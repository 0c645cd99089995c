"""The port's configs equal the reference's, field by field."""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402


@pytest.mark.parametrize("arch", port_configs.ALL_ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_fields_equal_reference(arch, size):
    get = "get_config" if size == "full" else "get_smoke_config"
    port = getattr(port_configs, get)(arch)
    ref = getattr(ref_configs, get)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.vocab_padded == ref.vocab_padded
    assert port.n_superblocks == ref.n_superblocks
    assert port.param_count() == ref.param_count()


def test_port_archs_are_reference_archs():
    assert set(port_configs.ALL_ARCHS) <= set(ref_configs.ALL_ARCHS)


def test_unknown_arch_names_the_roadmap_item():
    with pytest.raises(KeyError, match="1.18"):
        port_configs.get_config("whisper-large-v3")
