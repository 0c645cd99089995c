"""The port's configs equal the reference's, field by field."""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


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


def test_unknown_arch_names_the_ports_archs():
    """An arch the reference lacks raises KeyError naming the port's."""
    for get in (port_configs.get_config, port_configs.get_smoke_config):
        with pytest.raises(KeyError, match="whisper-large-v3") as e:
            get("whisper-tiny")
        assert "gpt2-124m" in str(e.value)


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_whisper_config_equals_the_reference(size):
    """The encoder-decoder arch is the port's too: its FULL and SMOKE
    configs equal the reference's, and the serve path refuses it, as the
    reference's engine does."""
    get = "get_config" if size == "full" else "get_smoke_config"
    port = getattr(port_configs, get)("whisper-large-v3")
    ref = getattr(ref_configs, get)("whisper-large-v3")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.is_encoder_decoder and port.enc_layers == ref.enc_layers
    assert port.param_count() == ref.param_count()
    assert "whisper-large-v3" in port_configs.ALL_ARCHS
    with pytest.raises(ValueError, match="models/whisper.py"):
        transformer.check_served(port)
