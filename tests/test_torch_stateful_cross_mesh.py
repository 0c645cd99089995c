"""mamba2 and jamba served tensor-parallel by the port: the mesh check in
a subprocess, on the smoke configs with the reference's weights, gives
streams on 1x1, 2x1, 1x2 and 2x2 equal to the unsharded engine's and to
the JAX engine's (checks in ``tests/torch_stateful_checks.py``).

On 1x2 a mamba mixer splits its SSM heads over ``model`` (its gated norm
sums its squares over ``model``, its ``out_proj`` is row-parallel, and
each rank gathers the B/C conv window); on 2x1 the states split their
slots over ``data``; on 2x2 every rank runs whole mixers for its data
slots.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

import torch_stateful_checks as checks  # noqa: E402

ARCHS = {"mamba2": "mamba2-370m", "jamba": "jamba-1.5-large-398b"}


@pytest.mark.parametrize("name", list(ARCHS))
def test_cross_mesh_streams_equal_the_jax_engine(tmp_path, name):
    m = checks.model(ARCHS[name])
    checks.check_mesh_verdict(m, name, checks.mesh_verdict(m, name,
                                                           tmp_path))
