"""mamba2 and jamba served by the port on an in-process 1x1 mesh (a
one-rank gloo group: the code path of every mesh), against the unsharded
port and the JAX engine (checks in ``tests/torch_stateful_checks.py``).

On the smoke configs, with the reference's weights: token by token,
chunked, and chunked on int8 pools with prefix sharing, the streams equal
the unsharded engine's and the JAX engine's.  The multi-rank shapes are
in ``tests/test_torch_stateful_cross_mesh.py``.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

import torch_stateful_checks as checks  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCHS = {"mamba2": "mamba2-370m", "jamba": "jamba-1.5-large-398b"}


@pytest.fixture(scope="module")
def mesh_1x1():
    yield from checks.one_rank_mesh()


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=4),
                                dict(kv_dtype="int8", share_prefixes=True,
                                     prefill_chunk=4)],
                         ids=["token", "chunked", "int8-shared-chunked"])
def test_streams_on_a_1x1_mesh_equal_unsharded_and_jax(mesh_1x1, name, kw):
    checks.check_one_rank_mesh(checks.model(ARCHS[name]), mesh_1x1, **kw)
