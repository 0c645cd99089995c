"""The port's RX gate (TPU kernel 2.9) against the reference's.

On the CPU the wrapper runs its plain version, which is held against the
JAX Pallas kernel in interpret mode and against the host oracle
``rx_ref`` (numpy complex128), on the same numpy inputs.  The CUDA kernel
runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``, where it is bit-equal to the plain version).

Tolerances:
- against ``rx_ref``: 1e-5, the reference's own (fp32 rounding of
  products of order 1);
- against the Pallas interpret path in bf16: bit-equal (both round every
  product, sum and difference to bf16);
- against it in fp32: XLA's CPU backend contracts ``c*a + s*b`` into
  ``fma(c, a, s*b)``, skipping the rounding of ``c*a`` that the port (and
  the CUDA kernel) make: one fp32 ulp of |c*a| plus one ulp of the result.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.qc_gate import kernel as jqc_k  # noqa: E402
from repro.kernels.qc_gate import ops as jqc_ops  # noqa: E402
from repro.kernels.qc_gate import ref as jqc_r  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.qc_gate import kernel, ops, ref  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_MANTISSA = {"float32": 23, "bfloat16": 7}


def _state(n_qubits: int, dtype: str, seed: int):
    """The same random planes as JAX arrays and torch tensors of dtype."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        j = jnp.asarray(rng.standard_normal(1 << n_qubits), _JNP[dtype])
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(getattr(torch, dtype))))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - _MANTISSA[dtype])


SWEEP = [(8, 0), (8, 4), (8, 7), (12, 6)]  # tests/test_kernels.py rx sweep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1.1, 0.25, 2 * math.pi])
@pytest.mark.parametrize("n_qubits,qubit", SWEEP)
def test_plain_matches_the_pallas_kernel(n_qubits, qubit, theta, dtype):
    (jre, tre), (jim, tim) = _state(n_qubits, dtype, seed=4)
    want = jqc_k.rx_gate(jre, jim, qubit, theta, block_outer=2)
    got = registry.RX_GATE(tre, tim, qubit=qubit, theta=theta, block_outer=2)
    c, _ = ref.rotation(theta, getattr(torch, dtype))
    for g, w, plane in zip(got, want, (tre, tim)):
        assert g.dtype == plane.dtype and g.shape == plane.shape
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            tol = _ulp(c * _np(plane), dtype) + _ulp(_np(w), dtype)
            assert (np.abs(_np(g) - _np(w)) <= tol).all()


@pytest.mark.parametrize("n_qubits,qubit", SWEEP)
def test_plain_matches_the_oracle(n_qubits, qubit):
    (jre, tre), (jim, tim) = _state(n_qubits, "float32", seed=4)
    got = kernel.rx_gate(tre, tim, qubit, 1.1, block_outer=2)
    want = ref.rx_ref(tre, tim, qubit, 1.1)
    ref_want = jqc_r.rx_ref(np.asarray(jre), np.asarray(jim), qubit, 1.1)
    for g, w, rw in zip(got, want, ref_want):
        np.testing.assert_array_equal(w, rw)  # the oracle is the reference's
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5)


def test_rx_layer_preserves_norm_and_equals_the_reference():
    (jre, tre), (jim, tim) = _state(10, "float32", seed=6)
    norm0 = float((tre.double() ** 2 + tim.double() ** 2).sum())
    o_re, o_im = ops.rx_layer(tre, tim, n_qubits=10, theta=0.3)
    norm1 = float((o_re.double() ** 2 + o_im.double() ** 2).sum())
    np.testing.assert_allclose(norm0, norm1, rtol=1e-5)
    j_re, j_im = jqc_ops.rx_layer(jre, jim, n_qubits=10, theta=0.3)
    np.testing.assert_allclose(_np(o_re), _np(j_re), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(o_im), _np(j_im), rtol=1e-5, atol=1e-5)


def test_rx_two_pi_is_minus_identity():
    """RX(2pi) = -I (spin-1/2 phase), on |0...0> and on a random state."""
    re, im = ops.zero_state(6, device="cpu")
    o_re, o_im = kernel.rx_gate(re, im, 3, 2 * math.pi, block_outer=2)
    np.testing.assert_allclose(_np(o_re), -_np(re), atol=1e-5)
    np.testing.assert_allclose(_np(o_im), -_np(im), atol=1e-5)
    (_, tre), (_, tim) = _state(6, "float32", seed=8)
    o_re, o_im = kernel.rx_gate(tre, tim, 5, 2 * math.pi)
    np.testing.assert_allclose(_np(o_re), -_np(tre), atol=1e-5)
    np.testing.assert_allclose(_np(o_im), -_np(tim), atol=1e-5)


def test_zero_state_equals_the_reference():
    re, im = ops.zero_state(9, device="cpu")
    j_re, j_im = jqc_ops.zero_state(9)
    assert re.dtype == im.dtype == torch.float32
    np.testing.assert_array_equal(_np(re), _np(j_re))
    np.testing.assert_array_equal(_np(im), _np(j_im))


@pytest.mark.parametrize("n_qubits,dtype_bytes", [(1, 4), (14, 4), (21, 4),
                                                  (28, 2)])
def test_flops_bytes_equal_the_reference(n_qubits, dtype_bytes):
    assert ref.flops_bytes(n_qubits, dtype_bytes) == \
        jqc_r.flops_bytes(n_qubits, dtype_bytes)


def test_work_terms_count_each_plane_once():
    re = torch.zeros(1 << 10, dtype=torch.bfloat16)
    assert ref.work_terms(re) == {"flops": 6.0 * 1024, "bytes": 4.0 * 2048}
    assert ref.work_terms(re, gates=10)["flops"] == 6.0 * 1024 * 10


@pytest.mark.parametrize("n_amp,qubit,block_outer", [
    (256, 8, 256),   # qubit past the state: no (outer, 2, inner) view
    (256, 0, 3),     # outer 128 not divisible by block_outer 3
    (12, 2, 256),    # 12 amplitudes have no view for qubit 2
])
def test_view_and_tile_checks_match_the_reference(n_amp, qubit, block_outer):
    x = np.zeros(n_amp, np.float32)
    with pytest.raises(AssertionError):
        jqc_k.rx_gate(jnp.asarray(x), jnp.asarray(x), qubit, 0.5,
                      block_outer=block_outer)
    t = torch.zeros(n_amp)
    for fn in (kernel.rx_gate, kernel.rx_gate_plain):
        with pytest.raises(ValueError):
            fn(t, t, qubit, 0.5, block_outer=block_outer)


def test_wrapper_refuses_bad_planes():
    t = torch.zeros(64)
    with pytest.raises(TypeError):
        kernel.rx_gate(t.double(), t.double(), 0, 0.5)
    with pytest.raises(TypeError):
        kernel.rx_gate(t, t.bfloat16(), 0, 0.5)
    with pytest.raises(ValueError, match="one"):
        kernel.rx_gate(t, torch.zeros(32), 0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.rx_gate(torch.zeros(128)[::2], t, 0, 0.5)
    with pytest.raises(ValueError, match="qubit"):
        kernel.rx_gate(t, t, -1, 0.5)


def test_cpu_calls_launch_nothing():
    before = kernel.rx_gate.launches
    re, im = ops.zero_state(8, device="cpu")
    ops.rx_layer(re, im, n_qubits=8, theta=0.7)
    registry.RX_GATE.interpret(re, im, qubit=1, theta=0.7)
    assert kernel.rx_gate.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        registry.RX_GATE.kernel(re, im, qubit=1, theta=0.7)
    with pytest.raises(NotImplementedError, match="no ref oracle"):
        registry.RX_GATE.ref(re, im, 1, 0.7)


def test_registered_workload_is_one_gate_on_the_zero_state():
    from repro_torch.analysis import get_workload

    wl = get_workload("kernel/qc-gate")
    re, im = wl.example_args()
    assert re.shape == (1 << 14,) and float(re.sum()) == 1.0
    got = wl.fn(re, im)
    want = ref.rx_ref(re, im, 0, 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5)
