"""The port's tests' CPU thread count, set once the vector math is warm.

Torch computes ``exp``, ``log``, ``tanh`` and the other elementwise
functions of a contiguous float tensor on the CPU through MKL's vector
math (VML), which sets itself up on its first call in a process.  When
that first call runs on several OpenMP threads at once, the chunk of a
thread other than the first can come out of a less accurate variant:
``torch.exp`` with a relative error up to 1.49e-4 (about 12 bits) where it
is otherwise within one ulp, in about one fresh process in 80, and exact
from the next call on.  A strided tensor (torch's own vector code, not
VML) and a first call on one thread never show it.  A test that holds a
softmax against the reference at 1e-5, such as the decode's split-merge
oracle, then fails for that one call.

:func:`use_threads` makes the first call of each such function on one
thread, in both float dtypes, and then sets the thread count; the port's
test modules call it at import in place of ``torch.set_num_threads``.
"""

import torch

#: torch's elementwise functions that MKL's vector math computes
_VML_OPS = (torch.exp, torch.expm1, torch.log, torch.log1p, torch.sqrt,
            torch.rsqrt, torch.tanh, torch.sin, torch.cos, torch.erf)


def use_threads(n: int) -> None:
    """Warm the vector math on one thread, then run on ``n`` threads."""
    torch.set_num_threads(1)
    x = torch.linspace(0.125, 1.0, 8192)
    for dtype in (torch.float32, torch.float64):
        for op in _VML_OPS:
            op(x.to(dtype))
    torch.set_num_threads(n)
