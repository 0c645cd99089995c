"""optim of the PyTorch port (see repro.optim)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    apply_update,
    global_norm,
    init_opt_state,
    schedule,
)
