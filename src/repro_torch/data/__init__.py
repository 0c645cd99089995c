"""data of the PyTorch port (see repro.data)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    global_batch,
    host_slice_for,
)
