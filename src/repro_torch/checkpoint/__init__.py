"""checkpoint of the PyTorch port (see repro.checkpoint)."""

from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
