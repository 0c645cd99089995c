"""distributed of the PyTorch port (see repro.distributed)."""
