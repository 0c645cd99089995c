"""serve of the PyTorch port (see repro.serve)."""
