"""core of the PyTorch port (see repro.core)."""
