"""launch of the PyTorch port (see repro.launch)."""
