"""models of the PyTorch port (see repro.models)."""
