"""configs (PyTorch port)."""
