"""launch (PyTorch port)."""
