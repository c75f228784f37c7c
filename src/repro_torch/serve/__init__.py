"""serve (PyTorch port)."""
