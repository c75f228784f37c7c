"""quant (PyTorch port)."""
