"""meta of the PyTorch port."""
