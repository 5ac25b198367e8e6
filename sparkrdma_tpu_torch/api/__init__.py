"""api of the PyTorch port."""
