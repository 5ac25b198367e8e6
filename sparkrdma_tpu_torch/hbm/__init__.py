"""hbm of the PyTorch port."""
