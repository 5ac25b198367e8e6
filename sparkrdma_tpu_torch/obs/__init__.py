"""obs of the PyTorch port."""
