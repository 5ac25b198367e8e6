"""exchange of the PyTorch port."""
