"""workloads of the PyTorch port."""
