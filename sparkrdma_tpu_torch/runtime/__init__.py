"""runtime of the PyTorch port."""

from sparkrdma_tpu_torch.runtime.distributed import initialize_distributed

__all__ = ["initialize_distributed"]
