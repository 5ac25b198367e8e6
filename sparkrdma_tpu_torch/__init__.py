"""sparkrdma_tpu_torch — the shuffle framework ported to PyTorch and CUDA.

A package beside ``sparkrdma_tpu`` (the JAX reference, which it never
imports). D shuffle partitions are stacked on one device; the reference's
Pallas kernels are hand-written CUDA kernels under ``csrc/``, built at
first use (``_build.py``). Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version.
"""

from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.runtime.mesh import ManagerId, MeshRuntime

__all__ = ["ShuffleConf", "MeshRuntime", "ManagerId"]
