"""Stacked-partition runtime — the counterpart of ``MeshRuntime``.

The reference runs one shuffle partition per device of a ``jax`` mesh.
Here ``num_partitions`` partitions are stacked on ONE device: a record
batch is one columnar tensor ``[W, D*n]`` whose column group ``d`` is
partition ``d``'s records, the same layout the reference's sharded
global array has. An all-to-all between partitions is then a
permutation in device memory.

Words are ``uint32`` in the reference; torch's ``uint32`` support is
partial, so the port carries them as ``int32`` bit-views and compares
them unsigned (``kernels/sort.py``). ``shard_records`` and ``host_rows``
are the only places a host ``uint32`` array crosses.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.hbm.slot_pool import SlotPool
from sparkrdma_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ManagerId:
    """Identity of one shuffle participant: (process, partition index)."""

    process_index: int
    device_index: int

    def __str__(self) -> str:
        return f"proc{self.process_index}/dev{self.device_index}"


class MeshRuntime:
    """D stacked partitions on one device; owns the device's slot pool,
    as one ``RdmaNode`` owns its buffer manager."""

    def __init__(self, conf: Optional[ShuffleConf] = None,
                 num_partitions: int = 8, device="cuda"):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.conf = conf or ShuffleConf()
        self.device = resolve_device(device)
        self.num_partitions = int(num_partitions)
        self.pool = SlotPool(self.conf, device=self.device)
        #: the process's place among the hosts (one process, one card
        #: here): stamped into journal spans as the reference stamps them
        self.process_index = 0
        self.process_count = 1

    def process_identity(self) -> dict:
        """This host process's identity, as stamped into every
        ``{"kind": "heartbeat"}`` line (``obs/rollup.py``): the rank
        pair, the host name and the pid."""
        return {"process_index": self.process_index,
                "host_count": self.process_count,
                "host": socket.gethostname(), "pid": os.getpid()}

    def manager_id(self, device_index: int) -> ManagerId:
        if not 0 <= device_index < self.num_partitions:
            raise ValueError(f"partition {device_index} out of range")
        return ManagerId(process_index=0, device_index=device_index)

    def shard_rows(self, x) -> torch.Tensor:
        """Host array ``[N, ...]`` -> the same array on the device, its
        rows split evenly over the stacked partitions (partition ``d``
        holds rows ``d*N/D .. (d+1)*N/D``), as the reference's
        ``shard_rows`` splits them over its devices. Any dtype torch
        takes; ``N`` a multiple of the partition count."""
        x = np.ascontiguousarray(x)
        if x.ndim < 1 or x.shape[0] % self.num_partitions:
            raise ValueError(
                f"leading dimension must be a multiple of "
                f"{self.num_partitions}, got shape {x.shape}")
        return torch.from_numpy(x).to(self.device)

    def shard_records(self, rows) -> torch.Tensor:
        """Host rows ``uint32[N, W]`` -> columnar ``int32[W, N]`` on the
        device (N a multiple of the partition count)."""
        rows = np.asarray(rows, dtype=np.uint32)
        if rows.ndim != 2 or rows.shape[0] % self.num_partitions:
            raise ValueError(
                f"rows must be [N, W] with N a multiple of "
                f"{self.num_partitions}, got {rows.shape}")
        # the rows cross as they are and are transposed by torch on the
        # device (on the CPU, by torch's threads): a numpy transpose of a
        # [N, 25] array is several times slower
        src = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))
        src = src.to(self.device)
        cols = torch.empty((src.shape[1], src.shape[0]), dtype=torch.int32,
                           device=self.device)
        return cols.copy_(src.T)

    def host_rows(self, cols: torch.Tensor) -> np.ndarray:
        """Columnar ``[W, N]`` -> host rows ``uint32[N, W]``."""
        return cols.detach().T.contiguous().cpu().numpy().view(np.uint32)

    def partition(self, cols: torch.Tensor, d: int) -> torch.Tensor:
        """Partition ``d``'s column group of a stacked batch (a view)."""
        n = cols.shape[1] // self.num_partitions
        return cols[:, d * n:(d + 1) * n]

    def stop(self) -> None:
        """Drop the pooled buffers (``RdmaNode.stop``)."""
        self.pool.clear()

    def __enter__(self) -> "MeshRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["MeshRuntime", "ManagerId", "resolve_device"]
