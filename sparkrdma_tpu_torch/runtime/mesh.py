"""Stacked-partition runtime — the counterpart of ``MeshRuntime``.

The reference runs one shuffle partition per device of a ``jax`` mesh.
Here ``num_partitions`` partitions are stacked on ONE device: a record
batch is one columnar tensor ``[W, D*n]`` whose column group ``d`` is
partition ``d``'s records, the same layout the reference's sharded
global array has. An all-to-all between partitions is then a
permutation in device memory.

When a ``torch.distributed`` group is up (``runtime/distributed.py``),
the runtime spans it, as the reference's mesh spans every process of a
job: ``num_partitions`` is the global D, and process ``p`` of ``P``
holds partitions ``p*L .. (p+1)*L - 1`` (``L = D / P``, the reference's
order, ``jax.devices()`` being sorted by process), stacked on its own
device. A record batch is then the LOCAL batch ``[W, L*n]``; moves
between processes go through ``exchange/hierarchical.py``.

Words are ``uint32`` in the reference; torch's ``uint32`` support is
partial, so the port carries them as ``int32`` bit-views and compares
them unsigned (``kernels/sort.py``). ``shard_records`` and ``host_rows``
are the only places a host ``uint32`` array crosses.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.hbm.slot_pool import SlotPool
from sparkrdma_tpu_torch.runtime.device import resolve_device
from sparkrdma_tpu_torch.runtime.distributed import group_rank


@dataclasses.dataclass(frozen=True)
class ManagerId:
    """Identity of one shuffle participant: (process, partition index)."""

    process_index: int
    device_index: int

    def __str__(self) -> str:
        return f"proc{self.process_index}/dev{self.device_index}"


class MeshRuntime:
    """D partitions, this process's stacked on its device; owns the
    device's slot pool, as one ``RdmaNode`` owns its buffer manager.

    ``device="cuda"`` is the process's current CUDA device, which a
    multi-process launcher sets before it builds the runtime."""

    def __init__(self, conf: Optional[ShuffleConf] = None,
                 num_partitions: int = 8, device="cuda"):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.conf = conf or ShuffleConf()
        self.device = resolve_device(device)
        self.num_partitions = int(num_partitions)
        #: the process's place in the group ((0, 1) without one): stamped
        #: into journal spans as the reference stamps them
        self.process_index, self.process_count = group_rank()
        if self.num_partitions % self.process_count:
            raise ValueError(
                f"{self.num_partitions} partitions do not split evenly "
                f"over {self.process_count} processes")
        #: partitions stacked on this process's device
        self.local_partitions = self.num_partitions // self.process_count
        self.pool = SlotPool(self.conf, device=self.device)

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
        return ManagerId(
            process_index=device_index // self.local_partitions,
            device_index=device_index)

    def local_device_indices(self) -> Tuple[int, ...]:
        """The global partitions this process holds, in stacking order."""
        first = self.process_index * self.local_partitions
        return tuple(range(first, first + self.local_partitions))

    def _local_rows(self, n: int) -> slice:
        """This process's rows of a global array of ``n`` rows."""
        per = n // self.num_partitions
        first = self.process_index * self.local_partitions * per
        return slice(first, first + self.local_partitions * per)

    def shard_rows(self, x) -> torch.Tensor:
        """Global host array ``[N, ...]`` -> this process's rows on its
        device: rows split evenly over the partitions (partition ``d``
        holds rows ``d*N/D .. (d+1)*N/D``), as the reference's
        ``shard_rows`` splits them over its devices, and only the local
        partitions' rows placed. Any dtype torch takes; ``N`` a multiple
        of the partition count."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] % self.num_partitions:
            raise ValueError(
                f"leading dimension must be a multiple of "
                f"{self.num_partitions}, got shape {x.shape}")
        if self.process_count > 1:
            x = x[self._local_rows(x.shape[0])]
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def shard_records(self, rows) -> torch.Tensor:
        """Global host rows ``uint32[N, W]`` -> this process's columnar
        batch ``int32[W, L*N/D]`` on its device (N a multiple of the
        partition count)."""
        rows = np.asarray(rows, dtype=np.uint32)
        if rows.ndim != 2 or rows.shape[0] % self.num_partitions:
            raise ValueError(
                f"rows must be [N, W] with N a multiple of "
                f"{self.num_partitions}, got {rows.shape}")
        if self.process_count > 1:
            rows = rows[self._local_rows(rows.shape[0])]
        # the rows cross as they are and are transposed by torch on the
        # device (on the CPU, by torch's threads): a numpy transpose of a
        # [N, 25] array is several times slower
        src = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))
        src = src.to(self.device)
        cols = torch.empty((src.shape[1], src.shape[0]), dtype=torch.int32,
                           device=self.device)
        return cols.copy_(src.T)

    def host_rows(self, cols: torch.Tensor) -> np.ndarray:
        """A local columnar batch ``[W, N]`` -> host rows
        ``uint32[N, W]``."""
        return cols.detach().T.contiguous().cpu().numpy().view(np.uint32)

    def partition(self, cols: torch.Tensor, d: int) -> torch.Tensor:
        """Local partition ``d``'s column group of this process's stacked
        batch (a view): global partition ``local_device_indices()[d]``."""
        n = cols.shape[1] // self.local_partitions
        return cols[:, d * n:(d + 1) * n]

    def stop(self) -> None:
        """Drop the pooled buffers (``RdmaNode.stop``)."""
        self.pool.clear()

    def __enter__(self) -> "MeshRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["MeshRuntime", "ManagerId", "resolve_device"]
