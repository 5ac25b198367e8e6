"""ShuffleManager-shaped public API — the Spark SPI surface.

The same five-method workflow as ``sparkrdma_tpu.api.shuffle_manager``:

    manager = ShuffleManager(MeshRuntime(conf, num_partitions=8))
    handle  = manager.register_shuffle(0, num_parts=8, partitioner=part)
    manager.get_writer(handle).write(records).stop()   # map stage + plan
    out, totals = manager.get_reader(handle, key_ordering=True).read()
    manager.unregister_shuffle(0); manager.stop()

One writer/reader pair drives every stacked partition at once. Only
full-range reads are ported: partition-range views, combine/aggregate,
pushdown, checkpointing and the observability stack wait for later
slices and raise where asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange, ShufflePlan
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime


@dataclasses.dataclass
class ShuffleHandle:
    """Ticket returned by ``register_shuffle`` (Spark's ShuffleHandle)."""

    shuffle_id: int
    num_parts: int
    partitioner: Callable


class ShuffleWriter:
    """Map side: hold the records; ``stop`` plans and publishes."""

    def __init__(self, manager: "ShuffleManager", handle: ShuffleHandle):
        self._m = manager
        self._h = handle
        self._records: Optional[torch.Tensor] = None
        self._plan: Optional[ShufflePlan] = None

    def write(self, records: torch.Tensor) -> "ShuffleWriter":
        if self._records is not None:
            raise RuntimeError("writer already holds records (one write per "
                               "map stage)")
        if records.device != self._m.runtime.device:
            raise ValueError(f"records on {records.device}, runtime on "
                             f"{self._m.runtime.device}")
        self._records = records
        return self

    def stop(self, success: bool = True) -> Optional[ShufflePlan]:
        """On success: plan the shuffle (the size exchange)."""
        if not success or self._records is None:
            self._records = None
            return None
        self._plan = self._m._exchange.plan(
            self._records, self._h.partitioner, self._h.num_parts)
        return self._plan

    @property
    def records(self) -> Optional[torch.Tensor]:
        return self._records

    @property
    def plan(self) -> Optional[ShufflePlan]:
        return self._plan


class ShuffleReader:
    """Reduce side: run the exchange, optionally key-sort."""

    def __init__(self, manager: "ShuffleManager", handle: ShuffleHandle,
                 start_partition: int = 0,
                 end_partition: Optional[int] = None,
                 key_ordering: bool = False):
        end = handle.num_parts if end_partition is None else end_partition
        if (start_partition, end) != (0, handle.num_parts):
            raise NotImplementedError(
                "partition-range reads are not ported yet")
        self._m = manager
        self._h = handle
        self.key_ordering = key_ordering

    def read(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(records [W, D*out_capacity], totals int32[D])``: partition
        ``d``'s columns are its received records, zero-padded past
        ``totals[d]``; key-sorted when ``key_ordering``."""
        writer = self._m._writers.get(self._h.shuffle_id)
        if writer is None or writer.plan is None:
            raise RuntimeError(f"shuffle {self._h.shuffle_id} has no "
                               "published map output (writer.stop() first)")
        out, totals, _ = self._m._exchange.exchange(
            writer.records, self._h.partitioner, writer.plan,
            self._h.num_parts, shuffle_id=self._h.shuffle_id,
            sort_key_words=(self._m.conf.key_words if self.key_ordering
                            else 0))
        return out, totals


class ShuffleManager:
    """The SPI root object — one per runtime."""

    def __init__(self, runtime: Optional[MeshRuntime] = None,
                 conf: Optional[ShuffleConf] = None, *,
                 num_partitions: int = 8, device="cuda"):
        self.runtime = runtime or MeshRuntime(
            conf, num_partitions=num_partitions, device=device)
        self.conf = conf or self.runtime.conf
        self.metrics = MetricsRegistry(enabled=True)
        self._exchange = ShuffleExchange(self.runtime, self.conf,
                                         metrics=self.metrics)
        self._handles: Dict[int, ShuffleHandle] = {}
        self._writers: Dict[int, ShuffleWriter] = {}

    def register_shuffle(self, shuffle_id: int, num_parts: int,
                         partitioner: Callable) -> ShuffleHandle:
        if shuffle_id in self._handles:
            raise ValueError(f"shuffle {shuffle_id} already registered")
        handle = ShuffleHandle(shuffle_id, num_parts, partitioner)
        self._handles[shuffle_id] = handle
        return handle

    def get_writer(self, handle: ShuffleHandle) -> ShuffleWriter:
        w = ShuffleWriter(self, handle)
        self._writers[handle.shuffle_id] = w
        return w

    def get_reader(self, handle: ShuffleHandle, start_partition: int = 0,
                   end_partition: Optional[int] = None,
                   key_ordering: bool = False) -> ShuffleReader:
        return ShuffleReader(self, handle, start_partition, end_partition,
                             key_ordering)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self._handles.pop(shuffle_id, None)
        self._writers.pop(shuffle_id, None)

    def stop(self) -> None:
        self._handles.clear()
        self._writers.clear()
        self.runtime.stop()

    def __enter__(self) -> "ShuffleManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ShuffleManager", "ShuffleHandle", "ShuffleWriter",
           "ShuffleReader"]
