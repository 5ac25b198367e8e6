"""The shuffle registry — the port's copy of
``sparkrdma_tpu.meta.map_output``.

Membership is static (the runtime's :class:`~sparkrdma_tpu_torch.runtime
.mesh.ManagerId`\\ s, one per stacked partition), so the registry holds
them from the start. Per shuffle it keeps a :class:`ShuffleMeta`: the
partition count, the partitioner and, once the map stage publishes, the
host copy of the ``counts[source, partition]`` matrix (the lengths of
the reference's ``RdmaMapTaskOutput`` tables; slot positions stand in
for their addresses).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.runtime.mesh import ManagerId


class DuplicateShuffleIdError(ValueError):
    """A shuffle id is already registered on this manager.

    A distinct type, so that callers which draw ids themselves (the
    ``Dataset`` layer) retry on exactly this condition without
    swallowing any other registry validation error; a ``ValueError``,
    so that callers catching that still do.
    """


@dataclasses.dataclass
class ShuffleMeta:
    """What the control plane knows about one registered shuffle."""

    shuffle_id: int
    num_parts: int
    partitioner: Callable
    registered_at: float = dataclasses.field(default_factory=time.monotonic)
    # set when the map stage publishes
    counts: Optional[np.ndarray] = None      # [mesh, num_parts]
    map_published_at: Optional[float] = None

    @property
    def total_records(self) -> Optional[int]:
        return None if self.counts is None else int(self.counts.sum())


class MapOutputRegistry:
    """Host-side shuffle and membership registry (the coordinator's role,
    without the RPC). Thread-safe; one writer per shuffle by convention.
    Counts ``meta.registrations``, ``meta.map_outputs_published`` and
    ``meta.map_records_published`` and sets the gauge
    ``meta.registered_shuffles``."""

    def __init__(self, manager_ids: Tuple[ManagerId, ...],
                 metrics: Optional[MetricsRegistry] = None):
        self._managers = tuple(manager_ids)
        self._shuffles: Dict[int, ShuffleMeta] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)

    @property
    def managers(self) -> Tuple[ManagerId, ...]:
        return self._managers

    def register(self, shuffle_id: int, num_parts: int,
                 partitioner: Callable) -> ShuffleMeta:
        with self._lock:
            if shuffle_id in self._shuffles:
                raise DuplicateShuffleIdError(
                    f"shuffle {shuffle_id} already registered")
            meta = ShuffleMeta(shuffle_id, num_parts, partitioner)
            self._shuffles[shuffle_id] = meta
            live = len(self._shuffles)
        self.metrics.counter("meta.registrations").inc()
        self.metrics.gauge("meta.registered_shuffles").set(live)
        return meta

    def publish_map_output(self, shuffle_id: int, counts: np.ndarray) -> None:
        """Record the host copy of the size table after the map stage."""
        with self._lock:
            meta = self._shuffles[shuffle_id]
            meta.counts = np.asarray(counts, dtype=np.int64)
            meta.map_published_at = time.monotonic()
            published = int(meta.counts.sum())
        self.metrics.counter("meta.map_outputs_published").inc()
        self.metrics.counter("meta.map_records_published").inc(published)

    def get(self, shuffle_id: int) -> ShuffleMeta:
        with self._lock:
            return self._shuffles[shuffle_id]

    def unregister(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)
            live = len(self._shuffles)
        self.metrics.gauge("meta.registered_shuffles").set(live)

    def shuffle_ids(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._shuffles)


__all__ = ["MapOutputRegistry", "ShuffleMeta", "DuplicateShuffleIdError"]
