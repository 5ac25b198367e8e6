"""Size-classed pool of device buffers — ``RdmaBufferManager`` analogue.

Counterpart of ``sparkrdma_tpu.hbm.slot_pool``:

- ``get(n)`` rounds the request up to a power-of-two size class and pops
  a buffer of that class, allocating a fresh one on a miss;
  ``Slot.release`` (the last of its references) puts it back;
- ``get_shaped`` / ``put_shaped`` serve buffers of an exact shape: the
  exchange's streaming receive chunks, send chunks and accumulator, and
  the fused regime's recycled output;
- ``prealloc`` warms classes at start-up, and ``stats()`` counts hits,
  misses and the buffers outstanding (with their high-water mark).

Buffers are torch tensors on the pool's device (``int32`` word views by
default). The device is the card unless the caller passes another, as
``MeshRuntime`` does; without CUDA the default raises. Only a miss is
zero-filled: a hit hands the buffer back as its last user left it, and
the caller writes what it reads.

JAX donation has no counterpart here: nothing deletes a buffer, so there
is no ``is_deleted`` check. The free buffers are a cache of the
device's memory: an allocation that finds the device full drops them
all (``evictions`` counts the buffers) and allocates once more, as
PyTorch's caching allocator does with its own free blocks. A buffer may be
put back while work that reads it is still queued: the port launches all
its work on one stream (PyTorch's current one), so whatever the next
holder queues runs after those reads, in stream order. A caller that
moves work to another stream must synchronise before putting back.

``get`` and ``get_shaped`` fire the fault plane's ``pool.acquire`` site
before they hand a buffer out: ``delay`` sleeps there, ``fail`` raises
the retryable ``FetchFailedError`` (the pool itself is intact, so the
reader's retry loop is the right handler) with nothing handed out.

Each acquire records a ``pool:acquire`` event (``hit``, ``wait_s``: the
host time of the pop or the allocation) and every change of occupancy a
``pool.outstanding`` counter sample on the owning manager's timeline
(``timeline``, the null timeline until a manager binds its own), as in
the reference. Left out of the reference's pool: the tenant accounts
that charge HBM slots.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.config import ShuffleConf, size_class
from sparkrdma_tpu_torch.exchange.errors import FetchFailedError
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.obs.timeline import NULL_TIMELINE
from sparkrdma_tpu_torch.runtime.device import resolve_device


def _fire_pool_acquire() -> None:
    """The ``pool.acquire`` site: a ``delay`` rule sleeps in the acquire,
    a ``fail`` rule raises the retryable fetch error."""
    if faults.fire("pool.acquire") == "fail":
        raise FetchFailedError(-1, "injected fault (pool.acquire)")


class Slot:
    """One pooled buffer of shape ``[capacity, record_words]`` with a
    reference count (``RdmaRegisteredBuffer``). ``capacity`` is the size
    class, not the live record count."""

    __slots__ = ("array", "capacity", "record_words", "_refs", "_pool",
                 "_lock")

    def __init__(self, array: torch.Tensor, capacity: int, record_words: int,
                 pool):
        self.array = array
        self.capacity = capacity
        self.record_words = record_words
        self._refs = 1
        self._pool = pool
        self._lock = threading.Lock()

    def retain(self) -> "Slot":
        with self._lock:
            if self._refs <= 0:
                raise RuntimeError("retain on released slot")
            self._refs += 1
        return self

    def release(self) -> None:
        """Drop one reference; the last one returns the slot to its pool
        (anything with a ``_put(slot)``)."""
        with self._lock:
            if self._refs <= 0:
                raise RuntimeError("double release")
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._pool._put(self)

    def view(self, start: int, length: int) -> torch.Tensor:
        """Rows ``[start, start + length)`` (a view, no copy)."""
        if start < 0 or length < 0 or start + length > self.capacity:
            raise ValueError(f"view [{start}:{start + length}] out of slot "
                             f"capacity {self.capacity}")
        return self.array[start:start + length]


class SlotPool:
    """Per-runtime pool of device buffers, bucketed by size class (``get``)
    or by exact shape and dtype (``get_shaped``)."""

    def __init__(self, conf: Optional[ShuffleConf] = None, device="cuda",
                 metrics: Optional[MetricsRegistry] = None):
        self.conf = conf or ShuffleConf()
        self.device = resolve_device(device)
        self._free: Dict[Tuple, List[torch.Tensor]] = defaultdict(list)
        self._lock = threading.Lock()
        self.allocations = 0               # guarded-by: _lock
        self.hits = 0                      # guarded-by: _lock
        self.misses = 0                    # guarded-by: _lock
        self.preallocated = 0              # immutable after __init__
        self.outstanding = 0               # guarded-by: _lock
        self.outstanding_high_water = 0    # guarded-by: _lock
        self.evictions = 0                 # guarded-by: _lock
        #: the owning manager rebinds this to its own registry
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        #: the owning manager's in-span timeline (rebound like metrics)
        self.timeline = NULL_TIMELINE
        for records, count in self.conf.prealloc_classes().items():
            cls = size_class(records)
            rw = self.conf.record_words
            for _ in range(count):
                self._free[(cls, rw)].append(self._zeros((cls, rw)))
                self.preallocated += 1

    def _zeros(self, shape, dtype=torch.int32) -> torch.Tensor:
        with self._lock:
            self.allocations += 1
        return self.zeros(shape, dtype)

    def zeros(self, shape, dtype=torch.int32) -> torch.Tensor:
        """A zero-filled tensor on the pool's device that the caller owns
        (it never enters the pool); if the device is full, the free
        buffers go back to it first."""
        try:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        except torch.OutOfMemoryError:
            with self._lock:
                dropped = sum(len(v) for v in self._free.values())
                self._free.clear()
                self.evictions += dropped
            if not dropped:
                raise
            return torch.zeros(shape, dtype=dtype, device=self.device)

    def _track(self, delta: int) -> None:
        """One buffer handed out (+1) or returned (-1)."""
        with self._lock:
            self.outstanding = max(0, self.outstanding + delta)
            self.outstanding_high_water = max(self.outstanding_high_water,
                                              self.outstanding)
            out = self.outstanding
        self.metrics.gauge("pool.outstanding").set(out)
        self.timeline.counter("pool.outstanding", out)

    def _pop(self, key) -> Optional[torch.Tensor]:
        """A free buffer under ``key`` (counted as a hit), or None (a
        miss)."""
        with self._lock:
            stack = self._free.get(key)
            arr = stack.pop() if stack else None
            if arr is None:
                self.misses += 1
            else:
                self.hits += 1
        self.metrics.counter("pool.hits" if arr is not None
                             else "pool.misses").inc()
        return arr

    def get(self, n_records: int, record_words: Optional[int] = None) -> Slot:
        """Pop (or allocate) a slot with capacity >= ``n_records``."""
        rw = record_words if record_words is not None \
            else self.conf.record_words
        if n_records > self.conf.max_slot_records:
            raise ValueError(f"requested {n_records} records > "
                             f"max_slot_records {self.conf.max_slot_records}")
        cls = size_class(n_records)
        if cls > self.conf.max_slot_records:
            raise ValueError(f"size class {cls} for request of {n_records} "
                             f"records > max_slot_records "
                             f"{self.conf.max_slot_records}")
        t0 = time.perf_counter()
        _fire_pool_acquire()
        arr = self._pop((cls, rw))
        hit = arr is not None
        if arr is None:
            arr = self._zeros((cls, rw))
        self.timeline.event("pool:acquire", hit=hit,
                            wait_s=round(time.perf_counter() - t0, 6))
        self._track(+1)
        return Slot(arr, cls, rw, self)

    def _put(self, slot: Slot) -> None:
        self._track(-1)
        with self._lock:
            self._free[(slot.capacity, slot.record_words)].append(slot.array)

    def get_shaped(self, shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """Pop (or allocate, zero-filled) a buffer of exactly ``shape`` and
        ``dtype``; hand it back with :meth:`put_shaped`."""
        shape = tuple(int(s) for s in shape)
        t0 = time.perf_counter()
        _fire_pool_acquire()
        arr = self._pop(("shaped", shape, dtype))
        hit = arr is not None
        if arr is None:
            arr = self._zeros(shape, dtype)
        # a miss pays the allocation, a hit only the pop: the pool's
        # share of the span's wall-clock
        self.timeline.event("pool:acquire", hit=hit,
                            wait_s=round(time.perf_counter() - t0, 6))
        self._track(+1)
        return arr

    def put_shaped(self, arr: torch.Tensor) -> None:
        """Return a shaped buffer for reuse. Work already queued on the
        stream that reads ``arr`` may still be running (module
        docstring)."""
        if arr.device != self.device:
            raise ValueError(f"buffer on {arr.device}, pool on {self.device}")
        self._track(-1)
        with self._lock:
            self._free[("shaped", tuple(arr.shape), arr.dtype)].append(arr)

    def free_counts(self) -> Dict[Tuple, int]:
        with self._lock:
            return {k: len(v) for k, v in self._free.items() if v}

    def clear(self) -> None:
        """Drop every pooled buffer (``RdmaBufferManager.stop``)."""
        with self._lock:
            self._free.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"allocations": self.allocations, "hits": self.hits,
                    "misses": self.misses,
                    "preallocated": self.preallocated,
                    "outstanding": self.outstanding,
                    "outstanding_high_water": self.outstanding_high_water,
                    "evictions": self.evictions}


__all__ = ["Slot", "SlotPool"]
