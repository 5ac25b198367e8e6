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
PyTorch's caching allocator does with its own free blocks.

**Stream order.** A buffer may be put back while work that reads or
writes it is still queued on the putting thread's current stream. The
pool keeps that stream with the buffer, and a ``get`` from a thread
whose current stream is another one makes its stream wait for the
putter's (``wait_stream``; counted in ``cross_stream_waits``) before
handing the buffer out, so the next holder's work runs after the last
one's on the card. Two tenants of the service share one pool from two
threads: on PyTorch's default stream (shared by every thread) the wait
is never needed, on side streams it is what keeps one tenant's kernels
from writing a buffer the other's are still reading. Work a caller moves
to a stream other than the one current at ``put`` must be synchronised
before the put, as before.

``get`` and ``get_shaped`` fire the fault plane's ``pool.acquire`` site
before they hand a buffer out: ``delay`` sleeps there, ``fail`` raises
the retryable ``FetchFailedError`` (the pool itself is intact, so the
reader's retry loop is the right handler) with nothing handed out.

Each acquire records a ``pool:acquire`` event (``hit``, ``wait_s``: the
host time of the pop or the allocation) and every change of occupancy a
``pool.outstanding`` counter sample on the owning manager's timeline
(``timeline``, the null timeline until a manager binds its own), as in
the reference.

Tenant accounts (the service's ``service/tenant.py``): ``get``,
``get_shaped`` and ``put_shaped`` take ``account=``, charged one HBM slot
for the buffer's lifetime, as in the reference: a charge blocks while the
tenant is at its ``hbm_slots`` quota (bounded by its wait, then
``QuotaExceededError``), before the fault site or the free stack is
touched; a ``Slot``'s charge is returned with its last reference, a
shaped buffer's by ``put_shaped`` with the same account.
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
                 "_lock", "_account")

    def __init__(self, array: torch.Tensor, capacity: int, record_words: int,
                 pool, account=None):
        self.array = array
        self.capacity = capacity
        self.record_words = record_words
        self._refs = 1
        self._pool = pool
        self._lock = threading.Lock()
        #: the tenant account charged one HBM slot while this lives
        self._account = account

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
        #: gets that had to order their stream after a putter's
        self.cross_stream_waits = 0        # guarded-by: _lock
        self._cuda = self.device.type == "cuda"
        #: the owning manager rebinds this to its own registry
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        #: the owning manager's in-span timeline (rebound like metrics)
        self.timeline = NULL_TIMELINE
        for records, count in self.conf.prealloc_classes().items():
            cls = size_class(records)
            rw = self.conf.record_words
            for _ in range(count):
                self._free[(cls, rw)].append(
                    (self._zeros((cls, rw)), self._stream()))
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

    def _stream(self):
        """The raw handle of this thread's current stream on the pool's
        card (0: the default stream), None on the CPU."""
        if not self._cuda:
            return None
        return torch._C._cuda_getCurrentRawStream(self.device.index)

    def _order_after(self, put_stream) -> None:
        """Make this thread's current stream wait for ``put_stream``, the
        stream current when the buffer came back, unless it is the same
        one (then stream order already holds)."""
        if put_stream is None or put_stream == self._stream():
            return
        src = (torch.cuda.default_stream(self.device) if put_stream == 0
               else torch.cuda.ExternalStream(put_stream,
                                              device=self.device))
        torch.cuda.current_stream(self.device).wait_stream(src)
        with self._lock:
            self.cross_stream_waits += 1

    def _pop(self, key) -> Optional[torch.Tensor]:
        """A free buffer under ``key`` (counted as a hit), ordered after
        its putter's stream, or None (a miss)."""
        with self._lock:
            stack = self._free.get(key)
            item = stack.pop() if stack else None
            if item is None:
                self.misses += 1
            else:
                self.hits += 1
        self.metrics.counter("pool.hits" if item is not None
                             else "pool.misses").inc()
        if item is None:
            return None
        arr, put_stream = item
        self._order_after(put_stream)
        return arr

    def _charge(self, account) -> None:
        """Charge ``account`` one HBM slot (blocking at its quota), then
        fire the ``pool.acquire`` site; a fault returns the charge."""
        if account is not None:
            account.charge("hbm", 1)
        try:
            _fire_pool_acquire()
        except BaseException:
            if account is not None:
                account.release("hbm", 1)
            raise

    def get(self, n_records: int, record_words: Optional[int] = None,
            account=None) -> Slot:
        """Pop (or allocate) a slot with capacity >= ``n_records``;
        ``account`` is charged one HBM slot until its last release."""
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
        self._charge(account)
        arr = self._pop((cls, rw))
        hit = arr is not None
        if arr is None:
            arr = self._zeros((cls, rw))
        self.timeline.event("pool:acquire", hit=hit,
                            wait_s=round(time.perf_counter() - t0, 6))
        self._track(+1)
        return Slot(arr, cls, rw, self, account=account)

    def _put(self, slot: Slot) -> None:
        if slot._account is not None:
            slot._account.release("hbm", 1)
        self._track(-1)
        stream = self._stream()
        with self._lock:
            self._free[(slot.capacity, slot.record_words)].append(
                (slot.array, stream))

    def get_shaped(self, shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.int32,
                   account=None) -> torch.Tensor:
        """Pop (or allocate, zero-filled) a buffer of exactly ``shape`` and
        ``dtype``; hand it back with :meth:`put_shaped`. ``account`` is
        charged one HBM slot; pass the same account to ``put_shaped``."""
        shape = tuple(int(s) for s in shape)
        t0 = time.perf_counter()
        self._charge(account)
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

    def put_shaped(self, arr: torch.Tensor, account=None) -> None:
        """Return a shaped buffer for reuse (and ``account``'s HBM slot).
        Work already queued on this thread's current stream that reads
        ``arr`` may still be running (module docstring)."""
        if arr.device != self.device:
            raise ValueError(f"buffer on {arr.device}, pool on {self.device}")
        if account is not None:
            account.release("hbm", 1)
        self._track(-1)
        stream = self._stream()
        with self._lock:
            self._free[("shaped", tuple(arr.shape), arr.dtype)].append(
                (arr, stream))

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
                    "evictions": self.evictions,
                    "cross_stream_waits": self.cross_stream_waits}


__all__ = ["Slot", "SlotPool"]
