"""Bounded in-span event timeline — *where inside* a shuffle read time went.

The port's copy of ``sparkrdma_tpu.obs.timeline``.
:class:`~sparkrdma_tpu_torch.obs.journal.ExchangeSpan` records that a
read was slow (phase wall-clocks, per-peer totals) but not where: which
streaming chunk blocked on ``queue_depth``, which pool acquire allocated
instead of hitting, which host-staging spill landed mid-read. This module
adds the missing sub-span resolution: a bounded, allocation-light event
recorder that the exchange data path (``exchange/protocol.py``), the slot
pool (``hbm/slot_pool.py``) and host staging (``hbm/host_staging.py``)
feed with monotonic-clock events, drained into the ``events`` array of
each journal line and rendered by ``scripts/shuffle_trace.py`` into
Chrome Trace Event Format (viewable in Perfetto).

Event shape (plain JSON so journal lines stay self-describing)::

    {"t": 0.00123, "ph": "B"|"E"|"i"|"C", "name": "chunk", ...extras}

- ``t``: seconds since the last :meth:`EventTimeline.drain` (monotonic
  ``perf_counter`` deltas — never wall clock, so NTP steps can't fold a
  phase negative);
- ``ph``: Chrome-trace phase letter — ``B``/``E`` duration begin/end,
  ``i`` instant, ``C`` counter (extras carry ``v``, the counter value);
- extras: small scalars only (chunk index, byte counts, hit/miss flags).

In the port every ``t`` is a host wall-clock mark around kernel launches
that run asynchronously on the card, as JAX's dispatch is in the
reference: a ``chunk`` interval times the host's enqueue of the chunk,
and a ``queue:block`` interval the host's wait for an older chunk's
CUDA event. Extras are host ints and strings only: nothing here reads a
device tensor, so recording an event never waits for the card.

Design constraints mirror :mod:`sparkrdma_tpu_torch.obs.metrics`:

1. **No-op when disabled.** The shared :data:`NULL_TIMELINE` singleton's
   methods are constant no-ops, so instrumentation sites stay
   unconditional in hot paths.
2. **Bounded memory.** At most ``capacity`` events are kept per drain
   interval; later events bump a drop counter instead of growing the
   buffer, and the drained array ends with one ``timeline:dropped``
   marker so consumers know the tail is missing rather than empty.
3. **Thread-tolerant.** Appends ride the GIL; ``drain``/``reset`` swap
   the buffer under a lock. Events recorded concurrently with a drain
   land in either the drained span or the next one — never lost.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

#: default per-span event budget — generous for hundreds of streaming
#: chunks, small enough that a journal line stays a few tens of KB
DEFAULT_CAPACITY = 512


class EventTimeline:
    """Bounded per-span event recorder (see module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        if capacity <= 0:
            raise ValueError("timeline capacity must be positive")
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0
        self._events: List[Dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------
    def event(self, name: str, ph: str = "i", **extras) -> None:
        """Record one event; silently dropped past ``capacity``."""
        if not self.enabled:
            return
        if len(self._events) >= self.capacity:
            self.dropped += 1
            return
        e: Dict = {"t": round(time.perf_counter() - self._t0, 6),
                   "ph": ph, "name": name}
        if extras:
            e.update(extras)
        self._events.append(e)

    def begin(self, name: str, **extras) -> None:
        """Open a duration event (Chrome-trace ``B``)."""
        self.event(name, ph="B", **extras)

    def end(self, name: str, **extras) -> None:
        """Close the innermost open duration event of ``name`` (``E``)."""
        self.event(name, ph="E", **extras)

    def counter(self, name: str, value) -> None:
        """Record a counter sample (``C``) — one point on a value track."""
        self.event(name, ph="C", v=value)

    # -- lifecycle ----------------------------------------------------
    def drain(self) -> List[Dict]:
        """Return-and-clear the buffered events; restart the clock.

        The journal calls this once per emitted span, so event ``t``
        values are relative to the previous drain — i.e. to (roughly)
        the start of the span being emitted.
        """
        with self._lock:
            events, self._events = self._events, []
            dropped, self.dropped = self.dropped, 0
            self._t0 = time.perf_counter()
        if dropped:
            events.append({"t": events[-1]["t"] if events else 0.0,
                           "ph": "i", "name": "timeline:dropped",
                           "n": dropped})
        return events

    def reset(self) -> None:
        """Discard buffered events and restart the clock."""
        with self._lock:
            self._events = []
            self.dropped = 0
            self._t0 = time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)


class _NullTimeline(EventTimeline):
    """Shared disabled singleton — constant no-ops, allocates nothing."""

    __slots__ = ()

    def __init__(self):
        super().__init__(capacity=1, enabled=False)

    def event(self, name: str, ph: str = "i", **extras) -> None:
        pass

    def counter(self, name: str, value) -> None:
        pass


NULL_TIMELINE = _NullTimeline()


# ---------------------------------------------------------------------
# process-wide active timeline — for components with no manager in reach
# (host staging's spill path), mirroring metrics.global_registry. The
# LAST manager to activate wins; concurrent managers interleave their
# global events, which is the honest answer for process-wide facts like
# spills anyway.
# ---------------------------------------------------------------------
_active_lock = threading.Lock()
_active: Optional[EventTimeline] = None
#: thread-local overlay: a tenant session's timeline, installed around
#: its SPI calls so one tenant's in-span events never land in another
#: tenant's journal lines (blast-radius isolation for shared machinery
#: like the tiered store's sync-fetch markers)
_tls = threading.local()


def set_active(tl: Optional[EventTimeline]) -> Optional[EventTimeline]:
    """Install the process-wide active timeline; returns the previous."""
    global _active
    with _active_lock:
        prev, _active = _active, tl
    return prev


class scoped_active:
    """Context manager: install ``tl`` as the CURRENT THREAD's active
    timeline (restores the prior thread scope on exit); while scoped,
    :func:`record_active` prefers it over the process-wide timeline.
    ``scoped_active(None)`` is a pass-through."""

    def __init__(self, tl: Optional[EventTimeline]):
        self._tl = tl
        self._prev: Optional[EventTimeline] = None

    def __enter__(self) -> "scoped_active":
        if self._tl is not None:
            self._prev = getattr(_tls, "timeline", None)
            _tls.timeline = self._tl
        return self

    def __exit__(self, *exc) -> None:
        if self._tl is not None:
            _tls.timeline = self._prev


def record_active(name: str, ph: str = "i", **extras) -> None:
    """Record into the active timeline, if any (no-op otherwise). A
    thread-scoped timeline (tenant session) takes precedence."""
    tl = getattr(_tls, "timeline", None)
    if tl is None:
        tl = _active
    if tl is not None:
        tl.event(name, ph=ph, **extras)


__all__ = ["EventTimeline", "NULL_TIMELINE", "DEFAULT_CAPACITY",
           "set_active", "scoped_active", "record_active"]
