"""Stall watchdog — a hung exchange must produce a signal, not silence.

The port's copy of ``sparkrdma_tpu.obs.watchdog``. The streaming
exchange regime blocks the host on completion tokens: the CUDA event
recorded after chunk ``j - queue_depth``'s fold, waited on with
``torch.cuda.Event.synchronize()`` before chunk ``j`` is admitted. A
wedged kernel or a lost peer turns that wait into an indefinite
silent hang: no log line, no journal span, nothing for an operator to
grep. The reference has the same failure mode (a lost completion leaves
``RdmaShuffleFetcherIterator`` parked on its results queue forever) and
the same lack of tooling.

:class:`StallWatchdog` closes the gap. The exchange arms it around every
blocking wait; if the wait exceeds ``ShuffleConf.watchdog_timeout_s`` the
watchdog — from its poll thread, while the wait keeps waiting —

- logs the full in-flight state (shuffle id, chunk index, queue
  occupancy, pool high-water) at ERROR;
- appends a ``{"kind": "stall", ...}`` line to the exchange journal, so
  the stall is machine-visible even though the read's own span will only
  ever be written if the wait eventually completes;
- records a ``stall`` event on the in-span timeline and bumps the
  ``watchdog.stalls`` counter.

**The poll thread needs the GIL while the wait blocks.** The port waits in
``Event.synchronize()``, which releases the GIL for the duration of
``cudaEventSynchronize`` (PyTorch's binding drops it around the call), so
the poll thread runs and the ``stall`` line lands while the reader is
still blocked. ``chip_smoke.py``'s ``obs`` phase holds this on the card:
it arms a 0.2 s watchdog around a wait on a ~2 s ``torch.cuda._sleep``
and checks that the stall line exists before ``synchronize()`` returns.
So the port waits in ``synchronize()`` and does not poll
``Event.query()``.

The wait itself is NOT interrupted: killing a kernel mid-flight would
corrupt the buffers it writes, and the retry layer above already maps real
backend failures to ``FetchFailedError``. The watchdog is a flight
recorder, not a circuit breaker.

**On-demand state dump**: :func:`install_state_dump` registers a
``SIGUSR1`` handler (where the platform has one) that dumps every
currently-armed wait via :func:`dump_armed` — ``kill -USR1 <pid>``
answers "what is this job blocked on right now" without restarting it.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import signal
import threading
import time
from typing import Dict, Iterator, List, Optional

log = logging.getLogger("sparkrdma_tpu_torch.watchdog")

# process-wide table of currently-armed waits, for the SIGUSR1 dump —
# every StallWatchdog registers here while armed
_armed_lock = threading.Lock()
_armed: Dict[int, Dict] = {}        # guarded-by: _armed_lock
_armed_ids = itertools.count(1)


#: the poll thread parks after this many seconds with nothing armed
_IDLE_S = 2.0


class StallWatchdog:
    """Watches blocking waits; fires once per stalled wait.

    ``timeout_s <= 0`` disables the watchdog entirely: :meth:`armed`
    yields immediately with no timer, no registration, no overhead —
    the null-instrument convention of :mod:`sparkrdma_tpu_torch.obs.metrics`.

    Where the reference starts a ``threading.Timer`` for every armed
    wait, the port keeps one poll thread per watchdog that wakes every
    ``min(timeout_s / 4, 1 s)`` and fires the waits past their deadline:
    arming is then a dict insert. A leg-F read arms 9 waits, and a
    thread started and joined for each took 10 % of its GB/s on the
    H100 (``scripts/torch_obs_cost.py``). A stall fires between
    ``timeout_s`` and ``1.25 * timeout_s`` into its wait, once, with the
    reference's record; the thread parks after ``_IDLE_S`` seconds with
    nothing armed and starts again at the next arm.
    """

    def __init__(self, timeout_s: float = 0.0, journal=None, metrics=None,
                 timeline=None):
        self.timeout_s = timeout_s
        self.journal = journal
        self.metrics = metrics
        self.timeline = timeline
        # the poll thread (_poll, _fire) and the SPI thread
        # (set_context / armed) race on the mutable state below
        self._lock = threading.Lock()
        #: stalls fired over this watchdog's lifetime
        self.stall_count = 0                       # guarded-by: _lock
        #: state dict of the most recent stall (None = never stalled)
        self.last_stall: Optional[Dict] = None     # guarded-by: _lock
        # per-read context (span id, shuffle id) merged into stall
        # records; the SPI layer refreshes it at the top of each read
        self._context: Dict = {}                   # guarded-by: _lock
        # armed waits: id -> (monotonic deadline, stall record)
        self._waits: Dict[int, tuple] = {}         # guarded-by: _lock
        self._poller: Optional[threading.Thread] = None  # guarded-by: _lock
        self._last_armed = 0.0                     # guarded-by: _lock
        self._period = min(max(timeout_s / 4, 1e-3), 1.0)

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def set_context(self, **kw) -> None:
        """Attach per-read identity (span_id, shuffle_id) to stalls."""
        with self._lock:
            self._context = dict(kw)

    @contextlib.contextmanager
    def armed(self, desc: str, **state) -> Iterator[None]:
        """Guard one blocking wait; fire if it outlives ``timeout_s``."""
        if not self.enabled:
            yield
            return
        with self._lock:
            record = dict(self._context)
        record.update(state)
        record["desc"] = desc
        record["armed_at"] = time.time()
        wid = next(_armed_ids)
        with _armed_lock:
            _armed[wid] = record
        now = time.monotonic()
        with self._lock:
            self._waits[wid] = (now + self.timeout_s, record)
            self._last_armed = now
            if self._poller is None:
                # daemon by design (ROADMAP C.1.16): one poll thread
                # per watchdog that parks itself once nothing has been
                # armed for _IDLE_S; the watchdog has no stop() to
                # join it from, and a process exit mid-wait leaves it
                # nothing to do
                # srlint: ignore[thread-lifecycle]
                self._poller = threading.Thread(
                    target=self._poll, name="stall-watchdog", daemon=True)
                self._poller.start()
        try:
            yield
        finally:
            with self._lock:
                self._waits.pop(wid, None)
            with _armed_lock:
                _armed.pop(wid, None)

    def _poll(self) -> None:
        """The poll thread: fires every wait past its deadline (once:
        a fired wait leaves the table), parks when idle."""
        while True:
            time.sleep(self._period)
            now = time.monotonic()
            with self._lock:
                due = [wid for wid, (deadline, _) in self._waits.items()
                       if deadline <= now]
                records = [self._waits.pop(wid)[1] for wid in due]
                if not self._waits and now - self._last_armed > _IDLE_S:
                    self._poller = None
                    return
            for record in records:
                self._fire(record)

    def _fire(self, record: Dict) -> None:
        """The armed wait is officially a stall."""
        stall = dict(record)
        stall["kind"] = "stall"
        stall["elapsed_s"] = round(time.time() - stall.pop("armed_at"),
                                   6)
        stall["ts"] = time.time()
        with self._lock:
            self.stall_count += 1
            self.last_stall = stall
        log.error("shuffle stall: blocked > %.3fs in %s (%s)",
                  self.timeout_s, stall.get("desc"),
                  ", ".join(f"{k}={v}" for k, v in sorted(stall.items())
                            if k not in ("desc", "kind", "ts")))
        if self.metrics is not None:
            self.metrics.counter("watchdog.stalls").inc()
        if self.timeline is not None:
            self.timeline.event("stall", **{
                k: v for k, v in stall.items()
                if k not in ("kind", "ts", "desc")})
        if self.journal is not None:
            self.journal.emit_raw(stall)


def dump_armed(sink=None) -> List[Dict]:
    """Snapshot (and log) every currently-armed blocking wait.

    Returns the snapshot so tests and embedders can assert on it;
    ``sink`` overrides the logger (any callable taking one string).
    """
    emit = sink if sink is not None else log.warning
    with _armed_lock:
        snapshot = [dict(v) for v in _armed.values()]
    now = time.time()
    if not snapshot:
        emit("watchdog state dump: no blocking waits armed")
        return snapshot
    for rec in snapshot:
        emit("watchdog state dump: %s armed %.3fs ago (%s)" % (
            rec.get("desc"), now - rec.get("armed_at", now),
            ", ".join(f"{k}={v}" for k, v in sorted(rec.items())
                      if k not in ("desc", "armed_at"))))
    return snapshot


def install_state_dump(signum: Optional[int] = None) -> bool:
    """Register the on-demand state dump on ``SIGUSR1`` (or ``signum``).

    Returns True when installed. Degrades to False — never raises — on
    platforms without SIGUSR1 or when called off the main thread
    (signal.signal's own restriction), so the SPI layer can attempt the
    install unconditionally.
    """
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:
            return False
    try:
        signal.signal(signum, lambda _sig, _frm: dump_armed())
        return True
    except (ValueError, OSError, RuntimeError):
        # non-main thread, or an embedder that owns signal handling
        return False


__all__ = ["StallWatchdog", "dump_armed", "install_state_dump"]
