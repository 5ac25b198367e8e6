"""Live telemetry store — the port's copy of ``sparkrdma_tpu.obs.tsdb``:
a bounded ring-buffer time-series view of the metrics registry.

The registry holds cumulative counters and point-in-time gauges, and
the journal is a write-only file; the alert evaluator
(:mod:`sparkrdma_tpu_torch.obs.alerts`) and the probe
(:mod:`sparkrdma_tpu_torch.obs.probe`) need a windowed view of the
recent past ("bytes spilled over the last 2 s"). :class:`TelemetryStore`
is that view:

- a thread snapshots every scalar instrument of the registry (and of
  the ``extra_sources``: the process-wide registry, where the tiered
  store and host staging count) every ``ShuffleConf.telemetry_window_s``
  seconds into a ring of ``ShuffleConf.telemetry_history`` samples
  (older samples are evicted, counted as ``tsdb.evictions``);
- :meth:`last` / :meth:`delta` / :meth:`rate` / :meth:`window` answer
  point, difference, per-second and series queries over the ring;
- :meth:`observe_rollup` keeps the last rollup lines of each (tenant,
  shuffle) and :meth:`observe_job` the last job lines of each (tenant,
  job): :meth:`rollup_history`, :meth:`job_history`, :meth:`job_lines`.

As in the reference, the disabled path is the shared
:data:`NULL_TELEMETRY` (constant no-ops, nothing allocated), memory is
bounded by ``deque(maxlen=...)``, and a sample never raises into a
shuffle (``sample_errors`` counts the failures). Samples read host
counters only: nothing here touches the card.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

log = logging.getLogger("sparkrdma_tpu_torch.tsdb")

#: default ring capacity (samples retained per series and rollup
#: windows retained per shuffle) — ShuffleConf.telemetry_history
DEFAULT_HISTORY = 120


class Windowed(NamedTuple):
    """A windowed query answer that is honest about its window.

    Ring eviction (or a young process) can leave fewer trailing seconds
    in the ring than the caller asked for — a ``delta`` over a
    requested 30s window silently computed from 4s of data would
    overstate calm and understate storms. ``effective_s`` is the actual
    elapsed time between the two endpoints used, so consumers (alert
    rules, the probe) can scale or discard short answers.
    """

    value: float
    effective_s: float


#: shared zero answer for the empty/disabled paths (allocation-free)
ZERO_WINDOWED = Windowed(0.0, 0.0)

#: shared immutable empties for the disabled path (allocation-free)
_EMPTY_TUPLE: tuple = ()
_EMPTY_DICT: Dict = {}


class TelemetryStore:
    """Bounded ring-buffer TSDB over a metrics registry (see module
    docstring). ``start()`` launches the cadence sampler thread;
    :meth:`sample` is also callable directly (tests, probes)."""

    def __init__(self, registry, window_s: float = 1.0,
                 history: int = DEFAULT_HISTORY,
                 clock: Callable[[], float] = time.time,
                 extra_sources: Tuple[Callable[[], Dict], ...] = ()):
        if window_s < 0:
            raise ValueError("telemetry window_s must be >= 0")
        if history < 2:
            raise ValueError("telemetry history must be >= 2 "
                             "(rate/delta need two samples)")
        self._registry = registry
        # additional snapshot callables folded into every sample —
        # the manager passes the process-global registry here so
        # globally-recorded series (store.*, staging.*, faults.*)
        # are queryable next to the manager's own; the primary
        # registry wins on name collisions
        self._extra_sources = tuple(extra_sources)
        self.window_s = float(window_s)
        self.history = int(history)
        self._clock = clock
        self.enabled = True
        self._lock = threading.Lock()
        # ring of (ts, {name: scalar}) registry snapshots, oldest first
        self._samples: deque = deque(maxlen=history)   # guarded-by: _lock
        # (tenant, shuffle_id) -> ring of emitted rollup lines
        self._rollups: Dict[Tuple[str, int], deque] = {}  # guarded-by: _lock
        # (tenant, job) -> ring of emitted {"kind": "job"} lines
        self._jobs: Dict[Tuple[str, str], deque] = {}     # guarded-by: _lock
        self.evicted = 0                               # guarded-by: _lock
        self.sample_errors = 0                         # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None or self.window_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._run, name="sparkrdma-telemetry", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.window_s):
            self.sample()

    def sample(self, now: Optional[float] = None) -> None:  # never-raises
        """Snapshot every scalar instrument into the ring.

        Histogram sub-dicts are skipped (they are not scalar series; the
        registry's fixed-bucket quantiles serve that need); counters,
        gauges and gauge ``.high_water`` shadows are all kept.
        """
        try:
            now = self._clock() if now is None else now
            snap = self._registry.snapshot()
            flat = {k: v for k, v in snap.items()
                    if isinstance(v, (int, float))}
            for src in self._extra_sources:
                for k, v in src().items():
                    if isinstance(v, (int, float)):
                        flat.setdefault(k, v)
            with self._lock:
                if len(self._samples) == self._samples.maxlen:
                    self.evicted += 1
                    evicted = self.evicted
                else:
                    evicted = 0
                self._samples.append((now, flat))
            # registry bookkeeping OUTSIDE the store lock (leaf lock
            # discipline); the new counts land in the NEXT sample
            self._registry.counter("tsdb.samples").inc()
            if evicted:
                self._registry.counter("tsdb.evictions").inc()
        except Exception:
            # telemetry must never take down the process it observes
            with self._lock:
                self.sample_errors += 1
                first = self.sample_errors == 1
            if first:
                log.exception("telemetry sample failed")

    def observe_rollup(self, line: Dict) -> None:
        """Record one emitted ``{"kind": "rollup"}`` line into the
        per-shuffle history ring (called by the RollupAggregator)."""
        key = (str(line.get("tenant", "") or ""),
               int(line.get("shuffle_id", 0) or 0))
        with self._lock:
            ring = self._rollups.get(key)
            if ring is None:
                ring = self._rollups[key] = deque(maxlen=self.history)
            ring.append(line)

    def observe_job(self, line: Dict) -> None:
        """Record one emitted ``{"kind": "job"}`` summary line into the
        per-job history ring (called by obs/trace.py at job close)."""
        key = (str(line.get("tenant", "") or ""),
               str(line.get("job", "") or ""))
        with self._lock:
            ring = self._jobs.get(key)
            if ring is None:
                ring = self._jobs[key] = deque(maxlen=self.history)
            ring.append(line)

    # -- queries ------------------------------------------------------
    def _points(self, name: str, span_s: Optional[float]
                ) -> List[Tuple[float, float]]:
        """(ts, value) points of one series, oldest first, restricted to
        the trailing ``span_s`` seconds of the ring (all when None).
        Caller must hold ``_lock``."""
        pts = [(ts, flat[name]) for ts, flat
               in self._samples if name in flat]
        if span_s is not None and pts:
            cutoff = pts[-1][0] - span_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def last(self, name: str):
        """Newest sampled value of ``name`` (None before any sample)."""
        with self._lock:
            for ts, flat in reversed(self._samples):
                if name in flat:
                    return flat[name]
        return None

    def window(self, name: str, span_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """The (ts, value) series of ``name`` over the trailing
        ``span_s`` seconds (the whole ring when None)."""
        with self._lock:
            return self._points(name, span_s)

    def delta(self, name: str, span_s: Optional[float] = None
              ) -> Windowed:
        """newest − oldest value over the window, with the *effective*
        elapsed seconds between those endpoints (zero with < 2 points).
        Exact for counters: both endpoints are true registry values.
        When eviction (or a young ring) holds less history than
        ``span_s`` asked for, ``effective_s`` says so."""
        with self._lock:
            pts = self._points(name, span_s)
        if len(pts) < 2:
            return ZERO_WINDOWED
        return Windowed(pts[-1][1] - pts[0][1], pts[-1][0] - pts[0][0])

    def rate(self, name: str, span_s: Optional[float] = None
             ) -> Windowed:
        """Per-second rate of change over the window, with the
        effective elapsed seconds it was computed over (zero with < 2
        points or zero elapsed time between them)."""
        with self._lock:
            pts = self._points(name, span_s)
        if len(pts) < 2:
            return ZERO_WINDOWED
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return ZERO_WINDOWED
        return Windowed((pts[-1][1] - pts[0][1]) / elapsed, elapsed)

    def rollup_history(self, shuffle_id: int, tenant: str = ""
                       ) -> List[Dict]:
        """The retained rollup-window lines of one (tenant, shuffle),
        oldest first (empty when the shuffle emitted none yet)."""
        with self._lock:
            ring = self._rollups.get((tenant, int(shuffle_id)))
            return list(ring) if ring is not None else []

    def job_history(self, job: str, tenant: str = "") -> List[Dict]:
        """The retained ``{"kind": "job"}`` lines of one (tenant, job)
        name, oldest first (empty when the job never closed here)."""
        with self._lock:
            ring = self._jobs.get((tenant, str(job)))
            return list(ring) if ring is not None else []

    def job_lines(self, limit: int = 0) -> List[Dict]:
        """Every retained job line across all rings, oldest first by
        close timestamp (the probe's ``/jobs`` payload); ``limit`` > 0
        keeps only the newest N."""
        with self._lock:
            lines = [ln for ring in self._jobs.values() for ln in ring]
        lines.sort(key=lambda ln: ln.get("ts", 0.0))
        if limit > 0:
            lines = lines[-limit:]
        return lines

    def stats(self) -> Dict:
        """JSON-ready snapshot for the probe endpoint: ring state, the
        newest sample, and full-ring per-second rates per series."""
        with self._lock:
            samples = list(self._samples)
            rollup_keys = sorted(self._rollups)
            job_keys = sorted(self._jobs)
            evicted = self.evicted
        newest: Dict = samples[-1][1] if samples else {}
        rates: Dict[str, float] = {}
        if len(samples) >= 2:
            t0, old = samples[0]
            t1, new = samples[-1]
            elapsed = t1 - t0
            if elapsed > 0:
                rates = {k: round((v - old[k]) / elapsed, 6)
                         for k, v in new.items() if k in old}
        return {
            "window_s": self.window_s,
            "history": self.history,
            "samples": len(samples),
            "evicted": evicted,
            "ts": samples[-1][0] if samples else 0.0,
            "last": dict(newest),
            "rate": rates,
            "rollup_series": [f"{t}/{sid}" for t, sid in rollup_keys],
            "job_series": [f"{t}/{j}" for t, j in job_keys],
        }

    # -- lifecycle ----------------------------------------------------
    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.window_s))
            self._thread = None


class _NullTelemetryStore(TelemetryStore):
    """Shared disabled singleton — constant no-ops, allocates nothing
    (the null-instrument pattern; queries return shared empties)."""

    __slots__ = ()

    def __init__(self):
        super().__init__(_NullRegistry(), window_s=0.0, history=2)
        self.enabled = False

    def start(self) -> None:
        pass

    def sample(self, now: Optional[float] = None) -> None:
        pass

    def observe_rollup(self, line: Dict) -> None:
        pass

    def last(self, name: str):
        return None

    def window(self, name: str, span_s: Optional[float] = None):
        return _EMPTY_TUPLE

    def delta(self, name: str, span_s: Optional[float] = None
              ) -> Windowed:
        return ZERO_WINDOWED

    def rate(self, name: str, span_s: Optional[float] = None
             ) -> Windowed:
        return ZERO_WINDOWED

    def rollup_history(self, shuffle_id: int, tenant: str = ""):
        return _EMPTY_TUPLE

    def observe_job(self, line: Dict) -> None:
        pass

    def job_history(self, job: str, tenant: str = ""):
        return _EMPTY_TUPLE

    def job_lines(self, limit: int = 0):
        return _EMPTY_TUPLE

    def stats(self) -> Dict:
        return _EMPTY_DICT

    def stop(self) -> None:
        pass


class _NullRegistry:
    """Placeholder registry for the null store (never actually read)."""

    __slots__ = ()

    def snapshot(self) -> Dict:
        return _EMPTY_DICT


NULL_TELEMETRY = _NullTelemetryStore()


__all__ = ["TelemetryStore", "NULL_TELEMETRY", "DEFAULT_HISTORY",
           "Windowed", "ZERO_WINDOWED"]
