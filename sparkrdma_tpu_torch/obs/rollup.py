"""Windowed rollups and heartbeats — the port's copy of
``sparkrdma_tpu.obs.rollup``, with the same line schemas.

Span sampling (:class:`~sparkrdma_tpu_torch.obs.journal.SamplingPolicy`)
keeps the journal bounded by dropping per-read detail; this module keeps
the aggregates exact while it does so:

- :class:`RollupAggregator` folds every recorded read, written in full
  or sampled away, into per-shuffle windows (count, bytes, spills,
  retries, streaming/fused split, a fixed-bucket latency histogram for
  p50/p95/p99) and writes one ``{"kind": "rollup"}`` journal line per
  shuffle (and tenant and job stage) per window. The reference's
  ``scripts/shuffle_report.py`` prefers these exact counts to
  sampling-corrected span estimates.
- :class:`HeartbeatEmitter` appends a ``{"kind": "heartbeat"}`` line
  every ``heartbeat_s`` from a thread (process identity, uptime, reads
  in flight, pool occupancy, tier occupancy, rss, per-tenant usage in
  the service), so ``scripts/shuffle_top.py`` can tell a silent host
  from an idle one.

Every field is host data: a rollup folds the span the manager built
after the read's closing sync, and a beat reads host counters, so
neither waits for the card. Both write through
:meth:`ExchangeJournal.emit_raw` and never raise into a shuffle: a beat
that fails is counted (``beat_errors``).

``ROLLUP_FIELDS`` and ``HEARTBEAT_FIELDS`` are the key sets of the two
line kinds, equal to the reference's (``tests/test_torch_rollup.py``);
the emitters raise if a line drifts from them.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION, ExchangeSpan
from sparkrdma_tpu_torch.obs.metrics import bucket_quantile
from sparkrdma_tpu_torch.obs.trace import current_trace

log = logging.getLogger("sparkrdma_tpu_torch.rollup")

#: upper bucket edges (ms) for the per-window read-latency histogram —
#: fixed so rollup lines from different hosts/windows merge bucket-wise
LATENCY_BOUNDS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

#: every key a ``{"kind": "rollup"}`` line carries
ROLLUP_FIELDS = frozenset({
    "kind", "schema", "ts", "process_index", "shuffle_id", "tenant",
    "trace_id", "job", "stage", "stage_attempt",
    "window_start", "window_s",
    "reads", "sampled_reads", "records", "bytes", "rounds", "dispatches",
    "retries", "spills", "streaming_reads", "fused_reads",
    "serde_encode_bytes", "serde_encode_mbps",
    "serde_decode_bytes", "serde_decode_mbps",
    "store_spill_bytes", "store_fetch_bytes",
    "store_prefetch_hits", "store_sync_fetches",
    "lat_bounds_ms", "lat_buckets", "lat_sum_ms", "lat_max_ms",
    "p50_ms", "p95_ms", "p99_ms",
})

#: every key a ``{"kind": "heartbeat"}`` line carries
HEARTBEAT_FIELDS = frozenset({
    "kind", "schema", "ts", "seq", "process_index", "host_count", "host",
    "pid", "uptime_s", "in_flight", "pool_outstanding", "spans_emitted",
    "rotations", "rss_mb", "host_tier_mb", "disk_tier_mb", "tenants",
    "trace_id", "job", "stage", "stage_attempt",
})


def span_latency_ms(span: ExchangeSpan) -> float:
    """The latency a read costs its caller: exchange + sort wall-clock
    (plan time is shared by the reads of a shuffle). The number the
    ``slow:<ms>`` sampling rule tests, so a kept outlier and its rollup
    bucket always agree."""
    return (span.exchange_s + span.sort_s) * 1e3


class _Cell:
    """Accumulator for one (window, shuffle) pair."""

    __slots__ = ("reads", "sampled_reads", "records", "bytes", "rounds",
                 "dispatches", "retries", "spills", "streaming_reads",
                 "fused_reads", "serde_encode_bytes", "serde_encode_s",
                 "serde_decode_bytes", "serde_decode_s",
                 "store_spill_bytes", "store_fetch_bytes",
                 "store_prefetch_hits", "store_sync_fetches",
                 "lat_buckets", "lat_sum_ms", "lat_max_ms")

    def __init__(self):
        self.reads = 0
        self.sampled_reads = 0
        self.records = 0
        self.bytes = 0
        self.rounds = 0
        self.dispatches = 0
        self.retries = 0
        self.spills = 0
        self.streaming_reads = 0
        self.fused_reads = 0
        self.serde_encode_bytes = 0
        self.serde_encode_s = 0.0
        self.serde_decode_bytes = 0
        self.serde_decode_s = 0.0
        self.store_spill_bytes = 0
        self.store_fetch_bytes = 0
        self.store_prefetch_hits = 0
        self.store_sync_fetches = 0
        self.lat_buckets = [0] * (len(LATENCY_BOUNDS_MS) + 1)
        self.lat_sum_ms = 0.0
        self.lat_max_ms = 0.0


class RollupAggregator:
    """Folds every span into per-shuffle windows; emits rollup lines.

    ``observe`` is called for each completed read *before* the sampling
    decision thins the journal — ``kept=False`` marks a span whose full
    line was dropped, which only affects the ``sampled_reads`` column
    (how many full spans the journal actually holds for cross-checking).
    Windows are wall-clock aligned (``floor(now / window_s)``); a window
    is emitted lazily when the first observation past its end arrives,
    and :meth:`flush` closes whatever is open (manager shutdown). The aggregator itself is a few hundred bytes per active
    shuffle — bounded regardless of read volume.
    """

    def __init__(self, journal, window_s: float = 30.0,
                 process_index: int = 0,
                 clock: Callable[[], float] = time.time,
                 store=None):
        self._journal = journal
        # optional TelemetryStore (obs/tsdb.py): every emitted rollup
        # line is also fed into its per-shuffle history ring
        self._store = store
        self.window_s = float(window_s)
        self.process_index = process_index
        self._clock = clock
        self._lock = threading.Lock()
        self._window_start: Optional[float] = None   # guarded-by: _lock
        # keyed by (tenant, shuffle_id): one cell per tenant per shuffle,
        # so two tenants' identically-numbered shuffles never merge
        self._cells: Dict[tuple, _Cell] = {}         # guarded-by: _lock
        # spill_count is process-cumulative
        self._last_spill = 0                         # guarded-by: _lock
        # serde codec totals are process-cumulative too (schema v4);
        # windows carry the delta, same trick as spills
        self._last_serde = (0, 0.0, 0, 0.0)          # guarded-by: _lock
        # tiered-store totals (schema v6): cumulative spill/fetch bytes,
        # prefetch hits, sync fetches — same delta folding
        self._last_store = (0, 0, 0, 0)              # guarded-by: _lock
        #: rollup lines emitted over this aggregator's lifetime
        self.emitted = 0                             # guarded-by: _lock

    def observe(self, span: ExchangeSpan, kept: bool = True,
                now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        lat_ms = span_latency_ms(span)
        b = 0
        while (b < len(LATENCY_BOUNDS_MS)
               and lat_ms > LATENCY_BOUNDS_MS[b]):
            b += 1
        with self._lock:
            pending = self._roll_locked(now)
            # one cell per tenant per shuffle per trace stage: a window
            # spanning a stage boundary splits into per-stage lines, so
            # the job layer's stage attribution stays exact
            ckey = (span.tenant, span.shuffle_id, span.trace_id,
                    span.job, span.stage, span.stage_attempt)
            cell = self._cells.get(ckey)
            if cell is None:
                cell = self._cells[ckey] = _Cell()
            cell.reads += 1
            if kept:
                cell.sampled_reads += 1
            cell.records += span.records
            cell.bytes += span.total_bytes
            cell.rounds += span.rounds
            cell.dispatches += span.dispatches
            cell.retries += span.retry_count
            spill_delta = span.spill_count - self._last_spill
            if spill_delta > 0:
                cell.spills += spill_delta
                self._last_spill = span.spill_count
            cur = (span.serde_encode_bytes, span.serde_encode_s,
                   span.serde_decode_bytes, span.serde_decode_s)
            if cur > self._last_serde:
                last = self._last_serde
                cell.serde_encode_bytes += cur[0] - last[0]
                cell.serde_encode_s += cur[1] - last[1]
                cell.serde_decode_bytes += cur[2] - last[2]
                cell.serde_decode_s += cur[3] - last[3]
                self._last_serde = cur
            store = (span.store_spill_bytes, span.store_fetch_bytes,
                     span.store_prefetch_hits, span.store_sync_fetches)
            if store > self._last_store:
                last = self._last_store
                cell.store_spill_bytes += store[0] - last[0]
                cell.store_fetch_bytes += store[1] - last[1]
                cell.store_prefetch_hits += store[2] - last[2]
                cell.store_sync_fetches += store[3] - last[3]
                self._last_store = store
            if span.dispatches > 1:
                cell.streaming_reads += 1
            else:
                cell.fused_reads += 1
            cell.lat_buckets[b] += 1
            cell.lat_sum_ms += lat_ms
            if lat_ms > cell.lat_max_ms:
                cell.lat_max_ms = lat_ms
        # journal emission does its own file I/O under its own lock —
        # it must happen after _lock is dropped (blocking-under-lock)
        for d in pending:
            self._journal.emit_raw(d)
            if self._store is not None:
                self._store.observe_rollup(d)

    def flush(self, now: Optional[float] = None) -> None:
        """Emit every open cell (shutdown / test hook)."""
        now = self._clock() if now is None else now
        with self._lock:
            pending = self._drain_locked(now)
        for d in pending:
            self._journal.emit_raw(d)
            if self._store is not None:
                self._store.observe_rollup(d)

    def peek(self) -> List[Dict]:
        """Lightweight snapshot of the OPEN (not yet emitted) cells —
        the probe endpoint's "live rollups" view. Not ROLLUP_FIELDS
        lines: just the running counts, no histogram/derived columns."""
        with self._lock:
            start = self._window_start
            return [{
                "tenant": tenant,
                "shuffle_id": sid,
                "job": job,
                "stage": stg,
                "window_start": start,
                "reads": c.reads,
                "records": c.records,
                "bytes": c.bytes,
                "retries": c.retries,
                "spills": c.spills,
            } for (tenant, sid, _tid, job, stg, _att), c
                in sorted(self._cells.items())]

    def _roll_locked(self, now: float) -> List[Dict]:
        """Advance the window; returns drained lines to emit once the
        caller has released ``_lock``."""
        start = (now // self.window_s) * self.window_s \
            if self.window_s > 0 else now
        if self._window_start is None:
            self._window_start = start
            return []
        if start <= self._window_start:
            return []
        pending = self._drain_locked(now)
        self._window_start = start
        return pending

    def _drain_locked(self, now: float) -> List[Dict]:
        """Snapshot every open cell into finished rollup lines and
        clear them. Pure in-memory work: the caller emits the returned
        lines *outside* ``_lock`` so slow journal I/O never extends the
        aggregator's critical section."""
        pending: List[Dict] = []
        for ckey in sorted(self._cells):
            tenant, sid, trace_id, job, stg, attempt = ckey
            c = self._cells[ckey]
            d = {
                "kind": "rollup",
                "schema": SCHEMA_VERSION,
                "ts": now,
                "process_index": self.process_index,
                "shuffle_id": sid,
                "tenant": tenant,
                "trace_id": trace_id,
                "job": job,
                "stage": stg,
                "stage_attempt": attempt,
                "window_start": self._window_start,
                "window_s": self.window_s,
                "reads": c.reads,
                "sampled_reads": c.sampled_reads,
                "records": c.records,
                "bytes": c.bytes,
                "rounds": c.rounds,
                "dispatches": c.dispatches,
                "retries": c.retries,
                "spills": c.spills,
                "streaming_reads": c.streaming_reads,
                "fused_reads": c.fused_reads,
                "serde_encode_bytes": c.serde_encode_bytes,
                "serde_encode_mbps": round(
                    c.serde_encode_bytes / c.serde_encode_s / 1e6, 3)
                if c.serde_encode_s > 0 else 0.0,
                "serde_decode_bytes": c.serde_decode_bytes,
                "serde_decode_mbps": round(
                    c.serde_decode_bytes / c.serde_decode_s / 1e6, 3)
                if c.serde_decode_s > 0 else 0.0,
                "store_spill_bytes": c.store_spill_bytes,
                "store_fetch_bytes": c.store_fetch_bytes,
                "store_prefetch_hits": c.store_prefetch_hits,
                "store_sync_fetches": c.store_sync_fetches,
                "lat_bounds_ms": list(LATENCY_BOUNDS_MS),
                "lat_buckets": list(c.lat_buckets),
                "lat_sum_ms": round(c.lat_sum_ms, 3),
                "lat_max_ms": round(c.lat_max_ms, 3),
                "p50_ms": round(bucket_quantile(
                    LATENCY_BOUNDS_MS, c.lat_buckets, 0.50,
                    hi=c.lat_max_ms), 3),
                "p95_ms": round(bucket_quantile(
                    LATENCY_BOUNDS_MS, c.lat_buckets, 0.95,
                    hi=c.lat_max_ms), 3),
                "p99_ms": round(bucket_quantile(
                    LATENCY_BOUNDS_MS, c.lat_buckets, 0.99,
                    hi=c.lat_max_ms), 3),
            }
            if set(d) != ROLLUP_FIELDS:
                # must survive python -O: the CLIs key on these fields
                raise RuntimeError(
                    "rollup line drifted from ROLLUP_FIELDS: "
                    f"{sorted(set(d) ^ ROLLUP_FIELDS)}")
            pending.append(d)
            self.emitted += 1
        self._cells.clear()
        return pending


def rss_mb() -> Optional[float]:   # never-raises
    """Resident set size in MiB, or None where unavailable.

    Prefers ``/proc/self/status`` (current RSS); falls back to
    ``resource.getrusage`` peak RSS (close enough for a liveness line).
    No psutil — stdlib only.
    """
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return round(peak_kb / 1024.0, 1)
    except Exception:
        return None


class HeartbeatEmitter:
    """Periodic liveness lines from a daemon thread.

    ``identity`` is the stable process identity (see
    :meth:`~sparkrdma_tpu_torch.runtime.mesh.MeshRuntime.process_identity`); ``probes`` maps the dynamic
    fields (``in_flight``, ``pool_outstanding``) to zero-arg callables
    evaluated at each beat — a probe that raises contributes -1 rather
    than killing the heartbeat. :meth:`beat` is also callable directly
    (tests, final beat at shutdown) and never raises.
    """

    def __init__(self, journal, interval_s: float,
                 identity: Optional[Dict] = None,
                 probes: Optional[Dict[str, Callable[[], int]]] = None,
                 clock: Callable[[], float] = time.time):
        self._journal = journal
        self.interval_s = float(interval_s)
        self._identity = dict(identity or {})
        self._probes = dict(probes or {})
        self._clock = clock
        self._started_at = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # beat() runs on both the background thread and foreground
        # callers (tests, the final beat in stop())
        self._lock = threading.Lock()
        self.seq = 0                                 # guarded-by: _lock
        self.beat_errors = 0                         # guarded-by: _lock
        self._last_beat_at = clock()                 # guarded-by: _lock

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._run, name="sparkrdma-heartbeat", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def _probe(self, name: str) -> int:
        fn = self._probes.get(name)
        if fn is None:
            return 0
        try:
            return int(fn())
        except Exception:
            return -1

    def _probe_raw(self, name: str):
        """Structured-valued probe (the per-tenant usage dict) — ``{}``
        when absent or failing; int coercion would mangle the value."""
        fn = self._probes.get(name)
        if fn is None:
            return {}
        try:
            return fn()
        except Exception:
            return {}

    def beat(self, now: Optional[float] = None) -> None:   # never-raises
        try:
            now = self._clock() if now is None else now
            with self._lock:
                self.seq += 1
                seq = self.seq
                self._last_beat_at = now
            tctx = current_trace()
            d = {
                "kind": "heartbeat",
                "schema": SCHEMA_VERSION,
                "ts": now,
                "seq": seq,
                "process_index": self._identity.get("process_index", 0),
                "host_count": self._identity.get("host_count", 1),
                "host": self._identity.get(
                    "host", socket.gethostname()),
                "pid": self._identity.get("pid", os.getpid()),
                "uptime_s": round(now - self._started_at, 3),
                "in_flight": self._probe("in_flight"),
                "pool_outstanding": self._probe("pool_outstanding"),
                "spans_emitted": getattr(self._journal, "emitted", 0),
                "rotations": getattr(self._journal, "rotations", 0),
                "rss_mb": rss_mb(),
                "host_tier_mb": self._probe("host_tier_mb"),
                "disk_tier_mb": self._probe("disk_tier_mb"),
                # tenant -> per-tier usage (empty outside the service)
                "tenants": self._probe_raw("tenants"),
                # job-trace coordinates (schema v12) of whatever job is
                # active at beat time — the liveness line says what the
                # process was *doing*, not just that it is alive
                "trace_id": tctx.trace_id if tctx else "",
                "job": tctx.job if tctx else "",
                "stage": tctx.stage if tctx else "",
                "stage_attempt": tctx.stage_attempt if tctx else 0,
            }
            if set(d) != HEARTBEAT_FIELDS:
                # must survive python -O; caught + counted just below
                raise RuntimeError(
                    "heartbeat line drifted from HEARTBEAT_FIELDS: "
                    f"{sorted(set(d) ^ HEARTBEAT_FIELDS)}")
            self._journal.emit_raw(d)
        except Exception:
            # liveness reporting must never take down the process it
            # reports on; the error count is itself the diagnostic
            with self._lock:
                self.beat_errors += 1
                first = self.beat_errors == 1
            if first:
                log.exception("heartbeat emission failed")

    def age_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last successful-or-attempted beat — the
        alert engine's heartbeat-staleness signal."""
        now = self._clock() if now is None else now
        with self._lock:
            return max(0.0, now - self._last_beat_at)

    def stop(self, final_beat: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.interval_s))
            self._thread = None
        if final_beat:
            self.beat()


__all__ = ["RollupAggregator", "HeartbeatEmitter", "LATENCY_BOUNDS_MS",
           "ROLLUP_FIELDS", "HEARTBEAT_FIELDS", "span_latency_ms",
           "rss_mb"]
