"""Structured exchange journal — one JSON-lines span per shuffle read.

The port's copy of ``sparkrdma_tpu.obs.journal``: the same dataclass,
field order, schema version, sampling hash and rotation, so a line
either package writes reads in the other's readers and in the
reference's stdlib-only CLIs (``scripts/shuffle_report.py``,
``scripts/shuffle_trace.py``).

The reference's observability output is a histogram printed to the
executor LOG (``RdmaShuffleReaderStats.printRemoteFetchHistogram``) —
human-greppable, machine-hostile. The journal replaces that with one
machine-readable record per executed exchange, appended to a configurable
JSON-lines sink (``ShuffleConf.metrics_sink``), carrying everything needed
to answer "which exchange round, which peer, which pool is slow" offline:

- identity: monotonically increasing ``span_id`` (also threaded into the
  profiler range names via
  :func:`sparkrdma_tpu_torch.utils.profiling.annotate_span`, so
  ``torch.profiler`` / Nsight Systems ranges and journal lines correlate
  by id), ``shuffle_id``, transport,
  and — multi-host — ``process_index`` / ``host_count`` so journals from
  every host merge without ambiguity (each host writes its own file via
  the ``{process}`` placeholder in ``metrics_sink``);
- phase wall-clocks: ``plan_s`` / ``exchange_s`` / ``sort_s`` (sort is
  0.0 when fused into the exchange program — the full-range default);
- volume: ``rounds``, ``dispatches``, ``records``, ``record_bytes``,
  ``total_bytes``;
- skew: ``per_peer_records`` — records contributed by each source device
  (the ``RdmaShuffleReaderStats`` per-remote-executor table, machine-
  readable);
- pressure: slot-pool occupancy high-water, cumulative host-staging
  spill count, retry count;
- **timeline** (schema v2): ``events`` — the bounded in-span event array
  drained from :class:`~sparkrdma_tpu_torch.obs.timeline.EventTimeline`
  (per-chunk dispatch/queue-block/fold, pool acquires, spills, retries,
  stalls), convertible to a Perfetto-viewable Chrome trace with
  ``scripts/shuffle_trace.py``;
- **sampling** (schema v3): ``sample_weight`` — how many reads this span
  statistically stands for. Under ``ShuffleConf.journal_sample`` (e.g.
  ``1/8+slow:250``) only a deterministic 1-in-N subset of spans plus
  every latency outlier is written in full; a span kept by the 1/N rule
  carries ``sample_weight=N`` so readers can scale counts back up, a
  slow-outlier-only span carries weight 1 (it represents just itself).
  Dropped spans still feed metrics and the windowed rollups, so
  aggregate totals stay exact (Dapper-style sampled tracing on top of
  Monotasks-style always-on accounting).

Besides spans, a journal may carry **auxiliary lines** tagged with a
``"kind"`` field:

- ``{"kind": "stall", ...}`` — flight-recorder records written by
  :mod:`sparkrdma_tpu_torch.obs.watchdog` while a read is still blocked (the
  read's own span only ever lands if the wait completes);
- ``{"kind": "rollup", ...}`` — per-shuffle windowed aggregates from
  :mod:`sparkrdma_tpu.obs.rollup` (exact counts even under sampling);
- ``{"kind": "heartbeat", ...}`` — periodic liveness lines (process
  identity, uptime, in-flight reads, pool occupancy, rss) so a silent
  host is distinguishable from an idle one;
- ``{"kind": "alert", ...}`` — alert lifecycle records (fired /
  resolved) from :mod:`sparkrdma_tpu.obs.alerts`, the rule engine's
  durable evidence trail consumed by ``shuffle_report --doctor``;
- ``{"kind": "job", ...}`` — per-job trace summaries (schema v12) from
  :mod:`sparkrdma_tpu_torch.obs.trace`: per-stage critical-path profiles,
  ``stage:idle`` time, the per-job verdict — consumed by
  ``shuffle_report --jobs``, ``shuffle_top`` and the probe's ``/jobs``
  route;
- ``{"kind": "plan", ...}`` — query-planner rewrite decisions (schema
  v13) from :mod:`sparkrdma_tpu_torch.plan.executor`: which rewrite fired on
  which plan node and what it saved — consumed by
  ``shuffle_report --jobs`` and the missed-reuse doctor rule.

:func:`read_journal` returns spans only; :func:`read_entries` returns
everything. The port writes spans and the ``stall``, ``job`` and ``plan``
lines; the ``rollup``, ``heartbeat``, ``alert`` and ``lease`` kinds come
with its live telemetry layer and its service, and its readers already
read them.

**Rotation**: long-running processes cap the live segment with
``ShuffleConf.journal_max_bytes``; when a write pushes the file past the
cap the journal atomically renames ``j`` → ``j.1`` (shifting ``j.1`` →
``j.2``, …) and starts a fresh segment. ``rotated_paths`` lists all
segments oldest-first; the readers and every CLI accept them.

Schema compatibility contract (pinned by tests): readers drop unknown
keys and default missing ones, so a v1/v2 line parses under the v3
reader (``events`` empty, single-host identity, ``sample_weight`` 1)
and a v3 line parses under earlier readers (the new fields are simply
invisible to them).

Aggregate with ``scripts/shuffle_report.py``; export traces with
``scripts/shuffle_trace.py``; watch live with ``scripts/shuffle_top.py``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import threading
import time
from typing import IO, Dict, Iterator, List, Optional, Union

log = logging.getLogger("sparkrdma_tpu_torch.journal")

#: v2: + ``events`` timeline, + ``process_index``/``host_count`` identity.
#: v3: + ``sample_weight`` (span sampling), + auxiliary ``rollup`` and
#: ``heartbeat`` line kinds (see obs/rollup.py).
#: v4: + ``serde_encode_bytes``/``serde_encode_s`` and decode twins —
#: process-cumulative host codec totals (api/serde.py), spill_count-style.
#: v5: + ``backoff_ms`` (per-attempt retry backoff delays, ms) and
#: ``degraded`` (sticky fallback names active at emit — faults.py ladder).
#: v6: + ``store_spill_bytes``/``store_fetch_bytes``/``store_prefetch_hits``
#: /``store_sync_fetches`` — process-cumulative tiered-store totals
#: (hbm/tiered_store.py), spill_count-style.
#: v7: + ``tenant`` — the service tenant a span belongs to ("" outside
#: the multi-tenant service); also carried by rollup cells and the
#: auxiliary ``{"kind": "admission"}`` fair-queueing wait lines
#: (the reference's ``service/``).
#: v8: + ``serde_columnar_{encode,decode}_{bytes,s}`` — the columnar
#: (schema-aware v2) codec's share of the v4 serde totals, also
#: process-cumulative. The v4 fields remain TOTALS across both codec
#: paths (pickle share = total − columnar), so pre-v8 consumers and the
#: rollup's serde series keep their meaning unchanged.
#: v9: + ``combine_{in,out}_{records,bytes}`` (measured map-side-combine
#: wire reduction), ``combine_dup_ratio`` (the combine gate's sampled
#: duplicate-key estimate — present on every aggregator read, combine
#: on or off, so ``--doctor`` can flag missed combines), and
#: ``pushdown_rows_dropped``/``pushdown_words_dropped`` (predicate /
#: projection pushdown deltas). PER-SPAN values (not cumulative) —
#: exchange/protocol.py §wire_stats.
#: v10: + ``phase_s`` (critical-path phase attribution: seconds per
#: pipeline phase, keys from obs/critical_path.py PHASES, summing to
#: the span's wall-clock) and ``bottleneck`` (the derived verdict, one
#: of obs/critical_path.py VERDICTS or "" when unattributed). PER-SPAN
#: — obs/critical_path.py §enrich, called at both emission sites.
#: v11: + auxiliary ``{"kind": "alert"}`` lines (obs/alerts.py
#: ALERT_FIELDS — rule-engine fire/resolve records). Span fields are
#: unchanged from v10, so v10↔v11 interchange is pure kind-tolerance:
#: a v10 reader skips the unknown kind, a v11 reader reads v10 lines
#: verbatim (pinned by tests/test_alerts.py).
#: v12: + ``trace_id``/``job``/``stage``/``stage_attempt`` — job-trace
#: coordinates (obs/trace.py TraceContext) stamped onto spans, rollup
#: windows, heartbeats and admission lines when a job is being traced
#: ("" / 0 outside any job context), + auxiliary ``{"kind": "job"}``
#: summary lines (obs/trace.py JOB_FIELDS — per-stage critical-path
#: profiles, stage:idle, the per-job verdict). v11↔v12 interchange is
#: the usual drop-unknown/default-missing contract, pinned both
#: directions by tests/test_trace.py.
#: v13: + auxiliary ``{"kind": "plan"}`` lines (plan/executor.py
#: PLAN_FIELDS — one line per query-planner rewrite decision:
#: pushdown sink, exchange reuse, broadcast-join selection, stage
#: overlap, combine-gate hoist — consumed by ``shuffle_report --jobs``
#: and the missed-reuse doctor rule). Span fields are unchanged from
#: v12, so v12↔v13 interchange is pure kind-tolerance like v10↔v11:
#: a v12 reader skips the unknown kind, a v13 reader reads v12 lines
#: verbatim (pinned both directions by tests/test_trace.py and
#: tests/test_obs.py).
#: v14: + auxiliary ``{"kind": "lease"}`` lines (service/rpc.py
#: LEASE_FIELDS — one line per RPC-lease lifecycle event: grant on
#: ``hello``, expire when a client misses its heartbeats and the
#: server reaps the session like a clean close, close on ``goodbye``,
#: adopt when a relaunched daemon re-adopts checkpointed exchange
#: output via ``resume_segments`` — consumed by ``shuffle_top``'s
#: lease table). Span fields are unchanged from v13, so v13↔v14
#: interchange is pure kind-tolerance like v12↔v13 (pinned both
#: directions by tests/test_service_rpc.py).
SCHEMA_VERSION = 14


@dataclasses.dataclass
class ExchangeSpan:
    """One shuffle read's observables — the journal line, typed.

    The superset of the legacy ``ExchangeRecord``; every field is plain
    JSON (lists, not ndarrays) so a line round-trips losslessly.
    """

    span_id: int
    shuffle_id: int
    transport: str
    rounds: int
    dispatches: int
    records: int
    record_bytes: int                      # bytes per record
    plan_s: float
    exchange_s: float
    sort_s: float
    per_peer_records: List[int]
    pool_high_water: int = 0
    spill_count: int = 0
    retry_count: int = 0
    # --- multi-host identity (schema v2) ---
    process_index: int = 0
    host_count: int = 1
    # --- in-span event timeline (schema v2); see obs/timeline.py ---
    events: List[Dict] = dataclasses.field(default_factory=list)
    # --- sampling (schema v3): reads this span stands for (>=1) ---
    sample_weight: int = 1
    # --- host serde codec totals (schema v4) — PROCESS-CUMULATIVE like
    # ``spill_count``: consumers diff consecutive spans for rates ---
    serde_encode_bytes: int = 0
    serde_encode_s: float = 0.0
    serde_decode_bytes: int = 0
    serde_decode_s: float = 0.0
    # --- recovery hardening (schema v5) ---
    # per-attempt backoff sleeps (ms) taken by this read's retry loop;
    # len(backoff_ms) <= retry_count (backoff may be disabled)
    backoff_ms: List[float] = dataclasses.field(default_factory=list)
    # degradations taken so far when the span was emitted (the port's
    # rungs: "broadcast_join", "plan_overlap") — see faults.py
    degraded: List[str] = dataclasses.field(default_factory=list)
    # --- tiered out-of-core store totals (schema v6) — PROCESS-CUMULATIVE
    # like ``spill_count``: consumers diff consecutive spans. A read that
    # raised ``store_sync_fetches`` blocked on disk (prefetch miss) ---
    store_spill_bytes: int = 0
    store_fetch_bytes: int = 0
    store_prefetch_hits: int = 0
    store_sync_fetches: int = 0
    # --- multi-tenant service identity (schema v7): "" when the read
    # ran outside a service session (single-tenant compat) ---
    tenant: str = ""
    # --- columnar codec share of the v4 serde totals (schema v8) —
    # PROCESS-CUMULATIVE; pickle-path share = v4 total − columnar ---
    serde_columnar_encode_bytes: int = 0
    serde_columnar_encode_s: float = 0.0
    serde_columnar_decode_bytes: int = 0
    serde_columnar_decode_s: float = 0.0
    # --- pre-exchange reduction accounting (schema v9) — PER-SPAN, not
    # cumulative: the measured map-side-combine wire reduction
    # (in/out records and bytes of THIS read's exchange), the combine
    # gate's sampled duplicate-key ratio (journaled for every
    # aggregator read so the doctor can flag combines that should have
    # run), and the predicate/projection pushdown deltas ---
    combine_in_records: int = 0
    combine_out_records: int = 0
    combine_in_bytes: int = 0
    combine_out_bytes: int = 0
    combine_dup_ratio: float = 0.0
    pushdown_rows_dropped: int = 0
    pushdown_words_dropped: int = 0
    # --- critical-path attribution (schema v10) — PER-SPAN: seconds
    # per pipeline phase (obs/critical_path.py PHASES; sums to the
    # span's wall-clock) and the derived bottleneck verdict ---
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    bottleneck: str = ""
    # --- job-trace coordinates (schema v12) — stamped from the active
    # obs/trace.py JobTrace; the defaults mean "outside any job" ---
    trace_id: str = ""
    job: str = ""
    stage: str = ""
    stage_attempt: int = 0
    ts: float = dataclasses.field(default_factory=time.time)
    schema: int = SCHEMA_VERSION

    @property
    def total_bytes(self) -> int:
        return self.records * self.record_bytes

    def to_dict(self) -> dict:
        # the fields in declaration order, as dataclasses.asdict gives
        # them, without its deep copy of the events: the same JSON line,
        # in a quarter of the host time for a streaming read's span
        d = {f.name: getattr(self, f.name) for f in _SPAN_FIELDS}
        d["total_bytes"] = self.total_bytes
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExchangeSpan":
        # forward/backward compat: unknown keys dropped, missing keys
        # defaulted — the cross-version contract (see module docstring)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_SPAN_FIELDS = dataclasses.fields(ExchangeSpan)

_span_id_lock = threading.Lock()
_span_id_next = 0


def next_span_id() -> int:
    """Process-wide monotone span id (shared across managers, so trace
    annotations never collide even with several managers alive)."""
    global _span_id_next
    with _span_id_lock:
        _span_id_next += 1
        return _span_id_next


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer — a fixed, platform-independent integer hash.

    The sampling decision must be a pure function of the span id (same
    id → same keep/drop on every host, every run, every Python), so it
    cannot use ``hash()`` (salted per process) or anything seeded.
    """
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """Per-read keep/drop policy for full-span emission.

    Parsed from ``ShuffleConf.journal_sample``:

    - ``all`` — keep every span (default; weight 1);
    - ``1/N`` — keep a deterministic 1-in-N subset, chosen by a fixed
      hash of the span id (kept spans carry ``sample_weight=N``);
    - ``slow:<ms>`` — always keep spans whose exchange+sort wall-clock
      is at least ``<ms>`` milliseconds (weight 1 — an outlier only
      represents itself);
    - ``1/N+slow:<ms>`` — union of both rules.

    :meth:`keep_weight` returns 0 to drop, else the span's
    ``sample_weight``. Dropped spans must still be folded into metrics
    and rollups by the caller — sampling thins the *detail*, never the
    aggregates.
    """

    rate: int = 1          # keep 1 in ``rate`` spans (1 = all)
    slow_ms: float = 0.0   # always keep spans at least this slow (0 = off)

    @classmethod
    def parse(cls, spec: Optional[str]) -> "SamplingPolicy":
        def bad(why: str) -> ValueError:
            return ValueError(
                f"bad journal_sample spec {spec!r} ({why}): expected 'all', "
                f"'1/N', 'slow:<ms>', or '1/N+slow:<ms>'")

        rate, slow = 1, 0.0
        for part in (spec or "all").strip().split("+"):
            part = part.strip()
            if part == "all":
                pass
            elif part.startswith("1/"):
                try:
                    rate = int(part[2:])
                except ValueError:
                    raise bad(f"unparsable rate {part!r}") from None
                if rate < 1:
                    raise bad("N must be >= 1")
            elif part.startswith("slow:"):
                try:
                    slow = float(part[5:])
                except ValueError:
                    raise bad(f"unparsable threshold {part!r}") from None
                if slow < 0 or slow != slow:  # negative or NaN
                    raise bad("threshold must be >= 0 ms")
            else:
                raise bad(f"unknown term {part!r}")
        return cls(rate=rate, slow_ms=slow)

    @property
    def samples_all(self) -> bool:
        return self.rate <= 1

    def keep_weight(self, span_id: int, elapsed_s: float) -> int:
        """0 = drop the span; N > 0 = keep it with ``sample_weight=N``."""
        if self.rate <= 1:
            return 1
        if _mix64(span_id) % self.rate == 0:
            return self.rate
        if self.slow_ms > 0.0 and elapsed_s * 1e3 >= self.slow_ms:
            return 1
        return 0


class ExchangeJournal:
    """Append-only JSON-lines sink for :class:`ExchangeSpan` records.

    ``sink`` may be a filesystem path (opened lazily, append mode — the
    file is only created once a span is actually emitted, so a disabled
    or idle journal leaves no artifact), a file-like object (tests,
    in-memory capture), or None/"" (disabled: :meth:`emit` is a no-op
    and no I/O ever happens).

    ``max_bytes`` > 0 enables size-based rotation for path sinks: when a
    write pushes the live segment past the cap, existing segments shift
    (``j.1`` → ``j.2``, …), the live file is atomically renamed to
    ``j.1`` and a fresh segment starts. ``rotations`` counts how often
    (mirrored to the ``journal.rotations`` metric).

    **A journal failure must never kill a shuffle**: the first
    ``OSError`` on open/write disables the sink, logs once, and bumps
    ``journal.write_errors`` in ``metrics`` (when provided); the read
    that triggered it — and every later read — completes normally,
    journal-less. Observability is a passenger, not a copilot.
    """

    def __init__(self, sink: Union[str, IO[str], None] = None,
                 metrics=None, max_bytes: int = 0):
        self._path: Optional[str] = None    # guarded-by: _lock
        self._fh: Optional[IO[str]] = None  # guarded-by: _lock
        self._own_fh = False                # guarded-by: _lock
        self._lock = threading.Lock()
        self._metrics = metrics
        self.max_bytes = int(max_bytes)
        # bytes in the live segment
        self._seg_bytes = 0                 # guarded-by: _lock
        self.emitted = 0                    # guarded-by: _lock
        #: completed size-based rotations of the live segment
        self.rotations = 0                  # guarded-by: _lock
        #: write failures observed (after the first, the sink is dead)
        self.write_errors = 0               # guarded-by: _lock
        if sink is None or sink == "":
            pass
        elif isinstance(sink, str):
            self._path = sink
        elif isinstance(sink, io.IOBase) or hasattr(sink, "write"):
            self._fh = sink
        else:
            raise TypeError(f"unsupported journal sink {sink!r}")

    @property
    def enabled(self) -> bool:
        # deliberately lock-free: emit()'s fast path when journaling is
        # off must cost one attribute read, and a stale True only sends
        # one more line into _write_line's own locked/guarded path
        # srlint: ignore[guarded-by] -- racy read is the documented contract
        return self._path is not None or self._fh is not None

    def emit(self, span: ExchangeSpan) -> None:
        if not self.enabled:
            return
        self._write_line(span.to_dict())

    def emit_raw(self, entry: dict) -> None:
        """Append an auxiliary (non-span) line — MUST carry ``"kind"``.

        Stall, rollup and heartbeat records use this;
        :func:`read_journal` skips such lines, :func:`read_entries`
        surfaces them.
        """
        if not self.enabled:
            return
        if "kind" not in entry:
            raise ValueError("auxiliary journal lines must carry 'kind'")
        self._write_line(entry)

    def _write_line(self, d: dict) -> None:   # never-raises
        line = json.dumps(d, separators=(",", ":"))
        # _lock IS the serializing writer lock: its entire purpose is to
        # keep concurrent emitters' line writes (and segment rotation)
        # from interleaving in the sink, so the file I/O has to happen
        # inside it. It is a leaf lock — nothing is called under it that
        # can take another lock — and every emitter goes through here.
        with self._lock:
            try:
                if self._fh is None:
                    # lazy sink open is part of the serialized write
                    # path # srlint: ignore[blocking-under-lock]
                    self._fh = open(self._path, "a", encoding="utf-8")
                    self._own_fh = True
                    try:
                        self._seg_bytes = os.fstat(self._fh.fileno()).st_size
                    except (OSError, AttributeError, ValueError):
                        self._seg_bytes = 0
                self._fh.write(line + "\n")   # srlint: ignore[blocking-under-lock]
                self._fh.flush()              # srlint: ignore[blocking-under-lock]
                self.emitted += 1
                self._seg_bytes += len(line) + 1
                if (self.max_bytes > 0 and self._own_fh
                        and self._path is not None
                        and self._seg_bytes >= self.max_bytes):
                    self._rotate_locked()
            except OSError as e:
                # disable on first failure: one loud log line, then the
                # journal goes quiet instead of failing every read
                self.write_errors += 1
                log.error("journal sink failed (%s); journaling disabled "
                          "for this manager", e)
                if self._own_fh and self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                self._fh = None
                self._path = None
                self._own_fh = False
                if self._metrics is not None:
                    self._metrics.counter("journal.write_errors").inc()

    def _rotate_locked(self) -> None:
        """Shift ``j.N`` → ``j.N+1`` and rename the live file to ``j.1``.

        Caller holds ``_lock``. Renames are atomic (``os.replace``), so
        a concurrent tailer sees either the old or the new name — never
        a torn file. A failed rotation follows the normal disable path
        via the caller's ``except OSError``.
        """
        self._fh.close()
        self._fh = None
        self._own_fh = False
        n = 1
        while os.path.exists(f"{self._path}.{n}"):
            n += 1
        for i in range(n, 1, -1):
            os.replace(f"{self._path}.{i - 1}", f"{self._path}.{i}")
        os.replace(self._path, f"{self._path}.1")
        self._seg_bytes = 0
        self.rotations += 1
        if self._metrics is not None:
            self._metrics.counter("journal.rotations").inc()

    def close(self) -> None:   # never-raises
        """Close owned sinks; flush (but never close) borrowed ones.

        Registered at manager shutdown (``ShuffleManager.stop``) so
        buffered file-like sinks are flushed even when the process exits
        without another emit.
        """
        with self._lock:
            if self._fh is None:
                return
            try:
                if self._own_fh:
                    self._fh.close()
                    self._fh = None
                else:
                    # borrowed sink: flush under the same writer lock
                    # that serializes emits (leaf lock, see _write_line)
                    # srlint: ignore[blocking-under-lock]
                    self._fh.flush()
            except OSError:
                pass


def rotated_paths(path: str) -> List[str]:
    """Every existing segment of a (possibly rotated) journal,
    oldest-first: ``[j.K, ..., j.2, j.1, j]``."""
    out: List[str] = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        out.append(f"{path}.{n}")
        n += 1
    out.reverse()
    if os.path.exists(path) or not out:
        out.append(path)
    return out


def iter_entries(path: str, errors: Optional[List[str]] = None,
                 include_rotated: bool = False) -> Iterator[dict]:
    """Stream journal lines as dicts, one at a time.

    Corrupt lines — e.g. a truncated tail left by a killed process —
    are skipped (and described in ``errors`` when a list is passed)
    instead of raising: one bad byte must not make a gigabyte of
    telemetry unreadable. ``include_rotated`` walks rotated segments
    (``path.N``) oldest-first before the live file.
    """
    paths = rotated_paths(path) if include_rotated else [path]
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError as e:
                    if errors is not None:
                        errors.append(f"{p}:{lineno}: {e}")
                    continue
                if isinstance(obj, dict):
                    yield obj
                elif errors is not None:
                    errors.append(f"{p}:{lineno}: not a JSON object")


def read_entries(path: str, errors: Optional[List[str]] = None,
                 include_rotated: bool = False) -> List[dict]:
    """Parse every journal line (spans AND auxiliary records) as dicts.

    Built on :func:`iter_entries` — corrupt lines are skipped, not
    fatal; pass ``errors=[]`` to collect their descriptions.
    """
    return list(iter_entries(path, errors=errors,
                             include_rotated=include_rotated))


def read_journal(path: str, include_rotated: bool = False
                 ) -> List[ExchangeSpan]:
    """Parse a journal file back into spans (blank lines skipped;
    auxiliary ``kind``-tagged lines — stall/rollup/heartbeat records —
    skipped too)."""
    return [ExchangeSpan.from_dict(d)
            for d in iter_entries(path, include_rotated=include_rotated)
            if d.get("kind") in (None, "span")]


__all__ = ["ExchangeSpan", "ExchangeJournal", "SamplingPolicy",
           "read_journal", "read_entries", "iter_entries", "rotated_paths",
           "next_span_id", "SCHEMA_VERSION"]
