"""End-to-end job tracing — which *job* and *stage* owns each span.

The port's copy of ``sparkrdma_tpu.obs.trace``: the same job line, stage
vocabulary and partition invariant.

Every observability layer below this one (spans, rollups, the TSDB,
critical-path verdicts, alerts) is keyed by a single shuffle id, but
real traffic is multi-stage jobs: ``workloads/tpcds.py`` chains
exchanges, ``pagerank.py``/``als.py`` run dozens of iterations. This
module is the correlation spine that says which shuffles belong to the
same query, which stage dominated its wall-clock, and how much time
fell *between* stages:

- :class:`TraceContext` — the immutable ``(trace_id, job, stage,
  stage_attempt)`` tuple stamped onto every journal span, rollup
  window, heartbeat and admission line (journal schema v12 fields);
- :class:`JobTrace` — the job-side context manager::

      with manager.job("tpcds_q64") as job:
          with job.stage("item_join"):
              ...exchanges...
          with job.stage("group_agg"):
              ...exchanges...

  Stage scopes time their own wall-clock; spans emitted inside them
  feed their ``phase_s`` attributions back (via
  :func:`observe_active_span`, called at both emission sites), and at
  job close one ``{"kind": "job"}`` summary line lands in the journal:
  per-stage critical-path profiles (each stage's merged ``phase_s``
  padded/scaled to partition its wall — the
  :func:`~sparkrdma_tpu_torch.obs.critical_path.partition_to_wall`
  contract), the inter-stage gap charged as explicit ``stage:idle``
  time, and a per-job verdict naming the dominant stage and its
  bottleneck. The **partition invariant** (pinned by tests): the sum
  of every stage's ``phase_s`` plus ``stage_idle_s`` equals the job's
  wall-clock.

Scoping follows the fault-plane / timeline pattern: a
process-wide active job (last activation wins — the honest answer for
process-wide consumers like the heartbeat) plus a thread-local overlay
so one tenant's stages never stamp another tenant's spans. Components
with no job in reach read :func:`current_trace` and get ``None`` —
tracing is a passenger, never a prerequisite.

``JOB_FIELDS`` / ``STAGE_FIELDS`` are the authoritative key sets of
the job line and its per-stage records; ``STAGE_VOCAB`` is the declared
stage-name vocabulary the bundled workloads annotate with. The CLIs
key on all three, so ``tests/test_torch_trace.py`` holds each equal to
the reference's.

Stdlib-only on purpose, like the rest of the journal toolchain.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from sparkrdma_tpu_torch.obs import critical_path
from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION
from sparkrdma_tpu_torch.obs.timeline import record_active

#: every key a ``{"kind": "job"}`` line carries (lint-pinned: the
#: CLIs' ``jb.get("...")`` reads are checked against this set)
JOB_FIELDS = frozenset({
    "kind", "schema", "ts", "trace_id", "job", "tenant", "process_index",
    "start_ts", "wall_s", "stage_idle_s", "stage_count", "spans",
    "records", "bytes", "dominant_stage", "bottleneck", "phase_s",
    "stages",
})

#: every key a per-stage record inside ``stages`` carries (lint-pinned
#: the same way, against ``st.get("...")`` reads)
STAGE_FIELDS = frozenset({
    "stage", "attempt", "start_ts", "wall_s", "phase_s", "spans",
    "records", "bytes", "bottleneck",
})

#: the declared stage-name vocabulary — every stage the bundled
#: workloads annotate. CLI stage-advice tables key on these names
#: (lint-pinned); ad-hoc user stages are legal, they just get generic
#: remediation in ``shuffle_report --doctor``.
STAGE_VOCAB = frozenset({
    "item_join", "store_join", "group_agg",     # tpcds q64 shape
    "co_partition", "probe_join",               # tpcds q95 shape
    "rank_update",                              # pagerank iterations
    "update_users", "update_items",             # als half-steps
    "publish", "chunk_sort", "collect",         # tiered terasort
    # Dataset-verb auto-stages (api/dataset.py _exchange op= names)
    "exchange", "repartition", "sort_by_key", "reduce_by_key",
    "distinct", "group_by_key", "cogroup", "join",
    # query-planner stages (plan/executor.py)
    "plan_optimize", "broadcast_build",
})

#: the job-level phase key charging inter-stage gaps — deliberately NOT
#: in critical_path.PHASES (it exists only at job scope; per-span
#: attributions can never carry it)
STAGE_IDLE = "stage:idle"


class TraceContext:
    """Immutable trace coordinates stamped onto telemetry lines."""

    __slots__ = ("trace_id", "job", "stage", "stage_attempt")

    def __init__(self, trace_id: str, job: str, stage: str = "",
                 stage_attempt: int = 0):
        self.trace_id = trace_id
        self.job = job
        self.stage = stage
        self.stage_attempt = stage_attempt

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, {self.job!r}, "
                f"{self.stage!r}, {self.stage_attempt})")


_trace_seq_lock = threading.Lock()
_trace_seq = 0


def next_trace_id(job: str = "") -> str:
    """Process-unique trace id. The pid component keeps ids from
    colliding across a multi-host journal merge (each host stamps its
    own), the sequence keeps them unique within a process."""
    global _trace_seq
    with _trace_seq_lock:
        _trace_seq += 1
        seq = _trace_seq
    return f"t{os.getpid():x}-{seq}"


class _Stage:
    """Accumulator for one (stage, attempt) scope of a job."""

    __slots__ = ("name", "attempt", "start", "end", "phase_raw",
                 "spans", "records", "bytes", "votes")

    def __init__(self, name: str, attempt: int, start: float):
        self.name = name
        self.attempt = attempt
        self.start = start
        self.end: Optional[float] = None
        # raw per-phase sums merged from observed spans; padded to the
        # stage wall at job close (partition_to_wall)
        self.phase_raw: Dict[str, float] = {}
        self.spans = 0
        self.records = 0
        self.bytes = 0
        self.votes: Dict[str, int] = {}

    def wall_s(self, now: float) -> float:
        return max((self.end if self.end is not None else now)
                   - self.start, 0.0)

    def to_record(self, now: float) -> Dict:
        wall = round(self.wall_s(now), 6)
        d = {
            "stage": self.name,
            "attempt": self.attempt,
            "start_ts": self.start,
            "wall_s": wall,
            "phase_s": critical_path.partition_to_wall(
                self.phase_raw, wall),
            "spans": self.spans,
            "records": self.records,
            "bytes": self.bytes,
            "bottleneck": (max(sorted(self.votes),
                               key=lambda v: self.votes[v])
                           if self.votes else ""),
        }
        if set(d) != STAGE_FIELDS:
            # must survive python -O: the CLIs key on these fields
            raise RuntimeError(
                "stage record drifted from STAGE_FIELDS: "
                f"{sorted(set(d) ^ STAGE_FIELDS)}")
        return d


class _StageScope:
    """Context manager returned by :meth:`JobTrace.stage`."""

    def __init__(self, job: "JobTrace", name: str, attempt: int):
        self._job = job
        self._name = name
        self._attempt = attempt

    def __enter__(self) -> "_StageScope":
        self._job._begin_stage(self._name, self._attempt)
        return self

    def __exit__(self, *exc) -> None:
        self._job._end_stage(self._name, self._attempt)


class _NullStageScope:
    """No-op scope for :func:`stage` when no job is active."""

    def __enter__(self) -> "_NullStageScope":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_STAGE_SCOPE = _NullStageScope()


class JobTrace:
    """One job's trace: stages, span attributions, the summary line.

    Usable directly (standalone exchange callers) or via
    :meth:`ShuffleManager.job`. Entering installs this trace as both
    the current thread's scoped job AND the process-wide active job
    (heartbeats beat on their own thread); exiting restores both and
    emits the ``{"kind": "job"}`` line.
    """

    def __init__(self, job: str, *, tenant: str = "", journal=None,
                 store=None, process_index: int = 0,
                 clock: Callable[[], float] = time.time):
        self.job = job
        self.trace_id = next_trace_id(job)
        self.tenant = tenant
        self._journal = journal
        self._store = store
        self.process_index = process_index
        self._clock = clock
        self._lock = threading.Lock()
        self._stages: List[_Stage] = []              # guarded-by: _lock
        self._open: Optional[_Stage] = None          # guarded-by: _lock
        self._start: Optional[float] = None          # guarded-by: _lock
        self._closed = False                         # guarded-by: _lock
        #: the emitted job line (None until close) — a hook for tests
        self.line: Optional[Dict] = None
        self._prev_tls: Optional["JobTrace"] = None
        self._prev_global: Optional["JobTrace"] = None

    # -- scoping ------------------------------------------------------
    def __enter__(self) -> "JobTrace":
        with self._lock:
            if self._start is None:
                self._start = self._clock()
        self._prev_tls = getattr(_tls, "job", None)
        _tls.job = self
        self._prev_global = set_active_job(self)
        record_active("job", ph="B", trace_id=self.trace_id, job=self.job)
        return self

    def __exit__(self, *exc) -> None:
        record_active("job", ph="E", trace_id=self.trace_id, job=self.job)
        _tls.job = self._prev_tls
        # only un-install from the global slot if we are still it (a
        # later job activation wins, per the timeline convention)
        global _active
        with _active_lock:
            if _active is self:
                _active = self._prev_global
        self.close()

    def stage(self, name: str, attempt: int = 0) -> _StageScope:
        """Open a stage scope: ``with job.stage("probe_join"):``.
        ``attempt`` distinguishes retries and iteration rounds
        (pagerank annotates ``stage("rank_update", attempt=i)``)."""
        return _StageScope(self, name, int(attempt))

    def _begin_stage(self, name: str, attempt: int) -> None:
        now = self._clock()
        with self._lock:
            if self._open is not None:
                raise RuntimeError(
                    f"stage {self._open.name!r} is still open; stages "
                    "are sequential, not nested")
            if self._start is None:
                self._start = now
            self._open = _Stage(name, attempt, now)
        record_active("stage", ph="B", trace_id=self.trace_id,
                      job=self.job, stage=name, attempt=attempt)

    def _end_stage(self, name: str, attempt: int) -> None:
        now = self._clock()
        record_active("stage", ph="E", trace_id=self.trace_id,
                      job=self.job, stage=name, attempt=attempt)
        with self._lock:
            st = self._open
            if st is None or st.name != name or st.attempt != attempt:
                return                       # mismatched exit: tolerate
            st.end = now
            self._stages.append(st)
            self._open = None

    # -- stamping / observation ---------------------------------------
    def snapshot(self) -> TraceContext:
        """The current trace coordinates (stage empty between stages)."""
        with self._lock:
            st = self._open
            if st is None:
                return TraceContext(self.trace_id, self.job)
            return TraceContext(self.trace_id, self.job, st.name,
                                st.attempt)

    def observe_span(self, span) -> None:
        """Fold an emitted span's attribution into its stage (called by
        both emission sites after ``critical_path.enrich``). Routed by
        the span's own stamped (stage, attempt) so a span that
        completes just after its stage closed still lands there."""
        if isinstance(span, dict):
            name = span.get("stage", "")
            attempt = int(span.get("stage_attempt", 0) or 0)
            phase_s = span.get("phase_s") or {}
            bottleneck = span.get("bottleneck", "")
            records = int(span.get("records", 0) or 0)
            nbytes = int(span.get("total_bytes", 0) or 0)
        else:
            name, attempt = span.stage, span.stage_attempt
            phase_s, bottleneck = span.phase_s, span.bottleneck
            records, nbytes = span.records, span.total_bytes
        with self._lock:
            st = None
            if (self._open is not None and self._open.name == name
                    and self._open.attempt == attempt):
                st = self._open
            else:
                for cand in reversed(self._stages):
                    if cand.name == name and cand.attempt == attempt:
                        st = cand
                        break
            if st is None:
                return           # span from outside any stage scope
            st.spans += 1
            st.records += records
            st.bytes += nbytes
            if isinstance(phase_s, dict):
                for p, v in phase_s.items():
                    if p in critical_path.PHASES:
                        st.phase_raw[p] = (st.phase_raw.get(p, 0.0)
                                           + float(v or 0.0))
            if bottleneck in critical_path.VERDICTS:
                st.votes[bottleneck] = st.votes.get(bottleneck, 0) + 1

    # -- close / emission ---------------------------------------------
    def build_line(self, now: Optional[float] = None) -> Dict:
        """The ``{"kind": "job"}`` summary line (pure; close() emits).

        Partition invariant: ``sum(stage phase_s) + stage_idle_s ==
        wall_s`` — each stage's profile partitions its own wall
        (partition_to_wall) and the idle term is the remainder of the
        job wall not covered by any stage.
        """
        now = self._clock() if now is None else now
        with self._lock:
            start = self._start if self._start is not None else now
            stages = list(self._stages)
            if self._open is not None:
                stages.append(self._open)
        wall = max(now - start, 0.0)
        recs = [st.to_record(now) for st in stages]
        stage_wall = sum(r["wall_s"] for r in recs)
        idle = round(max(wall - stage_wall, 0.0), 6)
        # job-level profile: merged stage phases + the explicit idle key
        phase_s: Dict[str, float] = {}
        for r in recs:
            for p, v in r["phase_s"].items():
                phase_s[p] = round(phase_s.get(p, 0.0) + v, 6)
        if idle > 0:
            phase_s[STAGE_IDLE] = idle
        dominant = max(recs, key=lambda r: r["wall_s"]) if recs else None
        d = {
            "kind": "job",
            "schema": SCHEMA_VERSION,
            "ts": now,
            "trace_id": self.trace_id,
            "job": self.job,
            "tenant": self.tenant,
            "process_index": self.process_index,
            "start_ts": start,
            "wall_s": round(wall, 6),
            "stage_idle_s": idle,
            "stage_count": len(recs),
            "spans": sum(r["spans"] for r in recs),
            "records": sum(r["records"] for r in recs),
            "bytes": sum(r["bytes"] for r in recs),
            "dominant_stage": dominant["stage"] if dominant else "",
            "bottleneck": dominant["bottleneck"] if dominant else "",
            "phase_s": phase_s,
            "stages": recs,
        }
        if set(d) != JOB_FIELDS:
            # must survive python -O: the CLIs key on these fields
            raise RuntimeError(
                "job line drifted from JOB_FIELDS: "
                f"{sorted(set(d) ^ JOB_FIELDS)}")
        return d

    def close(self, now: Optional[float] = None) -> Optional[Dict]:
        """Emit the job line (idempotent; returns the line)."""
        with self._lock:
            if self._closed:
                return self.line
            self._closed = True
        line = self.build_line(now)
        self.line = line
        if self._journal is not None:
            self._journal.emit_raw(line)
        if self._store is not None:
            self._store.observe_job(line)
        return line


# ---------------------------------------------------------------------
# process-wide active job + thread-local overlay — the fault-plane /
# timeline scoping pattern. Emission sites read current_trace() /
# observe_active_span(); a thread-scoped job (tenant session) takes
# precedence over the process-wide one.
# ---------------------------------------------------------------------
_active_lock = threading.Lock()
_active: Optional[JobTrace] = None
_tls = threading.local()


def set_active_job(job: Optional[JobTrace]) -> Optional[JobTrace]:
    """Install the process-wide active job; returns the previous."""
    global _active
    with _active_lock:
        prev, _active = _active, job
    return prev


class scoped_job:
    """Context manager: install ``job`` as the CURRENT THREAD's active
    job (restores the prior thread scope on exit). ``scoped_job(None)``
    is a pass-through — wiring sites stay unconditional."""

    def __init__(self, job: Optional[JobTrace]):
        self._job = job
        self._prev: Optional[JobTrace] = None

    def __enter__(self) -> "scoped_job":
        if self._job is not None:
            self._prev = getattr(_tls, "job", None)
            _tls.job = self._job
        return self

    def __exit__(self, *exc) -> None:
        if self._job is not None:
            _tls.job = self._prev


def active_job() -> Optional[JobTrace]:
    """The job in scope on this thread (thread-local first, then the
    process-wide slot; None when no job is being traced)."""
    job = getattr(_tls, "job", None)
    if job is None:
        job = _active
    return job


def current_trace() -> Optional[TraceContext]:
    """The trace coordinates to stamp onto a telemetry line right now
    (None when no job is active — emitters fall back to the schema
    defaults: empty strings, attempt 0)."""
    job = active_job()
    return job.snapshot() if job is not None else None


def observe_active_span(span) -> None:
    """Feed an enriched span back into the job it was stamped for
    (no-op without an active job)."""
    job = active_job()
    if job is not None:
        job.observe_span(span)


def stage(name: str, attempt: int = 0):
    """Workload-side stage annotation: opens a stage on the active job
    if one is being traced, else a no-op scope — so workloads annotate
    unconditionally and run identically outside a job context."""
    job = active_job()
    if job is None:
        return _NULL_STAGE_SCOPE
    return job.stage(name, attempt)


def auto_stage(name: str, attempt: int = 0):
    """Like :func:`stage`, but ALSO a no-op when a stage is already
    open — for library layers (the Dataset API) that annotate on the
    caller's behalf and must defer to any explicit ``job.stage(...)``
    scope already in force rather than raise on nesting."""
    job = active_job()
    if job is None:
        return _NULL_STAGE_SCOPE
    with job._lock:
        if job._open is not None:
            return _NULL_STAGE_SCOPE
    return job.stage(name, attempt)


__all__ = ["TraceContext", "JobTrace", "JOB_FIELDS", "STAGE_FIELDS",
           "STAGE_VOCAB", "STAGE_IDLE", "next_trace_id",
           "set_active_job", "scoped_job", "active_job",
           "current_trace", "observe_active_span", "stage",
           "auto_stage"]
