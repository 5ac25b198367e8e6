"""Shuffle configuration — a trimmed copy of ``sparkrdma_tpu.config``.

Only the knobs the ported paths read are kept (TeraSort, the aggregation
path with its map-side combine gate, the streaming regime with its
``queue_depth`` pacing, the slot pool, the pack/wide sort modes, and the
out-of-core path: host staging, the tiered store and segment
checkpoints; the query planner's rewrite gates and the host codec's
chunking; the whole-shuffle checkpoint, the reader's retry loop and
the fault plane; the observability knobs of the journal, the read
stats and the stall watchdog, of the live telemetry and alert layer,
and of the multi-tenant service), under the reference's names and with
its defaults, so a
configuration written for one package means the same thing to the
other. The reference's
``combine_fallback`` and ``transport_fallback`` rungs are not kept at
all, because a map-side combine or a transport that fails raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from sparkrdma_tpu_torch.faults import parse_fault_spec

DEFAULT_KEY_WORDS = 2
DEFAULT_VAL_WORDS = 2

#: transports the port implements: ``"xla"`` is the plain stacked
#: permute (one ``all_to_all_single`` across processes),
#: ``"pallas_ring"`` the hand-written CUDA exchange kernel (one process),
#: ``"hierarchical"`` the two-stage exchange of
#: ``exchange/hierarchical.py``
_TRANSPORTS = ("xla", "pallas_ring", "hierarchical")


def _parse_prealloc(spec: str) -> Dict[int, int]:
    """Parse a ``"records:count,records:count"`` prealloc spec (SparkRDMA's
    ``preAllocateBuffers`` "size:count,..." form)."""
    out: Dict[int, int] = {}
    spec = spec.strip()
    if not spec:
        return out
    for item in spec.split(","):
        size_s, _, count_s = item.partition(":")
        size, count = int(size_s), int(count_s)
        if size <= 0 or count <= 0:
            raise ValueError(f"invalid prealloc entry {item!r}")
        out[size] = out.get(size, 0) + count
    return out


@dataclasses.dataclass(frozen=True)
class ShuffleConf:
    """All knobs for a shuffle job (the slice's subset of the reference)."""

    # --- exchange geometry ---
    slot_records: int = 4096          # records per (src,dst) slot per round
    max_rounds: int = 64              # static upper bound on rounds
    #: rounds run by one fused exchange; a plan with more rounds streams
    #: them in chunks of this many rounds each (the bytes-in-flight
    #: throttle of SparkRDMA's fetcher)
    max_rounds_in_flight: int = 2
    #: streaming chunks outstanding before the host waits for the oldest
    #: (recvQueueDepth: bounds the live receive chunks)
    queue_depth: int = 8

    # --- record geometry ---
    key_words: int = DEFAULT_KEY_WORDS   # uint32 words per key
    val_words: int = DEFAULT_VAL_WORDS   # uint32 words per payload

    # --- slot pool (RdmaBufferManager analogues) ---
    prealloc: str = ""                # "records:count,..." warm classes
    max_slot_records: int = 1 << 22   # refuse larger single allocations

    # --- transport ---
    transport: str = "xla"
    #: pallas_ring only: all rounds in one kernel launch, with the size
    #: exchange riding a prefix lane of round 0
    ring_fused: bool = True
    #: host-group count for the hierarchical transport; 0 = auto from the
    #: process group (partitions per host = partitions / processes, the
    #: cards of one process standing for one host's)
    hierarchy_hosts: int = 0
    #: "pow2" or "fine" size classes for slot and output capacity
    geometry_classes: str = "pow2"

    # --- reduce-side sort ---
    #: merge-path sort for key-ordered reads when the output capacity is
    #: a power of two holding at least two runs
    fast_sort: bool = False
    fast_sort_run: int = 1 << 15
    #: keep arrival order within equal keys (disables the merge-path sort)
    stable_key_sort: bool = False
    #: payload widths that select the reference's "wide" / "pack" sort
    #: modes (0 disables). Every mode here is one stable key sort plus one
    #: gather, so the mode and ``wide_sort_ride_words`` name the
    #: reference's strategy but never change a result
    wide_sort_min_payload: int = 20
    wide_sort_ride_words: int = 10
    pack_sort_min_payload: int = 20

    # --- observability (obs/) ---
    #: keep an ``ExchangeRecord`` per recorded read in the manager's
    #: ``stats`` (printed as a per-source table on ``stop``) and feed the
    #: ``shuffle.*`` counters and the ``shuffle.exec_s`` histogram
    collect_shuffle_read_stats: bool = False
    #: exchange-journal sink: a filesystem path that receives one JSON
    #: line per recorded read (``obs/journal.py``; the reference's
    #: schema, read by ``scripts/shuffle_report.py`` and
    #: ``scripts/shuffle_trace.py``), plus ``stall``, ``job`` and
    #: ``plan`` lines. Empty: journal off, and the timeline with it. A
    #: literal ``{process}`` in the path expands to the runtime's process
    #: index
    metrics_sink: str = ""
    #: stall watchdog (``obs/watchdog.py``): a streaming exchange's wait
    #: for a chunk that exceeds this many seconds logs and journals a
    #: ``stall`` line with the in-flight state while the wait goes on.
    #: 0 disables. Size it well above a healthy chunk's wall-clock
    watchdog_timeout_s: float = 0.0
    #: span sampling (``obs/journal.py SamplingPolicy``): "all", "1/N"
    #: (a deterministic 1-in-N by span id, kept spans weighted N),
    #: "slow:<ms>" (every read at least that slow), or "1/N+slow:<ms>".
    #: Sampled-away reads still feed the metrics
    journal_sample: str = "all"
    #: rotate the live journal file past this many bytes (``<sink>.1``,
    #: ``.2``, …); 0 never rotates
    journal_max_bytes: int = 0
    #: windowed rollups (``obs/rollup.py``): with a journal, every read
    #: is folded into per-shuffle windows of this many seconds, one
    #: ``{"kind": "rollup"}`` line a window, exact whatever
    #: ``journal_sample`` keeps. 0 disables
    rollup_window_s: float = 30.0
    #: with a journal, a ``{"kind": "heartbeat"}`` line every this many
    #: seconds (process identity, uptime, reads in flight, pool
    #: occupancy, rss), from a thread. 0 disables
    heartbeat_s: float = 0.0
    #: live telemetry store (``obs/tsdb.py``): a thread snapshots every
    #: scalar metric into a bounded ring this often (rates, deltas, the
    #: probe's view). Needs ``collect_shuffle_read_stats`` or
    #: ``metrics_sink``; 0 disables
    telemetry_window_s: float = 0.0
    #: samples kept per series, and rollup windows per shuffle
    telemetry_history: int = 120
    #: probe endpoint (``obs/probe.py``) on ``127.0.0.1``: journal,
    #: snapshot, Prometheus text, alerts, health and jobs, for
    #: ``scripts/shuffle_top.py --connect``. -1 disables; 0 binds an
    #: ephemeral port (``manager.probe.port``)
    probe_port: int = -1
    #: alert evaluator (``obs/alerts.py``): every this many seconds a
    #: thread evaluates the rules against the telemetry store and
    #: journals ``{"kind": "alert"}`` fire and resolve lines. Needs the
    #: telemetry store; 0 disables
    alert_eval_s: float = 0.0
    #: consecutive breaching evaluations before an alert fires
    alert_fire_breaches: int = 3
    #: consecutive clean evaluations before an active alert resolves
    alert_resolve_windows: int = 2
    #: persisted baselines (``obs/baseline.py``) in
    #: ``<baseline_dir>/baselines.json``; empty disables
    baseline_dir: str = ""

    # --- map-side combine (pre-exchange reduction) ---
    #: map-side combine policy for aggregator shuffles: "auto" (a sampled
    #: duplicate-ratio estimate gates it per shuffle), "on", "off"
    map_side_combine: str = "auto"
    #: leading rows of partition 0 sampled for the "auto" gate's estimate;
    #: 0 skips sampling and makes "auto" behave as "on"
    combine_sample_rows: int = 1024
    #: sampled duplicate ratio (1 - unique/sample) at which "auto" turns
    #: the map-side combine on
    combine_min_dup_ratio: float = 0.25

    # --- query planner (plan/ package) rewrite gates ---
    #: sink plan-level ``filter``/``select`` nodes below layout-preserving
    #: exchanges into the earliest downstream exchange's
    #: ``row_filter``/``keep_words``, and hoist the combine gate's sample
    #: to plan time. Off: each filter/select materializes eagerly, so
    #: dropped rows still ride the wire as null-key filler. Results are
    #: bit-identical either way
    plan_pushdown: bool = True
    #: adopt the output of an earlier exchange with the same canonical
    #: fingerprint instead of exchanging again (and, with ``spill_dir``,
    #: persist it through ``checkpoint_segments`` for a restarted
    #: executor to resume)
    plan_reuse: bool = True
    #: a dimension-lookup join whose build side's plan-time row count
    #: fits ``plan_broadcast_records`` replicates that side to every
    #: partition and neither side exchanges. A build side with duplicate
    #: keys degrades the join to the shuffle join (``plan/executor.py``)
    plan_broadcast_join: bool = True
    #: encode a deferred host source of a join's dimension side on a
    #: background worker while the fact side's exchanges run
    plan_overlap: bool = True
    #: most build-side rows a broadcast join may replicate (0 never
    #: broadcasts)
    plan_broadcast_records: int = 4096

    # --- byte-payload serde (api/serde.py, api/pipeline.py) ---
    #: records per chunk of the pipelined host <-> device load: the host
    #: encodes chunk k+1 while chunk k is copied to the device. 0 loads
    #: in one shot
    serde_chunk_records: int = 1 << 20
    #: run the row codecs in the C++ library (``native/staging.cpp``,
    #: built with g++ at first use; its threads run with the GIL
    #: released). True needs the library: a failed build, a big-endian
    #: host or an unknown CPython bytes layout raises ``RuntimeError``.
    #: False is the numpy codec. Rows are bit-identical either way: the
    #: knob only trades speed
    serde_native: bool = True
    #: threads of one native codec call; 0: ``min(8, os.cpu_count())``
    serde_threads: int = 0
    #: schema-declared byte payloads take the columnar (v2) codec; False
    #: pins them to the v1 padded-slot codec. Rows are bit-identical
    #: either way (``from_host_columns`` / ``to_host_columns`` always
    #: use the columnar layout)
    serde_schema_columnar: bool = True

    # --- host staging / spill ---
    #: with ``spill_dir``: ``ShuffleWriter.stop`` checkpoints the published
    #: map output whole (``ShuffleManager.checkpoint_shuffle``), so that a
    #: read whose map output is lost, or a restarted manager, resumes it
    #: without running the map stage again; without ``spill_dir`` there
    #: is no store and nothing is written, as in the reference
    spill_to_host: bool = False
    spill_dir: str = ""               # checkpoint root (empty = no store)
    #: host pools, spill writes, checkpoints and file reads go through
    #: the C++ staging library (``native/staging.cpp``: an aligned pool,
    #: ``sr_write_file`` / ``sr_read_file``, a C spooler thread). True
    #: needs the library and raises ``RuntimeError`` if it cannot be
    #: built; False is the numpy path. Files are byte-identical either way
    use_native_staging: bool = True
    #: codec for spill runs and checkpoints: "" (off), "zlib" or "lzma";
    #: files self-describe, so readers need not know it
    compression: str = ""
    compression_level: int = 1        # zlib 1-9 / lzma preset 0-9

    # --- tiered out-of-core store (hbm/tiered_store.py) ---
    #: disk-segment root; empty falls back to ``spill_dir``; with both
    #: empty an eviction that needs disk leaves the segment on the host
    spill_tier_dir: str = ""
    #: host-tier watermark in bytes: past it the store's writer thread
    #: evicts least-recently-used unpinned segments to disk (a
    #: steady-state target, not a hard cap: eviction is asynchronous)
    spill_tier_host_bytes: int = 1 << 28
    #: disk -> host promotions kept in flight ahead of the consumer (0
    #: disables prefetch; a ``get`` of a disk segment with none in flight
    #: is a synchronous fetch)
    spill_tier_prefetch: int = 2
    #: reads of a disk segment whose CRC32 trailer mismatches before the
    #: read raises
    spill_tier_reread_attempts: int = 3
    #: codec of segments written to the disk tier ("", "zlib", "lzma")
    serde_schema_spill_codec: str = ""
    serde_schema_spill_level: int = 1

    # --- multi-tenant service (service/) ---
    #: default per-tenant quota of slot-pool buffers held at once (0:
    #: unlimited); a tenant at its quota blocks in the acquisition until
    #: one of its own buffers comes back, bounded by ``admission_wait_s``
    tenant_hbm_slots: int = 0
    #: default per-tenant host-tier bytes of the tiered store (0:
    #: unlimited); an over-quota put blocks while the tenant's own
    #: segments are demoted to disk
    tenant_host_bytes: int = 0
    #: default per-tenant disk-tier bytes (0: unlimited); eviction does
    #: not demote a segment of a tenant at its disk quota
    tenant_disk_bytes: int = 0
    #: reads admitted at once across all tenants by the service's
    #: deficit-round-robin controller (0: unlimited)
    admission_slots: int = 0
    #: rounds added to a waiting tenant's deficit per sweep; a read is
    #: admitted once its tenant's deficit covers its planned rounds
    admission_quantum: float = 1.0
    #: longest quota or admission wait, in seconds, before the operation
    #: fails with a clear error
    admission_wait_s: float = 300.0
    #: the service's RPC port on ``127.0.0.1`` (``service/rpc.py``): -1
    #: disables, 0 binds an ephemeral port (``service.rpc.port``)
    rpc_port: int = -1
    #: a client silent for this many seconds loses its lease, which is
    #: reaped like a clean ``close_session``; 0: leases never expire
    lease_s: float = 30.0
    #: backoff base of the RPC client's retries, in ms (0: no sleep)
    rpc_retry_ms: float = 25.0
    #: deadline across all attempts of one RPC call (0: none)
    rpc_deadline_s: float = 30.0

    # --- fault handling (faults.py, the reader's retry loop) ---
    max_retry_attempts: int = 3       # maxConnectionAttempts analogue
    #: probability of an injected fault at each exchange (draws from one
    #: seeded generator per exchange engine, as in the reference)
    fault_injection_rate: float = 0.0
    #: ``;``-joined ``site:action[@predicate]`` rules of the fault plane,
    #: e.g. ``"exchange.dispatch:fail@attempt<2;spill.read:corrupt@0.01"``;
    #: empty: no injection. Parsed when the conf is built
    fault_spec: str = ""
    #: backoff base of the retry loop: retry ``k`` sleeps about
    #: ``retry_backoff_ms * 2^(k-1)`` ms, jittered into [0.5x, 1.0x)
    #: (``faults.backoff_ms``); 0: no backoff
    retry_backoff_ms: float = 0.0
    #: once this many seconds have passed since a read's first attempt,
    #: its next failure is terminal; 0: bounded by attempts only
    retry_deadline_s: float = 0.0

    def __post_init__(self):
        if self.slot_records <= 0:
            raise ValueError("slot_records must be positive")
        if self.max_rounds <= 0 or self.max_rounds_in_flight <= 0:
            raise ValueError("max_rounds and max_rounds_in_flight must be "
                             "positive")
        if self.queue_depth <= 0:
            raise ValueError("queue_depth must be positive (it bounds "
                             "live recv-slot memory)")
        if self.max_slot_records <= 0:
            raise ValueError("max_slot_records must be positive")
        if self.max_retry_attempts <= 0:
            raise ValueError("max_retry_attempts must be positive (1 = "
                             "no retries)")
        if self.key_words <= 0 or self.val_words < 0:
            raise ValueError("key_words must be > 0 and val_words >= 0")
        if self.transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(ported: {', '.join(_TRANSPORTS)})")
        if self.hierarchy_hosts < 0:
            raise ValueError("hierarchy_hosts must be >= 0")
        if self.geometry_classes not in ("pow2", "fine"):
            raise ValueError(f"unknown geometry_classes "
                             f"{self.geometry_classes!r}")
        run = self.fast_sort_run
        if run < 128 or run & (run - 1):
            raise ValueError("fast_sort_run must be a power of two >= 128")
        if self.map_side_combine not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown map_side_combine {self.map_side_combine!r} "
                "(supported: 'auto', 'on', 'off')")
        if self.combine_sample_rows < 0:
            raise ValueError("combine_sample_rows must be >= 0 (0 = "
                             "no sampling, 'auto' behaves as 'on')")
        if not 0.0 <= self.combine_min_dup_ratio <= 1.0:
            raise ValueError("combine_min_dup_ratio must be in [0, 1]")
        for name in ("wide_sort_min_payload", "wide_sort_ride_words",
                     "pack_sort_min_payload"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        for name in ("compression", "serde_schema_spill_codec"):
            if getattr(self, name) not in ("", "zlib", "lzma"):
                raise ValueError(f"unknown {name} {getattr(self, name)!r} "
                                 "(supported: '', 'zlib', 'lzma')")
        for name in ("compression_level", "serde_schema_spill_level"):
            if not 0 <= getattr(self, name) <= 9:
                raise ValueError(f"{name} must be in [0, 9]")
        if self.plan_broadcast_records < 0:
            raise ValueError("plan_broadcast_records must be >= 0 (0 = "
                             "never broadcast)")
        if self.serde_threads < 0:
            raise ValueError("serde_threads must be >= 0 (0 = auto)")
        if self.serde_chunk_records < 0:
            raise ValueError("serde_chunk_records must be >= 0 (0 = no "
                             "chunking)")
        if self.spill_tier_host_bytes < 0:
            raise ValueError("spill_tier_host_bytes must be >= 0 (0 = "
                             "evict every unpinned host segment)")
        if self.spill_tier_prefetch < 0:
            raise ValueError("spill_tier_prefetch must be >= 0 (0 "
                             "disables prefetch)")
        if self.spill_tier_reread_attempts <= 0:
            raise ValueError("spill_tier_reread_attempts must be >= 1 "
                             "(1 = no re-reads)")
        if not 0.0 <= self.fault_injection_rate <= 1.0:
            raise ValueError("fault_injection_rate must be in [0, 1]")
        if self.retry_backoff_ms < 0:
            raise ValueError("retry_backoff_ms must be >= 0 (0 disables)")
        if self.retry_deadline_s < 0:
            raise ValueError("retry_deadline_s must be >= 0 (0 disables)")
        if self.watchdog_timeout_s < 0:
            raise ValueError("watchdog_timeout_s must be >= 0 (0 disables)")
        if self.journal_max_bytes < 0:
            raise ValueError("journal_max_bytes must be >= 0 (0 = no "
                             "rotation)")
        if self.rollup_window_s < 0:
            raise ValueError("rollup_window_s must be >= 0 (0 disables)")
        if self.heartbeat_s < 0:
            raise ValueError("heartbeat_s must be >= 0 (0 disables)")
        if self.telemetry_window_s < 0:
            raise ValueError("telemetry_window_s must be >= 0 "
                             "(0 disables)")
        if self.telemetry_history < 2:
            raise ValueError("telemetry_history must be >= 2 "
                             "(rate/delta need two samples)")
        if not -1 <= self.probe_port <= 65535:
            raise ValueError("probe_port must be in [-1, 65535] "
                             "(-1 disables, 0 = ephemeral)")
        if self.alert_eval_s < 0:
            raise ValueError("alert_eval_s must be >= 0 (0 disables)")
        if self.alert_fire_breaches < 1:
            raise ValueError("alert_fire_breaches must be >= 1 "
                             "(1 = fire on first breach)")
        if self.alert_resolve_windows < 1:
            raise ValueError("alert_resolve_windows must be >= 1 "
                             "(1 = resolve on first clean window)")
        if not -1 <= self.rpc_port <= 65535:
            raise ValueError("rpc_port must be in [-1, 65535] "
                             "(-1 disables, 0 = ephemeral)")
        if self.lease_s < 0:
            raise ValueError("lease_s must be >= 0 (0 = leases never "
                             "expire)")
        if self.rpc_retry_ms < 0:
            raise ValueError("rpc_retry_ms must be >= 0 (0 = tight "
                             "retry, no backoff sleep)")
        if self.rpc_deadline_s < 0:
            raise ValueError("rpc_deadline_s must be >= 0 "
                             "(0 = no deadline)")
        for name in ("tenant_hbm_slots", "tenant_host_bytes",
                     "tenant_disk_bytes", "admission_slots"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = unlimited)")
        if self.admission_quantum <= 0:
            raise ValueError("admission_quantum must be > 0 (rounds "
                             "refilled per DRR sweep)")
        if self.admission_wait_s < 0:
            raise ValueError("admission_wait_s must be >= 0 (0 = fail "
                             "immediately when over quota)")
        self.sampling_policy()  # validate journal_sample eagerly
        self.fault_rules()               # validate fault_spec eagerly
        _parse_prealloc(self.prealloc)  # validate eagerly

    @property
    def record_words(self) -> int:
        """Total uint32 words per record in exchange buffers."""
        return self.key_words + self.val_words

    def prealloc_classes(self) -> Dict[int, int]:
        return _parse_prealloc(self.prealloc)

    def sampling_policy(self):
        """Parsed ``journal_sample`` (``obs.journal.SamplingPolicy``)."""
        from sparkrdma_tpu_torch.obs.journal import SamplingPolicy

        return SamplingPolicy.parse(self.journal_sample)

    def fault_rules(self):
        """Parsed ``fault_spec`` (``faults.FaultRule`` list)."""
        return parse_fault_spec(self.fault_spec)

    def replace(self, **kw) -> "ShuffleConf":
        return dataclasses.replace(self, **kw)


def size_class(n_records: int) -> int:
    """Round a record count up to its power-of-two size class."""
    if n_records <= 0:
        raise ValueError("n_records must be positive")
    return 1 << (n_records - 1).bit_length()


def size_class_fine(n_records: int, bits: int = 4) -> int:
    """Round up keeping the top ``bits`` bits (padding < 1/2^bits)."""
    if n_records <= 0:
        raise ValueError("n_records must be positive")
    shift = max(0, n_records.bit_length() - 1 - bits)
    return ((n_records + (1 << shift) - 1) >> shift) << shift


__all__ = ["ShuffleConf", "size_class", "size_class_fine",
           "DEFAULT_KEY_WORDS", "DEFAULT_VAL_WORDS"]
