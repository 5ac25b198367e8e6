"""Canonical metric-name registry of the port — every counter, gauge,
histogram and timeline counter-track that ``sparkrdma_tpu_torch`` emits.

The port's own list, beside the reference's ``sparkrdma_tpu.obs.names``:
the names are the contract the reference's CLIs read back out of
journals and registry snapshots by string. The port's srlint rule
``counter-name-sync`` (``sparkrdma_tpu_torch/lint/rules_sync.py``, run by
``scripts/torch_srlint.py`` and ``tests/test_torch_lint.py``) holds it
both ways: every ``.counter("...")`` / ``.gauge("...")`` /
``.histogram("...")`` name the port emits must be declared here, every
name declared here must have an emission site, and every metric the
CLIs read back must be declared. Dynamic families
(``f"faults.{site}"``) are declared as wildcard patterns in
:data:`WILDCARDS`; an f-string whose holes are parameters of a helper
(``api/serde.py``'s ``_count``) is read with each caller's literals
filled in. ``tests/test_torch_obs.py`` keeps its own AST scan as well.

Stdlib only (``frozenset``), so the lint can read it with ``ast``.
"""

from __future__ import annotations

#: Monotonic counters (``registry.counter(name)``).
COUNTERS = frozenset({
    "staging.spills",
    "staging.spill_bytes",
    "pool.hits",
    "pool.misses",
    "meta.registrations",
    "meta.map_outputs_published",
    "meta.map_records_published",
    "journal.write_errors",
    "journal.rotations",
    "journal.sampled_out",
    "shuffle.exchanges",
    "shuffle.records",
    "shuffle.bytes",
    "shuffle.rounds",
    "transport.ring.kernels",
    "transport.ring.fused_kernels",
    "transport.ring.fused_rounds",
    "transport.ring.overlap_rounds",
    "transport.hier.flat_fallbacks",
    "transport.hier.staged_exchanges",
    "watchdog.stalls",
    "exchange.faults",
    "exchange.plans",
    "exchange.plan_passes_kernel",
    "exchange.plan_passes_plain",
    "exchange.map_passes_kernel",
    "exchange.map_passes_plain",
    "exchange.key_sorts_kernel",
    "exchange.key_sorts_plain",
    "exchange.queue_blocks",
    "exchange.stream_chunks",
    "exchange.dispatches",
    "exchange.slots_moved",
    "exchange.reduce_combine_in_records",
    "exchange.reduce_combine_out_records",
    "exchange.exchanges",
    "exchange.rounds",
    "exchange.records",
    "combine.gate_on",
    "combine.gate_off",
    "pushdown.filters",
    "pushdown.projections",
    "plan.pushdown_sunk",
    "plan.reuse_hits",
    "plan.broadcast_joins",
    "plan.overlapped_stages",
    "store.puts",
    "store.put_bytes",
    "store.spill_writes",
    "store.spill_bytes",
    "store.fetches",
    "store.fetch_bytes",
    "store.prefetch_hits",
    "store.sync_fetches",
    "store.crc_rereads",
    "store.compressed_segments",
    "critical_path.attributions",
    "service.admits",
    "service.admission_waits",
    "service.sessions_opened",
    "service.sessions_closed",
    "service.rpc.requests",
    "service.rpc.errors",
    "service.rpc.replays",
    "service.rpc.calls",
    "service.rpc.retries",
    "service.leases_granted",
    "service.leases_renewed",
    "service.leases_expired",
    "tsdb.samples",
    "tsdb.evictions",
    "probe.requests",
    "probe.errors",
    "alerts.fired",
    "alerts.resolved",
})

#: Counters of the port's own that the reference does not emit (and its
#: CLIs do not read): the other names are the reference's, spelled alike.
#: ``exchange.slots_moved`` is the record slots each fused launch or
#: streaming chunk moved, the source where the work happens of the
#: benchmark's ``slot_fill``. ``exchange.plan_passes_kernel`` and
#: ``exchange.plan_passes_plain`` count the plan passes counted by the
#: ``partition_counts`` kernel and by calling the partitioner;
#: ``exchange.map_passes_kernel`` the reads' map sides bucketed by one
#: ``bucket_scatter`` launch, ``exchange.map_passes_plain`` the source
#: partitions bucketed by ``bucket_records`` (the map-side combine counts
#: as neither). ``exchange.key_sorts_kernel`` / ``exchange.key_sorts_plain``
#: count the sorts by key (``lexsort_cols``) of the reduce-side tail and
#: of the map-side combine on the ``lexsort`` kernel's route (a card
#: tensor) and on the plain one.
#: ``exchange.reduce_combine_in_records`` / ``_out_records`` count the
#: lines into the reduce-side combine (``_fuse_tail``) and the keys out
#: of it, the source of the benchmark's ``reduce_fold``.
PORT_ONLY = frozenset({
    "exchange.slots_moved",
    "exchange.plan_passes_kernel",
    "exchange.plan_passes_plain",
    "exchange.map_passes_kernel",
    "exchange.map_passes_plain",
    "exchange.key_sorts_kernel",
    "exchange.key_sorts_plain",
    "exchange.reduce_combine_in_records",
    "exchange.reduce_combine_out_records",
})

#: Point-in-time gauges (``registry.gauge(name)``).
GAUGES = frozenset({
    "pool.outstanding",
    "meta.registered_shuffles",
    "store.host_bytes",
    "store.disk_bytes",
    "reads.in_flight",
    "service.tenants",
    "alerts.active",
})

#: Distributions (``registry.histogram(name)``).
HISTOGRAMS = frozenset({
    "shuffle.exec_s",
    "exchange.plan_s",
})

#: In-span timeline counter tracks (``timeline.counter(name, value)``):
#: Chrome-trace ``C`` events, read back by name in ``shuffle_trace``.
#: ``pool.outstanding`` is in both namespaces, as in the reference.
TIMELINE_TRACKS = frozenset({
    "pool.outstanding",
    "chunks.outstanding",
})

#: Dynamic name families emitted through f-strings; ``*`` stands for one
#: interpolated hole.
WILDCARDS = frozenset({
    "faults.*",
    "degrade.*",
    "recover.*",
    "serde.*_bytes",
    "serde.*_ns",
    "serde.*_calls",
    "serde.*_native",
    "serde.*_fallback",
    "serde.columnar.*_bytes",
    "serde.columnar.*_ns",
    "serde.columnar.*_calls",
    "serde.columnar.*_native",
    "serde.columnar.*_fallback",
    "tenant.*.hbm_slots",
    "tenant.*.host_bytes",
    "tenant.*.disk_bytes",
    "tenant.*.quota_waits",
})

__all__ = ["COUNTERS", "PORT_ONLY", "GAUGES", "HISTOGRAMS",
           "TIMELINE_TRACKS", "WILDCARDS"]
