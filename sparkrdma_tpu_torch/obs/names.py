"""Canonical metric-name registry of the port — every counter, gauge,
histogram and timeline counter-track that ``sparkrdma_tpu_torch`` emits.

The port's own list, beside the reference's ``sparkrdma_tpu.obs.names``:
the names are the contract the reference's CLIs read back out of
journals and registry snapshots by string. ``tests/test_torch_obs.py``
does for the port what srlint's ``counter-name-sync`` rule does for the
reference: it scans the port's AST for ``.counter("...")`` /
``.gauge("...")`` / ``.histogram("...")`` calls and fails when an
emitted name is missing here or a name declared here has no emission
site left. Dynamic families (``f"faults.{site}"``) are declared as
wildcard patterns in :data:`WILDCARDS`.

Stdlib only (``frozenset``), so the test can read it with ``ast``.
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
    "watchdog.stalls",
    "exchange.faults",
    "exchange.plans",
    "exchange.queue_blocks",
    "exchange.stream_chunks",
    "exchange.dispatches",
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

__all__ = ["COUNTERS", "GAUGES", "HISTOGRAMS", "TIMELINE_TRACKS",
           "WILDCARDS"]
