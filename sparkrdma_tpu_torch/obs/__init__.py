"""Observability of the port: metrics, the exchange journal, windowed
rollups and heartbeats, the in-span timeline, critical-path attribution,
the stall watchdog and job traces; the live telemetry store, the alert
evaluator with its baselines, and the probe endpoint.

See :mod:`sparkrdma_tpu_torch.obs.metrics` for the registry,
:mod:`sparkrdma_tpu_torch.obs.journal` for the JSON-lines exchange journal
(span sampling, rotation), :mod:`sparkrdma_tpu_torch.obs.timeline` for
the bounded in-span event recorder, :mod:`sparkrdma_tpu_torch.obs.watchdog`
for the stall watchdog, :mod:`sparkrdma_tpu_torch.obs.trace` for job
traces, :mod:`sparkrdma_tpu_torch.obs.rollup` for rollups and
heartbeats, and ``obs/tsdb.py``, ``obs/alerts.py``, ``obs/baseline.py``
and ``obs/probe.py`` for the live layer. The reference's
``scripts/shuffle_report.py``, ``scripts/shuffle_trace.py`` and
``scripts/shuffle_top.py`` (stdlib only) read the port's journals, and
``shuffle_top.py --connect`` its probe.
"""

from sparkrdma_tpu_torch.obs.journal import (
    SCHEMA_VERSION,
    ExchangeJournal,
    ExchangeSpan,
    SamplingPolicy,
    iter_entries,
    next_span_id,
    read_entries,
    read_journal,
    rotated_paths,
)
from sparkrdma_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_quantile,
    global_registry,
    set_global_registry,
)
from sparkrdma_tpu_torch.obs.rollup import (
    HEARTBEAT_FIELDS,
    LATENCY_BOUNDS_MS,
    ROLLUP_FIELDS,
    HeartbeatEmitter,
    RollupAggregator,
    span_latency_ms,
)
from sparkrdma_tpu_torch.obs.stats import ExchangeRecord, ShuffleReadStats
from sparkrdma_tpu_torch.obs.timeline import (
    NULL_TIMELINE,
    EventTimeline,
    record_active,
    set_active,
)
from sparkrdma_tpu_torch.obs.watchdog import (
    StallWatchdog,
    dump_armed,
    install_state_dump,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "bucket_quantile",
    "global_registry", "set_global_registry",
    "ExchangeJournal", "ExchangeSpan", "SamplingPolicy",
    "read_journal", "read_entries", "iter_entries", "rotated_paths",
    "next_span_id", "SCHEMA_VERSION",
    "RollupAggregator", "HeartbeatEmitter", "span_latency_ms",
    "ROLLUP_FIELDS", "HEARTBEAT_FIELDS", "LATENCY_BOUNDS_MS",
    "EventTimeline", "NULL_TIMELINE", "set_active", "record_active",
    "StallWatchdog", "dump_armed", "install_state_dump",
    "ExchangeRecord", "ShuffleReadStats",
]
