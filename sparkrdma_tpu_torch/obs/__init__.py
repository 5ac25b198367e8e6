"""Observability of the port: metrics, the exchange journal, the in-span
timeline, critical-path attribution, the stall watchdog and job traces.

See :mod:`sparkrdma_tpu_torch.obs.metrics` for the registry,
:mod:`sparkrdma_tpu_torch.obs.journal` for the JSON-lines exchange journal
(span sampling, rotation), :mod:`sparkrdma_tpu_torch.obs.timeline` for
the bounded in-span event recorder, :mod:`sparkrdma_tpu_torch.obs.watchdog`
for the stall watchdog and :mod:`sparkrdma_tpu_torch.obs.trace` for job
traces. The reference's ``scripts/shuffle_report.py`` and
``scripts/shuffle_trace.py`` (stdlib only) read the port's journals.
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
    "EventTimeline", "NULL_TIMELINE", "set_active", "record_active",
    "StallWatchdog", "dump_armed", "install_state_dump",
    "ExchangeRecord", "ShuffleReadStats",
]
