"""``RdmaShuffleReaderStats`` analogue, registry-backed — the port's copy
of ``sparkrdma_tpu.obs.stats``.

:class:`ShuffleReadStats` keeps one :class:`ExchangeRecord` per recorded
read (``ShuffleConf.collect_shuffle_read_stats``) and prints the
per-source fetch table on the manager's ``stop()``; every ``add()`` also
feeds the ``shuffle.exchanges`` / ``shuffle.records`` / ``shuffle.bytes``
/ ``shuffle.rounds`` counters and the ``shuffle.exec_s`` histogram of
the manager's :class:`~sparkrdma_tpu_torch.obs.metrics.MetricsRegistry`.
``utils/stats.py`` re-exports both, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

log = logging.getLogger("sparkrdma_tpu_torch.stats")


@dataclasses.dataclass
class ExchangeRecord:
    """One exchange's observables (the legacy in-memory span)."""

    shuffle_id: int
    plan_s: float
    exec_s: float
    total_records: int
    record_bytes: int
    num_rounds: int
    per_source_records: np.ndarray   # [mesh] records received per source

    @property
    def total_bytes(self) -> int:
        return self.total_records * self.record_bytes

    @property
    def gbps(self) -> float:
        return self.total_bytes / max(self.exec_s, 1e-9) / 1e9


class ShuffleReadStats:
    """Accumulates exchange records; prints histograms like the reference."""

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = enabled
        self.records: List[ExchangeRecord] = []
        # null-instrument registry when none given: add() stays branch-free
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=False)

    def add(self, rec: ExchangeRecord) -> None:
        if not self.enabled:
            return
        self.records.append(rec)
        reg = self.registry
        reg.counter("shuffle.exchanges").inc()
        reg.counter("shuffle.records").inc(rec.total_records)
        reg.counter("shuffle.bytes").inc(rec.total_bytes)
        reg.counter("shuffle.rounds").inc(rec.num_rounds)
        reg.histogram("shuffle.exec_s").observe(rec.exec_s)

    def per_source_histogram(self) -> Dict[int, int]:
        """Total records fetched per source device across all exchanges."""
        out: Dict[int, int] = {}
        for r in self.records:
            for s, c in enumerate(r.per_source_records):
                out[s] = out.get(s, 0) + int(c)
        return out

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        return {
            "exchanges": len(self.records),
            "total_records": sum(r.total_records for r in self.records),
            "total_bytes": sum(r.total_bytes for r in self.records),
            "mean_exec_s": float(np.mean([r.exec_s for r in self.records])),
            "mean_gbps": float(np.mean([r.gbps for r in self.records])),
        }

    def print_histogram(self) -> str:
        """Log + return the per-source fetch table (reference: dumped to
        executor log by printRemoteFetchHistogram)."""
        hist = self.per_source_histogram()
        lines = ["shuffle fetch per-source records:"]
        for s in sorted(hist):
            lines.append(f"  source {s}: {hist[s]}")
        text = "\n".join(lines)
        log.info("%s", text)
        return text


__all__ = ["ExchangeRecord", "ShuffleReadStats"]
