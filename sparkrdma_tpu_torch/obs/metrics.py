"""Counters and gauges — the slice's subset of ``sparkrdma_tpu.obs.metrics``.

The transport increments ``transport.ring.fused_kernels``,
``transport.ring.fused_rounds`` and ``transport.ring.overlap_rounds`` per
fused exchange launch and ``transport.ring.kernels`` per single-round
launch, under the reference's names. The exchange counts
``exchange.exchanges``, ``exchange.rounds`` and ``exchange.dispatches``
(programs of the reference's that one exchange maps to: 1 fused, or
prep + chunk and fold per streaming chunk + tail), the streaming
regime's ``exchange.stream_chunks`` and ``exchange.queue_blocks`` (host
waits at ``queue_depth``), the combine gate's decisions on aggregator
exchanges (``combine.gate_on`` / ``combine.gate_off``), and the
pushdowns it ran (``pushdown.filters``, ``pushdown.projections``), and
``exchange.faults`` per injected exchange failure. The slot pool counts
``pool.hits`` and ``pool.misses`` and sets the gauge
``pool.outstanding`` (buffers handed out and not yet returned). The
shuffle registry counts ``meta.registrations``,
``meta.map_outputs_published`` and ``meta.map_records_published`` and
sets the gauge ``meta.registered_shuffles``.

The fault plane (``faults.py``) counts each injection as
``faults.<site>`` and each failure overcome in place as
``recover.<name>`` (``spill_rewrite``, ``spill_reread``,
``checkpoint_reread``) in the process-wide registry.

Host staging and the tiered store have no manager in reach, so they
record in the process-wide :func:`global_registry`, as in the reference:
``staging.spills`` / ``staging.spill_bytes`` per spilled array, and the
store's ``store.puts``, ``store.put_bytes``, ``store.spill_writes``,
``store.spill_bytes``, ``store.fetches``, ``store.fetch_bytes``,
``store.prefetch_hits``, ``store.sync_fetches``, ``store.crc_rereads``,
``store.compressed_segments``, with the gauges ``store.host_bytes``
and ``store.disk_bytes``.

The host codec (``api/serde.py``) also has no manager in reach: each
call adds to ``serde.{encode,decode}_{bytes,ns,calls}`` (the v1 rows
format) or ``serde.columnar.{encode,decode}_{bytes,ns,calls}`` in the
process-wide registry (the reference's ``_native`` / ``_fallback`` split
has no counterpart: the port has the numpy codec only). The query planner counts its
rewrites on the manager's registry: ``plan.pushdown_sunk`` (a filter or
select fused into an exchange), ``plan.reuse_hits``,
``plan.broadcast_joins`` and ``plan.overlapped_stages``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class Counter:
    def __init__(self, enabled: bool):
        self._enabled = enabled
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self._enabled:
            with self._lock:
                self.value += n


class Gauge:
    """Last value set (a level, not a count)."""

    def __init__(self, enabled: bool):
        self._enabled = enabled
        self.value = 0

    def set(self, v) -> None:
        if self._enabled:
            self.value = v


class MetricsRegistry:
    """Named counters and gauges; a disabled registry hands out ones that
    stay 0."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self.enabled)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self.enabled)
            return g

    def snapshot(self) -> Dict[str, object]:
        """Every counter's and gauge's current value, by name."""
        with self._lock:
            out: Dict[str, object] = {n: c.value
                                      for n, c in self._counters.items()}
            out.update((n, g.value) for n, g in self._gauges.items())
        return out


_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None    # guarded-by: _global_lock


def global_registry() -> MetricsRegistry:
    """The process-wide registry (always enabled)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry(enabled=True)
        return _global


__all__ = ["Counter", "Gauge", "MetricsRegistry", "global_registry"]
