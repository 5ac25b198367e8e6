"""Counters only — the slice's subset of ``sparkrdma_tpu.obs.metrics``.

The transport increments ``transport.ring.fused_kernels``,
``transport.ring.fused_rounds`` and ``transport.ring.overlap_rounds`` per
fused exchange launch and ``transport.ring.kernels`` per single-round
launch, under the reference's names. The exchange counts
``exchange.exchanges`` and ``exchange.rounds``, the combine gate's
decisions on aggregator exchanges (``combine.gate_on`` /
``combine.gate_off``), and the pushdowns it ran (``pushdown.filters``,
``pushdown.projections``).
"""

from __future__ import annotations

import threading
from typing import Dict


class Counter:
    def __init__(self, enabled: bool):
        self._enabled = enabled
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self._enabled:
            with self._lock:
                self.value += n


class MetricsRegistry:
    """Named counters; a disabled registry hands out counters that stay 0."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self.enabled)
            return c


__all__ = ["Counter", "MetricsRegistry"]
