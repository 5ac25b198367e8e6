"""Counters, gauges and histograms — the port's ``sparkrdma_tpu.obs.metrics``.

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
The exchange also counts ``exchange.plans`` and ``exchange.records`` and
observes each plan's seconds in the histogram ``exchange.plan_s``; the
manager's read stats (``obs/stats.py``) count ``shuffle.exchanges``,
``shuffle.records``, ``shuffle.bytes`` and ``shuffle.rounds`` and observe
``shuffle.exec_s``; the journal counts ``journal.write_errors``,
``journal.rotations`` and ``journal.sampled_out``, the watchdog
``watchdog.stalls``, and ``critical_path.enrich``
``critical_path.attributions``. ``obs/names.py`` lists every name the
port emits (``tests/test_torch_obs.py`` holds the emission sites to it).

As in the reference, a disabled registry hands out shared null
instruments (no allocation per call), a gauge keeps its high-water mark
(``snapshot`` reports it as ``<name>.high_water``), and a histogram has
fixed buckets. Unlike the reference's, a counter takes a lock per
increment, so counters fed from the tiered store's threads stay exact.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Number = Union[int, float]


class Counter:
    """Monotonic counter (``LongAdder`` analogue)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Point-in-time value with a high-water mark.

    ``set`` tracks the current value; ``high_water`` remembers the max
    ever set — the slot-pool occupancy question ("how many buffers were
    live at peak") is a high-water read, not a current read.
    """

    __slots__ = ("name", "_value", "_high")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._high = 0

    def set(self, v: Number) -> None:
        self._value = v
        if v > self._high:
            self._high = v

    def add(self, delta: Number) -> None:
        self.set(self._value + delta)

    def update_max(self, v: Number) -> None:
        """Raise the high-water mark without touching the current value."""
        if v > self._high:
            self._high = v

    @property
    def value(self) -> Number:
        return self._value

    @property
    def high_water(self) -> Number:
        return self._high


class Histogram:
    """Fixed-boundary bucketed histogram (bounded memory per instrument).

    ``bounds`` are the inclusive upper edges of each bucket; one overflow
    bucket catches everything above the last edge. Tracks count / sum /
    min / max alongside, so mean and range survive the bucketing.
    """

    __slots__ = ("name", "bounds", "_buckets", "_count", "_sum",
                 "_min", "_max", "_lock")

    DEFAULT_BOUNDS: Tuple[float, ...] = (
        1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0)

    def __init__(self, name: str,
                 bounds: Optional[Sequence[Number]] = None):
        self.name = name
        b = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        if not b or list(b) != sorted(b):
            raise ValueError(f"histogram bounds must be ascending, got {b}")
        self.bounds = b
        self._buckets = [0] * (len(b) + 1)   # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "bounds": list(self.bounds),
                "buckets": list(self._buckets),
            }

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile from the buckets (see
        :func:`bucket_quantile`); 0.0 when empty."""
        with self._lock:
            buckets = list(self._buckets)
            lo, hi = self._min, self._max
        return bucket_quantile(self.bounds, buckets, q, lo=lo, hi=hi)


def bucket_quantile(bounds: Sequence[Number], buckets: Sequence[int],
                    q: float, lo: Optional[Number] = None,
                    hi: Optional[Number] = None) -> float:
    """Estimate the ``q``-quantile of a fixed-bucket histogram.

    ``bounds`` are inclusive upper edges; ``buckets`` has one extra
    overflow cell. Linear interpolation inside the bucket holding the
    rank — the standard Prometheus-style estimate, so p99 from a rollup
    line is comparable across hosts regardless of sample counts. ``lo``
    / ``hi`` (observed min/max, when known) tighten the first and the
    overflow bucket, whose edges are otherwise 0 and the last bound.
    """
    total = sum(buckets)
    if total <= 0:
        return 0.0
    q = min(max(q, 0.0), 1.0)
    rank = q * total
    seen = 0.0
    est = float(hi if hi is not None else bounds[-1])
    for i, n in enumerate(buckets):
        if n <= 0:
            continue
        if seen + n >= rank:
            lower = bounds[i - 1] if i > 0 else (
                lo if lo is not None else 0.0)
            if i < len(bounds):
                upper = bounds[i]
            else:
                upper = hi if hi is not None else bounds[-1]
            if upper < lower:
                upper = lower
            frac = (rank - seen) / n
            est = lower + (upper - lower) * frac
            break
        seen += n
    # the observed extrema are exact — never let bucket interpolation
    # place a quantile outside them
    if hi is not None:
        est = min(est, hi)
    if lo is not None:
        est = max(est, lo)
    return est


class _NullCounter(Counter):
    __slots__ = ()

    def __init__(self):
        super().__init__("<disabled>")

    def inc(self, n: Number = 1) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def __init__(self):
        super().__init__("<disabled>")

    def set(self, v: Number) -> None:
        pass

    def add(self, delta: Number) -> None:
        pass

    def update_max(self, v: Number) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def __init__(self):
        super().__init__("<disabled>", bounds=(0,))

    def observe(self, v: Number) -> None:
        pass


# shared singletons: the disabled path allocates nothing per call
_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Named instrument registry; the process-wide metrics root.

    One registry per :class:`~sparkrdma_tpu_torch.api.shuffle_manager
    .ShuffleManager`, or the module-level
    :func:`global_registry` for components with no manager in reach
    (host staging's spill counters). Disabled registries hand out null
    instruments — see the module docstring's overhead contract.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[Number]] = None) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(name, bounds))
        return h

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-ready dict of every instrument's current state."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        out: Dict[str, object] = {}
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
            out[g.name + ".high_water"] = g.high_water
        for h in hists:
            out[h.name] = h.snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None


def global_registry() -> MetricsRegistry:
    """The process-wide default registry (always enabled).

    Components that outlive or predate any ShuffleManager (host staging
    spill counters, module-level pools) record here; managers fold the
    relevant globals into their spans at emit time.
    """
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = MetricsRegistry(enabled=True)
    return _global


def set_global_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global if _global is not None else MetricsRegistry()
        _global = reg
    return prev


__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "bucket_quantile", "global_registry", "set_global_registry"]
