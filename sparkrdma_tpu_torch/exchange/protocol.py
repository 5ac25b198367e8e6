"""The slotted all-to-all exchange — the data plane.

Counterpart of ``sparkrdma_tpu.exchange.protocol`` for D partitions
stacked on one device (``runtime/mesh.py``). A shuffle is planned first
(:meth:`ShuffleExchange.plan`: the global counts matrix and the static
geometry derived from it) and then executed (:meth:`exchange`):

1. map side, per source partition: partition ids, stable bucketing by
   destination, and round ``r``'s fixed-capacity window of every bucket
   written into the send buffer in the transport layout;
2. size exchange: each source's per-destination counts ride a one-word
   prefix lane of round 0 (fused ring) or a plain permute (otherwise);
3. data rounds through the configured transport: ``"xla"`` is the plain
   stacked permute, ``"pallas_ring"`` the hand-written CUDA kernel of
   ``exchange/ring.py`` (all rounds of a launch at once when
   ``ring_fused``, else one launch per round), ``"hierarchical"`` the
   two-stage move of ``exchange/hierarchical.py``;
4. reduce side, per destination partition: compaction of the received
   round-chunked stream, then the optional tail — combine-by-key for an
   aggregator read, else the key-ordering sort (the merge-path kernel
   when the geometry allows, as in the reference).

Two regimes, switched on ``conf.max_rounds_in_flight`` as in the
reference:

- ``num_rounds <= max_rounds_in_flight``: the fused regime, all rounds
  in one transport step;
- more rounds: the streaming regime (:meth:`ShuffleExchange
  ._exchange_streaming`). A prep step runs the map side (on the card,
  one launch of ``csrc/bucket_scatter.cu`` for every source where the
  read's input allows it: :func:`map_kernel_takes`) and the size
  exchange; then chunks of ``max_rounds_in_flight`` rounds each are
  filled, moved and folded into an accumulator at their exact offsets in
  the stream, with the host waiting for the oldest chunk once
  ``conf.queue_depth`` are in flight; a tail step sorts or aggregates.
  Nothing in the chunk loop waits for the card except that pacing.

With an aggregator, a plan-time gate (``conf.map_side_combine``) may
also combine each source's records by (partition, key) before they are
bucketed; ``row_filter`` and ``keep_words`` push a predicate and a
projection into the map side, and :meth:`ShuffleExchange.wire_stats`
accounts for what they kept off the wire and for what the reduce-side
combine folded.

Partition ``p`` lives on stacked partition ``p % D`` (round-robin).

Across processes (a runtime that spans a ``torch.distributed`` group,
``runtime/mesh.py``) each process plans from the all-gathered counts
(every process derives the same geometry), runs the map side of its own
``L`` source partitions and the reduce side of its own ``L``
destinations, and moves its ``[L_src, D_dst, ...]`` sends: ``"xla"`` is
one ``all_to_all_single`` and ``"hierarchical"`` the staged move
(``exchange/hierarchical.py``); ``"pallas_ring"`` is the ring kernel's
push into every process's registered receive window
(``exchange/ring.py``, ``exchange/windows.py``), fused or a launch per
round as in one process, with the handshake on the host, and its
compaction or fold reads the window in place. The counts ride the same
move (round 0's prefix lane of the fused ring). One process takes the
stacked path unchanged.

Buffer reuse contract (``RdmaRegisteredBuffer`` semantics): when the
exchange owns a pool (a ``ShuffleManager``'s does), the streaming
regime draws its chunks and accumulator from it, and the fused regime's
``out`` becomes the output buffer of the NEXT same-geometry exchange of
the same shuffle, which overwrites it in place — consume (or copy) it
before then. :meth:`ShuffleExchange.release_shuffle` hands a shuffle's
buffers back to the pool. Given a tiered store (``store=``), the
exchange acquires and releases every pooled buffer through it. A service
session's exchange (``tenant=``, ``account=``) charges each pooled
buffer to the tenant's account while it holds it and tags its spans with
the tenant.

The record-movement strategy of every sort (``sort_mode``: pack, wide
or plain) is chosen as in the reference; all three are one stable sort
here (``kernels/sort.py``).

Faults (``faults.py``): ``exchange`` fires the ``exchange.dispatch``
site, then the legacy ``fault_hook`` or ``conf.fault_injection_rate``,
before any work; the streaming loop fires ``exchange.stream_round`` at
the top of each chunk. Each raises ``FetchFailedError`` (counted as
``exchange.faults``), which the reader's retry loop takes. An exchange
abandoned midway gives its pooled buffers back before the error
propagates. Left out of the reference: the degradation ladder
(transport fallback, the combine-off retry) — the port never falls back
from a kernel or a pass to something else.

Observability (``obs/``), under the reference's event names: the
exchange records ``plan``, ``combine:gate``, ``exchange:fused`` (with
one structural ``ring:round`` pair per round of a fused ring launch),
``stream:prep``, each chunk's ``chunk`` / ``chunk:dispatch`` /
``chunk:fold`` and ``queue:block``, the ``chunks.outstanding`` track,
``stream:tail`` and ``fault:injected`` on its ``timeline`` (the null
timeline unless a manager passes its own). Every mark is a host clock
read around asynchronous launches, and every extra a host int, so
recording never waits for the card. The streaming loop's wait for the
oldest chunk's CUDA event runs under ``watchdog.armed`` (with the
``block_hook`` test hook inside the armed region). :meth:`ShuffleExchange
.shuffle` (plan and exchange in one call) feeds ``stats`` and, given a
journal, writes a span for callers that bypass the manager.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.config import ShuffleConf, size_class, size_class_fine
from sparkrdma_tpu_torch.exchange.errors import FetchFailedError
from sparkrdma_tpu_torch.exchange.hierarchical import (
    make_flat_all_to_all, make_hierarchical_all_to_all)
from sparkrdma_tpu_torch.exchange.ring import (make_ring_all_to_all,
                                               make_ring_exchange)
from sparkrdma_tpu_torch.kernels.aggregate import (OPS, combine_by_key_cols,
                                                  map_side_combine_cols)
from sparkrdma_tpu_torch.kernels.bucket_scatter import (BIN_LIMIT,
                                                        bucket_scatter)
from sparkrdma_tpu_torch.kernels.bucketing import (bucket_records,
                                                   bucket_sorted_counts,
                                                   compact_segments,
                                                   fill_round_slots,
                                                   fill_round_slots_dest_major)
from sparkrdma_tpu_torch.kernels.merge_sort import (merge_sort_cols,
                                                    supports_fast_sort)
from sparkrdma_tpu_torch.kernels.partition_counts import (
    partition_counts, partition_counts_plain)
from sparkrdma_tpu_torch.kernels.sort import (lexsort_cols,
                                              packed_lexsort_cols,
                                              sort_by_lead_cols)
from sparkrdma_tpu_torch.kernels.wide_sort import sort_wide_cols
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.obs.stats import ExchangeRecord, ShuffleReadStats
from sparkrdma_tpu_torch.obs.timeline import NULL_TIMELINE, EventTimeline
from sparkrdma_tpu_torch.obs.watchdog import StallWatchdog
from sparkrdma_tpu_torch.runtime.distributed import WORLD
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime
from sparkrdma_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """``counts[s, p]`` = records source ``s`` sends to partition ``p``;
    ``num_rounds``, ``out_capacity`` and ``capacity`` are the static
    geometry; ``split_factor > 1`` records hot-partition splitting."""

    counts: np.ndarray          # int64 [mesh, num_parts * split_factor]
    num_rounds: int
    out_capacity: int           # per-partition compacted output capacity
    capacity: int               # slot capacity
    split_factor: int = 1

    @property
    def total_records(self) -> int:
        return int(self.counts.sum())


def split_partitioner(partitioner: Callable, num_parts: int,
                      k: int) -> Callable:
    """Spread each partition over ``k`` same-owner sub-partitions
    ``p + num_parts * j``, ``j`` cycling by local record position. Its
    ``device_spec`` wraps the inner partitioner's with ``k``; it has
    none where the inner one has none or is itself a split."""

    def wrapped(records):
        base = partitioner(records).to(torch.int64)
        j = torch.arange(records.shape[1], device=records.device) % k
        return base + num_parts * j

    wrapped.cache_key = ("split", k, num_parts,
                         getattr(partitioner, "cache_key", id(partitioner)))
    inner = getattr(partitioner, "device_spec", None)
    wrapped.device_spec = None if inner is None else inner.split(k, num_parts)
    return wrapped


def map_kernel_takes(on_card: bool, partitioner: Callable, num_parts: int,
                     combine: bool, row_filter: Optional[Callable],
                     keep_words: Optional[Tuple[int, ...]]) -> bool:
    """Whether the streaming prep buckets every source with one
    ``bucket_scatter`` launch: a batch on the card, a described
    partitioner (not a split of a split), no filter, no projection, no
    map-side combine (whose (partition, key) sort is its own bucketing)
    and 2 to ``BIN_LIMIT`` bins. Else each source goes through
    :meth:`ShuffleExchange._map_side`."""
    return (on_card and not combine and row_filter is None
            and keep_words is None and 1 < num_parts <= BIN_LIMIT
            and getattr(partitioner, "device_spec", None) is not None)


def _device_partition_counts(counts_local: torch.Tensor, num_parts: int,
                             mesh_size: int) -> torch.Tensor:
    """``[num_parts]`` per-destination counts -> ``[mesh, ppd]`` with row
    ``d`` holding the partitions owned by ``d`` (``d, d+mesh, ...``)."""
    ppd = num_parts // mesh_size
    idx = torch.arange(num_parts, device=counts_local.device)
    idx = idx.reshape(ppd, mesh_size).T.reshape(-1)
    return counts_local[idx].reshape(mesh_size, ppd)


class ShuffleExchange:
    """Planner and executor of exchanges over one stacked runtime."""

    def __init__(self, runtime: MeshRuntime,
                 conf: Optional[ShuffleConf] = None,
                 metrics: Optional[MetricsRegistry] = None, pool=None,
                 store=None, stats: Optional[ShuffleReadStats] = None,
                 timeline: Optional[EventTimeline] = None,
                 watchdog: Optional[StallWatchdog] = None, journal=None,
                 identity: Tuple[int, int] = (0, 1), rollup=None,
                 tenant: str = "", account=None, collectives=None):
        self.runtime = runtime
        #: the scope of this exchange's collectives across processes: a
        #: service session's own, else the default group's
        self.collectives = collectives if collectives is not None else WORLD
        #: the service tenant this exchange runs for ("" standalone): its
        #: spans carry it, and ``account`` meters its pooled buffers
        self.tenant = tenant
        self.account = account
        self.conf = conf or runtime.conf
        self.mesh_size = runtime.num_partitions
        #: processes of the runtime's group (1: the stacked path)
        self.processes = runtime.process_count
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        # the in-span timeline and the stall watchdog default to no-ops,
        # so the instrumentation sites stay unconditional
        self.timeline = timeline if timeline is not None else NULL_TIMELINE
        self.watchdog = watchdog if watchdog is not None \
            else StallWatchdog(self.conf.watchdog_timeout_s)
        #: a test's hook, called with the chunk index INSIDE the armed
        #: watchdog region before each streaming queue wait: simulates a
        #: wedged wait without wedging the card
        self.block_hook: Optional[Callable[[int], None]] = None
        #: read stats of :meth:`shuffle` (a manager passes its own)
        self.stats = stats if stats is not None else ShuffleReadStats(
            enabled=self.conf.collect_shuffle_read_stats,
            registry=self.metrics)
        #: the journal :meth:`shuffle` writes its spans to (None: none),
        #: and the ``(process_index, host_count)`` stamped into them
        self.journal = journal
        #: the rollup aggregator :meth:`shuffle` folds its spans into
        self.rollup = rollup
        self.sampler = self.conf.sampling_policy()
        self.identity = identity
        #: host seconds of the last :meth:`plan`
        self.last_plan_s = 0.0
        #: the tiered store (``hbm/tiered_store.py``): when given, buffers
        #: are acquired and released through it, so that each acquisition
        #: pokes its writer; its HBM tier is the pool, which a store-only
        #: caller inherits
        self.store = store
        if store is not None and pool is None:
            pool = store.pool
        #: the runtime's ``SlotPool`` (a manager passes it), or None: then
        #: every buffer is a fresh allocation and nothing is recycled
        self.pool = pool
        # the last fused output per (shuffle_id, geometry), recycled as the
        # output buffer of a repeat read and released on release_shuffle
        self._out_prev: Dict[Tuple, torch.Tensor] = {}
        #: programs of the reference's that the last exchange() maps to
        #: (1 fused; prep + chunk and fold per chunk + tail streaming)
        self.last_dispatches = 0
        self._last_wire = None
        self._last_wire_stats: Dict[str, float] = {}
        # [lines in, keys out] of the last read's reduce-side combine
        # (None: no aggregator); ints the combine already holds
        self._last_reduce: Optional[List[int]] = None
        #: a test's fault injector: called at each exchange, a True
        #: return fails it (takes priority over ``fault_injection_rate``)
        self.fault_hook: Optional[Callable[[], bool]] = None
        self._fault_rng = np.random.default_rng(0xFA17)

    def transport(self) -> str:
        return self.conf.transport

    def _get_buf(self, shape, device) -> torch.Tensor:
        """An ``int32`` buffer from the pool (or a fresh one without a
        pool) holding whatever its last user left: the caller zeroes or
        writes every word it reads."""
        if self.pool is None:
            return torch.empty(shape, dtype=torch.int32, device=device)
        if self.store is not None:
            return self.store.acquire_device(shape, account=self.account)
        return self.pool.get_shaped(shape, account=self.account)

    def _put_buf(self, arr: torch.Tensor) -> None:
        if self.pool is None:
            return
        if self.store is not None:
            self.store.release_device(arr, account=self.account)
        elif self.account is None:
            self.pool.put_shaped(arr)
        else:
            self.pool.put_shaped(arr, account=self.account)

    def release_shuffle(self, shuffle_id: int) -> None:
        """Return a shuffle's recycled output buffers to the pool
        (unregisterShuffle). Its last outputs may then be overwritten by
        any later exchange, so callers must be done with them."""
        for okey in [k for k in self._out_prev if k[0] == shuffle_id]:
            self._put_buf(self._out_prev.pop(okey))

    def release_all(self) -> None:
        """Return every recycled output buffer (manager teardown; a
        session's exchange dies with it, so nothing stays charged to its
        tenant's account)."""
        while self._out_prev:
            self._put_buf(self._out_prev.popitem()[1])

    def _fused_out(self, okey: Tuple, shape, device) -> torch.Tensor:
        """The fused regime's output buffer: with a pool, the previous
        output of the same (shuffle, geometry) goes back and the buffer
        popped for this read is usually that same one."""
        prev = self._out_prev.pop(okey, None)
        if prev is not None:
            self._put_buf(prev)
        out = self._get_buf(shape, device)
        if self.pool is not None:
            self._out_prev[okey] = out
        return out

    def _maybe_inject_fault(self, shuffle_id: int = -1) -> None:
        """The ``exchange.dispatch`` site, then the legacy injectors."""
        if faults.fire("exchange.dispatch") == "fail":
            self.metrics.counter("exchange.faults").inc()
            raise FetchFailedError(
                shuffle_id, "injected fault (fault_spec: exchange.dispatch)")
        if self.fault_hook is not None:
            if self.fault_hook():
                self.metrics.counter("exchange.faults").inc()
                self.timeline.event("fault:injected", shuffle=shuffle_id)
                raise FetchFailedError(shuffle_id, "injected fault (hook)")
        elif self.conf.fault_injection_rate > 0.0:
            if self._fault_rng.random() < self.conf.fault_injection_rate:
                self.metrics.counter("exchange.faults").inc()
                self.timeline.event("fault:injected", shuffle=shuffle_id)
                raise FetchFailedError(shuffle_id, "injected fault (rate)")

    # ------------------------------------------------------------------
    # phase 1: plan (the metadata fetch)
    # ------------------------------------------------------------------
    def plan(self, records: torch.Tensor, partitioner: Callable,
             num_parts: Optional[int] = None,
             capacity: Optional[int] = None) -> ShufflePlan:
        """Global counts matrix, slot capacity, rounds, output capacity."""
        t0 = time.perf_counter()
        self.timeline.begin("plan")
        num_parts = num_parts or self.mesh_size
        if num_parts % self.mesh_size:
            raise ValueError(f"num_parts {num_parts} not a multiple of "
                             f"mesh size {self.mesh_size}")
        classer = (size_class_fine
                   if self.conf.geometry_classes == "fine" else size_class)
        rt = self.runtime

        # every process holds an equal share of the global batch
        n_global = records.shape[1] * self.processes

        def measure(part_fn, parts):
            with span("shuffle:plan_pass", records.device):
                # a described partitioner on the card: one launch over
                # every stacked partition; else the partitioner itself
                if records.is_cuda and getattr(part_fn, "device_spec",
                                               None) is not None:
                    self.metrics.counter("exchange.plan_passes_kernel").inc()
                    counts = partition_counts(records, part_fn, parts,
                                              rt.local_partitions)
                else:
                    self.metrics.counter("exchange.plan_passes_plain").inc()
                    counts = partition_counts_plain(records, part_fn, parts,
                                                    rt.local_partitions)
                counts = counts.cpu()
                if self.processes > 1:
                    # the metadata-table read, made collective: every
                    # process gets the [D, parts] table (CPU tensors, gloo)
                    counts = counts.to(torch.int64)
                    rows = [torch.empty_like(counts)
                            for _ in range(self.processes)]
                    self.collectives.all_gather(rows, counts)
                    counts = torch.cat(rows)
            counts = counts.numpy().astype(np.int64)
            if int(counts.sum()) != n_global:
                raise ValueError(
                    f"partitioner produced out-of-range partition ids: "
                    f"counted {int(counts.sum())} of {n_global} "
                    f"records over {parts} partitions (ids must lie in "
                    f"[0, num_parts))")
            per_pair_max = int(counts.max(initial=0))
            cap = capacity if capacity is not None else min(
                classer(max(1, per_pair_max)), self.conf.slot_records)
            return counts, cap, max(1, math.ceil(per_pair_max / cap))

        counts, cap, num_rounds = measure(partitioner, num_parts)
        split = 1
        if num_rounds > self.conf.max_rounds:
            split = math.ceil(num_rounds / self.conf.max_rounds)
            sp = split_partitioner(partitioner, num_parts, split)
            counts, cap, num_rounds = measure(sp, num_parts * split)
        if num_rounds > self.conf.max_rounds:
            raise ValueError(
                f"partition skew needs {num_rounds} rounds > max_rounds "
                f"{self.conf.max_rounds} even after {split}-way partition "
                "splitting; raise slot_records or max_rounds")
        owned = counts.sum(axis=0)
        per_device_in = [int(owned[d::self.mesh_size].sum())
                         for d in range(self.mesh_size)]
        self.last_plan_s = time.perf_counter() - t0
        self.metrics.counter("exchange.plans").inc()
        self.metrics.histogram("exchange.plan_s").observe(self.last_plan_s)
        self.timeline.end("plan", rounds=num_rounds, capacity=cap,
                          split=split)
        return ShufflePlan(counts=counts, num_rounds=num_rounds,
                           out_capacity=classer(max(1, max(per_device_in))),
                           capacity=cap, split_factor=split)

    # ------------------------------------------------------------------
    # transports and the reduce-side tail
    # ------------------------------------------------------------------
    def _ring_fused_active(self) -> bool:
        return self.transport() == "pallas_ring" and self.conf.ring_fused

    def _data_a2a(self) -> Callable:
        """One round: this process's dest-major ``[L_src, D_dst, ...]``
        -> ``[L_dst, D_src, ...]`` (one process: ``[D_src, D_dst, ...]``
        -> ``[D_dst, D_src, ...]``)."""
        if self.transport() == "pallas_ring":
            return make_ring_all_to_all(self.mesh_size, self.metrics,
                                        self.runtime, self.collectives)
        if self.transport() == "hierarchical":
            return make_hierarchical_all_to_all(
                self.runtime, self.conf.hierarchy_hosts, self.metrics,
                self.collectives)
        if self.processes > 1:
            return make_flat_all_to_all(self.runtime, self.collectives)
        return lambda send: send.transpose(0, 1).contiguous()

    def _uses_fast_sort(self, out_capacity: int, sort_key_words: int,
                        aggregator: str = "") -> bool:
        """Does the tail run the merge-path sort? (Same rule as the
        reference, so both take it on the same geometries.)"""
        return (bool(sort_key_words) and not aggregator
                and self.conf.fast_sort
                and not self.conf.stable_key_sort
                and supports_fast_sort(out_capacity, self.conf.fast_sort_run))

    def sort_mode(self, record_words: int) -> str:
        """The reference's precedence rule: pack > wide > plain."""
        payload = record_words - self.conf.key_words
        if self.conf.pack_sort_min_payload and \
                payload >= self.conf.pack_sort_min_payload:
            return "pack"
        if self.conf.wide_sort_min_payload and \
                payload >= self.conf.wide_sort_min_payload:
            return "wide"
        return "plain"

    # ------------------------------------------------------------------
    # the map-side combine gate and the wire accounting
    # ------------------------------------------------------------------
    def _sampled_dup_ratio(self, records: torch.Tensor) -> float:
        """Duplicate-key ratio estimate (``1 - unique/sample``) from the
        first ``conf.combine_sample_rows`` rows of stacked partition 0 —
        the rows the reference samples from its first addressable shard,
        so both packages decide alike. Across processes the estimate is
        global partition 0's, broadcast from process 0 (CPU tensor,
        gloo): every process takes the decision one process would."""
        k = self.conf.combine_sample_rows
        if k <= 0:
            return 1.0           # sampling disabled: assume duplicates
        ratio = 0.0
        if self.runtime.process_index == 0:
            kw = self.conf.key_words
            sample = self.runtime.partition(records, 0)[:kw, :k]
            sample = sample.cpu().numpy()
            n = sample.shape[1]
            if n:
                uniq = len({tuple(col) for col in sample.T.tolist()})
                ratio = 1.0 - uniq / n
        if self.processes > 1:
            shared = torch.tensor([ratio], dtype=torch.float64)
            self.collectives.broadcast(shared, 0)
            ratio = float(shared[0])
        return ratio

    def plan_combine(self, records: torch.Tensor,
                     aggregator: str) -> Tuple[bool, float]:
        """The gate's decision ``(use, dup_ratio)`` without bumping its
        counters (a caller hoists it and hands it back as
        :meth:`exchange`'s ``combine_hint``)."""
        if not aggregator:
            return False, 0.0
        with span("shuffle:combine_gate", records.device):
            ratio = self._sampled_dup_ratio(records)
        mode = self.conf.map_side_combine
        if mode == "off":
            use = False
        elif mode == "on":
            use = True
        else:
            use = ratio >= self.conf.combine_min_dup_ratio
        return use, ratio

    def _note_wire(self, records, incoming, combined: bool, filtered: bool,
                   keep_words, dup_ratio: float) -> None:
        """Keep the operands of :meth:`wire_stats`; summing ``incoming``
        waits for the device, so it is deferred until asked for."""
        w = records.shape[0]
        w_eff = len(keep_words) if keep_words is not None else w
        self._last_wire_stats = {}
        self._last_wire = (int(records.shape[1]), w, w_eff, incoming,
                           bool(combined), bool(filtered), float(dup_ratio))

    def wire_stats(self) -> Dict[str, float]:
        """:meth:`reference_wire_stats`, and for every aggregator read the
        port's ``reduce_in_records`` / ``reduce_out_records``: the lines
        into the reduce-side combine and the keys out of it, summed over
        the partitions (0 / 0 where the one-partition exchange's map-side
        combine was the whole fold)."""
        s = self.reference_wire_stats()
        if self._last_reduce is None or self._last_wire is None:
            return s
        return dict(s, reduce_in_records=self._last_reduce[0],
                    reduce_out_records=self._last_reduce[1])

    def reference_wire_stats(self) -> Dict[str, float]:
        """Combine/pushdown wire accounting of the last :meth:`exchange`,
        under the reference's keys (what a journal span carries):
        ``combine_{in,out}_{records,bytes}`` when the map-side combine
        ran (a filter under it folded in), ``pushdown_rows_dropped`` for
        a filter without it, ``pushdown_words_dropped`` for a projection,
        and the gate's ``combine_dup_ratio`` for every aggregator
        exchange."""
        if self._last_wire is None:
            return {}
        if self._last_wire_stats:
            return self._last_wire_stats
        n_in, w, w_eff, incoming, combined, filtered, ratio = \
            self._last_wire
        out_rec = n_in
        if combined or filtered:
            out_rec = int(incoming.sum())
        s: Dict[str, float] = {"combine_dup_ratio": ratio}
        if combined:
            s.update(combine_in_records=n_in,
                     combine_out_records=out_rec,
                     combine_in_bytes=n_in * w * 4,
                     combine_out_bytes=out_rec * w_eff * 4)
        elif filtered:
            s["pushdown_rows_dropped"] = n_in - out_rec
        if w_eff != w:
            s["pushdown_words_dropped"] = (w - w_eff) * out_rec
        self._last_wire_stats = s
        return s

    # ------------------------------------------------------------------
    # the map side and the reduce-side tail
    # ------------------------------------------------------------------
    def _fuse_tail(self, out: torch.Tensor, total: int, out_capacity: int,
                   sort_key_words: int, aggregator: str = "",
                   float_payload: bool = False, tight_out: bool = False
                   ) -> Tuple[torch.Tensor, int]:
        """The optional reduce-side stage of one partition's output:
        combine-by-key for an aggregator (its output is key-sorted),
        else the key-ordering sort.

        Outside the merge-path geometry the port sorts by the key words
        stably; the reference's default there is unstable, so equal keys
        may come out in another (equally valid) order."""
        mode = self.sort_mode(out.shape[0])
        ride = self.conf.wide_sort_ride_words
        if aggregator:
            # the valid rows are the received prefix, and a stable sort
            # keeps their order whether the rest is masked or cut off:
            # combine the prefix alone (a map-side combined read receives
            # a few rows into a capacity sized by the raw counts)
            n = min(total, out_capacity)
            part, unique = combine_by_key_cols(
                out[:, :n], torch.ones(n, dtype=torch.bool,
                                       device=out.device),
                self.conf.key_words, aggregator, float_payload,
                wide=mode == "wide", ride_words=ride, pack=mode == "pack")
            # host ints the combine already holds: no sync. A ranged read's
            # tail follows an exchange run without the aggregator
            self.metrics.counter("exchange.reduce_combine_in_records").inc(n)
            self.metrics.counter("exchange.reduce_combine_out_records").inc(
                unique)
            if self._last_reduce is None:
                self._last_reduce = [0, 0]
            self._last_reduce[0] += n
            self._last_reduce[1] += unique
            if float_payload and n == 1 < out_capacity:
                # the scan over the whole capacity turns -0.0 into +0.0
                # even for one valid row (``combine_by_key_cols``)
                kw = self.conf.key_words
                part[kw:] = (part[kw:].view(torch.float32) + 0).view(
                    torch.int32)
            out[:, n:] = 0          # ``out`` is this partition's scratch
            out[:, :n] = part
            return out, unique
        if not sort_key_words:
            return out, total
        valid = None if tight_out else (
            torch.arange(out_capacity, device=out.device) < total)
        if self._uses_fast_sort(out_capacity, sort_key_words):
            # the valid rows are the received prefix: sort only that
            out = merge_sort_cols(
                out, run=self.conf.fast_sort_run,
                n_valid=None if tight_out else min(total, out_capacity))
        elif mode == "pack":
            out = packed_lexsort_cols(out, sort_key_words, valid,
                                      stable=self.conf.stable_key_sort)
        elif mode == "wide":
            out = sort_wide_cols(out, sort_key_words, valid, ride_words=ride)
        else:
            out = lexsort_cols(out, sort_key_words, valid)
        return out, total

    def _map_side(self, records: torch.Tensor, partitioner: Callable,
                  num_parts: int, combine: bool = False, aggregator: str = "",
                  float_payload: bool = False,
                  row_filter: Optional[Callable] = None,
                  keep_words: Optional[Tuple[int, ...]] = None):
        """Partition ids; the predicate pushdown (dropped rows take the
        sentinel id ``num_parts`` and never occupy a slot); the
        projection (only ``keep_words`` go on); then either the map-side
        combine, whose (partition, key) order already is the bucketing,
        or the bucketing sort. Returns ``(bucketed, counts, offsets)``
        with post-filter, post-combine counts."""
        with span("shuffle:map", records.device):
            pids = partitioner(records)
            if row_filter is not None:
                pids = torch.where(row_filter(records), pids, num_parts)
            recs = (records if keep_words is None
                    else records[list(keep_words)])
            mode = self.sort_mode(recs.shape[0])
            how = dict(wide=mode == "wide", pack=mode == "pack",
                       ride_words=self.conf.wide_sort_ride_words)
            if combine:
                sr, spids, _ = map_side_combine_cols(
                    recs, pids, num_parts, self.conf.key_words, aggregator,
                    float_payload, **how)
                counts, offs = bucket_sorted_counts(spids, num_parts)
                return sr, counts, offs
            # bucket_records' single-partition shortcut counts the whole
            # batch: under a filter, bucket over 2 partitions so the
            # sentinel rows are counted out, and keep the real one
            np_eff = num_parts if (num_parts > 1 or row_filter is None) else 2
            self.metrics.counter("exchange.map_passes_plain").inc()
            sr, counts, offs = bucket_records(recs, pids, np_eff, **how)
            return sr, counts[:num_parts], offs[:num_parts]

    # ------------------------------------------------------------------
    # phase 2: execute
    # ------------------------------------------------------------------
    def exchange(self, records: torch.Tensor, partitioner: Callable,
                 plan: ShufflePlan, num_parts: Optional[int] = None,
                 shuffle_id: int = -1, sort_key_words: int = 0,
                 aggregator: str = "", float_payload: bool = False,
                 row_filter: Optional[Callable] = None,
                 keep_words: Optional[Tuple[int, ...]] = None,
                 combine_hint: Optional[Tuple[bool, float]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run the planned exchange.

        Returns ``(out [W, L*out_capacity], totals int32[L], incoming
        int32[L, D, ppd])`` over this process's ``L`` stacked partitions
        (``L = D`` in one process): partition ``d``'s columns are its
        compacted received records (zero tail), ``totals[d]`` how many
        are valid, and ``incoming[d, s, q]`` the count source ``s`` sent
        to ``d``'s local partition ``q``.

        ``aggregator`` ("sum"/"min"/"max", payload words as uint32, or
        float32 with ``float_payload``) combines each partition's
        records by key: the output rows become its unique keys,
        ascending, and ``totals`` counts them. The combine gate
        (``conf.map_side_combine``, or ``combine_hint``) may also combine
        before the exchange; the output is the same bits either way.
        ``row_filter`` (``records -> bool[n]`` over full-width records)
        drops rows before they take a slot; ``keep_words`` (strictly
        increasing, all key words first) moves only those words, and the
        dropped ones come back zero.

        A plan with more rounds than ``conf.max_rounds_in_flight`` runs
        in the streaming regime. With a pool, the fused regime's ``out``
        is overwritten by the next same-geometry exchange of the same
        ``shuffle_id`` (module docstring)."""
        plan_parts = int(plan.counts.shape[1])
        if (num_parts is not None
                and num_parts * plan.split_factor != plan_parts):
            raise ValueError(f"num_parts {num_parts} != plan's {plan_parts} "
                             f"(split_factor {plan.split_factor})")
        if plan.split_factor > 1:
            partitioner = split_partitioner(
                partitioner, plan_parts // plan.split_factor,
                plan.split_factor)
        if aggregator and aggregator not in OPS:
            raise ValueError(f"unsupported aggregator {aggregator!r}")
        w = records.shape[0]
        if keep_words is not None:
            keep_words = tuple(int(i) for i in keep_words)
            kw = self.conf.key_words
            if (len(keep_words) < kw
                    or keep_words[:kw] != tuple(range(kw))):
                raise ValueError(
                    f"keep_words must start with all {kw} key words")
            if any(b <= a for a, b in zip(keep_words, keep_words[1:])):
                raise ValueError("keep_words must be strictly increasing")
            if keep_words[-1] >= w:
                raise ValueError(
                    f"keep_words {keep_words} out of range for W={w}")
            if len(keep_words) == w:
                keep_words = None    # full width: not a projection
        if records.dtype != torch.int32:
            raise TypeError(f"records must be int32 word views, got "
                            f"{records.dtype}")
        self._last_wire = None
        self._last_wire_stats = {}
        self._last_reduce = [0, 0] if aggregator else None
        self._maybe_inject_fault(shuffle_id)
        m = self.metrics
        m.counter("exchange.exchanges").inc()
        m.counter("exchange.rounds").inc(plan.num_rounds)
        m.counter("exchange.records").inc(plan.total_records)
        if row_filter is not None:
            m.counter("pushdown.filters").inc()
        if keep_words is not None:
            m.counter("pushdown.projections").inc()
        if combine_hint is not None and aggregator:
            use_combine, dup_ratio = bool(combine_hint[0]), combine_hint[1]
        else:
            # the gate's sampling is host work on the exchange's critical
            # path: timed, so the attribution charges it to "combine"
            self.timeline.begin("combine:gate")
            use_combine, dup_ratio = self.plan_combine(records, aggregator)
            self.timeline.end("combine:gate")
        if aggregator:
            m.counter("combine.gate_on" if use_combine
                      else "combine.gate_off").inc()
        if plan.num_rounds > self.conf.max_rounds_in_flight:
            out, totals, incoming = self._exchange_streaming(
                records, partitioner, plan, plan_parts, sort_key_words,
                aggregator, float_payload, use_combine, row_filter,
                keep_words, shuffle_id)
        else:
            owned = plan.counts.sum(axis=0)
            per_dev = np.array([owned[d::self.mesh_size].sum()
                                for d in range(self.mesh_size)])
            # a pre-exchange reduction shrinks totals below the plan's
            pushed = (use_combine or row_filter is not None
                      or keep_words is not None)
            tight = not pushed and bool(
                (per_dev == plan.out_capacity).all())
            fkey = (getattr(row_filter, "cache_key", id(row_filter))
                    if row_filter is not None else None)
            # the reference's program key: same key, same output buffer
            okey = (shuffle_id, plan_parts, plan.capacity, plan.num_rounds,
                    plan.out_capacity, w, sort_key_words, aggregator,
                    float_payload, tight, use_combine, fkey, keep_words,
                    getattr(partitioner, "cache_key", id(partitioner)))
            tl = self.timeline
            with span("shuffle:fused", records.device):
                tl.begin("exchange:fused", rounds=plan.num_rounds)
                if self._ring_fused_active():
                    # structural marks: the rounds run inside one kernel,
                    # so these record the launch's round structure, not
                    # its time
                    for r in range(plan.num_rounds):
                        tl.begin("ring:round", round=r)
                        tl.end("ring:round", round=r)
                try:
                    out, totals, incoming = self._run(
                        records, partitioner, plan_parts, plan.capacity,
                        plan.num_rounds, plan.out_capacity, sort_key_words,
                        tight, aggregator, float_payload, use_combine,
                        row_filter, keep_words, okey)
                finally:
                    # closed on a failed attempt too: the span's timeline
                    # stays balanced across retries
                    tl.end("exchange:fused")
            self.last_dispatches = 1
            m.counter("exchange.dispatches").inc()
            m.counter("exchange.slots_moved").inc(
                plan.num_rounds * self.runtime.local_partitions * plan_parts
                * plan.capacity)
        self._note_wire(records, incoming, use_combine,
                        row_filter is not None, keep_words, dup_ratio)
        return out, totals, incoming

    def _run(self, records, partitioner, num_parts, capacity, num_rounds,
             out_capacity, sort_key_words, tight, aggregator, float_payload,
             combine, row_filter, keep_words, okey):
        """The fused regime: the reference's ``local_step``, looped over
        the stacked partitions around one exchange launch. Every word of
        ``out`` is written (it may be a recycled buffer)."""
        rt = self.runtime
        mesh = self.mesh_size
        local = rt.local_partitions
        ppd = num_parts // mesh
        w = records.shape[0]
        rows = list(keep_words) if keep_words is not None else slice(None)
        w_eff = len(keep_words) if keep_words is not None else w
        dev = records.device
        oc = out_capacity
        out = self._fused_out(okey, (w, local * oc), dev)
        if keep_words is not None:
            out[[i for i in range(w) if i not in keep_words]] = 0
        totals = torch.zeros((local,), dtype=torch.int32, device=dev)

        def map_side(src):
            return self._map_side(rt.partition(records, src), partitioner,
                                  num_parts, combine, aggregator,
                                  float_payload, row_filter, keep_words)

        if num_parts == 1 and num_rounds == 1 and mesh == 1:
            # degenerate exchange (single partition, single source): the
            # slot/window/compact machinery is the identity, so the
            # pushdown and the tail run on the batch directly, as in the
            # reference
            n = records.shape[1]
            keep = row_filter(records) if row_filter is not None else None
            part = records[rows]
            if combine:
                # map side == reduce side here: one combine pass is the
                # filter's compaction and the tail at once
                valid = keep if keep is not None else torch.ones(
                    n, dtype=torch.bool, device=dev)
                part, total = combine_by_key_cols(
                    part, valid, self.conf.key_words, aggregator,
                    float_payload)
                wire = total
            else:
                total = n
                if keep is not None:
                    # stable validity-lead compaction: survivors to the
                    # front in arrival order, zeroed tail
                    part = sort_by_lead_cols(part, ~keep,
                                             self.sort_mode(w_eff))
                    total = int(keep.sum())
                    part[:, total:] = 0
                wire = total
            if oc != n:
                part = torch.cat([part, part.new_zeros((w_eff, oc - n))],
                                 dim=1)
            with span("shuffle:tail", dev):
                if not combine:
                    part, total = self._fuse_tail(part, total, oc,
                                                  sort_key_words, aggregator,
                                                  float_payload, tight)
                out[rows] = part
                totals[0] = total
            incoming = torch.full((1, 1, 1), wire, dtype=torch.int32,
                                  device=dev)
            return out, totals, incoming

        release = None
        if self._ring_fused_active():
            # dest-major fills written straight into the send buffer's
            # payload lanes; lane 0 of round 0 carries the size exchange
            send = torch.zeros((local, num_rounds, mesh, ppd, w_eff,
                                capacity + 1), dtype=torch.int32, device=dev)
            for s in range(local):
                sr, counts, offs = map_side(s)
                with span("shuffle:fill", dev):
                    for r in range(num_rounds):
                        fill_round_slots_dest_major(
                            sr, counts, offs, num_parts, mesh, capacity, r,
                            out=send[s, r, :, :, :, 1:])
                    send[s, 0, :, :, 0, 0] = _device_partition_counts(
                        counts, num_parts, mesh).to(torch.int32)
                del sr
            exchange = make_ring_exchange(mesh, num_rounds, self.metrics,
                                          rt, self.collectives)
            # across processes recv is this process's window: read in
            # place below, then released
            with span("shuffle:move", dev):
                recv = exchange(send)
            release = exchange.release
            del send
            # recv[d, r, s, q, w, 1 + c]
            incoming = recv[:, 0, :, :, 0, 0].clone()
            streams = [recv[d, :, :, :, :, 1:].permute(3, 2, 1, 0, 4)
                       for d in range(local)]
            del recv
        else:
            a2a = self._data_a2a()
            mapped = [map_side(s) for s in range(local)]
            incoming = torch.stack([
                _device_partition_counts(c, num_parts, mesh)
                for _, c, _ in mapped])
            # the size exchange: a transpose here, the data's move
            # across processes
            incoming = (incoming.transpose(0, 1) if self.processes == 1
                        else a2a(incoming)).to(torch.int32)
            rounds = []
            for r in range(num_rounds):
                with span("shuffle:fill", dev):
                    send = torch.stack([
                        fill_round_slots(sr, c, o, num_parts, capacity, r)[0]
                        .reshape(w_eff, ppd, mesh, capacity)
                        .permute(2, 1, 0, 3)
                        for sr, c, o in mapped])  # [D_src, D_dst, ppd, W, C]
                with span("shuffle:move", dev):
                    rounds.append(a2a(send))      # [D_dst, D_src, ppd, W, C]
                del send
            del mapped
            # per destination: [S, ppd, R, W, C] -> (w; q, s, r, c)
            streams = [torch.stack([rv[d] for rv in rounds], dim=2)
                       .permute(3, 1, 0, 2, 4) for d in range(local)]

        # reduce side: chunk (q, s, r) is prefix-valid with length
        # clip(incoming[d, s, q] - r*C, 0, C), in stream order (q, s, r)
        r_ix = torch.arange(num_rounds, device=dev)[None, :] * capacity
        for d in range(local):
            with span("shuffle:fold", dev):
                inc = incoming[d].T.reshape(ppd * mesh, 1).to(torch.int64)
                chunk_len = torch.clamp(inc - r_ix, 0, capacity).reshape(-1)
                stream = streams[d].reshape(w_eff, -1)
                streams[d] = None                # free as we go
                part, total = compact_segments(stream, chunk_len, oc)
                del stream
            with span("shuffle:tail", dev):
                part, total = self._fuse_tail(part, total, oc,
                                              sort_key_words, aggregator,
                                              float_payload, tight)
                out[rows, d * oc:(d + 1) * oc] = part
                totals[d] = total
        if release is not None:
            release()
        return out, totals, incoming

    # ------------------------------------------------------------------
    # phase 2, streaming regime: bounded rounds in flight
    # ------------------------------------------------------------------
    def _exchange_streaming(self, records, partitioner, plan, num_parts,
                            sort_key_words, aggregator, float_payload,
                            combine, row_filter, keep_words, shuffle_id):
        """The reference's prep, chunk, fold and tail programs as steps
        over the stacked partitions.

        - prep: the map side of every source (filter, projection,
          combine, bucketing; one ``bucket_scatter`` launch for all of
          them where :func:`map_kernel_takes`) and the size exchange; the
          bucketed sources sit side by side in one gather source,
          followed by one zero column that every empty slot position
          reads;
        - chunk ``j``: rounds ``[j*F, (j+1)*F)`` of every (source,
          destination) slot gathered into one pooled send buffer (no
          counts lane: prep did the size exchange; rounds past the plan
          move zeros) and moved into a pooled receive buffer;
        - fold ``j``: one indexed copy puts every valid column of the
          chunk at its exact offset in the destination's stream — (q, s,
          r) order over all ``n_chunks * F`` rounds, as the fused regime
          compacts — and the rest of the chunk into dump columns past
          the output;
        - tail: each partition's ``out_capacity`` columns through
          :meth:`_fuse_tail`, re-widened under a projection.

        Chunk offsets are computed on the device, so the loop never waits
        for the card except to pace: once ``queue_depth`` chunks are in
        flight, the host waits for the oldest one's fold (a CUDA event;
        on the CPU, where work is synchronous, the same count of waits
        is kept and there is nothing to wait for).

        A failure midway (``exchange.stream_round``, ``pool.acquire``, a
        launch) abandons the exchange: the accumulator and the chunk's
        send and receive buffers go back to the pool before the error
        propagates, so the pool's ``outstanding`` reads as before the
        attempt. The chunks still queued on the stream may read and
        write them after that; the pool's one-stream rule
        (``hbm/slot_pool.py``) covers this, as for any buffer put back
        with work queued: the next holder's work runs after theirs."""
        rt = self.runtime
        m = self.metrics
        mesh = self.mesh_size
        local = rt.local_partitions
        ppd = num_parts // mesh
        cap = plan.capacity
        oc = plan.out_capacity
        f_in = self.conf.max_rounds_in_flight
        n_chunks = math.ceil(plan.num_rounds / f_in)
        total_rounds = n_chunks * f_in
        w = records.shape[0]
        w_eff = len(keep_words) if keep_words is not None else w
        dev = records.device
        n = records.shape[1] // local
        unfused = (self.transport() == "pallas_ring"
                   and not self.conf.ring_fused)
        # the move of a hierarchical or multi-process exchange: [L_src,
        # D_dst, ...] -> [L_dst, D_src, ...] (None: the stacked paths);
        # the ring's chunks take its own move below, its counts this one
        cross = (self._data_a2a() if self.transport() == "hierarchical"
                 or self.processes > 1 else None)

        tl = self.timeline
        # --- prep -------------------------------------------------------
        with span("shuffle:prep", dev):
            tl.begin("stream:prep", chunks=n_chunks, rounds=plan.num_rounds)
            if map_kernel_takes(dev.type == "cuda", partitioner, num_parts,
                                combine, row_filter, keep_words):
                # every source bucketed by one launch, straight into the
                # chunks' gather source
                m.counter("exchange.map_passes_kernel").inc()
                with span("shuffle:map", dev):
                    src, cnts, offs = bucket_scatter(records, partitioner,
                                                     num_parts, local)
            else:
                srs, cnts, offs = [], [], []
                for s in range(local):
                    sr, c, o = self._map_side(
                        rt.partition(records, s), partitioner, num_parts,
                        combine, aggregator, float_payload, row_filter,
                        keep_words)
                    srs.append(sr)
                    cnts.append(c)
                    offs.append(o)
                with span("shuffle:fill", dev):
                    # the chunks' gather source
                    src = torch.cat(srs + [srs[0].new_zeros((w_eff, 1))],
                                    dim=1)
                del srs
                cnts, offs = torch.stack(cnts), torch.stack(offs)
            zero_col = local * n
            # dest-major: p_dq[d, q] = partition q * mesh + d
            p_dq = torch.arange(num_parts, device=dev).reshape(ppd, mesh).T
            cnt = cnts[:, p_dq]                                # [S, D, ppd]
            base = offs[:, p_dq] + (
                torch.arange(local, device=dev) * n)[:, None, None]
            if self.processes == 1:
                incoming = cnt.transpose(0, 1).to(torch.int32)  # [D, S, ppd]
                by_dest = cnt.permute(1, 2, 0)                  # [D, ppd, S]
            else:
                # the size exchange rides the data's move between processes
                with span("shuffle:move", dev):
                    moved = cross(cnt)                          # [L, S, ppd]
                incoming = moved.to(torch.int32)
                by_dest = moved.permute(0, 2, 1)                # [L, ppd, S]
            # segment (q, s, r) of destination d: its length and its start
            # in the destination's columns of the accumulator
            r_ix = torch.arange(total_rounds, device=dev) * cap
            seg = (by_dest[..., None] - r_ix).clamp(0, cap)
            flat = seg.reshape(local, -1)                      # [L, ppd*S*TR]
            starts = ((flat.cumsum(1) - flat).reshape(seg.shape)
                      + (torch.arange(local, device=dev) * oc)[:, None, None,
                                                               None])
            totals = flat.sum(1)
            col = torch.arange(cap, device=dev)
            dump = local * oc + col
            dispatches = 1
            tl.end("stream:prep")

        acc = self._get_buf((w_eff, local * oc + cap), dev)
        send = recv = None
        try:
            with span("shuffle:fold", dev):
                # a pooled buffer holds its last user's words
                acc.zero_()
            shape = ((f_in, local, mesh, ppd, w_eff, cap) if unfused
                     else (local, f_in, mesh, ppd, w_eff, cap))
            # record slots one chunk moves: every (source, destination
            # sub-partition) pair's F rounds of ``cap`` slots
            chunk_slots = f_in * local * num_parts * cap
            move = (make_ring_all_to_all(mesh, m, rt, self.collectives)
                    if unfused
                    else make_ring_exchange(mesh, f_in, m, rt,
                                            self.collectives)
                    if self._ring_fused_active() else None)
            # across processes the fused ring's receive is the window,
            # which the fold reads in place
            in_window = self.processes > 1 and self._ring_fused_active()
            in_flight = collections.deque()
            for j in range(n_chunks):
                if faults.fire("exchange.stream_round") == "fail":
                    # abandons the exchange: the accumulator holds
                    # partial rounds, and the retry starts over
                    m.counter("exchange.faults").inc()
                    raise FetchFailedError(
                        shuffle_id, f"injected fault (fault_spec: "
                        f"exchange.stream_round, chunk {j})")
                if len(in_flight) >= self.conf.queue_depth:
                    # the recvQueueDepth throttle: wait for the oldest.
                    # THE blocking wait of the regime, so it is armed: a
                    # wedged chunk journals a stall instead of hanging
                    # silently (Event.synchronize releases the GIL, so
                    # the watchdog's timer runs meanwhile)
                    m.counter("exchange.queue_blocks").inc()
                    with span("shuffle:queue_block", dev):
                        tl.begin("queue:block", chunk=j)
                        with self.watchdog.armed(
                                "queue:block", shuffle=shuffle_id, chunk=j,
                                queue=len(in_flight),
                                pool_high_water=(
                                    self.pool.outstanding_high_water
                                    if self.pool is not None else 0)):
                            if self.block_hook is not None:
                                self.block_hook(j)
                            done = in_flight.popleft()
                            if done is not None:
                                done.synchronize()
                        tl.end("queue:block", chunk=j)
                m.counter("exchange.stream_chunks").inc()
                with span("shuffle:chunk", dev):
                    tl.begin("chunk", chunk=j)
                    rounds = slice(j * f_in, (j + 1) * f_in)
                    with span("shuffle:fill", dev):
                        # chunk: send[s, f, d, q, :, c] = source s's column
                        # c of round j*F+f of partition q*mesh+d, or the
                        # zero column
                        pos = (r_ix[rounds, None] + col)[None, :, None, None,
                                                         :]
                        idx = torch.where(pos < cnt[:, None, :, :, None],
                                          base[:, None, :, :, None] + pos,
                                          zero_col)
                        if unfused:
                            idx = idx.transpose(0, 1)  # [F, S, D, ppd, C]
                        send = self._get_buf(shape, dev)
                        torch.gather(src.expand(shape[:4] + src.shape), 5,
                                     idx.unsqueeze(4).expand(shape), out=send)
                    with span("shuffle:move", dev):
                        if in_window:
                            # [L_dst, F, D_src, ...]: a synchronous move,
                            # whose ready step waits for the last chunk's
                            # fold
                            view = move(send)
                        elif cross is not None and move is None:
                            # [L_src, D_dst, F, ...] -> [L_dst, D_src, F, ...]
                            view = cross(send.transpose(1, 2)).transpose(1, 2)
                        else:
                            recv = self._get_buf(shape, dev)
                            if unfused:
                                for f in range(f_in):
                                    move(send[f], out=recv[f])
                                # [L, F, S, ppd, W, C]
                                view = recv.transpose(0, 1)
                            elif move is not None:
                                view = move(send, out=recv)
                            else:
                                view = recv.copy_(send.transpose(0, 2))
                    m.counter("exchange.slots_moved").inc(chunk_slots)
                    self._put_buf(send)
                    send = None
                    tl.event("chunk:dispatch", chunk=j, rounds=f_in)
                    if self._ring_fused_active():
                        # structural marks, as in the fused regime
                        for jr in range(f_in):
                            tl.begin("ring:round", round=j * f_in + jr)
                            tl.end("ring:round", round=j * f_in + jr)
                    with span("shuffle:fold", dev):
                        # fold: column c of (d, f, s, q) lands at its
                        # stream offset
                        ln = seg[..., rounds].permute(0, 3, 2, 1)[..., None]
                        st = starts[..., rounds].permute(0, 3, 2, 1)[...,
                                                                     None]
                        acc[:, torch.where(col < ln, st + col, dump)] = \
                            view.permute(4, 0, 1, 2, 3, 5)
                    del view
                    if in_window:
                        move.release()   # the fold that reads the window
                    if recv is not None:
                        self._put_buf(recv)  # read by the fold already queued
                    recv = None
                    dispatches += 2
                    done = None
                    if dev.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(dev))
                    in_flight.append(done)
                    tl.event("chunk:fold", chunk=j)
                    tl.end("chunk", chunk=j)
                tl.counter("chunks.outstanding", len(in_flight))
            del src

            # --- tail ---------------------------------------------------
            rows = (list(keep_words) if keep_words is not None
                    else slice(None))
            with span("shuffle:tail", dev):
                out = (self.pool.zeros((w, local * oc))
                       if self.pool is not None
                       else torch.zeros((w, local * oc), dtype=torch.int32,
                                        device=dev))
            new_totals = []
            for d, total in enumerate(totals.tolist()):
                with span("shuffle:tail", dev):
                    part, total = self._fuse_tail(
                        acc[:, d * oc:(d + 1) * oc], total, oc,
                        sort_key_words, aggregator, float_payload)
                    out[rows, d * oc:(d + 1) * oc] = part
                new_totals.append(total)
            tl.event("stream:tail")
        except BaseException:
            # an abandoned exchange gives its buffers back (docstring)
            for buf in (send, recv, acc):
                if buf is not None:
                    self._put_buf(buf)
            raise
        self._put_buf(acc)
        dispatches += 1
        self.last_dispatches = dispatches
        m.counter("exchange.dispatches").inc(dispatches)
        return (out, torch.tensor(new_totals, dtype=torch.int32, device=dev),
                incoming)

    # ------------------------------------------------------------------
    # plan + exchange in one call (callers without a manager)
    # ------------------------------------------------------------------
    def shuffle(self, records: torch.Tensor, partitioner: Callable,
                num_parts: Optional[int] = None,
                capacity: Optional[int] = None, shuffle_id: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor, ShufflePlan]:
        """:meth:`plan` and :meth:`exchange` in one call; returns ``(out,
        totals, plan)``.

        With ``conf.collect_shuffle_read_stats`` each call adds an
        :class:`~sparkrdma_tpu_torch.obs.stats.ExchangeRecord` to
        ``self.stats``, and with an enabled ``journal`` it writes a
        (sampled) span, folded into ``rollup`` when one is given: the
        stats and journal path of exchanges driven without a
        ShuffleManager. Either one times the exchange through
        a closing device sync; with neither, nothing waits."""
        from sparkrdma_tpu_torch.utils.stats import Timer, barrier

        plan = self.plan(records, partitioner, num_parts, capacity)
        journal_on = self.journal is not None and self.journal.enabled
        if not (self.stats.enabled or journal_on):
            out, totals, _ = self.exchange(records, partitioner, plan,
                                           num_parts, shuffle_id=shuffle_id)
            return out, totals, plan
        with Timer() as t:
            out, totals, _ = self.exchange(records, partitioner, plan,
                                           num_parts, shuffle_id=shuffle_id)
            barrier(out, totals)
        per_source = plan.counts.sum(axis=1)
        if self.stats.enabled:
            self.stats.add(ExchangeRecord(
                shuffle_id=shuffle_id, plan_s=self.last_plan_s,
                exec_s=t.elapsed, total_records=plan.total_records,
                record_bytes=records.shape[0] * 4,
                num_rounds=plan.num_rounds,
                per_source_records=per_source))
        if journal_on:
            from sparkrdma_tpu_torch.hbm.tiered_store import store_totals
            from sparkrdma_tpu_torch.obs import critical_path
            from sparkrdma_tpu_torch.obs import trace as _trace
            from sparkrdma_tpu_torch.obs.journal import (ExchangeSpan,
                                                         next_span_id)

            span_id = next_span_id()
            st_spill, st_fetch, st_hits, st_sync = store_totals()
            span = ExchangeSpan(
                span_id=span_id, shuffle_id=shuffle_id, tenant=self.tenant,
                transport=self.transport(), rounds=plan.num_rounds,
                dispatches=self.last_dispatches,
                records=plan.total_records,
                record_bytes=records.shape[0] * 4,
                plan_s=self.last_plan_s, exchange_s=t.elapsed, sort_s=0.0,
                per_peer_records=[int(c) for c in per_source],
                pool_high_water=(self.pool.outstanding_high_water
                                 if self.pool is not None else 0),
                process_index=self.identity[0],
                host_count=self.identity[1],
                events=self.timeline.drain(),
                store_spill_bytes=st_spill, store_fetch_bytes=st_fetch,
                store_prefetch_hits=st_hits, store_sync_fetches=st_sync,
                **self.reference_wire_stats())
            tctx = _trace.current_trace()
            if tctx is not None:
                span.trace_id = tctx.trace_id
                span.job = tctx.job
                span.stage = tctx.stage
                span.stage_attempt = tctx.stage_attempt
            critical_path.enrich(span, metrics=self.metrics)
            _trace.observe_active_span(span)
            weight = self.sampler.keep_weight(span_id, t.elapsed)
            if self.rollup is not None:
                self.rollup.observe(span, kept=weight > 0)
            if weight > 0:
                span.sample_weight = weight
                self.journal.emit(span)
            else:
                self.metrics.counter("journal.sampled_out").inc()
        return out, totals, plan


__all__ = ["ShuffleExchange", "ShufflePlan", "split_partitioner"]
