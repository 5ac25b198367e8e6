"""ShuffleManager-shaped public API — the Spark SPI surface.

The same five-method workflow as ``sparkrdma_tpu.api.shuffle_manager``:

    manager = ShuffleManager(MeshRuntime(conf, num_partitions=8))
    handle  = manager.register_shuffle(0, num_parts=8, partitioner=part)
    manager.get_writer(handle).write(records).stop()   # map stage + plan
    out, totals = manager.get_reader(handle, key_ordering=True).read()
    manager.unregister_shuffle(0); manager.stop()

One writer/reader pair drives every stacked partition at once. A reader
may aggregate (``aggregator``, with the map-side combine gate), push a
predicate and a projection into the exchange (``row_filter``,
``keep_words``, full range only), or read a range of partitions. A
full-range read fuses its sort or aggregation into the exchange's tail;
a ranged read keeps its partitions' rows first, then aggregates or
sorts them, as in the reference. ``read_view`` and ``read_partition``
give one partition's records out of a raw read.

Buffer lifecycle (the reference's ``RdmaBufferManager`` contract): the
manager's exchange draws its buffers from the runtime's ``SlotPool``.
A full-range fused read's ``out`` is recycled as the output of the next
same-geometry read of the same shuffle, which overwrites it in place:
consume or copy it first. ``unregister_shuffle`` and ``stop`` return the
recycled buffers to the pool.

Out-of-core (``workloads/streaming.py``): every manager owns a
:class:`~sparkrdma_tpu_torch.hbm.tiered_store.TieredStore`
(``manager.tiered``) over the runtime's pool, through which its exchange
acquires buffers; with ``conf.spill_dir`` set it also owns a
``MapOutputStore`` (``manager.store``) for segment checkpoints
(``checkpoint_segments`` / ``resume_segments``). ``unregister_shuffle``
drops the shuffle's segments and ``stop`` closes the store.

Durability and retry (the reference's Spark contract: a fetch failure,
then a stage retry from map output that survived):

- ``register_shuffle`` goes through a
  :class:`~sparkrdma_tpu_torch.meta.map_output.MapOutputRegistry`;
  ``ShuffleWriter.stop`` publishes the counts and, with
  ``conf.spill_to_host`` and a store, checkpoints the map output whole
  (``checkpoint_shuffle``); ``resume_shuffle`` rebuilds a writer from a
  checkpoint (a restarted manager skips the map stage);
  ``unregister_shuffle`` deletes the checkpoint, ``stop`` keeps it.
- ``read`` runs in a retry loop: an attempt that raises
  ``FetchFailedError`` (an injected fault), ``torch.AcceleratorError``
  (a CUDA failure, at the closing sync included) or ``KernelLaunchError``
  (a kernel's entry point refused) is retried up to
  ``conf.max_retry_attempts`` times within ``conf.retry_deadline_s``,
  with ``faults.backoff_ms`` sleeps, each retry logged as a warning;
  before each attempt the writer is recovered (the live one while its
  records and plan are intact, else the checkpoint). Any other error (a
  build error, a shape error, a ``TORCH_CHECK``) propagates at once: a
  retry would hide it. An unreadable checkpoint raises
  ``UnrecoverableShuffleError`` once.
- A standalone manager installs its fault plane (``faults.FaultPlane(
  conf.fault_spec)``) process-wide and puts the earlier one back in
  ``stop``.

Observability (``obs/``), as in the reference: with ``conf.metrics_sink``
set, each ``read(record_stats=True)`` call writes one journal span (one
per call, not per attempt: its ``retry_count`` and ``backoff_ms`` carry
the retries), built after the read's closing device sync from host data
only, enriched with the critical-path attribution, stamped with the job
trace in force (:meth:`ShuffleManager.job`) and sampled by
``conf.journal_sample``. The span's ``events`` are the manager's
timeline since the last span (the writer's ``plan`` included); the
exchange runs inside a ``shuffle:exchange#s<span_id>`` profiler range
(``utils/profiling.py``). ``conf.collect_shuffle_read_stats`` keeps an
``ExchangeRecord`` per read in ``manager.stats``, printed by ``stop``;
``conf.watchdog_timeout_s`` arms the stall watchdog around the streaming
wait. With a journal, every recorded read is also folded into the
windowed rollup (``obs/rollup.py``, ``conf.rollup_window_s``), sampled
away or not. The live layer, as in the reference, is gated on
``collect_shuffle_read_stats`` or ``metrics_sink`` (not on the port's
always-on registry) and each part on its own knob: the telemetry store
(``telemetry_window_s``), the heartbeat (``heartbeat_s``), the alert
evaluator with its baselines (``alert_eval_s``, ``baseline_dir``) and
the probe on ``127.0.0.1`` (``probe_port``). With the default knobs a
manager starts no thread and opens no socket.

Service mode (``tiered=`` given: a session that
:class:`~sparkrdma_tpu_torch.service.daemon.ShuffleService` hands a
tenant): the runtime, its pool, the tiered store, the journal and the
telemetry store are the daemon's, shared and never closed here, and the
daemon owns the heartbeat, the alerts and the probe. The session's fault
plane and timeline are installed for the calling thread only, for the
duration of each SPI call (:meth:`ShuffleManager._tenant_scope`), never
process-wide, so one tenant's fault schedule cannot fire inside another
tenant's read. Its pooled buffers and store segments are charged to the
tenant's account, each read waits for the admission controller at a
cost of its plan's rounds, and ``stop`` drops only its tenant's segments.
Across processes a session also has its own collective scope
(``collectives``, :func:`~sparkrdma_tpu_torch.runtime.distributed
.collective_scope`): its plan counts, samples, combine-gate broadcast,
moves and folds never meet another session's in one collective. A
manager given none uses the default group's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch._build import KernelLaunchError
from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.exchange.errors import (FetchFailedError,
                                                 UnrecoverableShuffleError)
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange, ShufflePlan
from sparkrdma_tpu_torch.exchange.windows import close_scope
from sparkrdma_tpu_torch.hbm.slot_pool import Slot
from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore
from sparkrdma_tpu_torch.kernels.aggregate import OPS
from sparkrdma_tpu_torch.kernels.sort import sort_by_lead_cols
from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore
from sparkrdma_tpu_torch.meta.map_output import MapOutputRegistry
from sparkrdma_tpu_torch.obs import critical_path
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.obs.alerts import AlertEvaluator
from sparkrdma_tpu_torch.obs.baseline import BaselineStore
from sparkrdma_tpu_torch.obs.journal import (ExchangeJournal, ExchangeSpan,
                                             next_span_id)
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from sparkrdma_tpu_torch.obs.probe import ProbeServer
from sparkrdma_tpu_torch.obs.rollup import (HeartbeatEmitter,
                                            RollupAggregator,
                                            span_latency_ms)
from sparkrdma_tpu_torch.obs.timeline import (EventTimeline, scoped_active,
                                              set_active)
from sparkrdma_tpu_torch.obs.tsdb import NULL_TELEMETRY, TelemetryStore
from sparkrdma_tpu_torch.obs.watchdog import (StallWatchdog,
                                              install_state_dump)
from sparkrdma_tpu_torch.runtime.distributed import (WORLD, Collectives,
                                                      refuse_across_processes)
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime
from sparkrdma_tpu_torch.utils.profiling import annotate, annotate_span
from sparkrdma_tpu_torch.utils.stats import (ExchangeRecord,
                                             ShuffleReadStats, Timer,
                                             barrier)

log = logging.getLogger("sparkrdma_tpu_torch.api")

_SENTINEL = 0xFFFFFFFF      # rank of a dropped segment (sorts last)

#: what a read attempt maps to ``FetchFailedError`` (the counterpart of
#: the reference's ``jax.errors.JaxRuntimeError``): a CUDA runtime
#: failure as PyTorch reports it (``torch.AcceleratorError``), and a
#: kernel entry point's refusal
_DEVICE_ERRORS = (torch.AcceleratorError, KernelLaunchError)


@dataclasses.dataclass
class ShuffleHandle:
    """Ticket returned by ``register_shuffle`` (Spark's ShuffleHandle)."""

    shuffle_id: int
    num_parts: int
    partitioner: Callable


def _partition_windows(plan: ShufflePlan, mesh: int, num_parts: int,
                       partition: int) -> List[Tuple[int, int, int]]:
    """Where original partition ``partition`` lies in the raw exchange
    output: ``(stacked partition, start, length)`` windows, one per
    sub-partition of a skew-split plan (``p + num_parts * j``, all on
    the same stacked partition as ``p``). A stacked partition's output
    is its local (sub-)partitions in ascending global id, each a
    contiguous segment of ``sum(counts[:, sp])`` records."""
    d = partition % mesh
    owned = plan.counts.sum(axis=0)
    windows = []
    for j in range(plan.split_factor):
        sp = partition + num_parts * j
        q = sp // mesh
        start = sum(int(owned[qq * mesh + d]) for qq in range(q))
        windows.append((d, start, int(owned[sp])))
    return windows


class ShuffleWriter:
    """Map side: hold the records; ``stop`` plans and publishes."""

    def __init__(self, manager: "ShuffleManager", handle: ShuffleHandle):
        self._m = manager
        self._h = handle
        self._records: Optional[torch.Tensor] = None
        self._plan: Optional[ShufflePlan] = None

    def write(self, records: torch.Tensor) -> "ShuffleWriter":
        if self._records is not None:
            raise RuntimeError("writer already holds records (one write per "
                               "map stage)")
        if records.device != self._m.runtime.device:
            raise ValueError(f"records on {records.device}, runtime on "
                             f"{self._m.runtime.device}")
        self._records = records
        return self

    def stop(self, success: bool = True) -> Optional[ShufflePlan]:
        """On success: plan the shuffle (the size exchange) and publish
        its counts; with ``conf.spill_to_host`` and a store, also
        checkpoint the map output (a restarted job resumes it with
        :meth:`ShuffleManager.resume_shuffle`)."""
        if not success or self._records is None:
            self._records = None
            return None
        with self._m._tenant_scope(), Timer() as t, \
                annotate("shuffle:plan", self._m.runtime.device):
            self._plan = self._m._exchange.plan(
                self._records, self._h.partitioner, self._h.num_parts)
        self._m._registry.publish_map_output(self._h.shuffle_id,
                                             self._plan.counts)
        self._m._plan_seconds[self._h.shuffle_id] = t.elapsed
        if self._m.store is not None and self._m.conf.spill_to_host:
            self._m.checkpoint_shuffle(self._h, writer=self)
        return self._plan

    @property
    def records(self) -> Optional[torch.Tensor]:
        return self._records

    @property
    def plan(self) -> Optional[ShufflePlan]:
        return self._plan


class ShuffleReader:
    """Reduce side: run the exchange; optionally aggregate or key-sort."""

    def __init__(self, manager: "ShuffleManager", handle: ShuffleHandle,
                 start_partition: int = 0,
                 end_partition: Optional[int] = None,
                 key_ordering: bool = False,
                 aggregator: Optional[str] = None,
                 float_payload: bool = False,
                 row_filter: Optional[Callable] = None,
                 keep_words: Optional[Tuple[int, ...]] = None,
                 combine_hint: Optional[Tuple[bool, float]] = None):
        self._m = manager
        self._h = handle
        self.start_partition = start_partition
        self.end_partition = (handle.num_parts if end_partition is None
                              else end_partition)
        if not 0 <= self.start_partition < self.end_partition <= \
                handle.num_parts:
            raise ValueError(
                f"invalid partition range [{self.start_partition}, "
                f"{self.end_partition}) for {handle.num_parts} partitions")
        if aggregator is not None and aggregator not in OPS:
            raise ValueError(f"unsupported aggregator {aggregator!r}")
        if float_payload and aggregator is None:
            raise ValueError("float_payload requires an aggregator")
        if (row_filter is not None or keep_words is not None) and \
                not self._full_range:
            # a ranged read slices the output by the plan's pre-filter
            # counts, which a pushdown would shrink underneath it
            raise ValueError(
                "row_filter/keep_words pushdown requires a full "
                "partition range (partition-ranged reads slice by the "
                "plan's pre-filter counts)")
        self.key_ordering = key_ordering
        self.aggregator = aggregator
        self.float_payload = float_payload
        self.row_filter = row_filter
        self.keep_words = keep_words
        #: a hoisted combine-gate decision ``(use, dup_ratio)``
        #: (``ShuffleExchange.plan_combine``), used instead of sampling
        self.combine_hint = combine_hint

    @property
    def _full_range(self) -> bool:
        return (self.start_partition, self.end_partition) == \
            (0, self._h.num_parts)

    def read(self, record_stats: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(records [W, D*out_capacity], totals int32[D])``: stacked
        partition ``d``'s columns are its received records, zero-padded
        past ``totals[d]``. A partition range keeps only those
        partitions' rows. ``aggregator`` turns each partition's rows
        into its unique keys, ascending, with reduced payloads (``totals``
        counts them); otherwise ``key_ordering`` sorts them by key.

        A failed attempt is retried (module docstring). ``record_stats
        =False`` skips the closing device sync (warm-up and pipelined
        reads): a CUDA failure of such a read surfaces at the caller's
        own first sync, outside the retry loop."""
        # reads in flight (heartbeat lines, shuffle_top) cover the whole
        # read, the admission wait included
        self._m._read_started()
        try:
            with self._m._tenant_scope():
                return self._read(record_stats)
        finally:
            self._m._read_finished()

    def _read(self, record_stats: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        writer = self._m._recover_writer(self._h)
        adm = self._m.admission
        if adm is None:
            return self._read_attempts(writer, record_stats)
        # service mode: one ticket a read, weighed by the plan's rounds,
        # so the controller shares exchange rounds, not read calls; a
        # tenant over capacity queues here (an ``admission`` wait line)
        with adm.admit(self._m.tenant,
                       cost=max(int(writer.plan.num_rounds), 1)):
            return self._read_attempts(writer, record_stats)

    def _read_attempts(self, writer: ShuffleWriter, record_stats: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's retry loop: bounded by ``max_retry_attempts``
        and ``retry_deadline_s``, with ``faults.backoff_ms`` sleeps that
        never run past the deadline; then the read's stats record and
        journal span."""
        m = self._m
        conf = m.conf
        sid = self._h.shuffle_id
        # one span per read() call, not per attempt; its id names the
        # profiler range, jitters the backoff and tags stall lines
        journal_on = m.journal.enabled and record_stats
        span_id = next_span_id() if journal_on else 0
        m.watchdog.set_context(span_id=span_id, shuffle_id=sid)
        attempt = 0
        deadline = (time.monotonic() + conf.retry_deadline_s
                    if conf.retry_deadline_s > 0 else None)
        backoffs: List[float] = []   # per-attempt sleeps, ms (span field)
        while True:
            attempt += 1
            try:
                # the timer covers this attempt only, through its closing
                # sync: exec_s leaves out failed attempts and reloads
                with Timer() as t:
                    try:
                        out, totals, post_s = self._attempt(
                            writer, record_stats, span_id)
                    except _DEVICE_ERRORS as e:
                        raise FetchFailedError(
                            sid, f"backend failure during exchange: {e}",
                            attempt) from e
                break
            except FetchFailedError as e:
                if attempt >= conf.max_retry_attempts:
                    raise FetchFailedError(
                        sid, f"giving up after {attempt} attempts",
                        attempt) from e
                if deadline is not None and time.monotonic() >= deadline:
                    raise FetchFailedError(
                        sid, f"retry deadline {conf.retry_deadline_s}s "
                        f"exceeded after {attempt} attempts", attempt) from e
                log.warning("shuffle %d fetch failed (attempt %d/%d): %s; "
                            "retrying", sid, attempt,
                            conf.max_retry_attempts, e)
                m.timeline.event("retry", attempt=attempt, shuffle=sid)
                delay_ms = faults.backoff_ms(attempt, conf.retry_backoff_ms,
                                             span_id)
                if delay_ms > 0:
                    if deadline is not None:
                        delay_ms = min(delay_ms, max(
                            (deadline - time.monotonic()) * 1e3, 0.0))
                    backoffs.append(round(delay_ms, 3))
                    m.timeline.event("retry:backoff", attempt=attempt,
                                     ms=round(delay_ms, 3))
                    time.sleep(delay_ms / 1e3)
                writer = m._recover_writer(self._h)
        if record_stats:
            self._record(writer.plan, out, t.elapsed, post_s, span_id,
                         attempt, backoffs)
        return out, totals

    def _attempt(self, writer: ShuffleWriter, record_stats: bool,
                 span_id: int) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """One attempt: the exchange, a ranged read's filter and tail,
        and the closing sync. Returns ``(out, totals, post_s)``:
        ``post_s`` is the host time of a ranged read's separate filter
        and tail (0.0 when the tail is fused into the exchange)."""
        m = self._m
        dev = m.runtime.device
        full = self._full_range
        fuse_agg = (self.aggregator or "") if full else ""
        post_s = 0.0
        with annotate_span("shuffle:exchange", span_id, dev):
            out, totals, _ = m._exchange.exchange(
                writer.records, self._h.partitioner, writer.plan,
                self._h.num_parts, shuffle_id=self._h.shuffle_id,
                sort_key_words=(m.conf.key_words
                                if self.key_ordering and full else 0),
                aggregator=fuse_agg,
                float_payload=self.float_payload if fuse_agg else False,
                row_filter=self.row_filter, keep_words=self.keep_words,
                combine_hint=self.combine_hint if fuse_agg else None)
        if not full:
            with Timer() as ts, annotate_span("shuffle:filter+agg+sort",
                                              span_id, dev):
                args = (out, writer.plan, self._h.num_parts,
                        self.start_partition, self.end_partition)
                if writer.plan.split_factor > 1:
                    out, totals = m._filtered_split(*args)
                else:
                    out, totals = m._filtered(*args)
                if self.aggregator or self.key_ordering:
                    out, totals = m._ranged_tail(
                        out, totals, writer.plan,
                        m.conf.key_words if self.key_ordering else 0,
                        self.aggregator or "", self.float_payload)
            post_s = ts.elapsed
        if record_stats:
            barrier(out)
        return out, totals, post_s

    def _record(self, plan: ShufflePlan, out: torch.Tensor, elapsed: float,
                post_s: float, span_id: int, attempt: int,
                backoffs: List[float]) -> None:
        """The read's ``ExchangeRecord``, then (journal on) its span, in
        the reference's order: trace coordinates, critical-path
        attribution, the job's stage profile, sampling, then the line.
        Every field is host data (the plan's numpy counts, ints the
        exchange and the stores keep): nothing here waits for the card."""
        from sparkrdma_tpu_torch.api.serde import codec_totals
        from sparkrdma_tpu_torch.hbm.host_staging import spill_count
        from sparkrdma_tpu_torch.hbm.tiered_store import store_totals

        m = self._m
        ex = m._exchange
        sid = self._h.shuffle_id
        per_source = plan.counts.sum(axis=1)
        plan_s = m._plan_seconds.get(sid, 0.0)
        m.stats.add(ExchangeRecord(
            shuffle_id=sid, plan_s=plan_s, exec_s=elapsed,
            total_records=plan.total_records,
            record_bytes=out.shape[0] * 4, num_rounds=plan.num_rounds,
            per_source_records=per_source))
        if not span_id:
            return
        serde = codec_totals()
        st_totals = store_totals()
        pool = m.runtime.pool
        span = ExchangeSpan(
            span_id=span_id, shuffle_id=sid, tenant=m.tenant,
            transport=ex.transport(),
            rounds=plan.num_rounds, dispatches=ex.last_dispatches,
            records=plan.total_records, record_bytes=out.shape[0] * 4,
            plan_s=plan_s,
            # the attempt's time through the closing sync, less a ranged
            # read's separate tail, which is reported as sort_s
            exchange_s=max(elapsed - post_s, 0.0), sort_s=post_s,
            per_peer_records=[int(c) for c in per_source],
            pool_high_water=pool.outstanding_high_water,
            spill_count=spill_count(), retry_count=attempt - 1,
            backoff_ms=backoffs,
            degraded=faults.active_degradations(),
            store_spill_bytes=st_totals[0], store_fetch_bytes=st_totals[1],
            store_prefetch_hits=st_totals[2],
            store_sync_fetches=st_totals[3],
            process_index=m.runtime.process_index,
            host_count=m.runtime.process_count,
            # drain restarts the timeline's clock: the next span's events
            # are relative to this one (a sampled-away span drains too)
            events=m.timeline.drain(),
            **serde, **ex.wire_stats())
        tctx = _trace.current_trace()
        if tctx is not None:
            span.trace_id = tctx.trace_id
            span.job = tctx.job
            span.stage = tctx.stage
            span.stage_attempt = tctx.stage_attempt
        critical_path.enrich(span, metrics=m.metrics)
        _trace.observe_active_span(span)
        weight = m.sampler.keep_weight(span_id,
                                       span_latency_ms(span) / 1e3)
        # the rollup folds every read, kept or sampled away, so window
        # totals stay exact under any journal_sample
        if m.rollup is not None:
            m.rollup.observe(span, kept=weight > 0)
        if weight > 0:
            span.sample_weight = weight
            m.journal.emit(span)
        else:
            m.metrics.counter("journal.sampled_out").inc()

    def _raw_read(self) -> Tuple[torch.Tensor, torch.Tensor, ShufflePlan]:
        """A full-range, unsorted read: the raw (local partition, source)
        layout that per-partition windows are cut from, whatever this
        reader's own options."""
        out, totals = ShuffleReader(self._m, self._h).read()
        return out, totals, self._m._writers[self._h.shuffle_id].plan

    def read_view(self) -> "OutputView":
        """Run the exchange and return a reference-counted view of its
        output (``RdmaRegisteredBuffer``): ``view.partition(p)`` gives
        partition ``p``'s records without another exchange; release every
        retained view and the base, and the pages go back to the pool.
        One process only (a partition's window may lie in another)."""
        refuse_across_processes(self._m.runtime, "read_view",
                                "sparkrdma_tpu/api/shuffle_manager.py:582")
        return OutputView(self._m, self._h, *self._raw_read())

    def read_partition(self, partition: int) -> np.ndarray:
        """One partition's records as host rows ``uint32[n, W]`` (small
        data): the per-task view Spark's reader iterator returns."""
        if not self.start_partition <= partition < self.end_partition:
            raise ValueError(
                f"partition {partition} outside reader range "
                f"[{self.start_partition}, {self.end_partition})")
        # the reference's reads the whole output on the host, which no
        # process holds across processes: parity
        refuse_across_processes(self._m.runtime, "read_partition",
                                "sparkrdma_tpu/api/shuffle_manager.py:552")
        out, _, plan = self._raw_read()
        mesh = self._m.runtime.num_partitions
        cap = plan.out_capacity
        pieces = [out[:, d * cap + start:d * cap + start + length]
                  for d, start, length in _partition_windows(
                      plan, mesh, self._h.num_parts, partition)]
        return self._m.runtime.host_rows(torch.cat(pieces, dim=1))


class OutputView:
    """Reference-counted exchange output with per-partition slicing — the
    ``RdmaRegisteredBuffer`` analogue on the consumer side.

    The output is copied out of the exchange's recycled buffer into a
    pooled one that the view owns (a ``Slot``); ``partition(p)`` slices
    it, ``retain``/``release`` count its holders, and the last release
    hands the pages to the pool for a later same-shape exchange."""

    def __init__(self, manager: "ShuffleManager", handle: ShuffleHandle,
                 out: torch.Tensor, totals: torch.Tensor, plan: ShufflePlan):
        self._pool = manager.runtime.pool
        arr = self._pool.get_shaped(tuple(out.shape), out.dtype)
        arr.copy_(out)          # detach from the exchange's recycling
        self._slot = Slot(arr, arr.shape[1], arr.shape[0], self)
        self.totals = totals.cpu().numpy()
        self._plan = plan
        self._handle = handle
        self._mesh = manager.runtime.num_partitions
        self._cap = plan.out_capacity

    def _put(self, slot: Slot) -> None:
        """The slot's pool hook: called on the last release."""
        self._pool.put_shaped(slot.array)

    def retain(self) -> "OutputView":
        self._slot.retain()
        return self

    def release(self) -> None:
        self._slot.release()

    def partition(self, p: int) -> torch.Tensor:
        """Columnar records of partition ``p`` (valid rows only): a view
        of the base, or, on a skew-split plan whose partition spans
        several sub-partition segments, their concatenation (a copy)."""
        if not 0 <= p < self._handle.num_parts:
            raise ValueError(f"partition {p} out of range")
        arr = self._slot.array
        slices = [arr[:, d * self._cap + start:d * self._cap + start + ln]
                  for d, start, ln in _partition_windows(
                      self._plan, self._mesh, self._handle.num_parts, p)]
        return slices[0] if len(slices) == 1 else torch.cat(slices, dim=1)


class ShuffleManager:
    """The SPI root object — one per runtime."""

    def __init__(self, runtime: Optional[MeshRuntime] = None,
                 conf: Optional[ShuffleConf] = None, *,
                 num_partitions: int = 8, device="cuda", tenant: str = "",
                 tiered: Optional[TieredStore] = None,
                 journal: Optional[ExchangeJournal] = None,
                 admission=None, account=None, telemetry=None,
                 collectives: Optional[Collectives] = None):
        self.runtime = runtime or MeshRuntime(
            conf, num_partitions=num_partitions, device=device)
        self.conf = conf or self.runtime.conf
        #: the scope of this manager's collectives across processes (a
        #: service session's own, else the default group's)
        self.collectives = collectives if collectives is not None else WORLD
        # service mode (module docstring): the daemon's tiered store,
        # journal and telemetry; per-tenant plane and timeline per call
        self.tenant = tenant
        self.account = account
        self.admission = admission
        self._service_mode = tiered is not None
        self.metrics = MetricsRegistry(enabled=True)
        #: the reference's gate of the live layer (the port's registry is
        #: always on, so it cannot stand in for it)
        obs_on = (self.conf.collect_shuffle_read_stats
                  or bool(self.conf.metrics_sink))
        if journal is not None:
            self.journal = journal       # the daemon's: shared, not closed
            self._sink_path = ""         # the daemon's probe serves it
        else:
            # the exchange journal: one span per recorded read; a literal
            # {process} in the sink names the host's own file
            sink = self.conf.metrics_sink
            if "{process}" in sink:
                sink = sink.replace("{process}",
                                    str(self.runtime.process_index))
            self.journal = ExchangeJournal(
                sink, metrics=self.metrics,
                max_bytes=self.conf.journal_max_bytes)
            self._sink_path = sink
        #: which reads get a full span (the rest feed the metrics only)
        self.sampler = self.conf.sampling_policy()
        # the live telemetry store: the daemon's in service mode, else
        # this manager's own (folding in the process-wide registry, where
        # the tiered store and staging count), else the null store
        if telemetry is not None:
            self.telemetry = telemetry
        elif obs_on and self.conf.telemetry_window_s > 0:
            self.telemetry = TelemetryStore(
                self.metrics, window_s=self.conf.telemetry_window_s,
                history=self.conf.telemetry_history,
                extra_sources=(lambda: global_registry().snapshot(),))
            self.telemetry.start()
        else:
            self.telemetry = NULL_TELEMETRY
        #: per-shuffle windows of every recorded read (journal on)
        self.rollup = (RollupAggregator(
            self.journal, window_s=self.conf.rollup_window_s,
            process_index=self.runtime.process_index,
            store=self.telemetry if self.telemetry.enabled else None)
            if self.journal.enabled and self.conf.rollup_window_s > 0
            else None)
        #: reads executing now (heartbeat lines and shuffle_top)
        self._reads_in_flight = 0           # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        self.heartbeat = None
        if (not self._service_mode and self.journal.enabled
                and self.conf.heartbeat_s > 0):
            pool = self.runtime.pool
            self.heartbeat = HeartbeatEmitter(
                self.journal, self.conf.heartbeat_s,
                identity=self.runtime.process_identity(),
                probes={
                    "in_flight": lambda: self._reads_in_flight,
                    "pool_outstanding": lambda: pool.outstanding,
                    "host_tier_mb": (lambda: self.tiered.occupancy()[
                        "host_bytes"] // (1 << 20)),
                    "disk_tier_mb": (lambda: self.tiered.occupancy()[
                        "disk_bytes"] // (1 << 20)),
                })
            self.heartbeat.start()
        self.baselines = None
        self.alerts = None
        if (not self._service_mode and self.telemetry.enabled
                and self.conf.alert_eval_s > 0):
            self.baselines = (BaselineStore(self.conf.baseline_dir)
                              if self.conf.baseline_dir else None)
            self.alerts = AlertEvaluator(
                telemetry=self.telemetry, metrics=self.metrics,
                journal=self.journal, baselines=self.baselines,
                heartbeat=self.heartbeat,
                interval_s=self.conf.alert_eval_s,
                fire_after=self.conf.alert_fire_breaches,
                resolve_after=self.conf.alert_resolve_windows,
                geometry=f"w{self.runtime.num_partitions}")
            self.alerts.start()
        # the probe: a bind failure is logged, never fatal (telemetry
        # must not take down the shuffle it observes)
        self.probe = None
        if not self._service_mode and self.conf.probe_port >= 0:
            try:
                self.probe = ProbeServer(
                    self.conf.probe_port, metrics=self.metrics,
                    telemetry=self.telemetry,
                    identity=self.runtime.process_identity(),
                    journal_path=self._sink_path,
                    rollups=(self.rollup.peek
                             if self.rollup is not None else None),
                    alerts=(self.alerts.active
                            if self.alerts is not None else None),
                    health=(self.alerts.health
                            if self.alerts is not None else None),
                    jobs=self.telemetry.job_lines)
                self.probe.start()
            except OSError:
                log.warning("probe endpoint failed to bind port %d",
                            self.conf.probe_port, exc_info=True)
        # the per-span event timeline; a standalone manager installs it
        # process-wide so module-level sites (staging, the tiered store,
        # the fault plane) reach it; events accumulate over plan and read
        # and drain into the span. A session installs it per call.
        self.timeline = EventTimeline(enabled=self.journal.enabled)
        self._prev_timeline = (None if self._service_mode
                               else set_active(self.timeline))
        self.watchdog = StallWatchdog(self.conf.watchdog_timeout_s,
                                      journal=self.journal,
                                      metrics=self.metrics,
                                      timeline=self.timeline)
        if self.watchdog.enabled:
            install_state_dump()   # SIGUSR1 dump of armed waits
        # the fault plane: process-wide for a standalone manager (module-
        # level sites reach it without a handle), per call for a session
        self.faults = faults.FaultPlane(self.conf.fault_spec)
        self._prev_plane = None
        if not self._service_mode:
            self._prev_plane = faults.set_active_plane(
                self.faults if self.faults.enabled else None)
            # the node owns the pool, the exchange draws from it; a
            # session must not re-point the daemon's shared pool
            self.runtime.pool.metrics = self.metrics
            self.runtime.pool.timeline = self.timeline
        #: ``ExchangeRecord`` per recorded read
        #: (``conf.collect_shuffle_read_stats``)
        self.stats = ShuffleReadStats(self.conf.collect_shuffle_read_stats,
                                      registry=self.metrics)
        #: checkpoints under ``conf.spill_dir`` (None without it)
        self.store = (MapOutputStore(
            self.conf.spill_dir, use_native=self.conf.use_native_staging,
            compression=self.conf.compression,
            compression_level=self.conf.compression_level)
            if self.conf.spill_dir else None)
        #: the tiered out-of-core store: the pool as its HBM tier, host
        #: leases, disk segments (the daemon's in service mode)
        self.tiered = (tiered if tiered is not None
                       else TieredStore(self.conf, pool=self.runtime.pool))
        self._exchange = ShuffleExchange(
            self.runtime, self.conf, metrics=self.metrics,
            pool=self.runtime.pool, store=self.tiered, stats=self.stats,
            timeline=self.timeline, watchdog=self.watchdog,
            journal=self.journal, rollup=self.rollup,
            identity=(self.runtime.process_index,
                      self.runtime.process_count),
            tenant=self.tenant, account=self.account,
            collectives=self.collectives)
        ids = tuple(self.runtime.manager_id(i)
                    for i in range(self.runtime.num_partitions))
        self._registry = MapOutputRegistry(ids, metrics=self.metrics)
        self._writers: Dict[int, ShuffleWriter] = {}
        #: host seconds of each shuffle's plan (the span's ``plan_s``)
        self._plan_seconds: Dict[int, float] = {}

    def register_shuffle(self, shuffle_id: int, num_parts: int,
                         partitioner: Callable) -> ShuffleHandle:
        """Raises ``DuplicateShuffleIdError`` for a live id."""
        self._registry.register(shuffle_id, num_parts, partitioner)
        return ShuffleHandle(shuffle_id, num_parts, partitioner)

    def get_writer(self, handle: ShuffleHandle) -> ShuffleWriter:
        w = ShuffleWriter(self, handle)
        self._writers[handle.shuffle_id] = w
        return w

    def get_reader(self, handle: ShuffleHandle, start_partition: int = 0,
                   end_partition: Optional[int] = None,
                   key_ordering: bool = False,
                   aggregator: Optional[str] = None,
                   float_payload: bool = False,
                   row_filter: Optional[Callable] = None,
                   keep_words: Optional[Tuple[int, ...]] = None,
                   combine_hint: Optional[Tuple[bool, float]] = None
                   ) -> ShuffleReader:
        """``row_filter``/``keep_words`` push a predicate / projection
        into the exchange (full partition range only): filtered rows
        never occupy a slot, projected-away words never move and come
        back zero. ``combine_hint`` feeds a hoisted combine-gate
        decision to an aggregator read. See
        :meth:`ShuffleExchange.exchange`."""
        return ShuffleReader(self, handle, start_partition, end_partition,
                             key_ordering, aggregator, float_payload,
                             row_filter, keep_words, combine_hint)

    def job(self, name: str) -> "_trace.JobTrace":
        """A job trace over the exchanges that follow::

            with manager.job("tpcds_q64") as job:
                with job.stage("item_join"):
                    ...register / write / read...

        Every span written inside is stamped with the trace coordinates
        (journal schema v12); at exit one ``{"kind": "job"}`` line lands
        in the journal, with each stage's critical-path profile, the
        ``stage:idle`` time and the job's verdict
        (:mod:`sparkrdma_tpu_torch.obs.trace`)."""
        return _trace.JobTrace(name, tenant=self.tenant, journal=self.journal,
                               store=self.telemetry,
                               process_index=self.runtime.process_index)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """Forget the shuffle and return its recycled output buffers to
        the pool: its reads' outputs must be consumed by now. Its tiered
        store segments and its checkpoint go too."""
        self._registry.unregister(shuffle_id)
        self._writers.pop(shuffle_id, None)
        self._plan_seconds.pop(shuffle_id, None)
        self._exchange.release_shuffle(shuffle_id)
        self.tiered.delete_shuffle(shuffle_id, tenant=self.tenant)
        if self.store is not None:
            self.store.delete(shuffle_id)

    # --- durability: whole-shuffle checkpoints -------------------------
    def _require_store(self) -> MapOutputStore:
        if self.store is None:
            raise RuntimeError("no MapOutputStore configured "
                               "(set conf.spill_dir)")
        return self.store

    def checkpoint_shuffle(self, handle: ShuffleHandle,
                           writer: Optional[ShuffleWriter] = None) -> None:
        """Persist the published map output to the host store: the
        stacked ``[W, N]`` records as ``uint32`` and the plan
        (:meth:`MapOutputStore.save`). ``writer`` checkpoints that
        writer's state (``ShuffleWriter.stop`` passes itself), even if a
        later ``get_writer`` displaced it from the manager's table.
        Across processes each process writes only its own partitions'
        shards (:meth:`MapOutputStore.save_shards`), the reference's
        per-executor shuffle files."""
        store = self._require_store()
        if writer is None:
            writer = self._writers.get(handle.shuffle_id)
        if writer is None or writer.records is None or writer.plan is None:
            raise RuntimeError(
                f"shuffle {handle.shuffle_id}: nothing published to "
                "checkpoint")
        rt = self.runtime
        records = writer.records.cpu().numpy()
        if rt.process_count > 1:
            n = records.shape[1] // rt.local_partitions
            shards = [(coord, records[:, r * n:(r + 1) * n])
                      for r, coord in enumerate(rt.local_device_indices())]
            store.save_shards(
                handle.shuffle_id, shards, writer.plan, handle.num_parts,
                (records.shape[0], records.shape[1] * rt.process_count),
                rt.process_index, rt.process_count)
            return
        store.save(handle.shuffle_id, records, writer.plan, handle.num_parts)

    def resume_shuffle(self, handle: ShuffleHandle) -> ShuffleWriter:
        """Rebuild the writer of a re-registered shuffle (the same
        partitioner: functions are not saved, as a restarted Spark job
        re-creates its lineage) from its checkpoint, whole or sharded,
        on the runtime's device; the map stage is skipped. Across
        processes each reads only its own partitions. An unreadable
        checkpoint raises ``UnrecoverableShuffleError``."""
        store = self._require_store()
        meta = store.load_meta(handle.shuffle_id)
        plan = store.plan_from_meta(meta)
        num_parts = int(meta["num_parts"])
        if num_parts != handle.num_parts:
            raise ValueError(
                f"checkpoint has num_parts={num_parts}, handle says "
                f"{handle.num_parts}")
        mesh_now = self.runtime.num_partitions
        if plan.counts.shape[0] != mesh_now:
            # a stale plan on another mesh would overflow its rounds
            raise ValueError(
                f"checkpoint was taken on a {plan.counts.shape[0]}-device "
                f"mesh; current mesh has {mesh_now} devices — re-run the "
                "map stage instead of resuming")
        shape = tuple(meta["shape"])
        rt = self.runtime
        try:
            if meta.get("sharded"):
                # executor-local files: this process's shards only
                shard = (shape[0], shape[1] // mesh_now)
                records = np.concatenate(
                    [store.read_shard(handle.shuffle_id, c, shard)
                     for c in rt.local_device_indices()], axis=1)
            else:
                records = store.read_records(handle.shuffle_id, meta)
                if rt.process_count > 1:
                    n = shape[1] // mesh_now
                    first = rt.local_device_indices()[0] * n
                    records = records[:, first:first
                                      + rt.local_partitions * n]
        except OSError as e:
            # the live map output is gone and the persisted copy fails
            # its CRC check even after the store's re-reads: terminal
            raise UnrecoverableShuffleError(
                handle.shuffle_id, f"checkpoint unreadable: {e}") from e
        w = ShuffleWriter(self, handle)
        w._records = torch.from_numpy(
            np.ascontiguousarray(records).view(np.int32)).to(
                self.runtime.device)
        w._plan = plan
        self._writers[handle.shuffle_id] = w
        self._registry.publish_map_output(handle.shuffle_id, plan.counts)
        log.info("shuffle %d resumed from checkpoint: %d records",
                 handle.shuffle_id, plan.total_records)
        return w

    def _recover_writer(self, handle: ShuffleHandle) -> ShuffleWriter:
        """The live writer while its map output is intact, else the
        checkpoint's."""
        writer = self._writers.get(handle.shuffle_id)
        if (writer is not None and writer.records is not None
                and writer.plan is not None):
            return writer
        if self.store is not None and \
                self.store.has_records(handle.shuffle_id):
            return self.resume_shuffle(handle)
        raise RuntimeError(
            f"shuffle {handle.shuffle_id}: no published map output (and "
            "no checkpoint); call get_writer(handle).write(records).stop() "
            "first")

    # --- durability: segment checkpoints -------------------------------
    def checkpoint_segments(self, shuffle_id: int, segments,
                            plan: Optional[ShufflePlan], num_parts: int,
                            extra_meta: Optional[dict] = None) -> None:
        """Persist chunked map output (``[(key, array), ...]``) as
        independent CRC-framed segment files and a manifest
        (:meth:`MapOutputStore.save_segments`), for
        :meth:`resume_segments`. Host only: across processes each
        process writes what it is given under its own ``spill_dir``."""
        self._require_store().save_segments(shuffle_id, segments, plan,
                                            num_parts, extra_meta=extra_meta)

    def resume_segments(self, shuffle_id: int) -> List[str]:
        """Adopt a segment checkpoint into the tiered store, only the
        segments missing from it, and without reading them (the
        prefetcher brings them in as they are consumed). Returns the
        adopted keys. Host only: across processes each process adopts
        what its own ``spill_dir`` holds."""
        meta = self._require_store().load_segment_meta(shuffle_id)
        adopted = []
        for key, entry in meta["segments"].items():
            if self.tiered.contains(key):
                continue
            self.tiered.adopt(key, self.store.segment_path(shuffle_id, entry),
                              entry["shape"], entry["dtype"],
                              tenant=self.tenant, shuffle=shuffle_id)
            adopted.append(key)
        return adopted

    # --- ranged reads: per stacked partition, after the exchange -------
    def _filtered(self, out: torch.Tensor, plan: ShufflePlan,
                  num_parts: int, start: int, end: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keep only partitions ``[start, end)``: the kept partitions of
        a stacked partition are adjacent segments of its output, so they
        form one window, moved to the front with the rest zeroed. Across
        processes, of this process's partitions."""
        rt = self.runtime
        mesh = rt.num_partitions
        cap = plan.out_capacity
        first_d = rt.local_device_indices()[0]
        spans: Dict[int, Tuple[int, int]] = {}
        for p in range(start, end):
            d, st, ln = _partition_windows(plan, mesh, num_parts, p)[0]
            d -= first_d
            if not 0 <= d < rt.local_partitions:
                continue
            first, total = spans.get(d, (st, 0))
            spans[d] = (first, total + ln)
        res = torch.zeros_like(out)
        totals = torch.zeros(rt.local_partitions, dtype=torch.int32,
                             device=out.device)
        for d, (first, ln) in spans.items():
            res[:, d * cap:d * cap + ln] = out[:, d * cap + first:
                                               d * cap + first + ln]
            totals[d] = ln
        return res, totals

    def _filtered_split(self, out: torch.Tensor, plan: ShufflePlan,
                        num_parts: int, start: int, end: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The partition-range filter of a skew-split plan, whose
        sub-partition segments of one parent lie apart in the stream.
        Sub-partition ``j`` of a kept parent ``p`` ranks ``(p - start) *
        split + j``, every other row the sentinel ``0xFFFFFFFF``, and one
        stable rank-keyed sort groups the kept rows by parent, as an
        unsplit read lays them out."""
        rt = self.runtime
        mesh = rt.num_partitions
        local = rt.local_partitions
        first_d = rt.local_device_indices()[0]
        cap = plan.out_capacity
        k = plan.split_factor
        rank = torch.full((local, cap), _SENTINEL, dtype=torch.int64,
                          device=out.device)
        kept = [0] * local
        for p in range(start, end):
            for j, (d, st, ln) in enumerate(
                    _partition_windows(plan, mesh, num_parts, p)):
                d -= first_d
                if not 0 <= d < local:
                    continue
                rank[d, st:st + ln] = (p - start) * k + j
                kept[d] += ln
        mode = self._exchange.sort_mode(out.shape[0])
        res = torch.zeros_like(out)
        for d in range(local):
            part = out[:, d * cap:(d + 1) * cap]
            res[:, d * cap:d * cap + kept[d]] = sort_by_lead_cols(
                part, rank[d], mode)[:, :kept[d]]
        return res, torch.tensor(kept, dtype=torch.int32, device=out.device)

    def _ranged_tail(self, out: torch.Tensor, totals: torch.Tensor,
                     plan: ShufflePlan, sort_key_words: int, aggregator: str,
                     float_payload: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ranged read's aggregation or key sort of each stacked
        partition's kept prefix: the exchange's own tail, which a
        full-range read runs inside the exchange (so a key sort takes
        the merge-path kernel where the geometry allows)."""
        cap = plan.out_capacity
        res = torch.empty_like(out)
        new_totals = torch.empty_like(totals)
        for d, total in enumerate(totals.tolist()):
            res[:, d * cap:(d + 1) * cap], new_totals[d] = \
                self._exchange._fuse_tail(out[:, d * cap:(d + 1) * cap],
                                          total, cap, sort_key_words,
                                          aggregator, float_payload)
        return res, new_totals

    def stop(self) -> None:
        """Release the pooled buffers, close the store and the journal
        (printing the read stats' per-source table first); checkpoints
        stay for a restarted manager to resume. The heartbeat writes a
        last beat, the alert evaluator saves its baselines, the probe
        closes its socket and the rollup writes its open window. A
        service session drops its tenant's segments and closes nothing
        of the daemon's."""
        if not self._service_mode and faults.active_plane() is self.faults:
            faults.set_active_plane(self._prev_plane)
        if self.stats.enabled and self.stats.records:
            self.stats.print_histogram()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.alerts is not None:
            self.alerts.stop()
            self.alerts = None
        if self.probe is not None:
            self.probe.stop()
            self.probe = None
        if self.rollup is not None:
            self.rollup.flush()
        self._exchange.release_all()
        self._writers.clear()
        # the ring's receive windows of this manager's scope (collective
        # where one is mapped: every process stops alike)
        close_scope(self.collectives)
        if self.collectives is not WORLD:
            self.collectives.close()
        if self._service_mode:
            self.tiered.delete_tenant(self.tenant)
            return
        self.telemetry.stop()
        self.journal.close()
        self.tiered.close()
        self.runtime.stop()
        # the process-wide timeline goes back to the earlier manager's
        # only if it is still this one's (as the fault plane does)
        current = set_active(self._prev_timeline)
        if current is not self.timeline:
            set_active(current)      # a later manager's: it stays

    def _read_started(self) -> None:
        with self._inflight_lock:
            self._reads_in_flight += 1
            n = self._reads_in_flight
        self.metrics.gauge("reads.in_flight").set(n)

    def _read_finished(self) -> None:
        with self._inflight_lock:
            self._reads_in_flight -= 1
            n = self._reads_in_flight
        self.metrics.gauge("reads.in_flight").set(n)

    def _tenant_scope(self) -> contextlib.ExitStack:
        """For one SPI call of a service session: the session's fault
        plane and timeline, installed for the calling thread only
        (``faults.scoped_plane``, ``timeline.scoped_active``), so that
        module-level sites reach the tenant's own without a process-wide
        install. A standalone manager's are process-wide already: an
        empty stack."""
        stack = contextlib.ExitStack()
        if self._service_mode:
            stack.enter_context(faults.scoped_plane(
                self.faults if self.faults.enabled else None))
            stack.enter_context(scoped_active(self.timeline))
        return stack

    def __enter__(self) -> "ShuffleManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ShuffleManager", "ShuffleHandle", "ShuffleWriter",
           "ShuffleReader", "OutputView"]
