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
- The manager installs its fault plane (``faults.FaultPlane(conf
  .fault_spec)``) process-wide and puts the earlier one back in ``stop``.

The observability stack (the journal span that would carry the retry
count, the timeline, the watchdog) and the tenant scoping of the plane
wait for later slices.
"""

from __future__ import annotations

import dataclasses
import logging
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
from sparkrdma_tpu_torch.hbm.slot_pool import Slot
from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore
from sparkrdma_tpu_torch.kernels.aggregate import OPS
from sparkrdma_tpu_torch.kernels.sort import sort_by_lead_cols
from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore
from sparkrdma_tpu_torch.meta.map_output import MapOutputRegistry
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime
from sparkrdma_tpu_torch.utils.stats import barrier

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
        self._plan = self._m._exchange.plan(
            self._records, self._h.partitioner, self._h.num_parts)
        self._m._registry.publish_map_output(self._h.shuffle_id,
                                             self._plan.counts)
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
        writer = self._m._recover_writer(self._h)
        return self._read_attempts(writer, record_stats)

    def _read_attempts(self, writer: ShuffleWriter, record_stats: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's retry loop: bounded by ``max_retry_attempts``
        and ``retry_deadline_s``, with ``faults.backoff_ms`` sleeps that
        never run past the deadline."""
        conf = self._m.conf
        sid = self._h.shuffle_id
        attempt = 0
        deadline = (time.monotonic() + conf.retry_deadline_s
                    if conf.retry_deadline_s > 0 else None)
        while True:
            attempt += 1
            try:
                try:
                    return self._attempt(writer, record_stats)
                except _DEVICE_ERRORS as e:
                    raise FetchFailedError(
                        sid, f"backend failure during exchange: {e}",
                        attempt) from e
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
                delay_ms = faults.backoff_ms(attempt, conf.retry_backoff_ms)
                if delay_ms > 0:
                    if deadline is not None:
                        delay_ms = min(delay_ms, max(
                            (deadline - time.monotonic()) * 1e3, 0.0))
                    time.sleep(delay_ms / 1e3)
                writer = self._m._recover_writer(self._h)

    def _attempt(self, writer: ShuffleWriter, record_stats: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One attempt: the exchange, a ranged read's filter and tail,
        and the closing sync."""
        m = self._m
        full = self._full_range
        fuse_agg = (self.aggregator or "") if full else ""
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
        if record_stats:
            barrier(out)
        return out, totals

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
        retained view and the base, and the pages go back to the pool."""
        return OutputView(self._m, self._h, *self._raw_read())

    def read_partition(self, partition: int) -> np.ndarray:
        """One partition's records as host rows ``uint32[n, W]`` (small
        data): the per-task view Spark's reader iterator returns."""
        if not self.start_partition <= partition < self.end_partition:
            raise ValueError(
                f"partition {partition} outside reader range "
                f"[{self.start_partition}, {self.end_partition})")
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
                 num_partitions: int = 8, device="cuda"):
        self.runtime = runtime or MeshRuntime(
            conf, num_partitions=num_partitions, device=device)
        self.conf = conf or self.runtime.conf
        self.metrics = MetricsRegistry(enabled=True)
        # the fault plane, process-wide: module-level sites (staging,
        # the checkpoint store) reach it without a handle
        self.faults = faults.FaultPlane(self.conf.fault_spec)
        self._prev_plane = faults.set_active_plane(
            self.faults if self.faults.enabled else None)
        # the node owns the pool, the exchange draws from it
        self.runtime.pool.metrics = self.metrics
        #: checkpoints under ``conf.spill_dir`` (None without it)
        self.store = (MapOutputStore(
            self.conf.spill_dir, use_native=self.conf.use_native_staging,
            compression=self.conf.compression,
            compression_level=self.conf.compression_level)
            if self.conf.spill_dir else None)
        #: the tiered out-of-core store: the pool as its HBM tier, host
        #: leases, disk segments
        self.tiered = TieredStore(self.conf, pool=self.runtime.pool)
        self._exchange = ShuffleExchange(self.runtime, self.conf,
                                         metrics=self.metrics,
                                         pool=self.runtime.pool,
                                         store=self.tiered)
        ids = tuple(self.runtime.manager_id(i)
                    for i in range(self.runtime.num_partitions))
        self._registry = MapOutputRegistry(ids, metrics=self.metrics)
        self._writers: Dict[int, ShuffleWriter] = {}

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

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """Forget the shuffle and return its recycled output buffers to
        the pool: its reads' outputs must be consumed by now. Its tiered
        store segments and its checkpoint go too."""
        self._registry.unregister(shuffle_id)
        self._writers.pop(shuffle_id, None)
        self._exchange.release_shuffle(shuffle_id)
        self.tiered.delete_shuffle(shuffle_id)
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
        later ``get_writer`` displaced it from the manager's table."""
        store = self._require_store()
        if writer is None:
            writer = self._writers.get(handle.shuffle_id)
        if writer is None or writer.records is None or writer.plan is None:
            raise RuntimeError(
                f"shuffle {handle.shuffle_id}: nothing published to "
                "checkpoint")
        store.save(handle.shuffle_id, writer.records.cpu().numpy(),
                   writer.plan, handle.num_parts)

    def resume_shuffle(self, handle: ShuffleHandle) -> ShuffleWriter:
        """Rebuild the writer of a re-registered shuffle (the same
        partitioner: functions are not saved, as a restarted Spark job
        re-creates its lineage) from its checkpoint, whole or sharded,
        on the runtime's device; the map stage is skipped. An unreadable
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
        try:
            if meta.get("sharded"):
                shard = (shape[0], shape[1] // mesh_now)
                records = np.concatenate(
                    [store.read_shard(handle.shuffle_id, c, shard)
                     for c in range(mesh_now)], axis=1)
            else:
                records = store.read_records(handle.shuffle_id, meta)
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
        :meth:`resume_segments`."""
        self._require_store().save_segments(shuffle_id, segments, plan,
                                            num_parts, extra_meta=extra_meta)

    def resume_segments(self, shuffle_id: int) -> List[str]:
        """Adopt a segment checkpoint into the tiered store, only the
        segments missing from it, and without reading them (the
        prefetcher brings them in as they are consumed). Returns the
        adopted keys."""
        meta = self._require_store().load_segment_meta(shuffle_id)
        adopted = []
        for key, entry in meta["segments"].items():
            if self.tiered.contains(key):
                continue
            self.tiered.adopt(key, self.store.segment_path(shuffle_id, entry),
                              entry["shape"], entry["dtype"],
                              shuffle=shuffle_id)
            adopted.append(key)
        return adopted

    # --- ranged reads: per stacked partition, after the exchange -------
    def _filtered(self, out: torch.Tensor, plan: ShufflePlan,
                  num_parts: int, start: int, end: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keep only partitions ``[start, end)``: the kept partitions of
        a stacked partition are adjacent segments of its output, so they
        form one window, moved to the front with the rest zeroed."""
        mesh = self.runtime.num_partitions
        cap = plan.out_capacity
        spans: Dict[int, Tuple[int, int]] = {}
        for p in range(start, end):
            d, st, ln = _partition_windows(plan, mesh, num_parts, p)[0]
            first, total = spans.get(d, (st, 0))
            spans[d] = (first, total + ln)
        res = torch.zeros_like(out)
        totals = torch.zeros(mesh, dtype=torch.int32, device=out.device)
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
        mesh = self.runtime.num_partitions
        cap = plan.out_capacity
        k = plan.split_factor
        rank = torch.full((mesh, cap), _SENTINEL, dtype=torch.int64,
                          device=out.device)
        kept = [0] * mesh
        for p in range(start, end):
            for j, (d, st, ln) in enumerate(
                    _partition_windows(plan, mesh, num_parts, p)):
                rank[d, st:st + ln] = (p - start) * k + j
                kept[d] += ln
        mode = self._exchange.sort_mode(out.shape[0])
        res = torch.zeros_like(out)
        for d in range(mesh):
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
        """Release the pooled buffers and close the store; checkpoints
        stay for a restarted manager to resume."""
        if faults.active_plane() is self.faults:
            faults.set_active_plane(self._prev_plane)
        self._exchange.release_all()
        self._writers.clear()
        self.tiered.close()
        self.runtime.stop()

    def __enter__(self) -> "ShuffleManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ShuffleManager", "ShuffleHandle", "ShuffleWriter",
           "ShuffleReader", "OutputView"]
