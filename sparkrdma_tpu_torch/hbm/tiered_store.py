"""Tiered out-of-core segment store: HBM slots -> host leases -> disk.

Counterpart of ``sparkrdma_tpu.hbm.tiered_store``:

- **HBM tier** — the runtime's :class:`~sparkrdma_tpu_torch.hbm.slot_pool
  .SlotPool`; the exchange acquires its round buffers through
  ``acquire_device``/``release_device``, and each acquisition pokes the
  writer, so eviction overlaps the exchange;
- **host tier** — segments staged in :class:`~sparkrdma_tpu_torch.hbm
  .host_staging.HostBufferPool` leases (pageable host memory; the C pool
  unless ``ShuffleConf.use_native_staging`` is off, which also picks the
  native or numpy file writes and reads), bounded by
  ``ShuffleConf.spill_tier_host_bytes``;
- **disk tier** — CRC32-trailed segment files under ``spill_tier_dir``
  (else ``spill_dir``), in the reference's byte layout.

Host<->disk traffic runs on two daemon threads, which touch only numpy
views of leases: a **writer** that evicts least-recently-used unpinned
segments while host occupancy is over the watermark, and a
**prefetcher** that promotes disk segments ahead of the consumer. A
``get`` of a disk segment with no promotion in flight is a synchronous
fetch (``store.sync_fetches``). Disk reads verify the CRC trailer with
up to ``spill_tier_reread_attempts`` reads; a mismatch overcome is the
fault plane's ``spill_reread`` recovery (``faults.note_recovery``, which
counts ``recover.spill_reread``), a persistent one raises OSError.
Counters and gauges live in the process-wide registry
(``obs/metrics.py``).

The threads start with the first ``put``, ``adopt``, ``prefetch`` or
``drain``: a manager that never stages a segment runs none.

The store records ``spill:write`` (a demotion to disk), ``spill:fetch``
(``sync=True``: a ``get`` blocked on disk) and ``spill:promote`` (a
prefetched promotion) on the active timeline (``obs/timeline.py
record_active``), as the reference does.

Tenant accounts (the service's ``service/tenant.py``), as in the
reference: ``register_account(tenant, account)`` meters the segments
tagged with that tenant. A ``put`` charges host bytes first, blocking
while the tenant is over its host quota (each wait slice asks the writer
to demote one of that tenant's own least-recently-used segments); an
``adopt`` charges disk bytes; a demotion moves the charge from host to
disk and is skipped for a tenant at its disk quota; a promotion moves it
back only if the tenant has host headroom (else the segment stays on
disk); every way a segment leaves the store returns its charge.
``delete_tenant`` drops the tenant's segments and detaches its account.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.hbm.host_staging import (HostBuffer, HostBufferPool,
                                                  read_array, write_array)
from sparkrdma_tpu_torch.obs.metrics import global_registry
from sparkrdma_tpu_torch.obs.timeline import record_active


def store_totals() -> Tuple[int, int, int, int]:
    """Process-cumulative ``(spill_bytes, fetch_bytes, prefetch_hits,
    sync_fetches)``; a run's share is the difference of two readings."""
    reg = global_registry()
    return (int(reg.counter("store.spill_bytes").value),
            int(reg.counter("store.fetch_bytes").value),
            int(reg.counter("store.prefetch_hits").value),
            int(reg.counter("store.sync_fetches").value))


class _Segment:
    """Book-keeping for one stored segment (guarded by the store lock)."""

    __slots__ = ("key", "shape", "dtype", "nbytes", "tier", "pinned",
                 "tick", "lease", "path", "promoted", "wanted", "event",
                 "error", "tenant", "shuffle")

    def __init__(self, key: str, shape, dtype, nbytes: int,
                 tenant: str = "", shuffle: Optional[int] = None):
        self.key = key
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.nbytes = nbytes
        self.tier = "host"            # "host" | "disk"
        self.pinned = False
        self.tick = 0
        self.lease: Optional[HostBuffer] = None
        self.path: Optional[str] = None
        #: a promotion is (or was) in flight for this segment
        self.promoted = False
        #: a consumer prefetched this host-resident segment: it is about
        #: to be read, so eviction must not demote it
        self.wanted = False
        self.event: Optional[threading.Event] = None
        self.error: Optional[OSError] = None
        self.tenant = tenant
        self.shuffle = shuffle


class TieredStore:
    """Watermark-evicting, prefetching HBM/host/disk segment store."""

    def __init__(self, conf: Optional[ShuffleConf] = None, pool=None):
        conf = conf or ShuffleConf()
        self.conf = conf
        self.pool = pool                     # HBM tier (SlotPool), optional
        self.root = conf.spill_tier_dir or conf.spill_dir
        self._spill_codec = conf.serde_schema_spill_codec
        self._spill_level = conf.serde_schema_spill_level
        self._watermark = conf.spill_tier_host_bytes
        self._prefetch_depth = conf.spill_tier_prefetch
        self._reread_attempts = conf.spill_tier_reread_attempts
        self._use_native = conf.use_native_staging
        # pageable: segments reach the card through a copy made by
        # ``get`` (the input streamer stages it in its own page-locked pool)
        self.host_pool = HostBufferPool(use_native=self._use_native)
        self._segments: Dict[str, _Segment] = {}    # guarded-by: _lock
        #: tenant name -> TenantAccount (the service's wiring)
        self._accounts: Dict[str, object] = {}      # guarded-by: _lock
        self._lock = threading.Lock()
        self._tick = 0                       # guarded-by: _lock
        self._host_bytes = 0                 # guarded-by: _lock
        self._disk_bytes = 0                 # guarded-by: _lock
        self._closed = False                 # guarded-by: _lock
        # writer: pokes -> evict down to the watermark; prefetcher: keys
        # -> disk->host promotions
        self._wq: "queue.Queue" = queue.Queue()
        self._pq: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []  # guarded-by: _lock

    def _start(self) -> bool:
        """Start the writer and prefetcher threads, once; False when the
        store is closed."""
        with self._lock:
            if self._threads or self._closed:
                return not self._closed
            self._threads = [
                threading.Thread(target=self._writer_loop, daemon=True,
                                 name="tiered-store-writer"),
                threading.Thread(target=self._prefetch_loop, daemon=True,
                                 name="tiered-store-prefetch")]
            for t in self._threads:
                t.start()
            return True

    # ------------------------------------------------------------------
    # HBM tier: delegates, so the exchange acquires round buffers through
    # the store without changing the pool's discipline
    # ------------------------------------------------------------------
    def acquire_device(self, shape, account=None):
        """An ``int32`` device buffer from the HBM tier
        (``SlotPool.get_shaped``, charged to ``account``); each
        acquisition also pokes the writer."""
        self.service()
        return self.pool.get_shaped(shape, account=account)

    def release_device(self, arr, account=None) -> None:
        # a standalone caller passes no account, and the pool is called
        # as before the accounts existed (a pool subclass may not take one)
        if account is None:
            self.pool.put_shaped(arr)
        else:
            self.pool.put_shaped(arr, account=account)

    def register_account(self, tenant: str, account) -> None:
        """Meter ``tenant``'s host and disk holdings against ``account``
        (a ``TenantAccount``). Segments of a tenant with no account are
        tagged but not metered."""
        if not tenant:
            raise ValueError("tenant name must be non-empty")
        with self._lock:
            self._accounts[tenant] = account

    def _account(self, tenant: str):
        if not tenant:
            return None
        with self._lock:
            return self._accounts.get(tenant)

    def service(self) -> None:
        """Non-blocking poke: wake the writer if host occupancy is over
        the watermark."""
        with self._lock:
            over = self._host_bytes > self._watermark and not self._closed
        if over:
            self._wq.put("evict")

    # ------------------------------------------------------------------
    # host tier
    # ------------------------------------------------------------------
    def put(self, key: str, arr: np.ndarray, pin: bool = False,
            tenant: str = "", shuffle: Optional[int] = None) -> None:
        """Stage ``arr`` (copied into a pooled host lease) under ``key``.
        The put always lands in the host tier; the writer then evicts
        least-recently-used segments until occupancy is back under the
        watermark. A metered ``tenant`` is charged the host bytes first
        (module docstring), with no store lock held."""
        self._start()
        arr = np.asarray(arr)
        acct = self._account(tenant)
        if acct is not None:
            acct.charge("host", arr.nbytes,
                        poke=lambda: self._wq.put(("tenant", tenant)))
        seg = _Segment(key, arr.shape, arr.dtype, arr.nbytes,
                       tenant=tenant, shuffle=shuffle)
        lease = None
        try:
            lease = self.host_pool.get(arr.nbytes)
            lease.view(arr.dtype, arr.shape)[...] = arr
        except BaseException:
            # a charge for bytes that never landed goes back
            if lease is not None:
                lease.release()
            if acct is not None:
                acct.release("host", arr.nbytes)
            raise
        seg.lease = lease
        old = None
        old_ev, defer_old, closed, over = None, False, False, False
        with self._lock:
            if self._closed:
                closed = True
            else:
                old = self._segments.pop(key, None)
                if old is not None:
                    old_ev, defer_old = self._drop_locked(old)
                self._tick += 1
                seg.tick = self._tick
                seg.pinned = pin
                self._segments[key] = seg
                self._host_bytes += seg.nbytes
                over = self._host_bytes > self._watermark
        if closed:
            lease.release()
            if acct is not None:
                acct.release("host", arr.nbytes)
            raise RuntimeError("TieredStore is closed")
        if old_ev is not None:
            old_ev.set()
        if old is not None and not defer_old:
            self._discard(old)
        reg = global_registry()
        reg.counter("store.puts").inc()
        reg.counter("store.put_bytes").inc(arr.nbytes)
        self._set_gauges()
        if over:
            self._wq.put("evict")

    def get(self, key: str) -> np.ndarray:
        """The segment's records (a copy, safe across later evictions).

        A host-resident segment returns at once; a disk segment with a
        promotion in flight waits for it (a prefetch hit); a disk segment
        with none is read synchronously (a sync fetch)."""
        with self._lock:
            seg = self._segments.get(key)
            if seg is None:
                raise KeyError(f"no segment {key!r} in store")
            self._tick += 1
            seg.tick = self._tick
            seg.wanted = False
            tier = seg.tier
            ev = seg.event
            if tier == "host":
                hit = seg.promoted
                seg.promoted = False
                # copy under the lock: eviction may release the lease
                # the moment it is let go
                data = np.array(seg.lease.view(seg.dtype, seg.shape))
        if tier == "host":
            if hit:
                global_registry().counter("store.prefetch_hits").inc()
            return data
        if ev is not None:
            # promotion in flight: ride it
            ev.wait()
            with self._lock:
                seg = self._segments.get(key)
                if seg is None:
                    raise KeyError(f"segment {key!r} deleted mid-promote")
                if seg.error is not None:
                    raise seg.error
                if seg.tier == "host":
                    seg.promoted = False
                    data = np.array(seg.lease.view(seg.dtype, seg.shape))
                else:
                    data = None
            if data is not None:
                global_registry().counter("store.prefetch_hits").inc()
                return data
        # synchronous fetch: the consumer is blocked on disk right now
        global_registry().counter("store.sync_fetches").inc()
        record_active("spill:fetch", key=key, sync=True)
        data = self._read_segment(seg)
        self._promote_install(key, data)
        return data

    def prefetch(self, keys: Iterable[str]) -> None:
        """Queue disk->host promotions for ``keys``, at most
        ``spill_tier_prefetch`` queued at once (the rest are dropped and
        fetch synchronously later)."""
        if self._prefetch_depth <= 0:
            return
        self._start()
        budget = self._prefetch_depth - self._pq.qsize()
        for key in keys:
            if budget <= 0:
                return
            with self._lock:
                seg = self._segments.get(key)
                if seg is None:
                    continue
                if seg.tier == "host":
                    # resident (maybe mid-eviction): keep it from being
                    # demoted before the imminent get
                    seg.wanted = True
                    continue
                if seg.event is not None:
                    continue
                seg.event = threading.Event()
            self._pq.put(key)
            budget -= 1

    def pin(self, key: str) -> None:
        with self._lock:
            self._segments[key].pinned = True

    def unpin(self, key: str) -> None:
        with self._lock:
            self._segments[key].pinned = False

    # ------------------------------------------------------------------
    # disk tier
    # ------------------------------------------------------------------
    def adopt(self, key: str, path: str, shape, dtype,
              tenant: str = "", shuffle: Optional[int] = None) -> None:
        """Register an existing on-disk file (e.g. a checkpoint segment)
        as a disk-tier segment; nothing is read until a get or prefetch.
        A metered ``tenant`` is charged the disk bytes first."""
        self._start()
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        acct = self._account(tenant)
        if acct is not None:
            acct.charge("disk", nbytes)
        seg = _Segment(key, shape, dtype, nbytes,
                       tenant=tenant, shuffle=shuffle)
        seg.tier = "disk"
        seg.path = path
        old = None
        old_ev, defer_old, closed = None, False, False
        with self._lock:
            if self._closed:
                closed = True
            else:
                old = self._segments.pop(key, None)
                if old is not None:
                    old_ev, defer_old = self._drop_locked(old)
                self._tick += 1
                seg.tick = self._tick
                self._segments[key] = seg
                self._disk_bytes += nbytes
        if closed:
            if acct is not None:
                acct.release("disk", nbytes)
            raise RuntimeError("TieredStore is closed")
        if old_ev is not None:
            old_ev.set()
        if old is not None and not defer_old:
            self._discard(old)
        self._set_gauges()

    def _segment_path(self, key: str) -> str:
        if not self.root:
            raise OSError(
                f"cannot evict segment {key!r}: no disk tier configured "
                "(set ShuffleConf.spill_tier_dir or spill_dir)")
        os.makedirs(self.root, exist_ok=True)
        safe = key.replace(os.sep, "_").replace("/", "_")
        return os.path.join(self.root, f"{safe}.seg")

    def _read_segment(self, seg: _Segment) -> np.ndarray:
        """CRC-verified disk read with bounded re-reads on mismatch."""
        reg = global_registry()
        last: Optional[OSError] = None
        for attempt in range(self._reread_attempts):
            try:
                data = read_array(seg.path, seg.dtype, seg.shape,
                                  use_native=self._use_native)
            except OSError as e:
                last = e
                if attempt < self._reread_attempts - 1:
                    reg.counter("store.crc_rereads").inc()
                continue
            if attempt > 0:
                faults.note_recovery("spill_reread")
            reg.counter("store.fetches").inc()
            reg.counter("store.fetch_bytes").inc(seg.nbytes)
            return data
        raise OSError(
            f"segment {seg.key!r} unreadable after "
            f"{self._reread_attempts} attempts: {last}") from last

    def _promote_install(self, key: str, data: np.ndarray) -> bool:
        """Install freshly read bytes as the segment's host residence;
        True iff installed (False when it raced a delete or another read,
        or when its tenant has no host headroom: a promotion never waits
        on a quota, the data was read for the caller already)."""
        with self._lock:
            seg = self._segments.get(key)
            if seg is None or seg.tier == "host":
                return False
            acct = self._accounts.get(seg.tenant) if seg.tenant else None
        if acct is not None and not acct.try_charge("host", seg.nbytes):
            return False
        lease = None
        try:
            lease = self.host_pool.get(data.nbytes)
            lease.view(data.dtype, data.shape)[...] = data
        except BaseException:
            if lease is not None:
                lease.release()
            if acct is not None:
                acct.release("host", seg.nbytes)
            raise
        over = False
        with self._lock:
            cur = self._segments.get(key)
            stale = cur is not seg or seg.tier == "host"
            if not stale:
                seg.tier = "host"
                seg.lease = lease
                # freshly promoted = about to be consumed: most recent,
                # so the writer does not evict it straight back
                self._tick += 1
                seg.tick = self._tick
                self._host_bytes += seg.nbytes
                self._disk_bytes -= seg.nbytes
                over = self._host_bytes > self._watermark
        if stale:
            lease.release()
            if acct is not None:
                acct.release("host", seg.nbytes)
            return False
        if acct is not None:
            # the bytes moved disk -> host: the disk charge goes back
            acct.release("disk", seg.nbytes)
        self._set_gauges()
        if over:
            self._wq.put("evict")
        return True

    # ------------------------------------------------------------------
    # background threads
    # ------------------------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            try:
                # bounded wait: the closed flag is the durable exit signal
                item = self._wq.get(timeout=1.0)
            except queue.Empty:
                with self._lock:
                    if self._closed:
                        return
                continue
            if item is None:
                self._wq.task_done()
                return
            try:
                if isinstance(item, tuple) and item[0] == "tenant":
                    # a quota-blocked put: demote one of that tenant's
                    # own segments, never another tenant's
                    self._evict_one(set(), tenant=item[1])
                else:
                    # victims skipped for their tenant's disk quota stay
                    # skipped for the rest of this sweep
                    skip: set = set()
                    while self._evict_one(skip):
                        pass
            finally:
                self._wq.task_done()

    def _evict_one(self, skip: set, tenant: Optional[str] = None) -> bool:
        """Demote the least-recently-used unpinned host segment (of
        ``tenant`` when given, regardless of the watermark; else while
        occupancy is over it) to disk. True when the sweep should go
        on."""
        acct = None
        with self._lock:
            if self._closed or (tenant is None
                                and self._host_bytes <= self._watermark):
                return False
            victims = [s for s in self._segments.values()
                       if s.tier == "host" and not s.pinned
                       and not s.wanted and s.key not in skip
                       and (tenant is None or s.tenant == tenant)]
            if not victims:
                return False
            seg = min(victims, key=lambda s: s.tick)
            tick = seg.tick
            if seg.tenant:
                acct = self._accounts.get(seg.tenant)
            # the demotion moves the bytes into the owner's disk budget;
            # an owner with no disk headroom keeps the segment on the host
            # (the writer never waits on a quota)
            if acct is not None and not acct.try_charge("disk", seg.nbytes):
                skip.add(seg.key)
                return True
            # in flight: a concurrent get keeps reading the valid lease,
            # and a drop defers the lease's release to this thread
            seg.pinned = True
        try:
            path = self._segment_path(seg.key)
            write_array(path, seg.lease.view(seg.dtype, seg.shape),
                        use_native=self._use_native,
                        codec=self._spill_codec, level=self._spill_level,
                        pool=self.host_pool)
        except OSError:
            # disk refused (no tier configured / full): the segment stays
            # host-resident; data is never dropped — unless a put or
            # delete dropped it meanwhile, deferring its lease to us
            with self._lock:
                seg.pinned = False
                gone = self._segments.get(seg.key) is not seg
                lease = seg.lease if gone else None
                if gone:
                    seg.lease = None
            if acct is not None:
                acct.release("disk", seg.nbytes)
            if lease is not None:
                lease.release()
            return False
        orphan = None
        demoted = False
        with self._lock:
            still = self._segments.get(seg.key) is seg
            if still and (seg.wanted or seg.tick != tick):
                # a prefetch claimed it or a get read it mid-write: it is
                # no longer the least recently used, so it stays on the
                # host and the file just written is an orphan
                seg.pinned = False
                lease = None
                orphan = path
            elif still:
                seg.pinned = False
                seg.tier = "disk"
                seg.path = path
                lease, seg.lease = seg.lease, None
                self._host_bytes -= seg.nbytes
                self._disk_bytes += seg.nbytes
                demoted = True
            else:
                # replaced or deleted mid-write: the dropper deferred the
                # lease to us, and the file holds stale data
                lease, seg.lease = seg.lease, None
                orphan = path
        if lease is not None:
            lease.release()
        if acct is not None:
            # demoted: the host charge goes back (the disk one stays);
            # not demoted: the speculative disk charge goes back (a drop
            # meanwhile returned the host charge already)
            acct.release("host" if demoted else "disk", seg.nbytes)
        if orphan is not None:
            try:
                os.remove(orphan)
            except OSError:
                pass
            return True
        if demoted:
            reg = global_registry()
            reg.counter("store.spill_writes").inc()
            reg.counter("store.spill_bytes").inc(seg.nbytes)
            if self._spill_codec:
                reg.counter("store.compressed_segments").inc()
            record_active("spill:write", key=seg.key, bytes=seg.nbytes)
            self._set_gauges()
        return True

    def _prefetch_loop(self) -> None:
        while True:
            try:
                key = self._pq.get(timeout=1.0)
            except queue.Empty:
                with self._lock:
                    if self._closed:
                        return
                continue
            if key is None:
                self._pq.task_done()
                return
            try:
                self._promote(key)
            finally:
                self._pq.task_done()

    def _promote(self, key: str) -> None:
        """The prefetcher's read of one disk segment into the host tier;
        sets the segment's event whatever happens."""
        with self._lock:
            seg = self._segments.get(key)
            ev = seg.event if seg is not None else None
        if ev is None:
            return
        if seg.tier == "disk":
            try:
                data = self._read_segment(seg)
            except OSError as e:
                with self._lock:
                    seg.error = e
                    seg.event = None
                ev.set()
                return
            if self._promote_install(key, data):
                with self._lock:
                    if self._segments.get(key) is seg:
                        seg.promoted = True
                record_active("spill:promote", key=key, bytes=seg.nbytes)
        with self._lock:
            seg.event = None
        ev.set()

    # ------------------------------------------------------------------
    # inventory
    # ------------------------------------------------------------------
    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._segments

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._segments)

    def tier_of(self, key: str) -> str:
        with self._lock:
            return self._segments[key].tier

    def occupancy(self) -> Dict[str, int]:
        """Per-tier occupancy snapshot."""
        with self._lock:
            host_n = sum(1 for s in self._segments.values()
                         if s.tier == "host")
            return {
                "host_bytes": self._host_bytes,
                "disk_bytes": self._disk_bytes,
                "host_segments": host_n,
                "disk_segments": len(self._segments) - host_n,
                "hbm_outstanding": (self.pool.outstanding
                                    if self.pool is not None else 0),
            }

    def occupancy_by_tenant(self) -> Dict[str, Dict[str, int]]:
        """Tenant tag -> host/disk bytes (``""``: untagged segments)."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for s in self._segments.values():
                cell = out.setdefault(
                    s.tenant, {"host_bytes": 0, "disk_bytes": 0})
                cell["host_bytes" if s.tier == "host"
                     else "disk_bytes"] += s.nbytes
        return out

    def delete(self, key: str) -> None:
        with self._lock:
            seg = self._segments.pop(key, None)
            if seg is None:
                return
            ev, defer = self._drop_locked(seg)
        if ev is not None:
            ev.set()
        if not defer:
            self._discard(seg)
        self._set_gauges()

    def delete_shuffle(self, shuffle_id: int, tenant: str = "") -> None:
        """Drop every segment tagged with ``shuffle_id`` (and ``tenant``,
        if given): host leases returned, store-owned files removed."""
        with self._lock:
            keys = [k for k, s in self._segments.items()
                    if s.shuffle == shuffle_id
                    and (not tenant or s.tenant == tenant)]
        for key in keys:
            self.delete(key)

    def delete_tenant(self, tenant: str) -> None:
        """Drop every segment tagged with ``tenant`` and detach its account
        (a service session's teardown: its charges here return to 0)."""
        if not tenant:
            return
        with self._lock:
            keys = [k for k, s in self._segments.items()
                    if s.tenant == tenant]
        for key in keys:
            self.delete(key)
        with self._lock:
            self._accounts.pop(tenant, None)

    def _drop_locked(self, seg: _Segment):
        """Detach ``seg`` as it leaves ``_segments`` (caller holds
        ``_lock``), returning its tier bytes and its tenant's charge.
        Returns ``(event, defer)``: the promotion event to
        set once the lock is released (a ``get`` riding it would park
        forever otherwise), and whether the lease's release is deferred
        to the writer, which is reading it outside the lock."""
        if seg.tier == "host":
            self._host_bytes -= seg.nbytes
        else:
            self._disk_bytes -= seg.nbytes
        if seg.tenant:
            acct = self._accounts.get(seg.tenant)
            if acct is not None:
                # the account's lock is a leaf: its non-blocking release
                # is safe under the store's lock
                acct.release("host" if seg.tier == "host" else "disk",
                             seg.nbytes)
        ev, seg.event = seg.event, None
        defer = seg.pinned and seg.tier == "host" and seg.lease is not None
        return ev, defer

    def _discard(self, seg: _Segment) -> None:
        if seg.lease is not None:
            seg.lease.release()
            seg.lease = None
        if seg.path is not None and seg.path.endswith(".seg"):
            # store-owned files only; adopted checkpoint files stay
            try:
                os.remove(seg.path)
            except OSError:
                pass

    def _set_gauges(self) -> None:
        with self._lock:
            host_bytes, disk_bytes = self._host_bytes, self._disk_bytes
        reg = global_registry()
        reg.gauge("store.host_bytes").set(host_bytes)
        reg.gauge("store.disk_bytes").set(disk_bytes)

    def drain(self) -> None:
        """Block until every queued eviction and prefetch is done (after
        which host occupancy is under the watermark, or only pinned or
        wanted segments remain over it)."""
        if not self._start():
            return
        self._wq.put("evict")
        self._wq.join()
        self._pq.join()

    def close(self, delete_disk: bool = False) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            segs = list(self._segments.values())
            self._segments.clear()
            dropped = [self._drop_locked(s) for s in segs]
            threads = list(self._threads)
        for ev, _defer in dropped:
            if ev is not None:
                ev.set()
        for q in (self._wq, self._pq):
            q.put(None)
        for t in threads:
            t.join(timeout=10)
        for seg, (_ev, defer) in zip(segs, dropped):
            if seg.lease is not None and not defer:
                seg.lease.release()
                seg.lease = None
            if delete_disk and seg.path is not None \
                    and seg.path.endswith(".seg"):
                try:
                    os.remove(seg.path)
                except OSError:
                    pass
        self.host_pool.close()


__all__ = ["TieredStore", "store_totals"]
