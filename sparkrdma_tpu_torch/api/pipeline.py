"""Pipelined host <-> device path for encoded rows.

Counterpart of ``sparkrdma_tpu.api.pipeline``. The host codec
(``api/serde.py``) turns byte payloads or named columns into uint32 rows;
the runtime moves rows to the card. Back to back, the load rate is
``1/(1/encode + 1/copy)``, so large batches go in chunks, as a pipeline:

- **encode side**: a producer thread encodes chunk *k+1* into a lease of
  the process-wide :func:`staging_pool` while chunk *k* is copied to the
  device. The codec is the native one unless ``conf.serde_native`` is
  off (``serde_threads`` threads per call), and the pool is the C pool
  unless ``conf.use_native_staging`` is off. On a CUDA runtime the
  leases are page-locked and the copy is
  ``non_blocking`` on a side stream, with a CUDA event recorded after
  it; a lease goes back to the pool only once its event has completed,
  so the producer never writes into bytes still in flight. A hand-off
  queue of depth 2 bounds the leases in use.
- **decode side**: a worker thread copies partition window *d+1* down
  while window *d* decodes.

PLACEMENT: ``MeshRuntime.shard_records`` gives partition ``d`` the rows
``d*N/D .. (d+1)*N/D``, so each chunk takes the next slice of *every*
partition's range, and the chunks are concatenated per partition on the
device at the end. The result equals the single-shot ``encode ->
shard_records`` layout bit for bit, with overlap on or off. Across
processes each process encodes and stages only its own partitions'
ranges (every process holds the whole host input, as the reference's
caller does), and the loads always take the chunked path.

:class:`HostPrefetcher` is the query planner's background encode of a
deferred source (``plan/executor.py``).

A chunked load records ``serde:encode`` and ``serde:h2d`` begin/end
pairs per chunk (``chunk``, ``rows``), an unload ``serde:d2h`` and
``serde:decode`` pairs per partition window (``device``, ``rows``), on
the active timeline (``obs/timeline.py``), as the reference does: the
next journal span's events show where a load's or an unload's host
time went.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.serde import (_FIXED_KINDS, BytesColumn,
                                           RowSchema, _canon_varlen,
                                           _check_names, _coerce_fixed,
                                           decode_bytes_rows, decode_cols,
                                           encode_bytes_rows, encode_cols,
                                           payload_words)
from sparkrdma_tpu_torch.hbm.host_staging import HostBufferPool
from sparkrdma_tpu_torch.obs.timeline import record_active

#: the reserved all-ones filler key (``api/dataset.py``)
_NULL = np.uint32(0xFFFFFFFF)

#: encode -> copy hand-off depth: chunk k copying, chunk k+1 queued,
#: chunk k+2 being encoded
_QUEUE_DEPTH = 2

_pools: Dict[Tuple[bool, bool], HostBufferPool] = {}  # guarded-by: _pools_lock
_pools_lock = threading.Lock()


def staging_pool(pinned: bool, native: bool = True) -> HostBufferPool:
    """The process-wide chunk staging pool: page-locked (for copies to a
    card) or ordinary host memory, from the C pool (``native``) or numpy.
    Leases recycle across calls."""
    with _pools_lock:
        pool = _pools.get((pinned, native))
        if pool is None:
            pool = _pools[pinned, native] = HostBufferPool(
                pinned=pinned, use_native=native)
        return pool


def _codec_args(conf) -> dict:
    """The conf's codec choice, as the codecs' keyword arguments."""
    return {"native": conf.serde_native,
            "threads": conf.serde_threads or None}


def _chunk_rows(conf, mesh: int, chunk_records: Optional[int]) -> int:
    """Rows per chunk: ``serde_chunk_records`` (or ``chunk_records``)
    rounded down to a multiple of the partition count; 0 disables
    chunking."""
    chunk = conf.serde_chunk_records if chunk_records is None \
        else chunk_records
    if chunk <= 0:
        return 0
    return max(mesh, (chunk // mesh) * mesh)


def _ranges(per: int, lo: int, hi: int, parts) -> list:
    """Rows ``lo:hi`` of each of partitions ``parts``' ranges."""
    return [(d * per + lo, d * per + hi) for d in parts]


class _Loader:
    """Copies encoded chunks to the runtime's device and keeps each
    lease until its copy has landed."""

    def __init__(self, runtime, native: bool):
        self.rt = runtime
        self.cuda = runtime.device.type == "cuda"
        self.pool = staging_pool(pinned=self.cuda, native=native)
        self.stream = (torch.cuda.Stream(device=runtime.device)
                       if self.cuda else None)
        self.chunks: List[torch.Tensor] = []    # columnar [W, c] each
        self._inflight: list = []               # (lease, event)

    def lease(self, rows: int, w: int):
        buf = self.pool.get(rows * w * 4)
        return buf, buf.view(np.uint32, (rows, w))

    def put(self, ci: int, buf, out: np.ndarray, wait: bool) -> None:
        """Copy chunk ``ci``'s rows ``out`` (in lease ``buf``) to the
        device as columns; ``wait`` holds the host until it has landed
        (the overlap-off arm)."""
        c, w = out.shape
        record_active("serde:h2d", ph="B", chunk=ci, rows=c)
        try:
            self._put(buf, out, wait)
        finally:
            record_active("serde:h2d", ph="E", chunk=ci)

    def _put(self, buf, out: np.ndarray, wait: bool) -> None:
        c, w = out.shape
        if not self.cuda:
            self.chunks.append(torch.from_numpy(
                out.view(np.int32)).T.contiguous())
            buf.release()
            return
        src = buf.tensor[:c * w * 4].view(torch.int32).view(c, w)
        with torch.cuda.stream(self.stream):
            dev = torch.empty((c, w), dtype=torch.int32,
                              device=self.rt.device)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
            self.chunks.append(dev.T.contiguous())
        self._inflight.append((buf, ev))
        if wait:
            ev.synchronize()
        while self._inflight and self._inflight[0][1].query():
            self._inflight.pop(0)[0].release()

    def finish(self, mesh: int) -> torch.Tensor:
        """Concatenate every chunk's slice of local partition ``d``, for
        each ``d`` in turn: the single-shot layout."""
        try:
            pieces = []
            for d in range(mesh):
                for ch in self.chunks:
                    cc = ch.shape[1] // mesh
                    pieces.append(ch[:, d * cc:(d + 1) * cc])
            if not self.cuda:
                return torch.cat(pieces, dim=1)
            with torch.cuda.stream(self.stream):
                out = torch.cat(pieces, dim=1)
            cur = torch.cuda.current_stream(self.rt.device)
            cur.wait_stream(self.stream)
            out.record_stream(cur)
            return out
        finally:
            self.release_all()

    def release_all(self) -> None:
        for buf, ev in self._inflight:
            ev.synchronize()
            buf.release()
        self._inflight.clear()


def _pipelined(manager, n: int, w: int, chunk_records: Optional[int],
               overlap: bool, encode_into: Callable, single: Callable
               ) -> torch.Tensor:
    """The loop both loads share. ``encode_into(lo, hi, parts,
    out)`` encodes rows ``lo:hi`` of each of partitions ``parts``'
    ranges into ``out``; ``single()`` is the single-shot rows."""
    rt = manager.runtime
    mesh = rt.num_partitions
    chunk = _chunk_rows(manager.conf, mesh, chunk_records)
    if n == 0 or n % mesh != 0 or (rt.process_count == 1
                                   and (chunk == 0 or n <= chunk)):
        # nothing to overlap (or rows that do not shard evenly, which
        # shard_records refuses as it always has)
        return rt.shard_records(single())
    per = n // mesh
    cc = chunk // mesh if 0 < chunk < n else per
    bounds = [(lo, min(per, lo + cc)) for lo in range(0, per, cc)]
    parts = rt.local_device_indices()
    loader = _Loader(rt, manager.conf.use_native_staging)

    def encode_chunk(ci: int, lo: int, hi: int):
        c = (hi - lo) * len(parts)
        buf, out = loader.lease(c, w)
        try:
            record_active("serde:encode", ph="B", chunk=ci, rows=c)
            encode_into(lo, hi, parts, out)
            record_active("serde:encode", ph="E", chunk=ci)
        except BaseException:
            buf.release()
            raise
        return (ci, buf, out)

    try:
        if not overlap:
            for ci, (lo, hi) in enumerate(bounds):
                loader.put(*encode_chunk(ci, lo, hi), wait=True)
            return loader.finish(len(parts))
        q: Queue = Queue(maxsize=_QUEUE_DEPTH)
        stop = threading.Event()

        def producer():
            try:
                for ci, (lo, hi) in enumerate(bounds):
                    if stop.is_set():
                        return
                    q.put(encode_chunk(ci, lo, hi))
                q.put(None)
            except BaseException as e:  # raised on the consumer side
                q.put(e)

        t = threading.Thread(target=producer, name="serde-encode",
                             daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=30.0)
                except Empty:
                    if not t.is_alive():
                        raise RuntimeError(
                            "serde-encode producer died without a result")
                    continue
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                loader.put(*item, wait=False)
        finally:
            stop.set()
            while t.is_alive():         # unblock a producer at q.put
                try:
                    item = q.get(timeout=0.1)
                except Empty:
                    continue
                if isinstance(item, tuple):
                    item[1].release()
            t.join()
        return loader.finish(len(parts))
    finally:
        loader.release_all()


def _as_keys(keys) -> np.ndarray:
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32))
    return keys[:, None] if keys.ndim == 1 else keys


def encode_rows_to_device(manager, keys: np.ndarray, payloads: Sequence,
                          max_payload_bytes: int, *,
                          chunk_records: Optional[int] = None,
                          overlap: bool = True) -> torch.Tensor:
    """Encode byte payloads into v1 rows and load them onto the
    runtime's device, the host encode overlapped with the copy. Returns
    the columnar batch ``int32[W, N]``, the tensor
    ``runtime.shard_records(encode_bytes_rows(...))`` gives."""
    keys = _as_keys(keys)
    n = keys.shape[0]
    if len(payloads) != n:
        raise ValueError(f"{n} keys but {len(payloads)} payloads")
    per = n // manager.runtime.num_partitions
    w = keys.shape[1] + payload_words(max_payload_bytes)
    codec = _codec_args(manager.conf)

    def encode_into(lo, hi, parts, out):
        ranges = _ranges(per, lo, hi, parts)
        ck = np.concatenate([keys[a:b] for a, b in ranges])
        cp: list = []
        for a, b in ranges:
            cp.extend(payloads[a:b])
        encode_bytes_rows(ck, cp, max_payload_bytes, out=out, **codec)

    return _pipelined(
        manager, n, w, chunk_records, overlap, encode_into,
        lambda: encode_bytes_rows(keys, payloads, max_payload_bytes,
                                  **codec))


def encode_cols_to_device(manager, keys: np.ndarray, columns,
                          schema: RowSchema, *,
                          chunk_records: Optional[int] = None,
                          overlap: bool = True) -> torch.Tensor:
    """Schema-aware :func:`encode_rows_to_device`: named columns under
    ``schema``, each chunk gathered by array slicing (columns are
    canonicalized once), placement equal to the single-shot
    ``encode_cols -> shard_records`` path."""
    keys = _as_keys(keys)
    n = keys.shape[0]
    _check_names(schema, columns)
    fixed = [(fname, _coerce_fixed(fname, fkind, columns[fname], n))
             for fname, fkind, _ in schema.fixed]
    canon = dict(fixed)
    offsets = heap = None
    if schema.var_name is not None:
        offsets, heap = _canon_varlen(columns[schema.var_name], n)
        canon[schema.var_name] = BytesColumn(offsets, heap)
    per = n // manager.runtime.num_partitions
    codec = _codec_args(manager.conf)

    def encode_into(lo, hi, parts, out):
        ranges = _ranges(per, lo, hi, parts)
        cols = {fname: np.concatenate([arr[a:b] for a, b in ranges])
                for fname, arr in fixed}
        if schema.var_name is not None:
            lens = np.concatenate([np.diff(offsets[a:b + 1])
                                   for a, b in ranges])
            coff = np.zeros(lens.size + 1, dtype=np.int64)
            np.cumsum(lens, out=coff[1:])
            parts = [heap[int(offsets[a]):int(offsets[b])]
                     for a, b in ranges]
            cols[schema.var_name] = BytesColumn(
                coff, np.concatenate(parts) if int(coff[-1])
                else np.zeros(0, np.uint8))
        ck = np.concatenate([keys[a:b] for a, b in ranges])
        encode_cols(ck, cols, schema, out=out, **codec)

    return _pipelined(
        manager, n, keys.shape[1] + schema.payload_words, chunk_records,
        overlap, encode_into,
        lambda: encode_cols(keys, canon, schema, **codec))


def _unload(manager, records: torch.Tensor, totals, overlap: bool,
            decode: Callable) -> list:
    """Each partition's valid rows, filler dropped, through ``decode``,
    in partition order; window d+1 is copied down on a worker thread
    while window d decodes."""
    kw = manager.conf.key_words
    mesh = manager.runtime.local_partitions
    cap = records.shape[1] // mesh
    if cap == 0:
        return []
    tot = np.asarray(totals.cpu() if isinstance(totals, torch.Tensor)
                     else totals).tolist()

    def fetch(d: int) -> np.ndarray:
        record_active("serde:d2h", ph="B", device=d)
        win = records[:, d * cap:d * cap + int(tot[d])]
        rows = win.T.contiguous().cpu().numpy().view(np.uint32)
        record_active("serde:d2h", ph="E", device=d)
        return rows

    def run(d: int, rows: np.ndarray):
        if rows.size:
            filler = (rows[:, :kw] == _NULL).all(axis=1)
            if filler.any():
                rows = rows[~filler]
        record_active("serde:decode", ph="B", device=d,
                      rows=int(rows.shape[0]))
        part = decode(rows)
        record_active("serde:decode", ph="E", device=d)
        return part

    if not overlap or mesh == 1:
        return [run(d, fetch(d)) for d in range(mesh)]
    parts = []
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="serde-d2h") as ex:
        nxt = ex.submit(fetch, 0)
        for d in range(mesh):
            rows = nxt.result()
            if d + 1 < mesh:
                nxt = ex.submit(fetch, d + 1)
            parts.append(run(d, rows))
    return parts


def decode_rows_from_device(manager, records: torch.Tensor, totals, *,
                            overlap: bool = True
                            ) -> Tuple[np.ndarray, List[bytes]]:
    """Columnar batch -> host ``(keys uint32[N, kw], payloads)``, the
    reserved all-ones filler rows dropped (as ``Dataset.to_host_rows``
    drops them), partitions in order."""
    kw = manager.conf.key_words
    codec = _codec_args(manager.conf)
    parts = _unload(manager, records, totals, overlap,
                    lambda rows: decode_bytes_rows(rows, kw, **codec))
    if not parts:
        return np.empty((0, kw), np.uint32), []
    payloads: List[bytes] = []
    for _, p in parts:
        payloads.extend(p)
    return np.concatenate([k for k, _ in parts]), payloads


def _merge_col_parts(schema: RowSchema, parts: List[dict]) -> dict:
    """Per-partition column dicts concatenated in order (one part passes
    through as it is, keeping its views)."""
    if len(parts) == 1:
        return parts[0]
    cols: dict = {}
    for fname, _, _ in schema.fixed:
        cols[fname] = np.concatenate([p[fname] for p in parts])
    if schema.var_name is not None:
        bcs = [p[schema.var_name] for p in parts]
        lens = np.concatenate([np.diff(bc.offsets) for bc in bcs])
        offsets = np.zeros(lens.size + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        heaps = [bc.heap[int(bc.offsets[0]):int(bc.offsets[-1])]
                 for bc in bcs]
        cols[schema.var_name] = BytesColumn(
            offsets, np.concatenate(heaps) if int(offsets[-1])
            else np.zeros(0, np.uint8))
    return cols


def decode_cols_from_device(manager, records: torch.Tensor, totals,
                            schema: RowSchema, *, overlap: bool = True
                            ) -> Tuple[np.ndarray, dict]:
    """Schema-aware :func:`decode_rows_from_device`: ``(keys, {name:
    column})``, fixed columns as numpy views over each partition's
    fetched window."""
    kw = manager.conf.key_words
    codec = _codec_args(manager.conf)
    parts = _unload(manager, records, totals, overlap,
                    lambda rows: decode_cols(rows, kw, schema, **codec))
    if not parts:
        cols = {fname: np.zeros(0, _FIXED_KINDS[fkind][1])
                for fname, fkind, _ in schema.fixed}
        if schema.var_name is not None:
            cols[schema.var_name] = BytesColumn(
                np.zeros(1, np.int64), np.zeros(0, np.uint8))
        return np.empty((0, kw), np.uint32), cols
    keys = parts[0][0] if len(parts) == 1 else \
        np.concatenate([k for k, _ in parts])
    return keys, _merge_col_parts(schema, [c for _, c in parts])


class HostPrefetcher:
    """One background worker for deferred host -> device encodes.

    The planner's stage-overlap rewrite runs a deferred source's
    ``Dataset.from_host_rows`` here while an earlier stage's exchanges
    run. Keyed futures; an exception (or the 30 s watchdog's
    TimeoutError) surfaces at :meth:`take`. Callers :meth:`drain` at run
    boundaries so an aborted run's futures never reach a later one."""

    _TIMEOUT_S = 30.0

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futs: dict = {}

    def submit(self, key, fn) -> None:
        """Run ``fn()`` on the worker under ``key`` (a key already in
        flight is left alone)."""
        if key in self._futs:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="plan-prefetch")
        self._futs[key] = self._pool.submit(fn)

    def take(self, key):
        """``key``'s result (None if never submitted); raises what
        ``fn`` raised, or TimeoutError past the watchdog."""
        fut = self._futs.pop(key, None)
        if fut is None:
            return None
        return fut.result(timeout=self._TIMEOUT_S)

    def drain(self) -> None:
        """Drop every outstanding future (a run boundary): encodes not
        yet started are cancelled, a running one finishes unread."""
        for fut in self._futs.values():
            fut.cancel()
        self._futs.clear()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._futs.clear()


__all__ = ["encode_rows_to_device", "decode_rows_from_device",
           "encode_cols_to_device", "decode_cols_from_device",
           "staging_pool", "HostPrefetcher"]
