"""Host staging: a size-classed host buffer pool and pipelined spill.

The storage subset of ``sparkrdma_tpu.hbm.host_staging``:

- the file format: an optional codec header (``compress_array`` /
  ``decompress_blob``) and a CRC32 trailer appended to the byte stream
  before the write (``crc_frame`` / ``crc_frame_into`` / ``verify_crc``),
  so every file written here is byte-identical to the reference's and
  each package reads the other's;
- :class:`HostBufferPool` — power-of-two size-classed host buffers
  (``RdmaBufferManager.get/put``). A pool made with ``pinned=True``
  allocates page-locked torch tensors, which an asynchronous copy to the
  card needs; a pool made without it allocates ordinary numpy memory.
  A lease is never freed,
  only returned to its class's free stack, so page-locking is a one-time
  cost per buffer;
- :class:`SpillWriter` — a bounded queue and one writer thread persist
  arrays while the caller goes on;
- :func:`write_array` / :func:`read_array` — one array, synchronously.

The fault plane's storage sites fire here (``faults.py``):
``spill.write`` in ``write_array`` and ``SpillWriter.submit`` (an
injected failure is retried once in place and counted as the
``spill_rewrite`` recovery; ``corrupt`` flips a bit of the payload after
its CRC is taken) and ``spill.read`` in ``read_array`` (``fail`` raises
``OSError``; ``corrupt`` flips a bit of the payload before the CRC
check).

Not ported: ``native/staging.cpp`` (the C++ pool, spooler and serde
codecs) — the numpy path writes the same bytes — and the timeline
events.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.obs.metrics import global_registry


def _count_spill(nbytes: int) -> None:
    """One host-staging spill, in the process-wide registry."""
    reg = global_registry()
    reg.counter("staging.spills").inc()
    reg.counter("staging.spill_bytes").inc(nbytes)


def spill_count() -> int:
    """Cumulative process-wide spill submissions."""
    return int(global_registry().counter("staging.spills").value)


_CODEC_MAGIC = b"SRZC"
_CODEC_IDS = {"zlib": 1, "lzma": 2}
_HDR = struct.Struct("<4sBQ")        # magic, codec id, raw nbytes

_CRC_MAGIC = b"SRC1"
_CRC_TRAILER = struct.Struct("<4sI")  # magic, crc32 of preceding bytes


def _as_u8(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a contiguous array (no copy)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _trailer(flat: np.ndarray) -> np.ndarray:
    import zlib

    return np.frombuffer(
        _CRC_TRAILER.pack(_CRC_MAGIC, zlib.crc32(flat) & 0xFFFFFFFF),
        np.uint8)


def crc_frame(arr: np.ndarray) -> np.ndarray:
    """``payload + CRC32 trailer`` as one contiguous uint8 buffer."""
    flat = _as_u8(arr)
    return np.concatenate([flat, _trailer(flat)])


def crc_frame_into(arr: np.ndarray, pool: "HostBufferPool"):
    """The bytes of :func:`crc_frame`, staged in a pooled lease. Returns
    ``(frame, lease)``; release the lease once the write has landed."""
    flat = _as_u8(arr)
    n = flat.nbytes + _CRC_TRAILER.size
    lease = pool.get(n)
    frame = lease.view(np.uint8, (n,))
    frame[:flat.nbytes] = flat
    frame[flat.nbytes:] = _trailer(flat)
    return frame, lease


def verify_crc(payload: np.ndarray, trailer: bytes, path: str) -> None:
    """Check an 8-byte trailer against the payload; OSError on mismatch."""
    import zlib

    magic, crc = _CRC_TRAILER.unpack(trailer)
    if magic != _CRC_MAGIC:
        raise OSError(f"spill file {path}: trailing bytes are not a CRC "
                      "trailer — truncated or corrupt")
    actual = zlib.crc32(_as_u8(payload)) & 0xFFFFFFFF
    if actual != crc:
        raise OSError(
            f"spill file {path} failed CRC32 verification (stored "
            f"{crc:#010x}, computed {actual:#010x}) — corrupt")


def compress_array(arr: np.ndarray, codec: str, level: int = 1) -> bytes:
    """Header + compressed bytes of a contiguous array."""
    raw = np.ascontiguousarray(arr).tobytes()
    if codec == "zlib":
        import zlib

        blob = zlib.compress(raw, level)
    elif codec == "lzma":
        import lzma

        blob = lzma.compress(raw, preset=level)
    else:
        raise ValueError(f"unknown compression codec {codec!r}")
    return _HDR.pack(_CODEC_MAGIC, _CODEC_IDS[codec], len(raw)) + blob


def decompress_blob(blob: bytes) -> bytes:
    """Inverse of :func:`compress_array` (the raw bytes); a damaged blob
    raises OSError whatever the codec."""
    if len(blob) < _HDR.size:
        raise OSError(f"not a compressed spill blob ({len(blob)} bytes "
                      "is shorter than the codec header) — truncated")
    magic, cid, raw_n = _HDR.unpack_from(blob)
    if magic != _CODEC_MAGIC:
        raise OSError("not a compressed spill blob (bad magic)")
    body = blob[_HDR.size:]
    if cid == _CODEC_IDS["zlib"]:
        import zlib

        try:
            raw = zlib.decompress(body)
        except zlib.error as e:
            raise OSError(f"corrupt spill blob: {e}") from e
    elif cid == _CODEC_IDS["lzma"]:
        import lzma

        try:
            raw = lzma.decompress(body)
        except lzma.LZMAError as e:
            raise OSError(f"corrupt spill blob: {e}") from e
    else:
        raise OSError(f"unknown codec id {cid} in spill header")
    if len(raw) != raw_n:
        raise OSError(f"decompressed {len(raw)} bytes, header said "
                      f"{raw_n} — corrupt spill blob")
    return raw


class HostBuffer:
    """One pooled host buffer: ``nbytes`` (its size class) of uint8,
    seen as numpy (``view``) and, when the pool allocated it with torch,
    as a tensor (``tensor``; page-locked when ``pinned``)."""

    __slots__ = ("nbytes", "pinned", "tensor", "_np", "_pool", "_released")

    def __init__(self, nbytes: int, arr: np.ndarray, tensor, pinned: bool,
                 pool: "HostBufferPool"):
        self.nbytes = nbytes
        self.pinned = pinned
        self.tensor = tensor
        self._np = arr
        self._pool = pool
        self._released = False

    def view(self, dtype=np.uint8, shape=None) -> np.ndarray:
        a = self._np.view(dtype)
        return a if shape is None else a[:int(np.prod(shape))].reshape(shape)

    def release(self) -> None:
        self._pool.put(self)


class HostBufferPool:
    """Size-classed host buffer pool (``RdmaBufferManager`` analogue).

    ``pinned``: allocate page-locked buffers (torch, CUDA runtime only);
    otherwise numpy memory."""

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._free: Dict[int, List[HostBuffer]] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self._hits = 0                                 # guarded-by: _lock
        self._allocations = 0                          # guarded-by: _lock
        self._outstanding = 0                          # guarded-by: _lock
        self._bytes = 0                                # guarded-by: _lock
        self._pinned_bytes = 0                         # guarded-by: _lock

    @staticmethod
    def size_class(nbytes: int) -> int:
        c = 256
        while c < nbytes:
            c <<= 1
        return c

    def get(self, nbytes: int) -> HostBuffer:
        cls = self.size_class(nbytes)
        with self._lock:
            stack = self._free.get(cls)
            buf = stack.pop() if stack else None
            if buf is not None:
                self._hits += 1
            else:
                self._allocations += 1
                self._bytes += cls
                if self.pinned:
                    self._pinned_bytes += cls
            self._outstanding += 1
        if buf is None:
            buf = self._allocate(cls)
        buf._released = False
        return buf

    def _allocate(self, cls: int) -> HostBuffer:
        if not self.pinned:
            return HostBuffer(cls, np.empty(cls, np.uint8), None, False, self)
        import torch

        t = torch.empty(cls, dtype=torch.uint8, pin_memory=True)
        return HostBuffer(cls, t.numpy(), t, True, self)

    def put(self, buf: HostBuffer) -> None:
        if buf._released:
            raise ValueError("buffer already released")
        buf._released = True
        with self._lock:
            self._outstanding -= 1
            self._free.setdefault(buf.nbytes, []).append(buf)

    def stats(self) -> Dict[str, int]:
        """``allocations`` (buffers made: the misses), ``hits``, buffers
        ``outstanding``, ``bytes_allocated`` and ``pinned_bytes``."""
        with self._lock:
            return {"allocations": self._allocations, "hits": self._hits,
                    "outstanding": self._outstanding,
                    "bytes_allocated": self._bytes,
                    "pinned_bytes": self._pinned_bytes}

    def close(self) -> None:
        with self._lock:
            self._free.clear()


def _fire_spill_write(path: str) -> bool:
    """The ``spill.write`` site; True: corrupt the payload. An injected
    failure is retried once in place (the ``spill_rewrite`` recovery); a
    second one raises the writer's ``OSError``."""
    act = faults.fire("spill.write")
    if act == "fail":
        act = faults.fire("spill.write")   # one bounded in-place retry
        if act == "fail":
            raise OSError(
                f"injected fault (spill.write): write of {path} failed "
                "twice — giving up")
        faults.note_recovery("spill_rewrite")
    return act == "corrupt"


class SpillWriter:
    """Pipelined spill to disk: submit arrays, keep computing, drain once.

    One writer thread behind a queue of ``depth`` entries (the bytes-in-
    flight throttle): ``submit`` blocks only when it is full. Each
    submission is framed (optional codec, CRC trailer) on the caller's
    thread, and the frame is kept alive until ``drain``."""

    def __init__(self, depth: int = 8, codec: str = "", level: int = 1,
                 checksum: bool = True,
                 pool: Optional[HostBufferPool] = None):
        if codec and codec not in _CODEC_IDS:
            raise ValueError(f"unknown compression codec {codec!r}")
        self._codec = codec
        self._level = level
        self._checksum = checksum
        self._pool = pool
        self._leases: List[HostBuffer] = []   # released at drain/close
        self._pending: List[np.ndarray] = []  # keep-alive until drain
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._errors = 0                      # guarded-by: _lock
        self._stop = False                    # guarded-by: _lock
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._loop, daemon=True, name="spill-writer")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                # bounded wait: the stop flag is the durable exit signal
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                with self._lock:
                    if self._stop:
                        return
                continue
            if item is None:
                self._q.task_done()
                return
            path, arr = item
            try:
                arr.tofile(path)
            except OSError:
                with self._lock:
                    self._errors += 1
            self._q.task_done()

    def submit(self, path: str, arr: np.ndarray) -> None:
        _count_spill(arr.nbytes)
        corrupt = _fire_spill_write(path)
        if self._codec:
            arr = np.frombuffer(
                compress_array(arr, self._codec, self._level), np.uint8)
        if self._checksum:
            if self._pool is not None:
                arr, lease = crc_frame_into(arr, self._pool)
                self._leases.append(lease)
            else:
                arr = crc_frame(arr)
            if corrupt:
                # the trailer holds the true payload's CRC: what a bit
                # flip after the write looks like
                arr[0] ^= 0x01
        arr = np.ascontiguousarray(arr)
        self._pending.append(arr)
        self._q.put((path, arr))

    def drain(self) -> int:
        """Block until every write has landed; return this batch's error
        count (reset by the drain)."""
        self._q.join()
        with self._lock:
            errors, self._errors = self._errors, 0
        self._pending.clear()
        self._release_leases()
        return errors

    def _release_leases(self) -> None:
        for lease in self._leases:
            lease.release()
        self._leases.clear()

    def close(self) -> None:
        if self._thread is not None:
            with self._lock:
                self._stop = True
            self._q.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        self._pending.clear()
        self._release_leases()


def write_array(path: str, arr: np.ndarray, codec: str = "", level: int = 1,
                checksum: bool = True,
                pool: Optional[HostBufferPool] = None) -> None:
    """Synchronous single-array spill (optionally compressed), ending in
    a CRC32 trailer (``checksum=False`` writes the legacy layout).
    ``pool`` stages the frame in a pooled lease, released before return."""
    _count_spill(arr.nbytes)
    corrupt = _fire_spill_write(path)
    if codec:
        arr = np.frombuffer(compress_array(arr, codec, level), np.uint8)
    lease = None
    if checksum:
        if pool is not None:
            arr, lease = crc_frame_into(arr, pool)
        else:
            arr = crc_frame(arr)
        if corrupt:
            arr[0] ^= 0x01   # see SpillWriter.submit
    try:
        np.ascontiguousarray(arr).tofile(path)
    finally:
        if lease is not None:
            lease.release()


def read_array(path: str, dtype, shape,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Read back a spilled array of known dtype and shape.

    Compressed files are recognised by their header (magic, codec id and
    a raw size equal to the expected one), raw files by their size: the
    payload alone (legacy) or the payload and a CRC trailer, which is
    verified. Anything else, and any mismatch, raises OSError. ``out``:
    a C-contiguous destination of exactly ``shape``/``dtype``, filled and
    returned."""
    tsz = _CRC_TRAILER.size
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    act = faults.fire("spill.read")
    if act == "fail":
        raise OSError(f"injected fault (spill.read): {path}")
    corrupt = act == "corrupt"
    try:
        actual = os.path.getsize(path)
    except OSError as e:
        raise OSError(f"spill file {path} unreadable: {e}") from e
    if actual >= _HDR.size:
        with open(path, "rb") as f:
            head = f.read(_HDR.size)
            magic, cid, raw_n = _HDR.unpack(head)
            if (magic == _CODEC_MAGIC and cid in _CODEC_IDS.values()
                    and raw_n == expected):
                data = head + f.read()
                if (len(data) >= _HDR.size + tsz
                        and data[-tsz:-tsz + 4] == _CRC_MAGIC):
                    body = data[:-tsz]
                    if corrupt:
                        body = faults.mangle(body)
                    verify_crc(np.frombuffer(body, np.uint8),
                               data[-tsz:], path)
                    data = body
                raw = decompress_blob(data)
                decoded = np.frombuffer(raw, dtype=dtype).reshape(shape)
                if out is not None:
                    out[...] = decoded
                    return out
                return decoded.copy()
    has_trailer = actual == expected + tsz
    if actual != expected and not has_trailer:
        raise OSError(f"spill file {path} is {actual} bytes, expected "
                      f"{expected} raw (and no valid compression "
                      "header) — truncated or corrupt")
    if out is None:
        out = np.empty(shape, dtype=dtype)
    with open(path, "rb") as f:
        n = f.readinto(memoryview(_as_u8(out))[:expected])
        if n != expected:
            raise OSError(f"spill file {path} has wrong size")
        trailer = f.read(tsz) if has_trailer else b""
    if has_trailer:
        if corrupt:
            _as_u8(out)[0] ^= 0x01
        verify_crc(out, trailer, path)
    return out


__all__ = ["HostBufferPool", "HostBuffer", "SpillWriter", "write_array",
           "read_array", "compress_array", "decompress_blob", "spill_count",
           "crc_frame", "crc_frame_into", "verify_crc"]
