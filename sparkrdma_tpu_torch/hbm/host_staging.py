"""Host staging: a size-classed host buffer pool and pipelined spill.

The port's copy of ``sparkrdma_tpu.hbm.host_staging``:

- the file format: an optional codec header (``compress_array`` /
  ``decompress_blob``) and a CRC32 trailer appended to the byte stream
  before the write (``crc_frame`` / ``crc_frame_into`` / ``verify_crc``),
  so every file written here is byte-identical to the reference's and
  each package reads the other's;
- :class:`HostBufferPool` — power-of-two size-classed host buffers
  (``RdmaBufferManager.get/put``). A pool made with ``pinned=True``
  gives page-locked leases, which an asynchronous copy to the card
  needs. A lease is never freed, only returned to its class's free
  stack, so page-locking is a one-time cost per buffer;
- :class:`SpillWriter` — a bounded queue and one writer thread persist
  arrays while the caller goes on;
- :func:`write_array` / :func:`read_array` — one array, synchronously.

Each of the three has two paths, chosen by ``use_native``
(``ShuffleConf.use_native_staging``, on by default as in the
reference):

- **native**: the port's own copy of the reference's C++ library,
  ``native/staging.cpp``, built with ``g++`` at first use
  (``_build.build_native``) and loaded with ``ctypes``, which releases
  the GIL for a whole call. The pool's leases come from
  ``sr_pool_get`` (256-byte aligned); a page-locked pool registers each
  new lease once with ``cudaHostRegister``. The spill writer's thread is
  the C spooler; whole-file writes and reads are ``sr_write_file`` /
  ``sr_read_file``. A library that cannot be built or loaded raises
  ``RuntimeError``: the numpy path never takes over silently;
- **numpy**: numpy memory (page-locked torch tensors for a pinned
  pool), a Python writer thread and ``tofile`` / ``readinto``.

Both write the same bytes. The serde codecs of the same library are
dispatched from ``api/serde.py`` (:func:`codec_available`).

The fault plane's storage sites fire here on both paths (``faults.py``):
``spill.write`` in ``write_array`` and ``SpillWriter.submit`` (an
injected failure is retried once in place and counted as the
``spill_rewrite`` recovery; ``corrupt`` flips a bit of the payload after
its CRC is taken) and ``spill.read`` in ``read_array`` (``fail`` raises
``OSError``; ``corrupt`` flips a bit of the payload before the CRC
check).

Each spill also records a ``staging:spill`` event (``bytes``) on the
active timeline, so a spill in the middle of a read shows in its span.
"""

from __future__ import annotations

import ctypes
import os
import queue
import struct
import threading
import weakref
from typing import Dict, List, Optional, Set

import numpy as np

from sparkrdma_tpu_torch import _build, faults
from sparkrdma_tpu_torch.obs.metrics import global_registry
from sparkrdma_tpu_torch.obs.timeline import record_active


def _count_spill(nbytes: int) -> None:
    """One host-staging spill, in the process-wide registry and on the
    active timeline."""
    reg = global_registry()
    reg.counter("staging.spills").inc()
    reg.counter("staging.spill_bytes").inc(nbytes)
    record_active("staging:spill", bytes=nbytes)


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


# --- the native library ------------------------------------------------

#: sanitizer flavor of the library a process loads: "" (plain), "tsan"
#: or "asan". Set in a child process whose sanitizer runtime is
#: preloaded (python itself is not instrumented)
_FLAVOR_ENV = "SPARKRDMA_NATIVE_FLAVOR"

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None      # guarded-by: _lib_lock

_V, _S, _I64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
_LONG, _INT, _STR = ctypes.c_long, ctypes.c_int, ctypes.c_char_p
_LONG_P = ctypes.POINTER(ctypes.c_long)
#: every entry point: name -> (argtypes, restype)
_SIGNATURES = {
    "sr_alloc": ([_S], _V),
    "sr_free": ([_V], None),
    "sr_pool_create": ([], _V),
    "sr_pool_destroy": ([_V], None),
    "sr_pool_get": ([_V, _S], _V),
    "sr_pool_put": ([_V, _V], _INT),
    "sr_pool_class_of": ([_S], _S),
    "sr_pool_stats": ([_V, _LONG_P, _LONG_P, _LONG_P, _LONG_P], None),
    "sr_write_file": ([_STR, _V, _S], _LONG),
    "sr_read_file": ([_STR, _V, _S], _LONG),
    "sr_file_size": ([_STR], _LONG),
    "sr_codec_abi": ([], _INT),
    # objs, bytes_type, size_off, data_off, keys, n, key_words,
    # slot_words, max_payload_bytes, out, threads
    "sr_encode_rows": ([_V, _V, _I64, _I64, _V, _I64, _I64, _I64, _I64,
                        _V, _I64], _LONG),
    # rows, n, key_words, slot_words, base, soff
    "sr_decode_plan": ([_V, _I64, _I64, _I64, _I64, _V], _LONG),
    # rows, n, key_words, slot_words, keys_out, soff, stream_out, threads
    "sr_decode_rows": ([_V, _I64, _I64, _I64, _V, _V, _V, _I64], _LONG),
    # keys, n, key_words, row_words, ncols, srcs, widths, dst_off,
    # var_len_word, var_slot_words, var_max_bytes, var_off, var_heap,
    # out, threads
    "sr_encode_cols": ([_V, _I64, _I64, _I64, _I64, _V, _V, _V, _I64,
                        _I64, _I64, _V, _V, _V, _I64], _LONG),
    # rows, n, key_words, row_words, ncols, dsts, widths, src_off,
    # var_len_word, var_slot_words, var_off, var_heap, threads
    "sr_decode_cols": ([_V, _I64, _I64, _I64, _I64, _V, _V, _V, _I64,
                        _I64, _V, _V, _I64], _LONG),
    "sr_spooler_create": ([_S], _V),
    "sr_spooler_submit": ([_V, _STR, _V, _S], _INT),
    "sr_spooler_drain": ([_V], _LONG),
    "sr_spooler_destroy": ([_V], None),
}


def native_flavor() -> str:
    """The library flavor this process loads ('' plain, 'tsan', 'asan');
    any other value of the environment variable raises ValueError."""
    flavor = os.environ.get(_FLAVOR_ENV, "").strip()
    if flavor not in _build.FLAVOR_FLAGS:
        raise ValueError(f"{_FLAVOR_ENV}={flavor!r}: expected one of "
                         f"{sorted(_build.FLAVOR_FLAGS)}")
    return flavor


def _declare(lib: ctypes.CDLL, path) -> ctypes.CDLL:
    """Declare every entry point; a missing one raises RuntimeError."""
    for name, (args, res) in _SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise RuntimeError(f"native staging library {path} lacks the "
                               f"entry point {name}") from None
        fn.argtypes = args
        fn.restype = res
    return lib


def load_native() -> ctypes.CDLL:
    """The port's staging library, built at first use and cached for
    the process; ``RuntimeError`` naming the cause when it cannot be
    built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            # _lib_lock exists precisely to serialize this one-shot
            # build+dlopen: concurrent first callers must block until
            # the single build finishes, and the result is cached so
            # the lock is never held for the build again. Leaf lock by
            # design.
            # srlint: ignore[blocking-under-lock]
            path = _build.build_native(native_flavor())
            try:
                cdll = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(
                    f"native staging library {path} does not load: {e}"
                ) from e
            _lib = _declare(cdll, path)
        return _lib


def _reset_native() -> None:
    """Forget the loaded library (tests that point the build elsewhere)."""
    global _lib
    with _lib_lock:
        _lib = None


def codec_available() -> bool:
    """True when the library loads and the host is little-endian (where
    the codecs' host-order words are the ``<u4`` wire format). Both
    codecs' entry points are in every build, so there is no separate
    test for the columnar one."""
    try:
        return bool(load_native().sr_codec_abi())
    except RuntimeError:
        return False


def _register_host(ptr: int, nbytes: int) -> None:
    """Page-lock ``nbytes`` at ``ptr`` for the CUDA runtime."""
    import torch

    err = torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 1)  # portable
    if int(err):
        raise RuntimeError(f"cudaHostRegister of {nbytes} B failed: "
                           f"cudaError_t {int(err)}")


def _unregister_host(ptr: int) -> None:
    import torch

    torch.cuda.cudart().cudaHostUnregister(ptr)


class HostBuffer:
    """One pooled host buffer: ``nbytes`` (its size class) of uint8,
    seen as numpy (``view``) and, in a pinned pool, as a page-locked
    tensor (``tensor``; None otherwise). ``address`` is the native
    allocation (None on the numpy path)."""

    __slots__ = ("nbytes", "pinned", "tensor", "_np", "_pool", "_released",
                 "_ptr")

    def __init__(self, nbytes: int, arr: np.ndarray, tensor, pinned: bool,
                 pool: "HostBufferPool", ptr: Optional[int] = None):
        self.nbytes = nbytes
        self.pinned = pinned
        self.tensor = tensor
        self._np = arr
        self._pool = pool
        self._released = False
        self._ptr = ptr

    @property
    def address(self) -> Optional[int]:
        return self._ptr

    def view(self, dtype=np.uint8, shape=None) -> np.ndarray:
        a = self._np.view(dtype)
        return a if shape is None else a[:int(np.prod(shape))].reshape(shape)

    def release(self) -> None:
        self._pool.put(self)


def _destroy_native_pool(lib, handle, registered: Dict[int, int],
                         out: Set[int]) -> None:
    """Free a native pool's idle buffers (unregistering page-locked ones
    first). Leased buffers are leaked on purpose, as in the reference:
    their holder may still be using them."""
    for ptr in list(registered):
        if ptr not in out:
            _unregister_host(ptr)
            del registered[ptr]
    lib.sr_pool_destroy(handle)


class HostBufferPool:
    """Size-classed host buffer pool (``RdmaBufferManager`` analogue).

    ``use_native``: leases from the C pool (``sr_pool_get``), else numpy
    memory. ``pinned``: page-locked leases with a ``tensor`` view (CUDA
    runtime only): native ones registered once with
    ``cudaHostRegister``, numpy-path ones allocated by torch."""

    def __init__(self, pinned: bool = False, use_native: bool = True):
        self.pinned = pinned
        self._lock = threading.Lock()
        self._free: Dict[int, List[HostBuffer]] = {}   # guarded-by: _lock
        self._hits = 0                                 # guarded-by: _lock
        self._allocations = 0                          # guarded-by: _lock
        self._outstanding = 0                          # guarded-by: _lock
        self._bytes = 0                                # guarded-by: _lock
        self._pinned_bytes = 0                         # guarded-by: _lock
        self._lib = load_native() if use_native else None
        self._handle = None
        #: native: numpy and tensor views of each address seen, the
        #: page-locked addresses, the leased ones
        self._views: Dict[int, tuple] = {}             # guarded-by: _lock
        self._registered: Dict[int, int] = {}          # guarded-by: _lock
        self._out: Set[int] = set()                    # guarded-by: _lock
        if self._lib is not None:
            self._handle = self._lib.sr_pool_create()
            self._finalizer = weakref.finalize(
                self, _destroy_native_pool, self._lib, self._handle,
                self._registered, self._out)

    @property
    def native(self) -> bool:
        return self._lib is not None

    @staticmethod
    def size_class(nbytes: int) -> int:
        c = 256
        while c < nbytes:
            c <<= 1
        return c

    def get(self, nbytes: int) -> HostBuffer:
        cls = self.size_class(nbytes)
        if self._lib is not None:
            return self._get_native(cls)
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

    def _get_native(self, cls: int) -> HostBuffer:
        if self._handle is None:
            raise RuntimeError("host buffer pool is closed")
        ptr = self._lib.sr_pool_get(self._handle, cls)
        if not ptr:
            raise MemoryError(f"host pool allocation of {cls} B failed")
        with self._lock:
            self._out.add(ptr)
            views = self._views.get(ptr)
        if views is None:
            # a new allocation (the lease is ours alone until put)
            arr = np.ctypeslib.as_array(
                (ctypes.c_uint8 * cls).from_address(ptr))
            tensor = None
            if self.pinned:
                import torch

                _register_host(ptr, cls)
                tensor = torch.frombuffer(arr, dtype=torch.uint8)
            views = (arr, tensor)
            with self._lock:
                self._views[ptr] = views
                if self.pinned:
                    self._registered[ptr] = cls
                    self._pinned_bytes += cls
        return HostBuffer(cls, views[0], views[1], self.pinned, self, ptr)

    def _allocate(self, cls: int) -> HostBuffer:
        if not self.pinned:
            return HostBuffer(cls, np.empty(cls, np.uint8), None, False, self)
        import torch

        t = torch.empty(cls, dtype=torch.uint8, pin_memory=True)
        return HostBuffer(cls, t.numpy(), t, True, self)

    def put(self, buf: HostBuffer) -> None:
        if buf._released:
            raise ValueError("buffer already released")
        if self._lib is not None:
            if self._handle is None:
                # closed: the lease was left to its holder (leaked)
                buf._released = True
                return
            # off the leased set before the C pool can hand it out again
            with self._lock:
                owned = buf._ptr in self._out
                self._out.discard(buf._ptr)
            if not owned or \
                    self._lib.sr_pool_put(self._handle, buf._ptr) != 0:
                raise ValueError("buffer not owned by pool (double "
                                 "release?)")
            buf._released = True
            return
        buf._released = True
        with self._lock:
            self._outstanding -= 1
            self._free.setdefault(buf.nbytes, []).append(buf)

    def stats(self) -> Dict[str, int]:
        """``allocations`` (buffers made: the misses), ``hits``, buffers
        ``outstanding``, ``bytes_allocated``, ``pinned_bytes`` and
        ``native`` (1 when the C pool serves the leases)."""
        if self._lib is not None and self._handle is not None:
            vals = [ctypes.c_long() for _ in range(4)]
            self._lib.sr_pool_stats(self._handle,
                                    *[ctypes.byref(v) for v in vals])
            with self._lock:
                pinned = self._pinned_bytes
            return {"allocations": vals[1].value, "hits": vals[0].value,
                    "outstanding": vals[2].value,
                    "bytes_allocated": vals[3].value,
                    "pinned_bytes": pinned, "native": 1}
        with self._lock:
            return {"allocations": self._allocations, "hits": self._hits,
                    "outstanding": self._outstanding,
                    "bytes_allocated": self._bytes,
                    "pinned_bytes": self._pinned_bytes,
                    "native": int(self._lib is not None)}

    def close(self) -> None:
        if self._lib is not None:
            with self._lock:
                handle, self._handle = self._handle, None
            if handle is not None:
                self._finalizer()
            return
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
    flight throttle): ``submit`` blocks only when it is full. With
    ``use_native`` the thread is the C spooler's, else a Python thread.
    Each submission is framed (optional codec, CRC trailer) on the
    caller's thread, and the frame is kept alive until ``drain``."""

    def __init__(self, depth: int = 8, use_native: bool = True,
                 codec: str = "", level: int = 1, checksum: bool = True,
                 pool: Optional[HostBufferPool] = None):
        if codec and codec not in _CODEC_IDS:
            raise ValueError(f"unknown compression codec {codec!r}")
        self._codec = codec
        self._level = level
        self._checksum = checksum
        self._pool = pool
        self._leases: List[HostBuffer] = []   # released at drain/close
        self._pending: List[np.ndarray] = []  # keep-alive until drain
        self._lib = load_native() if use_native else None
        self._handle = None
        self._thread: Optional[threading.Thread] = None
        if self._lib is not None:
            self._handle = self._lib.sr_spooler_create(depth)
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._errors = 0                      # guarded-by: _lock
        self._stop = False                    # guarded-by: _lock
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="spill-writer")
        self._thread.start()

    @property
    def native(self) -> bool:
        return self._lib is not None

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
        if self._lib is None:
            self._q.put((path, arr))
        elif self._handle is None or self._lib.sr_spooler_submit(
                self._handle, os.fsencode(path), arr.ctypes.data,
                arr.nbytes) != 0:
            raise RuntimeError("spill writer is closed")

    def drain(self) -> int:
        """Block until every write has landed; return this batch's error
        count (reset by the drain)."""
        if self._lib is not None:
            errors = int(self._lib.sr_spooler_drain(self._handle))
        else:
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
        if self._handle is not None:
            self._lib.sr_spooler_drain(self._handle)
            self._lib.sr_spooler_destroy(self._handle)
            self._handle = None
        elif self._thread is not None:
            with self._lock:
                self._stop = True
            self._q.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        self._pending.clear()
        self._release_leases()


def _write_whole(path: str, arr: np.ndarray, lib) -> None:
    if lib is None:
        arr.tofile(path)
        return
    rc = lib.sr_write_file(os.fsencode(path), arr.ctypes.data, arr.nbytes)
    if rc != arr.nbytes:
        raise OSError(-rc if rc < 0 else 0,
                      f"native write of {path} failed (rc={rc})")


def write_array(path: str, arr: np.ndarray, use_native: bool = True,
                codec: str = "", level: int = 1, checksum: bool = True,
                pool: Optional[HostBufferPool] = None) -> None:
    """Synchronous single-array spill (optionally compressed), ending in
    a CRC32 trailer (``checksum=False`` writes the legacy layout), through
    ``sr_write_file`` (``use_native``) or ``tofile``. ``pool`` stages the
    frame in a pooled lease, released before return."""
    _count_spill(arr.nbytes)
    corrupt = _fire_spill_write(path)
    lib = load_native() if use_native else None
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
        _write_whole(path, np.ascontiguousarray(arr), lib)
    finally:
        if lease is not None:
            lease.release()


def read_array(path: str, dtype, shape, use_native: bool = True,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Read back a spilled array of known dtype and shape.

    Compressed files are recognised by their header (magic, codec id and
    a raw size equal to the expected one), raw files by their size: the
    payload alone (legacy) or the payload and a CRC trailer, which is
    verified. Anything else, and any mismatch, raises OSError. The
    payload of a raw file is read by ``sr_read_file`` (``use_native``) or
    ``readinto``. ``out``: a C-contiguous destination of exactly
    ``shape``/``dtype``, filled and returned."""
    tsz = _CRC_TRAILER.size
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    act = faults.fire("spill.read")
    if act == "fail":
        raise OSError(f"injected fault (spill.read): {path}")
    corrupt = act == "corrupt"
    lib = load_native() if use_native else None
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
    if lib is not None:
        # the payload only: the trailer is read below
        n = lib.sr_read_file(os.fsencode(path), out.ctypes.data, expected)
        if n < 0:
            raise OSError(-n, f"native read of {path} failed")
        trailer = b""
        if has_trailer:
            with open(path, "rb") as f:
                f.seek(expected)
                trailer = f.read(tsz)
    else:
        with open(path, "rb") as f:
            n = f.readinto(memoryview(_as_u8(out))[:expected])
            trailer = f.read(tsz) if has_trailer else b""
    if n != expected:
        raise OSError(f"spill file {path} has wrong size")
    if has_trailer:
        if corrupt:
            _as_u8(out)[0] ^= 0x01
        verify_crc(out, trailer, path)
    return out


__all__ = ["HostBufferPool", "HostBuffer", "SpillWriter", "write_array",
           "read_array", "compress_array", "decompress_blob", "spill_count",
           "crc_frame", "crc_frame_into", "verify_crc", "load_native",
           "codec_available", "native_flavor"]
