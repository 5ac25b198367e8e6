"""Host row codecs — the port's copy of ``sparkrdma_tpu.api.serde``.

The exchange moves fixed-width uint32 word records, so variable-length
byte payloads need an encoding on the host. Two formats, both
bit-identical to the reference's rows:

- **v1, padded slots** (:func:`encode_bytes_rows` /
  :func:`decode_bytes_rows`): a record is ``[key words | length word
  (bytes) | payload words, zero-padded]``, the payload slot sized to
  ``max_payload_bytes`` rounded up to whole words
  (:func:`payload_words`). Oversized payloads raise; bytes sit in words
  little-endian (``<u4``), whatever the host's order.
- **Columnar v2** (:class:`RowSchema`, :func:`encode_cols` /
  :func:`decode_cols`): fixed-width ``uint32`` / ``int64`` / ``float64``
  columns (a 64-bit value is two words, low then high) and at most one
  trailing varlen bytes column laid out as a v1 slot. Decode returns
  numpy views over the rows for the fixed columns and a
  :class:`BytesColumn` (offsets + heap) for the bytes column. A schema
  whose only column is a bytes column gives the v1 rows bit for bit.

Each codec has two implementations with the same rows, chosen by
``native`` (``ShuffleConf.serde_native``, on by default as in the
reference):

- **native**: ``sr_encode_rows`` / ``sr_decode_plan`` /
  ``sr_decode_rows`` and ``sr_encode_cols`` / ``sr_decode_cols`` of the
  port's C++ staging library (``native/staging.cpp``), rows sharded over
  ``threads`` std::threads (0 or None: ``min(8, os.cpu_count())``) with
  the GIL released. The v1 encoder reads each payload straight out of
  its CPython ``bytes`` object, at offsets checked once per process
  against a live object (:func:`_layout_ok`); the v1 decoder writes a
  pickle protocol-3 item stream that one ``pickle.loads`` turns into the
  payloads. The library must load, the host must be little-endian and
  the canary must pass, or the call raises ``RuntimeError``: the numpy
  codec never takes over silently. The fault sites ``serde.encode`` and
  ``serde.decode`` fire here, once per call: an injected failure is
  overcome by running the native call again (the ``serde_native``
  recovery; the reference degrades to numpy instead), a second one
  raises;
- **numpy**: vectorized numpy, no toolchain needed, explicit ``<u4``
  views.

Every call adds its encoded bytes, nanoseconds and one call to the
process-wide registry (``serde.*`` for v1, ``serde.columnar.*`` for v2)
and one ``{op}_native`` or ``{op}_fallback`` tick; :func:`codec_totals`
sums them as the reference does.

Not ported: the reference's degradation rungs (native to numpy, columnar
to v1).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.hbm.host_staging import (codec_available,
                                                  load_native)
from sparkrdma_tpu_torch.obs.metrics import global_registry

# CPython bytes-object layout the native encoder reads: ob_size at
# PyVarObject offset 16 (refcount and type pointer on 64-bit), the bytes
# at __basicsize__ - 1 (basicsize counts the trailing NUL). Checked by
# _layout_ok() against a live object before the first native call.
_SIZE_OFF = 16
_DATA_OFF = bytes.__basicsize__ - 1
_PICKLE_HEAD = b"\x80\x03("   # PROTO 3, MARK
_PICKLE_TAIL = b"l."          # LIST, STOP

_layout_checked: Optional[bool] = None


def payload_words(max_payload_bytes: int) -> int:
    """Words one payload slot occupies: 1 length word + ceil(bytes/4)."""
    if max_payload_bytes < 0:
        raise ValueError("max_payload_bytes must be >= 0")
    return 1 + (max_payload_bytes + 3) // 4


def _layout_ok() -> bool:
    """Canary: read a known bytes object through the offsets the native
    encoder uses; a CPython laid out otherwise fails. Cached."""
    global _layout_checked
    if _layout_checked is None:
        import ctypes
        try:
            if ctypes.sizeof(ctypes.c_void_p) != 8:
                raise OverflowError("32-bit pointers")
            probe = b"sparkrdma codec layout probe"
            holder = np.empty(1, dtype=object)
            holder[0] = probe
            op = ctypes.cast(holder.ctypes.data,
                             ctypes.POINTER(ctypes.c_void_p))[0]
            tp = ctypes.cast(op + 8, ctypes.POINTER(ctypes.c_void_p))[0]
            sz = ctypes.cast(op + _SIZE_OFF,
                             ctypes.POINTER(ctypes.c_int64))[0]
            data = ctypes.string_at(op + _DATA_OFF, len(probe))
            _layout_checked = (tp == id(bytes) and sz == len(probe)
                               and data == probe)
        except Exception:
            _layout_checked = False
    return _layout_checked


def _codec_lib():
    """The staging library, for a native codec call; ``RuntimeError``
    naming why when the native codec cannot run."""
    lib = load_native()
    if not lib.sr_codec_abi():
        raise RuntimeError(
            "native serde codec refused: big-endian host (its host-order "
            "words are not the <u4 wire format) — set serde_native=False")
    if not _layout_ok():
        raise RuntimeError(
            "native serde codec refused: this CPython's bytes layout "
            "failed the canary — set serde_native=False")
    return lib


def native_codec_available() -> bool:
    """True when a native codec call can run here."""
    return codec_available() and _layout_ok()


def _auto_threads(threads: Optional[int]) -> int:
    """Threads of one native call: ``threads``, or for None/0 the
    reference's ``min(8, os.cpu_count())``."""
    if threads:
        return int(threads)
    return max(1, min(8, os.cpu_count() or 1))


def _fire_codec(site: str) -> None:
    """The ``serde.encode`` / ``serde.decode`` site of a native call: an
    injected failure is overcome by running the call again (the
    ``serde_native`` recovery), a second one raises."""
    if faults.fire(site) == "fail":
        if faults.fire(site) == "fail":
            raise RuntimeError(f"injected fault ({site}): the native codec "
                               "call failed twice — giving up")
        faults.note_recovery("serde_native")


def _coerce_payloads(payloads: Sequence) -> List[bytes]:
    """Payloads as a list of bytes: bytes and any buffer-protocol object
    (bytearray, memoryview, uint8 arrays). ``str`` and ``int`` raise a
    ValueError naming the row (the codec guesses no encoding, and
    ``bytes(5)`` would mean five NUL bytes)."""
    out: List[bytes] = []
    for i, p in enumerate(payloads):
        if type(p) is bytes:
            out.append(p)
        elif isinstance(p, (bytes, bytearray, memoryview)):
            out.append(bytes(p))
        elif isinstance(p, (str, int)):
            raise ValueError(
                f"payload {i} is {type(p).__name__}, not bytes-like "
                "(encode strings explicitly; the codec will not guess)")
        else:
            try:
                out.append(bytes(memoryview(p)))
            except TypeError:
                raise ValueError(
                    f"payload {i} is {type(p).__name__}, which does not "
                    "support the buffer protocol — pass bytes, "
                    "bytearray, memoryview, or a uint8 array") from None
    return out


def _count(family: str, op: str, nbytes: int, ns: int,
           native: bool) -> None:
    reg = global_registry()
    reg.counter(f"{family}.{op}_bytes").inc(nbytes)
    reg.counter(f"{family}.{op}_ns").inc(ns)
    reg.counter(f"{family}.{op}_calls").inc()
    reg.counter(f"{family}.{op}_native" if native
                else f"{family}.{op}_fallback").inc()


def codec_totals() -> dict:
    """Cumulative process-wide codec totals: encoded bytes and host
    seconds inside the codec. The ``serde_{encode,decode}_*`` keys sum
    both formats; ``serde_columnar_*`` is the columnar share."""
    reg = global_registry()

    def _c(name: str) -> int:
        return int(reg.counter(name).value)

    ceb = _c("serde.columnar.encode_bytes")
    cen = _c("serde.columnar.encode_ns")
    cdb = _c("serde.columnar.decode_bytes")
    cdn = _c("serde.columnar.decode_ns")
    return {
        "serde_encode_bytes": _c("serde.encode_bytes") + ceb,
        "serde_encode_s": (_c("serde.encode_ns") + cen) / 1e9,
        "serde_decode_bytes": _c("serde.decode_bytes") + cdb,
        "serde_decode_s": (_c("serde.decode_ns") + cdn) / 1e9,
        "serde_columnar_encode_bytes": ceb,
        "serde_columnar_encode_s": cen / 1e9,
        "serde_columnar_decode_bytes": cdb,
        "serde_columnar_decode_s": cdn / 1e9,
    }


def _oversize_error(lens: np.ndarray, max_payload_bytes: int) -> ValueError:
    i = int(np.argmax(lens > max_payload_bytes))
    return ValueError(
        f"payload {i} is {int(lens[i])} bytes > max_payload_bytes "
        f"{max_payload_bytes} (raise the bound or split the "
        "payload — the serializer will not truncate silently)")


def _corrupt_error(lens: np.ndarray, max_bytes: int) -> ValueError:
    i = int(np.argmax(lens > max_bytes))
    return ValueError(
        f"row {i} declares {int(lens[i])} payload bytes but the slot "
        f"holds {max_bytes} — corrupt length word")


def _out_rows(out, n: int, w: int) -> np.ndarray:
    """``out`` (a caller's C-contiguous ``uint32[n, w]``) or a new one."""
    if out is None:
        return np.empty((n, w), dtype=np.uint32)
    if (out.shape != (n, w) or out.dtype != np.uint32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous uint32[{n}, {w}]")
    return out


def encode_bytes_rows(keys: np.ndarray, payloads: Sequence,
                      max_payload_bytes: int, *, native: bool = True,
                      threads: Optional[int] = None,
                      out: np.ndarray = None) -> np.ndarray:
    """``(key words, bytes payload)`` pairs -> v1 rows ``uint32[N,
    key_words + payload_words(max_payload_bytes)]``. ``native`` /
    ``threads`` choose the codec (module docstring); ``out`` lets the
    pipelined load encode into a staging lease (C-contiguous uint32 of
    the output shape)."""
    t0 = time.perf_counter_ns()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, kw = keys.shape
    if len(payloads) != n:
        raise ValueError(f"{n} keys but {len(payloads)} payloads")
    slot_words = payload_words(max_payload_bytes) - 1
    out = _out_rows(out, n, kw + 1 + slot_words)
    use_native = bool(native) and n > 0
    if use_native:
        lib = _codec_lib()
        _fire_codec("serde.encode")
        # a numpy object array's storage is a PyObject* vector: the C
        # threads read each bytes object's size and bytes in place
        objs = np.empty(n, dtype=object)
        coerced = False
        try:
            objs[:] = payloads
        except ValueError:
            # e.g. equal-length uint8 arrays, which numpy would broadcast
            payloads = _coerce_payloads(payloads)
            coerced = True
            objs[:] = payloads

        def call() -> int:
            return int(lib.sr_encode_rows(
                objs.ctypes.data, id(bytes), _SIZE_OFF, _DATA_OFF,
                keys.ctypes.data, n, kw, slot_words, max_payload_bytes,
                out.ctypes.data, _auto_threads(threads)))

        rc = call()
        if rc < 0 and not coerced:
            # a row that is not bytes (or too long): coerce, which raises
            # the precise error for rows that are not bytes-like, and
            # run once more
            payloads = _coerce_payloads(payloads)
            objs[:] = payloads
            rc = call()
        if rc < 0:
            lens = np.fromiter(map(len, payloads), np.int64, count=n)
            if int(lens.max()) > max_payload_bytes:
                raise _oversize_error(lens, max_payload_bytes)
            raise RuntimeError(f"native encoder rejected row {-rc - 1} "
                               "after coercion — codec inconsistency")
    else:
        if set(map(type, payloads)) - {bytes}:
            payloads = _coerce_payloads(payloads)
        lens = np.fromiter(map(len, payloads), dtype=np.int64, count=n)
        if n and int(lens.max()) > max_payload_bytes:
            raise _oversize_error(lens, max_payload_bytes)
        out[:, :kw] = keys
        out[:, kw] = lens.astype(np.uint32)
        if slot_words and n:
            # one join of zero-padded payloads is the slot layout
            slot_bytes = slot_words * 4
            buf = np.frombuffer(
                b"".join(p.ljust(slot_bytes, b"\0") for p in payloads),
                dtype=np.uint8)
            out[:, kw + 1:] = buf.view("<u4").reshape(n, slot_words)
    _count("serde", "encode", out.nbytes, time.perf_counter_ns() - t0,
           use_native)
    return out


def decode_bytes_rows(rows: np.ndarray, key_words: int, *,
                      native: bool = True, threads: Optional[int] = None
                      ) -> Tuple[np.ndarray, List[bytes]]:
    """Inverse of :func:`encode_bytes_rows`: ``(keys, payloads)``. A
    length word past the slot raises (the smallest such row), on either
    codec."""
    t0 = time.perf_counter_ns()
    rows = np.asarray(rows, dtype=np.uint32)
    n, w = rows.shape
    slot_words = w - key_words - 1
    max_bytes = slot_words * 4
    use_native = bool(native) and n > 0 and slot_words > 0
    if use_native:
        import pickle

        lib = _codec_lib()
        _fire_codec("serde.decode")
        crows = np.ascontiguousarray(rows)
        keys = np.empty((n, key_words), dtype=np.uint32)
        # one serial pass checks every length word and places each row's
        # pickle item in the stream
        soff = np.empty(n, dtype=np.int64)
        total = int(lib.sr_decode_plan(crows.ctypes.data, n, key_words,
                                       slot_words, len(_PICKLE_HEAD),
                                       soff.ctypes.data))
        if total < 0:
            raise _corrupt_error(crows[:, key_words], max_bytes)
        buf = np.empty(len(_PICKLE_HEAD) + total + len(_PICKLE_TAIL),
                       dtype=np.uint8)
        buf[:len(_PICKLE_HEAD)] = np.frombuffer(_PICKLE_HEAD, np.uint8)
        buf[len(_PICKLE_HEAD) + total:] = np.frombuffer(_PICKLE_TAIL,
                                                        np.uint8)
        rc = int(lib.sr_decode_rows(
            crows.ctypes.data, n, key_words, slot_words, keys.ctypes.data,
            soff.ctypes.data, buf.ctypes.data, _auto_threads(threads)))
        if rc < 0:    # the plan checked every length word already
            raise _corrupt_error(crows[:, key_words], max_bytes)
        payloads = pickle.loads(memoryview(buf))
    else:
        lens = rows[:, key_words]
        if n and int(lens.max()) > max_bytes:
            raise _corrupt_error(lens, max_bytes)
        keys = rows[:, :key_words]
        whole = np.ascontiguousarray(
            rows[:, key_words + 1:].astype("<u4")).view(np.uint8).tobytes()
        payloads = [whole[i * max_bytes: i * max_bytes + ln]
                    for i, ln in enumerate(lens.tolist())]
    _count("serde", "decode", rows.nbytes, time.perf_counter_ns() - t0,
           use_native)
    return keys, payloads


# ---------------------------------------------------------------------
# Columnar v2
# ---------------------------------------------------------------------

#: words and dtype of each fixed-width column kind
_FIXED_KINDS = {
    "uint32": (1, np.dtype(np.uint32)),
    "int64": (2, np.dtype(np.int64)),
    "float64": (2, np.dtype(np.float64)),
}


class RowSchema:
    """Declared column layout of a record's payload region.

    ``fields`` is an ordered sequence of ``(name, kind)``: ``"uint32"``
    (1 word), ``"int64"`` / ``"float64"`` (2 words, low then high), or
    ``("bytes", max_len)``, a varlen column stored as a v1 slot (1
    length word + ``ceil(max_len / 4)`` words). At most one bytes column,
    and it comes last; ``"keys"`` is reserved. Equality is field
    equality; :attr:`payload_words` must equal the manager's
    ``val_words``."""

    __slots__ = ("fields", "names", "payload_words", "fixed",
                 "var_name", "var_max_bytes", "var_len_word",
                 "var_slot_words")

    def __init__(self, fields: Sequence[Tuple[str, object]]):
        norm: List[Tuple[str, object]] = []
        fixed: List[Tuple[str, str, int]] = []   # (name, kind, word off)
        seen = set()
        var_name = None
        var_max = 0
        var_lw = -1
        off = 0
        for f in fields:
            try:
                name, kind = f
            except (TypeError, ValueError):
                raise ValueError(
                    f"schema field {f!r} is not a (name, kind) pair")
            if not isinstance(name, str) or not name:
                raise ValueError(
                    f"schema column name {name!r} must be a non-empty str")
            if name == "keys":
                raise ValueError(
                    'schema column name "keys" is reserved — key words '
                    "live outside the payload region")
            if name in seen:
                raise ValueError(f"duplicate schema column {name!r}")
            if var_name is not None:
                raise ValueError(
                    f"bytes column {var_name!r} must be the LAST schema "
                    f"column (found {name!r} after it)")
            seen.add(name)
            if isinstance(kind, str) and kind in _FIXED_KINDS:
                fixed.append((name, kind, off))
                off += _FIXED_KINDS[kind][0]
                norm.append((name, kind))
                continue
            try:
                tag, max_len = kind
            except (TypeError, ValueError):
                tag = None
            if tag != "bytes":
                raise ValueError(
                    f"schema column {name!r} has unknown kind {kind!r} — "
                    "expected 'uint32', 'int64', 'float64', or "
                    "('bytes', max_len)")
            max_len = int(max_len)
            if max_len < 0:
                raise ValueError(
                    f"bytes column {name!r}: max_len must be >= 0")
            var_name, var_max, var_lw = name, max_len, off
            off += 1 + (max_len + 3) // 4
            norm.append((name, ("bytes", max_len)))
        if not norm:
            raise ValueError("schema needs at least one column")
        self.fields = tuple(norm)
        self.names = tuple(n for n, _ in norm)
        self.fixed = tuple(fixed)
        self.var_name = var_name
        self.var_max_bytes = var_max
        self.var_len_word = var_lw
        self.var_slot_words = (var_max + 3) // 4 if var_name else 0
        self.payload_words = off

    @classmethod
    def bytes_only(cls, max_payload_bytes: int,
                   name: str = "payload") -> "RowSchema":
        """The schema whose rows are the v1 codec's: one bytes column."""
        return cls([(name, ("bytes", max_payload_bytes))])

    @property
    def is_bytes_only(self) -> bool:
        return len(self.fields) == 1 and self.var_name is not None

    def column_word_span(self, name: str) -> Tuple[int, int]:
        """``(offset, width)`` of a column in the payload region, in
        words (a bytes column spans its length word + slot words)."""
        for n, kind, off in self.fixed:
            if n == name:
                return off, _FIXED_KINDS[kind][0]
        if name == self.var_name:
            return self.var_len_word, 1 + self.var_slot_words
        raise KeyError(f"schema has no column {name!r} "
                       f"(columns: {list(self.names)})")

    def keep_words(self, columns: Sequence[str],
                   key_words: int) -> Tuple[int, ...]:
        """Record word indices of a projection keeping ``columns``: every
        key word plus each kept column's words, ascending (the exchange's
        ``keep_words``). Unknown names raise ``KeyError``."""
        words = set(range(key_words))
        for name in columns:
            off, width = self.column_word_span(name)
            words.update(range(key_words + off, key_words + off + width))
        return tuple(sorted(words))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, RowSchema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        return f"RowSchema({list(self.fields)!r})"


class BytesColumn:
    """A decoded varlen bytes column: ``offsets`` (int64[N + 1]) into a
    uint8 ``heap`` (Arrow's variable-binary layout). Reads as a lazy
    sequence of ``bytes``; :func:`encode_cols` takes it as it is."""

    __slots__ = ("offsets", "heap")

    def __init__(self, offsets: np.ndarray, heap: np.ndarray):
        self.offsets = offsets
        self.heap = heap

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"row {i} out of range for {n} rows")
        return self.heap[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def to_list(self) -> List[bytes]:
        return list(self)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BytesColumn):
            a0, a1 = int(self.offsets[0]), int(self.offsets[-1])
            b0, b1 = int(other.offsets[0]), int(other.offsets[-1])
            return (np.array_equal(self.offsets - a0, other.offsets - b0)
                    and np.array_equal(self.heap[a0:a1],
                                       other.heap[b0:b1]))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self) -> str:
        return (f"BytesColumn(rows={len(self)}, "
                f"heap_bytes={int(self.offsets[-1] - self.offsets[0])})")


def _canon_varlen(values, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """A varlen column as ``(offsets int64[n + 1], heap uint8[])``, from
    a :class:`BytesColumn`, an ``(offsets, heap)`` pair, or a sequence of
    bytes-like rows."""
    if isinstance(values, BytesColumn):
        offsets, heap = values.offsets, values.heap
    elif (isinstance(values, tuple) and len(values) == 2
          and isinstance(values[0], np.ndarray)):
        offsets, heap = values
    else:
        rows = values
        if set(map(type, rows)) - {bytes}:
            rows = _coerce_payloads(rows)
        lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        heap = (np.frombuffer(b"".join(rows), dtype=np.uint8)
                if int(offsets[-1]) else np.zeros(0, np.uint8))
        return offsets, heap
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.shape != (n + 1,):
        raise ValueError(f"varlen offsets must be int64[{n + 1}] "
                         f"(got shape {offsets.shape})")
    if n and int(np.min(np.diff(offsets))) < 0:
        raise ValueError("varlen offsets must be non-decreasing")
    heap = np.ascontiguousarray(heap, dtype=np.uint8).reshape(-1)
    if int(offsets[-1]) > heap.size or int(offsets[0]) < 0:
        raise ValueError(
            f"varlen offsets address {int(offsets[-1])} heap bytes but "
            f"the heap holds {heap.size}")
    return offsets, heap


def _coerce_fixed(name: str, kind: str, values, n: int) -> np.ndarray:
    arr = np.ascontiguousarray(values, dtype=_FIXED_KINDS[kind][1])
    if arr.shape != (n,):
        raise ValueError(
            f"column {name!r} must be {kind}[{n}] (got shape {arr.shape})")
    return arr


def _check_names(schema: RowSchema, columns) -> None:
    missing = set(schema.names) - set(columns)
    extra = set(columns) - set(schema.names)
    if missing or extra:
        raise ValueError(
            f"columns do not match schema: missing {sorted(missing)}, "
            f"unexpected {sorted(extra)}")


def encode_cols(keys: np.ndarray, columns, schema: RowSchema, *,
                native: bool = True, threads: Optional[int] = None,
                out: np.ndarray = None) -> np.ndarray:
    """Named columns -> rows ``uint32[N, key_words +
    schema.payload_words]``. ``columns`` maps every schema column to its
    values: fixed columns any array castable to their dtype, the bytes
    column a list of bytes, a :class:`BytesColumn` or ``(offsets,
    heap)``. ``native`` / ``threads`` / ``out`` as in
    :func:`encode_bytes_rows`."""
    t0 = time.perf_counter_ns()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, kw = keys.shape
    _check_names(schema, columns)
    w = kw + schema.payload_words
    out = _out_rows(out, n, w)
    fixed = [(fkind, foff, _coerce_fixed(fname, fkind, columns[fname], n))
             for fname, fkind, foff in schema.fixed]
    offsets = heap = None
    if schema.var_name is not None:
        offsets, heap = _canon_varlen(columns[schema.var_name], n)
        lens = np.diff(offsets)
        if n and int(lens.max()) > schema.var_max_bytes:
            raise _oversize_error(lens, schema.var_max_bytes)
    use_native = bool(native) and n > 0
    if use_native:
        lib = _codec_lib()
        _fire_codec("serde.encode")
        srcs = np.array([a.ctypes.data for _, _, a in fixed], np.uint64)
        widths = np.array([_FIXED_KINDS[k][0] for k, _, _ in fixed],
                          np.int64)
        doffs = np.array([o for _, o, _ in fixed], np.int64)
        rc = int(lib.sr_encode_cols(
            keys.ctypes.data, n, kw, w, len(fixed), srcs.ctypes.data,
            widths.ctypes.data, doffs.ctypes.data, schema.var_len_word,
            schema.var_slot_words, schema.var_max_bytes,
            offsets.ctypes.data if offsets is not None else None,
            heap.ctypes.data if heap is not None else None,
            out.ctypes.data, _auto_threads(threads)))
        if rc < 0:    # lengths were checked above
            raise RuntimeError(f"native columnar encoder rejected row "
                               f"{-rc - 1} after validation — codec "
                               "inconsistency")
    else:
        out[:, :kw] = keys
        for fkind, foff, arr in fixed:
            if fkind == "uint32":
                out[:, kw + foff] = arr
            else:
                # word values, low then high, on any host order
                bits = arr.view(np.uint64)
                out[:, kw + foff] = (bits & 0xFFFFFFFF).astype(np.uint32)
                out[:, kw + foff + 1] = (bits >> 32).astype(np.uint32)
        if schema.var_name is not None:
            lw = kw + schema.var_len_word
            lens = np.diff(offsets)
            out[:, lw] = lens.astype(np.uint32)
            if schema.var_slot_words and n:
                slot_bytes = schema.var_slot_words * 4
                slot = np.zeros((n, slot_bytes), dtype=np.uint8)
                mask = np.arange(slot_bytes)[None, :] < lens[:, None]
                # a boolean-mask assignment runs in row-major order: the
                # heap's row-concatenated order
                slot[mask] = heap[int(offsets[0]):int(offsets[-1])]
                out[:, lw + 1:lw + 1 + schema.var_slot_words] = \
                    slot.view("<u4")
    _count("serde.columnar", "encode", out.nbytes,
           time.perf_counter_ns() - t0, use_native)
    return out


def decode_cols(rows: np.ndarray, key_words: int, schema: RowSchema, *,
                native: bool = True, threads: Optional[int] = None
                ) -> Tuple[np.ndarray, dict]:
    """Inverse of :func:`encode_cols`: ``(keys, {name: column})``. Fixed
    columns are numpy views over ``rows`` (on a little-endian host; else
    computed copies), which keep ``rows`` alive; the bytes column is a
    :class:`BytesColumn`, gathered by ``sr_decode_cols`` (``native``) or
    a numpy mask. A length word past the slot raises."""
    t0 = time.perf_counter_ns()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    n, w = rows.shape
    if w != key_words + schema.payload_words:
        raise ValueError(
            f"rows have {w - key_words} payload words but the schema "
            f"declares {schema.payload_words}")
    keys = rows[:, :key_words]
    cols: dict = {}
    le = sys.byteorder == "little"
    for fname, fkind, foff in schema.fixed:
        c = key_words + foff
        if fkind == "uint32":
            cols[fname] = rows[:, c]
        elif le:
            dt = "<i8" if fkind == "int64" else "<f8"
            cols[fname] = rows[:, c:c + 2].view(dt)[:, 0]
        else:
            bits = (rows[:, c].astype(np.uint64)
                    | rows[:, c + 1].astype(np.uint64) << 32)
            cols[fname] = bits.view(_FIXED_KINDS[fkind][1])
    use_native = False      # fixed columns alone are views: no codec call
    if schema.var_name is not None:
        lw = key_words + schema.var_len_word
        slot_words = schema.var_slot_words
        max_bytes = slot_words * 4
        lens = rows[:, lw].astype(np.int64)
        if n and int(lens.max()) > max_bytes:
            raise _corrupt_error(lens, max_bytes)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        heap = np.empty(int(offsets[-1]), dtype=np.uint8)
        use_native = bool(native) and heap.size > 0
        if use_native:
            lib = _codec_lib()
            _fire_codec("serde.decode")
            rc = int(lib.sr_decode_cols(
                rows.ctypes.data, n, key_words, w, 0, None, None, None,
                schema.var_len_word, slot_words, offsets.ctypes.data,
                heap.ctypes.data, _auto_threads(threads)))
            if rc < 0:    # the lengths were checked above
                raise _corrupt_error(lens, max_bytes)
        elif heap.size:
            blob = np.ascontiguousarray(
                rows[:, lw + 1:lw + 1 + slot_words].astype(
                    "<u4")).view(np.uint8).reshape(n, max_bytes)
            mask = np.arange(max_bytes)[None, :] < lens[:, None]
            heap[:] = blob[mask]
        cols[schema.var_name] = BytesColumn(offsets, heap)
    _count("serde.columnar", "decode", rows.nbytes,
           time.perf_counter_ns() - t0, use_native)
    return keys, cols


def rows_content_digest(rows: np.ndarray) -> str:
    """Canonical 16-hex content digest of a host row batch (shape, dtype
    and bytes): one digest value for one bit pattern, the same value the
    reference's function gives. The query planner folds it into source
    fingerprints."""
    r = np.ascontiguousarray(rows)
    h = hashlib.sha256()
    h.update(repr((r.shape, r.dtype.name)).encode())
    h.update(r.data)
    return h.hexdigest()[:16]


__all__ = ["encode_bytes_rows", "decode_bytes_rows", "payload_words",
           "native_codec_available", "codec_totals", "RowSchema",
           "BytesColumn", "encode_cols", "decode_cols",
           "rows_content_digest"]
