"""Wire format of the external shuffle service — the port's copy of
``sparkrdma_tpu.service.wire``: the same frames, versions and field sets,
so either package's client talks to either package's server.

The control plane between :class:`~sparkrdma_tpu_torch.service.client.RpcClient`
and :class:`~sparkrdma_tpu_torch.service.rpc.RpcServer` is deliberately dumb:
length-prefixed JSON over a plain TCP socket, every frame carrying a
pinned ``RPC_SCHEMA_VERSION``. The data plane stays in the daemon's
process, on its card, and only the control plane crosses the wire, so
JSON is fast enough and — unlike pickle — safe to parse from a
half-trusted, possibly corrupted peer.

Frame layout (all integers big-endian)::

    +----------+----------+------------------------+
    | len: u32 | crc: u32 | payload: len JSON bytes|
    +----------+----------+------------------------+

``crc`` is the zlib CRC-32 of the *intact* payload, computed before any
injected corruption, so a frame mangled in flight (``faults.mangle`` —
or a real half-written socket) fails the receiver's CRC check and
surfaces as :class:`FrameError`, never as a silently-wrong JSON field.

Fault sites: :func:`send_frame` consults ``faults.fire("rpc.send")``
before writing (``fail`` → :class:`ConnectionError`, ``corrupt`` →
payload mangled after the CRC is computed); :func:`recv_frame` consults
``faults.fire("rpc.recv")`` after the read, before the CRC check.
Chaos schedules can therefore fail/corrupt/delay either direction of
the wire deterministically.

The literal frozensets below are the protocol's single source of truth
(equal to the reference's: ``tests/test_torch_service_rpc.py``): the
client's request dict, the server's reply dict, the lease journal line
and the CLI readers' ``.get()`` accesses follow them. Extend a set and
its builder/reader TOGETHER.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib

from sparkrdma_tpu_torch import faults as _faults

#: Bumped whenever a frame's meaning changes incompatibly. The server
#: rejects a ``hello`` carrying any other version with a non-retryable
#: error, so a mixed-version pair fails fast instead of mid-job.
RPC_SCHEMA_VERSION = 1

#: Every key a request envelope carries (client → server). ``args`` is
#: the per-op payload dict; ``req_id`` is the idempotency token — a
#: retried call re-sends the SAME id so the server can replay the
#: cached reply instead of applying a mutation twice.
REQUEST_FIELDS = frozenset({
    "op", "req_id", "client", "schema", "args",
})

#: Every key a reply envelope carries (server → client). ``retryable``
#: marks server-reported errors the client may usefully re-issue;
#: transport-level failures (connection drop, CRC mismatch) are always
#: retried regardless.
REPLY_FIELDS = frozenset({
    "ok", "req_id", "schema", "value", "error", "retryable",
})

#: The full op vocabulary — the server's handler table and the client's
#: call sites are both pinned against this set by rpc-schema-sync.
OPS = frozenset({
    # lease lifecycle
    "hello", "heartbeat", "goodbye",
    # tenant + session surface (mirrors ShuffleService)
    "register_tenant", "open_session", "close_session",
    # the five-method SPI, by value over the wire
    "register_shuffle", "unregister_shuffle", "write", "read",
    "resume_read",
    # admission tickets + quota/usage state
    "admit", "release",
    # introspection
    "locate", "usage", "stats", "leases",
})

#: Every key of a ``{"kind": "lease"}`` journal line (schema v14) AND
#: of a lease-table row served by the ``leases`` op — one vocabulary,
#: so ``shuffle_top``'s lease view reads the same fields either way.
LEASE_FIELDS = frozenset({
    "kind", "schema", "ts", "event", "client", "tenant", "sessions",
    "age_s", "ttl_s", "detail",
})

#: Refuse frames larger than this before allocating — a corrupted
#: length prefix must not look like a 4 GiB read.
MAX_FRAME_BYTES = 64 << 20

_HEADER = struct.Struct(">II")


class FrameError(Exception):
    """A frame failed structural validation (CRC, length, JSON).

    Always safe to retry: the receiver drops the connection rather
    than resynchronise mid-stream, and the sender's idempotent
    ``req_id`` makes the re-issued call apply-once.
    """


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, obj: dict) -> None:
    """Serialise ``obj`` and write one frame.

    Fault site ``rpc.send``: ``fail`` raises ConnectionError before any
    byte is written (the frame never half-sends); ``corrupt`` mangles
    the payload AFTER the CRC is computed, so the receiver detects it.
    """
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameError(f"frame too large: {len(payload)} bytes")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    verdict = _faults.fire("rpc.send")
    if verdict == "fail":
        raise ConnectionError("injected: rpc.send")
    if verdict == "corrupt":
        payload = _faults.mangle(payload)
    sock.sendall(_HEADER.pack(len(payload), crc) + payload)


def recv_frame(sock: socket.socket) -> dict:
    """Read one frame and return the decoded dict.

    Fault site ``rpc.recv``: ``fail`` raises ConnectionError after the
    read (the bytes are gone, as with a real drop); ``corrupt`` mangles
    the received payload BEFORE the CRC check, which then rejects it.
    """
    length, crc = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds cap")
    payload = _recv_exact(sock, length)
    verdict = _faults.fire("rpc.recv")
    if verdict == "fail":
        raise ConnectionError("injected: rpc.recv")
    if verdict == "corrupt":
        payload = _faults.mangle(payload)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("frame CRC mismatch")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"frame payload undecodable: {e}") from None
    if not isinstance(obj, dict):
        raise FrameError("frame payload is not an object")
    return obj


__all__ = [
    "RPC_SCHEMA_VERSION", "REQUEST_FIELDS", "REPLY_FIELDS", "OPS",
    "LEASE_FIELDS", "MAX_FRAME_BYTES", "FrameError", "send_frame",
    "recv_frame",
]
