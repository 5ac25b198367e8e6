"""Retrying RPC client for the external shuffle service — the port's
copy of ``sparkrdma_tpu.service.client``.

:class:`RpcClient` exposes the daemon's session surface over the
:mod:`~sparkrdma_tpu_torch.service.wire` protocol and carries the robustness
contract of this layer, so callers never hand-roll retry loops:

- **Backoff + deadline.** Every call retries transport failures
  (connection refused/dropped, CRC-mismatched frames, recv timeouts)
  under exponential backoff with deterministic jitter — the
  :func:`sparkrdma_tpu_torch.faults.backoff_ms` helper, jittered by the
  client id so two clients never thunder in lockstep — bounded by a
  wall-clock deadline (``conf.rpc_deadline_s``), which converts a
  persistent outage into ONE clean :class:`RpcCallError` instead of a
  hang.
- **Idempotent request ids.** A retried call re-sends the SAME
  ``req_id``; the server replays the cached reply for an id it has
  already applied, so a mutation that raced a connection drop is
  applied exactly once.
- **Lease upkeep.** ``hello()`` admits the client under the server's
  lease; :meth:`start_heartbeat` renews it from a background thread
  (its own logical calls, serialized on the shared socket lock). A
  server restart invalidates the lease — any op answered with
  ``unknown-client`` triggers one automatic re-``hello`` before the
  retry, so a rolling daemon restart looks like a slow call, not an
  error.

Accounting mirrors the fetch-retry idiom: every retried transport
failure increments ``service.rpc.retries`` (process-global registry),
so a chaos schedule on ``rpc.send``/``rpc.recv`` balances its books —
hard injections == retries + recoveries — as the reader's retry loop
balances the exchange sites'.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import zlib
from typing import Optional

from sparkrdma_tpu_torch import faults as _faults
from sparkrdma_tpu_torch.obs.metrics import global_registry
from sparkrdma_tpu_torch.service.wire import (RPC_SCHEMA_VERSION, FrameError,
                                        recv_frame, send_frame)

#: per-attempt socket timeout — a dead-but-connected daemon surfaces
#: as a retryable timeout instead of pinning the call forever
_SOCK_TIMEOUT_S = 10.0


class RpcCallError(Exception):
    """A call failed terminally: server-reported error or deadline."""

    def __init__(self, message: str, retryable: bool = False):
        super().__init__(message)
        self.retryable = retryable


class RpcClient:
    """One client identity talking to one daemon address.

    Thread-safe: all calls serialize on an internal lock (one socket,
    strict request/reply). ``client_id`` is the lease key — it must
    stay stable across reconnects, and SHOULD stay stable across a
    client process restart only if the caller wants to re-adopt the
    old lease.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 client_id: str = "", retry_ms: float = 25.0,
                 deadline_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.client_id = client_id or (
            f"c{os.getpid()}-{os.urandom(3).hex()}")
        self.retry_ms = float(retry_ms)
        self.deadline_s = float(deadline_s)
        self.lease_s = 0.0          # learned from hello()
        self.stats = {"calls": 0, "retries": 0}
        self._span = zlib.crc32(self.client_id.encode()) & 0xFFFFFFFF
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._next_req = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    @classmethod
    def from_conf(cls, conf, host: str = "127.0.0.1",
                  port: Optional[int] = None,
                  client_id: str = "") -> "RpcClient":
        """Build a client from the service knobs of a ShuffleConf."""
        return cls(host=host,
                   port=conf.rpc_port if port is None else port,
                   client_id=client_id,
                   retry_ms=conf.rpc_retry_ms,
                   deadline_s=conf.rpc_deadline_s)

    # --- transport -----------------------------------------------------
    def _ensure_connected(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=_SOCK_TIMEOUT_S)
            s.settimeout(_SOCK_TIMEOUT_S)
            self._sock = s
        return self._sock

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, op: str, **args):
        """One logical call: retried, deadlined, idempotent."""
        with self._lock:
            self._next_req += 1
            req_id = f"{self.client_id}:{self._next_req}"
        # the one request literal — pinned against wire.REQUEST_FIELDS
        req = {
            "op": op,
            "req_id": req_id,
            "client": self.client_id,
            "schema": RPC_SCHEMA_VERSION,
            "args": args,
        }
        global_registry().counter("service.rpc.calls").inc()
        self.stats["calls"] += 1
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s > 0 else None)
        attempt = 0
        rehelloed = False
        while True:
            attempt += 1
            try:
                # the lock intentionally spans the whole round trip:
                # one socket, strict request/reply — releasing it
                # between send and recv would interleave the heartbeat
                # thread's frames with this call's
                with self._lock:
                    sock = self._ensure_connected()
                    send_frame(sock, req)    # srlint: ignore[blocking-under-lock]
                    reply = recv_frame(sock)  # srlint: ignore[blocking-under-lock]
                if reply.get("req_id") != req_id:
                    raise FrameError("reply/request id mismatch")
            except (ConnectionError, FrameError, socket.timeout,
                    OSError) as e:
                self._drop_connection()
                if deadline is not None and time.monotonic() >= deadline:
                    raise RpcCallError(
                        f"{op}: deadline {self.deadline_s}s exceeded "
                        f"after {attempt} attempts: {e}") from e
                global_registry().counter("service.rpc.retries").inc()
                self.stats["retries"] += 1
                self._backoff(attempt, deadline)
                continue
            if reply.get("ok"):
                return reply.get("value")
            error = str(reply.get("error", ""))
            if (error == "unknown-client" and not rehelloed
                    and op not in ("hello", "goodbye")):
                # the daemon restarted out from under our lease: one
                # automatic re-hello, then re-issue the SAME req_id
                rehelloed = True
                self.hello()
                continue
            if reply.get("retryable") and not (
                    deadline is not None
                    and time.monotonic() >= deadline):
                global_registry().counter("service.rpc.retries").inc()
                self.stats["retries"] += 1
                self._backoff(attempt, deadline)
                continue
            raise RpcCallError(f"{op}: {error}")

    def _backoff(self, attempt: int, deadline: Optional[float]) -> None:
        delay_ms = _faults.backoff_ms(attempt, self.retry_ms,
                                      span_id=self._span)
        if delay_ms <= 0:
            return
        if deadline is not None:
            delay_ms = min(delay_ms, max(
                (deadline - time.monotonic()) * 1e3, 0.0))
        time.sleep(delay_ms / 1e3)

    # --- lease lifecycle -----------------------------------------------
    def hello(self) -> dict:
        """Admit (or renew) this client's lease; learns ``lease_s``."""
        value = self._call("hello")
        self.lease_s = float(value.get("lease_s", 0.0))
        return value

    def heartbeat(self) -> dict:
        return self._call("heartbeat")

    def start_heartbeat(self, period_s: float = 0.0) -> None:
        """Renew the lease from a daemon thread every ``period_s``
        (default: a third of the server's lease — three missed beats
        and the lease lapses, matching the acceptance bound)."""
        if self._hb_thread is not None:
            return
        period = period_s or (self.lease_s / 3.0 if self.lease_s > 0
                              else 1.0)
        self._hb_stop.clear()

        def beat():
            while not self._hb_stop.wait(period):
                try:
                    self.heartbeat()
                except Exception:
                    # liveness upkeep must never kill the client; a
                    # truly dead daemon surfaces on the next real call
                    pass

        self._hb_thread = threading.Thread(
            target=beat, name="sparkrdma-rpc-heartbeat", daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=5.0)
        self._hb_thread = None

    def close(self) -> None:
        """Best-effort clean goodbye (releases the lease server-side)."""
        self.stop_heartbeat()
        try:
            self._call("goodbye")
        except Exception:
            pass
        self._drop_connection()

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- session surface -----------------------------------------------
    def register_tenant(self, tenant: str) -> dict:
        return self._call("register_tenant", tenant=tenant)

    def open_session(self, tenant: str) -> str:
        return self._call("open_session", tenant=tenant)["session"]

    def close_session(self, session: str) -> bool:
        return bool(self._call("close_session",
                               session=session)["closed"])

    def register_shuffle(self, session: str, shuffle_id: int,
                         num_parts: int = 0,
                         partitioner: str = "hash") -> dict:
        return self._call("register_shuffle", session=session,
                          shuffle_id=shuffle_id, num_parts=num_parts,
                          partitioner=partitioner)

    def unregister_shuffle(self, session: str, shuffle_id: int) -> dict:
        return self._call("unregister_shuffle", session=session,
                          shuffle_id=shuffle_id)

    def write(self, session: str, shuffle_id: int, rows) -> int:
        """Ship host rows (list-of-lists or array-like) to the daemon's
        writer; the device exchange runs in-daemon."""
        if hasattr(rows, "tolist"):
            rows = rows.tolist()
        return int(self._call("write", session=session,
                              shuffle_id=shuffle_id,
                              rows=rows)["rows"])

    def read(self, session: str, shuffle_id: int,
             checkpoint: bool = False) -> tuple:
        """Read the shuffle output back as (rows, totals) nested lists;
        ``checkpoint=True`` also persists it for rolling restart."""
        v = self._call("read", session=session, shuffle_id=shuffle_id,
                       checkpoint=checkpoint)
        return v["rows"], v["totals"]

    def resume_read(self, session: str, shuffle_id: int) -> dict:
        """Adopt a checkpointed exchange output after a daemon restart
        (PR-8 ``resume_segments`` path) without re-exchanging."""
        return self._call("resume_read", session=session,
                          shuffle_id=shuffle_id)

    # --- admission + introspection -------------------------------------
    def admit(self, tenant: str, cost: int = 1) -> str:
        return self._call("admit", tenant=tenant, cost=cost)["ticket"]

    def release(self, ticket: str) -> bool:
        return bool(self._call("release", ticket=ticket)["released"])

    def locate(self, prefix: str = "") -> dict:
        return self._call("locate", prefix=prefix)

    def usage(self) -> dict:
        return self._call("usage")

    def server_stats(self) -> dict:
        return self._call("stats")

    def leases(self) -> list:
        return self._call("leases")


__all__ = ["RpcClient", "RpcCallError"]
