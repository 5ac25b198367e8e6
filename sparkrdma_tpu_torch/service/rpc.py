"""The shuffle service's network front door — the port's copy of
``sparkrdma_tpu.service.rpc``, a crash-tolerant RPC server.

:class:`~sparkrdma_tpu_torch.service.daemon.ShuffleService` admits
callers in its own process; :class:`RpcServer` serves the same sessions
to other processes on ``127.0.0.1``, behind the
:mod:`~sparkrdma_tpu_torch.service.wire` frame protocol, with the
failure story that makes it a service:

- **Leases.** Every client is admitted by ``hello`` under a lease of
  ``conf.lease_s`` seconds, renewed implicitly by any request and
  explicitly by ``heartbeat``. An expired lease is reaped exactly like
  a clean ``close_session``: outstanding admission tickets returned,
  tenant charges released, shuffles dropped — and a schema-v14
  ``{"kind": "lease"}`` journal line records the event. A SIGKILLed
  client therefore cannot pin quota forever.
- **Idempotent mutations.** Replies are cached per ``(client,
  req_id)``; a retried call (same id) replays the cached reply instead
  of applying the mutation twice, so the client may retry *every*
  transport failure blindly.
- **Rolling restart.** The daemon keeps no durable state of its own —
  sessions are re-opened by clients, and finished stages live in the
  spill store. ``read`` with ``checkpoint=True`` persists the exchange
  output (``checkpoint_segments``), and a relaunched daemon adopts it
  with ``resume_segments`` (the ``resume_read`` op), so an in-flight job
  completes without exchanging finished stages again.

The data plane stays in the daemon: ``write``/``read`` move host rows by
value (JSON lists of unsigned 32-bit words, as the reference's) over the
control socket, and the exchange runs on the daemon's card — adequate
for the control-plane sizes this wire carries, and it keeps every torch
and CUDA dependency on the server side.

Leases are timed on :func:`_clock` (``time.monotonic``), which the tests
replace to drive an expiry without sleeping.

Threading: one accept loop (which also ticks the lease reaper) plus
one handler thread per connection; ``_lock`` guards the lease/reply
tables, and blocking SPI work always runs outside it.
"""

from __future__ import annotations

import collections
import logging
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION
from sparkrdma_tpu_torch.service.wire import (LEASE_FIELDS, OPS,
                                        RPC_SCHEMA_VERSION, FrameError,
                                        recv_frame, send_frame)

log = logging.getLogger("sparkrdma_tpu_torch.service.rpc")

_ACCEPT_POLL_S = 0.25      # accept timeout; also the lease-reap cadence
_CONN_POLL_S = 0.5         # per-connection recv timeout (stop checks)
_REPLY_CACHE = 64          # replayable replies retained per client


def _clock() -> float:
    """The lease clock (monotonic seconds)."""
    return time.monotonic()


def lease_line(event: str, client: str, tenant: str = "",
               sessions: int = 0, age_s: float = 0.0,
               ttl_s: float = 0.0, detail: str = "") -> dict:
    """Build one ``{"kind": "lease"}`` journal line (schema v14).

    ``event`` is ``grant`` / ``expire`` / ``close`` / ``adopt`` for
    journal lines, plus ``live`` / ``stale`` for the rows the
    ``leases`` op serves to ``shuffle_top`` — one vocabulary either
    way. The drift check is a plain RuntimeError (not an assert) so it
    survives ``python -O``.
    """
    line = {
        "kind": "lease",
        "schema": SCHEMA_VERSION,
        "ts": time.time(),
        "event": event,
        "client": client,
        "tenant": tenant,
        "sessions": int(sessions),
        "age_s": round(float(age_s), 3),
        "ttl_s": round(float(ttl_s), 3),
        "detail": detail,
    }
    if set(line) != LEASE_FIELDS:
        raise RuntimeError("lease line drifted from LEASE_FIELDS")
    return line


class _Session:
    """One tenant session opened over the wire."""

    __slots__ = ("sid", "tenant", "manager", "shuffles")

    def __init__(self, sid: str, tenant: str, manager):
        self.sid = sid
        self.tenant = tenant
        self.manager = manager
        self.shuffles: Dict[int, object] = {}   # shuffle_id -> handle


class _Lease:
    """Per-client liveness + everything reaped when it lapses."""

    __slots__ = ("client", "granted", "renewed", "ttl_s", "sessions",
                 "tickets", "replies")

    def __init__(self, client: str, now: float, ttl_s: float):
        self.client = client
        self.granted = now
        self.renewed = now
        self.ttl_s = ttl_s
        self.sessions: Dict[str, _Session] = {}
        self.tickets: Dict[str, object] = {}    # ticket_id -> _Ticket
        self.replies = collections.OrderedDict()  # req_id -> reply

    def expired(self, now: float) -> bool:
        return self.ttl_s > 0 and (now - self.renewed) > self.ttl_s

    def tenant(self) -> str:
        for s in self.sessions.values():
            return s.tenant
        return ""


#: op -> handler method, one per ``wire.OPS`` entry
_HANDLERS = {
    "hello": "_op_hello",
    "heartbeat": "_op_heartbeat",
    "goodbye": "_op_goodbye",
    "register_tenant": "_op_register_tenant",
    "open_session": "_op_open_session",
    "close_session": "_op_close_session",
    "register_shuffle": "_op_register_shuffle",
    "unregister_shuffle": "_op_unregister_shuffle",
    "write": "_op_write",
    "read": "_op_read",
    "resume_read": "_op_resume_read",
    "admit": "_op_admit",
    "release": "_op_release",
    "locate": "_op_locate",
    "usage": "_op_usage",
    "stats": "_op_stats",
    "leases": "_op_leases",
}


class RpcError(Exception):
    """Raised by handlers: becomes an ``ok=false`` reply."""

    def __init__(self, message: str, retryable: bool = False):
        super().__init__(message)
        self.retryable = retryable


class RpcServer:
    """Serve one :class:`ShuffleService` over the wire protocol.

    ``port`` 0 binds an ephemeral port (read ``self.port`` back);
    sockets and threads are owned here — ``stop()`` joins everything
    and closes every connection, but deliberately does NOT reap live
    leases: a restarting daemon wants its clients to reconnect, not to
    have their quota charges torn down twice.
    """

    def __init__(self, service, port: int = 0,
                 lease_s: Optional[float] = None):
        self._svc = service
        self._lease_s = (service.conf.lease_s if lease_s is None
                         else float(lease_s))
        self._lock = threading.Lock()
        self._leases: Dict[str, _Lease] = {}    # guarded-by: _lock
        self._next_sid = 0                      # guarded-by: _lock
        self._next_ticket = 0                   # guarded-by: _lock
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind(("127.0.0.1", port))
            self._sock.listen(16)
        except OSError:
            self._sock.close()
            raise
        self._sock.settimeout(_ACCEPT_POLL_S)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._accept_loop, name="sparkrdma-rpc", daemon=True)
        self._conns: list = []                  # guarded-by: _lock

    # --- lifecycle ----------------------------------------------------
    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn, th in conns:
            try:
                conn.close()
            except OSError:
                pass
            th.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass

    # --- accept loop + lease reaper -----------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            self._reap_expired()
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(_CONN_POLL_S)
            # joined from stop() through the _conns list
            th = threading.Thread(target=self._serve_conn,
                                  args=(conn,),
                                  name="sparkrdma-rpc-conn", daemon=True)
            with self._lock:
                self._conns.append((conn, th))
            th.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except socket.timeout:
                    continue
                except FrameError:
                    # framing is unrecoverable mid-stream: count it and
                    # drop the connection; the client reconnects and
                    # replays by req_id
                    self._svc.metrics.counter("service.rpc.errors").inc()
                    break
                except (ConnectionError, OSError):
                    break
                reply = self._dispatch(req)
                try:
                    send_frame(conn, reply)
                except (ConnectionError, OSError):
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _reap_expired(self) -> None:
        now = _clock()
        with self._lock:
            lapsed = [l for l in self._leases.values() if l.expired(now)]
            for l in lapsed:
                del self._leases[l.client]
        for l in lapsed:
            self._svc.metrics.counter("service.leases_expired").inc()
            self._reap(l, "expire", now)

    def _reap(self, lease: _Lease, event: str, now: float,
              detail: str = "") -> None:
        """Tear a lease down exactly like a clean ``close_session``."""
        for ticket in lease.tickets.values():
            try:
                ticket.release()
            except Exception:
                log.warning("ticket release failed during %s of %s",
                            event, lease.client, exc_info=True)
        lease.tickets.clear()
        tenant = lease.tenant()
        sessions = len(lease.sessions)
        for sess in lease.sessions.values():
            try:
                self._svc.close_session(sess.manager)
            except Exception:
                log.warning("session close failed during %s of %s",
                            event, lease.client, exc_info=True)
        lease.sessions.clear()
        self._emit_lease(event, lease.client, tenant=tenant,
                         sessions=sessions,
                         age_s=now - lease.granted, detail=detail)

    def _emit_lease(self, event: str, client: str, tenant: str = "",
                    sessions: int = 0, age_s: float = 0.0,
                    ttl_s: float = 0.0, detail: str = "") -> None:
        try:
            self._svc.journal.emit_raw(lease_line(
                event, client, tenant=tenant, sessions=sessions,
                age_s=age_s, ttl_s=ttl_s, detail=detail))
        except Exception:
            # journal failure never takes the control plane down
            log.warning("lease journal emit failed", exc_info=True)

    # --- dispatch ------------------------------------------------------
    def _reply(self, req_id: str, ok: bool, value=None, error: str = "",
               retryable: bool = False) -> dict:
        # the one reply literal — pinned against wire.REPLY_FIELDS
        return {
            "ok": bool(ok),
            "req_id": req_id,
            "schema": RPC_SCHEMA_VERSION,
            "value": value,
            "error": error,
            "retryable": bool(retryable),
        }

    def _dispatch(self, req: dict) -> dict:
        self._svc.metrics.counter("service.rpc.requests").inc()
        req_id = str(req.get("req_id", ""))
        op = req.get("op")
        client = str(req.get("client", ""))
        if (op not in OPS or not client or not req_id
                or not isinstance(req.get("args"), dict)):
            self._svc.metrics.counter("service.rpc.errors").inc()
            return self._reply(req_id, False, error="bad-request")
        if req.get("schema") != RPC_SCHEMA_VERSION:
            self._svc.metrics.counter("service.rpc.errors").inc()
            return self._reply(
                req_id, False,
                error=f"schema-mismatch: client {req.get('schema')} "
                      f"!= server {RPC_SCHEMA_VERSION}")
        now = _clock()
        with self._lock:
            lease = self._leases.get(client)
            if lease is not None:
                cached = lease.replies.get(req_id)
                if cached is not None:
                    self._svc.metrics.counter(
                        "service.rpc.replays").inc()
                    return cached
                lease.renewed = now     # any request renews the lease
        if lease is None and op not in ("hello", "leases", "stats"):
            return self._reply(req_id, False, error="unknown-client")
        try:
            value = getattr(self, _HANDLERS[op])(client, req["args"])
            reply = self._reply(req_id, True, value=value)
        except RpcError as e:
            self._svc.metrics.counter("service.rpc.errors").inc()
            reply = self._reply(req_id, False, error=str(e),
                                retryable=e.retryable)
        except Exception as e:
            self._svc.metrics.counter("service.rpc.errors").inc()
            log.warning("rpc op %s failed", op, exc_info=True)
            reply = self._reply(
                req_id, False, error=f"{type(e).__name__}: {e}")
        with self._lock:
            lease = self._leases.get(client)
            if lease is not None:
                lease.replies[req_id] = reply
                while len(lease.replies) > _REPLY_CACHE:
                    lease.replies.popitem(last=False)
        return reply

    # --- helpers -------------------------------------------------------
    def _lease_of(self, client: str) -> _Lease:
        with self._lock:
            lease = self._leases.get(client)
        if lease is None:
            raise RpcError("unknown-client")
        return lease

    def _session_of(self, client: str, args: dict) -> _Session:
        lease = self._lease_of(client)
        sess = lease.sessions.get(str(args.get("session", "")))
        if sess is None:
            raise RpcError("unknown-session")
        return sess

    # --- lease ops -----------------------------------------------------
    def _op_hello(self, client: str, args: dict):
        now = _clock()
        with self._lock:
            lease = self._leases.get(client)
            fresh = lease is None
            if fresh:
                lease = _Lease(client, now, self._lease_s)
                self._leases[client] = lease
            else:
                lease.renewed = now
        if fresh:
            self._svc.metrics.counter("service.leases_granted").inc()
            self._emit_lease("grant", client, ttl_s=self._lease_s)
        return {"lease_s": self._lease_s, "fresh": fresh}

    def _op_heartbeat(self, client: str, args: dict):
        lease = self._lease_of(client)
        now = _clock()
        lease.renewed = now
        self._svc.metrics.counter("service.leases_renewed").inc()
        return {"ttl_s": lease.ttl_s, "age_s": now - lease.granted}

    def _op_goodbye(self, client: str, args: dict):
        now = _clock()
        with self._lock:
            lease = self._leases.pop(client, None)
        if lease is not None:
            self._reap(lease, "close", now)
        return {"closed": lease is not None}

    # --- tenant + session surface --------------------------------------
    def _op_register_tenant(self, client: str, args: dict):
        name = str(args.get("tenant", ""))
        if not name:
            raise RpcError("tenant name required")
        self._svc.register_tenant(name)
        return {"tenant": name}

    def _op_open_session(self, client: str, args: dict):
        tenant = str(args.get("tenant", ""))
        if not tenant:
            raise RpcError("tenant name required")
        lease = self._lease_of(client)
        manager = self._svc.open_session(tenant)
        with self._lock:
            self._next_sid += 1
            sid = f"s{self._next_sid}"
        lease.sessions[sid] = _Session(sid, tenant, manager)
        return {"session": sid}

    def _op_close_session(self, client: str, args: dict):
        lease = self._lease_of(client)
        sess = lease.sessions.pop(str(args.get("session", "")), None)
        if sess is not None:
            self._svc.close_session(sess.manager)
        return {"closed": sess is not None}

    # --- the SPI, by value ---------------------------------------------
    def _op_register_shuffle(self, client: str, args: dict):
        from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
        sess = self._session_of(client, args)
        sid = int(args["shuffle_id"])
        # 0 (the client default) means "the daemon's mesh width" — the
        # client usually doesn't know the geometry before this reply
        num_parts = (int(args.get("num_parts", 0))
                     or sess.manager.runtime.num_partitions)
        if str(args.get("partitioner", "hash")) != "hash":
            raise RpcError("only the 'hash' partitioner crosses "
                           "the wire")
        part = hash_partitioner(num_parts, sess.manager.conf.key_words)
        sess.shuffles[sid] = sess.manager.register_shuffle(
            sid, num_parts, part)
        return {"shuffle_id": sid, "num_parts": num_parts}

    def _op_unregister_shuffle(self, client: str, args: dict):
        sess = self._session_of(client, args)
        sid = int(args["shuffle_id"])
        sess.shuffles.pop(sid, None)
        sess.manager.unregister_shuffle(sid)
        return {"shuffle_id": sid}

    def _op_write(self, client: str, args: dict):
        sess = self._session_of(client, args)
        sid = int(args["shuffle_id"])
        handle = sess.shuffles.get(sid)
        if handle is None:
            raise RpcError(f"shuffle {sid} not registered")
        m = sess.manager
        rows = np.asarray(args["rows"], dtype=np.uint32)
        m.get_writer(handle).write(
            m.runtime.shard_records(rows)).stop(True)
        return {"rows": int(rows.shape[0])}

    def _op_read(self, client: str, args: dict):
        sess = self._session_of(client, args)
        sid = int(args["shuffle_id"])
        handle = sess.shuffles.get(sid)
        if handle is None:
            raise RpcError(f"shuffle {sid} not registered")
        m = sess.manager
        records, totals = m.get_reader(handle).read()
        # the card's int32 word views as the reference's uint32 words
        cols = records.cpu().numpy().view(np.uint32)
        tots = totals.cpu().numpy()
        if bool(args.get("checkpoint", False)):
            # persist the exchange OUTPUT (plan=None) so a relaunched
            # daemon can adopt it via resume_segments instead of
            # re-running the exchange — the rolling-restart path
            m.checkpoint_segments(
                sid,
                [(f"rpc{sid}:cols", cols), (f"rpc{sid}:totals", tots)],
                plan=None, num_parts=m.runtime.num_partitions,
                extra_meta={"rpc_output": True})
        return {"rows": cols.tolist(), "totals": tots.tolist()}

    def _op_resume_read(self, client: str, args: dict):
        sess = self._session_of(client, args)
        sid = int(args["shuffle_id"])
        m = sess.manager
        adopted = m.resume_segments(sid)
        try:
            cols = np.asarray(m.tiered.get(f"rpc{sid}:cols"))
            tots = np.asarray(m.tiered.get(f"rpc{sid}:totals"))
        except KeyError:
            raise RpcError(f"no checkpointed output for shuffle {sid}")
        lease = self._lease_of(client)
        now = _clock()
        self._emit_lease(
            "adopt", client, tenant=sess.tenant,
            sessions=len(lease.sessions), age_s=now - lease.granted,
            ttl_s=lease.ttl_s,
            detail=f"sid={sid} adopted={len(adopted)}")
        return {"rows": cols.tolist(), "totals": tots.tolist(),
                "adopted": sorted(str(k) for k in adopted)}

    # --- admission tickets + quota state -------------------------------
    def _op_admit(self, client: str, args: dict):
        lease = self._lease_of(client)
        tenant = str(args.get("tenant", ""))
        if not tenant:
            raise RpcError("tenant name required")
        ticket = self._svc.admission.admit(
            tenant, int(args.get("cost", 1)))
        with self._lock:
            self._next_ticket += 1
            tid = f"t{self._next_ticket}"
        lease.tickets[tid] = ticket
        return {"ticket": tid}

    def _op_release(self, client: str, args: dict):
        lease = self._lease_of(client)
        ticket = lease.tickets.pop(str(args.get("ticket", "")), None)
        if ticket is not None:
            ticket.release()
        return {"released": ticket is not None}

    # --- introspection --------------------------------------------------
    def _op_locate(self, client: str, args: dict):
        prefix = str(args.get("prefix", ""))
        store = self._svc.tiered
        out = {}
        for key in store.keys():
            k = str(key)
            if k.startswith(prefix):
                out[k] = store.tier_of(key)
        return out

    def _op_usage(self, client: str, args: dict):
        return self._svc.usage_by_tenant()

    def _op_stats(self, client: str, args: dict):
        st = self._svc.stats()
        return {"tenants": st["tenants"], "sessions": st["sessions"],
                "admission": st["admission"]}

    def _op_leases(self, client: str, args: dict):
        now = _clock()
        with self._lock:
            leases = list(self._leases.values())
        rows = []
        for l in leases:
            remaining = (l.ttl_s - (now - l.renewed)
                         if l.ttl_s > 0 else float("inf"))
            rows.append(lease_line(
                "live" if not l.expired(now) else "stale",
                l.client, tenant=l.tenant(),
                sessions=len(l.sessions), age_s=now - l.granted,
                ttl_s=max(0.0, remaining) if l.ttl_s > 0 else 0.0,
                detail=f"tickets={len(l.tickets)}"))
        return rows


__all__ = ["RpcServer", "RpcError", "lease_line"]
