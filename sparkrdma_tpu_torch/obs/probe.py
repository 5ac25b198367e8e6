"""Wire-reachable probe endpoint — the port's copy of
``sparkrdma_tpu.obs.probe``, with the same routes and bodies.

:class:`ProbeServer` is a small stdlib TCP server, started by
:class:`~sparkrdma_tpu_torch.service.daemon.ShuffleService` and by a
standalone :class:`~sparkrdma_tpu_torch.api.shuffle_manager.ShuffleManager`
when ``ShuffleConf.probe_port`` is 0 or more. It binds ``127.0.0.1``
only and serves read-only snapshots; the reference's
``scripts/shuffle_top.py --connect`` reads it.

Wire format (line-oriented, netcat-friendly)::

    client:  GET <path>\\n          (the "GET " prefix is optional)
    server:  <UTF-8 body> ... EOF   (connection closed = end of body)

paths:

- ``/journal``  — JSON array of this process's journal entries (all
  rotated segments), exactly what the file-based CLIs read; this is
  what makes ``shuffle_top --connect`` render byte-identical tables.
  The body is **streamed entry-by-entry** (one array element per line)
  rather than materialized, so a long-running daemon's probe stays
  bounded-memory however large the journal grows — the wire payload is
  still one valid JSON array.
- ``/jobs``     — recent ``{"kind": "job"}`` trace summaries
  (obs/trace.py JOB_FIELDS lines): ``{"served_at_s", "uptime_s",
  "jobs": [...]}``, newest last. Served from the TelemetryStore's
  per-job history rings when wired, else recovered by scanning the
  journal — so the route works for daemons and standalone managers
  alike.
- ``/snapshot`` — JSON object: heartbeat identity, TelemetryStore
  state (:meth:`~sparkrdma_tpu_torch.obs.tsdb.TelemetryStore.stats`), live
  (open-window) rollup cells, per-tenant usage.
- ``/metrics``  — Prometheus-style text exposition of the registry
  (dots become underscores; histograms export ``_count``/``_sum``).
- ``/alerts``   — the alert evaluator's currently-active alerts
  (obs/alerts.py line dicts), empty when no evaluator is wired.
- ``/health``   — the evaluator's worst-active-severity verdict:
  ``{"status", "score", "active", "subsystems"}`` (``status: "ok"``
  without an evaluator — absence of alerting is not unhealth).

``/snapshot``, ``/alerts`` and ``/health`` all carry ``served_at_s`` (a
``time.monotonic()`` reading) and ``uptime_s`` (seconds since this
server started) so wire consumers can compute staleness between polls
of the same daemon without trusting either side's wall clock.

Isolation contract: probe serving never touches shuffle state — every
route reads an immutable snapshot (journal file, registry snapshot,
store ring copies) — so a wedged, slow, or killed client can never
block a read. Each connection is handled inline on the single accept
thread with short timeouts; client death mid-response is swallowed and
counted (``probe.errors``). ``stop()`` closes the listening socket and
joins the thread — no leaked threads or sockets.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("sparkrdma_tpu_torch.probe")

#: accept-loop poll period — how quickly stop() is observed (seconds)
_ACCEPT_POLL_S = 0.25
#: per-connection socket timeout: a client must send its request line
#: and drain the response within this budget or the connection drops
_CONN_TIMEOUT_S = 5.0
#: longest request line accepted (a path, not a payload)
_MAX_REQUEST = 1024


def _prometheus_text(snapshot: Dict) -> str:
    """Render a registry snapshot as Prometheus exposition text.

    Scalar entries (counters, gauges, gauge high-waters) become plain
    samples; histogram sub-dicts export ``_count`` / ``_sum``. Metric
    names swap ``.`` for ``_`` per the exposition grammar.
    """
    lines: List[str] = []
    for name in sorted(snapshot):
        value = snapshot[name]
        flat = name.replace(".", "_").replace("-", "_")
        if isinstance(value, dict):
            count = value.get("count")
            total = value.get("sum")
            if count is None:
                continue
            lines.append(f"# TYPE {flat} summary")
            lines.append(f"{flat}_count {count}")
            if total is not None:
                lines.append(f"{flat}_sum {total}")
        elif isinstance(value, (int, float)):
            lines.append(f"# TYPE {flat} gauge")
            lines.append(f"{flat} {value}")
    return "\n".join(lines) + "\n"


class ProbeServer:
    """Read-only TCP snapshot server (see module docstring).

    All data sources are optional callables/objects so the server works
    identically under the multi-tenant daemon and a standalone manager;
    absent sources serve empty sections rather than errors.
    """

    def __init__(self, port: int, *, metrics=None, telemetry=None,
                 identity: Optional[Dict] = None,
                 journal_path: str = "",
                 rollups: Optional[Callable[[], List[Dict]]] = None,
                 tenants: Optional[Callable[[], Dict]] = None,
                 alerts: Optional[Callable[[], List[Dict]]] = None,
                 health: Optional[Callable[[], Dict]] = None,
                 jobs: Optional[Callable[[], List[Dict]]] = None):
        self._metrics = metrics
        self._telemetry = telemetry
        self._identity = dict(identity or {})
        self._journal_path = journal_path
        self._rollups = rollups
        self._tenants = tenants
        self._alerts = alerts
        self._health = health
        self._jobs = jobs
        self._started_mono = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
            # loopback only: the probe serves whoever can connect
            self._sock.bind(("127.0.0.1", port))
            self._sock.listen(8)
            self._sock.settimeout(_ACCEPT_POLL_S)
        except Exception:
            self._sock.close()   # never leak the half-built socket
            raise
        #: the actually-bound port (differs from the request when the
        #: conf asked for 0 = ephemeral)
        self.port = self._sock.getsockname()[1]
        self.host = "127.0.0.1"

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._serve, name="sparkrdma-probe", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._sock.close()

    def __enter__(self) -> "ProbeServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving ------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break            # listening socket closed under us
            try:
                self._handle(conn)
            except Exception:
                # a client can die at any byte; that is its problem,
                # never the shuffle's — count it and keep serving
                if self._metrics is not None:
                    self._metrics.counter("probe.errors").inc()
                log.debug("probe connection failed", exc_info=True)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(_CONN_TIMEOUT_S)
        buf = b""
        while b"\n" not in buf and len(buf) < _MAX_REQUEST:
            chunk = conn.recv(256)
            if not chunk:
                break
            buf += chunk
        line = buf.split(b"\n", 1)[0].decode("utf-8", "replace").strip()
        if line.upper().startswith("GET "):
            line = line[4:].strip()
        if self._metrics is not None:
            self._metrics.counter("probe.requests").inc()
        path = line or "/snapshot"
        if path == "/journal":
            # bounded-memory path: the journal can be arbitrarily large,
            # so entries stream one line at a time instead of being
            # materialized (plus rotated segments) as one string
            self._stream_journal(conn)
            return
        body = self._route(path)
        conn.sendall(body.encode("utf-8"))

    def _stream_journal(self, conn: socket.socket) -> None:
        """Stream ``/journal`` entry-by-entry as ONE valid JSON array
        (``shuffle_top --connect`` json.loads the whole body), holding
        at most one entry in memory at a time."""
        from sparkrdma_tpu_torch.obs.journal import iter_entries
        conn.sendall(b"[")
        first = True
        if self._journal_path:
            try:
                for entry in iter_entries(self._journal_path,
                                          include_rotated=True):
                    sep = b"\n" if first else b",\n"
                    conn.sendall(sep + json.dumps(
                        entry, separators=(",", ":")).encode("utf-8"))
                    first = False
            except OSError:
                # the journal sink is lazy — no file until the first
                # emit; an empty process legitimately serves []
                pass
        conn.sendall(b"]" if first else b"\n]")

    def _route(self, path: str) -> str:
        if path == "/journal":
            return json.dumps(self._journal_entries())
        if path == "/metrics":
            snap = (self._metrics.snapshot()
                    if self._metrics is not None else {})
            return _prometheus_text(snap)
        if path == "/snapshot":
            return json.dumps(self._snapshot())
        if path == "/alerts":
            alerts = self._alerts() if self._alerts is not None else []
            return json.dumps(dict(self._staleness(), alerts=alerts))
        if path == "/health":
            health = (self._health() if self._health is not None
                      else {"status": "ok", "score": 100, "active": 0,
                            "subsystems": {}})
            return json.dumps(dict(self._staleness(), **health))
        if path == "/jobs":
            return json.dumps(dict(self._staleness(),
                                   jobs=self._job_lines()))
        return json.dumps({"error": f"unknown path {path!r}",
                           "paths": ["/journal", "/jobs", "/snapshot",
                                     "/metrics", "/alerts",
                                     "/health"]})

    def _journal_entries(self) -> List[Dict]:
        if not self._journal_path:
            return []
        # local import: probe is stdlib-only and journal is too, but
        # keeping the dependency one-way at import time avoids cycles
        from sparkrdma_tpu_torch.obs.journal import read_entries
        try:
            return read_entries(self._journal_path, include_rotated=True)
        except OSError:
            # the journal sink is lazy — no file until the first emit;
            # an empty process legitimately serves an empty array
            return []

    def _job_lines(self) -> List[Dict]:
        """Recent job-trace summaries: the wired ``jobs`` source (the
        TelemetryStore's per-job rings) when it has any, else a journal
        scan — a standalone manager with telemetry off still serves its
        closed jobs."""
        if self._jobs is not None:
            lines = list(self._jobs())
            if lines:
                return lines
        if not self._journal_path:
            return []
        from sparkrdma_tpu_torch.obs.journal import iter_entries
        try:
            return [e for e in iter_entries(self._journal_path,
                                            include_rotated=True)
                    if e.get("kind") == "job"]
        except OSError:
            return []

    def _staleness(self) -> Dict:
        """Monotonic serving-time stamps — lets a wire consumer compute
        poll-to-poll staleness of ONE daemon without trusting wall
        clocks (monotonic readings are only comparable within a single
        server process; ``uptime_s`` restarting at 0 is the restart
        signal)."""
        now = time.monotonic()
        return {
            "served_at_s": round(now, 6),
            "uptime_s": round(now - self._started_mono, 6),
        }

    def _snapshot(self) -> Dict:
        telemetry = (self._telemetry.stats()
                     if self._telemetry is not None else {})
        rollups = self._rollups() if self._rollups is not None else []
        tenants = self._tenants() if self._tenants is not None else {}
        return dict(self._staleness(), **{
            "identity": self._identity,
            "telemetry": telemetry,
            "rollups": rollups,
            "tenants": tenants,
        })


__all__ = ["ProbeServer"]
