"""The port's probe endpoint against the reference's.

A port :class:`ProbeServer` and a reference one, over the same journal
file (written by the port: spans, rollup, heartbeat, job and alert
lines), the same registry operations, the same telemetry samples and the
same callables, answer every route with the same body: ``/journal``
(streamed), ``/jobs``, ``/snapshot``, ``/metrics``, ``/alerts``,
``/health``, an unknown path and the empty request, with and without the
``GET`` prefix — apart from the ``served_at_s`` / ``uptime_s`` stamps,
which are each server's own clock. The reference's
``scripts/shuffle_top.py`` reads the port's probe in-process
(``--connect``) exactly as it reads the journal file, and a manager's
probe serves its live rollups, binds ``127.0.0.1`` only, survives a
failed bind and closes its socket on ``stop``.
"""

import importlib.util
import json
import logging
import socket
from pathlib import Path

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.obs import journal as pj
from sparkrdma_tpu_torch.obs import probe as pp
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.obs.tsdb import TelemetryStore

REPO = Path(__file__).resolve().parent.parent
STAMPS = ("served_at_s", "uptime_s")


def _top():
    spec = importlib.util.spec_from_file_location(
        "shuffle_top_port_probe", REPO / "scripts" / "shuffle_top.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fetch(port: int, request: str) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request.encode("utf-8"))
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return buf
            buf += chunk


def _journal(path):
    """A port journal of every line kind the probe and the CLIs read."""
    from sparkrdma_tpu_torch.obs.rollup import (HeartbeatEmitter,
                                                RollupAggregator)

    j = pj.ExchangeJournal(str(path))
    agg = RollupAggregator(j, window_s=10.0)
    for i in range(4):
        span = pj.ExchangeSpan(
            span_id=100 + i, shuffle_id=i % 2, tenant="a",
            transport="pallas_ring", rounds=2, dispatches=1, records=64,
            record_bytes=16, plan_s=0.001, exchange_s=0.002 * (i + 1),
            sort_s=0.0, per_peer_records=[8] * 8)
        j.emit(span)
        agg.observe(span, now=1000.0 + i)
    agg.flush(now=1010.0)
    HeartbeatEmitter(j, 1.0, identity={"host": "h", "pid": 1},
                     clock=lambda: 1011.0).beat()
    j.emit_raw({"kind": "job", "schema": 14, "ts": 1012.0, "job": "q1",
                "tenant": "a", "trace_id": "t-1"})
    j.emit_raw({"kind": "alert", "schema": 14, "ts": 1013.0,
                "event": "fired", "rule": "spill_storm"})
    j.close()


@pytest.fixture()
def servers(tmp_path):
    """``(port server, reference server)`` over the same sources."""
    from sparkrdma_tpu.obs.metrics import MetricsRegistry as RReg
    from sparkrdma_tpu.obs.probe import ProbeServer as RProbe
    from sparkrdma_tpu.obs.tsdb import TelemetryStore as RStore

    path = tmp_path / "j.jsonl"
    _journal(path)
    rng = np.random.default_rng(0)
    regs = (MetricsRegistry(), RReg())
    stores = (TelemetryStore(regs[0], window_s=0.0, history=8),
              RStore(regs[1], window_s=0.0, history=8))
    for step in range(5):
        n = int(rng.integers(1, 1 << 20))
        for reg in regs:
            reg.counter("shuffle.bytes").inc(n)
            reg.gauge("pool.outstanding").set(step)
            reg.histogram("shuffle.exec_s").observe(0.01 * step)
        for store in stores:
            store.sample(now=100.0 + step)
            store.observe_job({"kind": "job", "job": "q1", "tenant": "a",
                               "ts": 50.0})
    kw = dict(identity={"process_index": 0, "host": "testhost"},
              journal_path=str(path),
              rollups=lambda: [{"tenant": "a", "shuffle_id": 1,
                                "reads": 2}],
              tenants=lambda: {"a": {"hbm": 1, "host": 0, "disk": 0}},
              alerts=lambda: [{"kind": "alert", "rule": "spill_storm"}],
              health=lambda: {"status": "warn", "score": 75, "active": 1,
                              "subsystems": {"store": "warn"}})
    port = pp.ProbeServer(0, metrics=regs[0], telemetry=stores[0],
                          jobs=stores[0].job_lines, **kw)
    want = RProbe(0, metrics=regs[1], telemetry=stores[1],
                  jobs=stores[1].job_lines, **kw)
    port.start()
    want.start()
    yield port, want, path
    port.stop()
    want.stop()


def _strip(body: bytes):
    try:
        d = json.loads(body)
    except ValueError:
        return body
    if isinstance(d, dict):
        for k in STAMPS:
            d.pop(k, None)
    return d


@pytest.mark.parametrize("request_line", [
    "GET /journal\n", "/journal\n", "GET /jobs\n", "GET /snapshot\n",
    "/snapshot\n", "\n", "GET /metrics\n", "GET /alerts\n",
    "GET /health\n", "GET /nowhere\n"])
def test_route_body_matches_reference(servers, request_line):
    port, want, _ = servers
    got = fetch(port.port, request_line)
    exp = fetch(want.port, request_line)
    assert got and _strip(got) == _strip(exp)
    if request_line.strip().endswith("/journal"):
        assert got == exp              # byte for byte, streamed
    if request_line.strip().endswith("/metrics"):
        assert b"shuffle_bytes" in got and b"shuffle_exec_s_count" in got


def test_stamps_are_monotonic_seconds(servers):
    port, _, _ = servers
    a = json.loads(fetch(port.port, "GET /health\n"))
    b = json.loads(fetch(port.port, "GET /health\n"))
    assert b["served_at_s"] >= a["served_at_s"] > 0
    assert b["uptime_s"] >= a["uptime_s"] >= 0


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_text_matches_reference(seed):
    from sparkrdma_tpu.obs.probe import _prometheus_text

    rng = np.random.default_rng(seed)
    snap = {}
    for i in range(12):
        name = f"a.b-{i}.c" if i % 3 else f"x{i}"
        kind = int(rng.integers(3))
        snap[name] = (int(rng.integers(1 << 30)) if kind == 0 else
                      float(rng.random()) if kind == 1 else
                      {"count": int(rng.integers(9)),
                       "sum": float(rng.random())})
    snap["not_scalar"] = "text"
    snap["no_count"] = {"sum": 1.0}
    assert pp._prometheus_text(snap) == _prometheus_text(snap)


def test_absent_sources_serve_empty_sections():
    srv = pp.ProbeServer(0)
    srv.start()
    try:
        assert json.loads(fetch(srv.port, "/alerts\n"))["alerts"] == []
        health = json.loads(fetch(srv.port, "/health\n"))
        assert health["status"] == "ok" and health["score"] == 100
        assert json.loads(fetch(srv.port, "/journal\n")) == []
        assert json.loads(fetch(srv.port, "/jobs\n"))["jobs"] == []
    finally:
        srv.stop()


def test_client_hanging_up_never_stops_the_server(servers):
    port, _, _ = servers
    for _ in range(3):
        s = socket.create_connection(("127.0.0.1", port.port), timeout=5)
        s.close()
    assert json.loads(fetch(port.port, "/health\n"))["status"] == "warn"


def test_shuffle_top_reads_the_port_probe_as_the_file(servers, capsys):
    """``--connect`` to the port's probe: the same buckets and the same
    frame as the journal file itself."""
    port, _, path = servers
    top = _top()
    addr = f"127.0.0.1:{port.port}"
    assert top.collect([], connect=[addr]) == top.collect([str(path)])
    assert top.main(["--connect", addr, "--once"]) == 0
    live = capsys.readouterr().out
    assert top.main([str(path), "--once"]) == 0
    assert live == capsys.readouterr().out
    assert "spill_storm" in live


# ---------------------------------------------------------------------
# the manager's probe
# ---------------------------------------------------------------------
def test_manager_probe_serves_live_rollups_and_closes(tmp_path):
    conf = ShuffleConf(slot_records=64, metrics_sink=str(tmp_path / "j"),
                       probe_port=0, rollup_window_s=3600.0)
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    assert m.probe is not None and m.probe.host == "127.0.0.1"
    assert m.probe._sock.getsockname()[0] == "127.0.0.1"
    h = m.register_shuffle(3, 8, modulo_partitioner(8))
    rows = np.random.default_rng(1).integers(1, 2**32, size=(256, 4),
                                             dtype=np.uint32)
    m.get_writer(h).write(m.runtime.shard_records(rows)).stop()
    m.get_reader(h).read()
    snap = json.loads(fetch(m.probe.port, "/snapshot\n"))
    assert [(c["shuffle_id"], c["reads"]) for c in snap["rollups"]] == \
        [(3, 1)]
    assert snap["identity"]["host_count"] == 1
    assert snap["telemetry"] == {}         # no telemetry store: empty
    port = m.probe.port
    m.stop()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)


def test_manager_probe_bind_failure_is_logged_not_fatal(tmp_path, caplog):
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        conf = ShuffleConf(slot_records=64, probe_port=busy.getsockname()[1])
        with caplog.at_level(logging.WARNING):
            m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
        assert m.probe is None
        assert "probe endpoint failed to bind" in caplog.text
        m.stop()
    finally:
        busy.close()
