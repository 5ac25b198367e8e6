"""The port's RPC front door against the reference's.

The cases of the reference's ``tests/test_service_rpc.py`` and the
service cases of ``tests/test_chaos.py``, on the port:

- frames are byte-identical both ways (the port's ``send_frame`` writes
  the reference's bytes, and each package reads the other's), the
  protocol's constants and field sets are the reference's, and a mangled
  or oversized frame is refused;
- the session surface over the wire gives the in-process read's rows,
  and the reference's: the reference's ``RpcClient`` drives the port's
  ``RpcServer`` and the port's client the reference's server;
- idempotent replay by ``req_id``, a schema mismatch, a corrupted frame
  retried with the books balanced, the deadline, ``locate`` and
  ``leases``, a goodbye reaped like ``close_session``;
- lease expiry and renewal on a patched lease clock
  (``service/rpc.py::_clock``): nothing sleeps against the wall clock;
- ``scripts/shuffle_top.py --rpc`` renders the lease table in-process;
- a fault schedule through a session balances its books (injections ==
  retries), as the reference's chaos smoke does.
"""

import importlib.util
import json
import socket
import threading
from pathlib import Path

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf, faults
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner)
from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION, read_entries
from sparkrdma_tpu_torch.service import (RpcCallError, RpcClient,
                                         ShuffleService)
from sparkrdma_tpu_torch.service import rpc as prpc
from sparkrdma_tpu_torch.service import wire

REPO = Path(__file__).resolve().parent.parent
MESH = 8


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.service import client as rc
    from sparkrdma_tpu.service import rpc as rr
    from sparkrdma_tpu.service import wire as rw

    return {"wire": rw, "rpc": rr, "client": rc}


def _records(words, rpd, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(MESH * rpd, words), dtype=np.uint32)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------
OBJECTS = [
    {"op": "hello", "args": {"n": [1, 2, 3]}, "s": "uniçode"},
    {"ok": True, "req_id": "c:1", "schema": 1, "value": None, "error": "",
     "retryable": False},
    {"rows": [[0, 4294967295, 7]] * 50, "totals": [1, 2, 3]},
    {},
]


def _raw(send, obj):
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return buf
            buf += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_frames_byte_identical_to_reference(ref, i):
    assert _raw(wire.send_frame, OBJECTS[i]) == \
        _raw(ref["wire"].send_frame, OBJECTS[i])


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_frames_read_across_packages(ref, i, direction):
    send, recv = ((wire.send_frame, ref["wire"].recv_frame)
                  if direction == "port->ref"
                  else (ref["wire"].send_frame, wire.recv_frame))
    a, b = socket.socketpair()
    try:
        send(a, OBJECTS[i])
        assert recv(b) == OBJECTS[i]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", ["RPC_SCHEMA_VERSION", "OPS",
                                  "REQUEST_FIELDS", "REPLY_FIELDS",
                                  "LEASE_FIELDS", "MAX_FRAME_BYTES"])
def test_protocol_constants_match_reference(ref, name):
    assert getattr(wire, name) == getattr(ref["wire"], name)


def test_handlers_cover_every_op():
    assert set(prpc._HANDLERS) == wire.OPS
    assert all(hasattr(prpc.RpcServer, h) for h in prpc._HANDLERS.values())


def test_mangled_frame_fails_crc():
    a, b = socket.socketpair()
    try:
        plane = faults.FaultPlane("rpc.send:corrupt@attempt<1")
        with faults.scoped_plane(plane):
            wire.send_frame(a, {"op": "x"})
        with pytest.raises(wire.FrameError):
            wire.recv_frame(b)
        assert plane.injected_total(("corrupt",)) == 1
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("site", ["rpc.send", "rpc.recv"])
def test_injected_failure_is_a_connection_error(site):
    a, b = socket.socketpair()
    try:
        with faults.scoped_plane(faults.FaultPlane(f"{site}:fail")):
            with pytest.raises(ConnectionError, match=site):
                wire.send_frame(a, {"op": "x"})
                wire.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_oversized_length_prefix_refused():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\xff\xff\xff\xff\x00\x00\x00\x00")
        with pytest.raises(wire.FrameError, match="exceeds cap"):
            wire.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_peer_close_is_connection_error():
    a, b = socket.socketpair()
    a.close()
    try:
        with pytest.raises(ConnectionError):
            wire.recv_frame(b)
    finally:
        b.close()


def test_rpc_sites_registered_and_corruptible():
    assert {"rpc.send", "rpc.recv"} <= set(faults.SITES)
    assert {"rpc.send", "rpc.recv"} <= set(faults.CORRUPTIBLE)
    faults.parse_fault_spec("rpc.recv:corrupt@0.5")


def test_lease_line_matches_reference(ref):
    kw = dict(tenant="blue", sessions=1, age_s=1.5, ttl_s=30.0, detail="d")
    got = prpc.lease_line("grant", "c1", **kw)
    want = ref["rpc"].lease_line("grant", "c1", **kw)
    assert set(got) == wire.LEASE_FIELDS and got["schema"] == SCHEMA_VERSION
    got.pop("ts")
    want.pop("ts")
    assert got == want


# ---------------------------------------------------------------------
# the session surface over the wire
# ---------------------------------------------------------------------
@pytest.fixture()
def svc(tmp_path):
    conf = ShuffleConf(rpc_port=0, lease_s=30.0,
                       spill_dir=str(tmp_path / "ck"),
                       metrics_sink=str(tmp_path / "j.jsonl"))
    s = ShuffleService(conf=conf, device="cpu")
    assert s.rpc is not None
    yield s
    s.stop()


def _client(port, client_id, **kw):
    kw.setdefault("retry_ms", 2.0)
    kw.setdefault("deadline_s", 20.0)
    return RpcClient(port=port, client_id=client_id, **kw)


def _inproc(svc, x, sid):
    """The same exchange through the in-process session surface."""
    m = svc.open_session("control")
    try:
        h = m.register_shuffle(sid, MESH,
                               hash_partitioner(MESH, m.conf.key_words))
        m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
        rows, totals = m.get_reader(h).read()
        out = (rows.numpy().view(np.uint32).copy(), totals.numpy().copy())
        m.unregister_shuffle(sid)
        return out
    finally:
        svc.close_session(m)


def _over_wire(client, x, sid, tenant="blue", checkpoint=False):
    client.hello()
    s = client.open_session(tenant)
    client.register_shuffle(s, sid, 0)
    assert client.write(s, sid, x) == x.shape[0]
    rows, totals = client.read(s, sid, checkpoint=checkpoint)
    return s, np.asarray(rows, np.uint32), np.asarray(totals)


def test_disabled_by_default():
    assert ShuffleConf().rpc_port == -1 and ShuffleConf().lease_s == 30.0


def test_bit_identity_with_inprocess_and_reference(svc):
    from sparkrdma_tpu.config import ShuffleConf as RConf
    from sparkrdma_tpu.exchange.partitioners import hash_partitioner as rh
    from sparkrdma_tpu.service import ShuffleService as RService

    x = _records(svc.conf.record_words, 16, seed=7)
    c = _client(svc.rpc.port, "bit")
    s, rows, totals = _over_wire(c, x, 701)
    c.unregister_shuffle(s, 701)
    c.close()
    want_rows, want_totals = _inproc(svc, x, 702)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(totals, want_totals)
    rs = RService(conf=RConf())
    try:
        m = rs.open_session("ref")
        h = m.register_shuffle(703, MESH, rh(MESH, m.conf.key_words))
        m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
        r_rows, r_totals = m.get_reader(h).read()
        np.testing.assert_array_equal(rows, np.asarray(r_rows))
        np.testing.assert_array_equal(totals, np.asarray(r_totals))
    finally:
        rs.stop()


def test_reference_client_drives_port_server(svc, ref):
    x = _records(svc.conf.record_words, 8, seed=8)
    c = ref["client"].RpcClient(port=svc.rpc.port, client_id="refc",
                                retry_ms=2.0, deadline_s=20.0)
    s, rows, totals = _over_wire(c, x, 711)
    assert c.usage()["blue"]["hbm"] >= 0
    assert [r["client"] for r in c.leases()] == ["refc"]
    c.close()
    want_rows, want_totals = _inproc(svc, x, 712)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(totals, want_totals)


def test_port_client_drives_reference_server(tmp_path):
    from sparkrdma_tpu.config import ShuffleConf as RConf
    from sparkrdma_tpu.service import ShuffleService as RService

    rs = RService(conf=RConf(rpc_port=0, lease_s=30.0))
    try:
        x = _records(rs.conf.record_words, 8, seed=9)
        c = _client(rs.rpc.port, "portc")
        s, rows, totals = _over_wire(c, x, 721)
        c.close()
        port_svc = ShuffleService(conf=ShuffleConf(), device="cpu")
        try:
            want_rows, want_totals = _inproc(port_svc, x, 722)
        finally:
            port_svc.stop()
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(totals, want_totals)
    finally:
        rs.stop()


def _call(s, op, req_id, args, client="idem", schema=None):
    wire.send_frame(s, {"op": op, "req_id": req_id, "client": client,
                        "schema": wire.RPC_SCHEMA_VERSION
                        if schema is None else schema, "args": args})
    return wire.recv_frame(s)


def test_schema_mismatch_rejected(svc):
    with socket.create_connection(("127.0.0.1", svc.rpc.port), 5) as s:
        reply = _call(s, "hello", "r1", {}, client="old", schema=999)
    assert reply["ok"] is False and reply["retryable"] is False
    assert "schema-mismatch" in reply["error"]
    assert set(reply) == wire.REPLY_FIELDS


def test_bad_request_and_unknown_client(svc):
    with socket.create_connection(("127.0.0.1", svc.rpc.port), 5) as s:
        assert _call(s, "nope", "r1", {})["error"] == "bad-request"
        assert _call(s, "usage", "r2", {})["error"] == "unknown-client"
        # monitors need no lease
        assert _call(s, "leases", "r3", {})["ok"]


def test_idempotent_replay_applies_mutation_once(svc):
    with socket.create_connection(("127.0.0.1", svc.rpc.port), 5) as s:
        assert _call(s, "hello", "h1", {})["ok"]
        r1 = _call(s, "open_session", "o1", {"tenant": "blue"})
        r2 = _call(s, "open_session", "o1", {"tenant": "blue"})
        assert r1["ok"] and r1 == r2
        assert svc.stats()["sessions"] == 1
        assert svc.metrics.counter("service.rpc.replays").value == 1
        r3 = _call(s, "open_session", "o2", {"tenant": "blue"})
        assert r3["value"]["session"] != r1["value"]["session"]
        assert svc.stats()["sessions"] == 2


def test_corrupted_frame_retried_books_balance(svc):
    """A corrupted and a failed frame, each way, are retried; the
    injections equal the client's retries (the port has no degradation
    rung), and the faulted run is bit-identical."""
    faults.reset_accounting()
    x = _records(svc.conf.record_words, 16, seed=9)
    plane = faults.FaultPlane(
        "rpc.send:corrupt@attempt<2;rpc.recv:fail@attempt<2;"
        "rpc.send:delay=2ms@0.2", seed=3)
    c = _client(svc.rpc.port, "chaos")
    with faults.scoped_plane(plane):
        _, rows, _ = _over_wire(c, x, 703)
    hard = plane.injected_total(("fail", "corrupt"))
    assert hard >= 4
    assert set(plane.sites_hit()) >= {"rpc.send", "rpc.recv"}
    assert hard == c.stats["retries"] + faults.recovery_total()
    want_rows, _ = _inproc(svc, x, 704)
    np.testing.assert_array_equal(rows, want_rows)
    c.close()


def test_client_deadline_converts_outage_to_one_error():
    c = RpcClient(port=_free_port(), client_id="dl", retry_ms=1.0,
                  deadline_s=0.3)
    with pytest.raises(RpcCallError, match="deadline"):
        c.hello()
    assert c.stats["retries"] >= 1


def test_locate_leases_and_resume(svc):
    x = _records(svc.conf.record_words, 8, seed=5)
    c = _client(svc.rpc.port, "intro")
    s, rows, totals = _over_wire(c, x, 705, checkpoint=True)
    v = c.resume_read(s, 705)
    assert sorted(v["adopted"]) == ["rpc705:cols", "rpc705:totals"]
    np.testing.assert_array_equal(np.asarray(v["rows"], np.uint32), rows)
    np.testing.assert_array_equal(np.asarray(v["totals"]), totals)
    loc = c.locate("rpc705:")
    assert set(loc) == {"rpc705:cols", "rpc705:totals"}
    lease_rows = c.leases()
    assert len(lease_rows) == 1 and set(lease_rows[0]) == wire.LEASE_FIELDS
    assert (lease_rows[0]["client"], lease_rows[0]["event"],
            lease_rows[0]["sessions"]) == ("intro", "live", 1)
    u = c.usage()["blue"]
    assert u["host"] + u["disk"] >= 1
    assert c.server_stats()["sessions"] == 1
    c.close()


def test_goodbye_reaps_like_close_session(svc):
    c = _client(svc.rpc.port, "bye")
    c.hello()
    c.open_session("blue")
    c.admit("blue", 1)
    assert svc.stats()["sessions"] == 1
    assert svc.stats()["admission"]["active"] == 1
    c.close()
    assert svc.stats()["sessions"] == 0
    assert svc.stats()["admission"]["active"] == 0
    events = [e["event"] for e in read_entries(svc._sink_path)
              if e.get("kind") == "lease"]
    assert events == ["grant", "close"]


# ---------------------------------------------------------------------
# leases on a patched clock
# ---------------------------------------------------------------------
class LeaseClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _serialized_reaper(monkeypatch, server):
    """The accept loop and the test call the reaper through one lock, so
    when the test's call returns, whichever reap ran has finished."""
    real, lock = server._reap_expired, threading.Lock()

    def reap():
        with lock:
            real()

    monkeypatch.setattr(server, "_reap_expired", reap)
    return reap


def test_expired_lease_reaped_like_close_session(tmp_path, monkeypatch):
    """No heartbeat: once the lease clock passes ``lease_s`` the server
    returns the admission ticket, zeroes the tenant's charges, drops the
    session and journals the expiry."""
    clock = LeaseClock()
    monkeypatch.setattr(prpc, "_clock", clock)
    conf = ShuffleConf(rpc_port=0, lease_s=0.5,
                       spill_dir=str(tmp_path / "ck"),
                       metrics_sink=str(tmp_path / "j.jsonl"))
    svc = ShuffleService(conf=conf, device="cpu")
    reap = _serialized_reaper(monkeypatch, svc.rpc)
    try:
        x = _records(conf.record_words, 8, seed=4)
        c = _client(svc.rpc.port, "lapsed")
        s, _, _ = _over_wire(c, x, 706, checkpoint=True)
        c.admit("blue", 1)
        assert c.resume_read(s, 706)["adopted"]
        u = svc.usage_by_tenant()["blue"]
        assert u["host"] + u["disk"] >= 1
        clock.t += 0.4
        reap()
        assert svc.stats()["sessions"] == 1      # not yet expired
        clock.t += 0.2
        reap()
        assert svc.stats()["sessions"] == 0
        assert svc.stats()["admission"]["active"] == 0
        assert svc.usage_by_tenant()["blue"] == \
            {"hbm": 0, "host": 0, "disk": 0}
        assert svc.metrics.counter("service.leases_expired").value == 1
        lease_events = [e for e in read_entries(svc._sink_path)
                        if e.get("kind") == "lease"]
        assert [e["event"] for e in lease_events] == \
            ["grant", "adopt", "expire"]
        exp = lease_events[-1]
        assert set(exp) == wire.LEASE_FIELDS
        assert (exp["client"], exp["tenant"], exp["sessions"],
                exp["schema"]) == ("lapsed", "blue", 1, 14)
        # the lapsed client's next call re-hellos under a fresh lease
        assert c.usage()["blue"]["host"] == 0
        assert svc.metrics.counter("service.leases_granted").value == 2
    finally:
        svc.stop()


def test_heartbeat_keeps_lease_alive(monkeypatch):
    clock = LeaseClock()
    monkeypatch.setattr(prpc, "_clock", clock)
    svc = ShuffleService(conf=ShuffleConf(rpc_port=0, lease_s=0.6,
                                          metrics_sink=""), device="cpu")
    reap = _serialized_reaper(monkeypatch, svc.rpc)
    try:
        c = _client(svc.rpc.port, "beater")
        c.hello()
        c.open_session("blue")
        for _ in range(10):              # 4 s of lease clock, 0.4 s apart
            clock.t += 0.4
            c.heartbeat()
            reap()
        assert svc.stats()["sessions"] == 1
        row = c.leases()[0]
        assert row["event"] == "live" and row["age_s"] == pytest.approx(4.0)
        c.close()
    finally:
        svc.stop()


# ---------------------------------------------------------------------
# the reference's monitor against the port's daemon
# ---------------------------------------------------------------------
def _top():
    spec = importlib.util.spec_from_file_location(
        "shuffle_top_port_rpc", REPO / "scripts" / "shuffle_top.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lease_table_renders_live_clients(svc, capsys):
    top = _top()
    c = _client(svc.rpc.port, "monitor-demo")
    addr = f"127.0.0.1:{svc.rpc.port}"
    try:
        c.hello()
        c.open_session("blue")
        c.open_session("blue")
        rows = top.fetch_lease_rows(addr)
        assert [r["client"] for r in rows] == ["monitor-demo"]
        assert set(rows[0]) == wire.LEASE_FIELDS
        assert (rows[0]["event"], rows[0]["sessions"], rows[0]["tenant"]) \
            == ("live", 2, "blue")
        assert 0.0 < rows[0]["ttl_s"] <= svc.conf.lease_s
        assert top.main(["--rpc", addr, "--once"]) == 0
        out = capsys.readouterr().out
        assert f"leases @ {addr} — 1 client(s)" in out
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("monitor-demo"))
        assert "blue" in line and "live" in line and "tickets=0" in line
    finally:
        c.close()
    assert top.fetch_lease_rows(addr) == []
    assert top.main(["--rpc", addr, "--once"]) == 0
    assert "(no live leases)" in capsys.readouterr().out


def test_unreachable_daemon_flags_stale(capsys):
    top = _top()
    addr = f"127.0.0.1:{_free_port()}"
    status = {}
    assert top.fetch_lease_rows(addr, retries=0, status=status) == []
    assert status == {addr: False}
    assert top.main(["--rpc", addr, "--once"]) == 0
    assert "STALE" in capsys.readouterr().out


# ---------------------------------------------------------------------
# the chaos cases through a session
# ---------------------------------------------------------------------
def test_session_chaos_books_balance(tmp_path):
    """A multi-site schedule through one session's read: every hard
    injection is a retry in its span (the reference's chaos smoke)."""
    faults.reset_accounting()
    sink = tmp_path / "chaos.jsonl"
    conf = ShuffleConf(slot_records=64, max_retry_attempts=6,
                       retry_backoff_ms=0.1, metrics_sink=str(sink),
                       fault_spec="exchange.dispatch:fail@attempt<2;"
                                  "pool.acquire:delay=1ms@attempt<2")
    svc = ShuffleService(MeshRuntime(conf, MESH, device="cpu"))
    m = svc.open_session("noisy")
    h = m.register_shuffle(61, MESH, modulo_partitioner(MESH, key_word=1))
    x = np.zeros((MESH * 16, 4), dtype=np.uint32)
    x[:, 1] = np.random.default_rng(0).integers(0, 8, size=MESH * 16)
    m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
    _, totals = m.get_reader(h).read()
    assert int(totals.sum()) == x.shape[0]
    hard = m.faults.injected_total(("fail", "corrupt"))
    assert hard == 2
    assert m.faults.sites_hit() == ["exchange.dispatch", "pool.acquire"]
    svc.stop()
    retried = sum(json.loads(ln)["retry_count"] for ln in
                  sink.read_text().splitlines() if "retry_count" in ln)
    assert hard == retried + faults.recovery_total()
    faults.reset_accounting()
