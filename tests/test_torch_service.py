"""The port's multi-tenant shuffle service against the reference's.

The cases of the reference's ``tests/test_service.py``, on the port:
two tenants reading at once through one ``ShuffleService`` give the
bytes of a standalone manager's read and of the reference's service on
the 8-device CPU mesh; an oversubscribed tenant queues (journaled
``admission`` waits) and does not fail; quotas hold in every tier under
seeded random operations and the per-tenant ledgers equal the store's
once its writer is idle; a session's fault plane stays thread-local
(one tenant's injected fault never reaches the other's concurrent
read); a session's ``stop`` drops only its own tenant; a re-registered
tenant keeps its account. Also: the admission controller's grant order
and the tenant accounts equal the reference's step for step, the slot
pool orders a buffer's next holder after its last one across streams,
and the daemon wants the card unless it is given the CPU.
"""

import json
import threading
from collections import deque

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.hbm.slot_pool import SlotPool
from sparkrdma_tpu_torch.service import (QuotaExceededError, ShuffleService,
                                         TenantQuota)
from sparkrdma_tpu_torch.service.admission import AdmissionController
from sparkrdma_tpu_torch.service.tenant import TenantAccount

MESH = 8
TIMEOUT = 180


def _svc(**kw):
    return ShuffleService(conf=ShuffleConf(**kw), device="cpu")


def _records(seed, n_rows=MESH * 32, words=4):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=(n_rows, words), dtype=np.uint32)


def _u32(t):
    return t.cpu().numpy().view(np.uint32) if t.dtype == torch.int32 \
        else t.cpu().numpy()


def _solo(x, sid, conf):
    m = ShuffleManager(MeshRuntime(conf, MESH, device="cpu"))
    h = m.register_shuffle(sid, MESH, modulo_partitioner(MESH))
    m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
    out, tot = m.get_reader(h).read()
    res = (_u32(out).copy(), tot.numpy().copy())
    m.stop()
    return res


def _reference_service(x, sid, conf_kw):
    from sparkrdma_tpu.config import ShuffleConf as RConf
    from sparkrdma_tpu.exchange.partitioners import modulo_partitioner as rm
    from sparkrdma_tpu.service import ShuffleService as RService

    svc = RService(conf=RConf(**conf_kw))
    try:
        m = svc.open_session("ref")
        h = m.register_shuffle(sid, MESH, rm(MESH))
        m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
        out, tot = m.get_reader(h).read()
        return np.asarray(out).copy(), np.asarray(tot).copy()
    finally:
        svc.stop()


def _tenants(svc, x, sid, tenants, reads=3, confs=None, hold=None):
    """Each tenant in its own thread: open, write, then (all together)
    ``reads`` reads; returns ``{tenant: (out, totals, manager)}``."""
    results, errors = {}, []
    start = threading.Barrier(len(tenants))

    def run(tenant):
        try:
            m = svc.open_session(tenant, (confs or {}).get(tenant))
            h = m.register_shuffle(sid, MESH, modulo_partitioner(MESH))
            m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
            start.wait(timeout=TIMEOUT)
            for _ in range(reads):
                out, tot = m.get_reader(h).read()
            results[tenant] = (_u32(out).copy(), tot.numpy().copy(), m)
            if hold is None:
                m.unregister_shuffle(sid)
                svc.close_session(m)
        except Exception as e:           # surfaced below, not swallowed
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in tenants]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors, errors
    return results


@pytest.mark.parametrize("geometry", ["fused", "streaming"])
def test_two_tenants_bit_identical_to_solo_and_reference(geometry):
    kw = dict(slot_records=64)
    if geometry == "streaming":
        kw.update(slot_records=8, max_rounds_in_flight=1, queue_depth=2)
    x = _records(1)
    ref_out, ref_tot = _solo(x, 21, ShuffleConf(**kw))
    jax_out, jax_tot = _reference_service(x, 21, kw)
    np.testing.assert_array_equal(ref_out, jax_out)
    np.testing.assert_array_equal(ref_tot, jax_tot)
    svc = _svc(**kw)
    results = _tenants(svc, x, 21, ("alice", "bob"))
    svc.stop()
    for tenant in ("alice", "bob"):
        out, tot, _ = results[tenant]
        np.testing.assert_array_equal(tot, ref_tot)
        np.testing.assert_array_equal(out, ref_out)


def test_oversubscribed_tenant_queues_not_fails(tmp_path):
    """``admission_slots=1`` and two reading tenants: both finish, the
    contention is journaled as ``admission`` wait lines, spans carry the
    tenant, and the daemon's heartbeat reports each tenant's usage."""
    sink = tmp_path / "journal.jsonl"
    svc = _svc(slot_records=64, metrics_sink=str(sink), heartbeat_s=3600.0,
               admission_slots=1, admission_quantum=4.0,
               admission_wait_s=120.0)
    x = _records(2)
    _tenants(svc, x, 31, ("alice", "bob"), reads=6)
    svc.heartbeat.beat()
    svc.stop()
    lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    waits = [d for d in lines if d.get("kind") == "admission"]
    assert waits and {d["tenant"] for d in waits} <= {"alice", "bob"}
    assert all(d["event"] == "wait" and d["wait_ms"] > 0 for d in waits)
    spans = [d for d in lines if d.get("kind") is None]
    assert {"alice", "bob"} == {d["tenant"] for d in spans}
    beats = [d for d in lines if d.get("kind") == "heartbeat"]
    assert beats and {"alice", "bob"} <= set(beats[-1]["tenants"])
    rolls = [d for d in lines if d.get("kind") == "rollup"]
    assert {"alice", "bob"} == {d["tenant"] for d in rolls}
    assert svc.metrics.counter("service.admits").value == 12


def test_admit_releases_slot_when_note_admit_fails(monkeypatch):
    ac = AdmissionController(max_concurrent=1, wait_s=1.0)
    real = ac._note_admit
    calls = {"n": 0}

    def flaky(tenant, cost, waited_s):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("journal disk full")
        real(tenant, cost, waited_s)

    monkeypatch.setattr(ac, "_note_admit", flaky)
    with pytest.raises(RuntimeError):
        ac.admit("t")
    assert ac.stats()["active"] == 0
    with ac.admit("t"):
        assert ac.stats()["active"] == 1
    assert ac.stats()["active"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_admission_grant_order_matches_reference(seed):
    """The deficit-round-robin state machine, stepped without threads:
    the same queued reads, the same grants in the same order."""
    from sparkrdma_tpu.service.admission import \
        AdmissionController as RController

    rng = np.random.default_rng(seed)
    sides = [AdmissionController(quantum=float(rng.choice([1.0, 2.5])),
                                 max_concurrent=2)]
    sides.append(RController(quantum=sides[0].quantum, max_concurrent=2))
    entries = [[], []]
    for step in range(40):
        if rng.random() < 0.6:
            tenant = f"t{int(rng.integers(3))}"
            cost = int(rng.integers(1, 6))
            for ac, ents in zip(sides, entries):
                e = {"granted": False}
                with ac._cv:
                    ac._queues.setdefault(tenant, deque()).append((cost, e))
                    if tenant not in ac._ring:
                        ac._ring.append(tenant)
                    ac._pump_locked()
                ents.append((tenant, cost, e))
        else:
            for ac in sides:
                if ac._active:
                    ac._release()
        got = [(t, c, e["granted"]) for t, c, e in entries[0]]
        want = [(t, c, e["granted"]) for t, c, e in entries[1]]
        assert got == want
        assert sides[0].stats() == sides[1].stats()


@pytest.mark.parametrize("seed", range(4))
def test_tenant_account_matches_reference(seed):
    """Charges, try-charges and releases in every tier, quotas at their
    edges, with waits off (an over-quota charge raises at once)."""
    from sparkrdma_tpu.service.tenant import TenantAccount as RAccount
    from sparkrdma_tpu.service.tenant import TenantQuota as RQuota

    rng = np.random.default_rng(seed)
    q = dict(hbm_slots=4, host_bytes=1000, disk_bytes=0)
    accts = (TenantAccount("t", TenantQuota(**q), wait_s=0.0),
             RAccount("t", RQuota(**q), wait_s=0.0))
    for _ in range(200):
        tier = ("hbm", "host", "disk")[int(rng.integers(3))]
        op = int(rng.integers(3))
        amount = int(rng.integers(0, 400 if tier != "hbm" else 3))
        outcomes = []
        for a in accts:
            try:
                if op == 0:
                    outcomes.append(a.charge(tier, amount))
                elif op == 1:
                    outcomes.append(a.try_charge(tier, amount))
                else:
                    outcomes.append(a.release(tier, amount))
            except Exception as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1]
        assert accts[0].usage() == accts[1].usage()
    assert accts[0].wait_count() == accts[1].wait_count() == 0


@pytest.mark.parametrize("seed", range(3))
def test_tenant_usage_invariants_under_random_ops(tmp_path, seed):
    """Seeded random multi-tenant store operations: no tenant's host or
    disk charge ever exceeds its quota, and once the store's writer is
    idle (``drain``) the per-tenant ledgers equal the store's totals and
    the accounts, tier by tier."""
    conf = ShuffleConf(slot_records=64,
                       spill_tier_dir=str(tmp_path / "tier"),
                       spill_tier_host_bytes=1 << 15,
                       admission_wait_s=0.05,
                       tenant_host_bytes=1 << 14,
                       tenant_disk_bytes=1 << 16)
    svc = ShuffleService(conf=conf, device="cpu")
    st = svc.tiered
    tenants = ["t0", "t1", "t2"]
    accts = {t: svc.register_tenant(t) for t in tenants}

    def check_quota():
        for t in tenants:
            u = accts[t].usage()
            assert u["host"] <= conf.tenant_host_bytes, (t, u)
            assert u["disk"] <= conf.tenant_disk_bytes, (t, u)

    rng = np.random.default_rng(seed)
    live = {t: [] for t in tenants}
    for step in range(150):
        t = tenants[int(rng.integers(len(tenants)))]
        op = float(rng.random())
        if op < 0.6:
            n = int(rng.integers(64, 1024))
            key = f"{t}.k{step}"
            try:
                st.put(key, np.full((4, n), step, np.uint32), tenant=t,
                       shuffle=step % 3)
                live[t].append(key)
            except QuotaExceededError:
                pass                       # fails clean: no wedge, no leak
        elif op < 0.85 and live[t]:
            st.delete(live[t].pop(int(rng.integers(len(live[t])))))
        elif live[t]:
            key = live[t][int(rng.integers(len(live[t])))]
            assert int(st.get(key)[0, 0]) == int(key.split("k")[-1])
        check_quota()
    st.drain()
    by_t = st.occupancy_by_tenant()
    tot = st.occupancy()
    assert sum(d["host_bytes"] for d in by_t.values()) == tot["host_bytes"]
    assert sum(d["disk_bytes"] for d in by_t.values()) == tot["disk_bytes"]
    check_quota()
    for t in tenants:
        u = accts[t].usage()
        o = by_t.get(t, {"host_bytes": 0, "disk_bytes": 0})
        assert (u["host"], u["disk"]) == (o["host_bytes"], o["disk_bytes"])
    svc.stop()


def test_hbm_slot_quota_blocks_then_releases():
    svc = _svc(slot_records=64, admission_wait_s=0.1, tenant_hbm_slots=2)
    pool = svc.runtime.pool
    acct = svc.register_tenant("t")
    s1 = pool.get(64, account=acct)
    s2 = pool.get(64, account=acct)
    assert acct.usage()["hbm"] == 2
    with pytest.raises(QuotaExceededError):
        pool.get(64, account=acct)
    assert acct.usage()["hbm"] == 2
    s1.release()
    s3 = pool.get(64, account=acct)
    assert acct.usage()["hbm"] == 2
    s2.release()
    arr = pool.get_shaped((4, 8), account=acct)
    assert acct.usage()["hbm"] == 2
    pool.put_shaped(arr, account=acct)
    s3.release()
    assert acct.usage()["hbm"] == 0
    svc.stop()


def test_pool_acquire_fault_returns_the_charge():
    svc = _svc(slot_records=64)
    acct = svc.register_tenant("t")
    with faults.scoped_plane(faults.FaultPlane("pool.acquire:fail")):
        with pytest.raises(Exception):
            svc.runtime.pool.get_shaped((2, 2), account=acct)
    assert acct.usage()["hbm"] == 0
    svc.stop()


def test_unregister_drops_tiered_segments(tmp_path):
    conf = ShuffleConf(slot_records=64, spill_tier_dir=str(tmp_path / "t"))
    m = ShuffleManager(MeshRuntime(conf, MESH, device="cpu"))
    a = np.ones((4, 256), np.uint32)
    m.tiered.put("sh9.c0", a, shuffle=9)
    m.tiered.put("sh9.c1", a, shuffle=9)
    m.tiered.put("sh10.c0", a, shuffle=10)
    m.register_shuffle(9, MESH, modulo_partitioner(MESH))
    assert m.tiered.occupancy()["host_bytes"] == 3 * a.nbytes
    m.unregister_shuffle(9)
    assert not m.tiered.contains("sh9.c0")
    assert m.tiered.contains("sh10.c0")
    assert m.tiered.occupancy()["host_bytes"] == a.nbytes
    m.stop()


def test_session_stop_drops_only_its_tenant(tmp_path):
    svc = _svc(slot_records=64, spill_tier_dir=str(tmp_path / "tier"))
    ma = svc.open_session("a")
    mb = svc.open_session("b")
    arr = np.ones((4, 128), np.uint32)
    ma.tiered.put("a.k", arr, tenant="a", shuffle=1)
    mb.tiered.put("b.k", arr, tenant="b", shuffle=1)
    assert svc.usage_by_tenant()["a"]["host"] == arr.nbytes
    svc.close_session(ma)
    assert not svc.tiered.contains("a.k") and svc.tiered.contains("b.k")
    occ = svc.tiered.occupancy_by_tenant()
    assert "a" not in occ and occ["b"]["host_bytes"] == arr.nbytes
    assert svc.usage_by_tenant()["a"] == {"hbm": 0, "host": 0, "disk": 0}
    np.testing.assert_array_equal(svc.tiered.get("b.k"), arr)
    # the daemon's singletons survived the session's stop
    assert not svc.tiered._closed and svc.journal is mb.journal
    svc.close_session(mb)
    svc.stop()


def test_session_fault_plane_stays_thread_local():
    svc = _svc(slot_records=64)
    before = faults.active_plane()
    m = svc.open_session("chaotic", ShuffleConf(
        slot_records=64, fault_spec="exchange.dispatch:fail@attempt<1"))
    try:
        assert m.faults.enabled
        assert faults.active_plane() is before
        with m._tenant_scope():
            assert faults.active_plane() is m.faults
        assert faults.active_plane() is before
    finally:
        svc.close_session(m)
        svc.stop()


def test_faulted_tenant_never_reaches_the_other(tmp_path):
    """Tenant A's schedule fails its first dispatch while tenant B reads
    at the same time: B's plane and spans show no injection and no
    retry, A's books balance (one injection, one retry), and both equal
    their solo reads."""
    sink = tmp_path / "j.jsonl"
    kw = dict(slot_records=64, metrics_sink=str(sink))
    x = _records(3)
    want_out, want_tot = _solo(x, 41, ShuffleConf(slot_records=64))
    svc = _svc(**kw)
    confs = {"noisy": ShuffleConf(
        fault_spec="exchange.dispatch:fail@attempt<1", **kw)}
    res = _tenants(svc, x, 41, ("noisy", "clean"), reads=2, confs=confs,
                   hold=True)
    noisy, clean = res["noisy"][2], res["clean"][2]
    assert noisy.faults.injected_total() == 1
    assert not clean.faults.enabled and clean.faults.injected_total() == 0
    for t in ("noisy", "clean"):
        np.testing.assert_array_equal(res[t][0], want_out)
        np.testing.assert_array_equal(res[t][1], want_tot)
    svc.stop()
    spans = [json.loads(ln) for ln in sink.read_text().splitlines()]
    spans = [d for d in spans if d.get("kind") is None]
    retries = {t: sum(d["retry_count"] for d in spans if d["tenant"] == t)
               for t in ("noisy", "clean")}
    assert retries == {"noisy": 1, "clean": 0}
    # the books: the one injection is the one retry (no recovery here)
    assert noisy.faults.injected_total() == retries["noisy"]
    events = {t: [e["name"] for d in spans if d["tenant"] == t
                  for e in d["events"]] for t in ("noisy", "clean")}
    assert "fault:injected" in events["noisy"]
    assert "fault:injected" not in events["clean"]
    assert "retry" not in events["clean"]


def test_reregistered_tenant_reuses_account_and_quota():
    svc = _svc(slot_records=64, tenant_host_bytes=1 << 20)
    a1 = svc.register_tenant("t")
    assert a1.quota.host_bytes == 1 << 20
    a2 = svc.register_tenant("t", quota=TenantQuota(host_bytes=1 << 10))
    assert a2 is a1 and a1.quota.host_bytes == 1 << 10
    m = svc.open_session("t")
    assert m.account is a1
    svc.close_session(m)
    m2 = svc.open_session("t")
    assert m2.account is a1 and svc.tiered._accounts["t"] is a1
    svc.close_session(m2)
    svc.stop()


def test_daemon_owns_the_live_layer(tmp_path):
    """Sessions run no heartbeat, alerts or probe of their own and share
    the daemon's journal and telemetry; ``stop`` ends every thread."""
    before = {t.ident for t in threading.enumerate()}
    svc = _svc(slot_records=64, metrics_sink=str(tmp_path / "j"),
               heartbeat_s=3600.0, telemetry_window_s=3600.0,
               alert_eval_s=3600.0, probe_port=0)
    assert svc.heartbeat and svc.alerts and svc.probe and \
        svc.telemetry.enabled
    m = svc.open_session("a")
    assert m.heartbeat is None and m.alerts is None and m.probe is None
    assert m.journal is svc.journal and m.telemetry is svc.telemetry
    assert m.rollup is not None and m.rollup.window_s == 30.0
    svc.stop()
    assert not ({t.ident for t in threading.enumerate()} - before)


def test_service_wants_the_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ShuffleService(conf=ShuffleConf(slot_records=64))
    svc = ShuffleService(MeshRuntime(ShuffleConf(slot_records=64), MESH,
                                     device="cpu"))
    assert svc.runtime.device.type == "cpu"
    svc.stop()


# ---------------------------------------------------------------------
# the shared pool's stream order
# ---------------------------------------------------------------------
class _Stream:
    def __init__(self, name, log):
        self.name, self._log = name, log

    def wait_stream(self, other):
        self._log.append((self.name, other.name))


@pytest.mark.parametrize("put_on,get_on,waits", [
    (7, 0, [("cur:0", "ext:7")]), (0, 5, [("cur:5", "default")]),
    (5, 5, []), (0, 0, [])])
@pytest.mark.parametrize("path", ["shaped", "slot"])
def test_pool_orders_next_holder_after_putter_stream(monkeypatch, put_on,
                                                     get_on, waits, path):
    """The hazard of two tenants' threads on different streams: a buffer
    put back from one stream is handed out on another only after that
    stream waits for the putter's (the card's behaviour is held in
    ``chip_smoke.py``'s ``service`` phase)."""
    log, current = [], {"s": put_on}
    pool = SlotPool(ShuffleConf(slot_records=64), device="cpu")
    pool._cuda = True
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: current["s"], raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(f"cur:{current['s']}",
                                                    log))
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda device=None: _Stream("default", log))
    monkeypatch.setattr(torch.cuda, "ExternalStream",
                        lambda ptr, device=None: _Stream(f"ext:{ptr}", log))
    if path == "shaped":
        arr = pool.get_shaped((4, 4))
        pool.put_shaped(arr)
        current["s"] = get_on
        again = pool.get_shaped((4, 4))
    else:
        slot = pool.get(16)
        arr = slot.array
        slot.release()
        current["s"] = get_on
        again = pool.get(16).array
    assert again is arr
    assert log == waits
    assert pool.stats()["cross_stream_waits"] == len(waits)


def test_launch_counts_exact_across_tenant_threads():
    """Tenants' threads launch the same kernels at once: the wrappers'
    counts lose no launch (more threads than cores, a short switch
    interval)."""
    import os
    import sys

    from sparkrdma_tpu_torch import _build

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads = 2 * (os.cpu_count() or 2) + 1
    per = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per
