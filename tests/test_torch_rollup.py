"""The port's rollups and heartbeats against the reference's.

``sparkrdma_tpu_torch.obs.rollup`` is held line for line against
``sparkrdma_tpu.obs.rollup``: the same seeded sequence of spans (tenants,
shuffles, job stages, latencies, cumulative spill / serde / store totals,
kept or sampled away), at the same injected times, gives the same
``{"kind": "rollup"}`` lines, field for field; the same probes under the
same clock give the same ``{"kind": "heartbeat"}`` lines (apart from the
process's ``rss_mb``, read twice). Then the manager's wiring: a journaling
read folds into the rollup whether or not its span is kept, the totals
equal the reference manager's on the same records, and a manager with
the default knobs starts no thread and opens no socket.
"""

import json
import os
import threading

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.obs import journal as pj
from sparkrdma_tpu_torch.obs import rollup as pr
from sparkrdma_tpu_torch.obs import trace as pt

MESH = 8


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.obs import journal as rj
    from sparkrdma_tpu.obs import rollup as rr
    from sparkrdma_tpu.obs import trace as rt

    return {"journal": rj, "rollup": rr, "trace": rt}


class Capture:
    """A journal that keeps what it is given (``emit_raw``)."""

    enabled = True

    def __init__(self):
        self.lines = []
        self.emitted = 3
        self.rotations = 1

    def emit_raw(self, d):
        self.lines.append(json.loads(json.dumps(d)))


class Broken(Capture):
    def emit_raw(self, d):
        raise OSError("sink gone")


def _span_kwargs(rng, i):
    """One random span's fields: the same dict builds either package's
    ``ExchangeSpan``."""
    tenant = ["", "a", "b"][int(rng.integers(3))]
    lat = float(rng.lognormal(-4.0, 2.0))
    return dict(
        span_id=i + 1, shuffle_id=int(rng.integers(3)), tenant=tenant,
        transport="pallas_ring", rounds=int(rng.integers(1, 40)),
        dispatches=int(rng.choice([1, 1, 19, 37])),
        records=int(rng.integers(0, 1 << 20)),
        record_bytes=100, plan_s=0.001,
        exchange_s=lat * float(rng.uniform(0.5, 1.0)),
        sort_s=lat * float(rng.uniform(0.0, 0.5)),
        per_peer_records=[1] * MESH, retry_count=int(rng.integers(0, 2)),
        trace_id=["", "t1", "t2"][int(rng.integers(3))],
        job=["", "terasort"][int(rng.integers(2))],
        stage=["", "exchange", "sort"][int(rng.integers(3))],
        stage_attempt=int(rng.integers(2)))


def _feed(rng, n, window_s):
    """A list of ``(span kwargs, kept, now)`` with cumulative totals
    that only grow, as the process-wide counters do."""
    out = []
    now = 1_000_000.0 + float(rng.uniform(0, window_s))
    spills = 0
    serde = [0, 0.0, 0, 0.0]
    store = [0, 0, 0, 0]
    for i in range(n):
        kw = _span_kwargs(rng, i)
        if rng.random() < 0.3:
            spills += int(rng.integers(1, 4))
        if rng.random() < 0.4:
            serde = [serde[0] + int(rng.integers(1, 1 << 20)),
                     serde[1] + float(rng.uniform(1e-4, 1e-2)),
                     serde[2] + int(rng.integers(1, 1 << 20)),
                     serde[3] + float(rng.uniform(1e-4, 1e-2))]
        if rng.random() < 0.4:
            store = [v + int(rng.integers(0, 1 << 16)) for v in store]
        kw.update(spill_count=spills, serde_encode_bytes=serde[0],
                  serde_encode_s=serde[1], serde_decode_bytes=serde[2],
                  serde_decode_s=serde[3], store_spill_bytes=store[0],
                  store_fetch_bytes=store[1], store_prefetch_hits=store[2],
                  store_sync_fetches=store[3])
        now += float(rng.exponential(window_s / 4))
        out.append((kw, bool(rng.random() < 0.6), now))
    return out, now + window_s


def test_field_sets_match_reference(ref):
    rr = ref["rollup"]
    assert pr.ROLLUP_FIELDS == rr.ROLLUP_FIELDS
    assert pr.HEARTBEAT_FIELDS == rr.HEARTBEAT_FIELDS
    assert pr.LATENCY_BOUNDS_MS == rr.LATENCY_BOUNDS_MS
    assert set(pr.__all__) == set(rr.__all__)


@pytest.mark.parametrize("window_s", [1.0, 30.0])
@pytest.mark.parametrize("seed", range(6))
def test_rollup_lines_match_reference(ref, seed, window_s):
    """Field for field, ``ts`` included (both take the injected time)."""
    feed, end = _feed(np.random.default_rng(seed), 60, window_s)
    jp, jr = Capture(), Capture()
    ap = pr.RollupAggregator(jp, window_s=window_s, process_index=2)
    ar = ref["rollup"].RollupAggregator(jr, window_s=window_s,
                                        process_index=2)
    for kw, kept, now in feed:
        ap.observe(pj.ExchangeSpan(**kw), kept=kept, now=now)
        ar.observe(ref["journal"].ExchangeSpan(**kw), kept=kept, now=now)
        assert ap.peek() == ar.peek()
    ap.flush(now=end)
    ar.flush(now=end)
    assert jp.lines and jp.lines == jr.lines
    assert ap.emitted == ar.emitted == len(jp.lines)
    assert all(set(d) == pr.ROLLUP_FIELDS for d in jp.lines)
    # the windows count every read, kept or sampled away
    assert sum(d["reads"] for d in jp.lines) == len(feed)
    assert sum(d["sampled_reads"] for d in jp.lines) == \
        sum(kept for _, kept, _ in feed)


@pytest.mark.parametrize("seed", range(3))
def test_rollup_history_feeds_store_like_reference(ref, seed):
    """Each emitted line also lands in the telemetry store's per-shuffle
    ring, as in the reference."""
    from sparkrdma_tpu.obs.metrics import MetricsRegistry as RReg
    from sparkrdma_tpu.obs.tsdb import TelemetryStore as RStore

    from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
    from sparkrdma_tpu_torch.obs.tsdb import TelemetryStore

    feed, end = _feed(np.random.default_rng(10 + seed), 40, 1.0)
    sp = TelemetryStore(MetricsRegistry(), window_s=0.0, history=4)
    sr = RStore(RReg(), window_s=0.0, history=4)
    ap = pr.RollupAggregator(Capture(), window_s=1.0, store=sp)
    ar = ref["rollup"].RollupAggregator(Capture(), window_s=1.0, store=sr)
    for kw, kept, now in feed:
        ap.observe(pj.ExchangeSpan(**kw), kept=kept, now=now)
        ar.observe(ref["journal"].ExchangeSpan(**kw), kept=kept, now=now)
    ap.flush(now=end)
    ar.flush(now=end)
    assert sp.stats()["rollup_series"] == sr.stats()["rollup_series"]
    for tenant in ("", "a", "b"):
        for sid in range(3):
            got = json.loads(json.dumps(sp.rollup_history(sid, tenant)))
            assert got == json.loads(json.dumps(
                sr.rollup_history(sid, tenant)))
            assert len(got) <= 4


@pytest.mark.parametrize("seed", range(3))
def test_span_latency_ms_matches_reference(ref, seed):
    kw = _span_kwargs(np.random.default_rng(seed), 0)
    assert pr.span_latency_ms(pj.ExchangeSpan(**kw)) == \
        ref["rollup"].span_latency_ms(ref["journal"].ExchangeSpan(**kw))


def test_window_rolls_on_the_injected_clock():
    """A window is written when the first read past its end arrives."""
    j = Capture()
    agg = pr.RollupAggregator(j, window_s=10.0)
    kw = _span_kwargs(np.random.default_rng(0), 0)
    agg.observe(pj.ExchangeSpan(**kw), now=105.0)
    agg.observe(pj.ExchangeSpan(**kw), now=109.0)
    assert j.lines == []
    agg.observe(pj.ExchangeSpan(**kw), now=111.0)
    assert [(d["window_start"], d["reads"]) for d in j.lines] == \
        [(100.0, 2)]
    agg.flush(now=125.0)
    assert [(d["window_start"], d["reads"]) for d in j.lines] == \
        [(100.0, 2), (110.0, 1)]


# ---------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------
IDENTITY = {"process_index": 1, "host_count": 2, "host": "h", "pid": 7}


def _boom():
    raise RuntimeError("probe failed")


PROBES = {
    "none": {},
    "values": {"in_flight": lambda: 2, "pool_outstanding": lambda: 5,
               "host_tier_mb": lambda: 300, "disk_tier_mb": lambda: 9},
    "failing": {"in_flight": _boom, "pool_outstanding": lambda: "x",
                "tenants": _boom},
    "tenants": {"tenants": lambda: {"a": {"hbm": 1, "host": 2,
                                          "disk": 3}}},
}


def _beats(module, journal, probes, job):
    ticks = iter(float(t) for t in range(100, 200))
    hb = module.HeartbeatEmitter(journal, 5.0, identity=IDENTITY,
                                 probes=probes, clock=lambda: next(ticks))
    hb.beat()
    hb.beat(now=150.0)
    return hb


@pytest.mark.parametrize("job", [False, True])
@pytest.mark.parametrize("probes", sorted(PROBES))
def test_heartbeat_lines_match_reference(ref, probes, job):
    """Field for field but ``rss_mb`` (the process's, read at each
    beat); inside a job trace the job's coordinates ride along."""
    jp, jr = Capture(), Capture()
    if job:
        with pt.JobTrace("j") as tp, ref["trace"].JobTrace("j") as tr:
            tr.trace_id = tp.trace_id    # ids are per-process counters
            with tp.stage("s", attempt=1), tr.stage("s", attempt=1):
                _beats(pr, jp, PROBES[probes], job)
                _beats(ref["rollup"], jr, PROBES[probes], job)
    else:
        _beats(pr, jp, PROBES[probes], job)
        _beats(ref["rollup"], jr, PROBES[probes], job)
    for d in jp.lines + jr.lines:
        assert set(d) == pr.HEARTBEAT_FIELDS
        d.pop("rss_mb")
    assert len(jp.lines) == 2 and jp.lines == jr.lines
    assert jp.lines[1]["seq"] == 2 and jp.lines[1]["uptime_s"] == 50.0
    assert bool(jp.lines[0]["job"]) == job


def test_heartbeat_never_raises_and_counts(ref):
    hp = pr.HeartbeatEmitter(Broken(), 5.0)
    hr = ref["rollup"].HeartbeatEmitter(Broken(), 5.0)
    for hb in (hp, hr):
        hb.beat()
        hb.beat()
    assert hp.beat_errors == hr.beat_errors == 2
    assert hp.seq == hr.seq == 2


def test_heartbeat_age_and_thread_stop():
    ticks = iter([10.0, 10.0, 12.5, 20.0])
    hb = pr.HeartbeatEmitter(Capture(), 3600.0,
                             clock=lambda: next(ticks))
    assert hb.age_s(now=12.0) == 2.0
    hb.start()
    assert hb._thread is not None
    hb.stop(final_beat=True)          # parks at 3600 s: stop wakes it
    assert hb._thread is None and hb.seq == 1


def test_rss_mb_is_a_size():
    rss = pr.rss_mb()
    assert rss is None or rss > 0


# ---------------------------------------------------------------------
# the manager's wiring
# ---------------------------------------------------------------------
def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=(n, 4), dtype=np.uint32)


def _rollup_totals(path):
    keys = ("reads", "records", "bytes", "rounds", "dispatches",
            "retries", "streaming_reads", "fused_reads")
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    rolls = [d for d in lines if d.get("kind") == "rollup"]
    return {k: sum(d[k] for d in rolls) for k in keys}, rolls


@pytest.mark.parametrize("geometry", ["fused", "streaming"])
def test_manager_rollup_totals_match_reference(tmp_path, geometry):
    """Three reads of two shuffles with ``journal_sample="1/4"``: every
    read is in the rollup (kept or not), and the windows' totals equal
    the reference manager's on the same records."""
    from sparkrdma_tpu import MeshRuntime as RRuntime
    from sparkrdma_tpu import ShuffleConf as RConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RManager
    from sparkrdma_tpu.exchange.partitioners import \
        modulo_partitioner as rmod

    kw = dict(slot_records=64, journal_sample="1/4", rollup_window_s=3600)
    if geometry == "streaming":
        kw.update(slot_records=8, max_rounds_in_flight=1)
    sinks = {}
    for name in ("port", "ref"):
        sink = tmp_path / f"{name}.jsonl"
        if name == "port":
            m = ShuffleManager(MeshRuntime(
                ShuffleConf(metrics_sink=str(sink), **kw), MESH,
                device="cpu"))
            part = modulo_partitioner(MESH)
        else:
            m = RManager(RRuntime(RConf(metrics_sink=str(sink), **kw)))
            part = rmod(MESH)
        for sid in (1, 2):
            h = m.register_shuffle(sid, MESH, part)
            m.get_writer(h).write(m.runtime.shard_records(
                _rows(sid, MESH * 32))).stop(True)
            for _ in range(3):
                m.get_reader(h).read()
        m.stop()
        sinks[name] = sink
    got, rolls = _rollup_totals(sinks["port"])
    want, _ = _rollup_totals(sinks["ref"])
    assert got == want and got["reads"] == 6
    assert {d["shuffle_id"] for d in rolls} == {1, 2}
    assert (got["streaming_reads"] > 0) == (geometry == "streaming")
    spans = pj.read_journal(str(sinks["port"]))
    assert len(spans) < 6 and all(s.sample_weight == 4 for s in spans)


def _sockets():
    fds = os.listdir("/proc/self/fd")
    out = 0
    for fd in fds:
        try:
            out += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return out


def test_default_manager_starts_no_thread_and_opens_no_socket():
    threads = {t.ident for t in threading.enumerate()}
    socks = _sockets()
    m = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=64), MESH,
                                   device="cpu"))
    h = m.register_shuffle(1, MESH, modulo_partitioner(MESH))
    m.get_writer(h).write(m.runtime.shard_records(_rows(0, 256))).stop()
    m.get_reader(h).read()
    assert m.rollup is None and m.heartbeat is None
    assert m.alerts is None and m.probe is None
    assert not m.telemetry.enabled
    assert {t.ident for t in threading.enumerate()} <= threads
    assert _sockets() == socks
    m.stop()


def test_journal_alone_adds_only_the_rollup(tmp_path):
    """``metrics_sink`` with the other knobs at their defaults: the
    rollup (``rollup_window_s`` 30) and nothing that runs a thread."""
    threads = {t.ident for t in threading.enumerate()}
    m = ShuffleManager(MeshRuntime(
        ShuffleConf(slot_records=64, metrics_sink=str(tmp_path / "j")),
        MESH, device="cpu"))
    assert m.rollup is not None and m.rollup.window_s == 30.0
    assert m.heartbeat is None and m.probe is None and m.alerts is None
    assert {t.ident for t in threading.enumerate()} <= threads
    m.stop()
