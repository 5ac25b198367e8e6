"""The port's telemetry store against the reference's.

``sparkrdma_tpu_torch.obs.tsdb.TelemetryStore`` over the port's
registry and ``sparkrdma_tpu.obs.tsdb.TelemetryStore`` over the
reference's, fed the same seeded counter and gauge operations and
sampled at the same injected times, answer every query alike: ``last``,
``delta``, ``rate`` and ``window`` over trailing spans, the ring's
evictions, ``stats()``, and the rollup and job history rings. Then the
null store, a failing source, and the manager's gate (the reference's
``collect_shuffle_read_stats or metrics_sink``, not the port's always-on
registry).
"""

import threading

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.obs import tsdb as pt
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

NAMES = ("store.spill_bytes", "shuffle.bytes", "journal.write_errors",
         "pool.outstanding", "service.admission_waits")
SPANS = (None, 0.5, 2.0, 5.0, 100.0)


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.obs import metrics as rm
    from sparkrdma_tpu.obs import tsdb as rt

    return {"tsdb": rt, "metrics": rm}


def _apply(rng, regs):
    """One random op, the same on every registry."""
    name = NAMES[int(rng.integers(len(NAMES)))]
    if name == "pool.outstanding":
        v = int(rng.integers(0, 40))
        for r in regs:
            r.gauge(name).set(v)
    else:
        n = int(rng.integers(0, 1 << 20))
        for r in regs:
            r.counter(name).inc(n)


@pytest.mark.parametrize("history", [2, 5, 120])
@pytest.mark.parametrize("seed", range(4))
def test_windowed_queries_match_reference(ref, seed, history):
    rng = np.random.default_rng(seed)
    rp, rr = MetricsRegistry(), ref["metrics"].MetricsRegistry()
    sp = pt.TelemetryStore(rp, window_s=0.0, history=history)
    sr = ref["tsdb"].TelemetryStore(rr, window_s=0.0, history=history)
    now = 5000.0
    for step in range(30):
        for _ in range(int(rng.integers(0, 4))):
            _apply(rng, (rp, rr))
        now += float(rng.uniform(0.05, 1.5))
        sp.sample(now=now)
        sr.sample(now=now)
        for name in NAMES + ("tsdb.samples", "pool.outstanding.high_water",
                             "missing.name"):
            assert sp.last(name) == sr.last(name)
            for span in SPANS:
                assert list(sp.window(name, span)) == \
                    list(sr.window(name, span))
                assert tuple(sp.delta(name, span)) == \
                    tuple(sr.delta(name, span))
                assert tuple(sp.rate(name, span)) == \
                    tuple(sr.rate(name, span))
        assert sp.stats() == sr.stats()
    assert sp.evicted == sr.evicted == max(0, 30 - history)
    assert rp.counter("tsdb.evictions").value == \
        rr.counter("tsdb.evictions").value


@pytest.mark.parametrize("seed", range(3))
def test_rollup_and_job_history_match_reference(ref, seed):
    rng = np.random.default_rng(seed)
    sp = pt.TelemetryStore(MetricsRegistry(), window_s=0.0, history=3)
    sr = ref["tsdb"].TelemetryStore(ref["metrics"].MetricsRegistry(),
                                    window_s=0.0, history=3)
    for i in range(25):
        if rng.random() < 0.5:
            line = {"kind": "rollup", "tenant": ["", "a", None][i % 3],
                    "shuffle_id": int(rng.integers(3)), "reads": i,
                    "ts": float(i)}
            sp.observe_rollup(line)
            sr.observe_rollup(line)
        else:
            line = {"kind": "job", "tenant": ["", "b"][i % 2],
                    "job": ["q64", "q95", None][int(rng.integers(3))],
                    "ts": float(rng.uniform(0, 100))}
            sp.observe_job(line)
            sr.observe_job(line)
    for tenant in ("", "a", "b"):
        for sid in range(3):
            assert sp.rollup_history(sid, tenant) == \
                sr.rollup_history(sid, tenant)
        for job in ("q64", "q95", ""):
            assert sp.job_history(job, tenant) == \
                sr.job_history(job, tenant)
    for limit in (0, 1, 4):
        assert sp.job_lines(limit) == sr.job_lines(limit)
    assert sp.stats() == sr.stats()


def test_extra_sources_fold_in_under_the_primary(ref):
    for mod, reg in ((pt, MetricsRegistry()),
                     (ref["tsdb"], ref["metrics"].MetricsRegistry())):
        reg.counter("shuffle.bytes").inc(7)
        store = mod.TelemetryStore(
            reg, window_s=0.0, history=4,
            extra_sources=(lambda: {"store.spill_bytes": 3,
                                    "shuffle.bytes": 99, "h": {"x": 1}},))
        store.sample(now=1.0)
        assert store.last("store.spill_bytes") == 3
        assert store.last("shuffle.bytes") == 7       # the primary wins
        assert store.last("h") is None                # not a scalar


def test_null_store_answers_like_reference(ref):
    np_, nr = pt.NULL_TELEMETRY, ref["tsdb"].NULL_TELEMETRY
    assert np_.enabled is nr.enabled is False
    for store in (np_, nr):
        store.start()
        store.sample(now=1.0)
        store.observe_rollup({"shuffle_id": 1})
        store.observe_job({"job": "j"})
        store.stop()
    assert np_.last("x") == nr.last("x") is None
    assert tuple(np_.delta("x")) == tuple(nr.delta("x")) == (0.0, 0.0)
    assert tuple(np_.rate("x", 1.0)) == tuple(nr.rate("x", 1.0))
    assert tuple(np_.window("x")) == tuple(nr.window("x")) == ()
    assert tuple(np_.rollup_history(1)) == ()
    assert tuple(np_.job_lines()) == () and np_.stats() == nr.stats() == {}


def test_failing_source_never_raises():
    def boom():
        raise RuntimeError("source down")

    store = pt.TelemetryStore(MetricsRegistry(), window_s=0.0,
                              history=4, extra_sources=(boom,))
    store.sample(now=1.0)
    store.sample(now=2.0)
    assert store.sample_errors == 2 and store.stats()["samples"] == 0


@pytest.mark.parametrize("kw", [dict(window_s=-1.0), dict(history=1)])
def test_constructor_refuses_like_reference(ref, kw):
    for mod, reg in ((pt, MetricsRegistry()),
                     (ref["tsdb"], ref["metrics"].MetricsRegistry())):
        with pytest.raises(ValueError):
            mod.TelemetryStore(reg, **kw)


def test_sampler_thread_starts_and_stops():
    store = pt.TelemetryStore(MetricsRegistry(), window_s=3600.0)
    store.start()
    assert store._thread is not None and store._thread.is_alive()
    store.stop()                      # the stop event wakes the wait
    assert store._thread is None


@pytest.mark.parametrize("stats,sink,window,on", [
    (False, False, 1.0, False), (True, False, 1.0, True),
    (False, True, 1.0, True), (True, True, 0.0, False)])
def test_manager_telemetry_gate(tmp_path, stats, sink, window, on):
    """The reference's gate: telemetry runs with either knob and a
    window, whatever the port's always-on registry says."""
    before = {t.ident for t in threading.enumerate()}
    conf = ShuffleConf(slot_records=64, collect_shuffle_read_stats=stats,
                       metrics_sink=str(tmp_path / "j") if sink else "",
                       telemetry_window_s=window)
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    assert m.telemetry.enabled == on
    assert (m.telemetry is pt.NULL_TELEMETRY) == (not on)
    started = {t.ident for t in threading.enumerate()} - before
    assert bool(started) == on
    m.stop()
    assert not ({t.ident for t in threading.enumerate()} - before)


def test_job_lines_reach_the_store(tmp_path):
    """``manager.job()`` passes the telemetry store to its trace: the
    job line lands in the per-job ring (the probe's ``/jobs``)."""
    conf = ShuffleConf(slot_records=64, metrics_sink=str(tmp_path / "j"),
                       telemetry_window_s=3600.0)
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    with m.job("q1") as job:
        pass
    lines = m.telemetry.job_history("q1")
    assert len(lines) == 1 and lines[0]["trace_id"] == job.trace_id
    assert m.telemetry.job_lines() == lines
    m.stop()
