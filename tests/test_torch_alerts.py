"""The port's alert evaluator and baselines against the reference's.

Each of the nine built-in rules is driven through the same telemetry
sequence on both packages — registries fed the same counter operations
and sampled at the same injected times, the same heartbeat ages, rollup
tails, tenant usage and baselines — and must fire and resolve with the
same ``{"kind": "alert"}`` lines, the same counters and the same
``active()`` / ``health()`` views. Hysteresis is held at several
``fire_after`` / ``resolve_after`` pairs on a flapping signal.
``baselines.json`` is byte-equal after the same observations, and the
manager's wiring runs ``spill_storm`` through the real path: the tiered
store's counter in the process-wide registry, the telemetry store, the
evaluator and the journal.
"""

import json

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.obs import alerts as pa
from sparkrdma_tpu_torch.obs import baseline as pb
from sparkrdma_tpu_torch.obs import tsdb as pt
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry, global_registry


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.obs import alerts as ra
    from sparkrdma_tpu.obs import baseline as rb
    from sparkrdma_tpu.obs import metrics as rm
    from sparkrdma_tpu.obs import tsdb as rt

    return {"alerts": ra, "baseline": rb, "metrics": rm, "tsdb": rt}


class ListJournal:
    def __init__(self):
        self.lines = []

    def emit_raw(self, d):
        self.lines.append(json.loads(json.dumps(d)))


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Beat:
    """A heartbeat stand-in: its age is set by the scenario."""

    interval_s = 1.0

    def __init__(self):
        self.age = 0.0

    def age_s(self, now=None):
        return self.age


class Side:
    """One package's evaluator and everything it reads."""

    def __init__(self, mods, tmp, fire, resolve):
        self.reg = mods["metrics"].MetricsRegistry()
        self.store = mods["tsdb"].TelemetryStore(self.reg, window_s=0.0,
                                                 history=16)
        self.journal = ListJournal()
        self.beat = Beat()
        self.usage = {}
        self.clock = Clock()
        self.baselines = mods["baseline"].BaselineStore(str(tmp),
                                                        alpha=0.01)
        for _ in range(3):
            self.baselines.observe("shuffle.bytes", 1e6, geometry="w8")
            self.baselines.observe("shuffle.bytes", 1.02e6, geometry="w8")
        self.ev = mods["alerts"].AlertEvaluator(
            telemetry=self.store, metrics=self.reg, journal=self.journal,
            baselines=self.baselines, heartbeat=self.beat,
            tenants=lambda: dict(self.usage), interval_s=1.0,
            fire_after=fire, resolve_after=resolve, geometry="w8",
            clock=self.clock)


def _step(side, rule, breach, now, waits):
    """Feed one step of ``rule``'s scenario (breaching or clean)."""
    reg = side.reg
    if rule == "spill_storm" and breach:
        reg.counter("store.spill_bytes").inc(1 << 20)
    elif rule == "sync_fetch_storm" and breach:
        reg.counter("store.sync_fetches").inc(3)
    elif rule == "admission_pileup" and breach:
        reg.counter("service.admission_waits").inc()
    elif rule == "journal_errors" and breach:
        reg.counter("journal.write_errors").inc()
    elif rule == "degrade_rung" and breach:
        reg.counter("degrade.serde_native").inc()
    elif rule == "heartbeat_stale":
        side.beat.age = 10.0 if breach else 0.5
    elif rule == "straggler_spread":
        side.store.observe_rollup({
            "tenant": "a", "shuffle_id": 5, "reads": 8, "ts": now,
            "lat_sum_ms": 80.0, "p50_ms": 10.0,
            "lat_max_ms": 100.0 if breach else 12.0})
    elif rule == "tenant_quota_pileup":
        side.usage = {"a": {"hbm": 1, "host": 0, "disk": 0,
                            "quota_waits": waits}}
    elif rule == "throughput_anomaly":
        reg.counter("shuffle.bytes").inc(1000 if breach else 1_000_000)


SCENARIO = [False, False] + [True] * 4 + [False] * 6


def _run(ref, tmp_path, rule, fire=2, resolve=2, scenario=SCENARIO):
    sides = [Side(mods, tmp_path / name, fire, resolve)
             for name, mods in (("port", {"alerts": pa, "baseline": pb,
                                          "metrics": _PortMetrics,
                                          "tsdb": pt}),
                                ("ref", ref))]
    rules = {rule: pa.ALERT_RULES[rule]}
    sides[1].ev._rules = {rule: ref["alerts"].ALERT_RULES[rule]}
    sides[0].ev._rules = rules
    now, waits = 1000.0, 0
    for breach in scenario:
        now += 1.0
        waits += int(breach)
        for side in sides:
            side.clock.t = now
            _step(side, rule, breach, now, waits)
            side.store.sample(now=now)
            side.ev.evaluate_once(now=now)
    return sides


class _PortMetrics:
    MetricsRegistry = MetricsRegistry


def test_rule_registry_matches_reference(ref):
    rr = ref["alerts"].ALERT_RULES
    assert sorted(pa.ALERT_RULES) == sorted(rr) and len(rr) == 9
    for rid, rule in pa.ALERT_RULES.items():
        r = rr[rid]
        assert (rule.severity, rule.subsystem, rule.condition,
                rule.metrics, rule.description) == \
            (r.severity, r.subsystem, r.condition, r.metrics,
             r.description)
    assert pa.ALERT_FIELDS == ref["alerts"].ALERT_FIELDS
    assert pa.SEVERITIES == ref["alerts"].SEVERITIES
    assert pa.CONDITIONS == ref["alerts"].CONDITIONS


@pytest.mark.parametrize("rule", sorted([
    "spill_storm", "sync_fetch_storm", "admission_pileup",
    "journal_errors", "degrade_rung", "heartbeat_stale",
    "straggler_spread", "tenant_quota_pileup", "throughput_anomaly"]))
def test_rule_fires_and_resolves_like_reference(ref, tmp_path, rule):
    port, want = _run(ref, tmp_path, rule)
    assert port.journal.lines == want.journal.lines
    events = [(d["rule"], d["event"]) for d in port.journal.lines]
    assert events == [(rule, "fired"), (rule, "resolved")]
    assert all(set(d) == pa.ALERT_FIELDS for d in port.journal.lines)
    for name in ("alerts.fired", "alerts.resolved"):
        assert port.reg.counter(name).value == \
            want.reg.counter(name).value == 1
    assert port.reg.gauge("alerts.active").value == 0
    assert port.ev.stats() == want.ev.stats()


@pytest.mark.parametrize("fire,resolve", [(1, 1), (3, 2), (2, 3)])
def test_hysteresis_matches_reference(ref, tmp_path, fire, resolve):
    """A flapping spill signal: the same single alert (or none) on both
    sides, at the same evaluations."""
    flap = [False, True, True, False, True, True, True, False, True,
            False, False, False, False, True, False, False, False, False]
    port, want = _run(ref, tmp_path, "spill_storm", fire, resolve, flap)
    assert port.journal.lines == want.journal.lines
    assert port.ev.stats() == want.ev.stats()


def test_active_and_health_match_reference(ref, tmp_path):
    """Mid-alert: the live views (``ts`` from the injected clock)."""
    port, want = _run(ref, tmp_path, "journal_errors",
                      scenario=[True, True, True])
    assert port.ev.active() == want.ev.active()
    assert len(port.ev.active()) == 1
    assert port.ev.health() == want.ev.health()
    assert port.ev.health()["status"] == "crit"


def test_crashing_rule_is_counted_and_others_run(ref):
    def boom(ctx):
        raise RuntimeError("rule bug")

    j = ListJournal()
    reg = MetricsRegistry()
    store = pt.TelemetryStore(reg, window_s=0.0, history=4)
    rules = {"a_boom": pa.AlertRule("a_boom", "warn", "t", "derived", (),
                                    "", boom),
             "spill_storm": pa.ALERT_RULES["spill_storm"]}
    ev = pa.AlertEvaluator(telemetry=store, metrics=reg, journal=j,
                           rules=rules, fire_after=1)
    reg.counter("store.spill_bytes").inc(0)
    store.sample(now=1.0)
    reg.counter("store.spill_bytes").inc(5)
    store.sample(now=2.0)
    lines = ev.evaluate_once(now=2.0)
    assert [d["rule"] for d in lines] == ["spill_storm"]
    assert ev.stats()["eval_errors"] == 1 and j.lines == lines


@pytest.mark.parametrize("kw", [dict(interval_s=-1.0), dict(fire_after=0),
                                dict(resolve_after=0)])
def test_evaluator_refuses_like_reference(ref, kw):
    for mod, reg in ((pa, MetricsRegistry()),
                     (ref["alerts"], ref["metrics"].MetricsRegistry())):
        with pytest.raises(ValueError):
            mod.AlertEvaluator(telemetry=pt.NULL_TELEMETRY, metrics=reg,
                               **kw)


# ---------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_baselines_json_byte_equal(ref, tmp_path, seed):
    rng = np.random.default_rng(seed)
    bp = pb.BaselineStore(str(tmp_path / "p"), alpha=0.3)
    br = ref["baseline"].BaselineStore(str(tmp_path / "r"), alpha=0.3)
    for _ in range(200):
        metric = ["shuffle.bytes", "store.spill_bytes", "x"][
            int(rng.integers(3))]
        geom = ["", "w8", "w4"][int(rng.integers(3))]
        v = float(rng.lognormal(10, 1))
        assert bp.observe(metric, v, geom) == br.observe(metric, v, geom)
    for metric, geom in (("shuffle.bytes", "w8"), ("x", ""), ("y", "")):
        for v in (0.0, 1e4, 1e6):
            assert bp.zscore(metric, v, geom) == br.zscore(metric, v, geom)
    assert bp.save() and br.save()
    assert (tmp_path / "p" / "baselines.json").read_bytes() == \
        (tmp_path / "r" / "baselines.json").read_bytes()
    # a fresh store reads it back
    again = pb.BaselineStore(str(tmp_path / "p"))
    assert again.stats()["entries"] == bp.stats()["entries"]
    assert again.get("x") == bp.get("x")


def test_baseline_from_telemetry_byte_equal(ref, tmp_path):
    port, want = _run(ref, tmp_path, "throughput_anomaly")
    assert port.baselines.save() and want.baselines.save()
    assert (tmp_path / "port" / "baselines.json").read_bytes() == \
        (tmp_path / "ref" / "baselines.json").read_bytes()


@pytest.mark.parametrize("content", [b"{not json", b'{"schema": 99}',
                                     b'{"schema": 1, "entries": []}',
                                     b'{"schema": 1, "entries": '
                                     b'{"a": {"median": "x"}}}'])
def test_baseline_unreadable_file_starts_fresh_like_reference(
        ref, tmp_path, content):
    for mod, name in ((pb, "p"), (ref["baseline"], "r")):
        d = tmp_path / name
        d.mkdir()
        (d / "baselines.json").write_bytes(content)
        store = mod.BaselineStore(str(d))
        assert store.load_errors == 1 and store.stats()["entries"] == 0


def test_baseline_alpha_refused():
    with pytest.raises(ValueError):
        pb.BaselineStore("unused", alpha=0.0)


# ---------------------------------------------------------------------
# the manager's wiring
# ---------------------------------------------------------------------
def test_manager_alerts_only_with_telemetry_and_cadence(tmp_path):
    base = dict(slot_records=64, metrics_sink=str(tmp_path / "j"))
    for kw, on in ((dict(alert_eval_s=1.0), False),
                   (dict(telemetry_window_s=3600.0), False),
                   (dict(telemetry_window_s=3600.0, alert_eval_s=3600.0),
                    True)):
        m = ShuffleManager(MeshRuntime(ShuffleConf(**base, **kw), 8,
                                       device="cpu"))
        assert (m.alerts is not None) == on
        m.stop()


def test_spill_storm_through_the_manager(tmp_path):
    """The real path: the process-wide ``store.spill_bytes`` counter,
    folded into the manager's telemetry, fires ``spill_storm`` into the
    journal; ``stop`` saves the baselines."""
    sink = tmp_path / "j.jsonl"
    conf = ShuffleConf(slot_records=64, metrics_sink=str(sink),
                       telemetry_window_s=3600.0, telemetry_history=2,
                       alert_eval_s=3600.0, alert_fire_breaches=1,
                       alert_resolve_windows=1,
                       baseline_dir=str(tmp_path / "base"))
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    spill = global_registry().counter("store.spill_bytes")
    spill.inc(0)                      # a series from the first sample
    m.telemetry.sample(now=100.0)
    spill.inc(1 << 22)
    m.telemetry.sample(now=101.0)
    fired = m.alerts.evaluate_once(now=101.0)
    assert [d["rule"] for d in fired] == ["spill_storm"]
    assert m.alerts.health()["status"] == "warn"
    assert m.alerts.health()["score"] == 75
    m.telemetry.sample(now=104.0)     # the ring of 2 drops the spike
    resolved = m.alerts.evaluate_once(now=104.0)
    assert [(d["rule"], d["event"]) for d in resolved] == \
        [("spill_storm", "resolved")]
    m.stop()
    lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert [d["event"] for d in lines if d.get("kind") == "alert"] == \
        ["fired", "resolved"]
    assert pb.BaselineStore(str(tmp_path / "base")).stats()["entries"] > 0
