"""The port's metrics, journal and read stats against the reference's.

Held exactly equal to ``sparkrdma_tpu.obs`` on the same seeded inputs:
histogram buckets and ``bucket_quantile``; the sampling hash ``_mix64``
and ``SamplingPolicy`` over 10,000 span ids under four specs; the
journal's line format, both ways (a line either package writes parses
under the other's ``read_journal`` / ``read_entries`` with the same
fields); the retry span after an injected fault; the five observability
knobs of ``ShuffleConf``. Also the journal's own contracts (a failing
sink never raises, rotation, the ``{process}`` placeholder), the
reference's two stdlib CLIs reading a port journal, and the port's
metric names against ``obs/names.py`` both ways (what srlint's
``counter-name-sync`` rule does for the reference).
"""

import ast
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.obs import journal as pj
from sparkrdma_tpu_torch.obs import metrics as pm
from sparkrdma_tpu_torch.obs.stats import ExchangeRecord, ShuffleReadStats

REPO = Path(__file__).resolve().parent.parent
SPECS = ("all", "1/8", "1/8+slow:250", "none")


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu import faults as ref_faults
    from sparkrdma_tpu.obs import journal as rj
    from sparkrdma_tpu.obs import metrics as rm

    return {"journal": rj, "metrics": rm, "faults": ref_faults}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------
# histograms and quantiles
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", [None, (1, 2, 4, 8, 16)])
def test_histogram_matches_reference(ref, seed, bounds):
    obs = np.random.default_rng(seed).lognormal(-3, 2.5, size=2000)
    hp = pm.Histogram("h", bounds)
    hr = ref["metrics"].Histogram("h", bounds)
    for v in obs.tolist():
        hp.observe(v)
        hr.observe(v)
    assert hp.snapshot() == hr.snapshot()
    assert (hp.count, hp.sum, hp.mean) == (hr.count, hr.sum, hr.mean)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0, -1.0, 2.0):
        assert hp.quantile(q) == hr.quantile(q)


@pytest.mark.parametrize("seed", range(4))
def test_bucket_quantile_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    bounds = sorted(rng.uniform(0, 100, size=6).tolist())
    buckets = rng.integers(0, 5, size=7).tolist()
    lo, hi = (None, None) if seed % 2 else (0.5, 150.0)
    for q in np.linspace(0, 1, 21).tolist():
        assert pm.bucket_quantile(bounds, buckets, q, lo, hi) == \
            ref["metrics"].bucket_quantile(bounds, buckets, q, lo, hi)


def test_registry_surface_matches_reference(ref):
    """The same instruments give the same snapshot, gauge high-water and
    null instruments included."""
    regs = [pm.MetricsRegistry(), ref["metrics"].MetricsRegistry()]
    for r in regs:
        r.counter("a").inc(3)
        g = r.gauge("g")
        g.set(5)
        g.add(-2)
        g.update_max(9)
        r.histogram("h").observe(0.25)
    assert regs[0].snapshot() == regs[1].snapshot()
    for mod in (pm, ref["metrics"]):
        off = mod.MetricsRegistry(enabled=False)
        assert off.counter("x") is off.counter("y")
        off.counter("x").inc(5)
        off.gauge("g").set(3)
        off.histogram("h").observe(1.0)
        assert off.snapshot() == {} and off.counter("x").value == 0
    regs[0].reset()
    assert regs[0].snapshot() == {}


def test_set_global_registry_swaps_and_restores():
    mine = pm.MetricsRegistry()
    prev = pm.set_global_registry(mine)
    try:
        assert pm.global_registry() is mine
    finally:
        assert pm.set_global_registry(prev) is mine
    assert pm.global_registry() is prev


# ---------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------
def test_mix64_matches_reference(ref):
    ids = list(range(10_000)) + [2**63 - 1, 2**64 - 1, 0x9E3779B97F4A7C15]
    assert [pj._mix64(i) for i in ids] == \
        [ref["journal"]._mix64(i) for i in ids]


@pytest.mark.parametrize("spec", SPECS)
def test_keep_weight_matches_reference(ref, spec):
    """The same keep/drop bits and weights for 10,000 span ids; ``none``
    is refused by both."""
    if spec == "none":
        for mod in (pj, ref["journal"]):
            with pytest.raises(ValueError):
                mod.SamplingPolicy.parse(spec)
        return
    pp = pj.SamplingPolicy.parse(spec)
    rp = ref["journal"].SamplingPolicy.parse(spec)
    assert dataclasses.astuple(pp) == dataclasses.astuple(rp)
    elapsed = np.random.default_rng(7).exponential(0.2, size=10_000)
    got = [pp.keep_weight(i, float(e)) for i, e in enumerate(elapsed, 1)]
    want = [rp.keep_weight(i, float(e)) for i, e in enumerate(elapsed, 1)]
    assert got == want
    if spec != "all":
        assert 0 < sum(w > 0 for w in got) < len(got)


@pytest.mark.parametrize("spec", ["", " all ", "1/1", "slow:0", "1/3+slow:1.5",
                                  "1/0", "1/x", "slow:-1", "slow:nan",
                                  "bogus", "1/4+slow:"])
def test_sampling_parse_matches_reference(ref, spec):
    def parse(mod):
        try:
            return dataclasses.astuple(mod.SamplingPolicy.parse(spec))
        except ValueError:
            return "ValueError"

    assert parse(pj) == parse(ref["journal"])


# ---------------------------------------------------------------------
# the journal's line format, both ways
# ---------------------------------------------------------------------
def _span_kwargs():
    return dict(span_id=7, shuffle_id=3, transport="pallas_ring", rounds=34,
                dispatches=36, records=1000, record_bytes=100, plan_s=0.01,
                exchange_s=0.2, sort_s=0.0,
                per_peer_records=[125] * 8, pool_high_water=4, retry_count=1,
                backoff_ms=[1.5], events=[{"t": 0.0, "ph": "B",
                                           "name": "plan"}],
                combine_in_records=10, pushdown_rows_dropped=2,
                phase_s={"plan": 0.01, "other": 0.2},
                bottleneck="fabric-bound", trace_id="t1-1", job="j",
                stage="s", stage_attempt=2, ts=1.0)


def test_span_fields_match_reference(ref):
    """Same fields, same order, same schema version."""
    names = [f.name for f in dataclasses.fields(pj.ExchangeSpan)]
    assert names == [f.name for f in
                     dataclasses.fields(ref["journal"].ExchangeSpan)]
    assert pj.SCHEMA_VERSION == ref["journal"].SCHEMA_VERSION == 14


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_journal_lines_cross_read(ref, tmp_path, direction):
    """A span and every aux kind the port writes (stall, job, plan) parse
    under the other package's readers with the same fields."""
    mods = (pj, ref["journal"])
    writer, reader = mods if direction == "port_to_ref" else mods[::-1]
    path = str(tmp_path / "j.jsonl")
    j = writer.ExchangeJournal(path)
    span = writer.ExchangeSpan(**_span_kwargs())
    j.emit(span)
    aux = [{"kind": "stall", "desc": "queue:block", "chunk": 9,
            "elapsed_s": 0.21, "ts": 2.0},
           {"kind": "job", "schema": 14, "trace_id": "t1-1", "stages": []},
           {"kind": "plan", "schema": 14, "node": "repartition#0",
            "rewrite": "reuse"}]
    for line in aux:
        j.emit_raw(line)
    j.close()
    (back,) = reader.read_journal(path)
    assert dataclasses.asdict(back) == dataclasses.asdict(span)
    entries = reader.read_entries(path)
    assert entries[0] == span.to_dict()
    assert entries[1:] == aux


def test_journal_failing_sink_never_raises():
    class Exploding(io.StringIO):
        def write(self, s):
            raise OSError(28, "No space left on device")

    reg = pm.MetricsRegistry()
    j = pj.ExchangeJournal(Exploding(), metrics=reg)
    j.emit(pj.ExchangeSpan(**_span_kwargs()))
    assert j.write_errors == 1 and not j.enabled
    assert reg.counter("journal.write_errors").value == 1
    j.emit(pj.ExchangeSpan(**_span_kwargs()))        # dead sink: no-op
    assert j.emitted == 0


def test_journal_lazy_sink_and_rotation(tmp_path):
    path = tmp_path / "j.jsonl"
    reg = pm.MetricsRegistry()
    j = pj.ExchangeJournal(str(path), metrics=reg, max_bytes=600)
    assert not path.exists()                  # nothing written yet
    for i in range(6):
        j.emit(pj.ExchangeSpan(**dict(_span_kwargs(), span_id=i + 1)))
    j.close()
    segs = pj.rotated_paths(str(path))
    assert j.rotations >= 1
    assert len(segs) == j.rotations + (1 if path.exists() else 0)
    assert reg.counter("journal.rotations").value == j.rotations
    spans = pj.read_journal(str(path), include_rotated=True)
    assert [s.span_id for s in spans] == list(range(1, 7))


def test_process_placeholder_and_stats_print(tmp_path, caplog):
    """A ``{process}`` sink names the host's own file; ``stop`` prints the
    read stats' per-source table, as the reference's manager does."""
    m, h = _manager(tmp_path, metrics_sink=str(tmp_path / "j-{process}.jsonl"),
                    collect_shuffle_read_stats=True)
    m.get_reader(h).read()
    with caplog.at_level("INFO", logger="sparkrdma_tpu_torch.stats"):
        m.stop()
    assert (tmp_path / "j-0.jsonl").exists()
    assert "source 0:" in caplog.text
    assert m.stats.summary()["exchanges"] == 1
    snap = m.metrics.snapshot()
    assert snap["shuffle.exchanges"] == 1
    assert snap["shuffle.exec_s"]["count"] == 1
    assert snap["exchange.plan_s"]["count"] == 1


def test_read_stats_match_reference(ref):
    """``ShuffleReadStats`` folds the same records into the same table,
    summary and registry."""
    from sparkrdma_tpu.obs.stats import ExchangeRecord as RefRecord
    from sparkrdma_tpu.obs.stats import ShuffleReadStats as RefStats

    rng = np.random.default_rng(3)
    pair = [(ShuffleReadStats(registry=pm.MetricsRegistry()), ExchangeRecord),
            (RefStats(registry=ref["metrics"].MetricsRegistry()), RefRecord)]
    for i in range(5):
        per = rng.integers(0, 100, size=8)
        for stats, rec in pair:
            stats.add(rec(shuffle_id=i, plan_s=0.001 * i, exec_s=0.01 + i,
                          total_records=int(per.sum()), record_bytes=100,
                          num_rounds=i + 1, per_source_records=per))
    (ps, _), (rs, _) = pair
    assert ps.per_source_histogram() == rs.per_source_histogram()
    assert ps.summary() == rs.summary()
    assert ps.print_histogram() == rs.print_histogram()
    assert ps.registry.snapshot() == rs.registry.snapshot()


# ---------------------------------------------------------------------
# the manager's spans
# ---------------------------------------------------------------------
def _rows(seed=0, n=8 * 16):
    return np.random.default_rng(seed).integers(1, 2**32, size=(n, 4),
                                                dtype=np.uint32)


def _manager(tmp_path, **kw):
    conf = ShuffleConf(**dict(dict(slot_records=64), **kw))
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    h = m.register_shuffle(93, 8, modulo_partitioner(8))
    m.get_writer(h).write(m.runtime.shard_records(_rows())).stop(True)
    return m, h


def test_retry_span_matches_reference(ref, tmp_path):
    """One injected ``exchange.dispatch`` failure: one span, whose
    ``retry_count`` and ``len(backoff_ms)`` equal the reference's."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.exchange.partitioners import \
        modulo_partitioner as ref_mod

    kw = dict(slot_records=64, max_retry_attempts=3, retry_backoff_ms=0.5,
              collect_shuffle_read_stats=True,
              fault_spec="exchange.dispatch:fail@attempt<1")
    spans = {}
    for name in ("ref", "port"):
        sink = str(tmp_path / f"{name}.jsonl")
        if name == "ref":
            rc = RefConf(metrics_sink=sink, **kw)
            m = RefManager(RefRuntime(rc), rc)
            part = ref_mod(8)
        else:
            m = ShuffleManager(MeshRuntime(ShuffleConf(metrics_sink=sink,
                                                       **kw), 8,
                                           device="cpu"))
            part = modulo_partitioner(8)
        try:
            h = m.register_shuffle(93, 8, part)
            m.get_writer(h).write(m.runtime.shard_records(_rows())).stop(
                True)
            m.get_reader(h).read()
        finally:
            m.stop()
        (spans[name],) = (ref["journal"] if name == "ref" else pj
                          ).read_journal(sink)
    p, r = spans["port"], spans["ref"]
    assert p.retry_count == r.retry_count == 1
    assert len(p.backoff_ms) == len(r.backoff_ms) == 1
    # the backoff is the reference's schedule for the port's span id
    assert p.backoff_ms == [round(ref["faults"].backoff_ms(
        1, 0.5, p.span_id), 3)]
    names = [e["name"] for e in p.events]
    assert names.count("retry") == names.count("retry:backoff") == 1
    assert "fault:injected" in names


def test_sampling_thins_spans_not_metrics(tmp_path):
    sink = tmp_path / "s.jsonl"
    m, h = _manager(tmp_path, metrics_sink=str(sink), journal_sample="1/4")
    for _ in range(12):
        m.get_reader(h).read()
    m.stop()
    spans = pj.read_journal(str(sink))
    dropped = m.metrics.counter("journal.sampled_out").value
    assert len(spans) + dropped == 12 and 0 < len(spans) < 12
    assert all(s.sample_weight == 4 for s in spans)


def test_unrecorded_reads_write_no_span(tmp_path):
    sink = tmp_path / "u.jsonl"
    m, h = _manager(tmp_path, metrics_sink=str(sink))
    m.get_reader(h).read(record_stats=False)
    m.get_reader(h).read()
    m.stop()
    (span,) = pj.read_journal(str(sink))
    # the un-recorded read's events wait for the next span
    assert [(e["name"], e["ph"]) for e in span.events].count(
        ("exchange:fused", "B")) == 2


@pytest.mark.parametrize("knob,value", [
    ("collect_shuffle_read_stats", None), ("metrics_sink", None),
    ("journal_sample", None), ("journal_max_bytes", None),
    ("watchdog_timeout_s", None), ("watchdog_timeout_s", -1.0),
    ("journal_max_bytes", -1), ("journal_sample", "1/0")])
def test_knobs_match_reference(knob, value):
    """The five knobs: the reference's defaults, and the same values
    refused."""
    from sparkrdma_tpu import ShuffleConf as RefConf

    if value is None:
        assert getattr(ShuffleConf(), knob) == getattr(RefConf(), knob)
        return
    for conf in (ShuffleConf, RefConf):
        with pytest.raises(ValueError):
            conf(**{knob: value})


# ---------------------------------------------------------------------
# the reference's CLIs on a port journal
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_journal(tmp_path_factory):
    """A port journal with a fused and a streaming read in one job."""
    root = tmp_path_factory.mktemp("cli")
    sink = root / "j.jsonl"
    conf = ShuffleConf(slot_records=8, queue_depth=2, metrics_sink=str(sink))
    m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
    with m.job("cli_job") as job:
        for sid in (1, 2):
            h = m.register_shuffle(sid, 8, modulo_partitioner(8))
            rows = _rows(sid, n=8 * (16 if sid == 1 else 64))
            with job.stage("exchange", attempt=sid):
                m.get_writer(h).write(m.runtime.shard_records(rows)).stop(
                    True)
                m.get_reader(h).read()
    m.stop()
    return sink


def test_shuffle_report_reads_port_journal(port_journal, capsys):
    report = _script("shuffle_report")
    assert report.main([str(port_journal), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(pj.read_journal(str(port_journal))) == out["spans"] == 2


def test_shuffle_trace_reads_port_journal(port_journal, tmp_path):
    trace = _script("shuffle_trace")
    out = tmp_path / "trace.json"
    assert trace.main([str(port_journal), "-o", str(out)]) == 0
    evs = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"chunk", "exchange:fused"} & names
    assert any(e["ph"] == "C" and e["name"] == "chunks.outstanding"
               for e in evs)


# ---------------------------------------------------------------------
# the port's metric names against obs/names.py, both ways
# ---------------------------------------------------------------------
_EMIT = ("counter", "gauge", "histogram")


def _declared():
    tree = ast.parse((REPO / "sparkrdma_tpu_torch/obs/names.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):      # frozenset({...})
            out[node.targets[0].id] = {e.value
                                       for e in node.value.args[0].elts}
    return out


def _emitted():
    """``(kind, name)`` of every literal emission and the skeleton of
    every f-string one (``*`` per hole) in the port's source."""
    names, patterns = set(), set()
    for path in sorted((REPO / "sparkrdma_tpu_torch").rglob("*.py")):
        if path.name == "names.py" and path.parent.name == "obs":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT and node.args):
                continue
            stack = [node.args[0]]
            while stack:
                e = stack.pop()
                if isinstance(e, ast.IfExp):
                    stack += [e.body, e.orelse]
                elif isinstance(e, ast.Constant) and isinstance(e.value,
                                                                str):
                    names.add((node.func.attr, e.value, len(node.args)))
                elif isinstance(e, ast.JoinedStr):
                    patterns.add("".join(
                        v.value if isinstance(v, ast.Constant) else "*"
                        for v in e.values))
    return names, patterns


def test_metric_names_declared_both_ways():
    import fnmatch

    decl = _declared()
    names, patterns = _emitted()
    allowed = {"counter": decl["COUNTERS"] | decl["TIMELINE_TRACKS"],
               "gauge": decl["GAUGES"], "histogram": decl["HISTOGRAMS"]}
    undeclared = sorted((k, n) for k, n, _ in names if n not in allowed[k])
    assert not undeclared, f"emitted but not in obs/names.py: {undeclared}"
    emitted = {n for _, n, _ in names}
    declared = (decl["COUNTERS"] | decl["GAUGES"] | decl["HISTOGRAMS"]
                | decl["TIMELINE_TRACKS"])
    assert not declared - emitted, \
        f"declared but never emitted: {sorted(declared - emitted)}"
    # a timeline track is a two-argument counter() call
    tracks = {n for k, n, nargs in names if k == "counter" and nargs == 2}
    assert tracks == decl["TIMELINE_TRACKS"]
    # every f-string family covers a declared wildcard, and every
    # wildcard is covered by one
    for p in patterns:
        assert any(fnmatch.fnmatchcase(w, p) for w in decl["WILDCARDS"]), p
    for w in decl["WILDCARDS"]:
        assert any(fnmatch.fnmatchcase(w, p) for p in patterns), w


def test_port_names_are_the_reference_names_it_shares():
    """Every name the port declares is one the reference declares too
    (same spelling, same kind), so the reference's CLIs read them; the
    port's own counters (``PORT_ONLY``) are the exception, and none of
    them is a name of the reference's."""
    from sparkrdma_tpu.obs import names as rn

    from sparkrdma_tpu_torch.obs import names as pn

    for kind in ("COUNTERS", "GAUGES", "HISTOGRAMS", "TIMELINE_TRACKS",
                 "WILDCARDS"):
        assert getattr(pn, kind) - pn.PORT_ONLY <= getattr(rn, kind), kind
    assert pn.PORT_ONLY <= pn.COUNTERS
    assert not pn.PORT_ONLY & (rn.COUNTERS | rn.GAUGES | rn.HISTOGRAMS)


def test_direct_exchange_span_matches_reference(ref, tmp_path):
    """``ShuffleExchange.shuffle`` without a manager: one stats record and
    one span, whose fields other than times and ids equal the
    reference's."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.exchange.partitioners import \
        modulo_partitioner as ref_mod
    from sparkrdma_tpu.exchange.protocol import ShuffleExchange as RefEx

    from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange

    kw = dict(slot_records=64, collect_shuffle_read_stats=True)
    rows = _rows(5)
    lines = {}
    for name in ("ref", "port"):
        sink = str(tmp_path / f"{name}.jsonl")
        if name == "ref":
            rt = RefRuntime(RefConf(**kw))
            ex = RefEx(rt.mesh, rt.axis_name, RefConf(**kw),
                       journal=ref["journal"].ExchangeJournal(sink))
            part = ref_mod(8)
        else:
            rt = MeshRuntime(ShuffleConf(**kw), 8, device="cpu")
            ex = ShuffleExchange(rt, journal=pj.ExchangeJournal(sink))
            part = modulo_partitioner(8)
        ex.shuffle(rt.shard_records(rows), part, shuffle_id=4)
        ex.journal.close()
        assert len(ex.stats.records) == 1
        (lines[name],) = pj.read_entries(sink)
    keep = ("shuffle_id", "transport", "rounds", "dispatches", "records",
            "record_bytes", "per_peer_records", "sort_s", "schema")
    assert {k: lines["port"][k] for k in keep} == \
        {k: lines["ref"][k] for k in keep}
    assert set(lines["port"]) == set(lines["ref"])
    assert lines["port"]["bottleneck"]
