"""The query planner and the TPC-DS queries: port vs reference on the CPU.

The same seeded tables go through ``sparkrdma_tpu.plan`` /
``sparkrdma_tpu.workloads.tpcds`` (on the forced 8-device CPU mesh) and
their ports (8 partitions stacked on the CPU). Held equal (tolerance 0):
the fingerprint of every node of the same plan over named, digested
sources; the optimizer's decisions; the ``plan.*`` counters; the query
results; and the planner's output records, bit for bit, with every
``plan_*`` knob on and with all of them off (the naive replay the
reference pins in ``tests/test_plan.py``).
"""

import dataclasses

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.dataset import Dataset
from sparkrdma_tpu_torch.api.serde import RowSchema
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.plan import (BroadcastBuildError, LogicalPlan,
                                      PlanExecutor, node_fingerprint,
                                      optimize)
from sparkrdma_tpu_torch.plan.nodes import PlanNode
from sparkrdma_tpu_torch.plan.optimizer import _all_nodes
from sparkrdma_tpu_torch.workloads import tpcds

KNOBS = ("plan_pushdown", "plan_reuse", "plan_broadcast_join",
         "plan_overlap")
ALL_ON = {k: True for k in KNOBS}
ALL_OFF = {k: False for k in KNOBS}
ARMS = pytest.mark.parametrize("knobs", [ALL_ON, ALL_OFF],
                               ids=["all_on", "all_off"])


def _pair(val_words=2, **kw):
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    conf = dict(slot_records=1024, val_words=val_words, **kw)
    rc = RefConf(collect_shuffle_read_stats=True, **conf)
    return (RefManager(RefRuntime(rc), rc),
            ShuffleManager(MeshRuntime(ShuffleConf(**conf), 8,
                                       device="cpu")))


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu import plan as ref_plan
    from sparkrdma_tpu.api.dataset import Dataset as RefDataset
    from sparkrdma_tpu.api.serde import RowSchema as RefSchema
    from sparkrdma_tpu.workloads import tpcds as ref_tpcds

    return {"plan": ref_plan, "Dataset": RefDataset, "RowSchema": RefSchema,
            "tpcds": ref_tpcds}


def _star_rev_plan(m, Dataset, LogicalPlan, RowSchema, pred, name="golden",
                   rows_per_device=16):
    """The reference tests' q_star_rev plan, built over either package."""
    fact, d1t, d2t, d3t = tpcds._star_tables(8, rows_per_device, 1, 0)
    out_schema = RowSchema([("a2", "uint32"), ("a3", "uint32"),
                            ("value", "uint32"), ("a1", "uint32")])
    fact_r = LogicalPlan.dataset(
        Dataset.from_host_rows(m, fact),
        name=f"{name}_fact").repartition(stage="fact_part")
    d1 = LogicalPlan.from_host_rows(m, d1t, name=f"{name}_d1")
    d2 = LogicalPlan.from_host_rows(m, d2t, name=f"{name}_d2")
    d3 = LogicalPlan.from_host_rows(m, d3t, name=f"{name}_d3")
    return (fact_r
            .join(d1, key_from=0, attr_to=3, stage="dim1_join")
            .join(d2, key_from=1, attr_to=0, stage="dim2_join")
            .join(d3, key_from=3, attr_to=1, schema=out_schema,
                  stage="dim3_join")
            .repartition(stage="qual_part")
            .filter(pred)
            .select("value")
            .reduce_by_key("sum", stage="star_agg"))


def _both_rev_plans(ref, rm, pm):
    rq = _star_rev_plan(rm, ref["Dataset"], ref["plan"].LogicalPlan,
                        ref["RowSchema"], ref["tpcds"]._star_pred)
    pq = _star_rev_plan(pm, Dataset, LogicalPlan, RowSchema,
                        tpcds._star_pred)
    return rq, pq


@pytest.fixture(scope="module")
def star_pair():
    rm, pm = _pair(val_words=4)
    yield rm, pm
    rm.stop()
    pm.stop()


def _labels_and_fps(root):
    return [(n.label, n.op, n.fp, n.fuses_into, n.broadcast, n.prefetch)
            for n in _all_nodes(root)]


def _decisions(decisions):
    return [dataclasses.astuple(d) for d in decisions]


def test_fingerprints_match_reference(ref, star_pair):
    """Named sources with a content digest fingerprint alike, node by
    node, before and after the rewrites; a source's digest and shape are
    in its fingerprint."""
    rm, pm = star_pair
    rq, pq = _both_rev_plans(ref, rm, pm)
    assert node_fingerprint(pq.root) == \
        ref["plan"].node_fingerprint(rq.root)
    src = pq.root
    while src.children:
        src = src.children[0]
    assert src.op == "source" and src.dataset.content_digest
    assert node_fingerprint(src) == ref["plan"].node_fingerprint(
        _leftmost(rq.root))
    proot, _ = optimize(pq.root, pm.conf)
    rroot, _ = ref["plan"].optimize(rq.root, rm.conf)
    assert _labels_and_fps(proot) == _labels_and_fps(rroot)


def _leftmost(node):
    while node.children:
        node = node.children[0]
    return node


def test_fingerprint_of_anonymous_source_is_its_digest(ref):
    """An unnamed source with a digest keys by the digest alone; one
    without keys by a token that no other object (or process) gets."""
    rows = np.arange(64, dtype=np.uint32).reshape(16, 4)
    pn = PlanNode("source", rows=rows)
    from sparkrdma_tpu.plan.nodes import PlanNode as RefNode

    assert node_fingerprint(pn) == \
        ref["plan"].node_fingerprint(RefNode("source", rows=rows))

    class Src:
        content_digest = ""

        def __init__(self):
            self.records = np.zeros((4, 16))

    s1, s2 = Src(), Src()
    f1 = node_fingerprint(PlanNode("source", dataset=s1))
    assert f1 == node_fingerprint(PlanNode("source", dataset=s1))
    assert f1 != node_fingerprint(PlanNode("source", dataset=s2))


@pytest.mark.parametrize("knobs", [
    ALL_ON, ALL_OFF, dict(ALL_OFF, plan_pushdown=True),
    dict(ALL_OFF, plan_broadcast_join=True),
    dict(ALL_OFF, plan_overlap=True),
    dict(ALL_ON, plan_broadcast_records=8)],
    ids=["all_on", "all_off", "pushdown", "broadcast", "overlap",
         "broadcast_ceiling"])
def test_optimizer_decisions_match_reference(ref, star_pair, knobs):
    from sparkrdma_tpu import ShuffleConf as RefConf

    rm, pm = star_pair
    rq, pq = _both_rev_plans(ref, rm, pm)
    proot, pdec = optimize(pq.root, ShuffleConf(val_words=4, **knobs))
    rroot, rdec = ref["plan"].optimize(rq.root, RefConf(val_words=4,
                                                        **knobs))
    assert _decisions(pdec) == _decisions(rdec)
    assert _labels_and_fps(proot) == _labels_and_fps(rroot)
    if knobs == ALL_ON:
        kinds = sorted(d.rewrite for d in pdec)
        assert kinds == ["broadcast_join"] * 3 + ["overlap"] * 3 + \
            ["pushdown"] * 4
    if knobs == ALL_OFF:
        assert pdec == [] and proot.children[0].op == "select"


def _plan_counters(m):
    snap = m.metrics.snapshot()
    return {k: int(v) for k, v in snap.items() if k.startswith("plan.")}


def _result(res):
    d = dataclasses.asdict(res)
    d.pop("suite_s", None)
    d.pop("shuffle_s", None)
    return d


@ARMS
def test_star_suite_matches_reference(ref, knobs):
    rm, pm = _pair(val_words=4, **knobs)
    try:
        want = ref["tpcds"].run_star_suite(rm, fact_rows_per_device=16)
        got = tpcds.run_star_suite(pm, fact_rows_per_device=16)
        assert got.verified and want.verified
        assert _result(got) == _result(want)
        assert (got.rev_groups, got.rev_total, got.all_groups,
                got.all_total) == (8, 3523, 8, 6521)
        assert _plan_counters(pm) == _plan_counters(rm)
        if knobs == ALL_ON:
            for k in ("plan.reuse_hits", "plan.broadcast_joins",
                      "plan.overlapped_stages", "plan.pushdown_sunk"):
                assert _plan_counters(pm)[k] > 0, k
    finally:
        rm.stop()
        pm.stop()


@ARMS
def test_star_outputs_bit_equal(ref, knobs):
    """Both star queries' output records and totals, run by each
    package's executor, are the same words in the same places."""
    rm, pm = _pair(val_words=4, **knobs)
    try:
        outs = []
        for m, mod, ex in ((rm, ref["tpcds"], ref["plan"].PlanExecutor),
                           (pm, tpcds, PlanExecutor)):
            fact, *dims = mod._star_tables(8, 16, 1, 0)
            if mod is tpcds:
                plans = tpcds._star_plans(pm, fact, dims, 1, 0)
            else:
                plans = _ref_star_plans(ref, rm, fact, dims)
            e = ex(m)
            outs.append([e.run(q) for q in plans])
        for rds, pds in zip(*outs):
            np.testing.assert_array_equal(records_from_torch(pds.records),
                                          np.asarray(rds.records))
            assert pds.totals.tolist() == np.asarray(rds.totals).tolist()
    finally:
        rm.stop()
        pm.stop()


def _ref_star_plans(ref, rm, fact, dims):
    """The reference suite's two plans (its run_star_suite builds them
    inline), over the same tables."""
    LP = ref["plan"].LogicalPlan
    fact_r = LP.dataset(ref["Dataset"].from_host_rows(rm, fact),
                        name="star_fact_s1_r0").repartition(
                            stage="fact_part")
    d1, d2, d3 = (LP.from_host_rows(rm, t, name=f"star_dim{i}_s1_r0")
                  for i, t in enumerate(dims, start=1))
    out_schema = ref["RowSchema"]([("a2", "uint32"), ("a3", "uint32"),
                                   ("value", "uint32"), ("a1", "uint32")])

    def joined(left):
        return (left.join(d1, key_from=0, attr_to=3)
                .join(d2, key_from=1, attr_to=0)
                .join(d3, key_from=3, attr_to=1, schema=out_schema))

    q_rev = (joined(fact_r).repartition().filter(ref["tpcds"]._star_pred)
             .select("value").reduce_by_key("sum"))
    return q_rev, joined(fact_r).reduce_by_key("sum")


@ARMS
def test_q64_matches_reference(ref, knobs):
    rm, pm = _pair(**knobs)
    try:
        want = ref["tpcds"].run_q64_shape(rm)
        got = tpcds.run_q64_shape(pm)
        assert got.verified and want.verified
        assert _result(got) == _result(want)
        assert _plan_counters(pm) == _plan_counters(rm)
    finally:
        rm.stop()
        pm.stop()


@pytest.mark.parametrize("kw", [dict(), dict(return_order_offset=512),
                                dict(n_warehouses=2, seed=3)],
                         ids=["default", "no_returns", "two_warehouses"])
@ARMS
def test_q95_matches_reference(ref, knobs, kw):
    rm, pm = _pair(**knobs)
    try:
        want = ref["tpcds"].run_q95_shape(rm, **kw)
        got = tpcds.run_q95_shape(pm, **kw)
        assert got.verified and want.verified
        assert _result(got) == _result(want)
        assert _plan_counters(pm) == _plan_counters(rm)
    finally:
        rm.stop()
        pm.stop()


def _degrade_plan(m, LP, DS, dim):
    """The reference's ``TestBroadcastDegradation`` plan: a fact side
    repartitioned, then a broadcast-marked lookup into ``dim``."""
    rng = np.random.default_rng(7)
    nf = 8 * 16
    fact = np.zeros((nf, 6), dtype=np.uint32)
    fact[:, 1] = rng.integers(1, 9, size=nf)     # lookup key 1..8
    fact[:, 2] = rng.integers(1, 50, size=nf)    # next key
    fact[:, 4] = rng.integers(1, 100, size=nf)   # value
    return (LP.dataset(DS.from_host_rows(m, fact), name="degrade_fact")
            .repartition(stage="fact_part")
            .join(LP.from_host_rows(m, dim, name="degrade_dim"),
                  key_from=0, attr_to=1, stage="bad_join")
            .sink())


def _plan_lines(path, prefix):
    from sparkrdma_tpu_torch.obs.journal import read_entries

    return [e for e in read_entries(str(path))
            if e.get("kind") == "plan" and e["detail"].startswith(prefix)]


def test_broadcast_of_duplicate_keys_raises(ref, tmp_path):
    """A dim side with a duplicate primary key: the broadcast build
    raises :class:`BroadcastBuildError`, and the executor degrades the
    join to the shuffle join, as the reference's
    ``test_duplicate_pk_degrades_to_shuffle_join``: the same rows as the
    reference's degraded run, one ``degraded to shuffle join`` plan
    line, a ``broadcast_join`` degradation in the books and its
    ``degrade.*`` counter."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.plan import LogicalPlan as RefPlan
    from sparkrdma_tpu.plan import PlanExecutor as RefExecutor

    from sparkrdma_tpu_torch import faults
    from sparkrdma_tpu_torch.obs.metrics import global_registry

    dim = np.zeros((16, 6), dtype=np.uint32)
    dim[:8, 1] = np.arange(1, 9)
    dim[:8, 2] = np.arange(1, 9) * 10
    dim[8, 1], dim[8, 2] = 3, 30          # PK 3 twice, same attribute
    kw = dict(slot_records=1024, val_words=4)
    rc = RefConf(metrics_sink=str(tmp_path / "ref.jsonl"), **kw)
    rm = RefManager(RefRuntime(rc), rc)
    try:
        want = RefExecutor(rm).run(
            _degrade_plan(rm, RefPlan, ref["Dataset"], dim), "degrade")
    finally:
        rm.stop()
    faults.reset_accounting()
    counter = global_registry().counter("degrade.broadcast_join")
    before = counter.value
    pm = ShuffleManager(MeshRuntime(
        ShuffleConf(metrics_sink=str(tmp_path / "port.jsonl"), **kw), 8,
        device="cpu"))
    try:
        ex = PlanExecutor(pm)
        q = _degrade_plan(pm, LogicalPlan, Dataset, dim)
        join = q.root.children[0]
        with pytest.raises(BroadcastBuildError, match="duplicate primary"):
            ex._broadcast_build(join.children[1])
        got = ex.run(q, "degrade")
        books = (faults.active_degradations(), faults.degradation_total())
        ex.close()
    finally:
        pm.stop()
        faults.reset_accounting()
    np.testing.assert_array_equal(got, want)
    assert books == (["broadcast_join"], 1)
    assert counter.value - before == 1
    for path in ("ref.jsonl", "port.jsonl"):
        (line,) = _plan_lines(tmp_path / path, "degraded to shuffle join")
        assert line["rewrite"] == "broadcast_join"
        assert "duplicate primary" in line["detail"]


def test_prefetch_failure_degrades_to_sync_encode(ref, tmp_path,
                                                  monkeypatch):
    """The reference's ``test_prefetch_failure_degrades_to_sync_encode``:
    a failed overlap prefetch encodes the source synchronously, and the
    star suite gives the reference's results, with ``prefetch failed``
    plan lines under rewrite ``overlap`` in both journals."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.pipeline import HostPrefetcher as RefPrefetcher
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    from sparkrdma_tpu_torch import faults
    from sparkrdma_tpu_torch.api.pipeline import HostPrefetcher

    def wedged(self, key):
        raise TimeoutError("encode wedged past the watchdog")

    monkeypatch.setattr(RefPrefetcher, "take", wedged)
    monkeypatch.setattr(HostPrefetcher, "take", wedged)
    kw = dict(slot_records=1024, val_words=4)
    rc = RefConf(metrics_sink=str(tmp_path / "ref.jsonl"), **kw)
    rm = RefManager(RefRuntime(rc), rc)
    try:
        want = ref["tpcds"].run_star_suite(rm, fact_rows_per_device=16,
                                           scale=1)
    finally:
        rm.stop()
    faults.reset_accounting()
    pm = ShuffleManager(MeshRuntime(
        ShuffleConf(metrics_sink=str(tmp_path / "port.jsonl"), **kw), 8,
        device="cpu"))
    try:
        got = tpcds.run_star_suite(pm, fact_rows_per_device=16, scale=1)
        degraded = faults.active_degradations()
    finally:
        pm.stop()
        faults.reset_accounting()
    assert got.verified and want.verified
    assert _result(got) == _result(want)
    assert degraded == ["plan_overlap"]
    ref_falls = _plan_lines(tmp_path / "ref.jsonl", "prefetch failed")
    falls = _plan_lines(tmp_path / "port.jsonl", "prefetch failed")
    assert falls and all(e["rewrite"] == "overlap" for e in falls)
    assert [(e["node"], e["detail"]) for e in falls] == \
        [(e["node"], e["detail"]) for e in ref_falls]


def test_shuffle_join_with_duplicate_keys_matches_reference(ref):
    from sparkrdma_tpu.plan import LogicalPlan as RefPlan
    from sparkrdma_tpu.plan import PlanExecutor as RefExecutor

    rm, pm = _pair(val_words=4, plan_broadcast_join=False)
    try:
        fact, d1t, _, _ = tpcds._star_tables(8, 16, 1, 0)
        dup = d1t.copy()
        dup[1, 1] = dup[0, 1]
        outs = []
        for m, LP, DS, EX in ((rm, RefPlan, ref["Dataset"], RefExecutor),
                              (pm, LogicalPlan, Dataset, PlanExecutor)):
            q = (LP.dataset(DS.from_host_rows(m, fact))
                 .join(LP.from_host_rows(m, dup), key_from=0, attr_to=3)
                 .sink())
            outs.append(EX(m).run(q))
        np.testing.assert_array_equal(outs[1], outs[0])
    finally:
        rm.stop()
        pm.stop()


def _persisted_plan(m):
    fact, *_ = tpcds._star_tables(8, 16, 1, 0)
    return LogicalPlan.dataset(Dataset.from_host_rows(m, fact),
                               name="durable_fact").repartition().sink()


def test_reuse_across_restart(tmp_path):
    """Two manager + executor lifetimes over one ``spill_dir``: the
    second adopts the first's exchange output through
    ``resume_segments``; ``invalidate_reuse`` forgets it."""
    conf = ShuffleConf(slot_records=1024, val_words=4,
                       spill_dir=str(tmp_path))
    rows = []
    for run in range(3):
        m = ShuffleManager(MeshRuntime(conf, 8, device="cpu"))
        try:
            ex = PlanExecutor(m)
            rows.append(ex.run(_persisted_plan(m)))
            hits = m.metrics.counter("plan.reuse_hits").value
            assert hits == (1 if run == 1 else 0), (run, hits)
            if run == 1:
                ex.invalidate_reuse()
        finally:
            m.stop()
    np.testing.assert_array_equal(rows[1], rows[0])
    np.testing.assert_array_equal(rows[2], rows[0])


def test_port_adopts_reference_reuse_checkpoint(ref, tmp_path):
    """The reference's durable reuse checkpoint of a named, digested
    exchange is found by the port's fingerprint and adopted."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    kw = dict(slot_records=1024, val_words=4, spill_dir=str(tmp_path))
    rc = RefConf(**kw)
    rm = RefManager(RefRuntime(rc), rc)
    try:
        fact, *_ = tpcds._star_tables(8, 16, 1, 0)
        q = ref["plan"].LogicalPlan.dataset(
            ref["Dataset"].from_host_rows(rm, fact),
            name="durable_fact").repartition().sink()
        want = ref["plan"].PlanExecutor(rm).run(q)
    finally:
        rm.stop()
    pm = ShuffleManager(MeshRuntime(ShuffleConf(**kw), 8, device="cpu"))
    try:
        got = PlanExecutor(pm).run(_persisted_plan(pm))
        assert pm.metrics.counter("plan.reuse_hits").value == 1
        np.testing.assert_array_equal(got, want)
    finally:
        pm.stop()


def test_plan_builders_refuse_like_reference(star_pair):
    _, pm = star_pair
    src = LogicalPlan.from_host_rows(pm, np.zeros((8, 6), np.uint32))
    with pytest.raises(ValueError, match="terminal"):
        src.sink().repartition()
    with pytest.raises(ValueError, match="terminal"):
        src.join(src.group_by_key())
    with pytest.raises(ValueError, match="at least one column"):
        src.select()
    assert "source" in src.repartition().explain()
    with pytest.raises(ValueError, match="no source node"):
        LogicalPlan(PlanNode("sink", children=[PlanNode("filter")]))._manager()
