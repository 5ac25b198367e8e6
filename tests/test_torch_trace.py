"""The port's job traces and planner lines against the reference's.

- ``JobTrace`` stage math on synthetic spans and a fake clock: the
  port's job line equals the reference's exactly (trace ids aside), the
  partition invariant included;
- the frozen field sets (``JOB_FIELDS``, ``STAGE_FIELDS``,
  ``STAGE_VOCAB``, ``PLAN_FIELDS``) are the reference's;
- ``manager.job`` over real reads: every span carries the job's trace id
  and stage, and one ``{"kind": "job"}`` line closes it; the Dataset
  verbs and the workloads open the reference's stages;
- the ``{"kind": "plan"}`` lines of q64, q95 and the star suite (the
  smoke's M-small queries at the reference tests' sizes) equal the
  reference's in order and in every field but times and ids.
"""

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.dataset import Dataset
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.obs import journal as pj
from sparkrdma_tpu_torch.obs import trace as pt
from sparkrdma_tpu_torch.plan import PLAN_FIELDS
from sparkrdma_tpu_torch.workloads import tpcds

D = 8


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu import plan as ref_plan
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.obs import trace as rt
    from sparkrdma_tpu.workloads import tpcds as ref_tpcds

    return dict(Runtime=RefRuntime, Conf=RefConf, Manager=RefManager,
                trace=rt, plan=ref_plan, tpcds=ref_tpcds)


def _clock(*ticks):
    it = iter(ticks)
    return lambda: next(it)


def _span(stage, attempt=0, phase_s=None, bottleneck="", records=100):
    return {"stage": stage, "stage_attempt": attempt,
            "phase_s": phase_s or {}, "bottleneck": bottleneck,
            "records": records, "total_bytes": records * 16}


def _drive(mod, script):
    """Run one synthetic job through ``mod.JobTrace``; returns its line
    with the trace id blanked."""
    ticks, spans, now = script
    jt = mod.JobTrace("j", clock=_clock(*ticks))
    for name, attempt, observed in spans:
        with jt.stage(name, attempt):
            for sp in observed:
                jt.observe_span(sp)
    jt.observe_span(_span("not_a_stage"))          # dropped by both
    line = jt.close(now=now)
    line["trace_id"] = ""
    line["ts"] = now
    return line


SCRIPTS = {
    "walls_idle_dominant": ((10.0, 11.0, 12.0, 14.5),
                            [("co_partition", 0, []),
                             ("probe_join", 0, [])], 15.0),
    "padded_and_scaled": ((0.0, 2.0, 3.0, 7.0),
                          [("co_partition", 0, [_span(
                              "co_partition",
                              phase_s={"dispatch": 0.5, "decode": 0.25},
                              bottleneck="fabric-bound")]),
                           ("probe_join", 0, [_span(
                               "probe_join",
                               phase_s={"dispatch": 8.0, "fold": 4.0},
                               bottleneck="fabric-bound")])], 8.0),
    "attempts_and_votes": ((0.0, 1.0, 1.0, 2.0, 2.5, 4.0),
                           [("rank_update", 0, [_span(
                               "rank_update", 0, {"queue_block": 0.3},
                               "fabric-bound")]),
                            ("rank_update", 1, [_span(
                                "rank_update", 1, {"encode": 0.2},
                                "codec-bound")] * 2),
                            ("update_users", 2, [_span(
                                "update_users", 2, {"spill": 9.0},
                                "spill-bound", records=7)])], 4.25),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_job_line_matches_reference(ref, name):
    got = _drive(pt, SCRIPTS[name])
    assert got == _drive(ref["trace"], SCRIPTS[name])
    staged = sum(sum(s["phase_s"].values()) for s in got["stages"])
    assert staged + got["stage_idle_s"] == pytest.approx(got["wall_s"],
                                                         abs=1e-3)


def test_field_sets_match_reference(ref):
    assert pt.JOB_FIELDS == ref["trace"].JOB_FIELDS
    assert pt.STAGE_FIELDS == ref["trace"].STAGE_FIELDS
    assert pt.STAGE_VOCAB == ref["trace"].STAGE_VOCAB
    assert pt.STAGE_IDLE == ref["trace"].STAGE_IDLE
    assert PLAN_FIELDS == ref["plan"].PLAN_FIELDS


def test_scoping_and_auto_stage():
    assert pt.current_trace() is None
    pt.observe_active_span(_span("x"))                 # no job: no-op
    with pt.stage("s"):                                # no job: no-op
        pass
    jt = pt.JobTrace("j", clock=_clock(*[float(i) for i in range(20)]))
    with jt:
        assert pt.active_job() is jt
        with pt.auto_stage("repartition"):
            assert pt.current_trace().stage == "repartition"
        with jt.stage("group_agg"):
            with pt.auto_stage("repartition"):         # defers
                assert pt.current_trace().stage == "group_agg"
    assert pt.active_job() is None
    assert [s["stage"] for s in jt.line["stages"]] == ["repartition",
                                                      "group_agg"]
    with pytest.raises(RuntimeError, match="still open"):
        jt2 = pt.JobTrace("k", clock=_clock(0.0, 1.0, 2.0))
        with jt2.stage("a"):
            jt2._begin_stage("b", 0)


def _rows(seed, n=D * 16):
    return np.random.default_rng(seed).integers(1, 2**32, size=(n, 4),
                                                dtype=np.uint32)


def test_job_stamps_spans_and_writes_one_job_line(tmp_path):
    sink = tmp_path / "j.jsonl"
    m = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=64,
                                               metrics_sink=str(sink)), D,
                                   device="cpu"))
    try:
        with m.job("terasort") as job:
            for i in range(3):
                h = m.register_shuffle(i, D, modulo_partitioner(D))
                with job.stage("exchange", attempt=i):
                    m.get_writer(h).write(m.runtime.shard_records(
                        _rows(i))).stop(True)
                    m.get_reader(h).read()
            # a Dataset verb opens its own stage between explicit ones
            Dataset.from_host_rows(m, _rows(9)).repartition()
    finally:
        m.stop()
    entries = pj.read_entries(str(sink))
    spans = pj.read_journal(str(sink))
    (line,) = [e for e in entries if e.get("kind") == "job"]
    assert len(spans) == 4
    assert {s.trace_id for s in spans} == {line["trace_id"]} and \
        line["trace_id"] == job.trace_id
    assert [(s.stage, s.stage_attempt) for s in spans] == [
        ("exchange", 0), ("exchange", 1), ("exchange", 2),
        ("repartition", 0)]
    assert line["stage_count"] == 4 and line["spans"] == 4
    assert line["records"] == sum(s.records for s in spans)
    assert set(line) == pt.JOB_FIELDS


@pytest.mark.parametrize("workload", ["pagerank", "als", "q95"])
def test_workloads_open_the_reference_stages(workload):
    from sparkrdma_tpu_torch.workloads import als, pagerank

    conf = ShuffleConf(val_words=1, slot_records=256)
    rt = MeshRuntime(conf, D, device="cpu")
    m = ShuffleManager(rt)
    try:
        with m.job(workload) as job:
            if workload == "pagerank":
                edges = np.random.default_rng(0).integers(0, 64, (512, 2))
                pagerank.run_pagerank(rt, edges, 64, iterations=2,
                                      verify=False)
                want = [("rank_update", 0), ("rank_update", 1)]
            elif workload == "als":
                rng = np.random.default_rng(0)
                ratings = np.stack([rng.integers(0, 32, 256),
                                    rng.integers(0, 16, 256),
                                    rng.integers(1, 6, 256)], 1)
                als.run_als(MeshRuntime(ShuffleConf(slot_records=256), D,
                                        device="cpu"), ratings, 32, 16,
                            rank=2, iterations=2, verify=False)
                want = [("update_users", 0), ("update_items", 0),
                        ("update_users", 1), ("update_items", 1)]
            else:
                tpcds.run_q95_shape(ShuffleManager(MeshRuntime(
                    ShuffleConf(slot_records=256), D, device="cpu")),
                    verify=False)
                want = [("co_partition", 0), ("probe_join", 0)]
    finally:
        m.stop()
    assert [(s["stage"], s["attempt"]) for s in job.line["stages"]] == want


# ---------------------------------------------------------------------
# the planner's journal lines
# ---------------------------------------------------------------------
def _plan_lines(path):
    return [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
            for e in pj.read_entries(str(path)) if e.get("kind") == "plan"]


def _job_lines(path):
    return [(e["job"], [s["stage"] for s in e["stages"]])
            for e in pj.read_entries(str(path)) if e.get("kind") == "job"]


def test_plan_lines_match_reference(ref, tmp_path):
    """q64, q95 and the star suite with the journal on: the same plan
    lines in the same order, and the same jobs with the same stages."""
    lines = {"ref": ([], []), "port": ([], [])}
    for which in ("ref", "port"):
        # q64 and q95 at W = 4, the star suite at W = 6
        for val_words, queries in ((2, ("q64", "q95")), (4, ("star",))):
            sink = tmp_path / f"{which}-{val_words}.jsonl"
            kw = dict(slot_records=1024, val_words=val_words,
                      metrics_sink=str(sink))
            if which == "ref":
                rc = ref["Conf"](collect_shuffle_read_stats=True, **kw)
                m = ref["Manager"](ref["Runtime"](rc), rc)
                mod = ref["tpcds"]
            else:
                m = ShuffleManager(MeshRuntime(ShuffleConf(**kw), D,
                                               device="cpu"))
                mod = tpcds
            try:
                if "q64" in queries:
                    mod.run_q64_shape(m)
                    with m.job("q95"):
                        mod.run_q95_shape(m)
                else:
                    mod.run_star_suite(m, fact_rows_per_device=16)
            finally:
                m.stop()
            lines[which][0].extend(_plan_lines(sink))
            lines[which][1].extend(_job_lines(sink))
    (got, got_jobs), (want, want_jobs) = lines["port"], lines["ref"]
    assert got and got == want
    assert all(set(e) | {"ts", "trace_id"} == PLAN_FIELDS for e in got)
    assert got_jobs == want_jobs
