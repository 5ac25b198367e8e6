"""The query planner and segment checkpoints across processes: two gloo
CPU processes x 4 partitions.

What the reference's ``PlanExecutor`` runs across processes, the port's
runs there too, bit for bit (the worker-as-script pattern of
``tests/test_torch_distributed_dataset.py``: each worker is this file
run as a script, ``python tests/test_torch_distributed_plan.py RANK
WORLD INIT_FILE OUT_DIR``, no JAX; the two meet through ``file://`` in
``tmp_path`` and each is killed past 120 s). Each worker runs
:func:`run_plans` on the port and writes its local outputs; the test
joins them in partition order and holds them, tolerance 0, against the
same plans run in one process by the port and by the reference on the
conftest's 8-device CPU mesh:

- a loaded dataset's ``filter`` (key word 0 even) then ``sort_by_key``;
  ``reduce_by_key("sum")`` with the combine hoist, whose decision every
  process takes from process 0's sample; deferred host rows, ``select``
  then ``repartition(16)``; ``run_inline`` of ``filter`` then
  ``reduce_by_key("max")``; the same with pushdown off; a shuffle join
  of two loaded sides, the left one filtered;
- a resume hit: a checkpoint that a one-process run persisted gives each
  process its own partitions; a run across processes persists nothing
  (the reference's write fails and is logged), so a fresh executor
  misses;
- a segment checkpoint each process writes into its own ``spill_dir``
  and a fresh manager adopts.

The samplers differ (``jax.random`` against a seeded
``torch.Generator``), so the reference's ``sort_by_key`` takes the
port's sample. What the reference fails on across processes refuses
with ``NotImplementedError`` naming ROADMAP A.12 and the reference's
line, in the real group and, one case each, on a runtime that believes
it is process 0 of 2.
"""

import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
D = 8
WORKER_S = 120
#: the merge-path geometry (160 records a partition, a 256-record output
#: capacity of two runs), as ``tests/test_torch_distributed_dataset.py``
KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
             pack_sort_min_payload=0, wide_sort_min_payload=0)
PER = 160
DIM_ROWS = 256
SCHEMA = [("u", "uint32"), ("v", "uint32")]
SEG_SID = 5

#: where the reference fails across processes, by refused plan
REF = "sparkrdma_tpu/api/dataset.py"
REFUSALS = {
    "memo hit": "sparkrdma_tpu/plan/executor.py:307",
    "sink": f"{REF}:531",
    "broadcast join": f"{REF}:531",
    "join of an exchange's output": f"{REF}:660",
    "group_by_key": f"{REF}:1015",
    "two exchanges chained": f"{REF}:660",
}
#: a refused plan's conf beyond ``KNOBS`` (a small dim is broadcast
#: unless the rewrite is off)
REFUSAL_CONF = {"join of an exchange's output": {"plan_broadcast_join":
                                                 False}}


# --- the inputs, from numpy seeds --------------------------------------
def rows_sort() -> np.ndarray:
    rng = np.random.default_rng(31)
    return rng.integers(1, 2**32 - 1, size=(D * PER, 4), dtype=np.uint32)


def rows_dup() -> np.ndarray:
    """Keys ``(0, id)``: ids in [0, 16) on process 0's partitions, in
    [0, 2^20) on process 1's (the combine gate's sample is process 0's)."""
    rng = np.random.default_rng(32)
    n = D * PER
    x = np.zeros((n, 4), np.uint32)
    x[:n // 2, 1] = rng.integers(0, 16, size=n // 2)
    x[n // 2:, 1] = rng.integers(0, 1 << 20, size=n - n // 2)
    x[:, 2:] = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    return x


def fact_rows() -> np.ndarray:
    """Join keys ``(0, k)``, k in [0, 2 * DIM_ROWS): half of them match."""
    rng = np.random.default_rng(33)
    x = rng.integers(0, 2**32, size=(D * PER, 4), dtype=np.uint32)
    x[:, 0] = 0
    x[:, 1] = rng.integers(0, 2 * DIM_ROWS, size=D * PER)
    return x


def dim_rows() -> np.ndarray:
    """Unique primary keys ``(0, 1..DIM_ROWS)`` and an attribute."""
    rng = np.random.default_rng(34)
    x = np.zeros((DIM_ROWS, 4), np.uint32)
    x[:, 1] = rng.permutation(DIM_ROWS) + 1
    x[:, 2] = rng.integers(0, 2**32, size=DIM_ROWS, dtype=np.uint32)
    return x


def even_w0(r):
    """Rows whose key word 0 is even: one predicate for both packages."""
    return (r[0] & 1) == 0


def even_w2(r):
    return (r[2] & 1) == 0


# --- the plans, over either package ------------------------------------
def run_plans(api) -> dict:
    """Every plan through ``api``: ``{name: array}``. A name ending in
    ``/out`` is columnar records, ``/totals`` per-partition counts; any
    other name is the same on every process."""
    res = {}

    def keep(name, ds):
        res[name + "/out"] = api.words(ds.records)
        res[name + "/totals"] = api.counts(ds.totals)

    P = api.LogicalPlan
    m = api.manager(**KNOBS)
    lines = api.plan_lines(m)
    ex = api.PlanExecutor(m)
    ds = api.Dataset.from_host_rows(m, rows_sort())
    with api.sampling("filter_sort"):
        keep("filter_sort", ex.run(P.dataset(ds).filter(
            even_w0, cache_key=("even_w0",)).sort_by_key()))
    keep("reduce_sum", ex.run(P.dataset(
        api.Dataset.from_host_rows(m, rows_dup())).reduce_by_key("sum")))
    res["hoist"] = np.array([ln["detail"] for ln in lines
                             if ln.get("rewrite") == "combine_hoist"])
    keep("repartition", api.PlanExecutor(m).run(
        P.from_host_rows(m, rows_sort()).repartition()))
    schema = api.RowSchema(SCHEMA)
    keep("select_repartition16", api.PlanExecutor(m).run(
        P.from_host_rows(m, rows_sort(), schema=schema).select("v")
        .repartition(16)))
    keep("inline_filter_reduce", api.PlanExecutor(m).run_inline(
        P.from_host_rows(m, rows_dup()).filter(
            even_w2, cache_key=("even_w2",)).reduce_by_key("max")))
    moff = api.manager(plan_pushdown=False, **KNOBS)
    keep("pushdown_off_filter_reduce", api.PlanExecutor(moff).run(
        P.from_host_rows(moff, rows_dup()).filter(
            even_w2, cache_key=("even_w2",)).reduce_by_key("sum")))
    mj = api.manager(plan_broadcast_join=False, **KNOBS)
    keep("shuffle_join", api.PlanExecutor(mj).run(
        P.from_host_rows(mj, fact_rows()).filter(
            even_w2, cache_key=("even_w2",)).join(
                P.from_host_rows(mj, dim_rows()))))
    for mm in (m, moff, mj):
        mm.stop()
    return res


class PortApi:
    """The port's side of :func:`run_plans`; its sorts record the
    splitter sample they drew (``samples``)."""

    def __init__(self):
        from sparkrdma_tpu_torch.api.dataset import Dataset
        from sparkrdma_tpu_torch.api.serde import RowSchema
        from sparkrdma_tpu_torch.plan import LogicalPlan, PlanExecutor

        self.Dataset, self.RowSchema = Dataset, RowSchema
        self.LogicalPlan, self.PlanExecutor = LogicalPlan, PlanExecutor
        self.samples = {}

    @staticmethod
    def manager(**kw):
        from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
        from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

        return ShuffleManager(MeshRuntime(ShuffleConf(**kw), D,
                                          device="cpu"))

    @staticmethod
    def words(x) -> np.ndarray:
        from sparkrdma_tpu_torch.interop import records_from_torch

        return records_from_torch(x)

    @staticmethod
    def counts(x) -> np.ndarray:
        return x.cpu().numpy().astype(np.int64)

    @staticmethod
    def plan_lines(m) -> list:
        """The ``{"kind": "plan"}`` lines ``m`` emits from now on."""
        lines = []
        m.journal.emit_raw = lines.append
        return lines

    @contextlib.contextmanager
    def sampling(self, name):
        from sparkrdma_tpu_torch.api import dataset as dataset_mod

        plain = dataset_mod.make_sampler

        def recording(*a, **kw):
            fn = plain(*a, **kw)

            def sample(records):
                self.samples[name] = fn(records)
                return self.samples[name]
            return sample

        dataset_mod.make_sampler = recording
        try:
            yield
        finally:
            dataset_mod.make_sampler = plain


class RefApi:
    """The reference's side of :func:`run_plans`: its sorts take the
    port's sample (``samples``, by plan name)."""

    def __init__(self, samples: dict):
        from sparkrdma_tpu.api.dataset import Dataset
        from sparkrdma_tpu.api.serde import RowSchema
        from sparkrdma_tpu.plan import LogicalPlan, PlanExecutor

        self.Dataset, self.RowSchema = Dataset, RowSchema
        self.LogicalPlan, self.PlanExecutor = LogicalPlan, PlanExecutor
        self.samples = samples

    @staticmethod
    def manager(**kw):
        from sparkrdma_tpu import ShuffleConf
        from sparkrdma_tpu.api.shuffle_manager import ShuffleManager

        return ShuffleManager(conf=ShuffleConf(**kw))

    @staticmethod
    def words(x) -> np.ndarray:
        return np.asarray(x)

    @staticmethod
    def counts(x) -> np.ndarray:
        return np.asarray(x).astype(np.int64)

    plan_lines = staticmethod(PortApi.plan_lines)

    @contextlib.contextmanager
    def sampling(self, name):
        from sparkrdma_tpu.api import dataset as dataset_mod

        plain = dataset_mod.make_sampler
        sample = self.samples[name]
        dataset_mod.make_sampler = lambda *a, **k: (lambda records: sample)
        try:
            yield
        finally:
            dataset_mod.make_sampler = plain


# --- durable reuse and segment checkpoints -----------------------------
def resume_plan(api, m):
    return api.LogicalPlan.from_host_rows(m, rows_sort()).repartition()


def persist_one_process(root: str) -> dict:
    """One process: ``resume_plan`` run with ``spill_dir`` ``root``,
    which persists its output; the output."""
    api = PortApi()
    m = api.manager(spill_dir=root, **KNOBS)
    out = api.PlanExecutor(m).run(resume_plan(api, m))
    res = {"out": api.words(out.records), "totals": api.counts(out.totals)}
    m.stop()
    return res


def durable(out_dir: str, rank: int) -> dict:
    """Across processes: a resume hit from ``spill{rank}`` (a copy of
    the one-process checkpoint), then a run with a fresh ``spill_dir``
    (nothing persisted, a fresh executor misses), then a segment
    checkpoint written and adopted in this process's own directory."""
    api = PortApi()
    res = {}
    m = api.manager(spill_dir=os.path.join(out_dir, f"spill{rank}"),
                    **KNOBS)
    out = api.PlanExecutor(m).run(resume_plan(api, m))
    res["resume/out"] = api.words(out.records)
    res["resume/totals"] = api.counts(out.totals)
    res["resume_hits"] = np.array(
        m.metrics.counter("plan.reuse_hits").value)
    m.stop()

    fresh = os.path.join(out_dir, f"fresh{rank}")
    m = api.manager(spill_dir=fresh, **KNOBS)
    warned = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("sparkrdma_tpu_torch.plan").addHandler(handler)
    try:
        first = api.PlanExecutor(m).run(resume_plan(api, m))
        again = api.PlanExecutor(m).run(resume_plan(api, m))
    finally:
        logging.getLogger("sparkrdma_tpu_torch.plan").removeHandler(handler)
    res["fresh/out"] = api.words(again.records)
    res["fresh/totals"] = api.counts(again.totals)
    res["fresh_first_equal"] = np.array(np.array_equal(
        api.words(first.records), res["fresh/out"]))
    res["fresh_hits"] = np.array(m.metrics.counter("plan.reuse_hits").value)
    res["fresh_checkpoints"] = np.array(
        m.store.list_segment_checkpoints(), np.int64)
    res["persist_warnings"] = np.array(warned)
    m.stop()

    seg = os.path.join(out_dir, f"seg{rank}")
    mine = np.arange(12, dtype=np.uint32).reshape(3, 4) + 100 * rank
    m = api.manager(spill_dir=seg, **KNOBS)
    m.checkpoint_segments(SEG_SID, [(f"k{rank}", mine)], None, D)
    m.stop()
    m = api.manager(spill_dir=seg, **KNOBS)
    res["segments_adopted"] = np.array(m.resume_segments(SEG_SID))
    res["segments_equal"] = np.array(np.array_equal(
        np.asarray(m.tiered.get(f"k{rank}")), mine))
    res["segments_files"] = np.array(sorted(os.listdir(seg)))
    m.stop()
    return res


# --- the refusals ------------------------------------------------------
def refused_calls():
    """Each plan the reference fails on across processes, as a call on
    a fresh manager (``m``) and a loaded dataset of it (``ds``)."""
    from sparkrdma_tpu_torch.plan import LogicalPlan as P
    from sparkrdma_tpu_torch.plan import PlanExecutor

    def join(m, ds, broadcast):
        dim = P.from_host_rows(m, dim_rows())
        PlanExecutor(m).run(P.dataset(ds).join(dim)) if broadcast else \
            PlanExecutor(m).run(P.dataset(ds).repartition().join(dim))

    return {
        "memo hit": None,     # needs a first run: see memo_hit()
        "sink": lambda m, ds: PlanExecutor(m).run(
            P.dataset(ds).repartition().sink()),
        "broadcast join": lambda m, ds: join(m, ds, True),
        "join of an exchange's output": lambda m, ds: join(m, ds, False),
        "group_by_key": lambda m, ds: PlanExecutor(m).run(
            P.dataset(ds).group_by_key()),
        "two exchanges chained": lambda m, ds: PlanExecutor(m).run(
            P.dataset(ds).repartition().reduce_by_key("sum")),
    }


def memo_hit(m, ds, processes=None):
    """Run a plan, then the same plan on the same executor: a memo hit.
    ``processes`` makes the runtime believe it spans that many processes
    after the first run."""
    from sparkrdma_tpu_torch.plan import LogicalPlan as P
    from sparkrdma_tpu_torch.plan import PlanExecutor

    ex = PlanExecutor(m)
    ex.run(P.dataset(ds).repartition())
    if processes:
        m.runtime.process_count = processes
    ex.run(P.dataset(ds).repartition())


def group_refusals() -> dict:
    """In the real group: each refused plan, ``[type, message]``
    (``["", ""]`` if it did not raise)."""
    api = PortApi()
    said = {}
    for name, call in refused_calls().items():
        m = api.manager(**KNOBS, **REFUSAL_CONF.get(name, {}))
        ds = api.Dataset.from_host_rows(m, rows_sort())
        try:
            (call or memo_hit)(m, ds)
            said[name] = ["", ""]
        except Exception as e:      # the test holds type and message
            said[name] = [type(e).__name__, str(e)]
        m.stop()
    return said


def worker(rank: int, world: int, init_file: str, out_dir: str) -> int:
    assert "jax" not in sys.modules
    import torch

    from sparkrdma_tpu_torch import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed(num_processes=world, process_id=rank,
                                  init_method=f"file://{init_file}",
                                  backend="gloo")
    api = PortApi()
    res = run_plans(api)
    res.update({f"samples/{k}": v for k, v in api.samples.items()})
    res.update(durable(out_dir, rank))
    np.savez(os.path.join(out_dir, f"proc{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"refused{rank}.json"), "w") as f:
        json.dump(group_refusals(), f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MPOK proc={rank}", flush=True)
    return 0


# --- the test side -----------------------------------------------------
def _run_workers(tmp_path, world: int) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(init), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"workers ran past {WORKER_S} s:\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}"
        assert f"MPOK proc={r}" in out, out
    return [(dict(np.load(tmp_path / f"proc{r}.npz")),
             json.loads((tmp_path / f"refused{r}.json").read_text()))
            for r in range(world)]


@pytest.fixture(scope="module")
def persisted(tmp_path_factory):
    """The one-process run that persists ``resume_plan``'s output, and
    its directory."""
    root = tmp_path_factory.mktemp("one") / "spill"
    return persist_one_process(str(root)), root


@pytest.fixture(scope="module")
def workers(tmp_path_factory, persisted):
    """The two processes' outputs, each ``(arrays, refusals)``; each
    process's ``spill{rank}`` starts as a copy of the one-process
    checkpoint."""
    tmp = tmp_path_factory.mktemp("two")
    for r in range(2):
        shutil.copytree(persisted[1], tmp / f"spill{r}")
    return _run_workers(tmp, 2)


@pytest.fixture(scope="module")
def single():
    """The plans in this (group-less) process, and the samples the sorts
    drew."""
    api = PortApi()
    return run_plans(api), api.samples


@pytest.fixture(scope="module")
def reference(single):
    """The reference's plans on its 8-device CPU mesh, its sorts handed
    the port's samples."""
    return run_plans(RefApi(single[1]))


def _joined(parts: list, key: str) -> np.ndarray:
    if key.endswith("/out"):
        return np.concatenate([p[key] for p in parts], axis=1)
    if key.endswith("/totals"):
        return np.concatenate([p[key] for p in parts])
    for p in parts[1:]:
        np.testing.assert_array_equal(p[key], parts[0][key], err_msg=key)
    return parts[0][key]


PLANS = ("filter_sort", "reduce_sum", "hoist", "repartition",
         "select_repartition16", "inline_filter_reduce",
         "pushdown_off_filter_reduce", "shuffle_join")


def test_plans_listed(single):
    names = {k.split("/")[0] for k in single[0]}
    assert names == set(PLANS)


@pytest.mark.parametrize("name", PLANS)
def test_two_processes_match_one_and_the_reference(workers, single,
                                                   reference, name):
    parts = [w[0] for w in workers]
    keys = [k for k in single[0] if k.split("/")[0] == name]
    assert keys, name
    for key in keys:
        got = _joined(parts, key)
        np.testing.assert_array_equal(got, single[0][key], err_msg=key)
        np.testing.assert_array_equal(got, reference[key], err_msg=key)
    if name in single[1]:
        # every process computed the splitters from the whole sample
        for p in parts:
            np.testing.assert_array_equal(p[f"samples/{name}"],
                                          single[1][name])


@pytest.mark.slow
def test_four_processes_match_one_and_the_reference(tmp_path, persisted,
                                                    single, reference):
    """Four processes of two partitions each: the same outputs, and the
    resume hit gives each its partitions."""
    for r in range(4):
        shutil.copytree(persisted[1], tmp_path / f"spill{r}")
    parts = [w[0] for w in _run_workers(tmp_path, 4)]
    for key in single[0]:
        got = _joined(parts, key)
        np.testing.assert_array_equal(got, single[0][key], err_msg=key)
        np.testing.assert_array_equal(got, reference[key], err_msg=key)
    np.testing.assert_array_equal(_joined(parts, "resume/out"),
                                  persisted[0]["out"])


def test_plans_are_what_they_should_be(single):
    """The one-process outputs against the inputs, so the parity above
    holds something: the sort is a merge-path one, the gate sampled
    duplicates, the projection dropped its word, the join matched the
    rows it should."""
    res, _ = single
    cap = res["filter_sort/out"].shape[1] // D
    # the merge-path geometry: a power of two of at least two runs (the
    # filler the filter leaves sorts to the last partition)
    assert cap & (cap - 1) == 0 and cap >= 2 * KNOBS["fast_sort_run"]
    assert int(res["filter_sort/totals"].sum()) == D * PER
    assert res["hoist"].tolist() and res["hoist"][0].startswith("use=True")
    out, tot = res["select_repartition16/out"], res[
        "select_repartition16/totals"]
    assert int(tot.sum()) == D * PER
    cap = out.shape[1] // D
    for d, t in enumerate(tot):          # "u" (word 2) was projected away
        assert not out[2, d * cap:d * cap + t].any()
        assert out[3, d * cap:d * cap + t].any()
    fact = fact_rows()
    hits = int(((fact[:, 1] >= 1) & (fact[:, 1] <= DIM_ROWS)
                & (fact[:, 2] % 2 == 0)).sum())
    out, tot = res["shuffle_join/out"], res["shuffle_join/totals"]
    cap = out.shape[1] // D
    live = sum(int((out[1, d * cap:d * cap + t] != 0).sum())
               for d, t in enumerate(tot))
    assert live == hits


def test_resume_hit_gives_each_process_its_partitions(workers, persisted):
    parts = [w[0] for w in workers]
    one = persisted[0]
    np.testing.assert_array_equal(_joined(parts, "resume/out"), one["out"])
    np.testing.assert_array_equal(_joined(parts, "resume/totals"),
                                  one["totals"])
    assert [int(p["resume_hits"]) for p in parts] == [1, 1]


def test_nothing_persisted_across_processes(workers, persisted):
    """The reference's write fails and is logged: no checkpoint, and a
    fresh executor runs the plan again (no hit), with the same output."""
    parts = [w[0] for w in workers]
    for p in parts:
        assert p["fresh_checkpoints"].tolist() == []
        assert int(p["fresh_hits"]) == 0
        assert bool(p["fresh_first_equal"])
        assert len(p["persist_warnings"]) == 2
        for msg in p["persist_warnings"]:
            assert "plan reuse persist" in msg and "A.12" in msg
            assert "`sparkrdma_tpu/plan/executor.py:343`" in msg
    np.testing.assert_array_equal(_joined(parts, "fresh/out"),
                                  persisted[0]["out"])


def test_segment_checkpoint_in_each_process_directory(workers):
    for r, (p, _) in enumerate(workers):
        assert p["segments_adopted"].tolist() == [f"k{r}"]
        assert bool(p["segments_equal"])
        assert p["segments_files"].tolist() == [f"shuffle_{SEG_SID}"]


def test_refused_in_the_group(workers):
    for _, said in workers:
        assert set(said) == set(REFUSALS)
        for name, (kind, msg) in said.items():
            assert kind == "NotImplementedError", (name, kind, msg)
            assert "A.12" in msg and f"`{REFUSALS[name]}`" in msg, msg


# --- the refusals, on a runtime that believes it is process 0 of 2 -----
@pytest.fixture
def two_processes(monkeypatch):
    """Runtimes built now, and the group itself, look like process 0 of
    2 (no group: only what refuses before any collective is driven)."""
    from sparkrdma_tpu_torch.runtime import distributed, mesh

    monkeypatch.setattr(mesh, "group_rank", lambda: (0, 2))
    monkeypatch.setattr(distributed, "group_rank", lambda: (0, 2))


def test_refusals_listed():
    assert tuple(refused_calls()) == tuple(REFUSALS)


@pytest.mark.parametrize("name", [n for n in REFUSALS
                                  if n != "two exchanges chained"])
def test_refused_across_processes(monkeypatch, name):
    """Each refusal before any collective (a chain of two exchanges runs
    the first: the group's run above holds it). The memo hit's first
    run is a real one-process run."""
    from sparkrdma_tpu_torch.runtime import distributed, mesh

    api = PortApi()
    if name != "memo hit":
        monkeypatch.setattr(mesh, "group_rank", lambda: (0, 2))
        monkeypatch.setattr(distributed, "group_rank", lambda: (0, 2))
    m = api.manager(**KNOBS, **REFUSAL_CONF.get(name, {}))
    try:
        ds = api.Dataset.from_host_rows(m, rows_sort())
        with pytest.raises(NotImplementedError, match="A.12") as err:
            if name == "memo hit":
                memo_hit(m, ds, processes=2)
            else:
                refused_calls()[name](m, ds)
        assert f"as the reference: `{REFUSALS[name]}`" in str(err.value)
    finally:
        m.runtime.process_count = 1
        m.stop()


def test_join_refuses_before_the_dim_encode_starts(two_processes):
    """An overlapped dim source (its encode on a background thread)
    never starts when the join refuses."""
    from sparkrdma_tpu_torch.plan import LogicalPlan as P
    from sparkrdma_tpu_torch.plan import PlanExecutor

    api = PortApi()
    m = api.manager(plan_broadcast_join=False, **KNOBS)
    try:
        ex = PlanExecutor(m)
        plan = P.from_host_rows(m, fact_rows()).repartition().join(
            P.from_host_rows(m, dim_rows()))
        with pytest.raises(NotImplementedError, match=r"dataset\.py:660"):
            ex.run(plan)
        assert ex._prefetcher is None
        assert m.metrics.counter("plan.overlapped_stages").value == 0
    finally:
        m.stop()


def test_dim_estimate_is_global_across_processes(two_processes):
    """Each process decides the broadcast alike: a loaded dataset's rows
    count whole (an even share a process), an exchange's output is
    unknown, and a join reading one refuses at entry."""
    from sparkrdma_tpu_torch.plan import LogicalPlan as P
    from sparkrdma_tpu_torch.plan import PlanExecutor
    from sparkrdma_tpu_torch.plan.optimizer import estimate_rows

    api = PortApi()
    m = api.manager(**KNOBS)
    try:
        ds = api.Dataset.from_host_rows(m, rows_sort())
        assert int(ds.totals.sum()) == D * PER // 2
        assert estimate_rows(P.dataset(ds).root) == D * PER
        made = api.Dataset(m, ds.records, ds.totals)
        assert made.exchanged and estimate_rows(P.dataset(made).root) is None
        with pytest.raises(NotImplementedError, match=r"dataset\.py:660"):
            PlanExecutor(m).run(P.from_host_rows(m, fact_rows()).join(
                P.dataset(made)))
    finally:
        m.stop()


def test_persist_writes_nothing_across_processes(two_processes, tmp_path,
                                                 caplog):
    from sparkrdma_tpu_torch.plan import PlanExecutor

    api = PortApi()
    m = api.manager(spill_dir=str(tmp_path / "spill"), **KNOBS)
    try:
        ds = api.Dataset.from_host_rows(m, rows_sort())
        with caplog.at_level(logging.WARNING, "sparkrdma_tpu_torch.plan"):
            PlanExecutor(m)._persist("ab12", ds)
        assert m.store.list_segment_checkpoints() == []
        assert any("executor.py:343" in r.getMessage()
                   for r in caplog.records)
    finally:
        m.stop()


def test_persist_still_raises_in_one_process(tmp_path, monkeypatch):
    """In one process a reuse-cache fault raises (ROADMAP C.1.7)."""
    from sparkrdma_tpu_torch.plan import PlanExecutor

    api = PortApi()
    m = api.manager(spill_dir=str(tmp_path / "spill"), **KNOBS)
    try:
        ds = api.Dataset.from_host_rows(m, rows_sort())

        def broken(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(m, "checkpoint_segments", broken)
        with pytest.raises(OSError, match="disk full"):
            PlanExecutor(m)._persist("ab12", ds)
    finally:
        m.stop()


def test_segments_are_host_only_across_processes(two_processes, tmp_path):
    """Writing and adopting a segment checkpoint needs no collective."""
    api = PortApi()
    conf = dict(spill_dir=str(tmp_path / "seg"), **KNOBS)
    m = api.manager(**conf)
    seg = np.arange(8, dtype=np.uint32).reshape(2, 4)
    try:
        m.checkpoint_segments(3, [("s", seg)], None, D)
        fresh = api.manager(**conf)
        assert fresh.resume_segments(3) == ["s"]
        np.testing.assert_array_equal(np.asarray(fresh.tiered.get("s")), seg)
        fresh.stop()
    finally:
        m.stop()


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
