"""Shuffles across processes: two gloo CPU processes x 4 partitions.

The geometry of ``tests/test_distributed.py`` (two processes, one
8-partition job), for the port: each process holds 4 partitions
(``MeshRuntime`` spans the ``torch.distributed`` group), plans from the
all-gathered counts and moves its sends with ``all_to_all_single``
(``exchange/hierarchical.py``).

The worker is this file run as a script (``python
tests/test_torch_distributed.py RANK WORLD INIT_FILE OUT_DIR``); it
imports no JAX and says so. The processes meet through ``file://`` in
``tmp_path``, so parallel runs never race for a port. Each worker runs
:func:`scenarios` and writes its local outputs; the test joins them in
partition order and holds them bit for bit (tolerance 0) against the
same scenarios run in one process by the port, and against the
reference on the conftest's 8-device CPU mesh:

- ``repartition(16)`` over ``hash_partitioner(16)``, and
  ``run_repartition`` itself;
- TeraSort (``run_terasort``) in the merge-path geometry, and the
  splitters every process computed;
- the hierarchical transport, H = 1 (flat), 2 (= processes: stage 2
  crosses) and 4 (virtual hosts in each process), fused and streaming,
  against the flat transport;
- the ring (``"pallas_ring"``, ``ring_fused`` True and False), fused and
  streaming, its pushes into the processes' shared-memory windows
  (``exchange/windows.py``) against the flat transport and the
  reference's ring, and a merge-path TeraSort on the ring;
- a sharded checkpoint (each process writes only its ``proc{p}`` shard
  files) resumed by fresh managers.

Each worker is killed past 120 s. The four-process case (H = 2 below
four processes, so stage 1 crosses them too) is ``slow``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
D = 8
WORKER_S = 120
#: the merge-path geometry: 160 records a partition land in a 256-record
#: (power of two, two runs) output capacity on both packages
TS_KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
                pack_sort_min_payload=0, wide_sort_min_payload=0)
TS_PER, TS_SEED = 160, 11
REPART_PER, REPART_SEED = 32, 3
HIER_PER, HIER_SEED = 48, 5
HOSTS = (1, 2, 4)
#: the ring's two kernels: fused (every round in one push) and a push a
#: round
RING_FUSED = (True, False)
#: fused (one round in flight covers the plan) and streaming geometries
HIER_GEOMETRIES = {"fused": dict(slot_records=64),
                   "stream": dict(slot_records=4, max_rounds_in_flight=1)}
CKPT_PER, CKPT_SEED = 16, 7


def _rows(per: int, seed: int, words: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=(D * per, words), dtype=np.uint32)


def scenarios(device: str = "cpu", spill_dir: str = "") -> dict:
    """Every scenario on the runtime's group (one process when there is
    none): ``{name: local array}``, outputs ``[W, L*cap]`` as uint32."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                           modulo_partitioner)
    from sparkrdma_tpu_torch.exchange.windows import open_windows
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.repartition import (generate_records,
                                                           run_repartition)
    from sparkrdma_tpu_torch.workloads.terasort import (random_records,
                                                        run_terasort)

    res = {}

    def ring_moves():
        """Moves through this process's ring windows (0 in one process:
        the stacked kernel needs none)."""
        return sum(w.moves for w in open_windows())

    def manager(**kw):
        conf = ShuffleConf(**kw)
        return ShuffleManager(MeshRuntime(conf, num_partitions=D,
                                          device=device))

    def keep(name, out, totals):
        res[name + "/out"] = records_from_torch(out)
        res[name + "/totals"] = totals.cpu().numpy()

    # repartition(16): the SPI on generate_records' rows, then the entry
    m = manager(slot_records=64)
    recs = generate_records(m, REPART_PER, REPART_SEED)
    h = m.register_shuffle(0, 16, hash_partitioner(16, m.conf.key_words))
    m.get_writer(h).write(recs).stop()
    keep("repartition", *m.get_reader(h).read())
    r = run_repartition(m, REPART_PER, num_parts=16, seed=REPART_SEED,
                        shuffle_id=1, verify=False, warmup=False)
    res["repartition/records"] = np.array([r.records])
    m.stop()

    # TeraSort in the merge-path geometry, and the splitters it sampled
    m = manager(**TS_KNOBS)
    rt = m.runtime
    tres, out, totals = run_terasort(m, TS_PER, seed=TS_SEED, verify=False,
                                     warmup=False, shuffle_id=2)
    keep("terasort", out, totals)
    res["terasort/records"] = np.array([tres.records])
    recs = random_records(D * TS_PER, m.conf.record_words, TS_SEED,
                          rt.device)
    first = rt.local_device_indices()[0] * TS_PER
    recs = recs[:, first:first + rt.local_partitions * TS_PER]
    res["terasort/splitters"] = compute_splitters(make_sampler(
        D, m.conf.key_words, 256, TS_SEED, runtime=rt)(recs), D)
    res["terasort/fast_sort"] = np.array([m._exchange._uses_fast_sort(
        tres.plan.out_capacity, m.conf.key_words)])
    m.stop()

    # the same TeraSort on the ring
    m = manager(transport="pallas_ring", **TS_KNOBS)
    _, out, totals = run_terasort(m, TS_PER, seed=TS_SEED, verify=False,
                                  warmup=False, shuffle_id=2)
    keep("terasort_ring", out, totals)
    res["terasort_ring/moves"] = np.array([ring_moves()])
    m.stop()

    # the hierarchical transport against the flat one
    x = _rows(HIER_PER, HIER_SEED)
    for geo, knobs in HIER_GEOMETRIES.items():
        for transport, hosts in [("xla", 0)] + [("hierarchical", H)
                                                for H in HOSTS]:
            m = manager(transport=transport, hierarchy_hosts=hosts, **knobs)
            h = m.register_shuffle(3, 16, hash_partitioner(16))
            plan = m.get_writer(h).write(m.runtime.shard_records(x)).stop()
            name = f"hier/{geo}/{transport}{hosts or ''}"
            keep(name, *m.get_reader(h).read())
            res[name + "/rounds"] = np.array([plan.num_rounds])
            res[name + "/moves"] = np.array([m.metrics.counter(
                f"transport.hier.{k}").value
                for k in ("staged_exchanges", "flat_fallbacks")])
            m.stop()
        # the ring against the flat transport
        for fused in RING_FUSED:
            m = manager(transport="pallas_ring", ring_fused=fused, **knobs)
            h = m.register_shuffle(3, 16, hash_partitioner(16))
            plan = m.get_writer(h).write(m.runtime.shard_records(x)).stop()
            name = f"ring/{geo}/{'fused' if fused else 'per_round'}"
            keep(name, *m.get_reader(h).read())
            res[name + "/rounds"] = np.array([plan.num_rounds])
            res[name + "/moves"] = np.array([ring_moves()])
            m.stop()
            res[name + "/closed"] = np.array([not open_windows()])

    # a sharded checkpoint, resumed by fresh managers
    if spill_dir:
        part = modulo_partitioner(D, key_word=1)
        xc = _rows(CKPT_PER, CKPT_SEED)
        kw = dict(slot_records=64, spill_to_host=True, spill_dir=spill_dir)
        m1 = manager(**kw)
        h = m1.register_shuffle(7, D, part)
        m1.get_writer(h).write(m1.runtime.shard_records(xc)).stop(True)
        keep("ckpt/live", *m1.get_reader(h).read())
        m1._writers.clear()
        m1.runtime.stop()
        m2 = manager(**kw)
        h2 = m2.register_shuffle(7, D, part)
        m2.resume_shuffle(h2)
        keep("ckpt/resumed", *m2.get_reader(h2).read())
        m2.stop()
    return res


def worker(rank: int, world: int, init_file: str, out_dir: str) -> int:
    assert "jax" not in sys.modules
    import torch

    from sparkrdma_tpu_torch import initialize_distributed
    from sparkrdma_tpu_torch.runtime.distributed import group_rank

    torch.set_num_threads(1)
    assert initialize_distributed(num_processes=world, process_id=rank,
                                  init_method=f"file://{init_file}",
                                  backend="gloo")
    assert group_rank() == (rank, world)
    spill = os.path.join(out_dir, "ckpt")
    res = scenarios("cpu", spill)
    # only this process's shard files and marker
    from sparkrdma_tpu_torch import MeshRuntime

    local = MeshRuntime(num_partitions=D, device="cpu").local_device_indices()
    marker = json.loads((Path(spill) / "shuffle_7" / f"proc{rank}.json")
                        .read_text())
    res["ckpt/marker_shards"] = np.array(marker["shards"])
    res["ckpt/local"] = np.array(local)
    np.savez(os.path.join(out_dir, f"proc{rank}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MPOK proc={rank}", flush=True)
    return 0


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
    return [dict(np.load(tmp_path / f"proc{r}.npz")) for r in range(world)]


def _joined(parts: list, key: str) -> np.ndarray:
    """Processes' local arrays in partition order: outputs side by side,
    totals end to end."""
    axis = 1 if key.endswith("/out") else 0
    return np.concatenate([p[key] for p in parts], axis=axis)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The scenarios in this (group-less) process: the stacked port."""
    return scenarios("cpu", str(tmp_path_factory.mktemp("one") / "ckpt"))


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs of the same scenarios on its 8-device CPU
    mesh (TeraSort with the port's splitters: the samplers differ)."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.exchange import partitioners as refp
    from sparkrdma_tpu.workloads.repartition import generate_records

    from sparkrdma_tpu_torch.workloads.terasort import random_records

    def read(conf, rows_or_recs, part, parts, **reader):
        m = RefManager(RefRuntime(conf), conf)
        try:
            recs = (m.runtime.shard_records(rows_or_recs)
                    if isinstance(rows_or_recs, np.ndarray) else
                    rows_or_recs(m))
            h = m.register_shuffle(1, parts, part)
            plan = m.get_writer(h).write(recs).stop()
            out, tot = m.get_reader(h, **reader).read()
            return np.asarray(out), np.asarray(tot), plan, m
        finally:
            m.stop()

    res = {}
    conf = RefConf(slot_records=64)
    out, tot, _, _ = read(conf, lambda m: generate_records(
        m, REPART_PER, REPART_SEED), refp.hash_partitioner(16), 16)
    res["repartition"] = (out, tot)

    def ts(splitters):
        conf = RefConf(**TS_KNOBS)
        x = random_records(D * TS_PER, conf.record_words, TS_SEED, "cpu")
        rows = np.ascontiguousarray(x.numpy().view(np.uint32).T)
        out, tot, plan, m = read(conf, rows,
                                 refp.range_partitioner(splitters, 2), D,
                                 key_ordering=True)
        assert m._exchange._uses_fast_sort(plan.out_capacity, 2, "")
        return out, tot
    res["terasort"] = ts

    x = _rows(HIER_PER, HIER_SEED)
    for geo, knobs in HIER_GEOMETRIES.items():
        for hosts in HOSTS:
            res[f"hier/{geo}/{hosts}"] = read(
                RefConf(transport="hierarchical", hierarchy_hosts=hosts,
                        **knobs), x, refp.hash_partitioner(16), 16)[:2]
        for fused in RING_FUSED:
            res[f"ring/{geo}/{fused}"] = read(
                RefConf(transport="pallas_ring", ring_fused=fused, **knobs),
                x, refp.hash_partitioner(16), 16)[:2]
    res["ckpt"] = read(RefConf(slot_records=64), _rows(CKPT_PER, CKPT_SEED),
                       refp.modulo_partitioner(D, key_word=1), D)[:2]
    return res


def _check(parts: list, single: dict, reference: dict, world: int) -> None:
    def same(key, want):
        np.testing.assert_array_equal(_joined(parts, key), want, err_msg=key)

    # every key of the one-process run, joined from the processes
    for key in single:
        if key.endswith(("/out", "/totals")):
            same(key, single[key])
    for p in parts:
        for key in ("repartition/records", "terasort/records",
                    "terasort/splitters", "terasort/fast_sort"):
            np.testing.assert_array_equal(p[key], single[key], err_msg=key)
    assert single["repartition/records"][0] == D * REPART_PER
    assert single["terasort/fast_sort"][0]

    # against the reference
    same("repartition/out", reference["repartition"][0])
    same("repartition/totals", reference["repartition"][1])
    out_r, tot_r = reference["terasort"](single["terasort/splitters"])
    same("terasort/out", out_r)
    same("terasort/totals", tot_r)
    same("terasort_ring/out", out_r)
    same("terasort_ring/totals", tot_r)
    for geo in HIER_GEOMETRIES:
        flat = f"hier/{geo}/xla"
        for hosts in HOSTS:
            name = f"hier/{geo}/hierarchical{hosts}"
            same(name + "/out", _joined(parts, flat + "/out"))
            same(name + "/totals", _joined(parts, flat + "/totals"))
            same(name + "/out", reference[f"hier/{geo}/{hosts}"][0])
            same(name + "/totals", reference[f"hier/{geo}/{hosts}"][1])
            for p in parts:
                # one move a round (a chunk of one round streaming) and
                # one for the counts; the degenerate hierarchy goes flat
                moves = int(p[name + "/rounds"][0]) + 1
                want = [0, moves] if hosts == 1 else [moves, 0]
                assert p[name + "/moves"].tolist() == want, name
        assert int(parts[0][f"hier/{geo}/xla/rounds"][0]) > (
            1 if geo == "stream" else 0)
        for fused in RING_FUSED:
            name = f"ring/{geo}/{'fused' if fused else 'per_round'}"
            same(name + "/out", _joined(parts, flat + "/out"))
            same(name + "/totals", _joined(parts, flat + "/totals"))
            same(name + "/out", reference[f"ring/{geo}/{fused}"][0])
            same(name + "/totals", reference[f"ring/{geo}/{fused}"][1])
            rounds = int(parts[0][name + "/rounds"][0])
            # fused: one push carries the counts and every round; a
            # chunk of one round streaming, the counts' push first. A
            # push a round: the counts' move, then one a round
            want = (1 if geo == "fused" else 1 + rounds) if fused \
                else 1 + rounds
            for p in parts:
                assert int(p[name + "/moves"][0]) == want, name
                assert p[name + "/closed"][0], name
            assert int(single[name + "/moves"][0]) == 0
    for p in parts:
        assert int(p["terasort_ring/moves"][0]) > 0
    for key in ("ckpt/live", "ckpt/resumed"):
        same(key + "/out", reference["ckpt"][0])
        same(key + "/totals", reference["ckpt"][1])
    for r, p in enumerate(parts):
        np.testing.assert_array_equal(p["ckpt/marker_shards"], p["ckpt/local"])
        assert len(p["ckpt/local"]) == D // world


def test_two_processes_match_one_and_the_reference(tmp_path, single,
                                                   reference):
    parts = _run_workers(tmp_path, 2)
    _check(parts, single, reference, 2)
    shards = sorted(f.name for f in (tmp_path / "ckpt" / "shuffle_7").iterdir())
    assert shards == ["meta.json", "proc0.json", "proc1.json"] + [
        f"shard_{c}.u32" for c in range(D)]


@pytest.mark.slow
def test_four_processes_stage_one_crosses(tmp_path, single, reference):
    """H = 2 below four processes: stage 1 spans processes as well."""
    parts = _run_workers(tmp_path, 4)
    _check(parts, single, reference, 4)


# --- the bootstrap -----------------------------------------------------
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_initialize_without_coordinator_is_one_process(monkeypatch, caplog):
    from sparkrdma_tpu_torch import initialize_distributed

    for k in RENDEZVOUS_ENV:
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level("INFO", logger="sparkrdma_tpu_torch.runtime"):
        assert initialize_distributed() is False
    assert "single-process" in caplog.text
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_initialize_true_when_a_group_is_up(tmp_path):
    import torch.distributed as dist

    from sparkrdma_tpu_torch import MeshRuntime, initialize_distributed

    try:
        assert initialize_distributed(
            num_processes=1, process_id=0, backend="gloo",
            init_method=f"file://{tmp_path / 'rv'}")
        # a group is up: nothing to join, whatever the arguments say
        assert initialize_distributed("127.0.0.1:1", 2, 1)
        rt = MeshRuntime(num_partitions=D, device="cpu")
        assert (rt.process_index, rt.process_count) == (0, 1)
    finally:
        dist.destroy_process_group()


def test_initialize_retries_then_raises(monkeypatch):
    """``max_attempts`` tries against an address nobody listens on,
    ``retry_delay_s`` apart, then ``RuntimeError`` from the last."""
    import socket
    import time as _time

    from sparkrdma_tpu_torch import initialize_distributed

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    sleeps = []
    monkeypatch.setattr(_time, "sleep", sleeps.append)
    with pytest.raises(RuntimeError, match="after 3 attempts") as err:
        initialize_distributed(f"127.0.0.1:{port}", num_processes=2,
                               process_id=1, max_attempts=3,
                               retry_delay_s=7.0, backend="gloo",
                               timeout_s=1.0)
    assert sleeps == [7.0, 7.0, 7.0]
    assert err.value.__cause__ is not None


def test_initialize_reads_torchrun_env(monkeypatch):
    """``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are
    the coordinator when no argument is given."""
    import torch.distributed as dist

    from sparkrdma_tpu_torch.runtime import distributed

    seen = {}

    def fake_init(backend, init_method, world_size, rank, **kw):
        seen.update(backend=backend, init_method=init_method,
                    world=world_size, rank=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "2345")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert distributed.initialize_distributed(backend="gloo")
    assert seen == dict(backend="gloo", init_method="tcp://10.0.0.7:2345",
                        world=4, rank=3)


# --- the runtime and the config ----------------------------------------
@pytest.fixture
def two_processes(monkeypatch):
    """Runtimes built now believe they are process 0 of 2 (no group:
    only what refuses before any collective can be driven)."""
    from sparkrdma_tpu_torch.runtime import mesh

    monkeypatch.setattr(mesh, "group_rank", lambda: (0, 2))


def test_runtime_spans_the_group(two_processes):
    from sparkrdma_tpu_torch import MeshRuntime

    rt = MeshRuntime(num_partitions=D, device="cpu")
    assert (rt.process_index, rt.process_count, rt.local_partitions) == \
        (0, 2, 4)
    assert rt.local_device_indices() == (0, 1, 2, 3)
    assert [rt.manager_id(d).process_index for d in range(D)] == \
        [0] * 4 + [1] * 4
    rows = _rows(4, 1)
    cols = rt.shard_records(rows)
    np.testing.assert_array_equal(
        cols.numpy().view(np.uint32), rows[:16].T)
    assert rt.shard_rows(np.arange(D * 3)).tolist() == list(range(12))
    np.testing.assert_array_equal(rt.partition(cols, 1).numpy(),
                                  cols[:, 4:8].numpy())
    with pytest.raises(ValueError, match="evenly"):
        MeshRuntime(num_partitions=3, device="cpu")


def test_process_identity_is_the_rank(monkeypatch, tmp_path):
    """The journal's ``{process}`` placeholder, the heartbeat's identity
    and the spans' ``process_index`` take the rank in the group."""
    from sparkrdma_tpu_torch.runtime import mesh

    monkeypatch.setattr(mesh, "group_rank", lambda: (1, 2))
    m = _manager(metrics_sink=str(tmp_path / "j{process}.jsonl"))
    try:
        assert m._sink_path == str(tmp_path / "j1.jsonl")
        ident = m.runtime.process_identity()
        assert (ident["process_index"], ident["host_count"]) == (1, 2)
        assert m._exchange.identity == (1, 2)
        assert m.runtime.local_device_indices() == (4, 5, 6, 7)
    finally:
        m.stop()


def test_conf_hierarchical_accepted():
    from sparkrdma_tpu_torch import ShuffleConf

    conf = ShuffleConf(transport="hierarchical", hierarchy_hosts=2)
    assert (conf.transport, conf.hierarchy_hosts) == ("hierarchical", 2)
    assert ShuffleConf().hierarchy_hosts == 0
    with pytest.raises(ValueError, match="hierarchy_hosts"):
        ShuffleConf(hierarchy_hosts=-1)


def _manager(**kw):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    return ShuffleManager(MeshRuntime(ShuffleConf(**kw), num_partitions=D,
                                      device="cpu"))


def test_ring_runs_across_processes(two_processes):
    """The ring builds across processes (it refused until its push form
    came); the scenarios above run it. Without a group nothing is
    mapped, so stopping closes nothing."""
    from sparkrdma_tpu_torch.exchange.windows import open_windows

    m = _manager(transport="pallas_ring", ring_fused=False)
    try:
        assert m._exchange.processes == 2
        assert m._exchange.transport() == "pallas_ring"
    finally:
        m.stop()
    assert not open_windows()


def _refusals():
    """Each entry point that runs in one process only (ROADMAP A.12);
    the Dataset's own are in ``tests/test_torch_distributed_dataset.py``,
    the planner's and the service's in ``tests/test_torch_distributed_plan.py``
    and ``tests/test_torch_distributed_service.py``."""
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads import (als, join, pagerank,
                                               streaming, tpcds)

    cols = np.zeros((4, 64), np.uint32)

    def reader(m, call):
        h = m.register_shuffle(1, D, hash_partitioner(D))
        return call(m.get_reader(h))

    return {
        "run_pagerank": lambda m: pagerank.run_pagerank(
            m.runtime, np.zeros((8, 2), np.int64), 8),
        "run_hash_join": lambda m: join.run_hash_join(m, 8, 8),
        "run_als": lambda m: als.run_als(m.runtime, np.zeros((8, 3)), 8, 8),
        "run_q64_shape": lambda m: tpcds.run_q64_shape(m),
        "run_q95_shape": lambda m: tpcds.run_q95_shape(m),
        "run_star_suite": lambda m: tpcds.run_star_suite(m),
        "run_tiered_terasort": lambda m: streaming.run_tiered_terasort(
            m, cols, 32),
        "read_partition": lambda m: reader(m, lambda r: r.read_partition(0)),
        "read_view": lambda m: reader(m, lambda r: r.read_view()),
    }


REFUSED = ("run_pagerank", "run_hash_join", "run_als", "run_q64_shape",
           "run_q95_shape", "run_star_suite", "run_tiered_terasort",
           "read_partition", "read_view")


#: where the reference itself fails across processes (it reads a global
#: array on the host)
REFERENCE_LINES = {
    "run_pagerank": "sparkrdma_tpu/workloads/pagerank.py:207",
    "run_hash_join": "sparkrdma_tpu/workloads/join.py:254",
    "run_als": "sparkrdma_tpu/workloads/als.py:272",
    "run_q64_shape": "sparkrdma_tpu/api/dataset.py:531",
    "run_q95_shape": "sparkrdma_tpu/workloads/tpcds.py:312",
    "run_star_suite": "sparkrdma_tpu/api/dataset.py:531",
    "run_tiered_terasort": "sparkrdma_tpu/workloads/streaming.py:331",
    "read_partition": "sparkrdma_tpu/api/shuffle_manager.py:552",
    "read_view": "sparkrdma_tpu/api/shuffle_manager.py:582",
}


def test_refusals_listed():
    assert tuple(_refusals()) == REFUSED


@pytest.mark.parametrize("name", REFUSED)
def test_entry_point_refused_across_processes(two_processes, name):
    m = _manager()
    try:
        with pytest.raises(NotImplementedError, match="A.12") as err:
            _refusals()[name](m)
        said = str(err.value)
        assert f"as the reference: `{REFERENCE_LINES[name]}`" in said
    finally:
        m.stop()


@pytest.mark.parametrize("entry", ["terasort", "repartition"])
def test_whole_array_checks_refused_across_processes(two_processes, entry):
    from sparkrdma_tpu_torch.workloads.repartition import run_repartition
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    m = _manager()
    run = run_terasort if entry == "terasort" else run_repartition
    try:
        with pytest.raises(ValueError, match="verify=False"):
            run(m, 8)
    finally:
        m.stop()


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
