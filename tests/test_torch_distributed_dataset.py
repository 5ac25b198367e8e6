"""The ``Dataset`` verbs, the input streamer and the streaming TeraSort
fold across processes: two gloo CPU processes x 4 partitions.

What the reference runs across processes, the port runs there too (the
geometry of ``tests/test_torch_distributed.py``, whose worker-as-script
pattern this file follows): each worker is this file run as a script
(``python tests/test_torch_distributed_dataset.py RANK WORLD INIT_FILE
OUT_DIR``, no JAX), the two meet through ``file://`` in ``tmp_path`` and
each is killed past 120 s (four processes under ``-m slow``). Each
worker runs :func:`run_all` on the port and writes its local outputs;
the test joins them in partition order and holds them, tolerance 0,
against the same scenarios run in one process by the port and by the
reference on the conftest's 8-device CPU mesh:

- ``from_host_rows`` then ``sort_by_key``, ``repartition``,
  ``reduce_by_key`` (``sum``, ``max``, ``float_payload``), ``distinct``
  and ``count_by_key``; ``filter`` then ``sort_by_key``;
- ``from_host_payloads`` (chunked and one-shot) and ``from_host_columns``
  then ``sort_by_key``; ``select`` then ``repartition``; the local rows
  ``to_host_payloads`` / ``to_host_columns`` give back;
- ``InputStreamer``'s per-process chunks, and ``run_streaming_terasort``'s
  ``fold_sums`` (global on every process).

Everything runs in the merge-path geometry (a power-of-two output
capacity of at least two runs), where both packages' key-ordered tails
agree bit for bit. The samplers differ (``jax.random`` against a seeded
``torch.Generator``), so the reference's ``sort_by_key`` is handed the
port's sample. The rows of ``reduce_by_key`` skew the
combine gate's sample: partition 0 (process 0) is full of duplicate keys
and partition 4 (process 1) has none, so the processes take one decision
(``gate``) only because process 0's estimate is broadcast.

The entry points the reference cannot run across processes raise
``NotImplementedError`` naming ROADMAP A.12 and the reference's failing
line: one case each, on a runtime that believes it is process 0 of 2,
and a few again in the real two-process run.
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
#: (power of two, two runs) output capacity
KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
             pack_sort_min_payload=0, wide_sort_min_payload=0)
PER = 160
MAXB = 13
SCHEMA = [("u", "uint32"), ("i", "int64"), ("b", ("bytes", 10))]
#: the load's chunk: 64 rows, 8 a partition, so a partition takes
#: several chunks and the last one is ragged (160 = 20 * 8)
SERDE_CHUNK = 64
STREAM_CHUNK, STREAM_CHUNKS = 512, 4

#: where the reference fails across processes, by refused call
REF = "sparkrdma_tpu/api/dataset.py"
REFUSALS = {
    "count": f"{REF}:575",
    "to_host_rows": f"{REF}:531",
    "collect_rows": f"{REF}:1165",
    "group_by_key": f"{REF}:1015",
    "cogroup": f"{REF}:1064",
    "join_count": f"{REF}:1086",
    "join": f"{REF}:1122",
    "chained repartition": f"{REF}:660",
    "chained sort_by_key": f"{REF}:660",
    "chained reduce_by_key": f"{REF}:660",
    "chained distinct": f"{REF}:660",
    "chained count_by_key": f"{REF}:660",
    "chained filter then repartition": f"{REF}:660",
    "chained to_host_payloads": "sparkrdma_tpu/api/pipeline.py:245",
    "chained to_host_columns": "sparkrdma_tpu/api/pipeline.py:479",
    "repartition with the caller's totals": f"{REF}:660",
    "run_streaming_terasort with spill_dir":
        "sparkrdma_tpu/workloads/streaming.py:139",
}


# --- the inputs, from numpy seeds --------------------------------------
def rows_sort(w: int = 4) -> np.ndarray:
    """Random words (no all-ones key): keys all but surely distinct."""
    rng = np.random.default_rng(21)
    return rng.integers(1, 2**32 - 1, size=(D * PER, w), dtype=np.uint32)


def rows_dup(floating: bool = False) -> np.ndarray:
    """Keys ``(0, id)``: ids in [0, 16) on the first half's partitions
    (process 0's), in [0, 2^20) on the second half's; random payloads
    (float32 bit patterns with ``floating``)."""
    rng = np.random.default_rng(23 if floating else 22)
    n = D * PER
    x = np.zeros((n, 4), np.uint32)
    x[:n // 2, 1] = rng.integers(0, 16, size=n // 2)
    x[n // 2:, 1] = rng.integers(0, 1 << 20, size=n - n // 2)
    if floating:
        x[:, 2:] = rng.standard_normal((n, 2)).astype(
            np.float32).view(np.uint32)
    else:
        x[:, 2:] = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    return x


def rows_distinct() -> np.ndarray:
    """Keys ``(0, id < 64)``, word 2 in [0, 3), word 3 a function of both:
    full rows repeat."""
    rng = np.random.default_rng(24)
    x = np.zeros((D * PER, 4), np.uint32)
    x[:, 1] = rng.integers(0, 64, size=D * PER)
    x[:, 2] = rng.integers(0, 3, size=D * PER)
    x[:, 3] = x[:, 1] * np.uint32(2654435761) + x[:, 2]
    return x


def payload_input():
    rng = np.random.default_rng(25)
    keys = rng.integers(1, 2**32 - 1, size=(D * PER, 2), dtype=np.uint32)
    pays = [rng.bytes(int(k))
            for k in rng.integers(0, MAXB + 1, size=D * PER)]
    return keys, pays


def column_input():
    rng = np.random.default_rng(26)
    n = D * PER
    keys = rng.integers(1, 2**32 - 1, size=(n, 2), dtype=np.uint32)
    cols = {"u": rng.integers(0, 2**32, size=n, dtype=np.uint32),
            "i": rng.integers(-2**62, 2**62, size=n),
            "b": [rng.bytes(int(k)) for k in rng.integers(0, 11, size=n)]}
    return keys, cols


def stream_input() -> np.ndarray:
    rng = np.random.default_rng(27)
    return rng.integers(0, 2**32, size=(4, STREAM_CHUNK * STREAM_CHUNKS),
                        dtype=np.uint32)


def even_w2(r):
    """Rows whose word 2 is even: one predicate for both packages."""
    return (r[2] & 1) == 0


def _bytes(col) -> list:
    return col.to_list() if hasattr(col, "to_list") else list(col)


def _flat(payloads: list) -> dict:
    """A list of bytes as lengths and one heap."""
    return {"lens": np.array([len(p) for p in payloads], np.int64),
            "heap": np.frombuffer(b"".join(payloads), np.uint8)}


# --- the scenarios, over either package --------------------------------
def run_all(api) -> dict:
    """Every scenario through ``api`` (:class:`PortApi` or the
    reference's): ``{name: array}``. A name ending in ``/out`` is
    columnar records, ``/totals`` per-partition counts, ``/rows`` host
    rows in partition order; ``/chunks`` the streamer's chunks
    ``[J, W, C]``; any other name is the same on every process."""
    res = {}

    def keep(name, ds):
        res[name + "/out"] = api.words(ds.records)
        res[name + "/totals"] = api.counts(ds.totals)

    def sort(name, ds):
        out = api.sorted(ds, name)
        keep(name, out)

    m = api.manager(**KNOBS)
    ds = api.Dataset.from_host_rows(m, rows_sort())
    sort("sort_by_key", ds)
    sort("filter_sort", ds.filter(even_w2, cache_key=("even_w2",)))
    keep("repartition", ds.repartition())
    dd = api.Dataset.from_host_rows(m, rows_dup())
    keep("reduce_sum", dd.reduce_by_key("sum"))
    stats = m._exchange.wire_stats()
    res["gate"] = np.array([stats["combine_dup_ratio"],
                            "combine_in_records" in stats])
    keep("reduce_max", dd.reduce_by_key("max"))
    keep("count_by_key", dd.count_by_key())
    keep("reduce_float", api.Dataset.from_host_rows(
        m, rows_dup(floating=True)).reduce_by_key("sum",
                                                  float_payload=True))
    keep("distinct", api.Dataset.from_host_rows(m, rows_distinct())
         .distinct())

    keys, pays = payload_input()
    mp = api.manager(val_words=api.payload_words(MAXB),
                     serde_chunk_records=SERDE_CHUNK, **KNOBS)
    dp = api.Dataset.from_host_payloads(mp, keys, pays, MAXB)
    keep("payloads_load", dp)
    keep("payloads_load_one_shot", api.Dataset.from_host_payloads(
        mp, keys, pays, MAXB, chunk_records=0))
    sort("payloads_sort", dp)
    k, p = dp.to_host_payloads()
    res["payloads_host/rows"] = k
    res.update({f"payloads_host_{n}/rows": v for n, v in _flat(p).items()})

    keys, cols = column_input()
    schema = api.RowSchema(SCHEMA)
    mc = api.manager(val_words=schema.payload_words,
                     serde_chunk_records=SERDE_CHUNK, **KNOBS)
    dc = api.Dataset.from_host_columns(mc, keys, cols, schema)
    keep("columns_load", dc)
    sort("columns_sort", dc)
    keep("select_repartition", dc.select("i").repartition())
    k, c = dc.filter(even_w2).select("u", "b").to_host_columns()
    res["columns_host/rows"] = k
    res["columns_host_u/rows"] = np.asarray(c["u"])
    res["columns_host_i/rows"] = np.asarray(c["i"])
    res.update({f"columns_host_b_{n}/rows": v
                for n, v in _flat(_bytes(c["b"])).items()})

    x = stream_input()
    res["streamer/chunks"] = np.stack([api.words(c) for c in api.stream(
        m, x, STREAM_CHUNK)])
    fold = api.streaming_terasort(m, x, STREAM_CHUNK)
    res["fold_sums"] = np.asarray(fold.fold_sums)
    res["fold_records"] = np.array([fold.records, fold.chunks,
                                    fold.verified is None])
    for mm in (m, mp, mc):
        mm.stop()
    return res


class PortApi:
    """The port's side of :func:`run_all`; its sorts record the splitter
    sample they drew (``samples``)."""

    def __init__(self, device: str = "cpu"):
        from sparkrdma_tpu_torch.api.dataset import Dataset
        from sparkrdma_tpu_torch.api.serde import RowSchema, payload_words

        self.device = device
        self.Dataset, self.RowSchema = Dataset, RowSchema
        self.payload_words = payload_words
        self.samples = {}

    def manager(self, **kw):
        from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
        from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

        return ShuffleManager(MeshRuntime(ShuffleConf(**kw), D,
                                          device=self.device))

    @staticmethod
    def words(x) -> np.ndarray:
        from sparkrdma_tpu_torch.interop import records_from_torch

        return records_from_torch(x)

    @staticmethod
    def counts(x) -> np.ndarray:
        return x.cpu().numpy().astype(np.int64)

    def sorted(self, ds, name):
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
            return ds.sort_by_key()
        finally:
            dataset_mod.make_sampler = plain

    def stream(self, m, x, chunk):
        from sparkrdma_tpu_torch.hbm.input_stream import (ArrayChunkSource,
                                                          InputStreamer)

        return list(InputStreamer(m.runtime, ArrayChunkSource(x, chunk)))

    def streaming_terasort(self, m, x, chunk):
        from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
        from sparkrdma_tpu_torch.workloads.streaming import (
            run_streaming_terasort)

        return run_streaming_terasort(m, ArrayChunkSource(x, chunk),
                                      verify=True)


class RefApi:
    """The reference's side of :func:`run_all`: its sorts take the
    port's sample (``samples``, by scenario name)."""

    def __init__(self, samples: dict):
        from sparkrdma_tpu.api.dataset import Dataset
        from sparkrdma_tpu.api.serde import RowSchema, payload_words

        self.Dataset, self.RowSchema = Dataset, RowSchema
        self.payload_words = payload_words
        self.samples = samples

    def manager(self, **kw):
        from sparkrdma_tpu import ShuffleConf
        from sparkrdma_tpu.api.shuffle_manager import ShuffleManager

        return ShuffleManager(conf=ShuffleConf(**kw))

    @staticmethod
    def words(x) -> np.ndarray:
        return np.asarray(x)

    @staticmethod
    def counts(x) -> np.ndarray:
        return np.asarray(x).astype(np.int64)

    def sorted(self, ds, name):
        from sparkrdma_tpu.api import dataset as dataset_mod

        plain = dataset_mod.make_sampler
        sample = self.samples[name]
        dataset_mod.make_sampler = lambda *a, **k: (lambda records: sample)
        try:
            return ds.sort_by_key()
        finally:
            dataset_mod.make_sampler = plain

    def stream(self, m, x, chunk):
        from sparkrdma_tpu.hbm.input_stream import (ArrayChunkSource,
                                                    InputStreamer)

        return list(InputStreamer(m.runtime, ArrayChunkSource(x, chunk)))

    def streaming_terasort(self, m, x, chunk):
        from sparkrdma_tpu.hbm.input_stream import ArrayChunkSource
        from sparkrdma_tpu.workloads.streaming import run_streaming_terasort

        return run_streaming_terasort(m, ArrayChunkSource(x, chunk),
                                      verify=True)


def group_refusals() -> dict:
    """In the real group: a few refused calls, each ``[type, message]``
    (``["", ""]`` if it did not raise)."""
    from sparkrdma_tpu_torch.api.dataset import Dataset

    api = PortApi()
    m = api.manager(**KNOBS)
    ds = Dataset.from_host_rows(m, rows_sort())
    calls = {
        "count": lambda: ds.count,
        "to_host_rows": lambda: ds.to_host_rows(),
        "chained repartition": lambda: ds.sort_by_key().repartition(),
        "chained filter then repartition":
            lambda: ds.repartition().filter(even_w2).repartition(),
        "chained count_by_key": lambda: ds.distinct().count_by_key(),
    }
    said = {}
    for name, call in calls.items():
        try:
            call()
            said[name] = ["", ""]
        except Exception as e:      # the test holds type and message
            said[name] = [type(e).__name__, str(e)]
    m.stop()
    return said


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
    api = PortApi()
    res = run_all(api)
    res.update({f"samples/{k}": v for k, v in api.samples.items()})
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
def workers(tmp_path_factory):
    """The two processes' outputs, each ``(arrays, refusals)``."""
    return _run_workers(tmp_path_factory.mktemp("two"), 2)


@pytest.fixture(scope="module")
def single():
    """The scenarios in this (group-less) process, and the samples the
    sorts drew."""
    api = PortApi()
    return run_all(api), api.samples


@pytest.fixture(scope="module")
def reference(single):
    """The reference's outputs on its 8-device CPU mesh, its sorts handed
    the port's samples."""
    return run_all(RefApi(single[1]))


def _joined(parts: list, key: str) -> np.ndarray:
    """The processes' local arrays in partition order."""
    if key.endswith("/out"):
        axis = 1
    elif key.endswith("/chunks"):
        axis = 2
    elif key.endswith(("/totals", "/rows")):
        axis = 0
    else:
        for p in parts[1:]:
            np.testing.assert_array_equal(p[key], parts[0][key],
                                          err_msg=key)
        return parts[0][key]
    return np.concatenate([p[key] for p in parts], axis=axis)


SCENARIOS = ("sort_by_key", "filter_sort", "repartition", "reduce_sum",
             "reduce_max", "count_by_key", "reduce_float", "distinct",
             "payloads_load", "payloads_load_one_shot", "payloads_sort",
             "payloads_host", "columns_load", "columns_sort",
             "select_repartition", "columns_host", "streamer", "fold",
             "gate")


#: scenarios whose arrays are several names, each ``<scenario>_<part>``
SPLIT = ("payloads_host", "columns_host", "fold")


def _keys(res: dict, name: str) -> list:
    """The result names a scenario wrote."""
    heads = {k: k.split("/")[0] for k in res}
    return sorted(k for k, h in heads.items() if h == name or (
        name in SPLIT and h.startswith(name + "_")))


def test_scenarios_listed(single):
    covered = [k for n in SCENARIOS for k in _keys(single[0], n)]
    assert sorted(covered) == sorted(single[0])


@pytest.mark.parametrize("name", SCENARIOS)
def test_two_processes_match_one_and_the_reference(workers, single,
                                                   reference, name):
    parts = [w[0] for w in workers]
    keys = _keys(single[0], name)
    assert keys, name
    for key in keys:
        got = _joined(parts, key)
        np.testing.assert_array_equal(got, single[0][key], err_msg=key)
        np.testing.assert_array_equal(got, reference[key], err_msg=key)
    for sname, sample in single[1].items():
        if sname == name:
            # every process computed the splitters from the whole sample
            for p in parts:
                np.testing.assert_array_equal(p[f"samples/{name}"], sample)


@pytest.mark.slow
def test_four_processes_match_one_and_the_reference(tmp_path, single,
                                                    reference):
    """Four processes of two partitions each: the same outputs."""
    parts = [w[0] for w in _run_workers(tmp_path, 4)]
    for name in SCENARIOS:
        for key in _keys(single[0], name):
            got = _joined(parts, key)
            np.testing.assert_array_equal(got, single[0][key], err_msg=key)
            np.testing.assert_array_equal(got, reference[key], err_msg=key)


def test_outputs_are_what_they_should_be(single):
    """The one-process outputs against the host inputs, so the parity
    above holds something: the loads are the inputs, the fold is their
    sums, the streamer's chunks the array's, the sorts merge-path ones."""
    res, _ = single
    x = stream_input()
    want = np.concatenate([[x.shape[1]], x.astype(np.uint64).sum(axis=1)
                           & np.uint64(0xFFFFFFFF)]).astype(np.uint32)
    np.testing.assert_array_equal(res["fold_sums"], want)
    assert res["fold_records"].tolist() == [x.shape[1], STREAM_CHUNKS, 1]
    np.testing.assert_array_equal(
        np.concatenate(list(res["streamer/chunks"]), axis=1), x)
    keys, pays = payload_input()
    np.testing.assert_array_equal(res["payloads_host/rows"], keys)
    np.testing.assert_array_equal(res["payloads_host_lens/rows"],
                                  [len(p) for p in pays])
    np.testing.assert_array_equal(res["payloads_load/out"],
                                  res["payloads_load_one_shot/out"])
    assert res["payloads_load/totals"].tolist() == [PER] * D
    for name in ("sort_by_key", "payloads_sort", "columns_sort"):
        assert res[name + "/out"].shape[1] == D * 256, name
        assert int(res[name + "/totals"].sum()) == D * PER, name
    assert int(res["filter_sort/totals"].sum()) == D * PER
    n_even = int((rows_sort()[:, 2] % 2 == 0).sum())
    filler = (res["filter_sort/out"][:2] == 0xFFFFFFFF).all(axis=0)
    assert int(filler.sum()) == D * PER - n_even


def test_refused_in_the_group(workers):
    for _, said in workers:
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


def _refused_calls():
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        run_streaming_terasort)

    def loaded(m):
        return Dataset.from_host_rows(m, rows_sort())

    def exchanged(ds):
        ds.exchanged = True
        return ds

    def payloads(m):
        keys, pays = payload_input()
        return Dataset.from_host_payloads(m, keys, pays, MAXB)

    def columns(m):
        keys, cols = column_input()
        return Dataset.from_host_columns(
            m, keys, cols, PortApi().RowSchema(SCHEMA))

    return {
        "count": lambda m: loaded(m).count,
        "to_host_rows": lambda m: loaded(m).to_host_rows(),
        "collect_rows": lambda m: Dataset.collect_rows(
            loaded(m).records, loaded(m).totals),
        "group_by_key": lambda m: loaded(m).group_by_key(),
        "cogroup": lambda m: loaded(m).cogroup(loaded(m)),
        "join_count": lambda m: loaded(m).join_count(loaded(m)),
        "join": lambda m: loaded(m).join(loaded(m)),
        "chained repartition":
            lambda m: exchanged(loaded(m)).repartition(),
        "chained sort_by_key":
            lambda m: exchanged(loaded(m)).sort_by_key(),
        "chained reduce_by_key":
            lambda m: exchanged(loaded(m)).reduce_by_key("max"),
        "chained distinct": lambda m: exchanged(loaded(m)).distinct(),
        "chained count_by_key":
            lambda m: exchanged(loaded(m)).count_by_key(),
        "chained filter then repartition": lambda m: exchanged(
            loaded(m)).filter(even_w2).repartition(),
        "chained to_host_payloads":
            lambda m: exchanged(payloads(m)).to_host_payloads(),
        "chained to_host_columns":
            lambda m: exchanged(columns(m)).to_host_columns(),
        "repartition with the caller's totals": lambda m: Dataset(
            m, loaded(m).records, loaded(m).totals).repartition(),
        "run_streaming_terasort with spill_dir":
            lambda m: run_streaming_terasort(
                m, ArrayChunkSource(stream_input(), STREAM_CHUNK),
                spill_dir=str(REPO / "never-written")),
    }


def _width(name: str) -> dict:
    if "payloads" in name:
        return {"val_words": PortApi().payload_words(MAXB)}
    if "columns" in name:
        return {"val_words": PortApi().RowSchema(SCHEMA).payload_words}
    return {}


def test_refusals_listed():
    assert tuple(_refused_calls()) == tuple(REFUSALS)


@pytest.mark.parametrize("name", tuple(REFUSALS))
def test_refused_across_processes(two_processes, name):
    api = PortApi()
    m = api.manager(**KNOBS, **_width(name))
    try:
        with pytest.raises(NotImplementedError, match="A.12") as err:
            _refused_calls()[name](m)
        assert f"as the reference: `{REFUSALS[name]}`" in str(err.value)
    finally:
        m.stop()


def test_results_are_marked():
    """A verb's result is marked as an exchange's output, and so is a
    filter or select view of it and a dataset given its totals; a
    loaded dataset and its views are not (one process, where nothing
    refuses)."""
    from sparkrdma_tpu_torch.api.dataset import Dataset

    api = PortApi()
    m = api.manager(**KNOBS)
    try:
        ds = Dataset.from_host_rows(m, rows_distinct())
        assert not ds.exchanged
        assert not ds.filter(even_w2).exchanged
        assert not ds.filter(even_w2)._materialize_pending().exchanged
        assert Dataset(m, ds.records, ds.totals).exchanged
        for res in (ds.repartition(), ds.sort_by_key(),
                    ds.reduce_by_key("sum"), ds.distinct(),
                    ds.count_by_key(), ds.filter(even_w2).repartition()):
            assert res.exchanged
            assert res.filter(even_w2).exchanged
            assert res.filter(even_w2)._materialize_pending().exchanged
    finally:
        m.stop()


@pytest.mark.parametrize("procs", [1, 2])
def test_streamer_refuses_uneven_chunks(monkeypatch, procs):
    from sparkrdma_tpu_torch.hbm.input_stream import (ArrayChunkSource,
                                                      InputStreamer)
    from sparkrdma_tpu_torch.runtime import mesh

    monkeypatch.setattr(mesh, "group_rank", lambda: (0, procs))
    m = PortApi().manager(**KNOBS)
    try:
        src = ArrayChunkSource(np.zeros((4, 3 * 36), np.uint32), 36)
        with pytest.raises(ValueError, match="split evenly"):
            list(InputStreamer(m.runtime, src))
    finally:
        m.stop()


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
