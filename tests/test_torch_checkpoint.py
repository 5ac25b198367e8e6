"""Whole and sharded checkpoints, port vs reference, across packages.

- the reference's ``MapOutputStore.save`` and the port's ``save`` of the
  same records and plan give byte-identical ``records.u32`` and equal
  ``meta.json`` (uncompressed, zlib and lzma); so do ``save_shards``'s
  shard files, markers and metadata;
- the port's ``resume_shuffle`` of a reference checkpoint, whole and
  sharded, reads the bits the reference's read gives, and the
  reference's ``load`` of a port checkpoint returns the same records
  and plan;
- an incomplete or torn sharded checkpoint is refused by both.

Every comparison is exact (integer data, tolerance 0). Rows are made
from a seed with numpy; the reference runs on the forced 8-device CPU
mesh and is imported inside fixtures.
"""

import json

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.errors import UnrecoverableShuffleError
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore

D = 8
CODECS = ["", "zlib", "lzma"]


@pytest.fixture(scope="module")
def ref():
    """``(MapOutputStore, ShufflePlan, ShuffleManager, MeshRuntime,
    ShuffleConf, modulo_partitioner)`` of the reference."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefMgr
    from sparkrdma_tpu.exchange.partitioners import modulo_partitioner as rm
    from sparkrdma_tpu.exchange.protocol import ShufflePlan as RefPlan
    from sparkrdma_tpu.meta.checkpoint import MapOutputStore as RefStore

    return RefStore, RefPlan, RefMgr, RefRuntime, RefConf, rm


def _rows(seed, n_per_dev=16, w=4):
    """The rows of ``tests/test_fault_recovery.py``'s ``_write``: word 1
    a partition id, word 2 random."""
    rng = np.random.default_rng(seed)
    x = np.zeros((D * n_per_dev, w), dtype=np.uint32)
    x[:, 1] = rng.integers(0, D, size=D * n_per_dev)
    x[:, 2] = rng.integers(0, 2**32, size=D * n_per_dev, dtype=np.uint32)
    return x


def _plans(ref, seed=0, split=1):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, size=(D, D * split)).astype(np.int64)
    geo = dict(num_rounds=3, out_capacity=128, capacity=16,
               split_factor=split)
    return ShufflePlan(counts=counts, **geo), ref[1](counts=counts, **geo)


def _records(seed, shape=(4, 8 * 40)):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("split", [1, 2])
def test_save_byte_identical(tmp_path, ref, codec, split):
    mine = MapOutputStore(str(tmp_path / "port"), compression=codec)
    theirs = ref[0](str(tmp_path / "ref"), use_native=False,
                    compression=codec)
    plan, ref_plan = _plans(ref, 1, split)
    recs = _records(2)
    # the port hands its int32 bit views; they are written as <u4
    d1 = mine.save(7, recs.view(np.int32), plan, D)
    d2 = theirs.save(7, recs, ref_plan, D)
    f1, f2 = _files(d1), _files(d2)
    assert sorted(f1) == sorted(f2) == ["meta.json", "records.u32"]
    assert f1["records.u32"] == f2["records.u32"]
    assert json.loads(f1["meta.json"]) == json.loads(f2["meta.json"])
    assert f1["meta.json"] == f2["meta.json"]
    assert not (tmp_path / "port" / "shuffle_7.tmp").exists()
    assert mine.contains(7) and mine.has_records(7)
    assert mine.list_shuffles() == [7]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("procs", [(0, 1), (0, 2), (1, 2)])
def test_save_shards_byte_identical(tmp_path, ref, codec, procs):
    p, n = procs
    mine = MapOutputStore(str(tmp_path / "port"), compression=codec)
    theirs = ref[0](str(tmp_path / "ref"), use_native=False,
                    compression=codec)
    plan, ref_plan = _plans(ref, 3)
    recs = _records(4, (4, 64))
    shards = [(c, recs[:, c * 8:(c + 1) * 8]) for c in range(p * 4,
                                                            p * 4 + 4)]
    d1 = mine.save_shards(9, [(c, a.view(np.int32)) for c, a in shards],
                          plan, D, recs.shape, p, n)
    d2 = theirs.save_shards(9, shards, ref_plan, D, recs.shape, p, n)
    f1, f2 = _files(d1), _files(d2)
    assert sorted(f1) == sorted(f2)
    for name in f1:
        if name.endswith(".json"):
            assert json.loads(f1[name]) == json.loads(f2[name]), name
        assert f1[name] == f2[name], name
    assert MapOutputStore._save_id(plan, recs.shape) == \
        ref[0]._save_id(ref_plan, recs.shape)


def _ref_manager(ref, **kw):
    RefStore, RefPlan, RefMgr, RefRuntime, RefConf, _ = ref
    conf = RefConf(slot_records=64, **kw)
    return RefMgr(RefRuntime(conf), conf)


def _port_manager(**kw):
    return ShuffleManager(MeshRuntime(ShuffleConf(slot_records=64, **kw), D,
                                      device="cpu"))


def _ref_read(m, h):
    out, totals = m.get_reader(h).read()
    return np.asarray(out), np.asarray(totals)


def _port_read(m, h):
    out, totals = m.get_reader(h).read()
    return records_from_torch(out), totals.numpy()


@pytest.mark.parametrize("codec", ["", "zlib"])
def test_port_resumes_reference_checkpoint(tmp_path, ref, codec):
    root = str(tmp_path / "ck")
    rm = _ref_manager(ref, spill_to_host=True, spill_dir=root,
                      compression=codec)
    x = _rows(5)
    try:
        h = rm.register_shuffle(3, D, ref[5](D, key_word=1))
        rm.get_writer(h).write(rm.runtime.shard_records(x)).stop(True)
        want = _ref_read(rm, h)
    finally:
        rm._writers.clear()
        rm.runtime.stop()
    pm = _port_manager(spill_dir=root)
    try:
        ph = pm.register_shuffle(3, D, modulo_partitioner(D, key_word=1))
        w = pm.resume_shuffle(ph)
        assert records_from_torch(w.records).T.tolist() == x.tolist()
        got = _port_read(pm, ph)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
        assert pm._registry.get(3).total_records == x.shape[0]
    finally:
        pm.stop()


def test_port_resumes_reference_sharded_checkpoint(tmp_path, ref):
    rm = _ref_manager(ref)
    x = _rows(6)
    try:
        h = rm.register_shuffle(30, D, ref[5](D, key_word=1))
        rm.get_writer(h).write(rm.runtime.shard_records(x)).stop(True)
        writer = rm._writers[30]
        want = _ref_read(rm, h)
        recs = np.asarray(writer.records)
        store = ref[0](str(tmp_path / "sharded"), use_native=False)
        n = recs.shape[1] // D
        # two processes' worth of shards, written as each would
        for p in range(2):
            store.save_shards(30, [(c, recs[:, c * n:(c + 1) * n])
                                   for c in range(p * 4, p * 4 + 4)],
                              writer.plan, D, recs.shape, p, 2)
    finally:
        rm.stop()
    pm = _port_manager(spill_dir=str(tmp_path / "sharded"))
    try:
        assert pm.store.contains(30)
        ph = pm.register_shuffle(30, D, modulo_partitioner(D, key_word=1))
        pm.resume_shuffle(ph)
        got = _port_read(pm, ph)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
    finally:
        pm.stop()


@pytest.mark.parametrize("codec", ["", "zlib"])
def test_reference_loads_port_checkpoint(tmp_path, ref, codec):
    root = str(tmp_path / "ck")
    pm = _port_manager(spill_to_host=True, spill_dir=root, compression=codec)
    x = _rows(7)
    try:
        h = pm.register_shuffle(4, D, modulo_partitioner(D, key_word=1))
        plan = pm.get_writer(h).write(pm.runtime.shard_records(x)).stop()
        want = _port_read(pm, h)
    finally:
        pm.stop()
    recs, rplan, num_parts = ref[0](root, use_native=False).load(4)
    assert num_parts == D and recs.dtype == np.uint32
    assert recs.T.tolist() == x.tolist()
    assert np.array_equal(rplan.counts, plan.counts)
    assert (rplan.num_rounds, rplan.out_capacity, rplan.capacity,
            rplan.split_factor) == (plan.num_rounds, plan.out_capacity,
                                    plan.capacity, plan.split_factor)
    # and the reference's manager resumes it to the port's bits
    rm = _ref_manager(ref, spill_dir=root)
    try:
        rh = rm.register_shuffle(4, D, ref[5](D, key_word=1))
        rm.resume_shuffle(rh)
        got = _ref_read(rm, rh)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
    finally:
        rm.stop()


def test_port_load_round_trip(tmp_path, ref):
    mine = MapOutputStore(str(tmp_path))
    plan, _ = _plans(ref, 8, 2)
    recs = _records(9)
    mine.save(2, recs, plan, D)
    got, gplan, num_parts = mine.load(2)
    assert np.array_equal(got, recs) and num_parts == D
    assert np.array_equal(gplan.counts, plan.counts)
    assert gplan.split_factor == 2
    mine.save_shards(3, [(0, recs[:, :8])], plan, D, (4, 64), 0, 1)
    with pytest.raises(ValueError, match="sharded"):
        mine.load(3)
    with pytest.raises(KeyError):
        mine.load(4)


@pytest.mark.parametrize("how", ["incomplete", "torn", "truncated"])
def test_broken_sharded_checkpoint_refused_by_both(tmp_path, ref, how):
    """A marker missing (incomplete), a marker of another save (torn),
    or a meta.json cut short: both stores read it as absent."""
    plan, ref_plan = _plans(ref, 10)
    shard = _records(11, (4, 8))
    for name, store, p in (("port", MapOutputStore, plan),
                           ("ref", lambda r: ref[0](r, use_native=False),
                            ref_plan)):
        s = store(str(tmp_path / name))
        if how == "incomplete":
            s.save_shards(31, [(0, shard)], p, D, (4, 64), 0, 2)
        else:
            s.save_shards(31, [(0, shard)], p, D, (4, 64), 0, 1)
        d = tmp_path / name / "shuffle_31"
        if how == "torn":
            marker = json.loads((d / "proc0.json").read_text())
            marker["save_id"] = "0" * 16
            (d / "proc0.json").write_text(json.dumps(marker))
        elif how == "truncated":
            (d / "meta.json").write_text((d / "meta.json").read_text()[:20])
    for s in (MapOutputStore(str(tmp_path / "port")),
              ref[0](str(tmp_path / "ref"), use_native=False)):
        assert not s.contains(31)
        if how != "truncated":
            with pytest.raises(KeyError, match=how):
                s.load_meta(31)
    m = _port_manager(spill_dir=str(tmp_path / "port"))
    try:
        h = m.register_shuffle(31, D, modulo_partitioner(D, key_word=1))
        with pytest.raises(RuntimeError, match="no published map output"):
            m.get_reader(h).read()
    finally:
        m.stop()


def test_corrupt_port_checkpoint_refused_by_both(tmp_path, ref):
    """A flipped data byte in a port checkpoint: the reference's load
    fails its CRC check, and the port's resume raises
    ``UnrecoverableShuffleError``."""
    root = tmp_path / "ck"
    pm = _port_manager(spill_to_host=True, spill_dir=str(root))
    try:
        h = pm.register_shuffle(8, D, modulo_partitioner(D, key_word=1))
        pm.get_writer(h).write(pm.runtime.shard_records(_rows(12))).stop()
        blob = root / "shuffle_8" / "records.u32"
        raw = bytearray(blob.read_bytes())
        raw[16] ^= 0xFF
        blob.write_bytes(bytes(raw))
        with pytest.raises(OSError, match="CRC32"):
            ref[0](str(root), use_native=False).load(8)
        pm._writers.clear()
        with pytest.raises(UnrecoverableShuffleError,
                           match="checkpoint unreadable"):
            pm.get_reader(h).read()
    finally:
        pm.stop()


def test_resume_refuses_other_geometry(tmp_path, ref):
    root = str(tmp_path / "ck")
    pm = _port_manager(spill_to_host=True, spill_dir=root)
    try:
        h = pm.register_shuffle(6, D, modulo_partitioner(D, key_word=1))
        pm.get_writer(h).write(pm.runtime.shard_records(_rows(13))).stop()
    finally:
        pm.stop()
    pm = _port_manager(spill_dir=root)
    try:
        with pytest.raises(ValueError, match="num_parts"):
            pm.resume_shuffle(pm.register_shuffle(
                6, 2 * D, modulo_partitioner(2 * D, key_word=1)))
    finally:
        pm.stop()
    small = ShuffleManager(MeshRuntime(ShuffleConf(spill_dir=root), 4,
                                       device="cpu"))
    try:
        with pytest.raises(ValueError, match="8-device mesh"):
            small.resume_shuffle(small.register_shuffle(
                6, D, modulo_partitioner(D, key_word=1)))
    finally:
        small.stop()
