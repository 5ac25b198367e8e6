"""The ``Dataset`` verbs and ``run_repartition``: port vs reference on the
CPU.

The same seeded host rows load into ``sparkrdma_tpu.api.dataset.Dataset``
(on the forced 8-device CPU mesh) and into the port's (8 partitions
stacked on the CPU), and every verb's output is held bit-equal per
partition: the padded columnar records and the per-partition totals
(tolerance 0: integer words; float sums too, since the port mirrors the
reference's scan tree). Join sums of payload products are float32
prefix sums, held to rtol 1e-6 (the reference's own check).

``sort_by_key`` draws its splitter sample with ``jax.random`` in the
reference and a seeded ``torch.Generator`` in the port; the parity test
hands the port the reference's sample, so both range-partition alike.
Keys there are distinct, because the reference's key-ordered tail is
unstable at the default configuration (ROADMAP C.1.1).
"""

import itertools

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api import dataset as dataset_mod
from sparkrdma_tpu_torch.api.dataset import Dataset
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.meta.map_output import DuplicateShuffleIdError
from sparkrdma_tpu_torch.workloads.repartition import run_repartition

RTOL = 1e-6


def _pair(**kw):
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    rm = RefManager(conf=RefConf(slot_records=256, **kw))
    pm = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=256, **kw), 8,
                                    device="cpu"))
    return rm, pm


@pytest.fixture(scope="module")
def pairs():
    made = {"w4": _pair(), "w25": _pair(val_words=23)}
    yield made
    for rm, pm in made.values():
        rm.stop()
        pm.stop()


@pytest.fixture(scope="module")
def RefDataset():
    from sparkrdma_tpu.api.dataset import Dataset as RefDataset

    return RefDataset


def _load(RefDataset, pair, rows):
    rm, pm = pair
    return (RefDataset.from_host_rows(rm, rows),
            Dataset.from_host_rows(pm, rows))


def _same(rds, pds):
    np.testing.assert_array_equal(records_from_torch(pds.records),
                                  np.asarray(rds.records))
    assert pds.totals.tolist() == np.asarray(rds.totals).tolist()


def _rows(seed, w, n=8 * 96, key_range=24, pay_range=2**32):
    """Keys ``(0..2, 0..key_range)`` with duplicates; payload words drawn
    from ``[0, pay_range)``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, pay_range, size=(n, w), dtype=np.uint32)
    x[:, 0] = rng.integers(0, 3, size=n)
    x[:, 1] = rng.integers(0, key_range, size=n)
    return x


def _distinct_keys(seed, w, n=8 * 96):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    x[:, 0] = rng.permutation(n).astype(np.uint32) * 7919 + 1
    return x


def _ref_samples(rds):
    """The reference's splitter sample of what its sort_by_key samples."""
    import jax

    from sparkrdma_tpu.meta.sampling import make_sampler

    m = rds.manager
    rt = m.runtime
    recs = rds._materialize_pending()._dense_records()
    return np.asarray(jax.device_get(make_sampler(
        rt.mesh, rt.axis_name, m.conf.key_words, 256)(recs)))


def _sort_both(rds, pds, monkeypatch):
    samples = _ref_samples(rds)
    monkeypatch.setattr(dataset_mod, "make_sampler",
                        lambda *a, **k: (lambda recs: samples))
    return rds.sort_by_key(), pds.sort_by_key()


W = pytest.mark.parametrize("w", ["w4", "w25"])


@pytest.mark.parametrize("w,num_parts", [("w4", None), ("w4", 16),
                                         ("w25", None)])
def test_repartition(pairs, RefDataset, w, num_parts):
    rm, pm = pairs[w]
    rds, pds = _load(RefDataset, pairs[w], _rows(1, rm.conf.record_words))
    _same(rds.repartition(num_parts), pds.repartition(num_parts))
    assert pds.count == rds.count == 8 * 96


@W
def test_sort_by_key(pairs, RefDataset, w, monkeypatch):
    rm, _ = pairs[w]
    rds, pds = _load(RefDataset, pairs[w],
                     _distinct_keys(2, rm.conf.record_words))
    rs, ps = _sort_both(rds, pds, monkeypatch)
    _same(rs, ps)
    got = ps.to_host_rows()
    keys = got[:, 0].astype(np.uint64) << np.uint64(32) | got[:, 1]
    assert np.all(keys[1:] > keys[:-1])


@pytest.mark.parametrize("op,floating", [("sum", False), ("min", False),
                                         ("sum", True)])
def test_reduce_by_key(pairs, RefDataset, op, floating):
    x = _rows(3, 4, pay_range=1 << 20)
    if floating:
        x[:, 2:] = np.random.default_rng(3).standard_normal(
            (len(x), 2)).astype(np.float32).view(np.uint32)
    rds, pds = _load(RefDataset, pairs["w4"], x)
    _same(rds.reduce_by_key(op, float_payload=floating),
          pds.reduce_by_key(op, float_payload=floating))


@W
def test_distinct(pairs, RefDataset, w):
    rm, _ = pairs[w]
    x = _rows(4, rm.conf.record_words, pay_range=2)
    rds, pds = _load(RefDataset, pairs[w], x)
    rd, pd = rds.distinct(), pds.distinct()
    _same(rd, pd)
    assert pd.count == len(np.unique(x, axis=0))


@pytest.mark.parametrize("w", ["w4"])
def test_count_by_key(pairs, RefDataset, w):
    rm, _ = pairs[w]
    x = _rows(5, rm.conf.record_words)
    rds, pds = _load(RefDataset, pairs[w], x)
    rc, pc = rds.count_by_key(), pds.count_by_key()
    _same(rc, pc)
    keys, counts = np.unique(x[:, :2], axis=0, return_counts=True)
    got = pc.to_host_rows()
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    np.testing.assert_array_equal(got[:, :2], keys)
    np.testing.assert_array_equal(got[:, 2], counts)


@W
def test_group_by_key(pairs, RefDataset, w):
    rm, _ = pairs[w]
    rds, pds = _load(RefDataset, pairs[w], _rows(6, rm.conf.record_words))
    rg, pg = rds.group_by_key(), pds.group_by_key()
    np.testing.assert_array_equal(records_from_torch(pg.values),
                                  np.asarray(rg.values))
    np.testing.assert_array_equal(records_from_torch(pg.groups),
                                  np.asarray(rg.groups))
    assert pg.group_totals.tolist() == np.asarray(rg.group_totals).tolist()
    assert pg.totals.tolist() == np.asarray(rg.totals).tolist()
    ref_host, got_host = rg.to_host(), pg.to_host()
    assert sorted(got_host) == sorted(ref_host)
    for k in ref_host:
        np.testing.assert_array_equal(got_host[k], ref_host[k])


@pytest.mark.parametrize("w", ["w25"])
def test_cogroup(pairs, RefDataset, w):
    rm, pm = pairs[w]
    wds = rm.conf.record_words
    ra, pa = _load(RefDataset, pairs[w], _rows(7, wds))
    rb, pb = _load(RefDataset, pairs[w], _rows(8, wds, key_range=40))
    rc, pc = ra.cogroup(rb), pa.cogroup(pb)
    for name in ("values_a", "values_b", "cotable"):
        np.testing.assert_array_equal(records_from_torch(getattr(pc, name)),
                                      np.asarray(getattr(rc, name)))
    assert pc.union_totals.tolist() == np.asarray(rc.union_totals).tolist()
    with pytest.raises(ValueError, match="same manager"):
        pa.cogroup(Dataset(ShuffleManager(MeshRuntime(
            pm.conf, 8, device="cpu")), pb.records))


@W
def test_join_count_and_rows(pairs, RefDataset, w):
    rm, _ = pairs[w]
    wds = rm.conf.record_words
    xa, xb = _rows(9, wds, pay_range=1000), _rows(10, wds, pay_range=1000)
    xb[:, 0] = 5            # the join ignores the high key word
    ra, pa = _load(RefDataset, pairs[w], xa)
    rb, pb = _load(RefDataset, pairs[w], xb)
    rc, rs = ra.join_count(rb)
    pc, ps = pa.join_count(pb)
    assert pc == rc
    np.testing.assert_allclose(ps, rs, rtol=RTOL)
    rj, rt = ra.join(rb)
    pj, pt = pa.join(pb)
    np.testing.assert_array_equal(records_from_torch(pj), np.asarray(rj))
    assert pt.tolist() == np.asarray(rt).tolist()
    assert int(pt.sum()) == pc
    rows = Dataset.collect_rows(pj, pt)
    np.testing.assert_array_equal(rows, RefDataset.collect_rows(rj, rt))
    with pytest.raises(ValueError, match="overflow"):
        pa.join(pb, out_capacity=max(1, int(pt.max()) - 1))


def test_join_single_word_key(RefDataset):
    pair = _pair(key_words=1, val_words=3)
    try:
        xa, xb = _rows(11, 4), _rows(12, 4)
        ra, pa = _load(RefDataset, pair, xa)
        rb, pb = _load(RefDataset, pair, xb)
        assert pa.join_count(pb)[0] == ra.join_count(rb)[0]
        rj, rt = ra.join(rb)
        pj, pt = pa.join(pb)
        np.testing.assert_array_equal(records_from_torch(pj), np.asarray(rj))
    finally:
        for m in pair:
            m.stop()


def _odd(r):
    return (r[2] & 1) == 1


def _small_key(r):
    return r[1] < 12


def _port_small_key(r):
    return as_unsigned(r[1]) < 12


@pytest.mark.parametrize("w", ["w4"])
def test_filter_pushdown(pairs, RefDataset, w, monkeypatch):
    rm, pm = pairs[w]
    x = _rows(13, rm.conf.record_words)
    rds, pds = _load(RefDataset, pairs[w], x)
    rf = rds.filter(_odd, cache_key=("odd",))
    pf = pds.filter(_odd, cache_key=("odd",))
    # fused into the exchange: dropped rows never take a slot
    _same(rf.repartition(), pf.repartition())
    assert pm._exchange.wire_stats()["pushdown_rows_dropped"] == \
        int((x[:, 2] & 1 == 0).sum())
    # eager host exits, and a chained filter ANDs
    keep = (x[:, 2] & 1) == 1
    assert pf.count == rf.count == int(keep.sum())
    np.testing.assert_array_equal(pf.to_host_rows(), rf.to_host_rows())
    rff = rf.filter(_small_key)
    pff = pf.filter(_port_small_key)
    _same(rff.repartition(), pff.repartition())
    assert pff.count == int((keep & (x[:, 1] < 12)).sum())
    # verbs that cannot fuse it apply it first
    _same(rf.count_by_key(), pf.count_by_key())
    _same(rff.reduce_by_key(), pff.reduce_by_key())


def test_filter_then_sort(pairs, RefDataset, monkeypatch):
    x = _distinct_keys(14, 4)
    rds, pds = _load(RefDataset, pairs["w4"], x)
    rs, ps = _sort_both(rds.filter(_odd), pds.filter(_odd), monkeypatch)
    _same(rs, ps)
    assert ps.count == int(((x[:, 2] & 1) == 1).sum())


@pytest.mark.parametrize("w", ["w4"])
def test_chained_padded_verbs(pairs, RefDataset, w, monkeypatch):
    """Padded outputs re-densify (null-key filler) before the next
    exchange, partition by partition, as in the reference."""
    rm, _ = pairs[w]
    x = _rows(15, rm.conf.record_words, key_range=37)
    rds, pds = _load(RefDataset, pairs[w], x)
    r1, p1 = rds.reduce_by_key(), pds.reduce_by_key()
    np.testing.assert_array_equal(records_from_torch(p1._dense_records()),
                                  np.asarray(r1._dense_records()))
    r2, p2 = r1.repartition(16), p1.repartition(16)
    _same(r2, p2)
    _same(r2.distinct(), p2.distinct())
    r3, p3 = _sort_both(r2, p2, monkeypatch)
    _same(r3, p3)
    assert p3.count == r3.count == len(np.unique(x[:, :2], axis=0))


def test_dense_records_skewed_partitions(pairs, RefDataset):
    import jax.numpy as jnp

    rm, pm = pairs["w4"]
    x = _rows(16, 4)
    rds, pds = _load(RefDataset, pairs["w4"], x)
    totals = np.full((8,), 96, np.int32)
    totals[0] = 1
    totals[5] = 40
    rsk = type(rds)(rm, rds.records, jnp.asarray(totals))
    psk = Dataset(pm, pds.records, torch.from_numpy(totals))
    np.testing.assert_array_equal(psk.to_host_rows(), rsk.to_host_rows())
    _same(rsk.repartition(), psk.repartition())


def test_host_boundary(pairs, RefDataset):
    rm, pm = pairs["w4"]
    x = _rows(17, 4)
    rds, pds = _load(RefDataset, pairs["w4"], x)
    assert pds.content_digest == rds.content_digest
    np.testing.assert_array_equal(pds.to_host_rows(), x)
    bad = x.copy()
    bad[3, :2] = 0xFFFFFFFF
    with pytest.raises(ValueError, match="reserved all-ones"):
        Dataset.from_host_rows(pm, bad)


#: a schema of every kind whose payload is 6 words, and the byte bound
#: whose v1 slot is 6 words too
SCHEMA = [("a", "uint32"), ("b", "int64"), ("p", ("bytes", 6))]
MAXB = 20


@pytest.fixture(scope="module")
def schema_pair():
    rm, pm = _pair(val_words=6, serde_chunk_records=64)
    yield rm, pm
    rm.stop()
    pm.stop()


def _schema_data(seed, n=8 * 48):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, 3, size=n),
                     rng.permutation(n) + 1], axis=1).astype(np.uint32)
    cols = {"a": rng.integers(0, 2**32, size=n, dtype=np.uint32),
            "b": rng.integers(-2**62, 2**62, size=n),
            "p": [rng.bytes(int(k)) for k in rng.integers(0, 7, size=n)]}
    pays = [rng.bytes(int(k)) for k in rng.integers(0, MAXB + 1, size=n)]
    return keys, cols, pays


def _same_host(got, want):
    """Decoded ``(keys, payloads)`` or ``(keys, columns)`` equal."""
    np.testing.assert_array_equal(got[0], want[0])
    if isinstance(got[1], dict):
        assert set(got[1]) == set(want[1])
        for k, v in got[1].items():
            if k == "p":
                assert v == want[1][k].to_list()
            else:
                np.testing.assert_array_equal(v, want[1][k])
    else:
        assert list(got[1]) == list(want[1])


@pytest.mark.parametrize("method", [
    "select", "plan", "to_host_payloads", "to_host_columns",
    "from_host_payloads", "from_host_columns", "schema"])
def test_schema_and_payload_verbs_match_reference(schema_pair, RefDataset,
                                                  method):
    """The methods slice 6 left refusing, one case each, held against
    the reference on the same seeded keys, columns and payloads: the
    device records bit-equal, and the host decodes equal."""
    from sparkrdma_tpu.api.serde import RowSchema as RefSchema
    from sparkrdma_tpu.plan import PlanExecutor as RefExecutor

    from sparkrdma_tpu_torch.api.serde import RowSchema
    from sparkrdma_tpu_torch.plan import PlanExecutor

    rm, pm = schema_pair
    keys, cols, pays = _schema_data(20)
    rsch, psch = RefSchema(SCHEMA), RowSchema(SCHEMA)
    if method in ("from_host_payloads", "to_host_payloads"):
        rb, pb = RefSchema.bytes_only(MAXB), RowSchema.bytes_only(MAXB)
        rds = RefDataset.from_host_payloads(rm, keys, pays, MAXB)
        pds = Dataset.from_host_payloads(pm, keys, pays, MAXB)
        _same(rds, pds)
        rbs = RefDataset.from_host_payloads(rm, keys, pays, MAXB, schema=rb)
        pbs = Dataset.from_host_payloads(pm, keys, pays, MAXB, schema=pb)
        _same(rbs, pbs)
        if method == "to_host_payloads":
            got = pds.to_host_payloads()
            _same_host(got, rds.to_host_payloads())
            _same_host(pbs.to_host_payloads(overlap=False),
                       rbs.to_host_payloads(overlap=False))
            assert list(got[1]) == pays
        return
    rds = RefDataset.from_host_columns(rm, keys, cols, rsch)
    pds = Dataset.from_host_columns(pm, keys, cols, psch)
    _same(rds, pds)
    if method == "from_host_columns":
        assert pds.schema == psch
    elif method == "to_host_columns":
        _same_host(pds.to_host_columns(), rds.to_host_columns())
    elif method == "select":
        r2, p2 = rds.select("b").repartition(), pds.select("b").repartition()
        _same(r2, p2)
        _same_host(p2.to_host_columns(), r2.to_host_columns())
        _same_host(pds.select("a", "p").to_host_columns(),
                   rds.select("a", "p").to_host_columns())
    elif method == "plan":
        want = RefExecutor(rm).run(rds.plan("t").repartition().sink())
        got = PlanExecutor(pm).run(pds.plan("t").repartition().sink())
        np.testing.assert_array_equal(got, want)
    else:
        rows = pds.to_host_rows()
        r2 = RefDataset.from_host_rows(rm, rows, schema=rsch)
        p2 = Dataset.from_host_rows(pm, rows, schema=psch)
        _same(r2, p2)
        assert p2.content_digest == r2.content_digest
        _same_host(p2.to_host_columns(), r2.to_host_columns())
        with pytest.raises(ValueError, match="payload words"):
            Dataset.from_host_rows(pm, rows, schema=RowSchema.bytes_only(4))


def test_dataset_ids_skip_user_registered(pairs, monkeypatch):
    """A user-registered id in the Dataset range is skipped: the manager
    raises the dedicated error, a ValueError, and the draw moves on."""
    _, pm = pairs["w4"]
    base = 1 << 21
    pm.register_shuffle(base, 8, hash_partitioner(8, 2))
    with pytest.raises(DuplicateShuffleIdError):
        pm.register_shuffle(base, 8, hash_partitioner(8, 2))
    with pytest.raises(ValueError, match="already registered"):
        pm.register_shuffle(base, 8, hash_partitioner(8, 2))
    monkeypatch.setattr(dataset_mod, "_ID_COUNTER", itertools.count(base))
    try:
        x = _rows(19, 4, n=8 * 16)
        ds = Dataset.from_host_rows(pm, x).repartition()
        assert ds.count == x.shape[0]
        assert base in pm._registry.shuffle_ids()
        assert next(dataset_mod._ID_COUNTER) == base + 2
    finally:
        pm.unregister_shuffle(base)


@pytest.mark.parametrize("num_parts", [8, 16])
@pytest.mark.parametrize("val_words", [2, 0])
def test_run_repartition_matches_reference(num_parts, val_words):
    """``run_repartition`` at ``num_parts`` 8 and 16, at W = 4 and at
    W = 2 (no payload: ``BASELINE.md`` config 1's record): the totals,
    the verdict, and the raw read itself equal the reference's."""
    from sparkrdma_tpu.workloads import repartition as ref_mod

    rm, pm = _pair(val_words=val_words)
    try:
        ref = ref_mod.run_repartition(rm, 64, num_parts=num_parts,
                                      warmup=False, shuffle_id=20)
        got = run_repartition(pm, 64, num_parts=num_parts, warmup=False,
                              shuffle_id=20, device_verify=True)
        assert ref.verified and got.verified
        assert (got.records, got.record_bytes) == \
            (ref.records, ref.record_bytes) == (8 * 64, 4 * (2 + val_words))
        assert pm._registry.shuffle_ids() == ()
    finally:
        rm.stop()
        pm.stop()


@pytest.mark.parametrize("slot_records", [256, 4])
def test_val_words_zero_read_bit_equal(slot_records):
    """W = 2 through the fused regime and, with 4-record slots, the
    streaming one: the raw read equals the reference's."""
    from sparkrdma_tpu.exchange.partitioners import \
        hash_partitioner as ref_hash
    from sparkrdma_tpu.workloads.repartition import \
        generate_records as ref_gen

    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu_torch.workloads.repartition import generate_records

    kw = dict(slot_records=slot_records, val_words=0)
    rm = RefManager(conf=RefConf(**kw))
    pm = ShuffleManager(MeshRuntime(ShuffleConf(**kw), 8, device="cpu"))
    try:
        outs = []
        for m, gen, hp in ((rm, ref_gen, ref_hash),
                           (pm, generate_records, hash_partitioner)):
            h = m.register_shuffle(3, 16, hp(16, 2))
            m.get_writer(h).write(gen(m, 64, seed=4)).stop()
            out, totals = m.get_reader(h).read()
            outs.append((np.asarray(out) if m is rm
                         else records_from_torch(out),
                         np.asarray(totals).tolist()))
        assert outs[0][1] == outs[1][1]
        np.testing.assert_array_equal(outs[1][0], outs[0][0])
        assert (pm._exchange.last_dispatches > 1) == (slot_records == 4)
    finally:
        rm.stop()
        pm.stop()
