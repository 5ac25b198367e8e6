"""The pipelined host <-> device path (``api/pipeline.py``) and the
Dataset's payload and column methods: port vs reference on the CPU.

The same seeded keys and payloads load through the reference's
``Dataset.from_host_payloads`` / ``from_host_columns`` (on the forced
8-device CPU mesh) and the port's (8 partitions stacked on the CPU), in
chunks of 64 records: the device layout must be bit-equal to the
reference's (tolerance 0: uint32 words) with overlap on, with overlap
off and in one shot, and the decodes must give back the reference's
keys, payloads and columns.
"""

import threading

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.dataset import Dataset
from sparkrdma_tpu_torch.api.pipeline import HostPrefetcher, staging_pool
from sparkrdma_tpu_torch.api.serde import (BytesColumn, RowSchema,
                                           encode_bytes_rows, payload_words)
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.interop import records_from_torch

MAXB = 13
KW = 2
VW = payload_words(MAXB)
SCHEMA = [("u", "uint32"), ("i", "int64"), ("f", "float64"),
          ("b", ("bytes", 10))]


def _pair(val_words, **kw):
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    conf = dict(slot_records=256, key_words=KW, val_words=val_words,
                serde_chunk_records=64, **kw)
    return (RefManager(conf=RefConf(**conf)),
            ShuffleManager(MeshRuntime(ShuffleConf(**conf), 8,
                                       device="cpu")))


@pytest.fixture(scope="module")
def pairs():
    made = {"v1": _pair(VW), "cols": _pair(RowSchema(SCHEMA).payload_words)}
    yield made
    for rm, pm in made.values():
        rm.stop()
        pm.stop()


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.api import serde
    from sparkrdma_tpu.api.dataset import Dataset as RefDataset

    return RefDataset, serde


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=(n, KW), dtype=np.uint32)
    payloads = [rng.bytes(int(k)) for k in rng.integers(0, MAXB + 1, size=n)]
    return keys, payloads


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=(n, KW), dtype=np.uint32)
    keys[:, 0] = np.arange(n, dtype=np.uint32)       # distinct keys
    cols = {"u": rng.integers(0, 2**32, size=n, dtype=np.uint32),
            "i": rng.integers(-2**62, 2**62, size=n),
            "f": rng.standard_normal(n),
            "b": [rng.bytes(int(k)) for k in rng.integers(0, 11, size=n)]}
    return keys, cols


def _same_records(pds, rds):
    np.testing.assert_array_equal(records_from_torch(pds.records),
                                  np.asarray(rds.records))


@pytest.mark.parametrize("n,kw", [
    (1024, dict(overlap=True)),        # 16 chunks of 64 over 8 partitions
    (1024, dict(overlap=False)),
    (1024, dict(chunk_records=0)),     # one shot
    (1000, dict(overlap=True)),        # 125 per partition: ragged chunk
    (1000, dict(chunk_records=24, overlap=False)),
], ids=["overlap", "no_overlap", "single_shot", "ragged", "small_chunks"])
def test_payload_load_bit_equal(pairs, ref, n, kw):
    RefDataset, _ = ref
    rm, pm = pairs["v1"]
    keys, payloads = _corpus(n, n)
    rds = RefDataset.from_host_payloads(rm, keys, payloads, MAXB)
    pds = Dataset.from_host_payloads(pm, keys, payloads, MAXB, **kw)
    _same_records(pds, rds)
    assert torch.equal(pds.records, pm.runtime.shard_records(
        encode_bytes_rows(keys, payloads, MAXB)))
    assert staging_pool(False).stats()["outstanding"] == 0


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("schema", [False, True], ids=["v1", "bytes_only"])
def test_payload_unload_matches_reference(pairs, ref, overlap, schema):
    RefDataset, serde = ref
    rm, pm = pairs["v1"]
    keys, payloads = _corpus(7, 512)
    rsch = serde.RowSchema.bytes_only(MAXB) if schema else None
    psch = RowSchema.bytes_only(MAXB) if schema else None
    rds = RefDataset.from_host_payloads(rm, keys, payloads, MAXB,
                                        schema=rsch)
    pds = Dataset.from_host_payloads(pm, keys, payloads, MAXB, schema=psch)
    _same_records(pds, rds)
    rk, rp = rds.to_host_payloads(overlap=overlap)
    pk, pp = pds.to_host_payloads(overlap=overlap)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pk, keys)
    assert isinstance(pp, BytesColumn) == schema
    assert pp == list(rp) == payloads


@pytest.mark.parametrize("overlap", [True, False])
def test_columns_round_trip_matches_reference(pairs, ref, overlap):
    RefDataset, serde = ref
    rm, pm = pairs["cols"]
    keys, cols = _columns(8, 1000)
    rds = RefDataset.from_host_columns(rm, keys, cols,
                                       serde.RowSchema(SCHEMA),
                                       overlap=overlap)
    pds = Dataset.from_host_columns(pm, keys, cols, RowSchema(SCHEMA),
                                    overlap=overlap)
    _same_records(pds, rds)
    rk, rc = rds.to_host_columns(overlap=overlap)
    pk, pc = pds.to_host_columns(overlap=overlap)
    np.testing.assert_array_equal(pk, rk)
    for name in ("u", "i", "f"):
        np.testing.assert_array_equal(pc[name], rc[name])
        np.testing.assert_array_equal(pc[name], cols[name])
    assert pc["b"] == rc["b"].to_list() == cols["b"]


def test_select_through_an_exchange_matches_reference(pairs, ref):
    """A pending select rides the next exchange as ``keep_words``: the
    projected-away columns come back zero, the same words as the
    reference's; the schema survives a sort, an aggregator drops it."""
    RefDataset, serde = ref
    rm, pm = pairs["cols"]
    keys, cols = _columns(9, 512)
    rds = RefDataset.from_host_columns(rm, keys, cols,
                                       serde.RowSchema(SCHEMA))
    pds = Dataset.from_host_columns(pm, keys, cols, RowSchema(SCHEMA))
    rsel, psel = rds.select("i", "b").repartition(), \
        pds.select("i", "b").repartition()
    _same_records(psel, rsel)
    assert psel.projected == rsel.projected == ("i", "b")
    pk, pc = psel.to_host_columns()
    order = np.argsort(pk[:, 0])
    assert not pc["u"].any() and not pc["f"].any()
    np.testing.assert_array_equal(pc["i"][order], cols["i"])
    assert pds.sort_by_key().schema == RowSchema(SCHEMA)
    assert pds.reduce_by_key().schema is None
    with pytest.raises(ValueError, match="already projected away"):
        pds.select("i").select("u")


def test_filler_rows_dropped_on_decode(pairs):
    _, pm = pairs["v1"]
    keys, payloads = _corpus(10, 64)
    rows = encode_bytes_rows(keys, payloads, MAXB)
    filler = np.full((8, rows.shape[1]), 0xFFFFFFFF, np.uint32)
    padded = np.concatenate([rows[:32], filler[:4], rows[32:], filler[4:]])
    ds = Dataset(pm, pm.runtime.shard_records(padded))
    k, p = ds.to_host_payloads()
    assert len(p) == 64
    assert sorted(zip(map(tuple, k.tolist()), p)) == \
        sorted(zip(map(tuple, keys.tolist()), payloads))


def test_empty_batch_and_refusals(pairs):
    _, pm = pairs["v1"]
    ds = Dataset.from_host_payloads(pm, np.empty((0, KW), np.uint32), [],
                                    MAXB)
    k, p = ds.to_host_payloads()
    assert k.shape == (0, KW) and p == []
    with pytest.raises(ValueError, match="val_words"):
        Dataset.from_host_payloads(pm, np.zeros((8, KW), np.uint32),
                                   [b""] * 8, MAXB + 64)
    bad = np.zeros((8, KW), np.uint32)
    bad[3] = 0xFFFFFFFF
    with pytest.raises(ValueError, match="reserved"):
        Dataset.from_host_payloads(pm, bad, [b""] * 8, MAXB)
    with pytest.raises(ValueError, match="schema-carrying"):
        Dataset.from_host_rows(pm, np.zeros((8, KW + VW),
                                            np.uint32)).to_host_columns()


def test_failed_encode_releases_leases(pairs):
    """A payload that does not encode raises out of the producer thread,
    and every staging lease goes back to the pool."""
    _, pm = pairs["v1"]
    keys, payloads = _corpus(11, 1024)
    payloads[700] = b"x" * (MAXB + 1)
    with pytest.raises(ValueError, match="max_payload_bytes"):
        Dataset.from_host_payloads(pm, keys, payloads, MAXB)
    assert staging_pool(False).stats()["outstanding"] == 0


def test_host_prefetcher():
    pf = HostPrefetcher()
    try:
        gate = threading.Event()
        pf.submit("a", lambda: 1)
        pf.submit("a", lambda: 2)           # a key in flight stays
        assert pf.take("a") == 1
        assert pf.take("a") is None
        pf.submit("b", lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            pf.take("b")
        pf.submit("c", gate.wait)
        pf.submit("d", lambda: 4)
        pf.drain()
        gate.set()
        assert pf.take("d") is None
    finally:
        pf.close()
