"""The reference's pack and wide sort modes against the port's one sort.

The reference moves a sort's records three ways (``sort_mode``: u64
packing, key+index sort with a gather, or riding every word); the port
has one stable key sort plus one gather and no mode parameter. Each of
the reference's mode functions gets the same numpy inputs as the port's
one sort and must give the same bits (tolerance 0) wherever the
reference's sort is stable; the reference's unstable pack sort
(``stable=False``) is held on distinct keys. Then whole reads at W = 25
(100-byte records): with the default thresholds, which select the pack
mode everywhere, through both managers; and under each of the
reference's three threshold settings, where the port's reads must not
change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
from sparkrdma_tpu.exchange.partitioners import hash_partitioner as ref_hash
from sparkrdma_tpu.kernels import aggregate as ref_agg
from sparkrdma_tpu.kernels import bucketing as ref_bucket
from sparkrdma_tpu.kernels import sort as ref_sort
from sparkrdma_tpu.kernels import wide_sort as ref_wide
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.dataset import Dataset
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels import aggregate as port_agg
from sparkrdma_tpu_torch.kernels import bucketing as port_bucket
from sparkrdma_tpu_torch.kernels import sort as port_sort

MODES = [dict(), dict(wide=True, ride_words=3), dict(wide=True,
                                                     ride_words=40),
         dict(pack=True)]
MODE_IDS = ["plain", "wide-ride3", "wide-ride40", "pack"]


def _cols(rng, w, n, distinct=None):
    """uint32 ``[w, n]``; with ``distinct`` the two key words take few
    values (many ties), some at or above 2^31."""
    x = rng.integers(0, 2**32, size=(w, n), dtype=np.uint64).astype(np.uint32)
    if distinct:
        x[0] = np.where(rng.random(n) < 0.5, 0x80000003, 5)
        x[1] = rng.integers(0, distinct, n)
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t):
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("w,n", [(4, 300), (25, 257)])
def test_bucket_records_modes(rng, mode, w, n):
    x = _cols(rng, w, n)
    pids = rng.integers(0, 8, n).astype(np.int32)
    want = ref_bucket.bucket_records(jnp.asarray(x), jnp.asarray(pids), 8,
                                     **mode)
    got = port_bucket.bucket_records(_t(x), torch.from_numpy(pids), 8)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("op,floating", [("sum", False), ("max", False),
                                         ("sum", True)])
def test_combine_by_key_modes(rng, mode, op, floating):
    x = _cols(rng, 25, 300, distinct=12)
    if floating:
        x[2:] = (rng.standard_normal((23, 300)) * 50).astype(
            np.float32).view(np.uint32)
    valid = rng.random(300) < 0.8
    want, wn = ref_agg.combine_by_key_cols(
        jnp.asarray(x), jnp.asarray(valid), 2, op, floating, **mode)
    got, n = port_agg.combine_by_key_cols(_t(x), torch.from_numpy(valid), 2,
                                          op, floating)
    assert n == int(wn)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_map_side_combine_modes(rng, mode):
    x = _cols(rng, 25, 256, distinct=10)
    pids = rng.integers(0, 9, 256).astype(np.int32)  # 8 = dropped rows
    want = ref_agg.map_side_combine_cols(jnp.asarray(x), jnp.asarray(pids),
                                         8, 2, "sum", **mode)
    got = port_agg.map_side_combine_cols(_t(x), torch.from_numpy(pids), 8,
                                         2, "sum")
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


@pytest.mark.parametrize("mode", ["plain", "wide", "pack"])
def test_sort_by_lead_modes(rng, mode):
    x = _cols(rng, 25, 300)
    lead = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    lead[::3] = lead[1::3][:100]                       # ties
    want = ref_sort.sort_by_lead_cols(jnp.asarray(x), jnp.asarray(lead),
                                      mode)
    got = port_sort.sort_by_lead_cols(_t(x), _t(lead))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    sl = port_sort.sort_by_lead_cols(_t(lead)[None], _t(lead))[0]
    wl, wc = ref_sort.packed_partition_cols(jnp.asarray(x),
                                            jnp.asarray(lead))
    np.testing.assert_array_equal(_np(sl), np.asarray(wl))
    np.testing.assert_array_equal(_np(got), np.asarray(wc))


@pytest.mark.parametrize("key_words", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_packed_lexsort_stable(rng, key_words, masked):
    x = _cols(rng, 24, 300, distinct=7)
    valid = rng.random(300) < 0.7 if masked else None
    want = ref_sort.packed_lexsort_cols(
        jnp.asarray(x), key_words,
        None if valid is None else jnp.asarray(valid), stable=True)
    got = port_sort.lexsort_cols(
        _t(x), key_words, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_packed_lexsort_unstable_on_distinct_keys(rng):
    """``stable=False`` (the reference's default tail): on distinct keys
    every sort gives the same order."""
    x = _cols(rng, 25, 300)
    want = ref_sort.packed_lexsort_cols(jnp.asarray(x), 2, stable=False)
    got = port_sort.lexsort_cols(_t(x), 2)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("ride", [0, 10, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_sort_wide_cols(rng, ride, masked):
    x = _cols(rng, 25, 300, distinct=9)
    valid = rng.random(300) < 0.6 if masked else None
    want = ref_wide.sort_wide_cols(
        jnp.asarray(x), 2, None if valid is None else jnp.asarray(valid),
        ride_words=ride)
    got = port_sort.lexsort_cols(
        _t(x), 2, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("key_words", [1, 2])
def test_sort_perm(rng, key_words):
    """The reference's key+index sort: its sorted keys and permutation
    are the key words and a riding row-index word after the port's one
    stable sort."""
    x = _cols(rng, 6, 300, distinct=9)
    valid = rng.random(300) < 0.6
    wk, wp = ref_wide.sort_perm(jnp.asarray(x), key_words,
                                jnp.asarray(valid))
    idx = torch.arange(300, dtype=torch.int32)[None]
    got = port_sort.lexsort_cols(torch.cat([_t(x[:key_words]), idx]),
                                 key_words, torch.from_numpy(valid))
    np.testing.assert_array_equal(got[key_words].numpy(), np.asarray(wp))
    np.testing.assert_array_equal(_np(got[:key_words]), np.asarray(wk))


@pytest.mark.parametrize("read", [dict(), dict(aggregator="sum"),
                                  dict(key_ordering=True)],
                         ids=["plain", "sum", "key_ordering"])
@pytest.mark.parametrize("slot", [4096, 8], ids=["fused", "streaming"])
def test_default_geometry_read_w25(rng, read, slot):
    """100-byte records with every sort-mode knob at its default (pack):
    a read through both managers is bit-identical. The key-ordered read
    uses the merge-path geometry (``fast_sort``, a 256-record output
    capacity holding two 128-record runs), where the order is unique."""
    rows = _cols(rng.__class__(np.random.PCG64(21)), 25, 8 * 160).T.copy()
    rows[:, 1] %= 200                                  # repeated keys
    kw = dict(val_words=23, slot_records=slot, fast_sort=True,
              fast_sort_run=128)
    ref_conf = RefConf(**kw)
    ref = RefManager(RefRuntime(ref_conf, devices=jax.devices()[:8]),
                     ref_conf)
    port = ShuffleManager(MeshRuntime(ShuffleConf(**kw), 8, device="cpu"))
    outs = []
    for m, part in ((ref, ref_hash(8, 2)), (port, hash_partitioner(8, 2))):
        assert m._exchange.sort_mode(25) == "pack"
        h = m.register_shuffle(3, 8, part)
        plan = m.get_writer(h).write(m.runtime.shard_records(rows)).stop()
        assert plan.out_capacity == 256
        assert (plan.num_rounds > 2) == (slot == 8)
        out, totals = m.get_reader(h, **read).read()
        outs.append((np.asarray(out) if m is ref else records_from_torch(out),
                     np.asarray(totals)))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    ref.stop()
    port.stop()


KNOBS = {"plain": dict(pack_sort_min_payload=0, wide_sort_min_payload=0),
         "wide": dict(pack_sort_min_payload=0),
         "pack": dict()}


def _knob_read(knobs, read, rows):
    """One read of ``rows`` (W = 25, 8 stacked partitions, on the CPU)
    under the sort-mode ``knobs``: ``(the exchange's sort_mode(25), the
    read's outputs as numpy arrays)``."""
    m = ShuffleManager(MeshRuntime(ShuffleConf(val_words=23, **knobs), 8,
                                   device="cpu"))
    try:
        mode = m._exchange.sort_mode(25)
        if read in ("key_ordering", "sum"):
            h = m.register_shuffle(5, 8, hash_partitioner(8, 2))
            m.get_writer(h).write(m.runtime.shard_records(rows)).stop()
            kw = (dict(key_ordering=True) if read == "key_ordering"
                  else dict(aggregator="sum"))
            out, totals = m.get_reader(h, **kw).read()
            return mode, (records_from_torch(out), totals.numpy())
        ds = Dataset.from_host_rows(m, rows)
        if read == "group_by_key":
            g = ds.group_by_key()
            return mode, (records_from_torch(g.values),
                          records_from_torch(g.groups), g.group_totals,
                          g.totals)
        d = ds.distinct()
        return mode, (records_from_torch(d.records), d.totals.numpy())
    finally:
        m.stop()


@pytest.mark.parametrize("read", ["key_ordering", "sum", "group_by_key",
                                  "distinct"])
@pytest.mark.parametrize("label", list(KNOBS))
def test_sort_mode_knobs_change_no_read(label, read):
    """The reference's three threshold settings select its three sort
    strategies; the port reports the reference's label and gives the
    bytes of its plain-mode read under each, outside the merge-path
    geometry (``fast_sort`` off), with repeated keys and whole repeated
    rows."""
    rng = np.random.default_rng(25)
    rows = _cols(rng, 25, 8 * 160).T.copy()
    rows[:, 0] %= 3
    rows[:, 1] %= 40                                   # repeated keys
    rows[1::4] = rows[0::4]                            # repeated rows
    mode, got = _knob_read(KNOBS[label], read, rows)
    assert mode == label
    _, want = _knob_read(KNOBS["plain"], read, rows)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
