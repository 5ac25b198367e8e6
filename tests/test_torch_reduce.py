"""The aggregation slice through the SPI, port vs reference.

Both packages get the same records and run register -> write -> stop
(plan) -> ``get_reader(...).read()``: aggregator reads (uint32
``sum``/``min``/``max`` and float32 ``sum``) with the map-side combine
gate on, off and automatic, predicate and projection pushdown, and
partition-range reads with and without a skew-split plan. ``out``,
``totals`` and ``wire_stats()`` must be bit-identical (tolerance 0),
and so must the plans and the gate's counters. Float payloads hold no
NaN and no denormals.

The sizes keep every plan within ``max_rounds_in_flight`` (the
streaming regime is not ported), and the ranged key-ordered read at the
merge-path geometry (a power-of-two output capacity holding two runs),
where both packages take the merge-path sort, whose order is unique.
"""

import jax
import numpy as np
import pytest

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
from sparkrdma_tpu.exchange.partitioners import hash_partitioner as ref_hash
from sparkrdma_tpu.exchange.partitioners import \
    modulo_partitioner as ref_modulo
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner)
from sparkrdma_tpu_torch.interop import plan_from_reference, records_from_torch
from sparkrdma_tpu_torch.kernels.sort import as_unsigned

GATE = ("combine.gate_on", "combine.gate_off", "pushdown.filters",
        "pushdown.projections")


def _records(rng, n, distinct=24, floating=False):
    """Four-word rows: two key words (few distinct keys, some words at
    or above 2^31) and two payload words (uint32, or float32 bits)."""
    rows = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, 1] = rng.zipf(1.3, size=n) % distinct
    rows[:, 0] = np.where(rows[:, 1] % 5 == 0, 0x80000001, 7)
    if floating:
        rows[:, 2:] = (rng.standard_normal((n, 2)) * 100).astype(
            np.float32).view(np.uint32)
    return rows


def _ref_filter(r):
    return r[1] % 3 != 0


_ref_filter.cache_key = "key1-mod3"


def _filter(r):
    return as_unsigned(r[1]) % 3 != 0


def _pair(d, rows, part, **kw):
    """Both managers with the records written and planned (the
    reference's counters on)."""
    ref_conf = RefConf(collect_shuffle_read_stats=True, **kw)
    ref = RefManager(RefRuntime(ref_conf, devices=jax.devices()[:d]),
                     ref_conf)
    rh = ref.register_shuffle(5, d, part[0])
    ref_plan = ref.get_writer(rh).write(ref.runtime.shard_records(rows)).stop()
    port = ShuffleManager(MeshRuntime(ShuffleConf(**kw), num_partitions=d,
                                      device="cpu"))
    ph = port.register_shuffle(5, d, part[1])
    plan = port.get_writer(ph).write(port.runtime.shard_records(rows)).stop()
    want = plan_from_reference(ref_plan)
    np.testing.assert_array_equal(plan.counts, want.counts)
    assert (plan.num_rounds, plan.capacity, plan.out_capacity,
            plan.split_factor) == (want.num_rounds, want.capacity,
                                   want.out_capacity, want.split_factor)
    return (ref, rh), (port, ph), plan


def _check(pair_r, pair_p, ref_kw=None, **kw):
    """One read on each side; outputs, totals, wire stats and counters
    bit-identical."""
    (ref, rh), (port, ph) = pair_r, pair_p
    ref_kw = dict(kw, **(ref_kw or {}))
    out_r, tot_r = ref.get_reader(rh, **ref_kw).read()
    out, totals = port.get_reader(ph, **kw).read()
    np.testing.assert_array_equal(totals.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))
    assert port._exchange.reference_wire_stats() == \
        ref._exchange.wire_stats()
    for name in GATE:
        assert port.metrics.counter(name).value == \
            ref.metrics.counter(name).value, name
    return out, totals


def _stop(*managers):
    for m in managers:
        m.stop()


@pytest.mark.parametrize("d,slot", [(1, 1024), (8, 16)])
@pytest.mark.parametrize("transport", ["xla", "pallas_ring"])
@pytest.mark.parametrize("combine", ["on", "off", "auto"])
def test_reduce_by_key_matches_reference(rng, d, slot, transport, combine):
    rows = _records(rng, 8 * 75)
    r, p, _ = _pair(d, rows, (ref_hash(d, 2), hash_partitioner(d, 2)),
                    slot_records=slot, max_rounds_in_flight=8,
                    transport=transport, map_side_combine=combine)
    out, totals = _check(r, p, aggregator="sum")
    ws = p[0]._exchange.wire_stats()
    assert ("combine_in_records" in ws) == (
        combine == "on" or (combine == "auto" and
                            ws["combine_dup_ratio"] >= 0.25))
    assert int(totals.sum()) == len({(a, b) for a, b in rows[:, :2]})
    _stop(r[0], p[0])


@pytest.mark.parametrize("op,floating", [("min", False), ("max", False),
                                         ("sum", True), ("max", True)])
@pytest.mark.parametrize("d", [1, 8])
def test_aggregators_match_reference(rng, op, floating, d):
    rows = _records(rng, 8 * 75, floating=floating)
    r, p, _ = _pair(d, rows, (ref_hash(d, 2), hash_partitioner(d, 2)),
                    slot_records=1024 if d == 1 else 16,
                    max_rounds_in_flight=8, transport="pallas_ring",
                    map_side_combine="on")
    _check(r, p, aggregator=op, float_payload=floating)
    _stop(r[0], p[0])


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("aggregator,combine", [("sum", "on"),
                                                ("sum", "off"), (None, "on")])
@pytest.mark.parametrize("pushdown", ["filter", "project", "both"])
def test_pushdown_matches_reference(rng, d, aggregator, combine, pushdown):
    rows = _records(rng, 8 * 75)
    r, p, _ = _pair(d, rows, (ref_hash(d, 2), hash_partitioner(d, 2)),
                    slot_records=1024 if d == 1 else 16,
                    max_rounds_in_flight=8, transport="pallas_ring",
                    map_side_combine=combine)
    kw = {"aggregator": aggregator}
    ref_kw = {}
    if pushdown in ("filter", "both"):
        kw["row_filter"], ref_kw["row_filter"] = _filter, _ref_filter
    if pushdown in ("project", "both"):
        kw["keep_words"] = (0, 1, 2)
    out, totals = _check(r, p, ref_kw, **kw)
    if "keep_words" in kw:
        assert not out[3].any()
    ws = p[0]._exchange.wire_stats()
    if pushdown == "project":
        assert ws.get("pushdown_words_dropped", 0) > 0
    _stop(r[0], p[0])


@pytest.mark.parametrize("read", ["plain", "sum", "float-max"])
def test_ranged_read_matches_reference(rng, read):
    rows = _records(rng, 8 * 75, floating=read == "float-max")
    r, p, _ = _pair(8, rows, (ref_hash(8, 2), hash_partitioner(8, 2)),
                    slot_records=16, max_rounds_in_flight=8,
                    transport="pallas_ring", map_side_combine="on")
    kw = {"start_partition": 2, "end_partition": 5}
    if read != "plain":
        kw.update(aggregator=read.split("-")[-1],
                  float_payload=read == "float-max")
    out, totals = _check(r, p, **kw)
    t = totals.numpy()
    assert t[[0, 1, 5, 6, 7]].sum() == 0 and t[2:5].all()
    # the exchange ran without the map-side combine (a ranged read
    # slices the output by the plan's pre-combine counts)
    assert "combine_in_records" not in p[0]._exchange.wire_stats()
    _stop(r[0], p[0])


def _skewed(rng, n):
    """Half the records on partition 3: past ``max_rounds`` at 16-record
    slots, so the plan splits it (``split_factor`` 2)."""
    rows = _records(rng, n)
    hot = rng.random(n) < 0.5
    rows[:, 1] = np.where(hot, 3 + 8 * rng.integers(0, 6, n), rows[:, 1])
    return rows


@pytest.mark.parametrize("read,rng_range", [
    ("plain", (2, 5)), ("sum", (2, 5)), ("sum", (3, 4)), ("sort", (0, 4)),
    ("plain", (0, 8))])
def test_skew_split_ranged_read_matches_reference(rng, read, rng_range):
    rows = _skewed(rng, 8 * 64)
    r, p, plan = _pair(8, rows, (ref_modulo(8, 1), modulo_partitioner(8, 1)),
                       slot_records=16, max_rounds=2, fast_sort=True,
                       fast_sort_run=128, transport="pallas_ring",
                       map_side_combine="on")
    assert plan.split_factor == 2 and plan.out_capacity == 512
    kw = {"start_partition": rng_range[0], "end_partition": rng_range[1]}
    if read == "sum":
        kw["aggregator"] = "sum"
    if read == "sort":
        kw["key_ordering"] = True
    _check(r, p, **kw)
    _stop(r[0], p[0])


def test_ranged_key_ordering_at_merge_path_geometry(rng, monkeypatch):
    """A ranged key-ordered read sorts the kept prefix with the
    merge-path sort: an output capacity of 256 holds two runs of 128."""
    from sparkrdma_tpu_torch.exchange import protocol
    from sparkrdma_tpu_torch.kernels import merge_sort

    seen = []

    def spy(cols, valid=None, run=1 << 15, n_valid=None):
        seen.append((cols.shape[1], n_valid))
        return merge_sort.merge_sort_cols(cols, valid, run, n_valid)

    monkeypatch.setattr(protocol, "merge_sort_cols", spy)
    rows = rng.integers(0, 2**32, size=(8 * 160, 4), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    r, p, plan = _pair(8, rows, (ref_hash(8, 2), hash_partitioner(8, 2)),
                       slot_records=4096, fast_sort=True, fast_sort_run=128,
                       transport="pallas_ring")
    assert plan.out_capacity == 256
    _, totals = _check(r, p, start_partition=2, end_partition=5,
                       key_ordering=True)
    assert seen == [(256, int(t)) for t in totals.numpy()]
    _stop(r[0], p[0])


def test_combine_hint_skips_the_gate(rng):
    rows = _records(rng, 8 * 75)
    r, p, _ = _pair(8, rows, (ref_hash(8, 2), hash_partitioner(8, 2)),
                    slot_records=16, max_rounds_in_flight=8,
                    map_side_combine="off")
    _check(r, p, aggregator="sum", combine_hint=(True, 0.5))
    assert p[0]._exchange.wire_stats()["combine_dup_ratio"] == 0.5
    _stop(r[0], p[0])


def test_reader_validation():
    m = ShuffleManager(MeshRuntime(ShuffleConf(), 8, device="cpu"))
    h = m.register_shuffle(1, 8, hash_partitioner(8, 2))
    for kw, msg in ((dict(start_partition=3, end_partition=3),
                     "invalid partition range"),
                    (dict(aggregator="avg"), "unsupported aggregator"),
                    (dict(float_payload=True), "requires an aggregator"),
                    (dict(end_partition=4, row_filter=_filter),
                     "full partition range"),
                    (dict(end_partition=4, keep_words=(0, 1)),
                     "full partition range")):
        with pytest.raises(ValueError, match=msg):
            m.get_reader(h, **kw)
    recs = m.runtime.shard_records(np.zeros((64, 4), np.uint32))
    m.get_writer(h).write(recs).stop()
    for keep, msg in (((0, 2), "key words"), ((0, 1, 3, 2), "increasing"),
                      ((0, 1, 4), "out of range")):
        with pytest.raises(ValueError, match=msg):
            m.get_reader(h, keep_words=keep).read()
    m.stop()
