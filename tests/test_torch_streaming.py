"""The streaming regime, port vs reference.

A plan with more rounds than ``max_rounds_in_flight`` streams them in
chunks of that many rounds, paced by ``queue_depth``. Both packages get
the same records (made with numpy from a seed) and must give the same
``out``, ``totals`` and ``incoming`` bit for bit (tolerance 0), and the
port's streaming read must equal its own fused read of the same records
(``max_rounds_in_flight`` above the plan's rounds). The reference runs
the ``"xla"`` transport on the forced 8-device CPU mesh: its transports
give the same bytes, and its ring kernel is slow in interpret mode. The
port sweeps its three transports. The dispatch and pacing counters
(``last_dispatches``, ``exchange.stream_chunks``,
``exchange.queue_blocks``) must equal the reference's.

Key-ordered reads are compared where both packages take the merge-path
sort (a power-of-two output capacity holding two runs), whose order is
unique; elsewhere the reference's key sort is unstable.
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
from sparkrdma_tpu.exchange.protocol import ShuffleExchange as RefExchange
from sparkrdma_tpu.obs.metrics import MetricsRegistry as RefMetrics
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner)
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

D = 8
COUNTERS = ("exchange.stream_chunks", "exchange.queue_blocks",
            "exchange.dispatches")
TRANSPORTS = [("xla", True), ("pallas_ring", True), ("pallas_ring", False)]


def _rows(seed, n=D * 96, distinct=40, floating=False):
    """Four-word rows: key word 1 Zipf over few ids (hot partitions, so
    some (source, destination) pairs need many 4-record rounds), word 0
    partly at or above 2^31, two payload words (uint32 or float32 bits:
    no NaN, no denormals)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, 1] = rng.zipf(1.3, size=n) % distinct
    rows[:, 0] = np.where(rows[:, 1] % 5 == 0, 0x80000001, 7)
    if floating:
        rows[:, 2:] = (rng.standard_normal((n, 2)) * 100).astype(
            np.float32).view(np.uint32)
    return rows


@pytest.fixture(scope="module")
def rows():
    return _rows(11)


@pytest.fixture(scope="module")
def ref_cache():
    """The reference's exchanges of this module, per geometry (each one
    compiles its programs)."""
    return {}


def _ref_exchange(cache, rows, f_in, queue_depth):
    """The reference's streaming exchange on the ``xla`` transport:
    ``(out, totals, incoming, last_dispatches, counters, rounds)``."""
    key = (f_in, queue_depth)
    if key not in cache:
        conf = RefConf(slot_records=4, max_rounds_in_flight=f_in,
                       queue_depth=queue_depth)
        rt = RefRuntime(conf, devices=jax.devices()[:D])
        reg = RefMetrics()
        ex = RefExchange(rt.mesh, rt.axis_name, conf, pool=rt.pool,
                         metrics=reg)
        recs = rt.shard_records(rows)
        part = ref_hash(D, 2)
        plan = ex.plan(recs, part, D)
        out, totals, incoming = ex.exchange(recs, part, plan, D)
        cache[key] = (np.asarray(out), np.asarray(totals),
                           np.asarray(incoming), ex.last_dispatches,
                           {c: reg.counter(c).value for c in COUNTERS},
                           plan.num_rounds)
        rt.stop()
    return cache[key]


def _port_exchange(rows, f_in, queue_depth, transport="xla", fused=True):
    conf = ShuffleConf(slot_records=4, max_rounds_in_flight=f_in,
                       queue_depth=queue_depth, transport=transport,
                       ring_fused=fused)
    rt = MeshRuntime(conf, D, device="cpu")
    reg = MetricsRegistry()
    ex = ShuffleExchange(rt, conf, metrics=reg, pool=rt.pool)
    recs = rt.shard_records(rows)
    part = hash_partitioner(D, 2)
    plan = ex.plan(recs, part, D)
    out, totals, incoming = ex.exchange(recs, part, plan, D)
    return (records_from_torch(out), totals.numpy(), incoming.numpy(),
            ex.last_dispatches, {c: reg.counter(c).value for c in COUNTERS},
            plan.num_rounds)


@pytest.mark.parametrize("transport,fused", TRANSPORTS)
@pytest.mark.parametrize("queue_depth", [1, 8])
@pytest.mark.parametrize("f_in", [1, 2, 4])
def test_streaming_matches_reference_and_fused(ref_cache, rows, f_in,
                                               queue_depth, transport,
                                               fused):
    want = _ref_exchange(ref_cache, rows, f_in, queue_depth)
    got = _port_exchange(rows, f_in, queue_depth, transport, fused)
    rounds = got[5]
    assert rounds == want[5] and rounds > 4          # every F streams
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == 1 + 2 * -(-rounds // f_in) + 1
    assert got[4] == want[4]
    assert got[4]["exchange.queue_blocks"] == max(
        0, -(-rounds // f_in) - queue_depth)
    fused_read = _port_exchange(rows, 64, queue_depth, transport, fused)
    assert fused_read[3] == 1
    for g, w in zip(fused_read[:3], got[:3]):
        np.testing.assert_array_equal(g, w)


def _managers(rows, part, **kw):
    """Both managers with the records written and planned; the port's
    plan must equal the reference's."""
    ref_conf = RefConf(collect_shuffle_read_stats=True, **kw)
    ref = RefManager(RefRuntime(ref_conf, devices=jax.devices()[:D]),
                     ref_conf)
    rh = ref.register_shuffle(5, D, part[0])
    ref_plan = ref.get_writer(rh).write(
        ref.runtime.shard_records(rows)).stop()
    port = ShuffleManager(MeshRuntime(ShuffleConf(**kw), D, device="cpu"))
    ph = port.register_shuffle(5, D, part[1])
    plan = port.get_writer(ph).write(port.runtime.shard_records(rows)).stop()
    np.testing.assert_array_equal(plan.counts, ref_plan.counts)
    assert (plan.num_rounds, plan.capacity, plan.out_capacity,
            plan.split_factor) == (ref_plan.num_rounds, ref_plan.capacity,
                                   ref_plan.out_capacity,
                                   ref_plan.split_factor)
    assert plan.num_rounds > kw.get("max_rounds_in_flight", 2)
    return (ref, rh), (port, ph), plan


def _same_read(r, p, ref_kw=None, **kw):
    (ref, rh), (port, ph) = r, p
    out_r, tot_r = ref.get_reader(rh, **dict(kw, **(ref_kw or {}))).read()
    out, totals = port.get_reader(ph, **kw).read()
    np.testing.assert_array_equal(totals.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))
    assert port._exchange.reference_wire_stats() == \
        ref._exchange.wire_stats()
    assert port._exchange.last_dispatches == ref._exchange.last_dispatches
    return out.clone(), totals.clone()


def _stop(*pairs):
    for m, _ in pairs:
        m.stop()


@pytest.mark.parametrize("floating", [False, True])
@pytest.mark.parametrize("combine", ["on", "off"])
def test_streaming_aggregator_matches_reference(floating, combine):
    """uint32 and float32 sums under streaming, map-side combine on and
    off: equal to the reference and to the port's fused read."""
    rows = _rows(12, floating=floating)
    r, p, _ = _managers(rows, (ref_hash(D, 2), hash_partitioner(D, 2)),
                        slot_records=4, max_rounds_in_flight=1,
                        map_side_combine=combine, transport="pallas_ring")
    out, totals = _same_read(r, p, aggregator="sum", float_payload=floating)
    port, ph = p
    fused = ShuffleManager(MeshRuntime(
        ShuffleConf(slot_records=4, max_rounds_in_flight=64,
                    map_side_combine=combine), D, device="cpu"))
    h = fused.register_shuffle(5, D, hash_partitioner(D, 2))
    fused.get_writer(h).write(fused.runtime.shard_records(rows)).stop()
    out_f, tot_f = fused.get_reader(h, aggregator="sum",
                                    float_payload=floating).read()
    assert (out_f == out).all() and (tot_f == totals).all()
    _stop(r, p, (fused, h))


def _ref_filter(rec):
    return rec[1] % 3 != 0


_ref_filter.cache_key = "key1-mod3"


def _filter(rec):
    return as_unsigned(rec[1]) % 3 != 0


@pytest.mark.parametrize("aggregator", [None, "sum"])
def test_streaming_filter_projection_matches_reference(aggregator):
    rows = _rows(13)
    r, p, _ = _managers(rows, (ref_hash(D, 2), hash_partitioner(D, 2)),
                        slot_records=4, max_rounds_in_flight=2,
                        map_side_combine="on", transport="pallas_ring")
    out, _ = _same_read(r, p, dict(row_filter=_ref_filter),
                        aggregator=aggregator, row_filter=_filter,
                        keep_words=(0, 1, 2))
    assert not out[3].any()
    _stop(r, p)


@pytest.mark.parametrize("read", [dict(), dict(aggregator="sum"),
                                  dict(start_partition=2, end_partition=5),
                                  dict(start_partition=3, end_partition=4,
                                       aggregator="sum")],
                         ids=["plain", "sum", "range", "range-sum"])
def test_streaming_skew_split_matches_reference(read):
    """Half the records on partition 3: past ``max_rounds`` at 4-record
    slots, so the plan splits it 2-way (``ppd`` = 2) and still streams
    (fold offsets over (q, s, r) with two local partitions)."""
    rng = np.random.default_rng(14)
    rows = _rows(14, n=D * 48)
    hot = rng.random(len(rows)) < 0.5
    rows[:, 1] = np.where(hot, 3 + 8 * rng.integers(0, 6, len(rows)),
                          rows[:, 1])
    r, p, plan = _managers(rows, (ref_modulo(D, 1), modulo_partitioner(D, 1)),
                           slot_records=4, max_rounds=5,
                           max_rounds_in_flight=1, transport="pallas_ring",
                           map_side_combine="on")
    assert plan.split_factor == 2
    _same_read(r, p, **read)
    _stop(r, p)


def test_streaming_key_ordered_merge_path_matches_reference(monkeypatch):
    """A key-ordered streaming read whose tail takes the merge-path sort:
    an output capacity of 256 holds two runs of 128."""
    from sparkrdma_tpu_torch.exchange import protocol
    from sparkrdma_tpu_torch.kernels import merge_sort

    seen = []

    def spy(cols, valid=None, run=1 << 15, n_valid=None):
        seen.append(cols.shape[1])
        return merge_sort.merge_sort_cols(cols, valid, run, n_valid)

    monkeypatch.setattr(protocol, "merge_sort_cols", spy)
    rng = np.random.default_rng(15)
    rows = rng.integers(0, 2**32, size=(D * 160, 4), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    r, p, plan = _managers(rows, (ref_hash(D, 2), hash_partitioner(D, 2)),
                           slot_records=16, max_rounds_in_flight=1,
                           fast_sort=True, fast_sort_run=128,
                           transport="pallas_ring")
    assert plan.out_capacity == 256
    assert r[0]._exchange._uses_fast_sort(256, 2, "")
    _same_read(r, p, key_ordering=True)
    assert seen == [256] * D
    _stop(r, p)
