"""TPC-H Q18's ``GROUP BY l_orderkey`` (``shufflebench``'s ``tpch_q18``
configuration under its ``groupby_orderkey`` mix) through the port's SPI
on the CPU: register, ``write(...).stop()``, ``get_reader(h,
aggregator="sum").read()`` with the configuration's conf, on the mix's
lines of ``lineitem`` in ship-date order.

Each read is compared row for row with the benchmark's plain reference
(``shufflebench/checks/reduce_sum.py``) and bit for bit with the JAX
package's read of the same lines, and its reduce-side combine counters
(``exchange.reduce_combine_{in,out}_records``, ``wire_stats()``'s
``reduce_{in,out}_records``) with the lines folded and the distinct keys.

The combine gate samples the first 1024 lines of partition 0. At a few
hundred thousand lines those span weeks of ship days, over which an
order's lines meet, and the gate turns the map-side combine on; from
about 2^20 lines on they span days and it declines, as at the cell's
size (2^27). Both sides are read here.
"""

import numpy as np
import pytest
import torch

from shufflebench import registry
from shufflebench.cell import make_words
from shufflebench.checks import reduce_sum
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.interop import records_from_torch

BENCH = registry.benchmark()
CONFIG = registry.config(BENCH, "tpch_q18")
MIX = registry.mix("groupby_orderkey")
PARTS = CONFIG["partitions"]
KW = CONFIG["key_words"]


def _lines(n, seed):
    """The cell's records ``int32[3, n]``: the mix's keys, the
    configuration's payload."""
    return torch.cat([make_words(MIX["keys"], n, seed, "cpu"),
                      make_words(CONFIG["payload"], n, seed + 1, "cpu")])


def _port_read(records):
    """The port's read of ``records`` with the configuration's conf;
    returns ``(out, totals, wire_stats, counters)``."""
    conf = ShuffleConf(key_words=KW, val_words=CONFIG["val_words"],
                       **CONFIG["conf"])
    m = ShuffleManager(MeshRuntime(conf, num_partitions=PARTS, device="cpu"))
    try:
        h = m.register_shuffle(0, PARTS, hash_partitioner(PARTS, KW))
        m.get_writer(h).write(records).stop()
        out, totals = m.get_reader(h, **MIX["reader"]).read()
        names = ("combine.gate_on", "combine.gate_off",
                 "exchange.reduce_combine_in_records",
                 "exchange.reduce_combine_out_records")
        counters = {k: m.metrics.counter(k).value for k in names}
        return out.clone(), totals.clone(), dict(m.wire_stats()), counters
    finally:
        m.stop()


def _rows(out, totals):
    """Every partition's valid rows, one after another."""
    oc = out.shape[1] // PARTS
    return torch.cat([out[:, p * oc:p * oc + int(t)]
                      for p, t in enumerate(totals.tolist())], dim=1)


@pytest.fixture(scope="module")
def jax_read():
    """The JAX package's read of the same host rows, with the
    configuration's conf."""
    import jax

    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.exchange.partitioners import \
        hash_partitioner as ref_hash

    def read(rows):
        conf = RefConf(key_words=KW, val_words=CONFIG["val_words"],
                       collect_shuffle_read_stats=True,
                       **CONFIG["conf"])
        ref = RefManager(RefRuntime(conf, devices=jax.devices()[:PARTS]),
                         conf)
        try:
            h = ref.register_shuffle(0, PARTS, ref_hash(PARTS, KW))
            ref.get_writer(h).write(ref.runtime.shard_records(rows)).stop()
            out, totals = ref.get_reader(h, **MIX["reader"]).read()
            gate = {k: ref.metrics.counter(k).value
                    for k in ("combine.gate_on", "combine.gate_off")}
            return (np.asarray(out), np.asarray(totals),
                    dict(ref._exchange.wire_stats()), gate)
        finally:
            ref.stop()

    return read


def _same_as_references(records, jax_read):
    """The port's read equals the plain reference's row for row and the
    JAX package's bit for bit; returns the port's wire stats, counters
    and the reference's distinct keys."""
    out, totals, wire, counters = _port_read(records)
    got = reduce_sum.compare(records, _rows(out, totals), totals.tolist(),
                             PARTS, KW)
    assert got == {"count_mismatch": 0, "rows_mismatched": 0}
    r_out, r_tot, r_wire, r_gate = jax_read(
        records.T.contiguous().numpy().view(np.uint32))
    np.testing.assert_array_equal(totals.numpy(), r_tot)
    np.testing.assert_array_equal(records_from_torch(out), r_out)
    assert {k: wire[k] for k in r_wire} == r_wire
    assert set(wire) - set(r_wire) == {"reduce_in_records",
                                       "reduce_out_records"}
    assert {k: counters[k] for k in r_gate} == r_gate
    keys = reduce_sum.read(records, PARTS, KW, KW)[0].shape[1]
    return wire, counters, keys


@pytest.mark.parametrize("n,seed", [(1 << 16, 2 ** 31 + 3),
                                    (1 << 17, 2 ** 33 + 9),
                                    (1 << 18, 5)])
def test_read_matches_references(jax_read, n, seed):
    records = _lines(n, seed)
    wire, counters, keys = _same_as_references(records, jax_read)
    # a few hundred thousand lines: the sampled head spans weeks and the
    # gate combines on the map side; the tail folds what arrives
    assert wire["combine_dup_ratio"] >= 0.25
    assert counters["combine.gate_on"] == 1
    assert wire["reduce_in_records"] == wire["combine_out_records"]
    assert wire["reduce_out_records"] == keys
    assert counters["exchange.reduce_combine_in_records"] == \
        wire["reduce_in_records"]
    assert counters["exchange.reduce_combine_out_records"] == keys


@pytest.mark.parametrize("seed", [2 ** 31 + 17])
def test_gate_declines_at_ship_date_scale(jax_read, seed):
    n = 1 << 21
    records = _lines(n, seed)
    wire, counters, keys = _same_as_references(records, jax_read)
    assert wire["combine_dup_ratio"] < 0.25
    assert counters["combine.gate_off"] == 1
    assert "combine_in_records" not in wire
    # every line crosses at full width and the tail folds them all
    assert wire["reduce_in_records"] == n
    assert counters["exchange.reduce_combine_in_records"] == n
    assert wire["reduce_out_records"] == keys
    assert counters["exchange.reduce_combine_out_records"] == keys
    assert 3.9 < n / keys < 4.1
