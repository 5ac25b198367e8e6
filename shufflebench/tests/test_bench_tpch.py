"""The TPC-H Q18 cell's distributions (``gen/tpch_orderkey.py``,
``gen/tpch_quantity.py``) against TPC-H §4.2.3, and its per-layer
reader (``metrics/reduce_fold.py``)."""

import pytest
import torch

from shufflebench import registry

ORDERKEY = registry._load(registry.HERE / "gen" / "tpch_orderkey.py")
SPEC = registry.mix("groupby_orderkey")["keys"][0]
PARAMS = {k: v for k, v in SPEC.items() if k not in ("words", "dist")}
N = 1 << 20


def _words(n, seed):
    return registry.generator("tpch_orderkey")(
        n, 2, torch.Generator().manual_seed(seed), "cpu", **PARAMS)


def _key(words):
    """The int64 ``l_orderkey`` of key words (high word first)."""
    return (words[0].to(torch.int64) << 32) | (words[1].to(torch.int64)
                                               & 0xFFFFFFFF)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, 2 ** 33 + 1])
def test_orderkey_lines(seed):
    words = _words(N, seed)
    assert words.shape == (2, N) and words.dtype == torch.int32
    key = _key(words)
    # sparse keys: the first 8 of every 32
    assert bool(((key & 31) < 8).all())
    uniq, mult = torch.unique(key, return_counts=True)
    assert 1 <= int(mult.min()) and int(mult.max()) <= 7
    assert abs(N / uniq.numel() - 4) < 0.05
    # a contiguous run of orders: back from key to order index
    order = ((uniq >> 5) << 3) | (uniq & 7)
    assert int(order[-1] - order[0]) + 1 == uniq.numel()
    assert 1 <= int(order[0]) and int(order[-1]) <= 1_500_000_000


@pytest.mark.parametrize("n", [N, 1000, 4099])
def test_lines_in_ship_date_order(n):
    order, day = ORDERKEY.lines(n, torch.Generator().manual_seed(n), "cpu",
                                **PARAMS)
    assert order.shape == day.shape == (n,)
    step = day[1:].to(torch.int32) - day[:-1]
    assert bool((step >= 0).all())
    # stable: within a day, in generation order (ascending orders)
    assert bool((order[1:][step == 0] >= order[:-1][step == 0]).all())
    # an order's lines ship 1-121 days after its date: within 120 days of
    # each other, and inside the spec's 2,406 + 121 days
    o = (order - order.min()).to(torch.int64)
    lo = torch.full((int(o.max()) + 1,), 1 << 14, dtype=torch.int32)
    hi = torch.zeros_like(lo)
    lo.scatter_reduce_(0, o, day.to(torch.int32), "amin")
    hi.scatter_reduce_(0, o, day.to(torch.int32), "amax")
    assert int((hi - lo).max()) <= 120
    assert 1 <= int(day[0]) and int(day[-1]) <= 2405 + 121


def test_high_words_zero_and_one_across_offsets():
    seen = set()
    for seed in range(40):
        words = _words(1 << 12, seed)
        seen |= set(words[0].tolist())
    assert seen == {0, 1}


def test_quantities_are_decimal_units():
    q = registry.generator("tpch_quantity")(
        N, 1, torch.Generator().manual_seed(3), "cpu")
    assert q.shape == (1, N) and q.dtype == torch.int32
    assert bool((q % 100 == 0).all())
    assert int(q.min()) == 100 and int(q.max()) == 5000
    assert abs(float(q.double().mean()) - 2550) < 10


def test_reduce_fold_reader():
    read = registry.metric_reader("reduce_fold")

    def job(wire):
        return {"wire": wire}

    run = {"jobs": [job({"reduce_in_records": 400, "reduce_out_records": 100}),
                    job({"reduce_in_records": 500, "reduce_out_records": 100}),
                    job({"reduce_in_records": 40000,
                         "reduce_out_records": 1000}),
                    # the one-partition fold, all on the map side
                    job({"reduce_in_records": 0, "reduce_out_records": 0})]}
    assert read(run) == 5.0
    # a program without the keys (the parent's), or no aggregator read
    assert read({"jobs": [job({"combine_dup_ratio": 0.02}), job({})]}) is None
    assert read({"jobs": []}) is None
