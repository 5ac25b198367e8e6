"""The sort by key of columnar records (``kernels/sort.py::lexsort_cols``)
and its two counters.

The CPU cases hold the plain route's received-prefix sort (``n``) and its
placement into a destination (``out``) against the masked sort and the
copy they replace, the kernel's rule for carrying records, and the
exchange's two counters after a streaming read of each kind. The ``gpu``
cases hold ``csrc/lexsort.cu`` against the plain route, bit for bit, and
a whole streaming read of each kind on the card against the same read on
the CPU; they skip without a card (decided in the ``cuda`` fixture).
This file imports no JAX, so the card's machine runs it: ``python -m
pytest --noconftest -m gpu tests/test_torch_lexsort.py``.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange import partitioners as parts_mod
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange
from sparkrdma_tpu_torch.kernels import sort as S
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry


def _batch(seed, w, n, hi=None, kw=0, device="cpu"):
    """``int32[w, n]`` of random uint32 words, the first ``kw`` below
    ``hi`` where given (ties)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, size=(w, n), dtype=np.uint64)
    if hi is not None:
        x[:kw] = rng.integers(0, hi, size=(kw, n), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)


def _keys(seed, w, n, kw, keys, device="cpu"):
    """Records whose key words are random, tie often, are all equal, or
    have the top bit set in about half of them (unsigned order)."""
    if keys == "ties":
        return _batch(seed, w, n, hi=3, kw=kw, device=device)
    if keys == "equal":
        return _batch(seed, w, n, hi=1, kw=kw, device=device)
    x = _batch(seed, w, n, device=device)
    if keys == "top":
        x[:kw] = _batch(seed + 1, kw, n, hi=4, kw=kw, device=device) << 30
    return x


# ---------------------------------------------------------------------------
# CPU: the plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,w", [(1, 1), (2, 3), (3, 25), (3, 5)])
@pytest.mark.parametrize("n,total", [(0, 9), (1, 9), (700, 1024),
                                     (1024, 1024)])
@pytest.mark.parametrize("keys", ["random", "ties"])
def test_prefix_sort_equals_the_masked_sort(kw, w, n, total, keys):
    """Sorting the received prefix ``[0, n)`` gives the bytes of today's
    sort of every column with the tail masked, where the tail is zero (a
    read's accumulator), ties in arrival order; a tail that is not zero
    keeps its place."""
    x = _keys(n + total + kw, w, total, kw, keys)
    x[:, n:] = 0
    masked = S.lexsort_cols(x, kw, torch.arange(total) < n)
    assert torch.equal(S.lexsort_cols(x, kw, n=n), masked)
    y = _keys(n + 7, w, total, kw, keys)
    got = S.lexsort_cols(y, kw, n=n)
    assert torch.equal(got[:, :n], S.lexsort_cols(y[:, :n], kw))
    assert torch.equal(got[:, n:], y[:, n:])


@pytest.mark.parametrize("kw,w", [(2, 3), (3, 25)])
@pytest.mark.parametrize("mask", [False, True])
def test_out_writes_the_copy_it_replaces(kw, w, mask):
    """``out=`` (a column slice of a wider zeroed buffer, like the read's
    output) holds the same bytes as the sorted copy copied there, and
    nothing past ``n`` is written."""
    total, n = 2000, 1500
    acc = torch.zeros((w, 3 * total), dtype=torch.int32)
    x = acc[:, total:2 * total]
    x[:, :n] = _keys(5, w, n, kw, "ties")
    valid = torch.from_numpy(np.random.default_rng(6).random(total) < 0.7) \
        if mask else None
    want = torch.zeros((w, 4 * total), dtype=torch.int32)
    masked = valid if mask else torch.ones(total, dtype=torch.bool)
    want[:, total:2 * total][:, :n] = S.lexsort_cols(
        x[:, :n], kw, masked[:n])
    got = torch.zeros((w, 4 * total), dtype=torch.int32)
    dest = got[:, total:2 * total]
    assert S.lexsort_cols(x, kw, valid, n=n, out=dest) is dest
    assert dest.stride(0) == 4 * total
    assert torch.equal(got, want)


@pytest.mark.parametrize("w,kw,whole", [
    (3, 2, True),      # TPC-H Q18's lines
    (5, 3, True),      # the map-side combine's (split id, 4 words)
    (4, 2, True),      # WordCount's reduce-side combine
    (1, 1, True), (2, 0, True), (3, 0, False),
    (25, 3, False),    # TeraSort's records
    (6, 3, False), (7, 4, False), (25, 25, True)])
def test_records_are_carried_by_shape(w, kw, whole):
    """Whole records go through the passes where they are at most one
    word wider than their key words and an index; else the key words
    and an index do, and the records are placed once."""
    assert S.carries_whole_records(w, kw) is whole


def _streaming(device="cpu", key_words=2, val_words=2, **conf):
    """At most 2 rounds in flight and 32-record slots: the reads below
    stream over 8 stacked partitions."""
    rt = MeshRuntime(ShuffleConf(slot_records=32, max_rounds_in_flight=2,
                                 key_words=key_words, val_words=val_words,
                                 **conf), 8, device=device)
    return ShuffleExchange(rt, metrics=MetricsRegistry())


# read kind -> (exchange arguments, key sorts a read: the tail's and the
# map-side combine's)
READS = {
    "sort": (dict(sort_key_words=2), 8),
    "aggregator": (dict(aggregator="sum", combine_hint=(False, 1.0)), 8),
    "map-side combine": (dict(aggregator="sum", combine_hint=(True, 2.0)),
                         16),
    "neither": (dict(), 0),
}


def _read(ex, x, **kw):
    part = parts_mod.hash_partitioner(8, 2)
    plan = ex.plan(x, part)
    assert plan.num_rounds > ex.conf.max_rounds_in_flight
    return ex.exchange(x, part, plan, **kw)


def _key_sorts(ex):
    return (ex.metrics.counter("exchange.key_sorts_kernel").value,
            ex.metrics.counter("exchange.key_sorts_plain").value)


@pytest.mark.parametrize("kind", sorted(READS))
def test_key_sort_counters_after_a_streaming_read(kind):
    """A CPU read counts each sort by key on the plain route: one a
    partition in the tail (sort or aggregator), one a source in the
    map-side combine, none where the read neither sorts nor aggregates."""
    args, sorts = READS[kind]
    x = _batch(8, 4, 8 * 512, hi=40, kw=2)
    ex = _streaming()
    _read(ex, x, **args)
    assert _key_sorts(ex) == (0, sorts)


# ---------------------------------------------------------------------------
# the card: the kernel against the plain route, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lexsort kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _same(x, kw, valid=None, n=None, out=None):
    """The kernel (one launch) and the plain route on the same input."""
    before = S.lexsort_cols.launches
    want = S.lexsort_cols_plain(
        x, kw, valid, n, None if out is None else out.clone())
    got = S.lexsort_cols(x, kw, valid, n=n, out=out)
    torch.cuda.synchronize()
    if (x.shape[1] if n is None else n) and (kw > 0 or valid is not None):
        assert S.lexsort_cols.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    return got


SHAPES = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 5), (2, 5), (3, 5), (4, 5),
          (1, 25), (2, 25), (3, 25), (4, 25)]
# records sorted: none, one, a tile less one, three tiles and a part, and
# many tiles
NS = [0, 1, 4095, 3 * 4096 + 5, 100003]


@pytest.mark.gpu
@pytest.mark.parametrize("kw,w", SHAPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("keys", ["random", "ties", "equal", "top"])
def test_kernel_matches_plain(cuda, kw, w, n, keys):
    _same(_keys(kw * 100 + w + n, w, n, kw, keys, device=cuda), kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,w", [(1, 1), (2, 3), (3, 5), (3, 25), (0, 3),
                                  (0, 25)])
@pytest.mark.parametrize("n", [1, 4095, 3 * 4096 + 5, 100003])
@pytest.mark.parametrize("mask", ["scattered", "all", "none"])
def test_kernel_mask_matches_plain(cuda, kw, w, n, mask):
    """Invalid rows scattered through a mask go last, in key order;
    an all-true mask and an all-false one change nothing."""
    x = _keys(n + kw, w, n, kw, "ties", device=cuda)
    valid = {"scattered": torch.rand(n, device=cuda) < 0.6,
             "all": torch.ones(n, dtype=torch.bool, device=cuda),
             "none": torch.zeros(n, dtype=torch.bool, device=cuda)}[mask]
    _same(x, kw, valid)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,w", [(2, 3), (3, 5), (3, 25)])
@pytest.mark.parametrize("n", [0, 1, 4097, 70001])
def test_kernel_prefix_into_strided_out(cuda, kw, w, n):
    """The read's tail: the input a column slice of the accumulator (its
    row stride not ``n``), the received prefix ``n`` sorted into a column
    slice of the zeroed output, and the prefix alone without ``out``."""
    total = 70001 + 3
    acc = torch.zeros((w, 3 * total + 11), dtype=torch.int32, device=cuda)
    x = acc[:, total:2 * total]
    x[:, :n] = _keys(n + w, w, n, kw, "random", device=cuda)
    out = torch.zeros((w, 2 * total + 5), dtype=torch.int32, device=cuda)
    dest = out[:, total:2 * total]
    _same(x, kw, n=n, out=dest)
    assert not out[:, :total].any() and not out[:, total + n:].any()
    _same(x, kw, n=n)
    _same(x, kw, torch.rand(total, device=cuda) < 0.5, n=n, out=dest)


@pytest.mark.gpu
def test_kernel_edges(cuda):
    """A column-strided input, a column-strided ``out``, the identity
    (no key, no mask), and what the kernel refuses."""
    x = _keys(3, 5, 9000, 3, "ties", device=cuda)
    _same(x[:, ::2], 3)
    out = torch.zeros((5, 18000), dtype=torch.int32, device=cuda)
    _same(x, 3, n=7000, out=out[:, ::2])
    assert torch.equal(S.lexsort_cols(x, 0), x)
    with pytest.raises(TypeError, match="int32"):
        S.lexsort_cols(x.float(), 2)
    with pytest.raises(ValueError, match="key words"):
        S.lexsort_cols(x, 6)
    with pytest.raises(ValueError, match="overlaps"):
        S.lexsort_cols(x, 2, out=x)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(READS))
def test_streaming_read_on_card_equals_cpu(cuda, kind):
    """A whole streaming read of each kind on the card (the kernel's
    route: 8 key sorts a read in the tail, 8 more in the map-side
    combine) against the same read on the CPU, bit for bit."""
    args, sorts = READS[kind]
    x = _batch(13, 4, 8 * 4096, hi=500, kw=2)
    card = _streaming(cuda)
    before = S.lexsort_cols.launches
    got = _read(card, x.to(cuda), **args)
    assert _key_sorts(card) == (sorts, 0)
    assert S.lexsort_cols.launches == before + sorts
    cpu = _streaming()
    want = _read(cpu, x, **args)
    assert _key_sorts(cpu) == (0, sorts)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
