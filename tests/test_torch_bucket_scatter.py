"""The read's map-side bucketing into the gather source
(``kernels/bucket_scatter.py``).

The CPU cases hold the plain version against a stable sort of each
source partition's ids, and the streaming prep's choice of path with
its two counters. The ``gpu`` cases hold the CUDA kernel against the
plain version, bit for bit, and a whole streaming exchange against the
same exchange bucketed source by source; they skip without a card
(decided in the ``cuda`` fixture). This file imports no JAX, so the
card's machine runs it: ``python -m pytest --noconftest -m gpu
tests/test_torch_bucket_scatter.py``.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange import partitioners as parts_mod
from sparkrdma_tpu_torch.exchange import protocol
from sparkrdma_tpu_torch.exchange.protocol import (ShuffleExchange,
                                                   map_kernel_takes,
                                                   split_partitioner)
from sparkrdma_tpu_torch.kernels import bucket_scatter as bs
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry


def _batch(seed, w, n, hi=2 ** 32, device="cpu"):
    x = np.random.default_rng(seed).integers(0, hi, size=(w, n),
                                             dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _splitters(seed, parts, kw, variant, hi=2 ** 32):
    """``[parts - 1, kw]`` uint32 rows: random (unsorted), with duplicate
    rows, or all equal."""
    rows = np.random.default_rng(seed).integers(0, hi, size=(parts - 1, kw),
                                                dtype=np.uint32)
    if variant == "duplicate":
        rows[1::2] = rows[0::2][:len(rows[1::2])]
    elif variant == "equal":
        rows[:] = rows[:1]
    return rows


def _bins(part):
    spec = part.device_spec
    return spec.num_parts + spec.stride * (spec.split_k - 1)


MAKERS = {
    "hash": lambda: parts_mod.hash_partitioner(40, 2),
    "mod": lambda: parts_mod.modulo_partitioner(5, 1),
    "range": lambda: parts_mod.range_partitioner(
        _splitters(3, 8, 3, "duplicate", hi=2 ** 4), 3),
    "split": lambda: split_partitioner(parts_mod.hash_partitioner(8, 3), 8,
                                       9),
}


# ---------------------------------------------------------------------------
# CPU: the plain version and the prep's path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", sorted(MAKERS))
@pytest.mark.parametrize("L,n", [(8, 8 * 257 + 5), (1, 1001), (8, 3)])
def test_plain_is_a_stable_sort_of_each_source(make, L, n):
    """Source ``d``'s records sit at ``[d*n, (d+1)*n)`` in the order of a
    stable sort by id, then one zero column; counts and offsets are each
    source's."""
    part = MAKERS[make]()
    parts = _bins(part)
    x = _batch(4, 3, n, hi=2 ** 4 if make == "range" else 2 ** 32)
    src, counts, offsets = bs.bucket_scatter(x, part, parts, L)  # plain
    m = n // L
    assert src.shape == (3, L * m + 1) and src.dtype == torch.int32
    assert counts.dtype == offsets.dtype == torch.int64
    assert counts.shape == offsets.shape == (L, parts)
    assert not src[:, -1].any()
    for d in range(L):
        rec = x[:, d * m:(d + 1) * m]
        ids = part(rec).numpy()
        perm = np.argsort(ids, kind="stable")
        np.testing.assert_array_equal(src[:, d * m:(d + 1) * m].numpy(),
                                      rec.numpy()[:, perm])
        c = np.bincount(ids, minlength=parts)
        np.testing.assert_array_equal(counts[d].numpy(), c)
        np.testing.assert_array_equal(offsets[d].numpy(), np.cumsum(c) - c)


def _conditions():
    h = parts_mod.hash_partitioner(8, 2)
    split = split_partitioner(h, 8, 4)
    return {
        "described": (dict(), True),
        "split": (dict(partitioner=split, num_parts=32), True),
        "cpu batch": (dict(on_card=False), False),
        "no description": (dict(partitioner=lambda r: h(r)), False),
        "split of a split": (dict(partitioner=split_partitioner(split, 32,
                                                                2),
                                  num_parts=64), False),
        "filter": (dict(row_filter=lambda r: r[0] > 0), False),
        "projection": (dict(keep_words=(0, 1)), False),
        "combine": (dict(combine=True), False),
        "one bin": (dict(partitioner=parts_mod.hash_partitioner(1, 2),
                         num_parts=1), False),
        "bin limit": (dict(partitioner=parts_mod.hash_partitioner(256, 2),
                           num_parts=256), True),
        "past the bin limit": (dict(
            partitioner=parts_mod.hash_partitioner(264, 2), num_parts=264),
            False),
    }


@pytest.mark.parametrize("case", sorted(_conditions()))
def test_map_kernel_takes_what_the_input_shows(case):
    given, want = _conditions()[case]
    kw = dict(on_card=True, partitioner=parts_mod.hash_partitioner(8, 2),
              num_parts=8, combine=False, row_filter=None, keep_words=None)
    kw.update(given)
    assert map_kernel_takes(**kw) is want


def _streaming(device="cpu", partitions=8, slot_records=32, key_words=2,
               val_words=1, **conf):
    """At most 2 rounds in flight and 32-record slots: the reads below
    stream."""
    rt = MeshRuntime(ShuffleConf(slot_records=slot_records,
                                 max_rounds_in_flight=2, key_words=key_words,
                                 val_words=val_words, **conf), partitions,
                     device=device)
    return ShuffleExchange(rt, metrics=MetricsRegistry())


def _map_passes(ex):
    return (ex.metrics.counter("exchange.map_passes_kernel").value,
            ex.metrics.counter("exchange.map_passes_plain").value)


def _read(ex, x, part, split=1, **kw):
    plan = ex.plan(x, part)
    assert plan.num_rounds > ex.conf.max_rounds_in_flight
    assert plan.split_factor == split
    return ex.exchange(x, part, plan, **kw)


def _on_card_everywhere(monkeypatch):
    """The prep's test as on the card, whatever the batch's device: on
    the CPU the kernel route's ``bucket_scatter`` runs the plain
    version, so the route's wiring runs here."""
    real = protocol.map_kernel_takes
    monkeypatch.setattr(protocol, "map_kernel_takes",
                        lambda on_card, *a: real(True, *a))


def _hash():
    return parts_mod.hash_partitioner(8, 2)


# partitioner, read arguments, (kernel, plain) map passes of a read
READS = {
    "described": (_hash, {}, (1, 0)),
    "no description": (lambda: (lambda r, p=_hash(): p(r)), {}, (0, 8)),
    "filter": (_hash, dict(row_filter=lambda r: r[2] > 0), (0, 8)),
    "projection": (_hash, dict(keep_words=(0, 1)), (0, 8)),
    "combine": (_hash, dict(aggregator="sum", combine_hint=(True, 2.0)),
                (0, 0)),
    "combine declined": (_hash, dict(aggregator="sum",
                                     combine_hint=(False, 1.0)), (1, 0)),
    # 7 of 8 keys past every splitter: the plan splits 4 ways
    "split": (lambda: parts_mod.range_partitioner(
        np.array([[1, 0]] * 7, dtype=np.uint32), 2), dict(split=4), (1, 0)),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_prep_path_and_counters(monkeypatch, case):
    """A streaming read takes the kernel's route exactly where the input
    allows it, with one ``map_passes_kernel`` a read; else each source
    counts one ``map_passes_plain`` (a combined one neither). Both
    routes read the same bytes."""
    make, kw, want = READS[case]
    x = _batch(7, 3, 8 * 512, hi=2 ** 3)
    plain = _streaming(max_rounds=4)
    ref = _read(plain, x, make(), **kw)
    assert _map_passes(plain) == ((0, 0) if case == "combine" else (0, 8))
    _on_card_everywhere(monkeypatch)
    card = _streaming(max_rounds=4)
    got = _read(card, x, make(), **kw)
    assert _map_passes(card) == want
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_prep_one_bin_takes_the_plain_route(monkeypatch):
    _on_card_everywhere(monkeypatch)
    ex = _streaming(partitions=1)
    x = _batch(8, 3, 512)
    out, totals, _ = _read(ex, x, parts_mod.hash_partitioner(1, 2))
    assert _map_passes(ex) == (0, 1)
    assert int(totals[0]) == 512


def test_plain_regime_buckets_source_by_source():
    """The fused regime keeps ``bucket_records``: a source a pass."""
    rt = MeshRuntime(ShuffleConf(slot_records=4096, val_words=1), 8,
                     device="cpu")
    ex = ShuffleExchange(rt, metrics=MetricsRegistry())
    x = _batch(9, 3, 8 * 256)
    part = parts_mod.hash_partitioner(8, 2)
    plan = ex.plan(x, part)
    assert plan.num_rounds <= ex.conf.max_rounds_in_flight
    ex.exchange(x, part, plan)
    assert _map_passes(ex) == (0, 8)


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bucket_scatter kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _same(x, part, parts, L):
    before = bs.bucket_scatter.launches
    got = bs.bucket_scatter(x, part, parts, L)
    torch.cuda.synchronize()
    assert bs.bucket_scatter.launches == before + 1
    want = bs.bucket_scatter_plain(x, part, parts, L)
    for name, a, b in zip(("src", "counts", "offsets"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    return got


# L, records, and whether the batch is a row-strided view starting at a
# column that is not a multiple of 4 (no 16-byte loads): partitions of
# 4099 records (neither a multiple of 4 nor of the tile), 100003, 6000
# (two tiles, the second partial, 16-byte loads), 4096 (one tile,
# strided), 8192 (two whole tiles), none, 3
SHAPES = [(8, 8 * 4099 + 3, False), (1, 100003, True), (8, 8 * 6000, False),
          (8, 8 * 4096, True), (8, 8 * 8192, False), (8, 5, False),
          (1, 3, False)]


def _view(seed, w, n, strided, cuda, hi=2 ** 32):
    x = _batch(seed, w, n + 3, hi=hi, device=cuda)
    return x[:, 3:] if strided else x[:, :n].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("w", [1, 3, 25])
@pytest.mark.parametrize("parts", [8, 32, 40, 72, 256])
def test_hash_kernel_matches_plain(cuda, L, n, strided, w, parts):
    x = _view(w * 1000 + parts, w, n, strided, cuda)
    _same(x, parts_mod.hash_partitioner(parts, min(w, 3)), parts, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("variant", ["random", "duplicate", "equal"])
@pytest.mark.parametrize("parts", [8, 32, 72])
def test_range_kernel_matches_plain(cuda, L, n, strided, variant, parts):
    # keys from 16 values a word: many tie with the splitters
    x = _view(parts, 3, n, strided, cuda, hi=2 ** 4)
    spl = _splitters(parts, parts, 2, variant, hi=2 ** 4)
    _same(x, parts_mod.range_partitioner(spl, 2), parts, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("key_word", [0, 2])
def test_mod_kernel_matches_plain(cuda, L, n, strided, key_word):
    x = _view(key_word, 3, n, strided, cuda)
    _same(x, parts_mod.modulo_partitioner(13, key_word), 13, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("inner", ["hash", "range", "mod"])
def test_split_kernel_matches_plain(cuda, L, n, strided, k, inner):
    x = _view(k, 25, n, strided, cuda)
    base = {"hash": lambda: parts_mod.hash_partitioner(8, 3),
            "range": lambda: parts_mod.range_partitioner(
                _splitters(k, 8, 3, "random"), 3),
            "mod": lambda: parts_mod.modulo_partitioner(8, 1)}[inner]()
    _same(x, split_partitioner(base, 8, k), 8 * k, L)


@pytest.mark.gpu
def test_kernel_edges_match_plain(cuda):
    """All records in one bin, most bins empty, ids below the bins, the
    bin limit, a column-strided view, an expanded batch, more key words
    than the kernel holds in registers, splitters past shared memory;
    and what the kernel refuses."""
    x = _batch(9, 6, 8 * 5003, device=cuda)
    ones = x.clone()
    ones[:2] = 7                          # one key: one bin
    got = _same(ones, parts_mod.hash_partitioner(72, 2), 72, 8)
    assert int((got[1] > 0).sum()) == 8
    few = _batch(10, 6, 8 * 5003, hi=3, device=cuda)
    _same(few, parts_mod.modulo_partitioner(40, 0), 40, 8)   # 3 of 40
    _same(x, parts_mod.hash_partitioner(16, 2), 32, 8)       # ids < 16
    _same(x, parts_mod.hash_partitioner(bs.BIN_LIMIT, 2), bs.BIN_LIMIT, 8)
    _same(x, parts_mod.hash_partitioner(2, 2), 2, 1)
    _same(x, parts_mod.hash_partitioner(1, 2), 1, 8)
    _same(x[:, ::3], parts_mod.hash_partitioner(8, 3), 8, 8)
    _same(x[:, :1].expand(6, 800), parts_mod.hash_partitioner(8, 3), 8, 8)
    _same(x, parts_mod.hash_partitioner(40, 6), 40, 8)
    _same(x, parts_mod.range_partitioner(
        _splitters(9, 40, 6, "random"), 6), 40, 8)
    big = parts_mod.range_partitioner(_splitters(11, 200, 24, "random"), 24)
    _same(_batch(11, 24, 8 * 3001, device=cuda), big, 200, 8)
    with pytest.raises(ValueError, match="device_spec"):
        bs.bucket_scatter(x, lambda r: r[0].long() % 8, 8, 8)
    with pytest.raises(ValueError, match="bins"):
        bs.bucket_scatter(x, parts_mod.hash_partitioner(300, 2), 300, 8)
    with pytest.raises(ValueError, match="past"):
        bs.bucket_scatter(x, parts_mod.hash_partitioner(16, 2), 8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["range", "hash"])
def test_streaming_exchange_on_card_equals_source_by_source(cuda, part):
    """A whole streaming read with the described partitioner (one launch)
    against the same read with an undescribed copy of it (a source at a
    time): ``out``, ``totals`` and ``incoming`` equal, bit for bit."""
    x = _batch(12, 25, 8 * 20000, device=cuda)
    make = {"hash": lambda: parts_mod.hash_partitioner(8, 3),
            "range": lambda: parts_mod.range_partitioner(
                np.sort(_splitters(12, 8, 3, "random"), axis=0), 3)}[part]
    card = _streaming(cuda, slot_records=512, key_words=3, val_words=22)
    before = bs.bucket_scatter.launches
    got = _read(card, x, make(), sort_key_words=3)
    assert bs.bucket_scatter.launches == before + 1
    assert _map_passes(card) == (1, 0)
    plain = _streaming(cuda, slot_records=512, key_words=3, val_words=22)
    want = _read(plain, x, lambda r, p=make(): p(r), sort_key_words=3)
    assert _map_passes(plain) == (0, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
