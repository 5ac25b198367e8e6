"""The plan pass's count table (``kernels/partition_counts.py``).

The CPU cases hold the partitioners' descriptions, the plan's choice of
path and its counters, and the plain version against ``histogram_pids``
over the partitioner. The ``gpu`` cases hold the CUDA kernel against the
plain version, bit for bit, and skip without a card (decided in the
``cuda`` fixture). This file imports no JAX, so the card's machine runs
it: ``python -m pytest --noconftest -m gpu
tests/test_torch_partition_counts.py``.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange import partitioners as parts_mod
from sparkrdma_tpu_torch.exchange.protocol import (ShuffleExchange,
                                                   split_partitioner)
from sparkrdma_tpu_torch.kernels import partition_counts as pc
from sparkrdma_tpu_torch.kernels.bucketing import histogram_pids
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry


def _batch(seed, w, n, hi=2 ** 32, device="cpu"):
    x = np.random.default_rng(seed).integers(0, hi, size=(w, n),
                                             dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _sorted_rows(rows):
    return rows[np.lexsort(rows.T[::-1])]


def _splitters(seed, parts, kw, variant, keys=None):
    """``[parts - 1, kw]`` uint32 rows: random (unsorted), sorted with
    duplicate rows, or all equal to the first record's key."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2 ** 32, size=(parts - 1, kw), dtype=np.uint32)
    if variant == "sorted":
        return _sorted_rows(rows)
    if variant == "duplicate":
        rows[1::2] = rows[0::2][:len(rows[1::2])]
        return _sorted_rows(rows)
    if variant == "key_equal":
        key = keys[:kw, 0].cpu().numpy().view(np.uint32)
        return np.repeat(key[None, :], parts - 1, axis=0)
    return rows


# ---------------------------------------------------------------------------
# CPU: the descriptions, the plan's path and the plain version
# ---------------------------------------------------------------------------


def _fields(spec):
    return (spec.kind, spec.num_parts, spec.key_words, spec.first,
            spec.split_k, spec.stride)


def test_factories_attach_their_description():
    h = parts_mod.hash_partitioner(24, 3)
    assert _fields(h.device_spec) == ("hash", 24, 3, 0, 1, 0)
    assert h.device_spec.rows is None
    m = parts_mod.modulo_partitioner(7, 2)
    assert _fields(m.device_spec) == ("mod", 7, 1, 2, 1, 0)
    spl = np.array([[7, 0, 3], [5, 9, 1], [5, 9, 0]], dtype=np.uint32)
    r = parts_mod.range_partitioner(spl, 3)
    assert _fields(r.device_spec) == ("range", 4, 3, 0, 1, 0)
    # the rows read, sorted: an id counts the rows at or below its key
    rows = r.device_spec.rows
    assert rows.dtype == np.uint32
    np.testing.assert_array_equal(rows, spl[[2, 1, 0]])
    np.testing.assert_array_equal(
        parts_mod.range_partitioner(spl, 2).device_spec.rows,
        [[5, 9], [5, 9], [7, 0]])
    one = parts_mod.range_partitioner(np.zeros((0, 2), np.uint32), 2)
    assert one.device_spec.num_parts == 1
    assert one.device_spec.rows.shape == (0, 2)


def test_range_ids_do_not_depend_on_the_splitters_order():
    """The plain callable reads the description's sorted rows, through
    the one per-device copy it shares with every split, and gives the
    ids the unsorted rows define."""
    x = _batch(6, 3, 4096, hi=2 ** 4)
    spl = np.random.default_rng(6).integers(0, 2 ** 4, size=(9, 3),
                                            dtype=np.uint32)
    r = parts_mod.range_partitioner(spl, 3)
    keys = x.numpy().view(np.uint32).T.astype(np.int64)
    rows = spl.astype(np.int64)
    ge = np.zeros((len(keys), len(rows)), dtype=bool)   # key >= row
    eq = np.ones_like(ge)
    for w in range(3):
        kw, sw = keys[:, w:w + 1], rows[None, :, w]
        ge |= eq & (kw > sw)
        eq &= kw == sw
    want = (ge | eq).sum(axis=1)
    np.testing.assert_array_equal(r(x).numpy(), want)
    sp = split_partitioner(r, 10, 3)
    assert sp.device_spec.on_device is r.device_spec.on_device
    assert list(r.device_spec.on_device) == [torch.device("cpu")]


def test_split_wraps_the_inner_description():
    h = parts_mod.hash_partitioner(8, 2)
    sp = split_partitioner(h, 8, 4)
    assert _fields(sp.device_spec) == ("hash", 8, 2, 0, 4, 8)
    # a split of a split, and of a callable without one, has none
    assert split_partitioner(sp, 32, 2).device_spec is None
    assert split_partitioner(lambda r: r[0].long() % 8, 8,
                             2).device_spec is None


def _exchange(device="cpu", slot_records=32):
    """Small slots and at most 4 rounds: the batches below plan in two
    passes, the second split 2 ways."""
    rt = MeshRuntime(ShuffleConf(slot_records=slot_records, max_rounds=4),
                     8, device=device)
    return ShuffleExchange(rt, metrics=MetricsRegistry())


def _passes(ex):
    return (ex.metrics.counter("exchange.plan_passes_kernel").value,
            ex.metrics.counter("exchange.plan_passes_plain").value)


def test_plan_on_cpu_takes_the_plain_path():
    ex = _exchange()
    x = _batch(1, 3, 8 * 1024)
    before = pc.partition_counts.launches
    plan = ex.plan(x, parts_mod.hash_partitioner(8, 2))
    assert plan.split_factor == 2         # two passes: the split's too
    assert _passes(ex) == (0, 2)
    assert pc.partition_counts.launches == before
    assert plan.total_records == 8 * 1024


def test_undescribed_partitioner_takes_the_plain_path():
    """Without a description the partitioner itself is called, once per
    stacked partition and pass, on any device."""
    ex = _exchange()
    x = _batch(2, 2, 8 * 256)
    calls = []

    def part(records):
        calls.append(records.shape[1])
        return as_unsigned(records[1]) % 8

    plan = ex.plan(x, part)
    assert _passes(ex) == (0, 1)
    assert calls == [256] * 8 and plan.split_factor == 1
    counts = pc.partition_counts_plain(x, part, 8, 8)
    np.testing.assert_array_equal(plan.counts, counts.numpy())


@pytest.mark.parametrize("make", [
    lambda: parts_mod.hash_partitioner(40, 2),
    lambda: parts_mod.modulo_partitioner(5, 1),
    lambda: parts_mod.range_partitioner(
        _splitters(3, 8, 3, "duplicate"), 3),
    lambda: split_partitioner(parts_mod.hash_partitioner(8, 3), 8, 3),
], ids=["hash", "mod", "range", "split"])
@pytest.mark.parametrize("L,n", [(8, 8 * 257 + 5), (1, 1001), (8, 3)])
def test_plain_equals_histogram_over_the_partitioner(make, L, n):
    part = make()
    x = _batch(4, 3, n)
    spec = part.device_spec
    parts = spec.num_parts + spec.stride * (spec.split_k - 1)
    got = pc.partition_counts(x, part, parts, L)      # CPU: the plain one
    m = n // L
    want = torch.stack([histogram_pids(part(x[:, d * m:(d + 1) * m]), parts)
                        for d in range(L)])
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_kernel_args_refuse_what_the_kernel_cannot_read():
    x = _batch(5, 2, 64)
    with pytest.raises(ValueError, match="key words"):
        pc.kernel_args(x, parts_mod.hash_partitioner(8, 3).device_spec, 8, 8)
    with pytest.raises(ValueError, match="key words"):
        pc.kernel_args(x, parts_mod.modulo_partitioner(8, 2).device_spec, 8,
                       8)
    with pytest.raises(ValueError, match="int32"):
        pc.kernel_args(x.long(), parts_mod.modulo_partitioner(8).device_spec,
                       8, 8)
    with pytest.raises(ValueError, match="range"):
        pc.kernel_args(x, parts_mod.modulo_partitioner(8).device_spec, 8,
                       2 ** 16)
    args = pc.kernel_args(x[:, 8:40], parts_mod.modulo_partitioner(
        8, 1).device_spec.split(3, 8), 24, 4)
    assert args[1:] == (64, 1, 8, 4, parts_mod.KERNEL_KINDS["mod"], 8, 1, 1,
                        0, 3, 8)


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the partition_counts kernel has "
                    "no CPU mode")
    return torch.device("cuda")


def _same(x, part, parts, L):
    before = pc.partition_counts.launches
    got = pc.partition_counts(x, part, parts, L)
    torch.cuda.synchronize()
    assert pc.partition_counts.launches == before + 1
    want = pc.partition_counts_plain(x, part, parts, L)
    assert torch.equal(got, want), (got, want)
    return got


# L, records, and whether the batch is a row-strided view starting at a
# column that is not a multiple of 4
SHAPES = [(8, 8 * 4099 + 3, False), (1, 100003, True), (8, 8 * 1024, True),
          (8, 5, False), (8, 0, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("kw", [1, 2, 3])
@pytest.mark.parametrize("parts", [2, 8, 24, 40, 256])
def test_hash_kernel_matches_plain(cuda, L, n, strided, kw, parts):
    x = _batch(kw * 1000 + parts, 4, n + 3, device=cuda)
    x = x[:, 3:] if strided else x[:, :n].contiguous()
    _same(x, parts_mod.hash_partitioner(parts, kw), parts, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("variant", ["random", "sorted", "duplicate",
                                     "key_equal"])
@pytest.mark.parametrize("kw", [2, 3])
@pytest.mark.parametrize("parts", [8, 257])
def test_range_kernel_matches_plain(cuda, L, n, strided, variant, kw, parts):
    x = _batch(kw * 100 + parts, 4, n + 3, hi=2 ** 8 if variant ==
               "duplicate" else 2 ** 32, device=cuda)
    x = x[:, 3:] if strided else x[:, :n].contiguous()
    keys = x if x.shape[1] else _batch(0, 4, 1, device=cuda)
    spl = _splitters(parts + kw, parts, kw, variant, keys)
    if variant == "duplicate":
        spl %= 2 ** 8                     # keys tie with the splitters
        spl = _sorted_rows(spl)
    _same(x, parts_mod.range_partitioner(spl, kw), parts, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("key_word", [0, 2])
def test_mod_kernel_matches_plain(cuda, L, n, strided, key_word):
    x = _batch(key_word, 4, n + 3, device=cuda)
    x = x[:, 3:] if strided else x[:, :n].contiguous()
    _same(x, parts_mod.modulo_partitioner(13, key_word), 13, L)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,strided", SHAPES)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("inner", ["hash", "range", "mod"])
def test_split_kernel_matches_plain(cuda, L, n, strided, k, inner):
    x = _batch(k, 4, n + 3, device=cuda)
    x = x[:, 3:] if strided else x[:, :n].contiguous()
    base = {"hash": lambda: parts_mod.hash_partitioner(8, 3),
            "range": lambda: parts_mod.range_partitioner(
                _splitters(k, 8, 3, "sorted"), 3),
            "mod": lambda: parts_mod.modulo_partitioner(8, 1)}[inner]()
    _same(x, split_partitioner(base, 8, k), 8 * k, L)


@pytest.mark.gpu
def test_kernel_edges_match_plain(cuda):
    """Histograms past shared memory (straight to the table), ids past
    ``parts`` dropped, a column-strided view, an
    expanded batch and more key words than the kernel holds in
    registers."""
    x = _batch(9, 6, 8 * 3001, device=cuda)
    _same(x, parts_mod.hash_partitioner(3000, 2), 3000, 8)
    _same(x, parts_mod.hash_partitioner(20000, 2), 20000, 8)
    _same(x, parts_mod.hash_partitioner(16, 2), 8, 8)
    _same(x[:, ::3], parts_mod.hash_partitioner(8, 3), 8, 8)
    _same(x[:, :1].expand(6, 800), parts_mod.hash_partitioner(8, 3), 8, 8)
    _same(x, parts_mod.hash_partitioner(40, 6), 40, 8)
    _same(x, parts_mod.range_partitioner(
        _splitters(9, 40, 6, "sorted"), 6), 40, 8)
    _same(x, parts_mod.range_partitioner(
        _splitters(9, 40, 6, "random"), 6), 40, 8)
    with pytest.raises(ValueError, match="device_spec"):
        pc.partition_counts(x, lambda r: r[0].long() % 8, 8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["range", "hash"])
def test_plan_on_card_equals_the_plain_plan(cuda, part):
    """The plan of a CUDA batch is the plain path's, with one launch a
    pass and ``exchange.plan_passes_kernel`` bumped once a pass."""
    x = _batch(11, 25, 8 * 20000, device=cuda)
    make = {"hash": lambda: parts_mod.hash_partitioner(8, 3),
            "range": lambda: parts_mod.range_partitioner(
                _splitters(11, 8, 3, "sorted"), 3)}[part]
    card = _exchange(cuda, slot_records=512)
    before = pc.partition_counts.launches
    got = card.plan(x, make())
    assert got.split_factor > 1
    assert pc.partition_counts.launches == before + 2
    assert _passes(card) == (2, 0)
    plain = _exchange(cuda, slot_records=512)
    want = plain.plan(x, lambda r, p=make(): p(r))   # no description
    assert _passes(plain) == (0, 2)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.num_rounds, got.out_capacity, got.capacity,
            got.split_factor) == (want.num_rounds, want.out_capacity,
                                  want.capacity, want.split_factor)
