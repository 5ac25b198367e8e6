"""Port merge-path sort vs ``sparkrdma_tpu.kernels.merge_sort``.

The reference runs its Pallas kernel in interpret mode on the CPU; the
port runs its plain version there. Records compare over all words, so
the sorted output is unique and the comparison is bit-exact (tolerance
0). The kernel itself is held against the plain version on the card by
the ``gpu`` tests (skipped without one) and by ``chip_smoke.py``.

The reference is jitted once per shape and always given a mask (all
true where the port gets none, which sorts identically), so its
interpret-mode compile is paid once per (W, N).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.kernels import merge_sort as ref
from sparkrdma_tpu_torch.interop import records_from_torch, records_to_torch
from sparkrdma_tpu_torch.kernels import merge_sort as port


_ref_sort = jax.jit(ref.merge_sort_cols,
                    static_argnames=("run", "tile", "interpret"))


def _input(rng, variant, w, n):
    if variant == "identical":
        return np.full((w, n), 7, dtype=np.uint32), None
    hi = 4 if variant == "few_keys" else 2**32
    x = rng.integers(0, hi, size=(w, n), dtype=np.uint32)
    valid = None
    if variant == "valid":
        valid = rng.random(n) < 0.8           # scattered invalid rows
    return x, valid


@pytest.mark.parametrize("variant", ["random", "valid", "few_keys",
                                     "identical"])
@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("w", [4, 25])
def test_merge_sort_matches_reference(rng, w, n, variant):
    x, valid = _input(rng, variant, w, n)
    mask = np.ones(n, bool) if valid is None else valid
    want = np.asarray(_ref_sort(jnp.asarray(x), jnp.asarray(mask),
                                run=128, tile=128, interpret=True))
    got = port.merge_sort_cols(
        records_to_torch(x, "cpu"),
        None if valid is None else torch.from_numpy(valid), run=128)
    np.testing.assert_array_equal(records_from_torch(got), want)


@pytest.mark.parametrize("w,n,run", [(4, 1024, 128), (25, 2048, 256)])
def test_one_stage_matches_reference_stage(rng, w, n, run):
    """One stage alone vs the reference's ``_merge_stage`` on the same
    chunk-sorted input."""
    x = rng.integers(0, 2**32, size=(w, n), dtype=np.uint32)
    x[:, ::5] = x[:, :1]                      # duplicate records
    cols = ref.chunk_sort_cols(jnp.asarray(x), run)
    tile = 128
    padded = jnp.concatenate(
        [cols, jnp.full((w, 2 * tile), 0xFFFFFFFF, jnp.uint32)], axis=1)
    aoff = ref._merge_path_offsets(padded, n, run, tile)
    want = np.asarray(ref._merge_stage(padded, aoff, n=n, run=run, tile=tile,
                                       interpret=True))[:, :n]
    got = port.merge_stage(records_to_torch(np.asarray(cols), "cpu"), run)
    np.testing.assert_array_equal(records_from_torch(got), want)


def test_chunk_sort_matches_reference(rng):
    x = rng.integers(0, 2**32, size=(5, 1024), dtype=np.uint32)
    want = np.asarray(ref.chunk_sort_cols(jnp.asarray(x), 256))
    got = port.chunk_sort_cols(records_to_torch(x, "cpu"), 256)
    np.testing.assert_array_equal(records_from_torch(got), want)


@pytest.mark.parametrize("n,run", [(1024, 128), (512, 512), (768, 128)])
def test_geometry_rule_matches_reference(n, run):
    assert port.supports_fast_sort(n, run) == ref.supports_fast_sort(n, run)


def test_rejects_bad_geometry():
    x = torch.zeros((2, 1000), dtype=torch.int32)
    with pytest.raises(ValueError, match="power-of-two"):
        port.merge_sort_cols(x, run=128)
    with pytest.raises(ValueError, match="run must be"):
        port.merge_sort_cols(torch.zeros((2, 1024), dtype=torch.int32),
                             run=100)


@pytest.mark.parametrize("w,expected", [(4, 512), (25, 512), (200, 128)])
def test_tile_fits_shared_memory(w, expected):
    """Two double-buffered CTAs per SM where they fit, else one."""
    tile = port.pick_tile(w, 1 << 15)
    assert tile == expected
    per_sm = 2 if port.stage_smem(w, tile) <= 233472 // 2 - 1024 else 1
    assert per_sm == (1 if w == 200 else 2)
    assert port.stage_smem(w, tile) <= 232448
    assert port.pick_tile(w, 128) == 128


def _np_sorted(x):
    """Full-record ascending sort of uint32 ``[W, N]`` columns (numpy)."""
    return x[:, np.lexsort(x[::-1])] if x.shape[1] else x


def _prefix_input(rng, variant, w, n):
    if variant == "identical":
        return np.full((w, n), 7, dtype=np.uint32)
    hi = 4 if variant == "few_keys" else 2**32
    x = rng.integers(0, hi, size=(w, n), dtype=np.uint32)
    if variant == "duplicates":
        x[:, ::3] = x[:, 1:2]                 # one record, many times
    return x


@pytest.mark.parametrize("variant", ["random", "few_keys", "duplicates",
                                     "identical"])
@pytest.mark.parametrize("total", [257, 511, 100])
def test_prefix_sort_matches_reference(rng, total, variant):
    """``n_valid`` sorts only ceil(total / run) runs (ragged stages) and
    must equal the reference given the same prefix as a mask: just above
    a power of two, just below one, and below a single run."""
    w, n, run = 25, 1024, 128
    x = _prefix_input(rng, variant, w, n)
    mask = np.arange(n) < total
    want = np.asarray(_ref_sort(jnp.asarray(x), jnp.asarray(mask),
                                run=run, tile=128, interpret=True))
    cols = records_to_torch(x, "cpu")
    got = port.merge_sort_cols(cols, run=run, n_valid=total)
    np.testing.assert_array_equal(records_from_torch(got), want)
    np.testing.assert_array_equal(
        records_from_torch(port.merge_sort_cols_plain(cols, total)), want)


@pytest.mark.parametrize("n_runs,tail", [(5, 0), (3, 64), (1, 200),
                                         (2, 0)])
def test_ragged_stage_plain_sorts_each_pair(rng, n_runs, tail):
    """Odd run counts and a short last B run: each pair of runs (the
    last one short, or A alone) comes out as its full sort."""
    w, run = 3, 256
    n = n_runs * run + tail
    x = rng.integers(0, 8, size=(w, n), dtype=np.uint32)
    runs = [_np_sorted(x[:, i:i + run]) for i in range(0, n, run)]
    cols = np.concatenate(runs, axis=1)
    want = np.concatenate([_np_sorted(cols[:, i:i + 2 * run])
                           for i in range(0, n, 2 * run)], axis=1)
    got = port.merge_stage(records_to_torch(cols, "cpu"), run)
    np.testing.assert_array_equal(records_from_torch(got), want)


@pytest.mark.parametrize("w,n,run,tile", [(4, 1024, 128, 128),
                                          (25, 2048, 256, 128),
                                          (3, 4096, 512, 256)])
def test_split_pass_matches_reference_offsets(rng, w, n, run, tile):
    """The split pass's plain version vs the reference's
    ``_merge_path_offsets`` on distinct records (ties may split
    differently between the two)."""
    x = rng.integers(0, 2**32, size=(w, n), dtype=np.uint32)
    x[0] = rng.permutation(n).astype(np.uint32) * 977   # all distinct
    cols = ref.chunk_sort_cols(jnp.asarray(x), run)
    padded = jnp.concatenate(
        [cols, jnp.full((w, 2 * tile), 0xFFFFFFFF, jnp.uint32)], axis=1)
    want = np.asarray(ref._merge_path_offsets(padded, n, run, tile))
    got = port.merge_splits(records_to_torch(np.asarray(cols), "cpu"),
                            run, tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5 * 256, 3 * 256 + 64, 2048])
def test_split_pass_ties_to_a(rng, n):
    """Ragged stages with many ties: every split is the count of A
    records among the tile's predecessors in the merge that takes A
    first on ties (A's records before B's equal ones)."""
    w, run, tile = 2, 256, 128
    x = rng.integers(0, 3, size=(w, n), dtype=np.uint32)
    cols = np.concatenate([_np_sorted(x[:, i:i + run])
                           for i in range(0, n, run)], axis=1)
    want = []
    for g0 in range(0, n, tile):
        base = g0 // (2 * run) * (2 * run)
        pair = cols[:, base:base + 2 * run]
        src = (np.arange(pair.shape[1]) >= run).astype(np.uint32)
        order = np.lexsort(np.vstack([src[None], pair[::-1]]))
        want.append(int((src[order][:g0 - base] == 0).sum()))
    got = port.merge_splits(records_to_torch(cols, "cpu"), run, tile)
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.int32))


def test_prefix_args_rejected():
    x = torch.zeros((2, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        port.merge_sort_cols(x, torch.ones(1024, dtype=torch.bool),
                             run=128, n_valid=5)
    with pytest.raises(ValueError, match="tile"):
        port.merge_splits(x, 128, 256)
    with pytest.raises(ValueError, match="run"):
        port.merge_stage(x, 96)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the merge kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,run,n_valid", [
    (4, 4096, 128, None), (25, 1 << 16, 256, None),
    (25, 1 << 18, 1 << 15, None),
    (25, 5 * 256, 256, None),                 # odd number of runs
    (25, 3 * 256 + 64, 256, None),            # short last B run
    (25, 1 << 16, 256, (1 << 14) + 77),       # prefix sort, ragged
    (25, 1 << 18, 1 << 15, 1000)])            # prefix below one run
def test_kernel_matches_plain_on_card(cuda, w, n, run, n_valid):
    gen = torch.Generator(device=cuda).manual_seed(w + n)
    x = torch.randint(-2**31, 2**31 - 1, (w, n), generator=gen,
                      device=cuda, dtype=torch.int64).to(torch.int32)
    x[:, ::7] = x[:, 3:4]
    if n_valid is not None:
        before = port.merge_stage.launches
        got = port.merge_sort_cols(x, run=run, n_valid=n_valid)
        torch.cuda.synchronize()
        stages = max(0, (-(-n_valid // run) - 1).bit_length())
        assert port.merge_stage.launches == before + stages
        assert torch.equal(got, port.merge_sort_cols_plain(x, n_valid))
        return
    cols = torch.cat([port.chunk_sort_cols(x[:, :n // run * run], run),
                      port.chunk_sort_cols(x[:, n // run * run:],
                                           n % run)], 1) if n % run \
        else port.chunk_sort_cols(x, run)
    tile = port.pick_tile(w, run)
    assert torch.equal(port.merge_splits(cols, run, tile),
                       port.merge_splits_plain(cols, run, tile))
    before = port.merge_stage.launches, port.merge_splits.launches
    got = port.merge_stage(cols, run)
    torch.cuda.synchronize()
    assert (port.merge_stage.launches, port.merge_splits.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, port.merge_stage_plain(cols, run))
