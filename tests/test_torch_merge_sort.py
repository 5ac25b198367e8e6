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


@pytest.mark.parametrize("w,expected", [(4, 512), (25, 512), (200, 256)])
def test_tile_fits_shared_memory(w, expected):
    assert port.pick_tile(w, 1 << 15) == expected
    assert port.pick_tile(w, 128) == 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the merge kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,run", [(4, 4096, 128), (25, 1 << 16, 256),
                                     (25, 1 << 18, 1 << 15)])
def test_kernel_matches_plain_on_card(cuda, w, n, run):
    gen = torch.Generator(device=cuda).manual_seed(w + n)
    x = torch.randint(-2**31, 2**31 - 1, (w, n), generator=gen,
                      device=cuda, dtype=torch.int64).to(torch.int32)
    x[:, ::7] = x[:, 3:4]
    cols = port.chunk_sort_cols(x, run)
    before = port.merge_stage.launches
    got = port.merge_stage(cols, run)
    torch.cuda.synchronize()
    assert port.merge_stage.launches == before + 1
    assert torch.equal(got, port.merge_stage_plain(cols, run))
