"""Port splitter computation vs the reference's on the same samples.

The two samplers draw different indices (``jax.random`` cannot be
reproduced in torch), so the parity is pinned on ``compute_splitters``;
the port's sampler is checked for shape, determinism and provenance.
"""

import numpy as np
import pytest

from sparkrdma_tpu.meta.sampling import compute_splitters as ref_splitters
from sparkrdma_tpu_torch.interop import records_to_torch
from sparkrdma_tpu_torch.meta.sampling import compute_splitters, make_sampler


@pytest.mark.parametrize("num_parts", [1, 2, 8, 16])
@pytest.mark.parametrize("key_words", [1, 2, 3])
def test_compute_splitters_equal(rng, num_parts, key_words):
    s = rng.integers(0, 2**32, size=(8 * 64, key_words), dtype=np.uint32)
    s[:40] = s[40]                                # heavy duplication
    s[40:48, 0] = 0xFFFFFFFF
    got = compute_splitters(s, num_parts)
    want = ref_splitters(s, num_parts)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_compute_splitters_empty_and_bad_shape():
    np.testing.assert_array_equal(
        compute_splitters(np.zeros((0, 2), np.uint32), 8),
        ref_splitters(np.zeros((0, 2), np.uint32), 8))
    with pytest.raises(ValueError):
        compute_splitters(np.zeros(4, np.uint32), 2)


def test_sampler_draws_from_each_partition(rng):
    d, n, spd = 8, 100, 16
    x = rng.integers(0, 2**32, size=(3, d * n), dtype=np.uint32)
    sample = make_sampler(d, 2, spd, seed=5)(records_to_torch(x, "cpu"))
    assert sample.shape == (d * spd, 2) and sample.dtype == np.uint32
    for p in range(d):
        keys = {tuple(r) for r in x[:2, p * n:(p + 1) * n].T.tolist()}
        assert all(tuple(r) in keys
                   for r in sample[p * spd:(p + 1) * spd].tolist())
    again = make_sampler(d, 2, spd, seed=5)(records_to_torch(x, "cpu"))
    np.testing.assert_array_equal(sample, again)
