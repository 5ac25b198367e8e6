"""Port partitioners vs the reference's, bit-exact (tolerance 0).

Random keys and the edge keys that break unsigned comparison or the
hash's wrap-around: all-ones words, zeros, and keys equal to splitters.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparkrdma_tpu.exchange import partitioners as ref
from sparkrdma_tpu_torch.exchange import partitioners as port
from sparkrdma_tpu_torch.interop import records_to_torch


def _records(rng, n, w, splitters=None):
    x = rng.integers(0, 2**32, size=(w, n), dtype=np.uint32)
    x[:, :8] = 0xFFFFFFFF                       # all-ones keys
    x[:, 8:16] = 0                              # zero keys
    x[0, 16:24] = 0x80000000                    # sign bit of int32 views
    x[1, 16:24] = 0x7FFFFFFF
    if splitters is not None:                   # keys equal to splitters
        k = splitters.shape[0]
        x[:splitters.shape[1], 24:24 + k] = splitters.T
    return x


def _same(part_ref, part_port, x):
    want = np.asarray(part_ref(jnp.asarray(x)))
    got = part_port(records_to_torch(x, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_parts", [2, 8, 16])
@pytest.mark.parametrize("key_words", [1, 2, 3])
def test_range_partitioner(rng, num_parts, key_words):
    spl = np.sort(rng.integers(0, 2**32, size=(num_parts - 1, key_words),
                               dtype=np.uint32), axis=0)
    spl[0] = [0x80000000] + [0] * (key_words - 1)
    spl = spl[np.lexsort(spl.T[::-1])]
    x = _records(rng, 512, key_words + 2, spl)
    _same(ref.range_partitioner(spl, key_words),
          port.range_partitioner(spl, key_words), x)


def test_range_partitioner_single_partition(rng):
    x = _records(rng, 64, 4)
    spl = np.zeros((0, 2), np.uint32)
    _same(ref.range_partitioner(spl), port.range_partitioner(spl), x)


@pytest.mark.parametrize("num_parts", [1, 7, 8, 256])
@pytest.mark.parametrize("key_words", [1, 2])
def test_hash_partitioner(rng, num_parts, key_words):
    x = _records(rng, 512, 4)
    _same(ref.hash_partitioner(num_parts, key_words),
          port.hash_partitioner(num_parts, key_words), x)


@pytest.mark.parametrize("num_parts", [3, 8])
@pytest.mark.parametrize("key_word", [0, 1])
def test_modulo_partitioner(rng, num_parts, key_word):
    x = _records(rng, 256, 4)
    _same(ref.modulo_partitioner(num_parts, key_word),
          port.modulo_partitioner(num_parts, key_word), x)


def test_cache_keys_match_reference():
    spl = np.arange(14, dtype=np.uint32).reshape(7, 2)
    assert port.range_partitioner(spl).cache_key == \
        ref.range_partitioner(spl).cache_key
    assert port.hash_partitioner(8).cache_key == \
        ref.hash_partitioner(8).cache_key
