"""``kernels/aggregate.py``: port vs reference, bit-exact.

Both packages get the same numpy inputs made from a seed; every output
must match to the bit (tolerance 0), float32 sums included: the port
mirrors the reference's scan tree, and IEEE adds are exact. The float
inputs hold no NaN (its payload bits are unspecified) and no denormals
(XLA on the CPU may flush them); signed zeros are included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.kernels import aggregate as ref
from sparkrdma_tpu_torch.kernels import aggregate as port

LENGTHS = (1, 2, 3, 7, 64, 1000)


def _u32(rng, shape, hi=2**32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _floats(rng, shape):
    """float32 bits: normal values of mixed sign and scale, and zeros of
    both signs."""
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape))
    x = x.astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.05] = -0.0
    return x.view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t):
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("op,floating", [("sum", False), ("min", False),
                                         ("max", False), ("sum", True),
                                         ("min", True), ("max", True)])
def test_segmented_scan_matches_reference(rng, n, op, floating):
    vals = _floats(rng, (3, n)) if floating else _u32(rng, (3, n))
    if not floating:
        vals[0] |= np.uint32(1 << 31)            # words >= 2^31
    first = rng.random(n) < 0.3
    ref_op = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    jv = jnp.asarray(vals.view(np.float32) if floating else vals)
    scan = jax.jit(ref._segmented_scan, static_argnums=2)
    want = np.asarray(scan(jv, jnp.asarray(first), ref_op))
    tv = _t(vals).view(torch.float32) if floating else _t(vals)
    got = port._segmented_scan(tv, torch.from_numpy(first), op)
    got = got.view(torch.int32) if floating else got
    np.testing.assert_array_equal(_np(got), want.view(np.uint32))


def _keyed(rng, n, w, key_words, distinct, floating):
    cols = _u32(rng, (w, n))
    cols[:key_words] = rng.integers(0, distinct, size=(key_words, n))
    cols[0, ::5] |= np.uint32(1 << 31)           # unsigned key order
    if floating:
        cols[key_words:] = _floats(rng, (w - key_words, n))
    return cols


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("floating", [False, True])
@pytest.mark.parametrize("n,distinct", [(1, 3), (2, 1), (257, 5),
                                        (1000, 40), (1000, 1000)])
def test_combine_by_key_cols_matches_reference(rng, op, floating, n,
                                               distinct):
    cols = _keyed(rng, n, 5, 2, distinct, floating)
    valid = rng.random(n) < 0.8
    want, wu = jax.jit(ref.combine_by_key_cols, static_argnums=(2, 3, 4))(
        jnp.asarray(cols), jnp.asarray(valid), 2, op, floating)
    got, gu = port.combine_by_key_cols(_t(cols), torch.from_numpy(valid), 2,
                                       op, floating)
    assert gu == int(wu)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("op,floating", [("sum", False), ("max", False),
                                         ("sum", True)])
@pytest.mark.parametrize("num_parts", [1, 8])
def test_map_side_combine_cols_matches_reference(rng, op, floating,
                                                 num_parts):
    """Ids of rows a filter dropped carry the sentinel ``num_parts``;
    some ids are far out of range too. Neither reaches the output."""
    n = 600
    recs = _keyed(rng, n, 4, 2, 30, floating)
    pids = rng.integers(0, num_parts, size=n)
    pids[rng.random(n) < 0.2] = num_parts
    pids[::97] = 1000
    want, wp, wu = jax.jit(ref.map_side_combine_cols,
                           static_argnums=(2, 3, 4, 5))(
        jnp.asarray(recs), jnp.asarray(pids.astype(np.int32)), num_parts, 2,
        op, floating)
    got, gp, gu = port.map_side_combine_cols(
        _t(recs), torch.from_numpy(pids), num_parts, 2, op, floating)
    assert gu == int(wu)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert (np.diff(gp.numpy()) >= 0).all()


def test_count_by_key_matches_reference(rng):
    rows = _u32(rng, (500, 4))
    rows[:, :2] = rng.integers(0, 7, size=(500, 2))
    valid = rng.random(500) < 0.9
    want, wu = jax.jit(ref.count_by_key, static_argnums=2)(
        jnp.asarray(rows), jnp.asarray(valid), 2)
    got, gu = port.count_by_key(_t(rows), torch.from_numpy(valid), 2)
    assert gu == int(wu)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_combine_by_key_rows_matches_reference(rng):
    rows = _keyed(rng, 300, 3, 1, 9, True).T.copy()
    valid = np.ones(300, bool)
    want, wu = jax.jit(ref.combine_by_key, static_argnums=(2, 3, 4))(
        jnp.asarray(rows), jnp.asarray(valid), 1, "sum", True)
    got, gu = port.combine_by_key(_t(rows), torch.from_numpy(valid), 1,
                                  "sum", True)
    assert gu == int(wu)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_unknown_op_refused():
    with pytest.raises(ValueError, match="unsupported op"):
        port.combine_by_key_cols(torch.zeros((3, 4), dtype=torch.int32),
                                 torch.ones(4, dtype=torch.bool), 2, "avg")
