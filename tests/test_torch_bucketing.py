"""Port bucketing/slot/compaction vs ``sparkrdma_tpu.kernels.bucketing``,
bit-exact (tolerance 0) on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.kernels import bucketing as ref
from sparkrdma_tpu_torch.interop import records_from_torch, records_to_torch
from sparkrdma_tpu_torch.kernels import bucketing as port


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dtype)


def _skewed(rng, n, num_parts, w=4):
    x = rng.integers(0, 2**32, size=(w, n), dtype=np.uint32)
    pids = rng.integers(0, num_parts, size=n).astype(np.int32)
    pids[: n // 3] = num_parts - 1           # a hot partition
    return x, pids


@pytest.mark.parametrize("num_parts", [1, 8, 40])
def test_histogram_pids(rng, num_parts):
    pids = rng.integers(-2, num_parts + 3, size=500).astype(np.int32)
    want = np.asarray(ref.histogram_pids(jnp.asarray(pids), num_parts))
    got = port.histogram_pids(_t(pids), num_parts).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_parts", [1, 8, 16])
def test_bucket_records(rng, num_parts):
    x, pids = _skewed(rng, 300, num_parts)
    b_r, c_r, o_r = ref.bucket_records(jnp.asarray(x), jnp.asarray(pids),
                                       num_parts)
    b_p, c_p, o_p = port.bucket_records(records_to_torch(x, "cpu"),
                                        _t(pids), num_parts)
    np.testing.assert_array_equal(records_from_torch(b_p), np.asarray(b_r))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_r))


def _bucketed(rng, num_parts, n=300):
    x, pids = _skewed(rng, n, num_parts)
    b, c, o = ref.bucket_records(jnp.asarray(x), jnp.asarray(pids),
                                 num_parts)
    return (b, c, o), (records_to_torch(np.asarray(b), "cpu"),
                       _t(np.asarray(c)), _t(np.asarray(o)))


@pytest.mark.parametrize("round_idx", [0, 1, 3])
@pytest.mark.parametrize("num_parts,capacity", [(8, 16), (20, 8)])
def test_fill_round_slots(rng, round_idx, num_parts, capacity):
    (b, c, o), (bp, cp, op) = _bucketed(rng, num_parts)
    s_r, n_r = ref.fill_round_slots(b, c, o, num_parts, capacity, round_idx)
    s_p, n_p = port.fill_round_slots(bp, cp, op, num_parts, capacity,
                                     round_idx)
    np.testing.assert_array_equal(records_from_torch(s_p), np.asarray(s_r))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))


@pytest.mark.parametrize("round_idx", [0, 2])
@pytest.mark.parametrize("num_parts,mesh", [(8, 8), (16, 8), (20, 4)])
def test_fill_round_slots_dest_major(rng, round_idx, num_parts, mesh):
    (b, c, o), (bp, cp, op) = _bucketed(rng, num_parts)
    s_r, n_r = ref.fill_round_slots_dest_major(b, c, o, num_parts, mesh, 16,
                                               round_idx)
    s_p, n_p = port.fill_round_slots_dest_major(bp, cp, op, num_parts, mesh,
                                                16, round_idx)
    np.testing.assert_array_equal(records_from_torch(s_p), np.asarray(s_r))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))
    # writing into a zeroed strided view gives the same bytes
    buf = torch.zeros((mesh, num_parts // mesh, 4, 17), dtype=torch.int32)
    port.fill_round_slots_dest_major(bp, cp, op, num_parts, mesh, 16,
                                     round_idx, out=buf[..., 1:])
    np.testing.assert_array_equal(records_from_torch(buf[..., 1:]),
                                  np.asarray(s_r))
    assert not buf[..., 0].any()


@pytest.mark.parametrize("seg_counts,out_capacity", [
    ([5, 0, 16, 3, 9, 16, 0, 1], 64),      # fits, with empty segments
    ([16] * 8, 128),                       # exactly full
    ([16, 16, 12, 16, 16, 16, 3, 9], 64),  # overflow: total > capacity
    ([0] * 8, 32),
])
def test_compact_segments(rng, seg_counts, out_capacity):
    c = 16
    stream = rng.integers(1, 2**32, size=(3, 8 * c), dtype=np.uint32)
    for i, k in enumerate(seg_counts):        # prefix-valid, zero tail
        stream[:, i * c + k:(i + 1) * c] = 0
    p_r, t_r = ref.compact_segments(jnp.asarray(stream),
                                    jnp.asarray(seg_counts, jnp.int32),
                                    out_capacity)
    p_p, t_p = port.compact_segments(records_to_torch(stream, "cpu"),
                                     _t(seg_counts), out_capacity)
    np.testing.assert_array_equal(records_from_torch(p_p), np.asarray(p_r))
    assert t_p == int(t_r)
