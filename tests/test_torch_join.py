"""The hash join: port vs reference on the CPU.

The same seeded partitions go through ``sparkrdma_tpu.workloads.join``'s
local joins and the port's. Match counts and materialized rows are held
bit-equal (integer words, tolerance 0), the overflow contract included;
sums of payload products are float32 prefix sums whose association order
differs between XLA and torch, so they are held to rtol 1e-6, the
reference's own check in ``run_hash_join``.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.interop import records_from_torch, records_to_torch
from sparkrdma_tpu_torch.workloads.join import (_local_join,
                                                _local_join_rows,
                                                _numpy_reference_join,
                                                run_hash_join)

RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    """The reference's local joins, jitted (one compile per shape instead
    of an op-by-op eager run)."""
    import types

    import jax
    import jax.numpy as jnp

    from sparkrdma_tpu.workloads import join

    return jnp, types.SimpleNamespace(
        _local_join=jax.jit(join._local_join, static_argnums=(4, 5)),
        _local_join_rows=jax.jit(join._local_join_rows,
                                 static_argnums=(4, 5, 6, 7, 8),
                                 static_argnames=("pack",)))


def _side(seed, w, cap, total, key_range, sentinel_share=0.0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 2**32, size=(w, cap), dtype=np.uint32)
    cols[1] = rng.integers(0, key_range, size=cap)
    cols[2] = rng.integers(1, 1000, size=cap)
    if sentinel_share:
        # valid records may carry the padding sentinel as their key
        cols[1, rng.random(cap) < sentinel_share] = 0xFFFFFFFF
    return cols, total


CASES = [
    # (cap_a, total_a, cap_b, total_b, key_range, sentinel share)
    (512, 512, 512, 512, 64, 0.0),
    (1024, 700, 512, 300, 40, 0.0),
    (2048, 1999, 1024, 1, 1 << 20, 0.0),
    (512, 400, 512, 450, 16, 0.1),
    (256, 0, 256, 200, 8, 0.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("w", [4, 25])
def test_local_join_count_exact_sum_close(ref, case, w):
    jnp, join = ref
    ca, ta, cb, tb, kr, sent = case
    a, _ = _side(1, w, ca, ta, kr, sent)
    b, _ = _side(2, w, cb, tb, kr, sent)
    rc, rs = join._local_join(jnp.asarray(a), jnp.asarray([ta]),
                              jnp.asarray(b), jnp.asarray([tb]), ca, cb)
    pc, ps = _local_join(records_to_torch(a, "cpu"), ta,
                         records_to_torch(b, "cpu"), tb)
    assert pc == int(rc)
    np.testing.assert_allclose(float(ps), float(rs), rtol=RTOL)
    # and both against float64 numpy on the valid records
    nc, ns = _numpy_reference_join(a[:, :ta].T, b[:, :tb].T)
    assert pc == nc
    np.testing.assert_allclose(float(ps), ns, rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("w,pack", [(4, False), (25, True)])
def test_local_join_rows_bit_equal(ref, case, w, pack):
    jnp, join = ref
    ca, ta, cb, tb, kr, sent = case
    a, _ = _side(3, w, ca, ta, kr, sent)
    b, _ = _side(4, w, cb, tb, kr, sent)
    vw = w - 2
    # the port's one route (a permutation sort at any width) against the
    # reference's full-record route at W=4 and its u64-packed one at W=25
    count = _numpy_reference_join(a[:, :ta].T, b[:, :tb].T)[0]
    # exact fit, and too small (the overflow contract: the true count
    # comes back with the first out_capacity rows); the multiset test
    # below takes a roomy capacity
    for cap in sorted({max(1, count), max(1, count // 3)}):
        rj, rc = join._local_join_rows(
            jnp.asarray(a), jnp.asarray([ta]), jnp.asarray(b),
            jnp.asarray([tb]), cap, 1, 2, vw, vw, pack=pack)
        pj, pc = _local_join_rows(records_to_torch(a, "cpu"), ta,
                                  records_to_torch(b, "cpu"), tb, cap, 1, 2,
                                  vw, vw)
        assert pc == int(rc) == count
        np.testing.assert_array_equal(records_from_torch(pj), np.asarray(rj))


def test_local_join_rows_multiset():
    """The rows are the join: every (A row, B row) pair of equal keys."""
    a, _ = _side(5, 4, 128, 128, 10)
    b, _ = _side(6, 4, 96, 96, 10)
    pj, pc = _local_join_rows(records_to_torch(a, "cpu"), 128,
                              records_to_torch(b, "cpu"), 96, 4096, 1, 2, 2,
                              2)
    got = records_from_torch(pj)[:, :pc].T
    want = np.array([[*ra[:4], *rb[2:4]] for ra in a.T for rb in b.T
                     if ra[1] == rb[1]], dtype=np.uint32)
    assert pc == len(want)
    np.testing.assert_array_equal(np.unique(got, axis=0),
                                  np.unique(want, axis=0))
    assert len(np.unique(got, axis=0)) == len(np.unique(want, axis=0))


@pytest.fixture(scope="module")
def managers():
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    def make(**kw):
        rm = RefManager(conf=RefConf(slot_records=256, **kw))
        pm = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=256, **kw),
                                        8, device="cpu"))
        return rm, pm

    made = [make(), make(val_words=23), make(key_words=1, val_words=3)]
    yield made
    for rm, pm in made:
        rm.stop()
        pm.stop()


@pytest.mark.parametrize("which,kwargs", [
    (0, dict(key_offset_b=1 << 12)), (1, dict()),
    (2, dict(key_range=1 << 8))], ids=["w4-disjoint", "w25", "kw1-dense"])
def test_run_hash_join_matches_reference(managers, which, kwargs):
    from sparkrdma_tpu.workloads.join import run_hash_join as ref_run

    rm, pm = managers[which]
    ref = ref_run(rm, 200, 150, seed=3, **kwargs)
    got = run_hash_join(pm, 200, 150, seed=3, **kwargs)
    assert ref.verified and got.verified
    assert (got.rows_a, got.rows_b, got.matches) == \
        (ref.rows_a, ref.rows_b, ref.matches)
    np.testing.assert_allclose(got.sum_products, ref.sum_products,
                               rtol=RTOL)
    if "key_offset_b" in kwargs:
        assert got.matches == 0 and got.sum_products == 0.0
    assert pm._registry.shuffle_ids() == ()


def test_numpy_reference_join_matches_dictionary_loop():
    """The vectorized reference counts and sums as the reference's loop."""
    from sparkrdma_tpu.workloads.join import \
        _numpy_reference_join as ref_numpy

    rng = np.random.default_rng(9)
    xa = rng.integers(0, 50, size=(400, 4), dtype=np.uint32)
    xb = rng.integers(0, 50, size=(300, 4), dtype=np.uint32)
    xb[:20, 1] = 0xFFFFFFFF
    xa[:5, 1] = 0xFFFFFFFF
    rc, rs = ref_numpy(xa, xb)
    pc, ps = _numpy_reference_join(xa, xb)
    assert pc == rc
    np.testing.assert_allclose(ps, rs, rtol=1e-12)


def test_hash_join_needs_payload():
    pm = ShuffleManager(MeshRuntime(ShuffleConf(val_words=0), 8,
                                    device="cpu"))
    with pytest.raises(ValueError, match="payload"):
        run_hash_join(pm, 8, 8)
    pm.stop()
