"""ALS: port vs reference on the CPU.

The ratings are those of ``tests/test_als.py`` (low-rank ground truth
plus noise, unique (user, item) pairs). Each half-step's records (plain
float32 products) and its exchange output — the summed partial normal
equations, a ``reduce_by_key`` over float32 payloads — are held
bit-equal to the reference's for the same factors (tolerance 0: the
port mirrors the reference's scan tree). The factors after the solves
agree only to a tolerance, because ``torch.linalg.solve`` is not
``jnp.linalg.solve``: port against reference at rtol 1e-3, atol 1e-5
(the largest difference seen at these sizes is ~8e-5 relative), and
each against ``_numpy_als`` at the reference's own rtol 2e-3, atol 2e-4.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.workloads.als import (_ALS, _numpy_als,
                                               _owner_layout, run_als)

RTOL, ATOL = 1e-3, 1e-5


def _random_ratings(rng, num_users, num_items, n, rank=3):
    u_true = rng.standard_normal((num_users, rank))
    v_true = rng.standard_normal((num_items, rank))
    pairs = rng.choice(num_users * num_items, size=n, replace=False)
    uu, ii = pairs // num_items, pairs % num_items
    rr = np.sum(u_true[uu] * v_true[ii], axis=1) \
        + 0.01 * rng.standard_normal(n)
    return np.stack([uu, ii, rr], axis=1)


@pytest.fixture(scope="module")
def runtimes():
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf

    def make(**kw):
        return (RefRuntime(RefConf(slot_records=128, **kw)),
                MeshRuntime(ShuffleConf(slot_records=128, **kw), 8,
                            device="cpu"))

    made = {c: make(map_side_combine=c) for c in ("auto", "on", "off")}
    yield made
    for ref, port in made.values():
        ref.stop()
        port.stop()


def _reference_half_steps(rt, ratings, nu, ni, k, factors_by_step):
    """The reference's records and exchange output of each half-step,
    built as its ``run_als`` builds them, from the given owner-layout
    factors (``{"users": V, "items": U}``)."""
    from sparkrdma_tpu.exchange.partitioners import modulo_partitioner
    from sparkrdma_tpu.exchange.protocol import ShuffleExchange
    from sparkrdma_tpu.workloads import als

    mesh = rt.num_partitions
    conf = rt.conf.replace(val_words=k + k * (k + 1) // 2)
    ex = ShuffleExchange(rt.mesh, rt.axis_name, conf)
    part = modulo_partitioner(mesh, key_word=1)
    w = conf.record_words
    build = als._make_build_fn(rt, k, w)
    res = {}
    for step, owner_col, dst_col, src_col in (("users", 1, 0, 1),
                                              ("items", 0, 1, 0)):
        tab, mask = als._edge_tables(ratings, owner_col, mesh)
        e = tab.shape[1]
        base = np.zeros((mesh * e, w), dtype=np.uint32)
        base[:, 1] = tab[:, :, dst_col].reshape(-1).astype(np.uint32)
        srcidx = (tab[:, :, src_col].reshape(-1).astype(np.int64)
                  // mesh).astype(np.int32)
        args = (rt.shard_records(base), rt.shard_rows(srcidx[:, None]),
                rt.shard_rows(tab[:, :, 2].reshape(-1, 1).astype(
                    np.float32)),
                rt.shard_rows(mask.reshape(-1, 1)))
        plan = ex.plan(args[0], part, mesh)
        rec = build(rt.shard_rows(factors_by_step[step]), *args)
        out, totals, _ = ex.exchange(rec, part, plan, mesh, aggregator="sum",
                                     float_payload=True)
        res[step] = (np.asarray(rec), np.asarray(out), np.asarray(totals),
                     dict(ex.wire_stats()))
    return res


@pytest.mark.parametrize("combine,shape", [
    ("on", (40, 24, 300)), ("off", (40, 24, 300)), ("auto", (13, 9, 80))],
    ids=["on", "off", "auto-uneven"])
def test_half_step_exchange_bit_equal(runtimes, combine, shape):
    ref_rt, port_rt = runtimes[combine]
    nu, ni, n = shape
    k, mesh = 4, 8
    rng = np.random.default_rng(n)
    ratings = _random_ratings(rng, nu, ni, n)
    als = _ALS(port_rt, ratings, nu, ni, k, 0.1)
    factors = {
        "users": rng.standard_normal((als.iper * mesh, k)).astype(np.float32),
        "items": rng.standard_normal((als.uper * mesh, k)).astype(np.float32)}
    owner = {s: _owner_layout(f, mesh) for s, f in factors.items()}
    ref = _reference_half_steps(ref_rt, ratings, nu, ni, k, owner)
    for step, hs in (("users", als.users), ("items", als.items)):
        f = torch.from_numpy(owner[step]).reshape(mesh, -1, k)
        rec = als.build(f, hs)
        out, totals = als.exchange(rec, hs)
        r_rec, r_out, r_tot, r_wire = ref[step]
        np.testing.assert_array_equal(records_from_torch(rec), r_rec)
        np.testing.assert_array_equal(records_from_torch(out), r_out)
        assert totals.tolist() == r_tot.tolist()
        assert als.ex.reference_wire_stats() == r_wire


@pytest.mark.parametrize("shape,iters", [((40, 24, 300), 3),
                                         ((13, 9, 80), 2)],
                         ids=["even", "uneven"])
def test_factors_match_reference(runtimes, shape, iters):
    from sparkrdma_tpu.workloads.als import run_als as ref_run

    ref_rt, port_rt = runtimes["auto"]
    nu, ni, n = shape
    ratings = _random_ratings(np.random.default_rng(0), nu, ni, n)
    ref = ref_run(ref_rt, ratings, nu, ni, rank=4, iterations=iters)
    got = run_als(port_rt, ratings, nu, ni, rank=4, iterations=iters)
    assert ref.verified and got.verified
    np.testing.assert_allclose(got.user_factors, ref.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors, ref.item_factors,
                               rtol=RTOL, atol=ATOL)
    assert abs(got.rmse - ref.rmse) <= 1e-4 * max(1.0, ref.rmse)
    assert set(got.wire) == {"users", "items"}


def test_cold_users(runtimes):
    """A user with no ratings gets the pure-regularization solution."""
    _, port_rt = runtimes["auto"]
    ratings = _random_ratings(np.random.default_rng(1), 8, 8, 30)
    ratings = ratings[ratings[:, 0] != 5]
    res = run_als(port_rt, ratings, 8, 8, rank=3, iterations=2)
    assert res.verified
    assert np.allclose(res.user_factors[5], 0.0, atol=1e-6)


def test_rmse_decreases(runtimes):
    _, port_rt = runtimes["on"]
    ratings = _random_ratings(np.random.default_rng(2), 32, 32, 400)
    r1 = run_als(port_rt, ratings, 32, 32, rank=4, iterations=1,
                 verify=False)
    r5 = run_als(port_rt, ratings, 32, 32, rank=4, iterations=6,
                 verify=False)
    assert r5.rmse < r1.rmse and r5.rmse < 0.5


def test_numpy_als_matches_reference():
    """The port's host reference sums in rating order, as the reference's
    ``np.add.at`` does; the two agree to float32 rounding."""
    from sparkrdma_tpu.workloads.als import _numpy_als as ref_numpy

    ratings = _random_ratings(np.random.default_rng(3), 40, 24, 300)
    ratings = ratings[ratings[:, 1] != 7]           # an item nobody rated
    v0 = np.random.default_rng(4).standard_normal((24, 4)).astype(
        np.float32) * 0.1
    for want, got in zip(ref_numpy(ratings, 40, 24, 4, 3, 0.1, v0),
                         _numpy_als(ratings, 40, 24, 4, 3, 0.1, v0)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_shard_rows():
    rt = MeshRuntime(ShuffleConf(), 8, device="cpu")
    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    t = rt.shard_rows(x)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x)
    with pytest.raises(ValueError, match="multiple of 8"):
        rt.shard_rows(x[:12])
