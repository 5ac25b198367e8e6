"""groupByKey/cogroup tables: port vs reference on the CPU.

The same seeded records go through ``sparkrdma_tpu.kernels.group`` and
``sparkrdma_tpu_torch.kernels.group``. Both sort stably, so the values
buffer, the CSR groups table, the cogroup table and their counts are
held bit-equal (tolerance 0: integer words): each of the reference's
sort routes (plain, wide, pack) against the port's one sort, at W = 4
and W = 25.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.interop import records_from_torch, records_to_torch
from sparkrdma_tpu_torch.kernels.group import cogroup_tables, group_runs_cols


@pytest.fixture(scope="module")
def ref():
    """The reference's functions, jitted (one compile per shape instead of
    an op-by-op eager run)."""
    import types

    import jax
    import jax.numpy as jnp

    from sparkrdma_tpu.kernels import group

    return jnp, types.SimpleNamespace(
        group_runs_cols=jax.jit(group.group_runs_cols, static_argnums=2,
                                static_argnames=("wide", "ride_words",
                                                 "pack")),
        cogroup_tables=jax.jit(group.cogroup_tables, static_argnums=4))


def _cols(seed, w, n, key_range):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 2**32, size=(w, n), dtype=np.uint32)
    cols[0] = rng.integers(0, 3, size=n)
    cols[1] = rng.integers(0, key_range, size=n)
    return cols


def _valid(seed, n, how):
    if how == "all":
        return np.ones(n, bool)
    if how == "prefix":
        return np.arange(n) < (n * 3) // 5
    return np.random.default_rng(seed + 1).random(n) < 0.6


ROUTES = [dict(), dict(wide=True, ride_words=3), dict(pack=True)]


@pytest.mark.parametrize("w", [4, 25])
@pytest.mark.parametrize("route", ROUTES, ids=["plain", "wide", "pack"])
@pytest.mark.parametrize("how,key_range", [("all", 5), ("prefix", 1 << 30),
                                           ("scattered", 5)])
def test_group_runs_bit_equal(ref, w, route, how, key_range):
    jnp, group = ref
    n = 2048
    cols = _cols(w * 7 + key_range % 97, w, n, key_range)
    valid = _valid(w, n, how)
    rv, rg, rn, rt = group.group_runs_cols(jnp.asarray(cols),
                                           jnp.asarray(valid), 2, **route)
    pv, pg, pn, pt = group_runs_cols(records_to_torch(cols, "cpu"),
                                     torch.from_numpy(valid), 2)
    assert (pn, pt) == (int(rn), int(rt))
    np.testing.assert_array_equal(records_from_torch(pv), np.asarray(rv))
    np.testing.assert_array_equal(records_from_torch(pg), np.asarray(rg))


def test_group_table_contents():
    """The table means what it says: each group's run in the values
    buffer holds exactly its key's valid records."""
    cols = _cols(3, 4, 512, 20)
    valid = _valid(3, 512, "scattered")
    pv, pg, pn, pt = group_runs_cols(records_to_torch(cols, "cpu"),
                                     torch.from_numpy(valid), 2)
    v, g = records_from_torch(pv), records_from_torch(pg)
    assert pt == int(valid.sum())
    keys, counts = np.unique(cols[:2, valid], axis=1, return_counts=True)
    assert pn == keys.shape[1]
    np.testing.assert_array_equal(g[:2, :pn], keys)
    np.testing.assert_array_equal(g[2, :pn], counts)
    for i in range(pn):
        run = v[:, g[3, i]:g[3, i] + g[2, i]]
        assert (run[:2] == keys[:, i:i + 1]).all()
    assert not g[:, pn:].any() and not v[:, pt:].any()


@pytest.mark.parametrize("sizes,overlap", [
    ((512, 512), 0.5), ((300, 700), 0.0), ((300, 700), 1.0),
    ((1024, 64), 0.5), ((512, 512), 1.0)])
def test_cogroup_tables_bit_equal(ref, sizes, overlap):
    jnp, group = ref
    na, nb = sizes
    rng = np.random.default_rng(na + nb)
    a = _cols(na, 4, na, 64)
    b = _cols(nb + 1, 4, nb, 64)
    if overlap < 1.0:
        # shift a share of B's keys out of A's range
        moved = rng.random(nb) >= overlap
        b[1, moved] += 1 << 20
    va, vb = _valid(1, na, "scattered"), _valid(2, nb, "prefix")
    ra = group.group_runs_cols(jnp.asarray(a), jnp.asarray(va), 2)
    rb = group.group_runs_cols(jnp.asarray(b), jnp.asarray(vb), 2)
    rtab, rnu = group.cogroup_tables(ra[1], ra[2], rb[1], rb[2], 2)
    pa = group_runs_cols(records_to_torch(a, "cpu"), torch.from_numpy(va), 2)
    pb = group_runs_cols(records_to_torch(b, "cpu"), torch.from_numpy(vb), 2)
    ptab, pnu = cogroup_tables(pa[1], pa[2], pb[1], pb[2], 2)
    assert pnu == int(rnu)
    np.testing.assert_array_equal(records_from_torch(ptab), np.asarray(rtab))
    ka = {tuple(k) for k in a[:2, va].T.tolist()}
    kb = {tuple(k) for k in b[:2, vb].T.tolist()}
    assert pnu == len(ka | kb)
