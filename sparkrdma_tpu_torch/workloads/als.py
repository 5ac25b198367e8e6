"""ALS collaborative filtering — the iterative factor shuffle
(``BASELINE.md`` config 4, "MLlib ALS on MovieLens-20M").

Counterpart of ``sparkrdma_tpu.workloads.als``. User ``u`` is owned by
stacked partition ``u % D`` and item ``i`` by ``i % D``; the ratings are
held twice, grouped by item owner (for the user half-step) and by user
owner (for the item half-step). Each half-step builds one record per
rating on the owner of the factor it reads: key ``(0, dst entity)``,
payload the float32 bits of the PARTIAL normal equations ``[r·f (k),
upper-tri(f fᵀ) (k(k+1)/2)]``. The exchange runs as a
``reduce_by_key`` (``aggregator="sum"``, ``float_payload=True``, with the
map-side combine gate of ``conf.map_side_combine``), so each owner
receives one summed ``(A, b)`` per entity and solves the batched k×k
systems ``(A + λI) x = b`` with ``torch.linalg.solve``. The rating graph
is static, so both exchange plans are made once.

The exchange output is bit-equal to the reference's for the same
factors (the float sums mirror its scan tree, and the partials are
plain products). The factors agree only to a tolerance, because
``torch.linalg.solve`` is not ``jnp.linalg.solve``. Under a job trace
each half-step is a stage (``update_users`` / ``update_items``, attempt
= the iteration), as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange, ShufflePlan
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.runtime.distributed import refuse_across_processes
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime
from sparkrdma_tpu_torch.utils.stats import barrier


@dataclasses.dataclass
class ALSResult:
    num_users: int
    num_items: int
    num_ratings: int
    rank: int
    iterations: int
    user_factors: np.ndarray      # [U, k]
    item_factors: np.ndarray      # [I, k]
    rmse: float
    total_s: float
    per_iter_s: float
    verified: Optional[bool] = None
    #: ``ShuffleExchange.wire_stats()`` of the last iteration's half-steps,
    #: under ``"users"`` and ``"items"``
    wire: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _owner_layout(x: np.ndarray, mesh: int) -> np.ndarray:
    """Dense ``[Npad, k]`` -> owner-major ``[mesh * per, k]``: partition
    ``d`` gets rows ``d, d+mesh, ...``."""
    npad, k = x.shape
    per = npad // mesh
    return x.reshape(per, mesh, k).transpose(1, 0, 2).reshape(mesh * per, k)


def _from_owner_layout(x: np.ndarray, mesh: int, n: int) -> np.ndarray:
    per = x.shape[0] // mesh
    return x.reshape(mesh, per, -1).transpose(1, 0, 2).reshape(
        mesh * per, -1)[:n]


def _edge_tables(ratings: np.ndarray, owner_col: int, mesh: int):
    """Ratings grouped by the owner of ``owner_col`` into per-partition
    padded tables: ``(table [mesh, epad, 3] (u, i, r), mask [mesh,
    epad])``."""
    owner = ratings[:, owner_col].astype(np.int64) % mesh
    # a stable sort of the narrowest type the owners fit is numpy's
    # radix sort: the same order, several times faster
    order = np.argsort(owner.astype(np.min_scalar_type(mesh - 1)),
                       kind="stable")
    r_sorted = ratings[order]
    counts = np.bincount(owner, minlength=mesh)
    epad = max(1, int(counts.max()))
    tab = np.zeros((mesh, epad, 3), dtype=np.float64)
    mask = np.zeros((mesh, epad), dtype=bool)
    off = 0
    for d in range(mesh):
        c = int(counts[d])
        tab[d, :c] = r_sorted[off:off + c]
        mask[d, :c] = True
        off += c
    return tab, mask


@dataclasses.dataclass
class _HalfStep:
    """The static side of one half-step: the records' keys (word 1 the
    destination entity), where each rating reads its source factor, the
    ratings, and the plan."""

    records: torch.Tensor       # int32 [w, mesh * epad]
    src_idx: torch.Tensor       # int64 [mesh, epad] source's local index
    rating: torch.Tensor        # float32 [mesh, epad]
    mask: torch.Tensor          # bool [mesh, epad]
    plan: ShufflePlan
    per: int                    # destination entities per partition


class _ALS:
    """Both half-steps of one ALS run over one exchange."""

    def __init__(self, runtime: MeshRuntime, ratings: np.ndarray,
                 num_users: int, num_items: int, rank: int, lam: float,
                 slot_records: Optional[int] = None,
                 map_side_combine: Optional[str] = None):
        mesh = runtime.num_partitions
        k = rank
        conf = runtime.conf.replace(val_words=k + k * (k + 1) // 2)
        if slot_records is not None:
            conf = conf.replace(slot_records=slot_records)
        if map_side_combine is not None:
            conf = conf.replace(map_side_combine=map_side_combine)
        self.runtime, self.mesh, self.k, self.lam = runtime, mesh, k, lam
        self.w = conf.record_words
        self.ex = ShuffleExchange(runtime, conf)
        self.part = modulo_partitioner(mesh, key_word=1)
        dev = runtime.device
        tri_i, tri_j = np.triu_indices(k)
        self.tri_i = torch.from_numpy(tri_i).to(dev)
        self.tri_j = torch.from_numpy(tri_j).to(dev)
        self.eye = torch.eye(k, dtype=torch.float32, device=dev)
        self.uper = _pad_to(num_users, mesh) // mesh
        self.iper = _pad_to(num_items, mesh) // mesh
        # user step: records built on ITEM owners, dst key = user id;
        # item step: records built on USER owners, dst key = item id
        self.users = self._prep(*_edge_tables(ratings, 1, mesh), 0, 1,
                                self.uper)
        self.items = self._prep(*_edge_tables(ratings, 0, mesh), 1, 0,
                                self.iper)

    def _prep(self, tab, mask, dst_col, src_col, per) -> _HalfStep:
        rt, mesh = self.runtime, self.mesh
        # the records' static part, columnar: word 1 the destination
        # entity, every other word zero until a build writes the payload
        records = torch.zeros((self.w, tab.shape[0] * tab.shape[1]),
                              dtype=torch.int32, device=rt.device)
        records[1] = rt.shard_rows(
            tab[:, :, dst_col].reshape(-1).astype(np.int32))
        src = (tab[:, :, src_col].astype(np.int64) // mesh)
        return _HalfStep(
            records=records,
            src_idx=rt.shard_rows(src),
            rating=rt.shard_rows(tab[:, :, 2].astype(np.float32)),
            mask=rt.shard_rows(mask),
            plan=self.ex.plan(records, self.part, mesh),
            per=per)

    def build(self, factors: torch.Tensor, hs: _HalfStep) -> torch.Tensor:
        """The half-step's records: its static keys, payload the partial
        normal equations of each rating from the source factors
        ``[mesh, per_src, k]`` (owner layout)."""
        mesh = self.mesh
        rows = torch.arange(mesh, device=factors.device)[:, None]
        f = torch.where(hs.mask[..., None], factors[rows, hs.src_idx], 0.0)
        r = torch.where(hs.mask, hs.rating, 0.0)
        b_p = r[..., None] * f                                # [D, E, k]
        a_p = f[..., self.tri_i] * f[..., self.tri_j]         # [D, E, ntri]
        payload = torch.cat([b_p, a_p], dim=-1).view(torch.int32)
        rec = hs.records.clone()
        rec[2:] = payload.reshape(-1, payload.shape[-1]).T
        return rec

    def exchange(self, rec: torch.Tensor, hs: _HalfStep):
        """The half-step's shuffle: ``(out, totals)`` of the summed
        partials, one row per destination entity owned."""
        out, totals, _ = self.ex.exchange(rec, self.part, hs.plan, self.mesh,
                                          aggregator="sum",
                                          float_payload=True)
        return out, totals

    def update(self, out: torch.Tensor, totals: torch.Tensor,
               hs: _HalfStep) -> torch.Tensor:
        """Solved factors ``[mesh, per, k]`` of the owned entities: each
        entity's summed partials are added into its owner slot (the dead
        rows into one spare slot per partition, cut off), the upper
        triangle is mirrored, and one batched solve runs."""
        k, mesh, per = self.k, self.mesh, hs.per
        dev = out.device
        oc = hs.plan.out_capacity
        ntri = k * (k + 1) // 2
        o = out.reshape(out.shape[0], mesh, oc)
        live = (torch.arange(oc, device=dev)[None, :]
                < totals.to(torch.int64)[:, None])
        slot = torch.where(live, as_unsigned(o[1]) // mesh, per) \
            + torch.arange(mesh, device=dev)[:, None] * (per + 1)
        fr = o[2:2 + k + ntri].view(torch.float32)
        fr = torch.where(live[None], fr, 0.0).permute(1, 2, 0)
        acc = torch.zeros((mesh * (per + 1), k + ntri), dtype=torch.float32,
                          device=dev).index_add_(
            0, slot.reshape(-1), fr.reshape(-1, k + ntri))
        acc = acc.reshape(mesh, per + 1, k + ntri)[:, :per]
        b, a_tri = acc[..., :k], acc[..., k:]
        a = torch.zeros((mesh, per, k, k), dtype=torch.float32, device=dev)
        a[..., self.tri_i, self.tri_j] = a_tri
        a[..., self.tri_j, self.tri_i] = a_tri
        a = a + self.lam * self.eye
        return torch.linalg.solve(a, b[..., None])[..., 0]


def run_als(
    runtime: MeshRuntime,
    ratings: np.ndarray,          # [N, 3] columns (user, item, rating)
    num_users: int,
    num_items: int,
    rank: int = 8,
    iterations: int = 5,
    lam: float = 0.1,
    seed: int = 0,
    verify: bool = True,
    slot_records: Optional[int] = None,
    map_side_combine: Optional[str] = None,
) -> ALSResult:
    """ALS with a map-side-combined partial-sum exchange per half-step.
    ``slot_records`` and ``map_side_combine`` ("on"/"off") override the
    runtime's configuration. The initial item factors are the reference's
    for the same ``seed``."""
    refuse_across_processes(runtime, "run_als",
                            "sparkrdma_tpu/workloads/als.py:272")
    mesh = runtime.num_partitions
    k = rank
    ratings = np.asarray(ratings, dtype=np.float64)
    als = _ALS(runtime, ratings, num_users, num_items, k, lam,
               slot_records=slot_records, map_side_combine=map_side_combine)
    dev = runtime.device

    rng = np.random.default_rng(seed)
    v0 = np.zeros((als.iper * mesh, k), np.float32)
    v0[:num_items] = rng.standard_normal((num_items, k),
                                         dtype=np.float32) * 0.1
    V = runtime.shard_rows(_owner_layout(v0, mesh)).reshape(mesh, als.iper, k)
    U = torch.zeros((mesh, als.uper, k), dtype=torch.float32, device=dev)

    wire: Dict[str, Dict[str, float]] = {}
    t0 = time.perf_counter()
    for it in range(iterations):
        # one job-trace stage per half-step (a no-op outside a job): the
        # exchange here has no journal, so the stage's wall-clock comes
        # from the job's clock, not from spans
        with _trace.stage("update_users", attempt=it):
            out, totals = als.exchange(als.build(V, als.users), als.users)
            wire["users"] = dict(als.ex.wire_stats())
            U = als.update(out, totals, als.users)
        with _trace.stage("update_items", attempt=it):
            out, totals = als.exchange(als.build(U, als.items), als.items)
            wire["items"] = dict(als.ex.wire_stats())
            V = als.update(out, totals, als.items)
            del out
            barrier(V)          # each iteration is a stage boundary
    total_s = time.perf_counter() - t0

    u_np = _from_owner_layout(U.reshape(-1, k).cpu().numpy(), mesh,
                              num_users)
    v_np = _from_owner_layout(V.reshape(-1, k).cpu().numpy(), mesh,
                              num_items)
    uu = ratings[:, 0].astype(np.int64)
    ii = ratings[:, 1].astype(np.int64)
    pred = np.sum(u_np[uu] * v_np[ii], axis=1)
    rmse = float(np.sqrt(np.mean((pred - ratings[:, 2]) ** 2)))

    verified = None
    if verify:
        u_ref, v_ref = _numpy_als(ratings, num_users, num_items, k,
                                  iterations, lam, v0[:num_items])
        verified = bool(
            np.allclose(u_np, u_ref, rtol=2e-3, atol=2e-4)
            and np.allclose(v_np, v_ref, rtol=2e-3, atol=2e-4))
    return ALSResult(
        num_users=num_users, num_items=num_items,
        num_ratings=ratings.shape[0], rank=k, iterations=iterations,
        user_factors=u_np, item_factors=v_np, rmse=rmse, total_s=total_s,
        per_iter_s=total_s / max(iterations, 1), verified=verified,
        wire=wire)


def _numpy_als(ratings, num_users, num_items, k, iterations, lam, v0):
    """Float32 host reference with the same update math. Each side's
    normal equations ``A = Σ f fᵀ`` and ``b = Σ r f`` over an entity's
    ratings are sparse products: the entity-by-source count and rating
    matrices times the sources' outer products and factors, summed in
    float64 (the reference sums with ``np.add.at`` in float32; this is
    the same math, at chip scale in seconds), then solved in float32."""
    from scipy import sparse

    uu = ratings[:, 0].astype(np.int64)
    ii = ratings[:, 1].astype(np.int64)
    rr = ratings[:, 2].astype(np.float32).astype(np.float64)
    tri_i, tri_j = np.triu_indices(k)
    shape = (num_users, num_items)
    ones = np.ones(len(uu))
    # duplicate (user, item) pairs add up, as each rating adds its own
    # f fᵀ and r f
    count = sparse.csr_matrix((ones, (uu, ii)), shape=shape)
    rating = sparse.csr_matrix((rr, (uu, ii)), shape=shape)
    by_user = (count, rating)
    by_item = (count.T.tocsr(), rating.T.tocsr())

    def solve_side(side, src_f):
        f = src_f.astype(np.float64)
        a_tri = (side[0] @ (f[:, tri_i] * f[:, tri_j])).astype(np.float32)
        b = (side[1] @ f).astype(np.float32)
        A = np.zeros((b.shape[0], k, k), np.float32)
        A[:, tri_i, tri_j] = a_tri
        A[:, tri_j, tri_i] = a_tri
        A += lam * np.eye(k, dtype=np.float32)[None]
        return np.linalg.solve(A, b[:, :, None])[:, :, 0]

    V = v0.astype(np.float32).copy()
    U = np.zeros((num_users, k), np.float32)
    for _ in range(iterations):
        U = solve_side(by_user, V)
        V = solve_side(by_item, U)
    return U, V


__all__ = ["run_als", "ALSResult"]
