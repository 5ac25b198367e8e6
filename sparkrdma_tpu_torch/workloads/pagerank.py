"""PageRank — the iterative aggregation workload (BASELINE.md config 5).

Counterpart of ``sparkrdma_tpu.workloads.pagerank``. Vertex ``v`` is
owned by stacked partition ``v % D`` (the exchange's placement); edges
live with their source's owner. Each iteration builds one contribution
record per edge (key ``(0, dst)``, payload the float32 bits of
``rank[src] / outdeg[src]``), runs the exchange as a ``reduce_by_key``
(``aggregator="sum"``, ``float_payload=True``, with the map-side combine
gate of ``conf.map_side_combine``), and adds each partition's per-key
sums into its dense rank slice. The graph is static, so the plan is made
once and reused by every iteration. Under a job trace each iteration is
a ``rank_update`` stage (attempt = the iteration), as in the reference.
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
class PageRankResult:
    num_vertices: int
    num_edges: int
    iterations: int
    ranks: np.ndarray           # [V] final ranks, host-side
    total_s: float
    per_iter_s: float
    verified: Optional[bool] = None
    plan: Optional[ShufflePlan] = None
    #: ``ShuffleExchange.wire_stats()`` of the last iteration
    wire: Dict[str, float] = dataclasses.field(default_factory=dict)


def _pad_to_mesh(n: int, mesh: int) -> int:
    return ((n + mesh - 1) // mesh) * mesh


def run_pagerank(runtime: MeshRuntime, edges: np.ndarray, num_vertices: int,
                 iterations: int = 10, damping: float = 0.85,
                 verify: bool = True, slot_records: Optional[int] = None,
                 map_side_combine: Optional[str] = None) -> PageRankResult:
    """``edges``: int ``[E, 2]`` (src, dst). ``slot_records`` and
    ``map_side_combine`` override the runtime's configuration."""
    refuse_across_processes(runtime, "run_pagerank",
                            "sparkrdma_tpu/workloads/pagerank.py:207")
    mesh = runtime.num_partitions
    conf = runtime.conf
    if slot_records is not None:
        conf = conf.replace(slot_records=slot_records)
    if map_side_combine is not None:
        conf = conf.replace(map_side_combine=map_side_combine)
    if conf.record_words < 3 or conf.key_words != 2:
        # the layout below is key words [0, 1] and payload word 2
        raise ValueError("pagerank needs key_words == 2 and "
                         "record_words >= 3 (2 key + 1 payload)")
    ex = ShuffleExchange(runtime, conf)
    part = modulo_partitioner(mesh, key_word=1)  # dst vertex owner
    dev = runtime.device

    edges = np.asarray(edges, dtype=np.int64)
    e = edges.shape[0]
    v = num_vertices
    vper = _pad_to_mesh(v, mesh) // mesh
    outdeg = np.bincount(edges[:, 0], minlength=v).astype(np.float32)
    outdeg = np.maximum(outdeg, 1.0)  # dangling vertices contribute nothing

    # edges grouped by source owner into a padded [mesh, epad] table;
    # padding rows are src = dst = 0 with a zero contribution
    owner = edges[:, 0] % mesh
    # the narrowest type the owners fit: numpy's stable sort of 8- and
    # 16-bit keys is a radix sort (the same permutation, several times
    # faster at tens of millions of edges)
    owner_key = owner.astype(np.min_scalar_type(mesh - 1))
    edges_by_owner = edges[np.argsort(owner_key, kind="stable")]
    per_dev = np.bincount(owner, minlength=mesh)
    epad = int(per_dev.max())
    etab = np.zeros((mesh, epad, 2), dtype=np.int64)
    emask = np.zeros((mesh, epad), dtype=bool)
    off = 0
    for d in range(mesh):
        k = int(per_dev[d])
        etab[d, :k] = edges_by_owner[off:off + k]
        emask[d, :k] = True
        off += k

    # static keys [hi = 0, lo = dst]; word 2 is rewritten in place with
    # each iteration's contributions (the keys, and so the plan, stay)
    base = np.zeros((mesh * epad, conf.record_words), dtype=np.uint32)
    base[:, 1] = etab[:, :, 1].reshape(-1).astype(np.uint32)
    records = runtime.shard_records(base)
    plan = ex.plan(records, part, mesh)

    src_idx = torch.from_numpy(etab[:, :, 0] // mesh).to(dev)
    live_edge = torch.from_numpy(emask).to(dev)
    outdeg_pad = np.ones((vper * mesh,), np.float32)
    outdeg_pad[:v] = outdeg
    # owner layout: partition d holds vertices d, d+mesh, ... -> [mesh, vper]
    outdeg_owner = torch.from_numpy(
        outdeg_pad.reshape(vper, mesh).T.copy()).to(dev)
    ranks0 = np.full((vper * mesh,), 1.0 / v, np.float32)
    ranks0[v:] = 0.0
    ranks = torch.from_numpy(ranks0.reshape(vper, mesh).T.copy()).to(dev)
    vid = (torch.arange(vper, device=dev)[None, :] * mesh
           + torch.arange(mesh, device=dev)[:, None])
    slot_base = torch.arange(mesh, device=dev)[:, None] * (vper + 1)
    oc = plan.out_capacity

    def build_records(ranks):
        r = ranks.gather(1, src_idx)
        dg = outdeg_owner.gather(1, src_idx)
        contrib = torch.where(live_edge, r / dg, 0.0)
        records[2] = contrib.reshape(-1).view(torch.int32)

    def update_ranks(out, totals):
        # each partition's rows are its unique dst keys with their summed
        # contributions; add them into its dense slice through one spare
        # slot per partition that takes the dead rows and is cut off
        o = out.reshape(out.shape[0], mesh, oc)
        live = (torch.arange(oc, device=dev)[None, :]
                < totals.to(torch.int64)[:, None])
        idx = torch.where(live, as_unsigned(o[1]) // mesh, vper) + slot_base
        sums = torch.where(live, o[2].view(torch.float32), 0.0)
        acc = torch.zeros(mesh * (vper + 1), dtype=torch.float32,
                          device=dev).index_add_(0, idx.reshape(-1),
                                                 sums.reshape(-1))
        acc = acc.reshape(mesh, vper + 1)[:, :vper]
        new = (1.0 - damping) / v + damping * acc
        return torch.where(vid < v, new, 0.0)   # zero the padding vertices

    t0 = time.perf_counter()
    for it in range(iterations):
        # one job-trace stage per iteration (a no-op outside a job); the
        # exchange has no journal, so the stage's wall-clock is the job's
        with _trace.stage("rank_update", attempt=it):
            build_records(ranks)
            out, totals, _ = ex.exchange(records, part, plan, mesh,
                                         aggregator="sum",
                                         float_payload=True)
            ranks = update_ranks(out, totals)
            del out
            barrier(ranks)      # each iteration is a stage boundary
    total_s = time.perf_counter() - t0

    r_np = ranks.cpu().numpy().T.reshape(-1)[:v]
    verified = None
    if verify:
        ref = _numpy_pagerank(edges, v, iterations, damping)
        verified = bool(np.allclose(r_np, ref, rtol=1e-4, atol=1e-7))
    return PageRankResult(
        num_vertices=v, num_edges=e, iterations=iterations, ranks=r_np,
        total_s=total_s, per_iter_s=total_s / max(iterations, 1),
        verified=verified, plan=plan, wire=dict(ex.wire_stats()))


def _numpy_pagerank(edges: np.ndarray, v: int, iterations: int,
                    damping: float) -> np.ndarray:
    """float64 reference; ``np.bincount(weights=)`` adds in index order,
    as ``np.add.at`` does, at chip scale in seconds."""
    src, dst = edges[:, 0], edges[:, 1]
    outdeg = np.maximum(np.bincount(src, minlength=v).astype(np.float64),
                        1.0)
    r = np.full(v, 1.0 / v)
    for _ in range(iterations):
        # (r / outdeg)[src] is r[src] / outdeg[src], with one gather
        acc = np.bincount(dst, weights=(r / outdeg)[src], minlength=v)
        r = (1 - damping) / v + damping * acc
    return r.astype(np.float32)


__all__ = ["run_pagerank", "PageRankResult"]
