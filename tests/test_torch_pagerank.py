"""PageRank: port vs reference on the CPU.

The graphs are those of ``tests/test_join_pagerank.py`` (a random graph,
a chain and a star). One iteration's exchange — the ``reduce_by_key``
over float32 contributions — must give bit-identical ``out``, ``totals``
and ``wire_stats()`` (tolerance 0: the port mirrors the reference's
float scan tree). The rank update around it is float arithmetic that
XLA on the CPU may contract into fused multiply-adds and PyTorch does
not, so the final ranks are held to rtol 1e-6 and atol 1e-9.
"""

import jax
import numpy as np
import pytest

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.exchange.partitioners import \
    modulo_partitioner as ref_modulo
from sparkrdma_tpu.exchange.protocol import ShuffleExchange as RefExchange
from sparkrdma_tpu.workloads.pagerank import run_pagerank as ref_pagerank
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.workloads.pagerank import (_numpy_pagerank,
                                                    run_pagerank)


def _graphs():
    rng = np.random.default_rng(0)
    v, e = 100, 600
    rand = np.stack([rng.integers(0, v, size=e), rng.integers(0, v, size=e)],
                    axis=1)
    star = np.stack([np.arange(1, 16), np.zeros(15, dtype=np.int64)], axis=1)
    return {"random": (rand, v, 5), "chain": (np.array([[0, 1], [1, 2],
                                                        [2, 3]]), 4, 20),
            "star": (star, 16, 10)}


GRAPHS = _graphs()


def _runtimes(d, **kw):
    ref = RefRuntime(RefConf(slot_records=128, **kw),
                     devices=jax.devices()[:d])
    port = MeshRuntime(ShuffleConf(slot_records=128, **kw),
                       num_partitions=d, device="cpu")
    return ref, port


def _first_iteration_rows(edges, v, mesh, w=4):
    """The records of iteration 1 as host rows, laid out as both
    packages lay them out (edges grouped by source owner, padded)."""
    outdeg = np.maximum(np.bincount(edges[:, 0], minlength=v), 1)
    outdeg = outdeg.astype(np.float32)
    owner = edges[:, 0] % mesh
    grouped = edges[np.argsort(owner, kind="stable")]
    per = np.bincount(owner, minlength=mesh)
    rows = np.zeros((mesh, int(per.max()), w), np.uint32)
    off = 0
    for d in range(mesh):
        k = int(per[d])
        src, dst = grouped[off:off + k, 0], grouped[off:off + k, 1]
        rows[d, :k, 1] = dst
        rows[d, :k, 2] = (np.float32(1.0 / v) / outdeg[src]).view(np.uint32)
        off += k
    return rows.reshape(-1, w)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("combine", ["on", "off", "auto"])
def test_iteration_exchange_matches_reference(graph, combine):
    edges, v, _ = GRAPHS[graph]
    d = 8
    ref_rt, port_rt = _runtimes(d, map_side_combine=combine)
    rows = _first_iteration_rows(edges, v, d)
    ref_ex = RefExchange(ref_rt.mesh, ref_rt.axis_name, ref_rt.conf)
    recs = ref_rt.shard_records(rows)
    ref_part = ref_modulo(d, key_word=1)
    plan = ref_ex.plan(recs, ref_part, d)
    out_r, tot_r, _ = ref_ex.exchange(recs, ref_part, plan, d,
                                      aggregator="sum", float_payload=True)

    ex = ShuffleExchange(port_rt)
    precs = port_rt.shard_records(rows)
    part = modulo_partitioner(d, key_word=1)
    pplan = ex.plan(precs, part, d)
    assert pplan.out_capacity == plan.out_capacity
    out, totals, _ = ex.exchange(precs, part, pplan, d, aggregator="sum",
                                 float_payload=True)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))
    assert ex.reference_wire_stats() == ref_ex.wire_stats()
    if combine != "auto":
        assert ("combine_in_records" in ex.wire_stats()) == (combine == "on")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_ranks_match_reference(graph):
    edges, v, iters = GRAPHS[graph]
    ref_rt, port_rt = _runtimes(8)
    want = ref_pagerank(ref_rt, edges, v, iterations=iters)
    got = run_pagerank(port_rt, edges, v, iterations=iters)
    assert got.verified and want.verified
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-6, atol=1e-9)
    assert (got.num_vertices, got.num_edges) == (v, len(edges))
    assert got.plan is not None and "combine_dup_ratio" in got.wire


def test_ranks_single_partition():
    """One partition takes the exchange's single-partition branch (one
    slot holds every edge: the streaming regime is not ported)."""
    edges, v, iters = GRAPHS["random"]
    ref_rt, port_rt = _runtimes(1)
    want = ref_pagerank(ref_rt, edges, v, iterations=iters,
                        slot_records=1024, map_side_combine="on")
    got = run_pagerank(port_rt, edges, v, iterations=iters,
                       slot_records=1024, map_side_combine="on")
    assert got.verified
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-6, atol=1e-9)


def test_graph_shapes():
    """The chain concentrates rank down-chain; the star's hub dominates."""
    _, port_rt = _runtimes(8)
    chain = run_pagerank(port_rt, *GRAPHS["chain"][:2], iterations=20)
    assert chain.ranks[3] > chain.ranks[0]
    star = run_pagerank(port_rt, *GRAPHS["star"][:2], iterations=10)
    assert star.ranks[0] == star.ranks.max()


def test_numpy_reference_matches_add_at():
    edges, v, iters = GRAPHS["random"]
    outdeg = np.maximum(np.bincount(edges[:, 0], minlength=v), 1.0)
    r = np.full(v, 1.0 / v)
    for _ in range(iters):
        acc = np.zeros(v)
        np.add.at(acc, edges[:, 1], r[edges[:, 0]] / outdeg[edges[:, 0]])
        r = (1 - 0.85) / v + 0.85 * acc
    np.testing.assert_array_equal(_numpy_pagerank(edges, v, iters, 0.85),
                                  r.astype(np.float32))


def test_layout_checked():
    with pytest.raises(ValueError, match="key_words == 2"):
        run_pagerank(MeshRuntime(ShuffleConf(val_words=0), 8, device="cpu"),
                     *GRAPHS["chain"][:2])
