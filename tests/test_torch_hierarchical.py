"""The hierarchical transport in one process, port against reference.

``ShuffleConf(transport="hierarchical", hierarchy_hosts=H)`` stages each
round's all-to-all as an intra-host then an inter-host move
(``sparkrdma_tpu_torch/exchange/hierarchical.py``); with H virtual hosts
of stacked partitions it must give the flat transport's bytes, and the
reference's hierarchical exchange's on the same records (the cases of
``tests/test_exchange.py::TestHierarchicalTransport``, tolerance 0).
The reference runs on the conftest's 8-device CPU mesh, imported inside
a fixture.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange.hierarchical import (
    hierarchy_for, make_hierarchical_all_to_all)
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner)
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

D = 8


@pytest.fixture(scope="module")
def ref():
    """The reference's runtime on the 8-device CPU mesh and its pieces."""
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.exchange import partitioners
    from sparkrdma_tpu.exchange.protocol import ShuffleExchange as RefExchange

    rt = RefRuntime(RefConf(slot_records=16))
    yield rt, RefConf, RefExchange, partitioners
    rt.stop()


def _runtime(**kw):
    return MeshRuntime(ShuffleConf(slot_records=16, **kw), num_partitions=D,
                       device="cpu")


def _ref_shuffle(ref, x, part_name, parts, **conf):
    rt, RefConf, RefExchange, partitioners = ref
    ex = RefExchange(rt.mesh, rt.axis_name, RefConf(slot_records=16, **conf))
    part = getattr(partitioners, part_name)(parts)
    out, tot, plan = ex.shuffle(rt.shard_records(x), part, num_parts=parts)
    return np.asarray(out), np.asarray(tot), plan


def _port_shuffle(x, part, parts, metrics=None, **conf):
    rt = _runtime(**conf)
    ex = ShuffleExchange(rt, rt.conf, metrics=metrics)
    out, tot, plan = ex.shuffle(rt.shard_records(x), part, num_parts=parts)
    return records_from_torch(out), tot.numpy(), plan


def _golden(x, pids, parts, cap, out, totals):
    """Per destination: the records each source sent it, in (partition,
    source) order, then zeros (the reference's numpy check)."""
    n = x.shape[0] // D
    for d in range(D):
        rows = [x[s * n:(s + 1) * n][pids[s * n:(s + 1) * n] == q * D + d]
                for q in range(parts // D) for s in range(D)]
        want = np.concatenate(rows)
        k = int(totals[d])
        assert k == len(want)
        np.testing.assert_array_equal(out[:, d * cap:d * cap + k].T, want)
        assert not out[:, d * cap + k:(d + 1) * cap].any()
    assert totals.sum() == x.shape[0]


@pytest.mark.parametrize("hosts", [2, 4])
def test_parity_with_flat_and_reference(ref, rng, hosts):
    x = rng.integers(1, 2**32, size=(D * 48, 4), dtype=np.uint32)
    out_f, tot_f, plan_f = _port_shuffle(x, hash_partitioner(16), 16)
    metrics = MetricsRegistry(enabled=True)
    out_h, tot_h, plan_h = _port_shuffle(
        x, hash_partitioner(16), 16, metrics=metrics,
        transport="hierarchical", hierarchy_hosts=hosts)
    assert plan_f.num_rounds == plan_h.num_rounds
    np.testing.assert_array_equal(tot_h, tot_f)
    np.testing.assert_array_equal(out_h, out_f)
    assert metrics.counter("transport.hier.staged_exchanges").value \
        == plan_h.num_rounds + 0
    out_r, tot_r, plan_r = _ref_shuffle(ref, x, "hash_partitioner", 16,
                                        transport="hierarchical",
                                        hierarchy_hosts=hosts)
    assert plan_r.num_rounds == plan_h.num_rounds
    np.testing.assert_array_equal(tot_h, tot_r)
    np.testing.assert_array_equal(out_h, out_r)


def test_correct_vs_numpy_multi_round(ref, rng):
    """The golden check on a plan with more rounds than fly at once (the
    streaming regime), and equal to the reference's bytes."""
    x = rng.integers(1, 2**32, size=(D * 80, 4), dtype=np.uint32)
    x[: D * 40, 0] = 0            # a skewed half: several rounds
    part = modulo_partitioner(D)
    out, tot, plan = _port_shuffle(x, part, D, transport="hierarchical",
                                   hierarchy_hosts=2, max_rounds_in_flight=1)
    assert plan.num_rounds > 1
    pids = part(torch.from_numpy(x.T.copy().view(np.int32))).numpy()
    _golden(x, pids, D, plan.out_capacity, out, tot)
    out_r, tot_r, _ = _ref_shuffle(ref, x, "modulo_partitioner", D,
                                   transport="hierarchical",
                                   hierarchy_hosts=2, max_rounds_in_flight=1)
    np.testing.assert_array_equal(tot, tot_r)
    np.testing.assert_array_equal(out, out_r)


def test_auto_hosts_single_process_goes_flat(rng):
    """hosts 0 is the process count, 1 here: the degenerate hierarchy
    runs the flat move and counts it."""
    rt = _runtime()
    assert hierarchy_for(rt, 0) == 1
    metrics = MetricsRegistry(enabled=True)
    x = rng.integers(1, 2**32, size=(D * 24, 4), dtype=np.uint32)
    out, tot, plan = _port_shuffle(x, modulo_partitioner(D), D,
                                   metrics=metrics, transport="hierarchical")
    out_f, tot_f, _ = _port_shuffle(x, modulo_partitioner(D), D)
    np.testing.assert_array_equal(out, out_f)
    np.testing.assert_array_equal(tot, tot_f)
    assert metrics.counter("transport.hier.flat_fallbacks").value \
        == plan.num_rounds
    assert metrics.counter("transport.hier.staged_exchanges").value == 0


def test_bad_hosts_rejected():
    with pytest.raises(ValueError, match="divide"):
        hierarchy_for(_runtime(), 3)
    with pytest.raises(ValueError, match="hierarchy_hosts"):
        ShuffleConf(hierarchy_hosts=-1)


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_move_is_the_flat_transpose(hosts):
    """The move alone: ``[D_src, D_dst, ...] -> [D_dst, D_src, ...]``."""
    send = torch.arange(D * D * 6, dtype=torch.int32).reshape(D, D, 2, 3)
    got = make_hierarchical_all_to_all(_runtime(), hosts)(send)
    assert torch.equal(got, send.transpose(0, 1))
