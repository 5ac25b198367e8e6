"""Port stacked ring exchange vs ``sparkrdma_tpu.exchange.ring``.

The reference's kernels run in interpret mode under ``shard_map`` on the
8-device CPU mesh; the port's wrappers run their plain version on the
CPU. Bit-exact (tolerance 0). The layouts differ only in where the
source axis lives: the reference's global ``[R, D*D, ...]`` holds device
``s``'s slots at ``[:, s*D:(s+1)*D]``; the port stacks them as ``send[s]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.exchange import ring as ref
from sparkrdma_tpu.exchange.partitioners import \
    modulo_partitioner as ref_modulo
from sparkrdma_tpu.exchange.protocol import ShuffleExchange as RefExchange
from sparkrdma_tpu.utils.compat import shard_map
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.exchange import ring as port
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShuffleExchange
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

D = 8


def _shard(runtime, fn, g, axis):
    spec = P(*([None] * axis + [runtime.axis_name]))
    return np.asarray(shard_map(fn, mesh=runtime.mesh, in_specs=spec,
                                out_specs=spec, check_vma=False)(g))


@pytest.mark.parametrize("num_rounds", [1, 2, 5])
def test_fused_exchange_matches_reference(runtime, rng, num_rounds):
    trail = (3, 5)
    g = rng.integers(0, 2**32, size=(num_rounds, D * D) + trail,
                     dtype=np.uint32)
    ex = ref.make_ring_exchange(
        runtime.mesh, runtime.axis_name, num_rounds,
        collective_id=ref.derive_collective_id(("kernel", num_rounds)))
    want = _shard(runtime, ex, jnp.asarray(g), 1)
    send = torch.from_numpy(g.view(np.int32)).reshape(
        (num_rounds, D, D) + trail).transpose(0, 1).contiguous()
    reg = MetricsRegistry()
    recv = port.make_ring_exchange(D, num_rounds, metrics=reg)(send)
    got = recv.transpose(0, 1).reshape((num_rounds, D * D) + trail)
    np.testing.assert_array_equal(records_from_torch(got), want)
    assert reg.counter("transport.ring.fused_kernels").value == 1
    assert reg.counter("transport.ring.fused_rounds").value == num_rounds
    assert reg.counter("transport.ring.overlap_rounds").value == \
        num_rounds - 1


def test_all_to_all_matches_reference(runtime, rng):
    trail = (2, 4, 9)
    g = rng.integers(0, 2**32, size=(D * D,) + trail, dtype=np.uint32)
    a2a = ref.make_ring_all_to_all(runtime.mesh, runtime.axis_name)
    want = _shard(runtime, a2a, jnp.asarray(g), 0)
    send = torch.from_numpy(g.view(np.int32)).reshape((D, D) + trail)
    reg = MetricsRegistry()
    got = port.make_ring_all_to_all(D, metrics=reg)(send)
    np.testing.assert_array_equal(
        records_from_torch(got.reshape((D * D,) + trail)), want)
    assert reg.counter("transport.ring.kernels").value == 1


def test_single_partition_is_identity(rng):
    g = torch.from_numpy(rng.integers(0, 2**31, size=(1, 3, 1, 2, 4),
                                      dtype=np.int32))
    assert port.make_ring_exchange(1, 3)(g) is g
    assert port.make_ring_all_to_all(1)(g[:, 0]) is not None
    with pytest.raises(ValueError, match="built for 2 rounds"):
        port.make_ring_exchange(D, 2)(torch.zeros((D, 3, D, 1),
                                                  dtype=torch.int32))


def test_collective_id_matches_reference():
    for key in [("a", 1), (None, 8, 16, 2), "x"]:
        assert port.derive_collective_id(key) == ref.derive_collective_id(key)


@pytest.fixture(scope="module")
def ref_ring():
    conf = RefConf(slot_records=16, max_rounds_in_flight=8,
                   transport="pallas_ring")
    rt = RefRuntime(conf)
    yield RefExchange(rt.mesh, rt.axis_name, conf), rt
    rt.stop()


@pytest.mark.parametrize("transport,fused", [("pallas_ring", True),
                                             ("pallas_ring", False),
                                             ("xla", True)])
def test_ragged_multi_round_exchange(ref_ring, transport, fused):
    """40 records per source into one partition over capacity-16 slots:
    rounds [16, 16, 8], the last one ragged. Output and totals equal the
    reference's fused ring exchange on every port transport."""
    ex_r, rt_r = ref_ring
    x = np.random.default_rng(3).integers(1, 2**32, size=(D * 40, 4),
                                          dtype=np.uint32)
    x[:, 0] = 5                               # all -> partition 5
    out_r, tot_r, plan_r = ex_r.shuffle(rt_r.shard_records(x),
                                        ref_modulo(8), num_parts=8)
    assert plan_r.num_rounds == 3
    conf = ShuffleConf(slot_records=16, max_rounds_in_flight=8,
                       transport=transport, ring_fused=fused)
    rt = MeshRuntime(conf, num_partitions=D, device="cpu")
    ex = ShuffleExchange(rt, conf)
    recs = rt.shard_records(x)
    plan = ex.plan(recs, modulo_partitioner(8), num_parts=8)
    assert plan.num_rounds == 3 and plan.capacity == plan_r.capacity
    np.testing.assert_array_equal(plan.counts, plan_r.counts)
    out, tot, incoming = ex.exchange(recs, modulo_partitioner(8), plan)
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))
    assert incoming[5].sum() == D * 40


@pytest.mark.parametrize("num_parts", [8, 16])
def test_exchange_parity_ppd(ref_ring, rng, num_parts):
    """Several partitions per stacked partition (ppd = 2) and a single
    fused round, against the reference."""
    ex_r, rt_r = ref_ring
    x = rng.integers(0, 2**32, size=(D * 24, 4), dtype=np.uint32)
    out_r, tot_r, _ = ex_r.shuffle(rt_r.shard_records(x),
                                   ref_modulo(num_parts),
                                   num_parts=num_parts)
    conf = ShuffleConf(slot_records=16, max_rounds_in_flight=8,
                       transport="pallas_ring")
    rt = MeshRuntime(conf, num_partitions=D, device="cpu")
    ex = ShuffleExchange(rt, conf)
    recs = rt.shard_records(x)
    part = modulo_partitioner(num_parts)
    out, tot, _ = ex.exchange(recs, part,
                              ex.plan(recs, part, num_parts=num_parts))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))


def test_streaming_regime_refused(ref_ring, rng):
    """Five rounds over two in flight, once refused, now stream in three
    chunks and give the reference's fused ring exchange's bytes."""
    ex_r, rt_r = ref_ring
    x = rng.integers(1, 2**32, size=(D * 72, 4), dtype=np.uint32)
    x[:, 0] = 5
    out_r, tot_r, _ = ex_r.shuffle(rt_r.shard_records(x), ref_modulo(8),
                                   num_parts=8)
    conf = ShuffleConf(slot_records=16, max_rounds_in_flight=2,
                       transport="pallas_ring")
    rt = MeshRuntime(conf, num_partitions=D, device="cpu")
    ex = ShuffleExchange(rt, conf)
    recs = rt.shard_records(x)
    plan = ex.plan(recs, modulo_partitioner(8), num_parts=8)
    assert plan.num_rounds == 5
    out, tot, _ = ex.exchange(recs, modulo_partitioner(8), plan)
    assert ex.last_dispatches == 1 + 2 * 3 + 1
    np.testing.assert_array_equal(tot.numpy(), np.asarray(tot_r))
    np.testing.assert_array_equal(records_from_torch(out), np.asarray(out_r))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1, 8, 1, 25, 1025),
                                   (8, 3, 8, 2, 5, 129), (4, 2, 4, 7)])
def test_kernel_matches_plain_on_card(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    send = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         device=cuda, dtype=torch.int64).to(torch.int32)
    before = port.ring_exchange.launches
    got = port.ring_exchange(send)
    torch.cuda.synchronize()
    assert port.ring_exchange.launches == before + 1
    assert torch.equal(got, port.ring_exchange_plain(send))
