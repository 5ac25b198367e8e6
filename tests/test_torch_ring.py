"""Port stacked ring exchange vs ``sparkrdma_tpu.exchange.ring``.

The reference's kernels run in interpret mode under ``shard_map`` on the
8-device CPU mesh; the port's wrappers run their plain version on the
CPU. Bit-exact (tolerance 0). The layouts differ only in where the
source axis lives: the reference's global ``[R, D*D, ...]`` holds device
``s``'s slots at ``[:, s*D:(s+1)*D]``; the port stacks them as ``send[s]``.
"""

import zlib

import chip_smoke
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


# --- the kernel's launch plan and per-item copy, held on the CPU ---------
#
# ``csrc/ring_exchange.cu`` cannot run here. What it computes is pinned
# in two steps: the launch plan from ``launch_plan`` covers every word of
# every chunk once, at every send shape ``chip_smoke.py`` checks and at
# odd ones; and a numpy emulation of the kernel's per-item copy (scalar
# head, 16-byte body aligned or at a word shift, scalar tail, the guard
# that keeps the shifted body's reads inside send) equals
# ``ring_exchange_plain``, the buffers based at 0, 4, 8 and 12 bytes.

def _shape_label(shape, a2a):
    """A leg shape's test id: the shape itself, so that a leg that comes
    to launch the kernel at a listed shape leaves the ids as they were."""
    return f"{'a2a ' if a2a else ''}{'x'.join(map(str, shape))}"


#: send shapes [D, R, D, ...]: every shape chip_smoke.py checks (those
#: legs B-Q launch the kernel at, then the kernel phases' own), and its
#: edge cases
RING_SHAPES = {
    **{_shape_label(shape, a2a): shape
       for _, shape, a2a in chip_smoke.RING_LEG_SHAPES},
    **chip_smoke.RING_PHASE_SHAPES,
    **chip_smoke.RING_EDGE_SHAPES,
}
#: (send, recv) base offsets in words: 4, 8 and 12 bytes
PHASES = [(0, 0), (1, 0), (0, 2), (3, 1), (2, 3)]


def _geometry(shape):
    d, r = shape[0], shape[1]
    chunk = int(np.prod(shape[3:], dtype=np.int64))
    return d, r, chunk, port.launch_plan(d, r, chunk)


def _items(d, r, chunk, plan):
    """Every item's (source offset, destination offset, length) in words,
    as the kernel computes them from its item index."""
    it = np.arange(plan.grid, dtype=np.int64)
    c = it // plan.items_per_chunk
    lo = (it - c * plan.items_per_chunk) * plan.item_words
    s, rr, dd = c // (r * d), (c // d) % r, c % d
    src = c * chunk + lo
    dst = ((dd * r + rr) * d + s) * chunk + lo
    return src, dst, np.minimum(plan.item_words, chunk - lo)


def _tiles(off, ln, total):
    """The intervals [off, off + ln) tile [0, total) exactly."""
    order = np.argsort(off, kind="stable")
    off, ln = off[order], ln[order]
    return (bool((ln > 0).all()) and (total == 0 or off[0] == 0)
            and bool((off[1:] == off[:-1] + ln[:-1]).all())
            and int(off[-1] + ln[-1] if len(off) else 0) == total)


@pytest.mark.parametrize("name,items,rest", [("chunk < item", 1, None),
                                             ("chunk = item + 1", 2, 1),
                                             ("chunk = 2 items", 2, 0)])
def test_edge_shapes_straddle_items(name, items, rest):
    """The edge shapes named for the work item sit where their names say,
    at the item size ``launch_plan`` uses."""
    d, r, chunk, plan = _geometry(RING_SHAPES[name])
    assert plan.item_words == port.ITEM_WORDS
    assert plan.items_per_chunk == items
    assert chunk % plan.item_words == (chunk if rest is None else rest)


@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_launch_plan_covers_every_word(name):
    shape = RING_SHAPES[name]
    d, r, chunk, plan = _geometry(shape)
    total = d * r * d * chunk
    assert plan.item_words % 4 == 0
    assert plan.grid == d * r * d * plan.items_per_chunk < 2**31
    if chunk == 0:
        assert plan.grid == 0
        return
    assert (plan.items_per_chunk - 1) * plan.item_words < chunk \
        <= plan.items_per_chunk * plan.item_words
    src, dst, ln = _items(d, r, chunk, plan)
    assert _tiles(src, ln, total) and _tiles(dst, ln, total)
    # an item's words go to where the permutation sends them
    c_src, c_dst = src // chunk, dst // chunk
    s, rr, dd = c_src // (r * d), (c_src // d) % r, c_src % d
    np.testing.assert_array_equal(c_dst, (dd * r + rr) * d + s)
    np.testing.assert_array_equal(src % chunk, dst % chunk)


def _emulated_chunk(shape):
    """The chunk length the emulation runs at: the shape's own up to 2^21
    words in all, else two items plus the shape's remainder (the same
    residue mod 4, so the same alignment cases)."""
    d, r, chunk, _ = _geometry(shape)
    if d * r * d * chunk <= 1 << 21:
        return chunk
    return 2 * port.ITEM_WORDS + chunk % port.ITEM_WORDS


def _emulate(send, d, r, chunk, plan, send_phase, recv_phase):
    """The kernel's copy, item by item, of the flat int32 ``send`` (its
    first word ``send_phase`` words past a 16-byte boundary) into a recv
    based ``recv_phase`` words past one. Returns recv and the write count
    of each word; asserts that every 16-byte block read lies in send and
    every vector store is aligned."""
    total = send.size
    recv = np.zeros_like(send)
    writes = np.zeros(total, dtype=np.int64)
    for src, dst, ln in zip(*_items(d, r, chunk, plan)):
        src, dst, ln = int(src), int(dst), int(ln)
        head = min((4 - (recv_phase + dst) % 4) % 4, ln)
        shift = (send_phase + src + head) % 4
        nvec = (ln - head) // 4
        if shift and nvec:
            if src + head < shift:
                head, nvec = head + 4, nvec - 1
            if nvec and (ln - head - 4 * nvec) + (total - src - ln) \
                    < 4 - shift:
                nvec -= 1
        body = 4 * nvec
        assert (recv_phase + dst + head) % 4 == 0 or nvec == 0
        recv[dst:dst + head] = send[src:src + head]
        if shift == 0:
            recv[dst + head:dst + head + body] = \
                send[src + head:src + head + body]
        elif nvec:
            first = src + head - shift
            assert first >= 0 and first + 4 * (nvec + 1) <= total
            assert (send_phase + first) % 4 == 0
            blocks = send[first:first + 4 * (nvec + 1)].reshape(nvec + 1, 4)
            window = np.concatenate([blocks[:-1], blocks[1:]], axis=1)
            recv[dst + head:dst + head + body] = \
                window[:, shift:shift + 4].reshape(-1)
        recv[dst + head + body:dst + ln] = \
            send[src + head + body:src + ln]
        writes[dst:dst + ln] += 1
    return recv, writes


@pytest.mark.parametrize("phases", PHASES,
                         ids=[f"send+{4 * a}B-recv+{4 * b}B"
                              for a, b in PHASES])
@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_item_copy_emulation_matches_plain(name, phases):
    shape = RING_SHAPES[name]
    d, r = shape[0], shape[1]
    chunk = _emulated_chunk(shape)
    plan = port.launch_plan(d, r, chunk)
    rng = np.random.default_rng(zlib.crc32(repr((name, phases)).encode()))
    send = rng.integers(-2**31, 2**31, size=(d, r, d, chunk),
                        dtype=np.int64).astype(np.int32)
    want = port.ring_exchange_plain(torch.from_numpy(send)).numpy()
    got, writes = _emulate(send.reshape(-1), d, r, chunk, plan, *phases)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.reshape(-1))


@pytest.mark.parametrize("shape", [(3, 5, 3, 2, 7, 101), (8, 2, 8, 1, 3, 5),
                                   (8, 1, 8, 0)])
def test_cpu_wrappers_take_views_and_out(shape):
    """On CPU tensors the wrappers run the plain permutation, into
    ``out`` views at a word offset too."""
    n = int(np.prod(shape))
    base = torch.arange(n + 3, dtype=torch.int32)
    send = base[1:1 + n].view(shape)
    out = torch.full((n + 2,), -1, dtype=torch.int32)[2:].view(shape)
    got = port.ring_exchange(send, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, port.ring_exchange_plain(send))
    a2a = send[:, 0]
    assert torch.equal(port.ring_all_to_all(a2a),
                       a2a.transpose(0, 1).contiguous())
