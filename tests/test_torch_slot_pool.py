"""The slot pool and the buffer lifecycle built on it.

- ``SlotPool``'s own contract, case for case as ``tests/test_slot_pool.py``
  holds the reference's;
- the exchange draws on it: pool hits across streaming chunks, and the
  fused output recycled between reads of one shuffle (the reference's
  contract: a repeat read overwrites the last one's ``out``);
- a "poisoned" pool that fills every returned buffer with 0xA5A5A5A5
  changes no output bit: every reused buffer is zeroed or fully written;
- ``read_view`` / ``OutputView.partition`` and ``read_partition`` equal
  the reference's, on an unsplit and on a skew-split plan.
"""

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
from sparkrdma_tpu.exchange.partitioners import \
    modulo_partitioner as ref_modulo
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner)
from sparkrdma_tpu_torch.hbm.slot_pool import SlotPool
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

D = 8


def make_pool(**kw):
    return SlotPool(ShuffleConf(**kw), device="cpu")


# --- the pool's own contract (mirrors tests/test_slot_pool.py) ---------

@pytest.mark.parametrize("device", [None, "cuda"])
def test_default_device_is_the_card(monkeypatch, device):
    """A pool built without a device (or with ``"cuda"``) lives on the
    current card, as ``MeshRuntime``'s device does; without CUDA it
    raises instead of carrying on on the CPU."""
    kw = {} if device is None else {"device": device}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotPool(ShuffleConf(), **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert SlotPool(ShuffleConf(), **kw).device == torch.device("cuda", 0)


def test_get_rounds_to_size_class():
    pool = make_pool()
    slot = pool.get(1000)
    assert slot.capacity == 1024
    assert slot.array.shape == (1024, pool.conf.record_words)
    assert slot.array.dtype == torch.int32 and not slot.array.any()


def test_put_get_reuses_buffer():
    pool = make_pool()
    slot = pool.get(512)
    ptr = slot.array.data_ptr()
    slot.release()
    assert pool.get(512).array.data_ptr() == ptr
    assert pool.hits == 1 and pool.misses == 1


def test_distinct_classes_not_shared():
    pool = make_pool()
    pool.get(100).release()        # class 128
    b = pool.get(300)              # class 512: a miss
    assert b.capacity == 512
    assert pool.misses == 2


def test_refcount_retain_release():
    pool = make_pool()
    slot = pool.get(64)
    slot.retain()
    slot.release()
    assert pool.free_counts() == {}    # still held
    slot.release()
    assert sum(pool.free_counts().values()) == 1
    with pytest.raises(RuntimeError, match="double release"):
        slot.release()
    with pytest.raises(RuntimeError, match="released slot"):
        slot.retain()


def test_view_slicing_and_bounds():
    pool = make_pool()
    slot = pool.get(64)
    v = slot.view(8, 16)
    assert v.shape == (16, pool.conf.record_words)
    v[0, 0] = 7
    assert slot.array[8, 0] == 7           # a view, not a copy
    with pytest.raises(ValueError):
        slot.view(60, 10)


def test_prealloc_warms_classes():
    pool = make_pool(prealloc="256:3")
    assert pool.preallocated == 3
    s = pool.get(200)
    assert pool.hits == 1 and pool.misses == 0
    s.release()
    with pytest.raises(ValueError, match="prealloc"):
        ShuffleConf(prealloc="256:0")


def test_max_slot_records_enforced():
    pool = make_pool(max_slot_records=1000)
    with pytest.raises(ValueError, match="max_slot_records"):
        pool.get(2048)
    with pytest.raises(ValueError, match="size class 1024"):
        pool.get(600)


def test_record_words_override():
    pool = make_pool()
    slot = pool.get(64, record_words=8)
    assert slot.array.shape == (64, 8)
    slot.release()
    assert pool.get(64, record_words=8).array.shape == (64, 8)
    assert pool.hits == 1


def test_shaped_buffers_and_stats():
    """``get_shaped`` keys on the exact shape and dtype; only a miss is
    zero-filled; the outstanding count and its high-water mark follow
    the buffers out and back, and the counters reach the registry."""
    reg = MetricsRegistry()
    pool = SlotPool(ShuffleConf(), device="cpu", metrics=reg)
    a = pool.get_shaped((3, 5))
    b = pool.get_shaped((3, 5))
    assert a.shape == (3, 5) and a.dtype == torch.int32 and not a.any()
    a.fill_(9)
    pool.put_shaped(a)
    assert pool.get_shaped((5, 3)).data_ptr() != a.data_ptr()
    c = pool.get_shaped((3, 5))
    assert c.data_ptr() == a.data_ptr() and (c == 9).all()   # not zeroed
    assert pool.get_shaped((3, 5), torch.int64).dtype == torch.int64
    pool.put_shaped(b)
    st = pool.stats()
    assert (st["hits"], st["misses"], st["outstanding"],
            st["outstanding_high_water"]) == (1, 4, 3, 4)
    assert reg.counter("pool.hits").value == 1
    assert reg.counter("pool.misses").value == 4
    assert reg.gauge("pool.outstanding").value == 3
    pool.clear()
    assert pool.free_counts() == {}
    with pytest.raises(ValueError, match="pool on"):
        pool.put_shaped(torch.zeros(2, device="meta"))


@pytest.mark.parametrize("free", [2, 0], ids=["evicts", "empty"])
def test_full_device_evicts_free_buffers(monkeypatch, free):
    """An allocation that finds the device full drops the free buffers
    and allocates once more; with none to drop it raises."""
    pool = make_pool()
    held = [pool.get_shaped((4, 4)) for _ in range(free)]
    for arr in held:
        pool.put_shaped(arr)
    real = torch.zeros
    calls = []

    def full_once(*a, **k):
        calls.append(a)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("device full")
        return real(*a, **k)

    monkeypatch.setattr(torch, "zeros", full_once)
    if not free:
        with pytest.raises(torch.OutOfMemoryError):
            pool.get_shaped((8, 8))
        return
    arr = pool.get_shaped((8, 8))
    assert arr.shape == (8, 8) and len(calls) == 2
    assert pool.free_counts() == {} and pool.stats()["evictions"] == free


def test_runtime_owns_pool():
    rt = MeshRuntime(ShuffleConf(prealloc="64:2"), D, device="cpu")
    assert rt.pool.device == rt.device and rt.pool.preallocated == 2
    with rt:
        pass
    assert rt.pool.free_counts() == {}      # stop() cleared it


# --- the exchange on the pool ---------------------------------------

def _rows(seed, n=D * 96):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, 1] = rng.zipf(1.3, size=n) % 40
    return rows


def _manager(rows, pool_cls=None, sid=1, **kw):
    rt = MeshRuntime(ShuffleConf(**kw), D, device="cpu")
    if pool_cls is not None:
        rt.pool = pool_cls(rt.conf, device=rt.device)
    m = ShuffleManager(rt)
    h = m.register_shuffle(sid, D, hash_partitioner(D, 2))
    m.get_writer(h).write(rt.shard_records(rows)).stop()
    return m, h


def test_pool_serves_streaming_chunks():
    m, h = _manager(_rows(1), slot_records=4, max_rounds_in_flight=1)
    plan = m._writers[1].plan
    assert plan.num_rounds >= 3
    m.get_reader(h).read()
    st = m.runtime.pool.stats()
    # acc, send and receive chunk, each allocated once and reused
    assert st["misses"] == 3 and st["hits"] == 2 * (plan.num_rounds - 1)
    assert st["outstanding"] == 0 and st["outstanding_high_water"] == 3
    assert m.metrics.counter("pool.hits").value == st["hits"]
    m.stop()


def test_fused_output_ping_pong():
    """A repeat read of one shuffle reuses (and overwrites) the last
    read's ``out``; another shuffle or read geometry gets its own; the
    buffers go back on unregister and stop."""
    rows = _rows(2)
    m, h = _manager(rows, slot_records=256)
    out1, tot1 = m.get_reader(h).read()
    first = out1.clone()
    out2, _ = m.get_reader(h).read()
    assert out2.data_ptr() == out1.data_ptr() and torch.equal(out2, first)
    out1.zero_()                   # the recycled buffer is the caller's
    out3, _ = m.get_reader(h).read()
    assert torch.equal(out3, first)   # rewritten whole by the next read
    agg, _ = m.get_reader(h, aggregator="sum").read()
    assert agg.data_ptr() != out1.data_ptr()
    h2 = m.register_shuffle(2, D, hash_partitioner(D, 2))
    m.get_writer(h2).write(m.runtime.shard_records(rows)).stop()
    other, _ = m.get_reader(h2).read()
    assert other.data_ptr() != out1.data_ptr() and torch.equal(other, first)
    pool = m.runtime.pool
    assert pool.stats()["hits"] == 2 and pool.outstanding == 3
    m.unregister_shuffle(1)
    assert pool.outstanding == 1
    again, _ = m.get_reader(h2).read()
    assert torch.equal(again, first)
    m.stop()
    assert pool.outstanding == 0 and pool.free_counts() == {}


class PoisonPool(SlotPool):
    """Every buffer handed back is filled with 0xA5A5A5A5 first, so a
    reader of stale words would see them."""

    def put_shaped(self, arr):
        arr.fill_(-0x5A5A5A5B)                  # 0xA5A5A5A5
        super().put_shaped(arr)


def _key_filter(rec):
    return as_unsigned(rec[1]) % 3 != 0


@pytest.mark.parametrize("slot,f_in", [(256, 2), (4, 1), (4, 2)],
                         ids=["fused", "streaming-F1", "streaming-F2"])
@pytest.mark.parametrize("transport,fused", [("xla", True),
                                             ("pallas_ring", True),
                                             ("pallas_ring", False)])
def test_poisoned_pool_changes_nothing(slot, f_in, transport, fused):
    rows = _rows(3)
    reads = [dict(), dict(key_ordering=True), dict(aggregator="sum"),
             dict(keep_words=(0, 1, 2)),
             dict(aggregator="sum", row_filter=_key_filter,
                  keep_words=(0, 1, 3)),
             dict(start_partition=2, end_partition=6)]
    kw = dict(slot_records=slot, max_rounds_in_flight=f_in,
              transport=transport, ring_fused=fused, map_side_combine="on")
    results = []
    for pool_cls in (None, PoisonPool):
        m, h = _manager(rows, pool_cls, **kw)
        got = []
        for _ in range(2):                      # repeat: recycled buffers
            for rkw in reads:
                out, totals = m.get_reader(h, **rkw).read()
                got.append((out.clone(), totals.clone()))
        results.append(got)
        if pool_cls is PoisonPool:
            assert m.runtime.pool.stats()["hits"] > 0
        m.stop()
    for (o, t), (po, pt) in zip(*results):
        assert torch.equal(o, po) and torch.equal(t, pt)


# --- per-partition views against the reference ------------------------

def _pair(rows, **kw):
    ref_conf = RefConf(**kw)
    ref = RefManager(RefRuntime(ref_conf, devices=jax.devices()[:D]),
                     ref_conf)
    rh = ref.register_shuffle(4, D, ref_modulo(D, 1))
    ref.get_writer(rh).write(ref.runtime.shard_records(rows)).stop()
    port = ShuffleManager(MeshRuntime(ShuffleConf(**kw), D, device="cpu"))
    ph = port.register_shuffle(4, D, modulo_partitioner(D, 1))
    plan = port.get_writer(ph).write(port.runtime.shard_records(rows)).stop()
    return (ref, rh), (port, ph), plan


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_views_match_reference(split):
    rng = np.random.default_rng(5)
    rows = _rows(5, n=D * 48)
    rows[:, 1] = rng.integers(0, 64, len(rows))
    if split:                         # half the records on partition 3
        hot = rng.random(len(rows)) < 0.5
        rows[:, 1] = np.where(hot, 3 + 8 * rng.integers(0, 6, len(rows)),
                              rows[:, 1])
    (ref, rh), (port, ph), plan = _pair(
        rows, slot_records=4, max_rounds=5, max_rounds_in_flight=8)
    assert plan.split_factor == (2 if split else 1)
    ref_view = ref.get_reader(rh).read_view()
    view = port.get_reader(ph, key_ordering=True).read_view()
    pool = port.runtime.pool
    held = pool.outstanding
    for p in range(D):
        want = np.asarray(ref_view.partition(p))
        np.testing.assert_array_equal(records_from_torch(
            view.partition(p)), want)
        np.testing.assert_array_equal(
            port.get_reader(ph).read_partition(p),
            ref.get_reader(rh).read_partition(p))
        np.testing.assert_array_equal(
            port.get_reader(ph).read_partition(p), want.T)
    np.testing.assert_array_equal(view.totals, np.asarray(ref_view.totals))
    # the view owns its pages: more reads do not touch it
    assert torch.equal(view.retain().partition(0),
                       view.partition(0).clone())
    view.release()
    assert pool.outstanding == held
    view.release()                   # the last holder: pages go back
    assert pool.outstanding == held - 1
    with pytest.raises(RuntimeError, match="double release"):
        view.release()
    with pytest.raises(ValueError, match="out of range"):
        view.partition(D)
    with pytest.raises(ValueError, match="outside reader range"):
        port.get_reader(ph, 2, 4).read_partition(5)
    ref_view.release()
    ref.stop()
    port.stop()
