"""The whole slice: TeraSort through the SPI, port vs reference.

Both packages get the same records and the same splitters (the
reference's, carried across with ``interop``), and run register ->
write -> stop (plan) -> read(key_ordering=True). ``read()``'s ``out``
and ``totals`` must be bit-identical (tolerance 0).

Sizes are picked so that the output capacity is a power of two holding
two runs of ``fast_sort_run`` (160 records per partition -> 256): only
then do both sides take the merge-path sort, whose output is unique.
Elsewhere the reference's tail sorts by the key words alone, unstably,
and the order of equal keys is unspecified.
"""

import jax
import numpy as np
import pytest

from sparkrdma_tpu import MeshRuntime as RefRuntime
from sparkrdma_tpu import ShuffleConf as RefConf
from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
from sparkrdma_tpu.exchange.partitioners import range_partitioner as ref_range
from sparkrdma_tpu.meta.sampling import compute_splitters as ref_splitters
from sparkrdma_tpu.meta.sampling import make_sampler as ref_sampler
from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
from sparkrdma_tpu_torch.interop import (plan_from_reference,
                                         records_from_torch,
                                         splitters_from_numpy)
from sparkrdma_tpu_torch.workloads.terasort import (device_verify_sort,
                                                    random_records,
                                                    run_terasort,
                                                    validate_global_sort)

KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
             pack_sort_min_payload=0, wide_sort_min_payload=0)


def _reference(x, d, transport):
    conf = RefConf(transport=transport, **KNOBS)
    m = RefManager(RefRuntime(conf, devices=jax.devices()[:d]), conf)
    try:
        rt = m.runtime
        recs = rt.shard_records(x)
        spl = ref_splitters(np.asarray(ref_sampler(
            rt.mesh, rt.axis_name, conf.key_words, 64)(recs)), d)
        h = m.register_shuffle(1, d, ref_range(spl, conf.key_words))
        plan = m.get_writer(h).write(recs).stop()
        assert m._exchange._uses_fast_sort(plan.out_capacity,
                                           conf.key_words, "")
        out, totals = m.get_reader(h, key_ordering=True).read()
        return spl, plan, np.asarray(out), np.asarray(totals)
    finally:
        m.stop()


@pytest.mark.parametrize("d,transport,per", [(8, "xla", 160),
                                             (8, "pallas_ring", 160),
                                             (1, "xla", 512)])
def test_read_matches_reference(rng, d, transport, per):
    x = rng.integers(0, 2**32, size=(d * per, 4), dtype=np.uint32)
    spl, plan_r, out_r, tot_r = _reference(x, d, transport)

    conf = ShuffleConf(transport=transport, **KNOBS)
    m = ShuffleManager(MeshRuntime(conf, num_partitions=d, device="cpu"))
    recs = m.runtime.shard_records(x)
    h = m.register_shuffle(1, d, range_partitioner(splitters_from_numpy(spl),
                                                   conf.key_words))
    plan = m.get_writer(h).write(recs).stop()
    ref_plan = plan_from_reference(plan_r)
    np.testing.assert_array_equal(plan.counts, ref_plan.counts)
    assert (plan.num_rounds, plan.capacity, plan.out_capacity) == \
        (ref_plan.num_rounds, ref_plan.capacity, ref_plan.out_capacity)
    out, totals = m.get_reader(h, key_ordering=True).read()
    np.testing.assert_array_equal(totals.numpy(), tot_r)
    np.testing.assert_array_equal(records_from_torch(out), out_r)
    assert validate_global_sort(out, totals, x, conf.key_words,
                                plan.out_capacity)
    assert device_verify_sort(m, recs, out, totals, conf.key_words,
                              plan.out_capacity)
    m.stop()


def test_read_prefix_sort_matches_reference(rng, monkeypatch):
    """The tail's prefix sort through the SPI: 8 partitions of ~300
    records in a padded 512-record ``out_capacity``, so each partition
    sorts ceil(total / 128) runs (ragged stages, an odd run count) and
    zeroes the rest; bit-exact against the reference's masked sort."""
    from sparkrdma_tpu_torch.exchange import protocol
    from sparkrdma_tpu_torch.kernels import merge_sort

    seen = []

    def spy(cols, valid=None, run=1 << 15, n_valid=None):
        seen.append((cols.shape[1], valid, n_valid))
        return merge_sort.merge_sort_cols(cols, valid, run, n_valid)

    monkeypatch.setattr(protocol, "merge_sort_cols", spy)
    d, per = 8, 300
    x = rng.integers(0, 2**32, size=(d * per, 4), dtype=np.uint32)
    spl, plan_r, out_r, tot_r = _reference(x, d, "pallas_ring")
    conf = ShuffleConf(transport="pallas_ring", **KNOBS)
    m = ShuffleManager(MeshRuntime(conf, num_partitions=d, device="cpu"))
    recs = m.runtime.shard_records(x)
    h = m.register_shuffle(1, d, range_partitioner(splitters_from_numpy(spl),
                                                   conf.key_words))
    plan = m.get_writer(h).write(recs).stop()
    assert plan.out_capacity == plan_r.out_capacity == 512
    out, totals = m.get_reader(h, key_ordering=True).read()
    np.testing.assert_array_equal(totals.numpy(), tot_r)
    np.testing.assert_array_equal(records_from_torch(out), out_r)
    assert len(seen) == d
    for (cap, valid, n_valid), total in zip(seen, tot_r):
        assert (cap, valid, n_valid) == (512, None, int(total))
    assert any(-(-int(t) // 128) % 2 for t in tot_r)    # odd run counts
    m.stop()


@pytest.mark.parametrize("d,transport,fused,per", [
    (8, "xla", True, 300), (8, "pallas_ring", True, 300),
    (8, "pallas_ring", False, 300), (1, "xla", True, 2048)])
def test_port_run_terasort_validates(d, transport, fused, per):
    """The port's own workload (records made on the device from a seed)
    passes the host permutation check and the device check, at W = 25."""
    conf = ShuffleConf(transport=transport, ring_fused=fused, val_words=23,
                       **KNOBS)
    m = ShuffleManager(MeshRuntime(conf, num_partitions=d, device="cpu"))
    res, out, totals = run_terasort(m, per, seed=11, verify=True,
                                    device_verify=True)
    assert res.verified and res.records == d * per
    assert int(totals.sum()) == d * per
    assert out.shape[0] == 25


def test_device_verify_catches_corruption():
    conf = ShuffleConf(**KNOBS)
    m = ShuffleManager(MeshRuntime(conf, num_partitions=8, device="cpu"))
    recs = random_records(8 * 64, 4, seed=2, device="cpu")
    _, out, totals = run_terasort(m, 64, verify=False, input_records=recs)
    cap = out.shape[1] // 8

    def check(o):
        return device_verify_sort(m, recs, o, totals, 2, cap)

    assert check(out)
    bad = out.clone()
    bad[2, 0] ^= 1                            # one payload bit
    assert not check(bad)
    swapped = out.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]   # order within a partition
    assert not check(swapped)


def test_pack_mode_refused():
    """The reference's default geometry at W = 25 (pack mode, once
    refused) runs and passes both checks."""
    conf = ShuffleConf(val_words=23)          # reference default: pack
    m = ShuffleManager(MeshRuntime(conf, num_partitions=8, device="cpu"))
    assert m._exchange.sort_mode(25) == "pack"
    res, _, _ = run_terasort(m, 64, verify=True, device_verify=True)
    assert res.verified
    m.stop()
