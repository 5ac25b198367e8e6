"""The metric arithmetic: the window's rate and tail, the idle share as a
union of intervals, the slots and bytes counted from a plan."""

import pytest

from shufflebench import registry, run, trace
from shufflebench.metrics import _common


def test_p95_is_nearest_rank():
    assert run.p95(range(1, 101)) == 95
    assert run.p95([5.0]) == 5.0
    # 20 values: the 19th; one value in twenty lies above it
    assert run.p95(list(range(20))) == 18


def test_union_counts_overlap_once():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.union((s, e) for _, s, e in ops) == [(0, 15), (20, 30)]
    assert trace.busy_ns(ops, 0, 40) == 25
    assert trace.busy_ns(ops, 8, 22) == 9          # clipped to the window
    assert trace.gaps(ops, 0, 40) == [(15, 20), (30, 40)]


def test_idle_gaps_named_by_innermost_open_range():
    ops = [("k", 0, 10), ("k", 20, 30)]
    ranges = [(trace.WINDOW, 0, 50), ("read", 5, 25), ("gen", 42, 48),
              ("shuffle:plan", 0, 50)]
    # (10, 20) in the read; (30, 50)'s middle, 40, in no job range
    assert trace.idle_by_range(ops, ranges, 0, 50) == {"read": 10,
                                                       "between": 20}
    s = trace.summary(ops, ranges)
    assert s["window_s"] == 50e-9 and s["busy_s"] == 20e-9
    assert s["breakdown"]["device_ops"] == [["k", 20e-9]]


def _job(rounds, capacity, split=1, total=1000, wire=None, f_in=2,
         parts=8, record_bytes=100):
    return {"plan": {"num_rounds": rounds, "capacity": capacity,
                     "split_factor": split, "plan_parts": parts * split,
                     "out_capacity": 0, "total_records": total},
            "rounds_in_flight": f_in, "partitions": parts,
            "record_bytes": record_bytes, "wire": wire or {},
            "spans": {"read": 0.5, "write_plan": 0.25}}


def test_slots_round_up_to_whole_chunks_once_streaming():
    # 3 rounds stream in 2 chunks of 2; 64 pairs x 2 splits x 4096 slots
    assert _common.slots_moved(_job(3, 4096, split=2)) == 4 * 8 * 16 * 4096
    # 2 rounds fit one fused exchange: not rounded
    assert _common.slots_moved(_job(2, 4096)) == 2 * 8 * 8 * 4096


def test_carried_after_the_combine():
    wire = {"combine_dup_ratio": 0.5, "combine_in_records": 1000,
            "combine_out_records": 250, "combine_in_bytes": 16000,
            "combine_out_bytes": 4000}
    assert _common.carried(_job(1, 64, wire=wire)) == (250, 16.0)
    assert _common.carried(_job(1, 64, total=999)) == (999, 100)


def test_layer_readers():
    jobs = [_job(3, 4096, total=4 * 64 * 4096)]
    run_rec = {"jobs": jobs, "traced_jobs": jobs, "device_kind":
               "NVIDIA H100 80GB HBM3",
               "trace": {"window_s": 1.0, "busy_s": 0.75,
                         "ops_s": {"void ring_exchange_kernel<4>(x)": 2e-3,
                                   "other": 1.0}}}
    assert registry.metric_reader("slot_fill")(run_rec) == 100.0
    assert registry.metric_reader("read_ms")(run_rec) == 500.0
    assert registry.metric_reader("plan_ms")(run_rec) == 250.0
    assert registry.metric_reader("sample_ms")(run_rec) is None
    assert registry.metric_reader("device_idle_share")(run_rec) == 25.0
    least = 2 * 4 * 64 * 4096 * 100 / 3.35e12
    assert registry.metric_reader("ring_roofline")(run_rec) == \
        pytest.approx(100 * least / 2e-3)
    # no aggregator: nothing to read; a declined gate reads 1
    assert registry.metric_reader("wire_reduction")(run_rec) is None
    jobs[0]["wire"] = {"combine_dup_ratio": 0.01}
    assert registry.metric_reader("wire_reduction")(run_rec) == 1.0
    # an unknown card or no kernel in the trace: nothing to read
    assert registry.metric_reader("ring_roofline")(
        dict(run_rec, device_kind="cpu")) is None
    run_rec["trace"]["ops_s"] = {"other": 1.0}
    assert registry.metric_reader("ring_roofline")(run_rec) is None
