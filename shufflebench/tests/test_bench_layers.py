"""The layers' reader (``layers.py``) on made-up events: an operation is
charged to the innermost range open at its launch, an idle gap is named
by the ranges open at its middle, and the program's ranges change
nothing that ``trace.py`` and the accepted readers read; and its
``main`` on the CPU at a small size."""

import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from shufflebench import layers, registry, run, trace

W = trace.WINDOW
#: the layers' readings
NEW = tuple(layers.READINGS)
#: the accepted per-layer readers
OLD = ("sample_ms", "plan_ms", "read_ms", "slot_fill", "wire_reduction",
       "ring_roofline", "device_idle_share")


def _ranges(tid=1):
    """A job in the window: its read holds an exchange with a map side, a
    chunk (a fill, a move and a fold) and a paced wait."""
    return [(W, 0, 1000, tid), ("read", 100, 900, tid),
            ("shuffle:exchange", 110, 890, tid),
            ("shuffle:map", 120, 200, tid),
            ("shuffle:chunk", 300, 500, tid),
            ("shuffle:fill", 310, 350, tid), ("shuffle:move", 350, 380, tid),
            ("shuffle:fold", 380, 420, tid),
            ("shuffle:queue_block", 600, 700, tid),
            ("shuffle:tail", 700, 850, tid)]


def _run(device_ops, launches, ranges, jobs=1):
    return {"layers": layers.summarize(device_ops, launches, ranges),
            "traced_jobs": [{"seconds": 0.1}] * jobs}


def _read(name, run):
    if name in layers.READINGS:
        return layers.READINGS[name](run)
    return registry.metric_reader(name)(run)


def test_open_stacks_nest_and_are_half_open():
    ranges = [("a", 0, 10, 1), ("b", 0, 5, 1), ("c", 5, 10, 1)]
    assert layers.open_stacks(ranges, [0, 4, 5, 9, 10]) == [
        ("a", "b"), ("a", "b"), ("a", "c"), ("a", "c"), ()]


def test_kernel_launched_in_map_counts_to_map_ms_only():
    # launched at 150, inside shuffle:map; it runs later, at 400-450
    ops = [("k", 400, 450, 7, 1)]
    run = _run(ops, {7: (150, 1)}, _ranges())
    assert run["layers"]["device_s"] == {"shuffle:map": 50e-9}
    assert _read("map_ms", run) == pytest.approx(50e-6)
    for name in ("plan_device_ms",):
        assert _read(name, run) is None           # no plan range here
    for name in ("slots_ms", "tail_ms"):
        assert _read(name, run) == 0.0
    # two jobs: per job
    assert _read("map_ms", _run(ops, {7: (150, 1)}, _ranges(), jobs=2)) \
        == pytest.approx(25e-6)


def test_charges_by_launch_thread_and_marks_the_unattributed():
    ops = [("fill", 10, 20, 1), ("other", 30, 40, 2), ("lost", 50, 60, 3),
           ("outside", 60, 70, 4), ("fold", 80, 90, 5)]
    ranges = _ranges() + [("shuffle:map", 0, 1000, 2)]   # another thread
    launches = {1: (320, 1), 2: (50, 2), 4: (950, 1), 5: (390, 1)}
    assert layers.charge(ops, launches, ranges) == [
        "shuffle:fill", "shuffle:map", layers.NO_LAUNCH, layers.BETWEEN,
        "shuffle:fold"]
    run = _run(ops, launches, ranges)
    assert _read("slots_ms", run) == pytest.approx(20e-6)


def test_idle_in_a_chunk_is_dispatch_idle_and_the_paced_wait_is_not():
    # busy except 430-470 (a chunk's host work after its fold) and
    # 620-680 (the paced wait)
    ops = [("k", 0, 430, 1), ("k", 470, 620, 2), ("k", 680, 1000, 3)]
    launches = {1: (0, 1), 2: (0, 1), 3: (0, 1)}
    run = _run(ops, launches, _ranges())
    lay = run["layers"]
    assert lay["idle_s"] == {"shuffle:chunk": 40e-9,
                             "shuffle:queue_block": 60e-9}
    assert _read("dispatch_idle_ms", run) == pytest.approx(40e-6)
    # a gap in a chunk's child (its move) counts; outside chunks it does not
    ops = [("k", 0, 355, 1), ("k", 375, 1000, 2)]
    assert _read("dispatch_idle_ms", _run(ops, launches, _ranges())) == \
        pytest.approx(20e-6)
    ops = [("k", 0, 250, 1), ("k", 270, 1000, 2)]
    run = _run(ops, launches, _ranges())
    assert _read("dispatch_idle_ms", run) == 0.0
    assert run["layers"]["idle_s"] == {"shuffle:exchange": 20e-9}


def test_nothing_to_read_without_the_program_ranges_or_a_card():
    harness = [r for r in _ranges() if not r[0].startswith("shuffle:")]
    ops = [("k", 400, 450, 7, 1)]
    run = _run(ops, {7: (150, 1)}, harness)
    assert run["layers"]["device_s"] == {"read": 50e-9}
    for name in NEW:
        assert _read(name, run) is None
    # a CPU run: ranges, no device work
    run = _run([], {}, _ranges())
    for name in NEW:
        assert _read(name, run) is None


def _trace_ops():
    return [("void ring_exchange_kernel<4>(x)", 360, 380, 1),
            ("sort", 400, 450, 2), ("gather", 500, 560, 3),
            ("k", 700, 800, 4)]


def _old_run(ranges3):
    jobs = [{"plan": {"num_rounds": 3, "capacity": 4096, "split_factor": 1,
                      "plan_parts": 8, "out_capacity": 0,
                      "total_records": 4 * 64 * 4096},
             "rounds_in_flight": 2, "partitions": 8, "record_bytes": 100,
             "wire": {"combine_dup_ratio": 0.9, "combine_in_records": 10,
                      "combine_out_records": 5, "combine_in_bytes": 160,
                      "combine_out_bytes": 80},
             "spans": {"read": 0.5, "write_plan": 0.25, "sample": 0.01}}]
    ops3 = [op[:3] for op in _trace_ops()]
    return {"jobs": jobs, "traced_jobs": jobs,
            "device_kind": "NVIDIA H100 80GB HBM3",
            "trace": trace.summary(ops3, ranges3)}


def test_program_ranges_change_nothing_trace_and_old_readers_read():
    harness = [r[:3] for r in _ranges() if not r[0].startswith("shuffle:")]
    program = [r[:3] for r in _ranges() if r[0].startswith("shuffle:")]
    ops3 = [op[:3] for op in _trace_ops()]
    assert trace.summary(ops3, harness) == trace.summary(ops3,
                                                         harness + program)
    without, with_ = _old_run(harness), _old_run(harness + program)
    assert without == with_
    # the new record key leaves the old readers as they were
    with_["layers"] = layers.summarize(
        _trace_ops(), {i: (155, 1) for i in range(1, 5)}, _ranges())
    for name in OLD:
        assert _read(name, copy.deepcopy(without)) == _read(name, with_)
    assert _read("ring_roofline", with_) is not None


def test_events_of_a_profile_keep_trace_events_as_they_were():
    """On a real (CPU) profile: ``trace.events`` returns the harness's
    ranges only, the same with the program's ranges inside them, and
    ``layers.events`` reads the program's ranges up to any ``#``."""
    def profiled(program):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(W):
                with record_function("read"):
                    if program:
                        with record_function("shuffle:exchange#s42"):
                            with record_function("shuffle:map"):
                                torch.ones(8).sum()
                    else:
                        torch.ones(8).sum()
        return prof

    names = {}
    for program in (False, True):
        prof = profiled(program)
        ops, ranges = trace.events(prof)
        names[program] = sorted(r[0] for r in ranges)
        assert ops == []
        dev, launches, lranges = layers.events(prof)
        assert dev == [] and launches == {}
        assert sorted(r[0] for r in lranges) == sorted(
            [W, "read"] + (["shuffle:exchange", "shuffle:map"]
                           if program else []))
        lay = layers.summarize(dev, launches, lranges)
        assert lay["busy_s"] == 0 and lay["seen"] == (
            ["shuffle:exchange", "shuffle:map"] if program else [])
    assert names[False] == names[True] == sorted([W, "read"])


def test_an_operation_without_its_launch_is_placed_by_stream_order():
    """The ring kernel's launch is not in the trace: it ran on the stream
    between a fill's gather and a fold's copy, so it was launched between
    their launches, where ``shuffle:move`` alone opened and closed."""
    ops = [("gather", 400, 420, 1, 7), ("ring", 420, 460, 2, 7),
           ("index_put", 460, 480, 3, 7), ("other stream", 465, 470, 4, 9)]
    launches = {1: (340, 1), 3: (390, 1)}
    names = layers.charge(ops, launches, _ranges())
    assert names == ["shuffle:fill", "shuffle:move", "shuffle:fold",
                     layers.NO_LAUNCH]
    # no range wholly between the neighbours' launches: the innermost
    # open throughout (both launched in fill; in fill and in move)
    launches = {1: (312, 1), 3: (340, 1)}
    assert layers.charge(ops, launches, _ranges())[1] == "shuffle:fill"
    launches = {1: (320, 1), 3: (360, 1)}
    assert layers.charge(ops, launches, _ranges())[1] == "shuffle:chunk"
    # two ranges between: the innermost range open throughout
    launches = {1: (305, 1), 3: (430, 1)}
    assert layers.charge(ops, launches, _ranges())[1] == "shuffle:chunk"


def test_main_traces_a_cell_on_the_cpu(capsys):
    """``python3 -m shufflebench.layers`` at a small size on the CPU: one
    line, the program's ranges seen as many times as the jobs make them,
    every device reading None (no card)."""
    rc = layers.main(["--workload", "terasort.sort", "--seed",
                      str(2 ** 31 + 3)], device="cpu",
                     overrides={"records_per_job": 1 << 12,
                                "conf": {"slot_records": 64}})
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device_kind"] == "cpu"
    assert line["readings"] == dict.fromkeys(NEW)
    assert line["untraced_ms_median"] > 0
    digest = line["digest"]
    assert digest["jobs"] == run.TRACED and digest["job_ms_median"] > 0
    per_job = digest["ranges_per_job"]
    for name in ("shuffle:sample", "shuffle:plan", "shuffle:exchange",
                 "shuffle:tail"):
        assert per_job[name] >= 1, name
    assert per_job["shuffle:map"] == 8          # one a source partition
