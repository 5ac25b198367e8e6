"""The port's profiling hooks (``utils/profiling.py``) on the CPU.

``trace`` writes a Chrome trace whose ranges include the read's
``shuffle:exchange#s<span_id>`` (the id of its journal span) and the
writer's ``shuffle:plan``; ``maybe_trace`` is a no-op without a
directory; on a CPU device ``annotate`` never touches NVTX. The layer
spans inside the plan and the read (``span``) open no range at all
without a profiler, and under one appear as many times, and nested, as
the exchange's structure says; ``exchange.slots_moved`` counts what the
benchmark's arithmetic counts. The card's side (the kernels' launches in
the same trace) is held by ``chip_smoke.py``'s ``obs`` phase and the
benchmark's traced runs.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       modulo_partitioner,
                                                       range_partitioner)
from sparkrdma_tpu_torch.meta.sampling import compute_splitters, make_sampler
from sparkrdma_tpu_torch.obs.journal import read_journal
from sparkrdma_tpu_torch.utils import profiling

D = 8


def _names(trace_dir):
    with open(trace_dir / profiling.TRACE_FILE) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


@pytest.fixture
def no_nvtx(monkeypatch):
    """NVTX must not be reached on the CPU: any call fails the test."""
    def boom(*a, **k):
        raise AssertionError("NVTX touched on a CPU device")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)


def test_trace_holds_the_span_range(tmp_path, no_nvtx):
    sink = tmp_path / "j.jsonl"
    m = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=64,
                                               metrics_sink=str(sink)), D,
                                   device="cpu"))
    rows = np.random.default_rng(0).integers(1, 2**32, size=(D * 16, 4),
                                             dtype=np.uint32)
    try:
        h = m.register_shuffle(5, D, modulo_partitioner(D))
        with profiling.trace(str(tmp_path / "tr")):
            m.get_writer(h).write(m.runtime.shard_records(rows)).stop(True)
            m.get_reader(h).read()
    finally:
        m.stop()
    (span,) = read_journal(str(sink))
    names = _names(tmp_path / "tr")
    assert f"shuffle:exchange#s{span.span_id}" in names
    assert "shuffle:plan" in names


def test_span_name_without_journal(no_nvtx, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate_span("shuffle:exchange", 0, "cpu"):
            torch.ones(8).sum()
        with profiling.annotate_span("shuffle:exchange", 42,
                                     torch.device("cpu")):
            torch.ones(8).sum()
    names = _names(tmp_path)
    assert {"shuffle:exchange", "shuffle:exchange#s42"} <= names


def test_maybe_trace_noop(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []
    with profiling.maybe_trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / profiling.TRACE_FILE).exists()


def test_annotate_on_a_cuda_device_opens_nvtx(monkeypatch):
    """The NVTX half, with the NVTX calls recorded instead of made (the
    CPU build has no NVTX library)."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with profiling.annotate_span("shuffle:exchange", 7, "cuda"):
        calls.append(("body",))
    assert calls == [("push", "shuffle:exchange#s7"), ("body",), ("pop",)]
    calls.clear()
    with pytest.raises(ValueError):
        with profiling.annotate("x", "cuda:0"):
            raise ValueError
    assert calls == [("push", "x"), ("pop",)]


# ---------------------------------------------------------------------
# the layer spans inside the plan and the read
# ---------------------------------------------------------------------
#: the timeline tests' shapes: 64-record slots, 2 chunks in flight; the
#: streaming read's plan splits (12 rounds against ``max_rounds`` 6 under
#: the hash partitioner) and streams 3 chunks of 2 rounds or more, so a
#: chunk waits in the queue
CONF = dict(slot_records=64, queue_depth=2, max_rounds=6,
            transport="pallas_ring")


def _skewed_rows(regime):
    """Two keys over ``D * 1536`` records (768 a pair, 12 rounds of 64)
    for the streaming regime; uniform keys (one round) for the fused."""
    n = D * (1536 if regime == "streaming" else 256)
    rows = np.random.default_rng(5).integers(1, 2**32, size=(n, 4),
                                             dtype=np.uint32)
    if regime == "streaming":
        rows[:, 0] = 0
        rows[:, 1] = rows[:, 1] % 2 + 1
    return rows


def _job(regime, read_kw, sampled=False, **conf):
    """Sample (``sampled``), plan and read one shuffle; returns the
    manager (stopped), the plan and the read's output."""
    m = ShuffleManager(MeshRuntime(ShuffleConf(**dict(CONF, **conf)), D,
                                   device="cpu"))
    try:
        recs = m.runtime.shard_records(_skewed_rows(regime))
        part = hash_partitioner(D, 2)
        if sampled:
            sampler = make_sampler(D, 2, 16, seed=3, runtime=m.runtime)
            part = range_partitioner(compute_splitters(sampler(recs), D), 2)
        h = m.register_shuffle(9, D, part)
        plan = m.get_writer(h).write(recs).stop(True)
        out, totals = m.get_reader(h, **read_kw).read()
    finally:
        m.stop()
    return m, plan, out, totals


READS = {"sorted": dict(key_ordering=True),
         "aggregated": dict(aggregator="sum")}


@pytest.fixture
def no_ranges(monkeypatch):
    """Any profiler range or NVTX range fails the test."""
    def boom(*a, **k):
        raise AssertionError("a range was opened with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("regime", ["fused", "streaming"])
def test_untraced_reads_open_no_range(no_ranges, regime, read):
    """With no profiler active, a sampled plan and a fused or streaming
    read complete without one ``record_function`` or NVTX call: every
    span is the shared no-op."""
    m, plan, out, totals = _job(regime, READS[read], sampled=True)
    assert (plan.num_rounds > 2) == (regime == "streaming")
    assert int(totals.sum()) > 0
    assert profiling.span("shuffle:map", "cuda") is \
        profiling.span("shuffle:chunk")


def _ranges(prof):
    """``(name up to any '#', start_ns, end_ns)`` of the program's ranges."""
    return [(e.name().split("#")[0], e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("shuffle:")]


def _parent(ranges, r):
    """The name of the narrowest other range holding ``r``, or None."""
    best = None
    for o in ranges:
        if o is not r and o[1] <= r[1] and r[2] <= o[2] and (
                best is None or o[2] - o[1] < best[2] - best[1]):
            best = o
    return best[0] if best else None


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("regime", ["fused", "streaming"])
def test_traced_reads_give_each_layer_range(regime, read):
    """Under ``torch.profiler`` each layer's range appears as often as
    the plan and the exchange's structure say, inside its parent."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m, plan, _, _ = _job(regime, READS[read], sampled=True)
    ranges = _ranges(prof)
    count = collections.Counter(name for name, _, _ in ranges)
    parents = collections.defaultdict(set)
    for r in ranges:
        parents[r[0]].add(_parent(ranges, r))
    chunks = m.metrics.counter("exchange.stream_chunks").value
    blocks = m.metrics.counter("exchange.queue_blocks").value
    # the sampler's draw and the splitters; the plan and its passes
    assert count["shuffle:sample"] == 2
    assert count["shuffle:plan"] == 1
    assert parents["shuffle:plan_pass"] == {"shuffle:plan"}
    assert count["shuffle:plan_pass"] == (2 if plan.split_factor > 1 else 1)
    assert count["shuffle:exchange"] == 1
    assert count["shuffle:combine_gate"] == (read == "aggregated")
    assert count["shuffle:map"] == D
    if regime == "fused":
        assert plan.split_factor == 1 and chunks == 0
        assert count["shuffle:fused"] == 1
        assert parents["shuffle:fused"] == {"shuffle:exchange"}
        assert parents["shuffle:map"] == {"shuffle:fused"}
        # the ring's fills by source, one launch, compaction and tail by
        # destination
        assert count["shuffle:fill"] == D and count["shuffle:move"] == 1
        assert count["shuffle:fold"] == D and count["shuffle:tail"] == D
        for name in ("fill", "move", "fold", "tail"):
            assert parents[f"shuffle:{name}"] == {"shuffle:fused"}
        assert not count["shuffle:chunk"] and not count["shuffle:prep"]
        return
    assert plan.split_factor > 1 and chunks == -(-plan.num_rounds // 2)
    assert blocks == chunks - 2 >= 1
    assert count["shuffle:prep"] == 1
    assert parents["shuffle:prep"] == {"shuffle:exchange"}
    assert parents["shuffle:map"] == {"shuffle:prep"}
    assert count["shuffle:chunk"] == chunks
    assert parents["shuffle:chunk"] == {"shuffle:exchange"}
    assert count["shuffle:queue_block"] == blocks
    assert parents["shuffle:queue_block"] == {"shuffle:exchange"}
    assert count["shuffle:move"] == chunks
    assert parents["shuffle:move"] == {"shuffle:chunk"}
    # a fill and a fold a chunk, and one more of each outside the loop:
    # the gather source (in prep) and the accumulator's zeroing
    assert count["shuffle:fill"] == chunks + 1
    assert parents["shuffle:fill"] == {"shuffle:chunk", "shuffle:prep"}
    assert count["shuffle:fold"] == chunks + 1
    assert parents["shuffle:fold"] == {"shuffle:chunk", "shuffle:exchange"}
    # a tail a partition, and the output's zeroing
    assert count["shuffle:tail"] == D + 1
    assert parents["shuffle:tail"] == {"shuffle:exchange"}
    if read == "aggregated":
        assert parents["shuffle:combine_gate"] == {"shuffle:exchange"}


@pytest.mark.parametrize("regime", ["fused", "streaming"])
def test_slots_moved_counts_the_benchmarks_slots(regime):
    """``exchange.slots_moved`` (host ints, bumped by each fused launch
    and each streaming chunk) equals the benchmark's own arithmetic from
    the plan (``shufflebench/metrics/_common.py::slots_moved``)."""
    from shufflebench.metrics._common import slots_moved

    m, plan, _, _ = _job(regime, READS["sorted"])
    job = {"plan": {"num_rounds": plan.num_rounds, "capacity": plan.capacity,
                    "plan_parts": int(plan.counts.shape[1])},
           "rounds_in_flight": m.conf.max_rounds_in_flight,
           "partitions": D}
    moved = m.metrics.counter("exchange.slots_moved").value
    assert moved == slots_moved(job) > 0
    assert (m.metrics.counter("exchange.stream_chunks").value > 0) == (
        regime == "streaming")


def test_manager_wire_stats_is_the_exchanges():
    """The public accounting is the exchange's, dict for dict: two keys
    over every record leave the combine as a few records a source."""
    m, _, _, _ = _job("streaming", dict(aggregator="sum"),
                      map_side_combine="on")
    stats = m.wire_stats()
    assert stats == m._exchange.wire_stats()
    assert stats["combine_in_records"] == D * 1536
    assert 0 < stats["combine_out_records"] < D * 64
