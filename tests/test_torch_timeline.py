"""The port's in-span timeline, critical path and stall watchdog against
the reference's.

- ``EventTimeline`` records, bounds and drains as the reference's does;
- ``critical_path.attribute`` / ``verdict`` / ``enrich`` give exactly
  the reference's numbers on the events drained from one reference read;
- one fused and one streaming read (``slot_records`` 64, ``queue_depth``
  2) through both managers on the same records: the span field sets are
  identical, every field that is neither a time, an id nor a
  process-cumulative total is equal, and the drained events are equal as
  the sequence of ``(name, ph, extras other than times)``. The slot
  pool's ``pool:acquire`` / ``pool.outstanding`` events are compared
  apart: the port's streaming chunk stages its send buffer in the pool,
  which the reference's compiled chunk program holds internally, so
  the pool events (and ``pool_high_water``) differ by design;
- the watchdog fires through ``block_hook`` inside the armed wait and
  writes one ``stall`` line, while the read still completes.
"""

import time

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.obs import critical_path as pcp
from sparkrdma_tpu_torch.obs import journal as pj
from sparkrdma_tpu_torch.obs import timeline as ptl
from sparkrdma_tpu_torch.obs.watchdog import (StallWatchdog, dump_armed,
                                              install_state_dump)

D = 8
#: span fields that are times, ids or process-cumulative totals
_VOLATILE = {"span_id", "ts", "plan_s", "exchange_s", "sort_s", "events",
             "phase_s", "bottleneck", "trace_id", "pool_high_water",
             "spill_count", "degraded", "serde_encode_bytes",
             "serde_encode_s", "serde_decode_bytes", "serde_decode_s",
             "serde_columnar_encode_bytes", "serde_columnar_encode_s",
             "serde_columnar_decode_bytes", "serde_columnar_decode_s",
             "store_spill_bytes", "store_fetch_bytes",
             "store_prefetch_hits", "store_sync_fetches"}
#: event extras that are times (or a trace id)
_TIMES = {"t", "wait_s", "ms", "trace_id"}


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.exchange.partitioners import \
        hash_partitioner as ref_hash
    from sparkrdma_tpu.obs import critical_path as rcp
    from sparkrdma_tpu.obs import journal as rj
    from sparkrdma_tpu.obs import timeline as rtl

    return dict(Runtime=RefRuntime, Conf=RefConf, Manager=RefManager,
                hash=ref_hash, cp=rcp, journal=rj, timeline=rtl)


def _rows(seed=0, skew=False):
    n = D * (512 if skew else 256)
    rows = np.random.default_rng(seed).integers(1, 2**32, size=(n, 4),
                                                dtype=np.uint32)
    if skew:
        # two keys: ~256 records a (source, destination) pair, 4 rounds
        # of 64, more than the 2 in flight
        rows[:, 0] = 0
        rows[:, 1] = rows[:, 1] % 2 + 1
    return rows


def _read(which, ref, sink, rows, read_kw, **conf_kw):
    """One recorded read through ``which``'s manager (``"ref"``/``"port"``)
    with the journal at ``sink``; returns the manager (stopped)."""
    kw = dict(slot_records=64, queue_depth=2, metrics_sink=str(sink),
              collect_shuffle_read_stats=True, **conf_kw)
    if which == "ref":
        conf = ref["Conf"](**kw)
        m = ref["Manager"](ref["Runtime"](conf), conf)
        part = ref["hash"](D, 2)
    else:
        m = ShuffleManager(MeshRuntime(ShuffleConf(**kw), D, device="cpu"))
        part = hash_partitioner(D, 2)
    try:
        h = m.register_shuffle(77, D, part)
        m.get_writer(h).write(m.runtime.shard_records(rows)).stop(True)
        m.get_reader(h, **read_kw(which)).read()
    finally:
        m.stop()
    return m


def _events(span, pool: bool):
    return [(e["name"], e["ph"],
             tuple(sorted((k, v) for k, v in e.items() if k not in _TIMES
                          and k not in ("name", "ph"))))
            for e in span["events"]
            if e["name"].startswith("pool") == pool]


def _filter(which):
    if which == "ref":
        def keep(r):
            return (r[2] & 1) == 0
    else:
        def keep(r):
            return (r[2] & 1) == 0
    keep.cache_key = "odd-out"
    return keep


READS = {
    "sorted": lambda which: dict(key_ordering=True),
    "agg_filter_project": lambda which: dict(
        aggregator="sum", row_filter=_filter(which), keep_words=(0, 1, 2)),
}


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("regime", ["fused", "streaming"])
def test_read_span_and_events_match_reference(ref, tmp_path, regime, read):
    rows = _rows(1, skew=regime == "streaming")
    extra = dict(map_side_combine="on") if read != "sorted" else {}
    spans = {}
    for which in ("ref", "port"):
        sink = tmp_path / f"{which}.jsonl"
        _read(which, ref, sink, rows, READS[read], **extra)
        spans[which] = [d for d in pj.read_entries(str(sink))
                        if d.get("kind") is None]
    (r,), (p,) = spans["ref"], spans["port"]
    assert set(p) == set(r)
    want = {k: v for k, v in r.items() if k not in _VOLATILE}
    got = {k: v for k, v in p.items() if k not in _VOLATILE}
    assert got == want
    if regime == "streaming":
        assert p["rounds"] > 2 and p["dispatches"] > 1
    else:
        assert p["dispatches"] == 1
    if read != "sorted":
        assert p["combine_in_records"] > 0 and p["pushdown_words_dropped"]
    assert _events(p, pool=False) == _events(r, pool=False)
    assert _events(p, pool=True), "the port's pool acquires are recorded"
    assert sum(p["phase_s"].values()) == pytest.approx(
        p["plan_s"] + p["exchange_s"] + p["sort_s"], abs=1e-5)


@pytest.mark.parametrize("regime", ["fused", "streaming"])
def test_ring_reads_add_only_structural_round_events(ref, tmp_path, regime):
    """The fused ring kernel's reads record one ``ring:round`` pair per
    round (inside ``exchange:fused``, or after each chunk's dispatch);
    without them, the events are the reference's ``xla`` read's."""
    rows = _rows(2, skew=regime == "streaming")
    spans = {}
    for which, transport in (("ref", "xla"), ("port", "pallas_ring")):
        sink = tmp_path / f"{which}.jsonl"
        _read(which, ref, sink, rows, READS["sorted"], transport=transport)
        (spans[which],) = [d for d in pj.read_entries(str(sink))
                           if d.get("kind") is None]
    p, r = spans["port"], spans["ref"]
    ring = [e for e in _events(p, pool=False) if e[0] == "ring:round"]
    # a streaming chunk launches max_rounds_in_flight (2) rounds, the
    # last one past the plan's rounds too
    launched = p["rounds"] if regime == "fused" else -(-p["rounds"] // 2) * 2
    assert len(ring) == 2 * launched
    assert [e for e in _events(p, pool=False) if e[0] != "ring:round"] \
        == _events(r, pool=False)


# ---------------------------------------------------------------------
# the timeline and the critical path
# ---------------------------------------------------------------------
def test_timeline_records_bounds_and_drains(ref):
    for mod in (ptl, ref["timeline"]):
        tl = mod.EventTimeline(capacity=3)
        tl.begin("chunk", chunk=0)
        tl.event("chunk:dispatch", chunk=0, rounds=2)
        tl.counter("chunks.outstanding", 1)
        tl.end("chunk", chunk=0)             # past capacity: dropped
        ev = tl.drain()
        assert [(e["name"], e["ph"]) for e in ev] == [
            ("chunk", "B"), ("chunk:dispatch", "i"),
            ("chunks.outstanding", "C"), ("timeline:dropped", "i")]
        assert ev[-1]["n"] == 1 and ev[2]["v"] == 1
        assert tl.drain() == [] and len(tl) == 0
        mod.NULL_TIMELINE.event("x")
        assert len(mod.NULL_TIMELINE) == 0
        with pytest.raises(ValueError):
            mod.EventTimeline(capacity=0)


def test_record_active_prefers_thread_scope():
    glob, mine = ptl.EventTimeline(), ptl.EventTimeline()
    prev = ptl.set_active(glob)
    try:
        with ptl.scoped_active(mine):
            ptl.record_active("a")
        ptl.record_active("b")
        with ptl.scoped_active(None):
            ptl.record_active("c")
    finally:
        ptl.set_active(prev)
    assert [e["name"] for e in mine.drain()] == ["a"]
    assert [e["name"] for e in glob.drain()] == ["b", "c"]


@pytest.fixture(scope="module")
def ref_events(ref, tmp_path_factory):
    """The events drained from one reference streaming read."""
    sink = tmp_path_factory.mktemp("cp") / "r.jsonl"
    _read("ref", ref, sink, _rows(3, skew=True), READS["sorted"])
    (span,) = ref["journal"].read_journal(str(sink))
    return span


@pytest.mark.parametrize("wall_scale", [0.5, 1.0, 3.0])
def test_critical_path_matches_reference(ref, ref_events, wall_scale):
    ev = ref_events.events
    wall = (ref_events.plan_s + ref_events.exchange_s) * wall_scale
    got = pcp.attribute(ev, wall)
    assert got == ref["cp"].attribute(ev, wall)
    assert sum(got.values()) == pytest.approx(wall, abs=1e-5)
    assert pcp.verdict(got, ev) == ref["cp"].verdict(got, ev)
    assert pcp.partition_to_wall(got, wall * 2) == \
        ref["cp"].partition_to_wall(got, wall * 2)
    assert pcp.merge_phases([ref_events, ref_events]) == \
        ref["cp"].merge_phases([ref_events, ref_events])


@pytest.mark.parametrize("case", ["spill", "codec", "admission"])
def test_verdicts_match_reference(ref, case):
    ev = {"spill": [{"t": 0.0, "ph": "i", "name": "spill:fetch",
                     "sync": True}],
          "codec": [{"t": 0.0, "ph": "B", "name": "serde:encode"},
                    {"t": 0.5, "ph": "E", "name": "serde:encode"}],
          "admission": [{"t": 0.0, "ph": "i", "name": "admission:wait",
                         "ms": 400.0}]}[case]
    ph = pcp.attribute(ev, 1.0)
    assert ph == ref["cp"].attribute(ev, 1.0)
    assert pcp.verdict(ph, ev) == ref["cp"].verdict(ph, ev)
    spans = [{"process_index": 0, "exchange_s": 1.0, "bottleneck": "x"},
             {"process_index": 1, "exchange_s": 3.0,
              "bottleneck": "codec-bound"}]
    assert pcp.straggler_delta(spans) == ref["cp"].straggler_delta(spans)
    assert pcp.shuffle_verdict(spans) == ref["cp"].shuffle_verdict(spans)


def test_phase_and_verdict_sets_match_reference(ref):
    assert pcp.PHASES == ref["cp"].PHASES
    assert pcp.VERDICTS == ref["cp"].VERDICTS
    assert pcp.PHASE_OF == ref["cp"].PHASE_OF


# ---------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------
def test_blocked_chunk_journals_one_stall(tmp_path):
    """A chunk wait held past ``watchdog_timeout_s`` by ``block_hook``
    journals one stall line with the in-flight state while the read is
    still blocked; the read completes and its span follows."""
    sink = tmp_path / "stall.jsonl"
    conf = ShuffleConf(slot_records=64, queue_depth=2,
                       metrics_sink=str(sink), watchdog_timeout_s=0.05)
    m = ShuffleManager(MeshRuntime(conf, D, device="cpu"))
    held = []
    try:
        h = m.register_shuffle(83, D, hash_partitioner(D, 2))
        m.get_writer(h).write(m.runtime.shard_records(
            _rows(4, skew=True))).stop(True)

        def hook(j):
            if not held:                      # hold the first wait only
                held.append(j)
                time.sleep(0.4)
                # the stall line lands while the wait is still blocked
                assert [e for e in pj.read_entries(str(sink))
                        if e.get("kind") == "stall"]

        m._exchange.block_hook = hook
        m.get_reader(h).read()
    finally:
        m.stop()
    entries = pj.read_entries(str(sink))
    (stall,) = [e for e in entries if e.get("kind") == "stall"]
    assert stall["desc"] == "queue:block" and stall["shuffle_id"] == 83
    assert stall["chunk"] == held[0] and stall["queue"] == 2
    assert stall["elapsed_s"] >= 0.05 and "pool_high_water" in stall
    (span,) = pj.read_journal(str(sink))
    assert stall["span_id"] == span.span_id
    assert "stall" in [e["name"] for e in span.events]
    assert m.watchdog.stall_count == 1
    assert m.metrics.counter("watchdog.stalls").value == 1


def test_watchdog_off_and_state_dump():
    wd = StallWatchdog(0.0)
    assert not wd.enabled
    with wd.armed("x"):
        assert dump_armed(sink=lambda s: None) == []
    wd = StallWatchdog(30.0)
    with wd.armed("queue:block", chunk=3):
        (rec,) = dump_armed(sink=lambda s: None)
        assert rec["desc"] == "queue:block" and rec["chunk"] == 3
    assert wd.stall_count == 0
    out = []
    import threading

    t = threading.Thread(target=lambda: out.append(install_state_dump()))
    t.start()
    t.join()
    assert out == [False]                 # off the main thread


def test_watchdog_fires_once_per_wait_and_parks(monkeypatch):
    """The poll thread fires a stalled wait once, never a wait that ends
    in time, and parks when nothing has been armed for a while. Each
    stalled wait lasts until its stall fires (a deadline of 10 s), so a
    loaded host that wakes the poll thread late delays the test and
    does not fail it."""
    from sparkrdma_tpu_torch.obs import watchdog as wdm
    from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

    def stall_until(count):
        deadline = time.monotonic() + 10.0
        while wd.stall_count < count and time.monotonic() < deadline:
            time.sleep(0.01)
        return wd.stall_count

    monkeypatch.setattr(wdm, "_IDLE_S", 0.1)
    reg = MetricsRegistry()
    wd = StallWatchdog(0.08, metrics=reg)
    with wd.armed("fast"):
        pass
    with wd.armed("slow", chunk=1):
        assert stall_until(1) == 1          # fired during the wait
    assert wd.stall_count == 1 and reg.counter("watchdog.stalls").value == 1
    assert wd.last_stall["desc"] == "slow" and wd.last_stall["chunk"] == 1
    # not before its timeout (the 1.25x cadence bound is the chip
    # smoke's to read: a loaded test host may delay the poll thread)
    assert wd.last_stall["elapsed_s"] >= 0.08
    deadline = time.monotonic() + 10.0
    while wd._poller is not None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert wd._poller is None
    with wd.armed("again"):                   # a parked watchdog restarts
        assert stall_until(2) == 2
    assert wd.stall_count == 2 and wd.last_stall["desc"] == "again"


def test_stall_counter_is_bumped_before_the_log_line(monkeypatch):
    """The registry's ``watchdog.stalls`` is bumped under the lock that
    bumps ``stall_count``, before the stall is logged: with the log call
    held 50 ms, the counter equals ``stall_count`` the moment the count
    reads 1."""
    from sparkrdma_tpu_torch.obs import watchdog as wdm
    from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry

    logged = []

    def slow_error(*a, **k):
        time.sleep(0.05)
        logged.append(a[0])

    monkeypatch.setattr(wdm.log, "error", slow_error)
    reg = MetricsRegistry()
    wd = StallWatchdog(0.02, metrics=reg)
    seen = None
    with wd.armed("slow"):
        deadline = time.monotonic() + 10.0
        while wd.stall_count < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        seen = (wd.stall_count, reg.counter("watchdog.stalls").value)
        while not logged and time.monotonic() < deadline:
            time.sleep(0.005)
    assert seen == (1, 1)
    assert logged and logged[0].startswith("shuffle stall")
