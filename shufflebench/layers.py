"""From a ``torch.profiler`` trace to the device time of each of the
program's layers, and the idle time each layer's host work leaves.

The program names its layers with ``record_function`` ranges
``shuffle:<layer>`` (``sparkrdma_tpu_torch/utils/profiling.py``: ``span``
and ``annotate``), on the clock of the device trace; a range's name is
read up to any ``#`` (``shuffle:exchange#s42`` is ``shuffle:exchange``).

- Every device operation (kernel, copy or set, chosen as ``trace.py``
  chooses them) is charged to the innermost range open, on the launching
  thread, when the host launched it: the launch is the ``cuda_runtime``
  or ``cuda_driver`` event with the operation's correlation id. The
  ranges are the program's and the harness's own (``trace.RANGES``), so
  an operation the program launched outside its ranges is charged to the
  harness's step (``read``, ``write_plan``, ...), and one launched
  outside every range to ``between``.
- An operation whose launch the trace lacks (the ring kernel: its
  library launches through its own static CUDA runtime, which the
  profiler does not see) is placed by its stream's order: the host
  launched it after the operation before it on its stream and before the
  one after it. If exactly one of the program's ranges opened and closed
  between those two launches, that range launched it; else it is charged
  to the innermost range open throughout, and without such neighbours to
  ``no_launch``.
- A range name's device time is the union of its operations' intervals
  inside the traced window (``trace.WINDOW``).
- Each idle gap of the window is named by the stack of ranges open on
  the window's thread at the gap's middle, innermost last.

``events`` reads the profile once into plain tuples; the rest is
arithmetic, kept apart so that the tests can drive it with made-up
events. Nothing here changes what ``trace.py`` reads.

``READINGS`` are the layers' readings, ms a traced job, each written as
a per-layer metric's ``read(run)`` over a run record that holds this
module's ``summary`` under ``"layers"``. ``run.py`` keeps no such key,
so they are not metrics of the benchmark: on a card,

    python3 -m shufflebench.layers --workload <cell> --seed <n>

sets the cell up as ``run.py`` does, times ``run.TRACED`` jobs without
the profiler, then traces as many (after one that takes the profiler's
start-up, as ``run.py``'s traced run does) and prints one JSON line:
the readings, the untraced and traced jobs' medians and ``digest``.
"""

import argparse
import itertools
import json
import statistics
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

from shufflebench import registry, trace

#: the program's range names start so
PREFIX = "shuffle:"
#: host activities that launch device work
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
#: charged where a launch lay outside every range / is missing
BETWEEN = "between"
NO_LAUNCH = "no_launch"
#: the layers the program's device work should fall in; work charged to
#: its other ranges (the exchange, the prep, a chunk) is launched between
#: them
NAMED = tuple(PREFIX + n for n in (
    "sample", "plan", "plan_pass", "map", "fill", "move", "fold", "tail"))

Range = Tuple[str, int, int, int]          # name, start, end, thread


def events(prof) -> Tuple[list, dict, list]:
    """``(device_ops, launches, ranges)`` of a finished profile:
    ``device_ops`` ``(name, start_ns, end_ns, correlation, stream)``,
    ``launches`` ``{correlation: (start_ns, thread)}`` and ``ranges``
    ``(name, start_ns, end_ns, thread)`` of the program's ranges, the
    harness's (``trace.RANGES``) and the traced window.

    A device operation's launch is the host runtime or driver call with
    its correlation id: a ``cuda_runtime`` or ``cuda_driver`` activity
    where the profiler names activities, else a host event linked to the
    torch op that made it (the op's id in ``linked_correlation_id``, which
    torch ops and ranges leave 0). Where no such call is in the trace,
    the launch is taken at the start of the op or range the operation is
    linked to."""
    from torch.autograd import DeviceType

    device_ops, links, calls, host, ranges = [], [], {}, {}, []
    harness = set(trace.RANGES) | {trace.WINDOW}
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if kind in trace._DEVICE_KINDS or (not kind and
                                               not e.is_user_annotation()):
                device_ops.append((e.name(), start, end, e.correlation_id(),
                                   e.device_resource_id()))
                links.append(e.linked_correlation_id())
            continue
        at = (start, e.start_thread_id())
        name = e.name().split("#")[0]
        if name.startswith(PREFIX) or name in harness:
            ranges.append((name, start, end, e.start_thread_id()))
        elif kind in LAUNCH_KINDS or (not kind and
                                      e.linked_correlation_id() > 0):
            calls[e.correlation_id()] = at
            continue
        host[e.correlation_id()] = at
    launches = {}
    for op, link in zip(device_ops, links):
        at = calls.get(op[3]) or (host.get(link) if link > 0 else None)
        if at is not None:
            launches[op[3]] = at
    return device_ops, launches, ranges


def _window(ranges: Sequence[Range]) -> Tuple[int, int, int]:
    for name, s, e, tid in ranges:
        if name == trace.WINDOW:
            return s, e, tid
    raise ValueError(f"the trace holds no {trace.WINDOW!r} range")


def open_stacks(ranges: Sequence[Range], points: Sequence[int]
                ) -> List[Tuple[str, ...]]:
    """For each point ``t`` the names of the ranges open at ``t``
    (``start <= t < end``), outermost first, in one sweep. Ranges that
    start together nest wider first."""
    marks = []
    for i, (_, s, e, _) in enumerate(ranges):
        marks.append((s, 1, s - e, i))
        marks.append((e, 0, 0, i))
    for j, t in enumerate(points):
        marks.append((t, 2, 0, j))
    marks.sort()
    stack: List[int] = []
    out: List[Tuple[str, ...]] = [()] * len(points)
    for _, kind, _, i in marks:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            # ranges of one thread nest, so this is nearly always the top
            for k in range(len(stack) - 1, -1, -1):
                if stack[k] == i:
                    del stack[k]
                    break
        else:
            out[i] = tuple(ranges[r][0] for r in stack)
    return out


def charge(device_ops, launches, ranges) -> List[str]:
    """The range each device operation is charged to: the innermost one
    open on the launching thread at its launch (module docstring; an
    operation without a launch is placed by :func:`_place`)."""
    by_thread: Dict[int, list] = defaultdict(list)
    for r in ranges:
        if r[0] != trace.WINDOW:
            by_thread[r[3]].append(r)
    names = [NO_LAUNCH] * len(device_ops)
    queries: Dict[int, list] = defaultdict(list)
    for i, op in enumerate(device_ops):
        launch = launches.get(op[3])
        if launch is not None:
            queries[launch[1]].append((i, launch[0]))
    for tid, qs in queries.items():
        stacks = open_stacks(by_thread.get(tid, []), [t for _, t in qs])
        for (i, _), st in zip(qs, stacks):
            names[i] = st[-1] if st else BETWEEN
    _place(device_ops, launches, by_thread, names)
    return names


def _place(device_ops, launches, by_thread, names) -> None:
    """Charge, in ``names``, each operation without a launch by its
    stream's order (module docstring)."""
    streams: Dict[int, list] = defaultdict(list)
    for i, op in enumerate(device_ops):
        streams[op[4] if len(op) > 4 else 0].append(i)
    for order in streams.values():
        order.sort(key=lambda i: device_ops[i][1])
        known = [k for k, i in enumerate(order)
                 if device_ops[i][3] in launches]
        for a, b in zip(known, known[1:]):
            if b - a < 2:
                continue
            lo = launches[device_ops[order[a]][3]]
            hi = launches[device_ops[order[b]][3]]
            if lo[1] != hi[1]:
                continue
            ranges = [r for r in by_thread.get(lo[1], ())
                      if r[0].startswith(PREFIX)]
            inside = [r for r in ranges if lo[0] < r[1] and r[2] < hi[0]]
            if len(inside) == 1:
                name = inside[0][0]
            else:
                ends = open_stacks(by_thread.get(lo[1], []),
                                   [lo[0], hi[0]])
                common = list(itertools.takewhile(
                    lambda xy: xy[0] == xy[1], zip(*ends)))
                name = common[-1][0] if common else BETWEEN
            for k in range(a + 1, b):
                names[order[k]] = name


def summarize(device_ops, launches, ranges) -> dict:
    """What the run's record keeps of the trace's layers, inside the
    traced window: ``intervals`` (each charged name's merged device
    intervals), ``device_s`` (their lengths), ``idle`` (each idle gap's
    range stack and length), ``idle_s`` (by the innermost range of the
    stack), ``seen`` and ``counts`` (the program's range names in the
    window, and how many of each) and ``ops_s`` (each range's time by
    operation name)."""
    lo, hi, tid = _window(ranges)
    charged: Dict[str, list] = defaultdict(list)
    ops_s: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for op, name in zip(device_ops, charge(device_ops, launches, ranges)):
        charged[name].append((op[1], op[2]))
        s, e = max(op[1], lo), min(op[2], hi)
        if e > s:
            ops_s[name][op[0][:80]] += (e - s) / 1e9
    intervals = {name: trace.clip(trace.union(iv), lo, hi)
                 for name, iv in charged.items()}
    intervals = {k: v for k, v in intervals.items() if v}
    ops3 = [op[:3] for op in device_ops]
    gaps = trace.gaps(ops3, lo, hi)
    mine = [r for r in ranges if r[3] == tid and r[0] != trace.WINDOW]
    stacks = open_stacks(mine, [(s + e) // 2 for s, e in gaps])
    idle = [(st, e - s) for st, (s, e) in zip(stacks, gaps)]
    idle_s: Dict[str, float] = defaultdict(float)
    for st, ns in idle:
        idle_s[st[-1] if st else BETWEEN] += ns / 1e9
    counts = Counter(r[0] for r in ranges if r[0].startswith(PREFIX)
                     and r[1] < hi and r[2] > lo)
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": trace.busy_ns(ops3, lo, hi) / 1e9,
            "intervals": intervals,
            "device_s": {k: sum(e - s for s, e in v) / 1e9
                         for k, v in intervals.items()},
            "idle": idle, "idle_s": dict(idle_s), "seen": sorted(counts),
            "counts": dict(counts),
            "ops_s": {k: dict(v) for k, v in ops_s.items()}}


def summary(prof) -> dict:
    """:func:`summarize` of a finished profile."""
    return summarize(*events(prof))


def union_s(layers: dict, names: Sequence[str]) -> float:
    """Seconds of the union of the device intervals charged to
    ``names``."""
    merged = trace.union(iv for n in names
                         for iv in layers["intervals"].get(n, ()))
    return sum(e - s for s, e in merged) / 1e9


def device_ms_per_job(run: dict, names: Sequence[str]):
    """Device ms a traced job charged to ``names``: their union over the
    traced window, over the traced jobs. None where the trace holds none
    of the ranges (a program without them) or no device work (a CPU
    run)."""
    layers = run.get("layers")
    jobs = len(run.get("traced_jobs") or ())
    if (not layers or not jobs or layers["busy_s"] <= 0
            or not set(names) & set(layers["seen"])):
        return None
    return 1e3 * union_s(layers, names) / jobs


def idle_ms_per_job(run: dict, inside: str, but_not: Sequence[str] = ()):
    """Idle ms a traced job whose range stack holds ``inside`` and whose
    innermost range is none of ``but_not``. None where the trace holds no
    ``inside`` range or no device work (a CPU run)."""
    layers = run.get("layers")
    jobs = len(run.get("traced_jobs") or ())
    if (not layers or not jobs or layers["busy_s"] <= 0
            or inside not in layers["seen"]):
        return None
    ns = sum(n for st, n in layers["idle"]
             if inside in st and st[-1] not in but_not)
    return ns / 1e6 / jobs


def digest(layers: dict, traced: Sequence[dict]) -> dict:
    """A line for the reader (not a metric): the ``traced`` jobs' median
    ms, then ms a job by charged range and by the innermost range of the
    idle gaps, and the shares the program's ranges cover: of the busy
    time, what is charged to a ``shuffle:*`` range or the harness's
    ``gen``; of what is charged to ``shuffle:*`` ranges, what falls in
    the ``NAMED`` layers; and each range's largest operations."""
    jobs = len(traced)
    per = 1e3 / max(jobs, 1)
    program = [n for n in layers["intervals"] if n.startswith(PREFIX)]
    busy = layers["busy_s"]
    covered = union_s(layers, program + ["gen"])
    inside = union_s(layers, program)
    return {
        "jobs": jobs,
        "job_ms_median": (statistics.median(j["seconds"] for j in traced)
                          * 1e3 if traced else None),
        "busy_ms": busy * per,
        "device_ms": {k: v * per for k, v in sorted(
            layers["device_s"].items(), key=lambda kv: -kv[1])},
        "idle_ms": {k: v * per for k, v in sorted(
            layers["idle_s"].items(), key=lambda kv: -kv[1])},
        "covered_share": covered / busy if busy else None,
        "named_share": (union_s(layers, NAMED) / inside if inside
                        else None),
        "ranges_per_job": {k: v / max(jobs, 1) for k, v in sorted(
            layers["counts"].items())},
        "top_ops_ms": {name: [[k, v * per] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:4]]
            for name, ops in layers["ops_s"].items()}}


#: each layer's reading (module docstring): what it sums, and the cells
#: in which it reads (``tail`` is left out of ``terasort.repartition``,
#: whose tail only zeroes and copies)
READINGS = {
    # the plan's partitioner passes, histograms and copy of the counts
    "plan_device_ms": lambda run: device_ms_per_job(
        run, ("shuffle:plan", "shuffle:plan_pass")),
    # partition ids, pushdown, the bucketing sort or the map-side combine
    "map_ms": lambda run: device_ms_per_job(run, ("shuffle:map",)),
    # the chunks' gathers into ``send`` and indexed copies into ``acc``;
    # the ring kernel, launched in ``shuffle:move``, is ``ring_roofline``'s
    "slots_ms": lambda run: device_ms_per_job(
        run, ("shuffle:fill", "shuffle:fold")),
    # the key sort and its gathers, or the reduce-side combine
    "tail_ms": lambda run: device_ms_per_job(run, ("shuffle:tail",)),
    # the card idle while the host dispatches a chunk, its paced wait out
    "dispatch_idle_ms": lambda run: idle_ms_per_job(
        run, "shuffle:chunk", but_not=("shuffle:queue_block",)),
}


def trace_jobs(cell, count: int):
    """``count`` jobs under the profiler after one that takes its
    start-up, inside the ``trace.WINDOW`` range, as ``run.py``'s traced
    run makes them; returns their records and the finished profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from shufflebench.cell import TRACED_JOBS, sync

    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    traced = []
    with profile(activities=acts) as prof:
        cell.job(cell.records(TRACED_JOBS, 0),
                 cell.sampler_seed(TRACED_JOBS, 0))
        sync(cell.device)
        with record_function(trace.WINDOW):
            for i in range(1, count + 1):
                records = cell.records(TRACED_JOBS, i)
                traced.append(cell.job(
                    records, cell.sampler_seed(TRACED_JOBS, i))[0])
                del records
            sync(cell.device)
    return traced, prof


def main(argv=None, device=None, overrides=None) -> int:
    """One cell's layers (module docstring); returns the exit code.
    ``device`` and ``overrides`` are ``run.main``'s, for the tests."""
    from shufflebench import run

    ap = argparse.ArgumentParser(description="One cell's layer readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)

    import torch

    from shufflebench.cell import WARMUP_JOBS, WINDOW_JOBS, Cell, sync

    if device is None:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    cell = Cell(registry.config(bench, wl["config"]),
                registry.mix(wl["traffic"]), args.seed, device, overrides)
    for i in range(run.WARMUP):
        cell.job(cell.records(WARMUP_JOBS, i),
                 cell.sampler_seed(WARMUP_JOBS, i))
        sync(cell.device)
    untraced = []
    for i in range(run.TRACED):
        records = cell.records(WINDOW_JOBS, i)
        untraced.append(cell.job(
            records, cell.sampler_seed(WINDOW_JOBS, i))[0]["seconds"])
        del records
    traced, prof = trace_jobs(cell, run.TRACED)
    cell.stop()
    rec = {"layers": summary(prof), "traced_jobs": traced}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device_kind": (torch.cuda.get_device_name(cell.device)
                        if cell.device.type == "cuda" else "cpu"),
        "readings": {k: f(rec) for k, f in READINGS.items()},
        "untraced_ms_median": statistics.median(untraced) * 1e3,
        "digest": digest(rec["layers"], traced)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
