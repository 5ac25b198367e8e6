"""From a ``torch.profiler`` trace to the device's busy time, its idle
gaps and the time of each kernel.

The profiler's raw events are read once (``events``) into plain tuples;
everything after that is arithmetic on intervals, kept apart so that
the tests can drive it with made-up events.

- device operations: kernels, copies and sets on the card, whatever
  stream they ran on. Busy time is the length of the union of their
  intervals, so two streams at once count once.
- host ranges: the ``record_function`` ranges the benchmark opens around
  its calls into the program (``RANGES``); an idle gap is named by the
  innermost one open at the gap's middle, or ``between`` where none is.
"""

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

#: the benchmark's host ranges, one per step of a job (and ``gen``, the
#: making of its records outside the job's clock)
RANGES = ("gen", "sample", "register", "write_plan", "read", "unregister")
#: the range around the traced jobs: the traced window
WINDOW = "traced_jobs"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[int, int]


def events(prof) -> Tuple[list, list]:
    """``(device_ops, host_ranges)`` of a finished profile: lists of
    ``(name, start_ns, end_ns)``. Host ranges are those of ``RANGES`` and
    ``WINDOW``."""
    from torch.autograd import DeviceType

    device_ops, ranges = [], []
    wanted = set(RANGES) | {WINDOW}
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if kind in _DEVICE_KINDS or (not kind and
                                         not e.is_user_annotation()):
                device_ops.append((e.name(), start, end))
        elif e.name() in wanted:
            ranges.append((e.name(), start, end))
    return device_ops, ranges


def window(ranges: Sequence[tuple]) -> Interval:
    """The traced window: the ``WINDOW`` range."""
    for name, s, e in ranges:
        if name == WINDOW:
            return s, e
    raise ValueError(f"the trace holds no {WINDOW!r} range")


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def busy_ns(device_ops: Sequence[tuple], lo: int, hi: int) -> int:
    """Time in ``[lo, hi)`` in which some device operation ran."""
    merged = clip(union((s, e) for _, s, e in device_ops), lo, hi)
    return sum(e - s for s, e in merged)


def gaps(device_ops: Sequence[tuple], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of ``[lo, hi)``."""
    out, t = [], lo
    for s, e in clip(union((s, e) for _, s, e in device_ops), lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def open_range(ranges: Sequence[tuple], t: int) -> str:
    """The innermost job range open at ``t`` (``between`` if none)."""
    best, width = "between", None
    for name, s, e in ranges:
        if name in RANGES and s <= t < e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def idle_by_range(device_ops, ranges, lo: int, hi: int) -> Dict[str, int]:
    """Idle nanoseconds of ``[lo, hi)`` by the host range open then."""
    out: Dict[str, int] = defaultdict(int)
    for s, e in gaps(device_ops, lo, hi):
        out[open_range(ranges, (s + e) // 2)] += e - s
    return dict(out)


def op_totals(device_ops, lo: int, hi: int) -> Dict[str, int]:
    """Nanoseconds of each device operation's name inside ``[lo, hi)``."""
    out: Dict[str, int] = defaultdict(int)
    for name, s, e in device_ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out[name] += e - s
    return dict(out)


def summary(device_ops, ranges, top: int = 10) -> dict:
    """What the run's record keeps of a trace: the window, the busy time,
    every operation's time by name, and the ``breakdown`` of the result
    line (the ``top`` largest of each list, in seconds)."""
    lo, hi = window(ranges)
    ops = op_totals(device_ops, lo, hi)
    idle = idle_by_range(device_ops, ranges, lo, hi)

    def largest(d):
        return [[k[:160], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (hi - lo) / 1e9,
            "busy_s": busy_ns(device_ops, lo, hi) / 1e9,
            "ops_s": {k: v / 1e9 for k, v in ops.items()},
            "breakdown": {"device_ops": largest(ops),
                          "idle_gaps": largest(idle)}}
