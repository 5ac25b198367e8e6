"""Per-shuffle critical-path attribution — *which phase* owns the wall.

The port's copy of ``sparkrdma_tpu.obs.critical_path``.

The in-span timeline (:mod:`sparkrdma_tpu_torch.obs.timeline`) records where
inside a read time went as raw B/E duration events; this module folds
that event stream into a **phase attribution**: wall-clock seconds per
pipeline phase (plan / combine / encode / H2D / dispatch / queue-block /
D2H / decode / fold / spill / admission-wait), plus a derived
``bottleneck`` verdict, both emitted onto every journal span (schema
v10 fields ``phase_s`` / ``bottleneck``).

Attribution is a *self-time sweep*: events are replayed in timestamp
order with a stack of open intervals, and each inter-event segment is
charged to the innermost open phase (Chrome-trace nesting discipline —
a ``queue:block`` inside a ``chunk`` charges queue-block, the rest of
the chunk charges dispatch). Instants carrying an ``ms`` extra (the
admission controller's ``admission:wait``) contribute directly. Time no
tracked phase covers — device execution the host never blocked on,
untimed host work — lands in ``other``, so the attribution **partitions
the span's wall-clock exactly** (attributed time exceeding the wall,
e.g. events recorded before the span formally started, is scaled down
proportionally).

**What the seconds mean in the port.** The timeline's marks are host
wall-clock times around kernel launches that run asynchronously on the
card (as JAX's dispatch is asynchronous in the reference), so
``phase_s`` attributes *host* time: ``dispatch`` is the host enqueueing
chunks or the fused exchange, ``queue_block`` the host waiting for an
older chunk's CUDA event, and device time the host never waited on
lands in ``other``. ``exchange_s`` itself runs through the read's
closing device sync, so it includes device time; there is no separate
device-time field, as there is none in the reference.

The verdict is per-span; ``straggler-bound`` additionally exists at the
cross-host merge level (:func:`straggler_delta` — used by
``scripts/shuffle_report.py`` over multi-journal input, where per-host
means of the same shuffle can be compared).

Stdlib-only on purpose, like the rest of the journal toolchain.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: every key a span's ``phase_s`` dict may carry (lint-pinned: the
#: port's srlint rule ``journal-schema-sync``, ``lint/rules_sync.py``,
#: checks the CLIs' ``ph.get("...")`` reads against this set)
PHASES = frozenset({
    "plan", "combine", "encode", "h2d", "d2h", "decode", "dispatch",
    "queue_block", "fold", "spill", "admission_wait", "other",
})

#: every bottleneck verdict a span (or a report-side merge) may carry
#: (lint-pinned: ``journal-schema-sync`` checks the ``*-bound``
#: literals in the CLIs against this set)
VERDICTS = frozenset({
    "codec-bound", "fabric-bound", "spill-bound", "admission-bound",
    "straggler-bound",
})

#: timeline event name -> phase. B/E events accrue self-time; names not
#: mapped here (pool acquires, counter tracks, fault markers) are
#: structural and charge whatever phase encloses them.
PHASE_OF = {
    "plan": "plan",
    "combine:gate": "combine",
    "serde:encode": "encode",
    "serde:h2d": "h2d",
    "serde:d2h": "d2h",
    "serde:decode": "decode",
    "stream:prep": "dispatch",
    "chunk": "dispatch",
    "ring:round": "dispatch",
    "exchange:fused": "dispatch",
    "queue:block": "queue_block",
    "fold": "fold",
    "spill": "spill",
    "spill:write": "spill",
    "spill:fetch": "spill",
    "admission:wait": "admission_wait",
}

#: phases whose time is host codec work (the serde pipeline)
_CODEC_PHASES = ("encode", "h2d", "d2h", "decode")
#: phases whose time is exchange execution / completion waits
_FABRIC_PHASES = ("plan", "combine", "dispatch", "queue_block", "fold")

#: cross-host spread (max/min of per-host mean exchange seconds) at or
#: above which a shuffle's merged verdict becomes straggler-bound
STRAGGLER_RATIO = 2.0


def attribute(events: Iterable[Dict], wall_s: float) -> Dict[str, float]:
    """Fold a drained timeline into ``{phase: seconds}`` summing to
    ``wall_s``.

    Self-time sweep over the B/E stream (module docstring); ``i``
    events with an ``ms`` extra contribute directly. Returns only
    phases with non-zero time, plus ``other`` (the unattributed
    remainder) — so ``sum(result.values()) == wall_s`` whenever
    ``wall_s > 0``.
    """
    out: Dict[str, float] = {}
    # stack of (event name, phase) for open B intervals, innermost last
    stack: List[Tuple[str, str]] = []
    last_t = 0.0
    for e in events:
        t = float(e.get("t", 0.0) or 0.0)
        name = e.get("name", "")
        ph = e.get("ph", "i")
        if stack and t > last_t:
            phase = stack[-1][1]
            out[phase] = out.get(phase, 0.0) + (t - last_t)
        last_t = max(last_t, t)
        mapped = PHASE_OF.get(name)
        if ph == "B" and mapped is not None:
            stack.append((name, mapped))
        elif ph == "E" and mapped is not None:
            # E closes the innermost open B of the same name
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    del stack[i]
                    break
        elif ph == "i" and mapped is not None and "ms" in e:
            out[mapped] = out.get(mapped, 0.0) + \
                float(e.get("ms", 0.0) or 0.0) / 1e3
    # unclosed intervals (a failed read's drain) contribute nothing
    # further — their self-time up to the last event is already counted
    total = sum(out.values())
    wall_s = max(float(wall_s), 0.0)
    if total > wall_s > 0:
        # the timeline can cover more than the span (events recorded
        # between reads, e.g. the writer's spills): scale to partition
        scale = wall_s / total
        out = {p: s * scale for p, s in out.items()}
        total = wall_s
    out = {p: round(s, 6) for p, s in out.items() if s > 0}
    out["other"] = round(max(wall_s - total, 0.0), 6)
    return out


def verdict(phase_s: Dict[str, float],
            events: Iterable[Dict] = ()) -> str:
    """The per-span bottleneck verdict from an attribution (+ the raw
    events, for spill signals that carry counts rather than time).

    Priority: a read that *blocked on disk* (sync tiered-store fetch)
    or whose spill phase dominates is spill-bound regardless of codec
    share — spilling is the remediable cause, the codec merely ran
    while the exchange starved. Then admission waits (the fair-queueing
    controller made the read wait — a quota problem, not a data-path
    one), then codec vs fabric by attributed share.
    """
    sync_fetches = 0
    for e in events:
        if e.get("name") == "spill:fetch" and e.get("sync"):
            sync_fetches += 1
    codec = sum(phase_s.get(p, 0.0) for p in _CODEC_PHASES)
    fabric = sum(phase_s.get(p, 0.0) for p in _FABRIC_PHASES)
    spill = phase_s.get("spill", 0.0)
    wait = phase_s.get("admission_wait", 0.0)
    if sync_fetches > 0 or (spill > 0 and spill >= max(codec, fabric,
                                                       wait)):
        return "spill-bound"
    if wait > 0 and wait >= max(codec, fabric):
        return "admission-bound"
    if codec > fabric:
        return "codec-bound"
    return "fabric-bound"


def enrich(span, metrics=None):
    """Attach ``phase_s`` + ``bottleneck`` to a just-built span (both
    emission sites call this before sampling/rollup, so every journal
    line — and every rollup observation — carries the verdict)."""
    wall = span.plan_s + span.exchange_s + span.sort_s
    span.phase_s = attribute(span.events, wall)
    span.bottleneck = verdict(span.phase_s, span.events)
    if metrics is not None:
        metrics.counter("critical_path.attributions").inc()
    return span


def partition_to_wall(phase_s: Dict[str, float],
                      wall_s: float) -> Dict[str, float]:
    """Scale/pad a merged phase dict so it partitions ``wall_s`` exactly
    — the same contract :func:`attribute` gives a single span, lifted
    to aggregates (a job stage's spans sum to less host-attributed time
    than the stage wall; the shortfall is charged to ``other``, an
    overshoot — overlapping reads — is scaled down proportionally).
    Returns ``{}`` when ``wall_s`` is not positive."""
    wall_s = max(float(wall_s), 0.0)
    if wall_s <= 0:
        return {}
    out = {p: float(v or 0.0) for p, v in phase_s.items()
           if p in PHASES and v}
    # a merged input may already carry per-span "other" remainders;
    # fold them into the recomputed remainder below instead of counting
    # them as attributed time (and then clobbering the key, which would
    # make the result sum to wall minus the carried value)
    out.pop("other", None)
    total = sum(out.values())
    if total > wall_s:
        scale = wall_s / total
        out = {p: s * scale for p, s in out.items()}
        total = wall_s
    out = {p: round(s, 6) for p, s in out.items() if s > 0}
    out["other"] = round(max(wall_s - total, 0.0), 6)
    return out


# ---------------------------------------------------------------------
# cross-host merge (multi-journal; report-side)
# ---------------------------------------------------------------------

def merge_phases(spans: Iterable) -> Dict[str, float]:
    """Sum attributions across spans (dicts or ExchangeSpan)."""
    out: Dict[str, float] = {}
    for s in spans:
        ph = s.get("phase_s") if isinstance(s, dict) else s.phase_s
        if not isinstance(ph, dict):
            continue
        for p, v in ph.items():
            if p in PHASES:
                out[p] = out.get(p, 0.0) + float(v or 0.0)
    return out


def straggler_delta(spans: Iterable) -> Tuple[float, float, Optional[int]]:
    """(max−min, max/min ratio, slowest process) of per-host mean
    exchange seconds for ONE shuffle's spans across a multi-journal
    merge. Ratio is 0.0 below two hosts (no spread to speak of)."""
    per_host: Dict[int, List[float]] = {}
    for s in spans:
        if isinstance(s, dict):
            pidx = int(s.get("process_index", 0) or 0)
            ex = float(s.get("exchange_s", 0.0) or 0.0)
        else:
            pidx, ex = s.process_index, s.exchange_s
        per_host.setdefault(pidx, []).append(ex)
    if len(per_host) < 2:
        return 0.0, 0.0, None
    means = {p: sum(v) / len(v) for p, v in per_host.items()}
    slow = max(means, key=lambda p: means[p])
    hi, lo = means[slow], min(means.values())
    return hi - lo, (hi / lo if lo > 0 else 0.0), slow


def shuffle_verdict(spans: List) -> str:
    """One shuffle's merged verdict: straggler-bound when the cross-
    host spread dominates, else the majority per-span verdict."""
    if not spans:
        return ""
    _, ratio, _ = straggler_delta(spans)
    if ratio >= STRAGGLER_RATIO:
        return "straggler-bound"
    votes: Dict[str, int] = {}
    for s in spans:
        v = s.get("bottleneck") if isinstance(s, dict) else s.bottleneck
        if v in VERDICTS:
            votes[v] = votes.get(v, 0) + 1
    if not votes:
        return ""
    return max(sorted(votes), key=lambda v: votes[v])


__all__ = ["PHASES", "VERDICTS", "PHASE_OF", "STRAGGLER_RATIO",
           "attribute", "verdict", "enrich", "partition_to_wall",
           "merge_phases", "straggler_delta", "shuffle_verdict"]
