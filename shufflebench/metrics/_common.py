"""Arithmetic the per-layer metrics share: medians of the jobs' spans,
the records an exchange carried and the record slots it moved."""

import math
import statistics


def median_span_ms(jobs, step):
    """Median host milliseconds of the jobs' ``step`` span, or None."""
    vals = [j["spans"][step] for j in jobs if step in j["spans"]]
    return statistics.median(vals) * 1e3 if vals else None


def carried(job):
    """``(records, bytes a record)`` the job's exchange carried: after the
    map-side combine where it ran, else every record of the plan."""
    wire = job["wire"]
    if wire.get("combine_out_records"):
        return (wire["combine_out_records"],
                wire["combine_out_bytes"] / wire["combine_out_records"])
    return job["plan"]["total_records"], job["record_bytes"]


def slots_moved(job):
    """Record slots the exchange moved: the rounds (rounded up to whole
    chunks of ``max_rounds_in_flight`` once the plan streams) times every
    (source, destination sub-partition) pair times the slot capacity."""
    plan = job["plan"]
    rounds, f_in = plan["num_rounds"], job["rounds_in_flight"]
    if rounds > f_in:
        rounds = math.ceil(rounds / f_in) * f_in
    return rounds * job["partitions"] * plan["plan_parts"] * plan["capacity"]
