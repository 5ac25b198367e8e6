"""Run one cell of the benchmark and print its result line.

    python3 -m shufflebench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``shufflebench/`` and ``sparkrdma_tpu_torch/``. One run:

1. set-up (``setup_s``, from the process's start): imports, the
   program's manager (its kernels built at first use, or loaded from
   ``build/`` in the checkout), the payload words, and two warm-up jobs
   of the cell's own shapes;
2. the window: jobs back to back for ``--seconds`` (a closed loop, one
   client, as a Spark application submits stages); each job's records are
   made inside the window and outside the job's clock. ``CHECKED`` jobs,
   at times drawn from the seed, copy every partition of their read to
   the host for the check; the window's clock stops while they copy;
3. with ``--trace 1``, ``TRACED`` more jobs under ``torch.profiler``;
4. the program's state freed, then the check: the reference
   (``reference.py``) works out each kept read again from its job's
   records, and every number compared has the limit 0.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number beside its limit), which
also close standard error. No result is printed, and the exit code is
not 0, without the CUDA devices the cell asks for, or if ``jax``,
``jaxlib``, ``flax`` or ``sparkrdma_tpu`` was imported.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from shufflebench import registry  # noqa: E402

HERE = Path(__file__).resolve().parent
# CUDA's JIT kernel cache inside the checkout, at a fixed path
os.environ["CUDA_CACHE_PATH"] = str(HERE / "out" / "cuda_cache")

#: modules no run may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkrdma_tpu")
#: warm-up jobs in set-up
WARMUP = 2
#: window jobs whose whole read the check compares
CHECKED = 3
#: jobs under the profiler in a traced run
TRACED = 16


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that are in ``FORBIDDEN``,
    compared whole (``sparkrdma_tpu_torch`` is not ``sparkrdma_tpu``)."""
    tops = {name.split(".")[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def p95(values) -> float:
    """95th percentile, nearest rank: at least 5 % of the values lie at
    or above it."""
    vals = sorted(values)
    return vals[max(math.ceil(0.95 * len(vals)) - 1, 0)]


def job_summary(jobs) -> dict:
    """What the window's jobs were: how many, their times' quartiles and
    halves, and the plans' geometry (a line for the reader, not a
    metric)."""
    if not jobs:
        return {"completed": 0}
    ms = [j["seconds"] * 1e3 for j in jobs]
    half = len(ms) // 2
    plans = [j["plan"] for j in jobs]
    return {"completed": len(jobs),
            "ms_quartiles": statistics.quantiles(ms, n=4) if half else ms,
            "ms_median_halves": [statistics.median(ms[:half or 1]),
                                 statistics.median(ms[half:])],
            "rounds": sorted({p["num_rounds"] for p in plans}),
            "split_factor": sorted({p["split_factor"] for p in plans}),
            "capacity": sorted({p["capacity"] for p in plans})}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_window(cell, seed: int, seconds: float) -> dict:
    """Jobs back to back for ``seconds``. A job counts if it completed
    inside the window; a job that raised is failed and missing.

    ``CHECKED`` jobs, the first to start after each of ``CHECKED`` times
    drawn from the seed (one in each equal slice of the window), keep
    their whole read for the check. Its copy to the host is outside the
    job's clock, and the window's end moves on by the copy's time, so
    that the window holds ``seconds`` of jobs."""
    import torch

    from shufflebench.cell import CHECKS, WINDOW_JOBS, job_seed

    draw = random.Random(job_seed(seed, CHECKS, 0))
    keep_at = [(k + 0.9 * draw.random()) * seconds / CHECKED
               for k in range(CHECKED)]
    jobs, kept = [], []
    attempted = failed = 0
    keep_s = 0.0
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    start = time.perf_counter()
    idx = 0
    while time.perf_counter() < start + seconds + keep_s:
        records = cell.records(WINDOW_JOBS, idx)
        keep = (len(kept) < CHECKED and
                time.perf_counter() - start - keep_s >= keep_at[len(kept)])
        attempted += 1
        try:
            rec, out, totals = cell.job(
                records, cell.sampler_seed(WINDOW_JOBS, idx))
        except Exception:   # a failed job: counted, the loop goes on
            failed += 1
            traceback.print_exc()
            if keep:
                kept.append((idx, None, None))
        else:
            if rec["end"] <= start + seconds + keep_s:
                jobs.append(rec)
            if keep:
                t = time.perf_counter()
                kept.append((idx,) + cell.keep(out, totals))
                keep_s += time.perf_counter() - t
            del out, totals
        del records
        idx += 1
    peak = (torch.cuda.max_memory_allocated(cell.device) if cuda else 0)
    return {"jobs": jobs, "kept": kept, "attempted": attempted,
            "failed": failed, "seconds": seconds, "peak_bytes": peak,
            "keep_s": keep_s}


def run_traced(cell, count: int):
    """``count`` jobs under the profiler (after one that takes its
    start-up), and the trace's summary (``trace.summary``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from shufflebench import trace
    from shufflebench.cell import TRACED_JOBS, sync

    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    traced = []
    with profile(activities=acts) as prof:
        # the profiler's own start-up falls in this first job
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
    return traced, trace.summary(*trace.events(prof))


def run_checks(cell, kept, failed: int) -> dict:
    """Each number compared, summed over the kept jobs, with its limit."""
    from shufflebench.cell import WINDOW_JOBS

    check = registry.check(cell.mix["check"])
    numbers = {"jobs_failed": failed,
               "jobs_unchecked": CHECKED - sum(1 for k in kept
                                               if k[1] is not None)}
    for idx, rows, totals in kept:
        if rows is None:
            continue
        got = check.compare(cell.records(WINDOW_JOBS, idx),
                            rows.to(cell.device), totals, cell.parts,
                            cell.key_words)
        for k, v in got.items():
            numbers[k] = numbers.get(k, 0) + v
    return {k: {"value": v, "limit": 0} for k, v in numbers.items()}


def main(argv=None, device=None, overrides=None) -> int:
    """One run; returns the exit code. ``device`` and ``overrides`` (a
    smaller job, a conf) are for the tests, which run it on the CPU."""
    args = parse(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    config = registry.config(bench, wl["config"])
    mix = registry.mix(wl["traffic"])

    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < wl["chips"]):
            print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    from shufflebench.cell import WARMUP_JOBS, Cell, sync

    # where set-up's time goes: seconds from the process's start to the
    # end of each step (a line for the reader, not a metric)
    marks = {"imports": time.perf_counter() - _T0}
    torch.zeros(1, device=device)
    sync(device)
    marks["device"] = time.perf_counter() - _T0
    cell = Cell(config, mix, args.seed, device, overrides)
    sync(cell.device)
    marks["manager_payload"] = time.perf_counter() - _T0
    for i in range(WARMUP):
        cell.job(cell.records(WARMUP_JOBS, i),
                 cell.sampler_seed(WARMUP_JOBS, i))
        sync(cell.device)
        marks[f"warmup_{i}"] = time.perf_counter() - _T0
    # what set-up made stays out of the collector's later passes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - _T0

    res = run_window(cell, args.seed, args.seconds)
    traced = summary = None
    if args.trace:
        traced, summary = run_traced(cell, TRACED)
    cuda = cell.device.type == "cuda"
    kind = torch.cuda.get_device_name(cell.device) if cuda else "cpu"

    cell.stop()     # the program's state goes before the check
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = run_checks(cell, res["kept"], res["failed"])
    check_s = time.perf_counter() - t
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    jobs = res["jobs"]
    if args.trace:
        run = {"jobs": jobs, "traced_jobs": traced, "trace": summary,
               "device_kind": kind}
        metrics = {}
        for m in registry.cell_metrics(bench, args.workload, "per_layer"):
            value = registry.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a failed job misses every limit: it counts as the window's length
        times = ([j["seconds"] for j in jobs]
                 + [res["seconds"]] * res["failed"])
        values = {
            "shuffle_gbps": sum(j["bytes"] for j in jobs)
            / res["seconds"] / 1e9,
            "job_p95_ms": p95(times) * 1e3 if times else None,
            "peak_mem_gb": res["peak_bytes"] / 1e9,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in registry.cell_metrics(bench, args.workload,
                                                  "end_to_end")
                   if values.get(m["name"]) is not None}
    device_line = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_line, "jobs": job_summary(jobs),
            "setup_marks_s": marks, "check_copy_s": res["keep_s"],
            "check_s": check_s}
    if args.trace:
        device_line.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        line["breakdown"] = summary["breakdown"]
    line["checks"] = checks

    leaked = forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
