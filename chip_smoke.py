#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold every kernel
against its plain version.

    python3 chip_smoke.py

It builds the CUDA kernels from ``sparkrdma_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. kernel phases — each hand-written kernel at the shapes the main path
   gives it, compared bit-exact with its plain PyTorch version on the
   same inputs (tolerance 0: integer data) and timed with CUDA events.
   The merge stage (split pass + merge kernel) runs at leg A's shape,
   at leg B's ragged received prefix (sorted with ``n_valid`` as the
   exchange's tail sorts it), on the padded rows that prefix used to
   sort, and on all-ones records; one ``merge_shape`` line each gives
   ``kernel_ms``, ``bound_ms`` by the rows merged and the share;
2. TeraSort legs at the full width of the benchmark configuration
   (100-byte records, W = 25, 16,777,216 records):
     A  one partition, the single-partition branch (merge-path tail);
     B  8 stacked partitions, fused ring exchange + merge-path tail;
     C  8 stacked partitions, per-round ring all-to-all + merge tail;
   each with its launch counts zeroed just before and read just after,
   its device-side verification, and a 2^20-record run that passes the
   host-side permutation check;
3. one ``{"kernels": [...]}`` line and, last, the device line.

Exits non-zero, without a result, if there is no CUDA device, if the
port is not beside it, or if any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

MEM_RATE = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
RECORDS = 1 << 24           # bench.py's 1-chip geometry, 1.68 GB at W=25
KEY_WORDS, VAL_WORDS = 2, 23
RUN = 1 << 15               # fast_sort_run
SLOT_B = 1 << 21            # slot_records of legs B and C
N_B = 1 << 22               # leg B's per-partition out_capacity
TOTAL_B = (1 << 21) + 12345  # a ragged received prefix inside it


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def rand_words(shape, seed: int) -> torch.Tensor:
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    n = 1
    for s in shape:
        n *= s
    return random_records(n, 1, seed, "cuda").reshape(shape)


def report(line: dict) -> None:
    print(json.dumps(line), flush=True)


def merge_shape(name: str, cols: torch.Tensor, run: int, reps: int = 20
                ) -> dict:
    """Time one merge stage (split pass + merge kernel) on ``cols`` and
    print it beside its bound by the rows merged."""
    from sparkrdma_tpu_torch.kernels.merge_sort import (merge_splits,
                                                        merge_stage,
                                                        merge_stage_plain,
                                                        pick_tile)

    w, rows = cols.shape
    out = torch.empty_like(cols)
    tile = pick_tile(w, run)
    ms = time_ms(lambda: merge_stage(cols, run, out=out), reps=reps)
    split_ms = time_ms(lambda: merge_splits(cols, run, tile), reps=reps)
    plain_ms = time_ms(lambda: merge_stage_plain(cols, run), reps=3, warm=1)
    bound = 2 * w * rows * 4 / MEM_RATE * 1e3
    line = {"merge_shape": name, "w": w, "rows_merged": rows, "run": run,
            "tile": tile, "kernel_ms": ms, "split_ms": split_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "share_of_bound": bound / ms}
    report(line)
    return line


def check_stage(cols: torch.Tensor, run: int) -> int:
    """Split pass and stage against their plain versions; max error."""
    from sparkrdma_tpu_torch.kernels.merge_sort import (merge_splits,
                                                        merge_splits_plain,
                                                        merge_stage,
                                                        merge_stage_plain,
                                                        pick_tile)

    tile = pick_tile(cols.shape[0], run)
    err = max_abs_err(merge_splits(cols, run, tile),
                      merge_splits_plain(cols, run, tile))
    got = merge_stage(cols, run)
    torch.cuda.synchronize()
    return max(err, max_abs_err(got, merge_stage_plain(cols, run)))


def merge_phase() -> dict:
    """The merge stage at leg A's shape (W=25, N=2^24) over several
    stages, at leg B's shape (one partition of N=2^22 holding a ragged
    received prefix, sorted as the exchange's tail sorts it), and on
    all-ones records (every comparison a tie of all 25 words)."""
    from sparkrdma_tpu_torch.kernels.merge_sort import (chunk_sort_cols,
                                                        merge_sort_cols,
                                                        merge_sort_cols_plain)

    w, n = KEY_WORDS + VAL_WORDS, RECORDS
    x = rand_words((w, n), seed=1)
    x[:, ::9] = x[:, 5:6]                      # identical records too
    form_ms = time_ms(lambda: chunk_sort_cols(x, RUN), reps=3, warm=1)
    err = 0
    for run in (RUN, 1 << 20, 1 << 23):
        err = max(err, check_stage(chunk_sort_cols(x, run), run))
    cols = chunk_sort_cols(x, RUN)
    del x
    shapes = [merge_shape("A", cols, RUN)]
    del cols
    torch.cuda.empty_cache()

    # leg B: one partition's compacted output, rows [0, total) received
    nb, total = N_B, TOTAL_B
    part = rand_words((w, nb), seed=8)
    part[:, total:] = 0
    got = merge_sort_cols(part, run=RUN, n_valid=total)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, merge_sort_cols_plain(part, total)))
    del got
    rows = -(-total // RUN) * RUN
    keep = torch.arange(rows, device="cuda") < total
    pcols = chunk_sort_cols(torch.where(keep[None, :], part[:, :rows], -1),
                            RUN)
    err = max(err, check_stage(pcols, RUN))
    shapes.append(merge_shape("B prefix", pcols, RUN))
    del pcols
    mask = torch.arange(nb, device="cuda") < total
    sort_prefix_ms = time_ms(
        lambda: merge_sort_cols(part, run=RUN, n_valid=total), reps=5)
    sort_masked_ms = time_ms(
        lambda: merge_sort_cols(part, mask, run=RUN), reps=5)
    full = chunk_sort_cols(torch.where(mask[None, :], part, -1), RUN)
    shapes.append(merge_shape("B padded (mask path)", full, RUN))
    del full, part
    shapes.append(merge_shape("random 2^22", chunk_sort_cols(
        rand_words((w, nb), seed=9), RUN), RUN))
    ones = torch.full((w, nb), -1, dtype=torch.int32, device="cuda")
    err = max(err, check_stage(ones, RUN))
    shapes.append(merge_shape("all-ones 2^22", ones, RUN))
    del ones
    torch.cuda.empty_cache()
    if err:
        fail(f"merge_stage disagrees with its plain version: {err}")
    line = {"phase": "merge_stage", "w": w, "n": n, "runs_checked":
            [RUN, 1 << 20, 1 << 23], "max_abs_err": err,
            "kernel_ms": shapes[0]["kernel_ms"],
            "bound_ms": shapes[0]["bound_ms"],
            "plain_ms": shapes[0]["plain_ms"], "library_ms": None,
            "run_formation_ms": form_ms,
            "leg_b_total": total, "sort_prefix_ms": sort_prefix_ms,
            "sort_masked_ms": sort_masked_ms}
    report(line)
    return line


def ring_phase() -> dict:
    """Fused exchange at leg B's shape (R=1, C=2^19) and at R=3."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_exchange,
                                                   ring_exchange_plain)

    w, d = KEY_WORDS + VAL_WORDS, 8
    err = 0
    small = rand_words((d, 3, d, 1, w, (1 << 17) + 1), seed=2)
    err = max(err, max_abs_err(ring_exchange(small),
                               ring_exchange_plain(small)))
    del small
    send = rand_words((d, 1, d, 1, w, (1 << 19) + 1), seed=3)
    got = ring_exchange(send)
    err = max(err, max_abs_err(got, ring_exchange_plain(send)))
    if err:
        fail(f"ring_exchange disagrees with its plain version: {err}")
    ms = time_ms(lambda: ring_exchange(send, out=got), reps=20)
    plain_ms = time_ms(lambda: ring_exchange_plain(send), reps=5)
    library_ms = time_ms(
        lambda: send.permute(2, 1, 0, 3, 4, 5).contiguous(), reps=5)
    line = {"phase": "ring_exchange", "shape": list(send.shape),
            "rounds_checked": [1, 3], "max_abs_err": err, "kernel_ms": ms,
            "bound_ms": 2 * send.numel() * 4 / MEM_RATE * 1e3,
            "plain_ms": plain_ms, "library_ms": library_ms}
    report(line)
    return line


def a2a_phase() -> dict:
    """Single-round all-to-all at leg C's shape ([D, D, ppd, W, C])."""
    from sparkrdma_tpu_torch.exchange.ring import ring_all_to_all

    w, d = KEY_WORDS + VAL_WORDS, 8
    send = rand_words((d, d, 1, w, 1 << 19), seed=4)
    got = ring_all_to_all(send)
    err = max_abs_err(got, send.transpose(0, 1).contiguous())
    if err:
        fail(f"ring_all_to_all disagrees with its plain version: {err}")
    ms = time_ms(lambda: ring_all_to_all(send), reps=20)
    plain_ms = time_ms(lambda: send.transpose(0, 1).contiguous(), reps=5)
    library_ms = time_ms(lambda: send.permute(1, 0, 2, 3, 4).contiguous(),
                         reps=5)
    line = {"phase": "ring_all_to_all", "shape": list(send.shape),
            "max_abs_err": err, "kernel_ms": ms,
            "bound_ms": 2 * send.numel() * 4 / MEM_RATE * 1e3,
            "plain_ms": plain_ms, "library_ms": library_ms}
    report(line)
    return line


def counters():
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange)
    from sparkrdma_tpu_torch.kernels.merge_sort import (merge_splits,
                                                        merge_stage)

    return {"merge_stage": merge_stage, "merge_splits": merge_splits,
            "ring_exchange": ring_exchange,
            "ring_all_to_all": ring_all_to_all}


def leg(name: str, partitions: int, records: int, transport: str,
        fused: bool, seed: int, full: bool):
    """One TeraSort leg through the SPI; returns (line, out, totals)."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    per = records // partitions
    conf = ShuffleConf(
        slot_records=per if partitions == 1 else SLOT_B,
        transport=transport, ring_fused=fused, val_words=VAL_WORDS,
        key_words=KEY_WORDS, fast_sort=True, fast_sort_run=RUN,
        pack_sort_min_payload=0, wide_sort_min_payload=0)
    manager = ShuffleManager(MeshRuntime(conf, num_partitions=partitions,
                                         device="cuda"))
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, out, totals = run_terasort(
        manager, per, seed=seed, verify=not full, device_verify=True,
        repeats=3 if full else 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    plan = res.plan
    line = {"leg": name, "records": res.records, "partitions": partitions,
            "transport": transport, "ring_fused": fused,
            "record_bytes": res.record_bytes,
            "gbps": res.gbps, "read_s": res.sort_exchange_s,
            "wall_s": wall, "capacity": plan.capacity,
            "rounds": plan.num_rounds, "out_capacity": plan.out_capacity,
            "verified": res.verified,
            "check": "device" if full else "host+device",
            "launches": launches}
    report(line)
    if not res.verified:
        fail(f"leg {name} failed verification")
    return line, out, totals


def profile_read(partitions: int) -> dict:
    """Device time by kernel for one leg-B read under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    conf = ShuffleConf(slot_records=SLOT_B, transport="pallas_ring",
                       val_words=VAL_WORDS, fast_sort=True,
                       fast_sort_run=RUN, pack_sort_min_payload=0,
                       wide_sort_min_payload=0)
    m = ShuffleManager(MeshRuntime(conf, num_partitions=partitions))
    recs = random_records(RECORDS, KEY_WORDS + VAL_WORDS, 7, "cuda")
    spl = compute_splitters(make_sampler(partitions, KEY_WORDS, 256, 7)(
        recs), partitions)
    h = m.register_shuffle(9, partitions, range_partitioner(spl))
    m.get_writer(h).write(recs).stop()
    reader = m.get_reader(h, key_ordering=True)
    reader.read()
    read_ms = time_ms(reader.read, reps=3, warm=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reader.read()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs("profiles", exist_ok=True)
    with open("profiles/torch_legB.txt", "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    line = {"profile": "leg B read", "read_ms": read_ms,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / read_ms),
            "top": [[k[:60], us / 1e3, c] for us, k, c in rows[:10]],
            "merge_kernels": [[k[:60], us / 1e3, c] for us, k, c in rows
                              if "merge_s" in k]}
    report(line)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from sparkrdma_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    report({"build_s": time.perf_counter() - t0,
            "libraries": sorted(libs)})

    merge = merge_phase()
    ring = ring_phase()
    a2a = a2a_phase()
    torch.cuda.empty_cache()

    legs = {}
    outs = {}
    for name, d, transport, fused in (("A", 1, "xla", True),
                                      ("B", 8, "pallas_ring", True),
                                      ("C", 8, "pallas_ring", False)):
        legs[name], out, totals = leg(name, d, RECORDS, transport, fused,
                                      seed=0, full=True)
        if name in ("B", "C"):
            outs[name] = (out, totals)
        del out, totals
        torch.cuda.empty_cache()
        leg(name + "-small", d, 1 << 20, transport, fused, seed=5,
            full=False)
    # the two transports of the 8-partition path give the same bytes
    (ob, tb), (oc, tc) = outs["B"], outs["C"]
    if not (torch.equal(ob, oc) and torch.equal(tb, tc)):
        fail("legs B and C disagree")
    del outs, ob, oc
    torch.cuda.empty_cache()
    for k, name in (("merge_stage", "A"), ("merge_stage", "B"),
                    ("ring_exchange", "B"), ("merge_stage", "C"),
                    ("ring_all_to_all", "C"), ("merge_splits", "A"),
                    ("merge_splits", "B"), ("merge_splits", "C")):
        if legs[name]["launches"][k] <= 0:
            fail(f"{k} was not launched on leg {name}")
    profile_read(8)

    def launches(k):
        return sum(legs[n]["launches"][k] for n in legs)

    kernels = [
        {"name": "merge_stage", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/merge_path.cu",
         "replaces": "sparkrdma_tpu/kernels/merge_sort.py:309",
         "launches": launches("merge_stage"),
         "split_launches": launches("merge_splits"),
         "max_abs_err": merge["max_abs_err"], "ms": merge["kernel_ms"],
         "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "ring_exchange", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "sparkrdma_tpu/exchange/ring.py:140",
         "launches": launches("ring_exchange"),
         "max_abs_err": ring["max_abs_err"], "ms": ring["kernel_ms"],
         "plain_ms": ring["plain_ms"], "bound_ms": ring["bound_ms"],
         "bound_by": "bytes", "library_ms": ring["library_ms"]},
        {"name": "ring_all_to_all", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "sparkrdma_tpu/exchange/ring.py:87",
         "launches": launches("ring_all_to_all"),
         "max_abs_err": a2a["max_abs_err"], "ms": a2a["kernel_ms"],
         "plain_ms": a2a["plain_ms"], "bound_ms": a2a["bound_ms"],
         "bound_by": "bytes", "library_ms": a2a["library_ms"]},
    ]
    report({"kernels": kernels})
    report({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
