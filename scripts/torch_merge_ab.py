#!/usr/bin/env python3
"""Time one checkout's merge stage (PyTorch port) at the main path's shapes.

    python3 scripts/torch_merge_ab.py [--root DIR] [--label NAME]

Imports ``sparkrdma_tpu_torch`` from DIR (default: the checkout holding
this script), builds its kernels there, and prints one JSON line per
shape: the median of CUDA-event-timed ``merge_stage`` calls and the
bound by the rows merged (read + write once at 3.35 TB/s), W = 25:

  A run R        N = 2^24 random records (one in nine identical), runs
                 of R = 2^15, 2^19, 2^23 — leg A's stages;
  B padded       N = 2^22, rows [0, 2^21 + 12345) random and the rest
                 all-ones: the rows a masked tail sort merges in leg B;
  B prefix       the ragged prefix the ``n_valid`` sort merges instead
                 (only where the tree has it);
  random 2^22    and  all-ones 2^22  — no ties against all ties;
  sort B         the whole partition sort as the exchange's tail calls
                 it (``n_valid`` where the tree has it, else the mask).

To compare two trees on one card, run it on both in one command, in
turns: old, new, new, old. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

MEM_RATE = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
W, RUN = 25, 1 << 15
N_A, N_B, TOTAL_B = 1 << 24, 1 << 22, (1 << 21) + 12345


def time_ms(fn, reps: int, warm: int = 2) -> float:
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


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_merge_ab: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparkrdma_tpu_torch.kernels import merge_sort as ms
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    if not os.path.abspath(ms.__file__).startswith(root + os.sep):
        print(f"torch_merge_ab: imported {ms.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    prefix = hasattr(ms, "merge_splits")   # ragged stages, n_valid sort
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    label = args.label or root

    def emit(line):
        line.update(label=label, card=card)
        print(json.dumps(line), flush=True)

    def words(n, seed):
        return random_records(W * n, 1, seed, "cuda").reshape(W, n)

    def stage(name, cols, run=RUN):
        out = torch.empty_like(cols)
        t = time_ms(lambda: ms.merge_stage(cols, run, out=out), reps=20)
        bound = 2 * cols.numel() * 4 / MEM_RATE * 1e3
        emit({"shape": name, "rows": cols.shape[1], "run": run,
              "kernel_ms": t, "bound_ms": bound, "share": bound / t})

    x = words(N_A, 1)
    x[:, ::9] = x[:, 5:6]
    for run in (RUN, 1 << 19, 1 << 23):
        stage(f"A run 2^{run.bit_length() - 1}", ms.chunk_sort_cols(x, run),
              run)
    del x
    torch.cuda.empty_cache()

    part = words(N_B, 8)
    part[:, TOTAL_B:] = 0
    mask = torch.arange(N_B, device="cuda") < TOTAL_B
    stage("B padded", ms.chunk_sort_cols(
        torch.where(mask[None, :], part, -1), RUN))
    if prefix:
        rows = -(-TOTAL_B // RUN) * RUN
        keep = torch.arange(rows, device="cuda") < TOTAL_B
        stage("B prefix", ms.chunk_sort_cols(
            torch.where(keep[None, :], part[:, :rows], -1), RUN))
    stage("random 2^22", ms.chunk_sort_cols(words(N_B, 9), RUN))
    stage("all-ones 2^22",
          torch.full((W, N_B), -1, dtype=torch.int32, device="cuda"))

    def sort():
        if prefix:
            return ms.merge_sort_cols(part, run=RUN, n_valid=TOTAL_B)
        return ms.merge_sort_cols(part, mask, run=RUN)

    emit({"shape": "sort B", "rows": N_B, "total": TOTAL_B,
          "path": "n_valid" if prefix else "mask",
          "sort_ms": time_ms(sort, reps=5)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
