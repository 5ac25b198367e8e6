#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold every kernel
against its plain version.

    python3 chip_smoke.py

It builds the CUDA kernels from ``sparkrdma_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel) and the host staging library from
``sparkrdma_tpu_torch/native`` (``g++``, at the same time), then:

1. kernel phases — each hand-written kernel at the shapes the main path
   gives it, compared bit-exact with its plain PyTorch version on the
   same inputs (tolerance 0: integer data) and timed with CUDA events.
   The merge stage (split pass + merge kernel) runs at leg A's shape,
   at leg B's ragged received prefix (sorted with ``n_valid`` as the
   exchange's tail sorts it), on the padded rows that prefix used to
   sort, and on all-ones records; one ``merge_shape`` line each gives
   ``kernel_ms``, ``bound_ms`` by the rows merged and the share;
   The ring exchange is also checked and timed at leg E's width (W=3),
   each ring line with its device time (``device_ms``: 20 launches in a
   CUDA graph, replayed between CUDA events; ``device_cold_ms``: the
   launches rotate over 128 MB of copies of the buffers, so none is
   found in L2, and the share of bound is taken from it),
   ``permute().contiguous()``'s (``library_device_ms``,
   ``library_device_cold_ms``) and the host cost of a launch (``ring_host``:
   1000 enqueues of a tiny shape); a ``ring_edges`` phase checks it at
   odd shapes (chunk = 0-3 mod 4, below 4 words, below and just above
   one work item, 0; D = 3 with R = 5; D = 1) as views based 4, 8 and
   12 bytes into larger buffers, written with ``out=``; and a
   ``combine`` phase times the float segmented scan (the mirrored
   reference tree) against the uint32 closed forms at leg D's shape;
2. TeraSort legs at the full width of the benchmark configuration
   (100-byte records, W = 25, 16,777,216 records):
     A  one partition, the single-partition branch (merge-path tail);
     B  8 stacked partitions, fused ring exchange + merge-path tail;
     C  8 stacked partitions, per-round ring all-to-all + merge tail;
   each with its launch counts zeroed just before and read just after,
   its device-side verification, and a 2^20-record run that passes the
   host-side permutation check;
3. the aggregation path:
     D        ``reduce_by_key`` at ``bench.py``'s combine leg: 16,777,216
              Zipf-keyed 16-byte records, 8 stacked partitions, map-side
              combine on, fused ring; checked on the host against numpy;
     D-small  2^20 records of the same mix through the same entry
              points on the card and on the CPU, bit-identical, and
              equal to numpy: uint32 sum/min/max, a float32 sum, a
              filter + projection read, ranged reads (aggregated, and
              key-ordered through the merge-path kernel), and a read
              over the per-round all-to-all;
     E        PageRank, 5 iterations over a Graph500 Kronecker graph at
              SCALE 22, edgefactor 16 (67,108,864 edges), made on the card
              from a seed, checked against a float64 numpy PageRank;
   with a ``torch.profiler`` table of one leg-D read;
4. the reference's default exchange geometry (``slot_records`` 4096,
   ``max_rounds_in_flight`` 2, ``queue_depth`` 8, the pack sort mode,
   the slot pool; only the transport and the record width set):
     F        TeraSort at 16,777,216 × 100-byte records through the
              streaming regime, device-verified, beside leg B's GB/s, with
              a profile of one read; then the ring kernel at the chunk
              shape leg F's plan gives and at a capacity that is not a
              multiple of 4;
     F-small  2^20 records on the card and on the CPU, bit-identical and
              host-checked, in five variants (default, ``fast_sort``,
              ``ring_fused=False``, ``queue_depth=1``, ``"fine"``
              classes), each equal to the fused regime's read; pool hits
              on a repeat read; ``read_view`` against ``read_partition``;
     G        ``reduce_by_key`` at leg D's data, checked against numpy;
     G-small  its uint32 and float32 sums, card against CPU;
5. the out-of-core path at ``bench.py``'s ``run_oversub`` shape:
     H        ``run_tiered_terasort`` over 16 chunks of 2,097,152 × 100-byte
              records (3.36 GB) through the tiered store (host watermark
              four chunks, the rest on disk), with its store counters,
              host pools and peak device memory beside a 4-chunk run's;
              then a third run with every chunk's read verified on the
              card (conservation, order within each partition, ascending
              partition boundaries); the same dataset through
              ``run_streaming_terasort``'s fold (no store), its sums
              checked against numpy; a profile of 4 chunks of the fold;
              then the ring kernel at the shape leg H's chunk plan gives
              it, against its plain version;
     H-small  16 chunks of 65,536 records on the card and on the CPU:
              each chunk's per-partition reads bit-identical card against
              CPU, across variants, spilled or not, and in key order; the
              full-record-ordered rows equal to numpy; checkpoint then
              resume after losing half the chunks; the spill mode from
              chunk files, verified; ``fast_sort`` and ``ring_fused=False``
              variants;
6. the verbs over the exchange (``transport="pallas_ring"``):
     I        ``run_repartition``, ``BASELINE.md`` config 1: 134,217,728
              8-byte records into 256 parts, placement checked on the card;
     J        ``run_hash_join``, 16,777,216 × 100-byte rows a side, and
              ``Dataset.join`` on the same rows, held against numpy;
     K        every ``Dataset`` verb on 16,777,216 Zipf-keyed 100-byte
              records, each held against numpy;
     K-small  2^20 records through every verb, card against CPU, with
              ``fast_sort`` + ``"pow2"`` and ``ring_fused=False`` variants;
     L        ``run_als``, ``BASELINE.md`` config 4, at MovieLens-20M's
              dimensions, held against ``_numpy_als``;
     L-small  both ALS half-steps at 1/16 of that, card against CPU;
7. the planner's TPC-DS queries and the serde round trip (the
   reference's default slots, ``"fine"`` classes, the ring kernel):
     M-small  q64, q95 and the star suite at the reference tests' sizes,
              card against CPU, every ``plan_*`` knob on against all off;
     P        the serde round trip: 4,194,304 records with 0-92 B payloads
              through ``from_host_payloads``, ``sort_by_key`` (the
              merge-path kernel) and ``to_host_payloads``; 16,777,216
              rows of a four-column schema through ``from_host_columns``,
              ``select``, ``repartition`` and ``to_host_columns``;
     N        q95 at TPC-DS SF100's ``web_sales`` / ``web_returns``;
     O        the star suite at scale 64 (287,996,928 fact rows), with
              ``queries_per_hour`` and the four rewrite counters;
     M        q64 at SF100 (287,997,024 ``store_sales`` rows);
   each checked against numpy;
8. a check that legs A-P retried and recovered nothing unseen: no
   ``faults.*`` or ``recover.*`` counter moved and the reader logged no
   "fetch failed ... retrying" warning (a real failure there would
   otherwise be absorbed by the retry loop);
9. durability, the reader's retry loop and the fault plane:
     Q        leg F's records at the default geometry with ``fast_sort``
              and ``spill_to_host``: ``stop()`` checkpoints (seconds, GB/s,
              the file's bytes); a control read, verified on the card; a
              read under a failed dispatch and a stream failure past
              ``queue_depth`` chunks (two retries, the pool's
              ``outstanding`` restored after each failed attempt); a read
              after the map output is lost from the card (resumed from the
              checkpoint); a restarted manager's read: each bit-identical
              to the control;
     Q-small  2^20 records: that schedule on the card and on the CPU (and
              ``ring_fused=False``), equal to the reads without faults;
              checkpoints written on one device and resumed on the other;
              a persistent fault, the retry deadline, the backoff schedule,
              a corrupt checkpoint (``UnrecoverableShuffleError``, no
              retry); ``spill.write``, ``spill.read`` (an H-small-sized
              tiered run), ``checkpoint.read`` and ``pool.acquire`` faults;
              the books (hard injections = retries + recoveries); and, in a
              child process, reads whose ring launches really fail (a grid
              the entry refuses, an address the card has not mapped);
10. the host staging library (``native/staging.cpp``, built with ``g++``
    beside the kernels' ``nvcc`` runs; legs A-Q run on it, as the
    defaults have it): one ``phase: native_staging`` line per part —
    ``build`` (seconds, compiler, cores); ``codec`` (leg P's data through
    the four codec calls on the native codec at the default threads and
    at one, and on numpy: bytes equal, MB/s); ``spill`` (leg Q's 1.68 GB
    through a ``SpillWriter`` on each path: files byte-identical, GB/s,
    each file read on both paths); ``pinned`` (a pinned staging lease is
    page-locked and a copy from it returns before it lands, beside leg
    P's loads with and without overlap); ``on_off`` (H-small's,
    Q-small's and a 2^16-record P-shaped size on the card with
    ``use_native_staging`` / ``serde_native`` on and off: outputs, spill
    files and checkpoints identical); ``serde_fault`` (one injected
    ``serde.encode`` and ``serde.decode`` failure, recovered with the
    same rows, books balanced);
   then the ring kernel at every send shape legs B-Q launched it at
   (recorded while each leg ran), each against its plain version and
   timed;
11. the whole smoke's seconds, one ``{"kernels": [...]}`` line and, last,
    the device line.

Exits non-zero, without a result, if there is no CUDA device, if the
port is not beside it, or if any phase fails.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

MEM_RATE = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
RECORDS = 1 << 24           # bench.py's 1-chip geometry, 1.68 GB at W=25
KEY_WORDS, VAL_WORDS = 2, 23
RUN = 1 << 15               # fast_sort_run
SLOT_B = 1 << 21            # slot_records of legs B, C, D and E
F_SMALL = 1 << 20           # leg F-small: card against CPU
FINE_CAP = 29               # a "fine" size class that is not a multiple of 4
N_B = 1 << 22               # leg B's per-partition out_capacity
TOTAL_B = (1 << 21) + 12345  # a ragged received prefix inside it
PARTS = 8                   # stacked partitions of legs B to E
D_VAL_WORDS = 2             # leg D: bench.py's combine leg, 16-byte records
D_SMALL = 1 << 20           # leg D-small: card against CPU
E_SCALE, E_EDGEFACTOR = 22, 16   # leg E: Graph500 Kronecker graph
H_CHUNKS = 16               # leg H: bench.py's run_oversub, 16 chunks of
H_CHUNK = RECORDS // 8      # records_per_device // 8 records each
H_SMALL_CHUNK = 1 << 16     # leg H-small: card against CPU
I_PER_DEVICE = 1 << 24      # leg I: 134,217,728 × 8-byte records, 1.07 GB
I_NUM_PARTS = 256           # BASELINE.md config 1: repartition(256)
J_ROWS = 1 << 21            # leg J: rows per partition on each side
J_KEY_RANGE = 1 << 24
#: leg J's sum of payload products is a float32 prefix-sum difference,
#: as in the reference: at 2^21 rows per partition the prefix sums reach
#: ~1e9, where a float32 ulp is 64 (numpy emulation: 3.2e-4 relative)
J_SUM_RTOL = 1e-3
K_RECORDS = RECORDS         # leg K: 16,777,216 × 100-byte records
K_KEY_IDS = 1 << 22         # Zipf(1.1) ids folded into 2^22, as leg D
K_SMALL = 1 << 20           # leg K-small: card against CPU
L_USERS, L_ITEMS, L_RATINGS = 138_493, 26_744, 20_000_263  # MovieLens-20M
L_RANK, L_ITERS = 8, 5
LEGS_I_TO_L = ("I", "J", "K", "K-small", "L", "L-small")
#: leg M: TPC-DS SF100 store_sales (287,997,024 rows, no cut), item
#: (204,000, no cut) and store (402, cut to 400: a table loads only in
#: multiples of the partition count)
M_FACT_PER_PART = 287_997_024 // 8
M_ITEMS, M_STORES = 204_000, 400
#: leg N: SF100 web_sales and web_returns, each cut to a multiple of 8;
#: 6,000,000 orders is the port's choice (~12 lines an order)
N_SALES, N_RETURNS = 72_001_232, 7_197_664
N_ORDERS, N_WAREHOUSES = 6_000_000, 15
#: leg O: the star suite at scale 64 (287,996,928 fact rows)
O_SCALE, O_PER_DEVICE = 64, 562_494
#: leg P: the serde round trip
P_V1, P_MAXB = 1 << 22, 92
P_COLS, P_BYTES = 1 << 24, 68
LEGS_M_TO_P = ("M-small", "P", "N", "O", "M")
#: leg Q: durability at leg F's records and geometry; Q-small: 2^20
Q_SEED, Q_SID = 0, 90
Q_SMALL = 1 << 20
LEGS_Q = ("Q", "Q-small")
#: native_staging: the P-shaped size of its on/off and fault runs
NS_SMALL = 1 << 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warm: int = 2, inner: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs
    of ``inner`` back-to-back calls each (per call). With ``inner`` = 1
    a short kernel's time includes the host's launch gap, since the card
    waits idle between the start event and the launch."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: one warm-up call outside
    the capture (it builds, loads and plans), then ``launches`` calls
    captured in one CUDA graph, the replay timed with CUDA events
    (median of ``reps``) over ``launches``. No host time is in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call over ``calls`` enqueues (the loop timed
    with ``time.perf_counter``, then one synchronise)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
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


#: the send shapes ``[D, R, D, ppd, W, C]`` legs B-Q launch the ring
#: kernel at, with the legs that launch each (what ``RingShapes`` recorded
#: on an H100; ``ring_leg_phases`` fails if a run records another set);
#: an a2a shape goes through ``ring_all_to_all`` as ``[D, D, ppd, W, C]``.
#: ``tests/test_torch_ring.py`` holds the kernel's launch plan and per-item
#: copy at these, the phase shapes and the edge shapes;
#: ``scripts/torch_ring_ab.py`` times these and the phase shapes.
RING_LEG_SHAPES = [
    # (legs, shape, a2a)
    ("M-small", (8, 1, 8, 1, 3, 14), False),
    ("D-small", (8, 1, 8, 1, 3, 32769), False),
    ("E", (8, 1, 8, 1, 3, 2097153), False),
    ("M-small", (8, 1, 8, 1, 4, 5), False),
    ("M-small", (8, 1, 8, 1, 4, 8), False),
    ("M-small", (8, 1, 8, 1, 4, 14), False),
    ("M-small", (8, 1, 8, 1, 4, 43), False),
    ("M-small", (8, 1, 8, 1, 4, 45), False),
    ("M-small", (8, 1, 8, 1, 4, 89), False),
    ("M-small", (8, 1, 8, 1, 4, 193), False),
    ("M-small", (8, 1, 8, 1, 4, 513), False),
    ("M", (8, 1, 8, 1, 4, 3201), False),
    ("D-small", (8, 1, 8, 1, 4, 32768), True),
    ("D-small", (8, 1, 8, 1, 4, 32769), False),
    ("D", (8, 1, 8, 1, 4, 524289), False),
    ("M-small", (8, 1, 8, 1, 6, 2), False),
    ("M-small", (8, 1, 8, 1, 6, 6), False),
    ("M-small", (8, 1, 8, 1, 6, 12), False),
    ("M-small", (8, 1, 8, 1, 6, 14), False),
    ("M-small", (8, 1, 8, 1, 6, 16), False),
    ("M-small", (8, 1, 8, 1, 6, 43), False),
    ("M-small", (8, 1, 8, 1, 6, 249), False),
    ("M-small", (8, 1, 8, 1, 6, 1665), False),
    ("H-small", (8, 1, 8, 1, 25, 1152), True),
    ("H-small, Q-small", (8, 1, 8, 1, 25, 1153), False),
    ("H-small", (8, 1, 8, 1, 25, 1216), True),
    ("H-small, Q-small", (8, 1, 8, 1, 25, 1217), False),
    ("H-small", (8, 1, 8, 1, 25, 2049), False),
    ("F-small, K-small, Q-small", (8, 1, 8, 1, 25, 4096), True),
    ("C-small", (8, 1, 8, 1, 25, 32768), True),
    ("B-small", (8, 1, 8, 1, 25, 32769), False),
    ("H", (8, 1, 8, 1, 25, 34817), False),
    ("H", (8, 1, 8, 1, 25, 36865), False),
    ("C", (8, 1, 8, 1, 25, 524288), True),
    ("B", (8, 1, 8, 1, 25, 524289), False),
    ("L-small", (8, 1, 8, 1, 46, 32769), False),
    ("L", (8, 1, 8, 1, 46, 524289), False),
    ("G-small, N", (8, 2, 8, 1, 4, 4096), False),
    ("M-small", (8, 2, 8, 1, 6, 4096), False),
    ("F-small, K, K-small, Q-small", (8, 2, 8, 1, 25, 4096), False),
    ("K-small", (8, 2, 8, 1, 25, 4097), False),
    ("P", (8, 2, 8, 1, 26, 4096), False),
    ("G", (8, 2, 8, 2, 4, 4096), False),
    ("P", (8, 2, 8, 2, 22, 4096), False),
    ("F, J, K, Q", (8, 2, 8, 2, 25, 4096), False),
    ("N", (8, 2, 8, 5, 4, 4096), False),
    ("M", (8, 2, 8, 18, 4, 4096), False),
    ("O", (8, 2, 8, 18, 6, 4096), False),
    ("O", (8, 2, 8, 29, 3, 4096), False),
    ("O", (8, 2, 8, 29, 6, 4096), False),
    ("I", (8, 2, 8, 32, 2, 4096), False),
    ("O", (8, 2, 8, 76, 6, 4096), False),
    ("M", (8, 2, 8, 97, 4, 4096), False),
    ("F-small", (8, 5, 8, 1, 25, 4097), False),
    ("F", (8, 34, 8, 2, 25, 4097), False),
]
#: the kernel phases' own shapes that no leg launches: ``ring_phase``'s
#: R = 3 and ``ring_chunk_phase``'s fine class (29 words, not a multiple
#: of 4)
RING_PHASE_SHAPES = {
    "R=3 kernel phase": (8, 3, 8, 1, 25, (1 << 17) + 1),
    "F fine class": (8, 2, 8, 2, 25, 29),
}
#: buffers streamed between two uses of one send/out pair when timing
#: cold: over twice the H100's 50 MB L2
COLD_BYTES = 1 << 27
#: host microseconds per launch of each ring wrapper and of
#: ``permute().contiguous()``, measured once by ``ring_host_phase``
RING_HOST_US = {}
#: what ``ring_device`` adds to each ring line
RING_DEVICE_KEYS = ("device_ms", "library_device_ms", "device_cold_ms",
                    "library_device_cold_ms", "device_share_of_bound",
                    "host_us_per_launch", "library_host_us_per_launch")


def ring_host_us() -> dict:
    """Host cost of one launch: 1000 enqueues of a tiny shape
    ``[8, 1, 8, 1, 1, 4]`` through ``ring_exchange``, its ``[8, 8, 1, 1,
    4]`` form through ``ring_all_to_all``, and ``permute().contiguous()``
    (which allocates its output, as the library call does)."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange)

    tiny = rand_words((PARTS, 1, PARTS, 1, 1, 4), seed=97)
    out = torch.empty_like(tiny)
    tiny2, out2 = tiny.squeeze(1), out.squeeze(1)
    return {"ring_exchange": host_us(lambda: ring_exchange(tiny, out=out)),
            "ring_all_to_all": host_us(
                lambda: ring_all_to_all(tiny2, out=out2)),
            "permute_contiguous": host_us(
                lambda: tiny.permute(2, 1, 0, 3, 4, 5).contiguous())}


def ring_host_phase() -> dict:
    RING_HOST_US.update(ring_host_us())
    line = {"phase": "ring_host", "shape": [PARTS, 1, PARTS, 1, 1, 4],
            "calls": 1000, "host_us_per_launch": dict(RING_HOST_US)}
    report(line)
    return line


def ring_times(send: torch.Tensor, out: torch.Tensor,
               a2a: bool = False) -> dict:
    """Device ms of the ring kernel on ``send`` (``[D, D, ...]`` through
    ``ring_all_to_all`` when ``a2a``) and of ``permute().contiguous()``'s
    copy into a buffer allocated outside the graph, each by CUDA-graph
    replay, twice. Warm: 20 launches on the same buffers, so a pair that
    fits the 50 MB L2 is read from there (a just-gathered send partly is
    on the main path; the pooled out is not). Cold: the launches rotate
    over copies of the pair, ``COLD_BYTES`` in all, so each finds its
    buffers evicted; a pair of ``COLD_BYTES`` or more is cold when warm,
    and is timed once. The share of the HBM bound is the cold one."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange)

    kernel = ring_all_to_all if a2a else ring_exchange
    dims = (1, 0, *range(2, send.dim())) if a2a else \
        (2, 1, 0, *range(3, send.dim()))
    lib_out = torch.empty_like(send)
    pair = 2 * send.numel() * 4
    line = {"device_ms": graph_ms(lambda: kernel(send, out=out)),
            "library_device_ms": graph_ms(
                lambda: lib_out.copy_(send.permute(dims)))}
    copies = -(-COLD_BYTES // max(pair, 1))
    if copies > 1:
        sends = [send] + [send.clone() for _ in range(copies - 1)]
        outs = [out] + [torch.empty_like(out) for _ in range(copies - 1)]
        libs = [lib_out] + [torch.empty_like(send)
                            for _ in range(copies - 1)]
        turn = itertools.count()

        def cold_kernel():
            k = next(turn) % copies
            kernel(sends[k], out=outs[k])

        def cold_library():
            k = next(turn) % copies
            libs[k].copy_(sends[k].permute(dims))

        launches = max(20, copies)
        line["device_cold_ms"] = graph_ms(cold_kernel, launches)
        line["library_device_cold_ms"] = graph_ms(cold_library, launches)
        del sends, outs, libs
    else:
        line["device_cold_ms"] = line["device_ms"]
        line["library_device_cold_ms"] = line["library_device_ms"]
    line["device_share_of_bound"] = \
        pair / MEM_RATE * 1e3 / line["device_cold_ms"]
    del lib_out
    return line


def ring_device(send: torch.Tensor, out: torch.Tensor,
                a2a: bool = False) -> dict:
    """``ring_times`` and the host cost per launch."""
    return {**ring_times(send, out, a2a),
            "host_us_per_launch":
                RING_HOST_US["ring_all_to_all" if a2a else "ring_exchange"],
            "library_host_us_per_launch": RING_HOST_US["permute_contiguous"]}


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
            "plain_ms": plain_ms, "library_ms": library_ms,
            **ring_device(send, got)}
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
            "plain_ms": plain_ms, "library_ms": library_ms,
            **ring_device(send, got, a2a=True)}
    report(line)
    return line


def ring_w3_phase() -> dict:
    """The fused exchange at leg E's shape: W = 3, C = 2^21."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_exchange,
                                                   ring_exchange_plain)

    send = rand_words((PARTS, 1, PARTS, 1, 3, SLOT_B + 1), seed=10)
    got = ring_exchange(send)
    err = max_abs_err(got, ring_exchange_plain(send))
    if err:
        fail(f"ring_exchange disagrees with its plain version at W=3: {err}")
    ms = time_ms(lambda: ring_exchange(send, out=got), reps=20)
    plain_ms = time_ms(lambda: ring_exchange_plain(send), reps=5)
    library_ms = time_ms(
        lambda: send.permute(2, 1, 0, 3, 4, 5).contiguous(), reps=5)
    line = {"phase": "ring_exchange", "leg": "E", "shape": list(send.shape),
            "max_abs_err": err, "kernel_ms": ms,
            "bound_ms": 2 * send.numel() * 4 / MEM_RATE * 1e3,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **ring_device(send, got)}
    report(line)
    return line


def zipf_rows(total: int, per_part: int, seed: int = 7) -> np.ndarray:
    """``bench.py``'s combine-leg records: Zipf(1.1) keys folded into
    ``per_part // 4`` ids in word 1, word 2 uniform in [0, 1000), words
    0 and 3 zero."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((total, 2 + D_VAL_WORDS), np.uint32)
    rows[:, 1] = rng.zipf(1.1, size=total) % max(per_part // 4, 1)
    rows[:, 2] = rng.integers(0, 1000, size=total, dtype=np.uint32)
    return rows


def as_float_payload(rows: np.ndarray) -> np.ndarray:
    """The same records with word 2 the float32 bits of ``value / 8``."""
    out = rows.copy()
    out[:, 2] = (rows[:, 2].astype(np.float32) / 8).view(np.uint32)
    return out


def combine_phase() -> dict:
    """One stacked partition's reduce-side combine at leg D's shape: 2^22
    columns, the first 2^21 of them Zipf records. Each form is held
    bit-exact against the same call on the CPU; then the scan alone:
    the mirrored float tree against the uint32 cumsum on the same
    sorted rows (and the tree on uint32 words against the cumsum)."""
    from sparkrdma_tpu_torch.kernels import aggregate as agg
    from sparkrdma_tpu_torch.kernels.sort import lexsort_cols

    n, m = N_B, N_B // 2
    rows = np.zeros((n, 4), np.uint32)
    rows[:m] = zipf_rows(m, m)
    cols = {}
    for name, r in (("u32", rows), ("f32", as_float_payload(rows))):
        cols[name] = torch.from_numpy(
            np.ascontiguousarray(r.T).view(np.int32)).cuda()
    valid = torch.arange(n, device="cuda") < m
    line = {"phase": "combine", "columns": n, "valid": m}
    err = 0
    for name, c, op, fl in (("u32_sum", cols["u32"], "sum", False),
                            ("u32_min", cols["u32"], "min", False),
                            ("f32_sum", cols["f32"], "sum", True)):
        got, unique = agg.combine_by_key_cols(c, valid, 2, op, fl)
        want, w_unique = agg.combine_by_key_cols(c.cpu(), valid.cpu(), 2,
                                                 op, fl)
        err = max(err, max_abs_err(got.cpu(), want), abs(unique - w_unique))
        line[name + "_ms"] = time_ms(
            lambda: agg.combine_by_key_cols(c, valid, 2, op, fl), reps=5)
        line["unique"] = unique
    srt = {k: lexsort_cols(c, 2, valid)[:, :m] for k, c in cols.items()}
    head, ends = agg._run_bounds(srt["u32"][:2])
    pay_u, pay_f = srt["u32"][2:], srt["f32"][2:].view(torch.float32)
    closed = agg._run_sums(pay_u, head, ends)
    err = max(err, max_abs_err(
        agg._segmented_scan(pay_u, head, "sum")[:, ends], closed))
    line.update(
        max_abs_err=err,
        scan_f32_tree_ms=time_ms(
            lambda: agg._segmented_scan(pay_f, head, "sum"), reps=5),
        scan_u32_tree_ms=time_ms(
            lambda: agg._segmented_scan(pay_u, head, "sum"), reps=5),
        sum_u32_closed_ms=time_ms(
            lambda: agg._run_sums(pay_u, head, ends), reps=5),
        sort_ms=time_ms(lambda: lexsort_cols(cols["u32"], 2, valid),
                        reps=5))
    report(line)
    if err:
        fail(f"combine_by_key_cols: card and CPU disagree: {err}")
    return line


def hash_pids(w0: np.ndarray, w1: np.ndarray, parts: int) -> np.ndarray:
    """numpy copy of ``hash_partitioner(parts, 2)``."""
    h = np.zeros(w0.shape, np.uint64)
    for w in (w0, w1):
        h = ((h ^ w.astype(np.uint64)) * np.uint64(2654435761)) \
            & np.uint64(0xFFFFFFFF)
    return ((h ^ (h >> np.uint64(16))) % np.uint64(parts)).astype(np.int64)


def reduce_expect(rows: np.ndarray, op: str, floating: bool = False):
    """Unique keys (word 1; word 0 is zero) and word 2 reduced by ``op``:
    uint32 sums mod 2^32 (float64 ``bincount``, exact below 2^53),
    float sums in float64."""
    uniq, inv = np.unique(rows[:, 1], return_inverse=True)
    vals = rows[:, 2].view(np.float32) if floating else rows[:, 2]
    if op == "sum":
        red = np.bincount(inv, weights=vals, minlength=len(uniq))
        return uniq, red if floating else (
            red.astype(np.uint64) % (1 << 32)).astype(np.uint32)
    red = np.full(len(uniq), 0 if op == "max" else 0xFFFFFFFF, np.uint32)
    (np.maximum if op == "max" else np.minimum).at(red, inv, vals)
    return uniq, red


def check_reduce(out, totals, uniq, red, lo: int = 0, hi: int = PARTS,
                 floating: bool = False) -> bool:
    """Partition ``d`` holds exactly the keys hashing to it (if ``lo <= d
    < hi``), ascending, with the expected reductions in word 2."""
    from sparkrdma_tpu_torch.interop import records_from_torch

    host = records_from_torch(out)
    tot = totals.cpu().numpy()
    oc = host.shape[1] // PARTS
    pid = hash_pids(np.zeros_like(uniq), uniq, PARTS)
    for d in range(PARTS):
        sel = (pid == d) & (lo <= d < hi)
        seg = host[:, d * oc:d * oc + int(tot[d])]
        if tot[d] != sel.sum() or seg[0].any() or seg[3].any() or \
                not np.array_equal(seg[1], uniq[sel]):
            return False
        if floating:
            if not np.allclose(seg[2].view(np.float32), red[sel],
                               rtol=1e-5):
                return False
        elif not np.array_equal(seg[2], red[sel]):
            return False
    return True


def check_sorted(out, totals, rows: np.ndarray, lo: int, hi: int) -> bool:
    """Partitions ``[lo, hi)`` hold their records in full-record order,
    the others nothing."""
    from sparkrdma_tpu_torch.interop import records_from_torch

    host = records_from_torch(out)
    tot = totals.cpu().numpy()
    oc = host.shape[1] // PARTS
    pid = hash_pids(rows[:, 0], rows[:, 1], PARTS)
    for d in range(PARTS):
        want = rows[pid == d] if lo <= d < hi else rows[:0]
        want = want[np.lexsort(tuple(want[:, c] for c in range(3, -1, -1)))]
        if not np.array_equal(host[:, d * oc:d * oc + int(tot[d])].T, want):
            return False
    return True


def reduce_manager(device: str, **kw):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    conf = ShuffleConf(slot_records=SLOT_B, transport="pallas_ring",
                       val_words=D_VAL_WORDS, map_side_combine="on", **kw)
    return ShuffleManager(MeshRuntime(conf, num_partitions=PARTS,
                                      device=device))


def write(manager, shuffle_id: int, rows: np.ndarray):
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner

    h = manager.register_shuffle(shuffle_id, PARTS,
                                 hash_partitioner(PARTS, 2))
    plan = manager.get_writer(h).write(
        manager.runtime.shard_records(rows)).stop()
    return h, plan


def leg_d():
    """``reduce_by_key`` at ``bench.py``'s combine leg, 16,777,216
    records: 1 warm-up read and 3 timed reads, checked against numpy."""
    kernels = zeroed_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = zipf_rows(RECORDS, RECORDS // PARTS)
    m = reduce_manager("cuda")
    h, plan = write(m, 70, rows)
    reader = m.get_reader(h, aggregator="sum")
    reader.read(record_stats=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2):
        reader.read(record_stats=False)
    out, totals = reader.read()
    read_s = (time.perf_counter() - t1) / 3
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    ws = m._exchange.wire_stats()
    uniq, red = reduce_expect(rows, "sum")
    verified = check_reduce(out, totals, uniq, red)
    line = {"leg": "D", "records": RECORDS, "record_bytes": rows.shape[1] * 4,
            "partitions": PARTS, "transport": "pallas_ring",
            "ring_fused": True, "aggregator": "sum", "map_side_combine": "on",
            "gbps": RECORDS * rows.shape[1] * 4 / read_s / 1e9,
            "read_s": read_s, "wall_s": wall, "capacity": plan.capacity,
            "rounds": plan.num_rounds, "out_capacity": plan.out_capacity,
            "unique_keys": int(totals.sum()),
            "combine_wire_reduction_ratio":
                ws["combine_in_bytes"] / ws["combine_out_bytes"],
            "combine_dup_ratio": ws["combine_dup_ratio"], "wire": ws,
            "verified": verified, "check": "host (numpy)",
            "launches": launches}
    report(line)
    if not verified:
        fail("leg D disagrees with numpy")
    del out, totals
    profile("leg D read", reader.read, "profiles/torch_legD.txt")
    m.stop()
    return line


def leg_d_small():
    """2^20 records of leg D's mix through the same entry points on the
    card and on the CPU: every read bit-identical between the two, and
    equal to numpy."""
    from sparkrdma_tpu_torch.kernels.sort import as_unsigned

    rows = zipf_rows(D_SMALL, D_SMALL // PARTS)
    rows_f = as_float_payload(rows)

    def key_filter(r):
        return as_unsigned(r[1]) % 3 != 0

    reads = [("sum", 1, dict(aggregator="sum")),
             ("min", 1, dict(aggregator="min")),
             ("max", 1, dict(aggregator="max")),
             ("f32_sum", 2, dict(aggregator="sum", float_payload=True)),
             ("filter+project sum", 1, dict(aggregator="sum",
                                            row_filter=key_filter,
                                            keep_words=(0, 1, 2))),
             ("range [2,5) sum", 1, dict(start_partition=2, end_partition=5,
                                         aggregator="sum")),
             ("range [2,5) key_ordering", 1, dict(
                 start_partition=2, end_partition=5, key_ordering=True))]

    def run(device, **kw):
        m = reduce_manager(device, fast_sort=True, fast_sort_run=RUN, **kw)
        hs = {1: write(m, 1, rows)[0], 2: write(m, 2, rows_f)[0]}
        res = {}
        for name, sid, rkw in reads:
            out, totals = m.get_reader(hs[sid], **rkw).read()
            res[name] = (out.cpu(), totals.cpu())
        return m, res, hs

    kernels = zeroed_counters()
    m, card, hs = run("cuda")
    unfused = reduce_manager("cuda", ring_fused=False)
    u_out, u_tot = unfused.get_reader(write(unfused, 1, rows)[0],
                                      aggregator="sum").read()
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    out_cap = m._writers[1].plan.out_capacity
    m.stop()
    unfused.stop()
    _, cpu, _ = run("cpu")
    same = {name: bool(torch.equal(card[name][0], cpu[name][0])
                       and torch.equal(card[name][1], cpu[name][1]))
            for name, _, _ in reads}
    kept = rows[rows[:, 1] % 3 != 0]
    numpy_ok = {
        "sum": check_reduce(*card["sum"], *reduce_expect(rows, "sum")),
        "min": check_reduce(*card["min"], *reduce_expect(rows, "min")),
        "max": check_reduce(*card["max"], *reduce_expect(rows, "max")),
        "f32_sum": check_reduce(*card["f32_sum"],
                                *reduce_expect(rows_f, "sum", True),
                                floating=True),
        "filter+project sum": check_reduce(*card["filter+project sum"],
                                           *reduce_expect(kept, "sum")),
        "range [2,5) sum": check_reduce(*card["range [2,5) sum"],
                                        *reduce_expect(rows, "sum"), 2, 5),
        "range [2,5) key_ordering": check_sorted(
            *card["range [2,5) key_ordering"], rows, 2, 5)}
    unfused_same = bool(torch.equal(u_out.cpu(), card["sum"][0])
                        and torch.equal(u_tot.cpu(), card["sum"][1]))
    line = {"leg": "D-small", "records": len(rows), "partitions": PARTS,
            "out_capacity": out_cap, "reads": [r[0] for r in reads],
            "card_equals_cpu": same, "equals_numpy": numpy_ok,
            "ring_fused_false_equals_fused": unfused_same,
            "launches": launches}
    report(line)
    if not (all(same.values()) and all(numpy_ok.values()) and unfused_same):
        fail("leg D-small: the card, the CPU and numpy disagree")
    return line


def kronecker_edges(scale: int, edgefactor: int, seed: int) -> np.ndarray:
    """A Graph500 Kronecker (R-MAT) edge list ``int64[M, 2]`` made on the
    card: initiator A = 0.57, B = C = 0.19, D = 0.05, SCALE bit levels,
    then a seeded vertex permutation and edge shuffle, as the Graph500
    specification's generator does; self-loops and duplicates kept."""
    n, m = 1 << scale, edgefactor << scale
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    ij = torch.zeros((2, m), dtype=torch.int64, device="cuda")
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device="cuda") > ab
        jj = torch.rand(m, generator=gen, device="cuda") > torch.where(
            ii, c_norm, a_norm)
        ij[0] |= ii.to(torch.int64) << bit
        ij[1] |= jj.to(torch.int64) << bit
    ij = torch.randperm(n, generator=gen, device="cuda")[ij]
    ij = ij[:, torch.randperm(m, generator=gen, device="cuda")]
    return ij.T.contiguous().cpu().numpy()


def leg_e():
    """PageRank, 5 iterations, through ``run_pagerank`` on the card."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.workloads.pagerank import run_pagerank

    t0 = time.perf_counter()
    edges = kronecker_edges(E_SCALE, E_EDGEFACTOR, seed=22)
    gen_s = time.perf_counter() - t0
    conf = ShuffleConf(key_words=2, val_words=1, transport="pallas_ring",
                       slot_records=SLOT_B, map_side_combine="auto")
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res = run_pagerank(MeshRuntime(conf, num_partitions=PARTS,
                                   device="cuda"),
                       edges, 1 << E_SCALE, iterations=5)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    plan = res.plan
    line = {"leg": "E", "workload": "pagerank",
            "graph": f"Graph500 Kronecker SCALE {E_SCALE} edgefactor "
                     f"{E_EDGEFACTOR}, A=0.57 B=C=0.19, seed 22",
            "vertices": res.num_vertices, "edges": res.num_edges,
            "partitions": PARTS, "iterations": res.iterations,
            "per_iter_s": res.per_iter_s,
            "edges_per_s": res.num_edges / res.per_iter_s,
            "graph_gen_s": gen_s, "wall_s": time.perf_counter() - t0,
            "combine_on": "combine_in_records" in res.wire,
            "wire_last_iteration": res.wire, "capacity": plan.capacity,
            "rounds": plan.num_rounds, "out_capacity": plan.out_capacity,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "verified": res.verified, "check": "numpy float64 PageRank, "
            "rtol 1e-4 atol 1e-7", "launches": launches}
    report(line)
    if not res.verified:
        fail("leg E: PageRank disagrees with numpy")
    return line


def zeroed_counters():
    """The kernel wrappers, each launch count set to 0."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange)
    from sparkrdma_tpu_torch.kernels.merge_sort import (merge_splits,
                                                        merge_stage)

    kernels = {"merge_stage": merge_stage, "merge_splits": merge_splits,
               "ring_exchange": ring_exchange,
               "ring_all_to_all": ring_all_to_all}
    for k in kernels.values():
        k.launches = 0
    return kernels


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
    kernels = zeroed_counters()
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


def profile(label: str, read, path: str) -> dict:
    """Device time by kernel of one ``read()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    read()
    read_ms = time_ms(read, reps=3, warm=0)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        read()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs("profiles", exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    line = {"profile": label, "read_ms": read_ms,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / read_ms),
            "top": [[k[:60], us / 1e3, c] for us, k, c in rows[:10]],
            "merge_kernels": [[k[:60], us / 1e3, c] for us, k, c in rows
                              if "merge_s" in k]}
    report(line)
    return line


def profile_read(label: str, conf, path: str) -> dict:
    """Device time by kernel for one key-ordered TeraSort read of
    ``RECORDS`` 100-byte records over ``PARTS`` stacked partitions."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    m = ShuffleManager(MeshRuntime(conf, num_partitions=PARTS))
    recs = random_records(RECORDS, KEY_WORDS + VAL_WORDS, 7, "cuda")
    spl = compute_splitters(make_sampler(PARTS, KEY_WORDS, 256, 7)(
        recs), PARTS)
    h = m.register_shuffle(9, PARTS, range_partitioner(spl))
    m.get_writer(h).write(recs).stop()
    line = profile(label, m.get_reader(h, key_ordering=True).read, path)
    m.stop()
    return line


def default_conf(**kw):
    """The reference's default geometry: only the transport and the
    record width are set."""
    from sparkrdma_tpu_torch import ShuffleConf

    return ShuffleConf(transport="pallas_ring", **kw)


def terasort_manager(device: str, **kw):
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    return ShuffleManager(MeshRuntime(default_conf(val_words=VAL_WORDS, **kw),
                                      num_partitions=PARTS, device=device))


def leg_f(leg_b_gbps: float) -> dict:
    """TeraSort at the reference's default geometry: 16,777,216 × 100-byte
    records, 8 stacked partitions, the streaming regime; 1 warm-up and 3
    reads, device-verified."""
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    m = terasort_manager("cuda")
    kernels = zeroed_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, out, totals = run_terasort(m, RECORDS // PARTS, seed=0, verify=False,
                                    device_verify=True, repeats=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    plan, ex = res.plan, m._exchange
    f_in = m.conf.max_rounds_in_flight
    pool = m.runtime.pool.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del out, totals
    m.stop()
    torch.cuda.empty_cache()
    # the same plan in one fused round: what streaming costs
    fused = terasort_manager("cuda", max_rounds_in_flight=plan.num_rounds)
    res_fused, out, totals = run_terasort(
        fused, RECORDS // PARTS, seed=0, verify=False, device_verify=True,
        repeats=3)
    same_plan = (res_fused.plan.num_rounds == plan.num_rounds
                 and fused._exchange.last_dispatches == 1)
    del out, totals
    fused.stop()
    line = {"leg": "F", "records": res.records, "partitions": PARTS,
            "record_bytes": res.record_bytes, "transport": "pallas_ring",
            "conf": "defaults (slot_records 4096, max_rounds 64, "
                    "max_rounds_in_flight 2, queue_depth 8, fast_sort off, "
                    "pool on)",
            "sort_mode": ex.sort_mode(res.record_bytes // 4),
            "gbps": res.gbps, "read_s": res.sort_exchange_s,
            "leg_b_gbps": leg_b_gbps,
            "fused_same_plan_gbps": res_fused.gbps,
            "fused_same_plan_read_s": res_fused.sort_exchange_s,
            "fused_same_plan_verified": res_fused.verified,
            "wall_s": wall,
            "capacity": plan.capacity, "rounds": plan.num_rounds,
            "split_factor": plan.split_factor,
            "out_capacity": plan.out_capacity,
            "chunks": -(-plan.num_rounds // f_in),
            "dispatches": ex.last_dispatches, "reads": 4,
            "stream_chunks": m.metrics.counter(
                "exchange.stream_chunks").value,
            "queue_blocks": m.metrics.counter("exchange.queue_blocks").value,
            "pool": pool, "max_memory_gb": peak_gb,
            "verified": res.verified, "check": "device",
            "launches": launches}
    report(line)
    if not (res.verified and res_fused.verified and same_plan):
        fail("leg F failed verification")
    if ex.last_dispatches <= 1:
        fail("leg F did not take the streaming regime")
    return line


def ring_chunk_phase(leg_f_line: dict) -> dict:
    """The fused exchange at the streaming chunk shape leg F's plan gives
    ([D, F, D, ppd, W, C], no counts lane), and at a "fine" size class
    that is not a multiple of 4 words."""
    from sparkrdma_tpu_torch.config import size_class_fine
    from sparkrdma_tpu_torch.exchange.ring import (ring_exchange,
                                                   ring_exchange_plain)

    w = KEY_WORDS + VAL_WORDS
    ppd = leg_f_line["split_factor"]
    shape = (PARTS, 2, PARTS, ppd, w, leg_f_line["capacity"])
    cap = size_class_fine(FINE_CAP)
    if cap % 4 == 0:
        fail(f"fine class {cap} is a multiple of 4")
    odd = rand_words((PARTS, 2, PARTS, ppd, w, cap), seed=12)
    err = max_abs_err(ring_exchange(odd), ring_exchange_plain(odd))
    send = rand_words(shape, seed=11)
    got = ring_exchange(send)
    err = max(err, max_abs_err(got, ring_exchange_plain(send)))
    if err:
        fail(f"ring_exchange disagrees with its plain version at the "
             f"chunk shape: {err}")
    line = {"phase": "ring_exchange", "leg": "F chunk", "shape": list(shape),
            "fine_shape": list(odd.shape), "max_abs_err": err,
            # 20 launches per timing: a 0.1 ms kernel alone would be
            # timed with the host's launch gap in it
            "kernel_ms": time_ms(lambda: ring_exchange(send, out=got),
                                 reps=10, inner=20),
            "kernel_ms_single": time_ms(lambda: ring_exchange(send, out=got),
                                        reps=50),
            "bound_ms": 2 * send.numel() * 4 / MEM_RATE * 1e3,
            "plain_ms": time_ms(lambda: ring_exchange_plain(send), reps=10,
                                inner=20),
            "library_ms": time_ms(
                lambda: send.permute(2, 1, 0, 3, 4, 5).contiguous(),
                reps=10, inner=20),
            **ring_device(send, got)}
    report(line)
    return line


def valid_rows(out: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Every partition's valid prefix, side by side (layout-free: two
    output capacities compare equal when their records do)."""
    oc = out.shape[1] // PARTS
    return torch.cat([out[:, d * oc:d * oc + t]
                      for d, t in enumerate(totals.tolist())], dim=1)


def leg_f_small() -> dict:
    """2^20 records of leg F's geometry on the card and on the CPU in five
    variants; every read equal across devices, variants and the fused
    regime, and host-checked; then the pool and the per-partition
    views."""
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.workloads.terasort import (random_records,
                                                        run_terasort)

    recs = random_records(F_SMALL, KEY_WORDS + VAL_WORDS, 5, "cuda")
    variants = [("default", {}), ("fast_sort", dict(fast_sort=True)),
                ("ring_fused=False", dict(ring_fused=False)),
                ("queue_depth=1", dict(queue_depth=1)),
                ("fine", dict(geometry_classes="fine")),
                ("fused regime", dict(max_rounds_in_flight=64))]
    kernels = zeroed_counters()
    results, info = {}, {}
    for device in ("cuda", "cpu"):
        x = recs if device == "cuda" else recs.cpu()
        for name, kw in variants:
            m = terasort_manager(device, **kw)
            res, out, totals = run_terasort(
                m, 0, seed=5, input_records=x, verify=name == "default",
                device_verify=True, warmup=False)
            results[device, name] = (valid_rows(out, totals).cpu(),
                                     totals.cpu(), res.verified)
            info[name] = {"rounds": res.plan.num_rounds,
                          "out_capacity": res.plan.out_capacity,
                          "dispatches": m._exchange.last_dispatches}
            m.stop()
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    want = results["cuda", "fused regime"]
    same = {f"{dev}/{name}": bool(torch.equal(r[0], want[0])
                                  and torch.equal(r[1], want[1]))
            for (dev, name), r in results.items()}
    verified = {f"{dev}/{name}": r[2] for (dev, name), r in results.items()}

    # the pool on a repeat read, and the per-partition views
    m = terasort_manager("cuda")
    h = m.register_shuffle(3, PARTS, hash_partitioner(PARTS, 2))
    m.get_writer(h).write(recs).stop()
    reader = m.get_reader(h)
    reader.read()
    first = m.runtime.pool.stats()
    reader.read()
    second = m.runtime.pool.stats()
    view = reader.read_view()
    views_equal = all(
        np.array_equal(records_from_torch(view.partition(p)).T,
                       reader.read_partition(p)) for p in range(PARTS))
    view.release()
    pool_hits = second["hits"] - first["hits"]
    m.stop()
    line = {"leg": "F-small", "records": F_SMALL, "partitions": PARTS,
            "variants": info, "equal_to_fused_read": same,
            "verified": verified, "check": "host (default) + device (all)",
            "second_read_pool_hits": pool_hits, "pool": second,
            "read_view_equals_read_partition": views_equal,
            "launches": launches}
    report(line)
    if not (all(same.values()) and all(verified.values()) and views_equal
            and pool_hits > 0):
        fail("leg F-small: a variant, the CPU, the pool or a view disagrees")
    return line


def leg_g() -> dict:
    """``reduce_by_key`` at leg D's data and the default geometry: 1 warm-
    up and 3 reads, checked against numpy. The plan is made before the
    map-side combine (as in the reference), so most streamed rounds carry
    nothing; the line counts them."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rows = zipf_rows(RECORDS, RECORDS // PARTS)
    m = ShuffleManager(MeshRuntime(default_conf(
        val_words=D_VAL_WORDS, map_side_combine="on"),
        num_partitions=PARTS, device="cuda"))
    h, plan = write(m, 71, rows)
    # rounds that carry data: ceil of the largest post-combine count
    _, _, incoming = m._exchange.exchange(
        m._writers[71].records, h.partitioner, plan, PARTS,
        aggregator="sum")
    kernels = zeroed_counters()
    reader = m.get_reader(h, aggregator="sum")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reader.read(record_stats=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2):
        reader.read(record_stats=False)
    out, totals = reader.read()
    read_s = (time.perf_counter() - t1) / 3
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    ws = m._exchange.wire_stats()
    verified = check_reduce(out, totals, *reduce_expect(rows, "sum"))
    f_in = m.conf.max_rounds_in_flight
    moved = -(-plan.num_rounds // f_in) * f_in
    with_data = -(-int(incoming.max()) // plan.capacity)
    line = {"leg": "G", "records": RECORDS, "record_bytes": rows.shape[1] * 4,
            "partitions": PARTS, "aggregator": "sum",
            "conf": "defaults + map_side_combine on",
            "gbps": RECORDS * rows.shape[1] * 4 / read_s / 1e9,
            "read_s": read_s, "wall_s": wall, "capacity": plan.capacity,
            "rounds": plan.num_rounds, "split_factor": plan.split_factor,
            "out_capacity": plan.out_capacity, "chunks": moved // f_in,
            "rounds_moved": moved, "rounds_with_data": with_data,
            "rounds_empty": moved - with_data,
            "dispatches": m._exchange.last_dispatches,
            "unique_keys": int(totals.sum()),
            "combine_wire_reduction_ratio":
                ws["combine_in_bytes"] / ws["combine_out_bytes"],
            "pool": m.runtime.pool.stats(), "verified": verified,
            "check": "host (numpy)", "launches": launches}
    report(line)
    if not verified:
        fail("leg G disagrees with numpy")
    m.stop()
    return line


def leg_g_small() -> dict:
    """2^20 records of leg G's mix, uint32 and float32 sums, on the card
    and on the CPU: bit-identical, and equal to numpy."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rows = zipf_rows(D_SMALL, D_SMALL // PARTS)
    rows_f = as_float_payload(rows)
    kernels = zeroed_counters()
    got = {}
    for device in ("cuda", "cpu"):
        m = ShuffleManager(MeshRuntime(default_conf(
            val_words=D_VAL_WORDS, map_side_combine="on"),
            num_partitions=PARTS, device=device))
        for name, r, fl in (("u32_sum", rows, False),
                            ("f32_sum", rows_f, True)):
            h, plan = write(m, 1 + fl, r)
            out, totals = m.get_reader(h, aggregator="sum",
                                       float_payload=fl).read()
            got[device, name] = (out.cpu(), totals.cpu(), plan.num_rounds,
                                 m._exchange.last_dispatches)
        m.stop()
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    same = {n: bool(torch.equal(got["cuda", n][0], got["cpu", n][0])
                    and torch.equal(got["cuda", n][1], got["cpu", n][1]))
            for n in ("u32_sum", "f32_sum")}
    numpy_ok = {
        "u32_sum": check_reduce(*got["cuda", "u32_sum"][:2],
                                *reduce_expect(rows, "sum")),
        "f32_sum": check_reduce(*got["cuda", "f32_sum"][:2],
                                *reduce_expect(rows_f, "sum", True),
                                floating=True)}
    line = {"leg": "G-small", "records": D_SMALL, "partitions": PARTS,
            "rounds": got["cuda", "u32_sum"][2],
            "dispatches": got["cuda", "u32_sum"][3],
            "card_equals_cpu": same, "equals_numpy": numpy_ok,
            "launches": launches}
    report(line)
    if not (all(same.values()) and all(numpy_ok.values())):
        fail("leg G-small: the card, the CPU and numpy disagree")
    return line


def ooc_manager(root: str, chunk: int, device: str = "cuda", **kw):
    """A manager at ``run_oversub``'s geometry (``bench.py:394-415``):
    slots of one chunk, "fine" classes, a host watermark of four chunks,
    two promotions ahead, tier and spill directories under ``root``;
    8 stacked partitions on the fused ring."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    w = KEY_WORDS + VAL_WORDS
    slot = max(4096, chunk)
    conf = dict(slot_records=slot, max_rounds=64,
                max_slot_records=max(1 << 22, 2 * slot),
                val_words=VAL_WORDS, geometry_classes="fine",
                transport="pallas_ring",
                spill_dir=os.path.join(root, "spill"),
                spill_tier_dir=os.path.join(root, "tier"),
                spill_tier_host_bytes=4 * w * chunk * 4,
                spill_tier_prefetch=2)
    conf.update(kw)
    return ShuffleManager(MeshRuntime(ShuffleConf(**conf),
                                      num_partitions=PARTS, device=device))


def fold_expect(cols: np.ndarray) -> np.ndarray:
    """numpy's record count and per-word sums mod 2^32."""
    return np.concatenate([[np.uint32(cols.shape[1] & 0xFFFFFFFF)],
                           cols.sum(axis=1, dtype=np.uint32)])


def leg_h() -> dict:
    """``bench.py``'s out-of-core leg on one card: ``run_tiered_terasort``
    (``collect=False``) over 16 chunks, with a 4-chunk run before it for
    peak device memory; the streaming fold over the same dataset; a
    profile of 4 chunks of the fold."""
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        run_streaming_terasort, run_tiered_terasort)

    t0 = time.perf_counter()
    w, chunk = KEY_WORDS + VAL_WORDS, H_CHUNK
    cols = np.random.default_rng(5).integers(
        0, 2**32, size=(w, H_CHUNKS * chunk), dtype=np.uint32)
    gen_s = time.perf_counter() - t0
    runs = {}
    for n in (4, H_CHUNKS):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc_") as tmp:
            m = ooc_manager(tmp, chunk)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels = zeroed_counters()
            res = run_tiered_terasort(m, cols[:, :n * chunk], chunk,
                                      collect=False, shuffle_id_base=900)
            torch.cuda.synchronize()
            runs[n] = {"res": res,
                       "launches": {k: v.launches
                                    for k, v in kernels.items()},
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "host_pool": m.tiered.host_pool.stats(),
                       "pool": m.runtime.pool.stats()}
            m.stop()
        torch.cuda.empty_cache()
    res = runs[H_CHUNKS]["res"]
    spill, fetch, hits, sync = res.store_stats
    # the same 16 chunks again, each read checked on the card: the timed
    # runs above carry no check, the fold below only a multiset's
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc_") as tmp:
        m = ooc_manager(tmp, chunk)
        checked = run_tiered_terasort(m, cols, chunk, collect=False,
                                      shuffle_id_base=900, device_verify=True)
        m.stop()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fold_") as tmp:
        m = ooc_manager(tmp, chunk)
        fold = run_streaming_terasort(m, ArrayChunkSource(cols, chunk))
        fold_ok = bool(np.array_equal(fold.fold_sums, fold_expect(cols)))
        prof = profile("leg H fold, 4 chunks", lambda: run_streaming_terasort(
            m, ArrayChunkSource(cols[:, :4 * chunk], chunk)),
            "profiles/torch_legH.txt")
        m.stop()
    torch.cuda.empty_cache()
    peak4, peak16 = runs[4]["peak_gb"], runs[H_CHUNKS]["peak_gb"]
    line = {"leg": "H", "workload": "run_tiered_terasort (collect=False)",
            "records": res.records, "record_bytes": res.record_bytes,
            "dataset_bytes": res.total_bytes, "chunks": res.chunks,
            "chunk_records": chunk, "partitions": PARTS,
            "transport": "pallas_ring",
            "conf": "run_oversub: slot 2,097,152, max_slot 4,194,304, "
                    "max_rounds 64, fine classes, host watermark 4 chunks "
                    "(838,860,800 B), prefetch 2",
            "cuts": "8 partitions stacked on one card (the reference's 8 "
                    "chips); the dataset fits the card's 80 GB, residency "
                    "is held against one chunk as the reference does",
            "gbps": res.gbps, "stream_s": res.stream_s,
            "spill_bytes": spill, "fetch_bytes": fetch,
            "prefetch_hits": hits, "sync_fetches": sync,
            "store_host_pool": runs[H_CHUNKS]["host_pool"],
            "staging_pool": res.staging,
            "slot_pool": runs[H_CHUNKS]["pool"],
            "max_memory_gb": peak16, "max_memory_gb_4_chunks": peak4,
            "peak_ratio_16_over_4": peak16 / peak4,
            "gbps_4_chunks": runs[4]["res"].gbps,
            "store_stats_4_chunks": runs[4]["res"].store_stats,
            "fold_gbps": fold.gbps, "fold_stream_s": fold.stream_s,
            "fold_staging_pool": fold.staging,
            "fold_sums_equal_numpy": fold_ok,
            "device_verified": checked.verified,
            "device_verified_gbps": checked.gbps,
            "fold_idle_share_4_chunks": prof["idle_share"],
            "gen_s": gen_s, "wall_s": time.perf_counter() - t0,
            "launches": runs[H_CHUNKS]["launches"],
            "check": "every chunk's read on the card (a third run); fold "
                     "sums vs numpy; spill > 0; peak(16) within 10 % of "
                     "peak(4)"}
    report(line)
    if checked.verified is not True:
        fail("leg H: a chunk's read failed the device check")
    if not fold_ok:
        fail("leg H: the fold's sums disagree with numpy")
    if spill <= 0:
        fail("leg H: nothing was spilled to disk")
    if abs(peak16 - peak4) > 0.1 * peak4:
        fail(f"leg H: peak device memory {peak16:.3f} GB at 16 chunks is "
             f"not within 10 % of {peak4:.3f} GB at 4 chunks")
    return line


def ring_ooc_phase() -> dict:
    """The fused exchange at the shape leg H's chunk plan gives it: chunk
    0 of leg H's dataset, planned by leg H's manager with the splitters
    the workload draws (slots of one chunk, "fine" classes), in the fused
    regime's layout ``[D, R, D, ppd, W, C + 1]`` (lane 0 of round 0 holds
    the size exchange)."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_exchange,
                                                   ring_exchange_plain)
    from sparkrdma_tpu_torch.interop import records_to_torch
    from sparkrdma_tpu_torch.workloads.streaming import _splitter_partitioner

    w, chunk = KEY_WORDS + VAL_WORDS, H_CHUNK
    first = np.random.default_rng(5).integers(
        0, 2**32, size=(w, chunk), dtype=np.uint32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_ooc_") as tmp:
        m = ooc_manager(tmp, chunk)
        part = _splitter_partitioner(first, PARTS, KEY_WORDS, 256)
        h = m.register_shuffle(1, PARTS, part)
        plan = m.get_writer(h).write(
            records_to_torch(first, m.runtime.device)).stop()
        fused = plan.num_rounds <= m.conf.max_rounds_in_flight
        m.stop()
    if not fused:
        fail(f"leg H's chunk plan streams ({plan.num_rounds} rounds): the "
             "ring phase assumes the fused layout")
    shape = (PARTS, plan.num_rounds, PARTS, plan.split_factor, w,
             plan.capacity + 1)
    send = rand_words(shape, seed=13)
    got = ring_exchange(send)
    err = max_abs_err(got, ring_exchange_plain(send))
    if err:
        fail(f"ring_exchange disagrees with its plain version at leg H's "
             f"chunk shape: {err}")
    line = {"phase": "ring_exchange", "leg": "H chunk", "shape": list(shape),
            "plan": {"rounds": plan.num_rounds, "capacity": plan.capacity,
                     "split_factor": plan.split_factor,
                     "out_capacity": plan.out_capacity},
            "max_abs_err": err,
            "kernel_ms": time_ms(lambda: ring_exchange(send, out=got),
                                 reps=10, inner=5),
            "kernel_ms_single": time_ms(lambda: ring_exchange(send, out=got),
                                        reps=20),
            "bound_ms": 2 * send.numel() * 4 / MEM_RATE * 1e3,
            "plain_ms": time_ms(lambda: ring_exchange_plain(send), reps=10,
                                inner=5),
            "library_ms": time_ms(
                lambda: send.permute(2, 1, 0, 3, 4, 5).contiguous(),
                reps=10, inner=5),
            **ring_device(send, got)}
    report(line)
    return line


class RingShapes:
    """The send shapes the ring kernel is launched at while inside the
    ``with``, with their launch counts: ``exchange/ring.py``'s ``_launch``
    is wrapped for the duration (the launch counts stay the wrappers'
    own). Each shape is the canonical ``[D, R, D, ...]`` with a flag:
    ``ring_all_to_all``'s ``[D, D, ...]`` is ``[D, 1, D, ...]``, a2a."""

    def __enter__(self):
        from sparkrdma_tpu_torch.exchange import ring

        self.counts = {}
        self._ring, self._launch = ring, ring._launch

        def launch(send, out, round_axis=True):
            shape = tuple(send.shape) if round_axis else \
                (send.shape[0], 1) + tuple(send.shape[1:])
            key = (shape, not round_axis)
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._launch(send, out, round_axis)

        ring._launch = launch
        return self

    def __exit__(self, *exc):
        self._ring._launch = self._launch


def run_leg(legs: dict, shapes: dict, name: str, fn) -> dict:
    """``legs[name] = fn()``, recording the ring shapes it launched and
    its seconds."""
    t0 = time.perf_counter()
    with RingShapes() as seen:
        legs[name] = fn()
    shapes[name] = seen.counts
    gc.collect()
    torch.cuda.empty_cache()
    report({"leg_s": name, "seconds": time.perf_counter() - t0,
            "memory_allocated_gb_after": torch.cuda.memory_allocated() / 1e9})
    return legs[name]


def ring_leg_phases(shapes: dict) -> list:
    """The ring kernel at every send shape legs B-Q launched it at: random
    words at each shape, bit-exact against its plain version, timed
    beside its bound and ``permute().contiguous()`` (CUDA events over
    20-launch batches below 0.5 ms of bound, and CUDA-graph replay). One
    line per shape, with the launches each leg made at it. Fails if the
    shapes and their legs are not those of ``RING_LEG_SHAPES``, which
    the CPU tests and the A/B script take."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange,
                                                   ring_exchange_plain)

    by_shape = {}
    for leg_name, counts in shapes.items():
        for key, n in counts.items():
            by_shape.setdefault(key, {})[leg_name] = n
    lines = []
    for seed, ((shape, a2a), legs) in enumerate(sorted(by_shape.items())):
        send = rand_words(shape, seed=100 + seed)
        if a2a:
            send = send.squeeze(1)
            kernel, dims = ring_all_to_all, (1, 0, *range(2, send.dim()))
            want = send.transpose(0, 1).contiguous()
        else:
            kernel, dims = ring_exchange, (2, 1, 0, *range(3, send.dim()))
            want = ring_exchange_plain(send)
        got = kernel(send)
        err = max_abs_err(got, want)
        del want
        if err:
            fail(f"the ring kernel disagrees with its plain version at "
                 f"{list(shape)} (a2a {a2a}, legs {sorted(legs)}): {err}")
        bound_ms = 2 * send.numel() * 4 / MEM_RATE * 1e3
        # short kernels are timed back to back, without the launch gap
        inner = 20 if bound_ms < 0.5 else 1
        line = {"phase": "ring_exchange", "shape": list(shape), "a2a": a2a,
                "legs": ", ".join(sorted(legs)), "launches_by_leg": legs,
                "launches": sum(legs.values()), "max_abs_err": err,
                "kernel_ms": time_ms(lambda: kernel(send, out=got),
                                     reps=10, inner=inner),
                "bound_ms": bound_ms,
                "plain_ms": time_ms(
                    lambda: send.permute(dims).contiguous() if a2a
                    else ring_exchange_plain(send), reps=5, inner=inner),
                "library_ms": time_ms(
                    lambda: send.permute(dims).contiguous(), reps=5,
                    inner=inner),
                **ring_device(send, got, a2a)}
        report(line)
        lines.append(line)
        del send, got
        torch.cuda.empty_cache()
    seen = {(tuple(shape), a2a, ", ".join(sorted(legs)))
            for (shape, a2a), legs in by_shape.items()}
    table = {(shape, a2a, ", ".join(sorted(legs.split(", "))))
             for legs, shape, a2a in RING_LEG_SHAPES}
    if seen != table:
        fail(f"the legs launched the ring kernel at other shapes than "
             f"RING_LEG_SHAPES lists: recorded, not listed "
             f"{sorted(seen - table)}; listed, not recorded "
             f"{sorted(table - seen)}")
    return lines


#: the odd shapes the ring kernel is checked at, beside
#: ``RING_LEG_SHAPES`` and ``RING_PHASE_SHAPES`` (``tests/test_torch_ring.py``
#: holds the item sizes against ``exchange/ring.py::ITEM_WORDS``, 4096)
RING_EDGE_SHAPES = {
    "chunk 1 mod 4": (8, 2, 8, 1, 3, 7),
    "chunk 2 mod 4": (4, 1, 4, 2, 1, 3),
    "chunk 3 mod 4": (8, 2, 8, 1, 3, 5),
    "chunk < 4": (8, 1, 8, 3),
    "chunk 1": (8, 2, 8, 1),
    "chunk < item": (8, 1, 8, 1, 25, 129),
    "chunk = item + 1": (2, 1, 2, 4096 + 1),
    "chunk = 2 items": (2, 3, 2, 2 * 4096),
    "chunk 0": (8, 1, 8, 0),
    "D=3, R=5": (3, 5, 3, 2, 7, 101),
    "D=1": (1, 2, 1, 9),
}
#: (send, out) base offsets in words: 0, 4, 8 and 12 bytes
RING_EDGE_OFFSETS = [(0, 0), (1, 0), (0, 2), (3, 1), (2, 3)]


def ring_edge_phase() -> dict:
    """The ring kernel at ``RING_EDGE_SHAPES``, each as views based 0, 4,
    8 and 12 bytes into larger buffers and written with ``out=``, through
    ``ring_exchange`` and (R = 1 shapes) ``ring_all_to_all``; then the
    unfused streaming loop's form, ``ring_all_to_all(send[f],
    out=recv[f])`` at a chunk that is not a multiple of 4 words, with D =
    3. Bit-exact against the plain version; the words around each
    ``out`` stay untouched."""
    from sparkrdma_tpu_torch.exchange.ring import (ring_all_to_all,
                                                   ring_exchange,
                                                   ring_exchange_plain)

    def views(shape, so, oo, seed):
        n = int(np.prod(shape))
        send = rand_words((n + 4,), seed)[so:so + n].view(shape)
        obuf = torch.full((n + 4,), -7, dtype=torch.int32, device="cuda")
        return send, obuf, obuf[oo:oo + n].view(shape), n

    err, checked = 0, 0
    for i, shape in enumerate(RING_EDGE_SHAPES.values()):
        for so, oo in RING_EDGE_OFFSETS:
            send, obuf, out, n = views(shape, so, oo, 300 + i)
            forms = [(ring_exchange, send, out, ring_exchange_plain(send))]
            if shape[1] == 1:
                s2, o2 = send.squeeze(1), out.squeeze(1)
                forms.append((ring_all_to_all, s2, o2,
                              s2.transpose(0, 1).contiguous()))
            for kernel, x, o, want in forms:
                o.fill_(-7)
                got = kernel(x, out=o)
                torch.cuda.synchronize()
                if got.data_ptr() != o.data_ptr():
                    fail(f"{kernel.__name__} did not write into out at "
                         f"{list(shape)}")
                err = max(err, max_abs_err(got, want))
                if not (bool((obuf[:oo] == -7).all())
                        and bool((obuf[oo + n:] == -7).all())):
                    fail(f"{kernel.__name__} wrote outside out at "
                         f"{list(shape)}, offsets {(so, oo)}")
                checked += 1
    # the unfused streaming loop: views send[f], recv[f] of [F, D, D, ...]
    f_in, d, cap = 2, 3, 29
    send = rand_words((f_in, d, d, 2, 5, cap), seed=399)
    recv = torch.full_like(send, -7)
    for f in range(f_in):
        ring_all_to_all(send[f], out=recv[f])
    torch.cuda.synchronize()
    err = max(err, max_abs_err(recv, send.transpose(1, 2).contiguous()))
    checked += 1
    if err:
        fail(f"the ring kernel disagrees with its plain version at an "
             f"edge shape: {err}")
    line = {"phase": "ring_edges", "shapes": [list(x) for x in
                                              RING_EDGE_SHAPES.values()],
            "offsets_words": RING_EDGE_OFFSETS, "launches_checked": checked,
            "streaming_views": [f_in, d, d, 2, 5, cap], "max_abs_err": err}
    report(line)
    return line


def same_runs(a, b) -> bool:
    """Two tiered runs' per-partition reads, chunk by chunk, bit for bit."""
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(np.array_equal(x, y)
                                   for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def runs_in_key_order(runs) -> bool:
    """Each chunk's partitions, read in partition order, ascend by key."""
    for j in range(len(runs[0])):
        rows = np.concatenate([runs[d][j] for d in range(len(runs))])
        key = rows[:, 0].astype(np.uint64) << np.uint64(32) | rows[:, 1]
        if np.any(key[1:] < key[:-1]):
            return False
    return True


def leg_h_small() -> dict:
    """16 chunks of 65,536 × 100-byte records through the out-of-core
    entry points, on the card and on the CPU."""
    from sparkrdma_tpu_torch.hbm.host_staging import write_array
    from sparkrdma_tpu_torch.hbm.input_stream import FileChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        _canon, run_streaming_terasort, run_tiered_terasort)

    w, chunk = KEY_WORDS + VAL_WORDS, H_SMALL_CHUNK
    cols = np.random.default_rng(15).integers(
        0, 2**32, size=(w, H_CHUNKS * chunk), dtype=np.uint32)
    want = _canon(np.ascontiguousarray(cols.T))
    control_bytes = 2 * cols.nbytes
    kernels = zeroed_counters()
    rows, runs, stats, checks = {}, {}, {}, {}
    variant_launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc_small_") as tmp:
        for device in ("cuda", "cpu"):
            for name, kw in (("control",
                              dict(spill_tier_host_bytes=control_bytes)),
                             ("oversubscribed", {})):
                m = ooc_manager(os.path.join(tmp, device + name), chunk,
                                device, **kw)
                res = run_tiered_terasort(m, cols, chunk)
                rows[device, name] = res.rows
                runs[device, name] = res.runs
                stats[f"{device}/{name}"] = res.store_stats
                m.stop()
        m = ooc_manager(os.path.join(tmp, "ckpt"), chunk)
        first = run_tiered_terasort(m, cols, chunk, checkpoint=True,
                                    shuffle_id_base=700)
        keys = [f"ts700.chunk{j}" for j in range(H_CHUNKS)]
        for j in range(0, H_CHUNKS, 2):
            m.tiered.put(keys[j], cols[:, j * chunk:(j + 1) * chunk])
        adopted = m.resume_segments(700)
        lazily = all(m.tiered.tier_of(k) == "disk" for k in adopted)
        again = run_tiered_terasort(m, cols, chunk, resume=True,
                                    shuffle_id_base=700)
        checks["resume_adopted_only_missing"] = \
            adopted == keys[1::2] and lazily
        checks["resume_rows_unchanged"] = bool(
            np.array_equal(again.rows, first.rows)
            and np.array_equal(first.rows, want)
            and same_runs(again.runs, first.runs)
            and same_runs(first.runs, runs["cuda", "oversubscribed"]))
        paths = []
        for j in range(H_CHUNKS):
            paths.append(os.path.join(tmp, f"in{j}.bin"))
            write_array(paths[-1], cols[:, j * chunk:(j + 1) * chunk])
        os.makedirs(os.path.join(tmp, "runs"))
        src = FileChunkSource(paths, w, chunk)
        spilled = run_streaming_terasort(
            m, src, spill_dir=os.path.join(tmp, "runs"), verify=True)
        src.close()
        checks["spill_mode_from_files_verified"] = spilled.verified is True
        m.stop()
        for name, kw in (("fast_sort pow2", dict(
                fast_sort=True, fast_sort_run=4096, geometry_classes="pow2")),
                         ("ring_fused=False", dict(ring_fused=False))):
            before = {k: v.launches for k, v in kernels.items()}
            m = ooc_manager(os.path.join(tmp, name.split()[0]), chunk, **kw)
            res = run_tiered_terasort(m, cols, chunk)
            torch.cuda.synchronize()
            variant_launches[name] = {k: v.launches - before[k]
                                      for k, v in kernels.items()}
            checks[f"{name} reads equal default"] = bool(
                np.array_equal(res.rows, rows["cuda", "oversubscribed"])
                and same_runs(res.runs, runs["cuda", "oversubscribed"]))
            m.stop()
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    # per partition and chunk, before the full-record reordering
    checks["card_equals_cpu"] = all(
        same_runs(runs["cuda", n], runs["cpu", n])
        and np.array_equal(rows["cuda", n], rows["cpu", n])
        for n in ("control", "oversubscribed"))
    checks["spilled_reads_equal_control"] = all(
        same_runs(runs[d, "oversubscribed"], runs[d, "control"])
        for d in ("cuda", "cpu"))
    checks["reads_in_key_order"] = all(runs_in_key_order(r)
                                       for r in runs.values())
    checks["equals_numpy_and_control"] = all(
        np.array_equal(r, want) for r in rows.values())
    checks["control_spills_nothing"] = all(
        stats[f"{d}/control"][0] == 0 for d in ("cuda", "cpu"))
    checks["oversubscribed_spills_no_sync_fetch"] = all(
        stats[f"{d}/oversubscribed"][0] > 0
        and stats[f"{d}/oversubscribed"][3] == 0 for d in ("cuda", "cpu"))
    checks["merge_stage_in_fast_sort"] = \
        variant_launches["fast_sort pow2"]["merge_stage"] > 0
    checks["ring_all_to_all_in_unfused"] = \
        variant_launches["ring_fused=False"]["ring_all_to_all"] > 0
    line = {"leg": "H-small", "records": int(cols.shape[1]),
            "chunks": H_CHUNKS, "chunk_records": chunk,
            "partitions": PARTS, "store_stats": stats,
            "variant_launches": variant_launches, "checks": checks,
            "launches": launches}
    report(line)
    if not all(checks.values()):
        fail("leg H-small: " + ", ".join(k for k, v in checks.items()
                                         if not v))
    return line


# --- legs I-L: repartition, the join, the Dataset verbs, ALS ------------


def timed(fn):
    """``(fn(), seconds)`` with the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def leg_i() -> dict:
    """``BASELINE.md`` config 1: ``repartition(256)`` of 134,217,728
    random 8-byte records (two key words, no payload; 1.07 GB) over 8
    stacked partitions at the default geometry; 1 warm-up and 1 timed
    read, the timed one checked on the card (conservation, and every
    record inside the window of the partition its key hashes to)."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.repartition import run_repartition

    m = ShuffleManager(MeshRuntime(ShuffleConf(
        key_words=2, val_words=0, transport="pallas_ring"),
        num_partitions=PARTS, device="cuda"))
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: run_repartition(
        m, I_PER_DEVICE, num_parts=I_NUM_PARTS, seed=0, device_verify=True))
    launches = {k: v.launches for k, v in kernels.items()}
    line = {"leg": "I", "workload": "run_repartition (BASELINE.md config 1)",
            "records": res.records, "record_bytes": res.record_bytes,
            "total_gb": res.total_bytes / 1e9, "num_parts": I_NUM_PARTS,
            "partitions": PARTS, "transport": "pallas_ring",
            "gbps": res.gbps, "exchange_s": res.exchange_s,
            "plan_s": res.plan_s, "wall_s": wall,
            "dispatches": m._exchange.last_dispatches,
            "stream_chunks": m.metrics.counter(
                "exchange.stream_chunks").value,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "verified": res.verified,
            "check": "device: count, word sums and record-hash sum mod "
                     "2^32, hash placement of every record",
            "launches": launches}
    report(line)
    if not res.verified:
        fail("leg I: the repartition read failed its device check")
    m.stop()
    return line


def join_tables(rows_per_part: int, key_range: int, seed: int):
    """The two tables ``run_hash_join`` makes for the same arguments:
    100-byte rows, key in word 1, payload in [1, 1000) in word 2."""
    rng = np.random.default_rng(seed)

    def gen(n):
        x = np.zeros((PARTS * n, KEY_WORDS + VAL_WORDS), dtype=np.uint32)
        x[:, 1] = rng.integers(0, key_range, size=PARTS * n)
        x[:, 2] = rng.integers(1, 1000, size=PARTS * n)
        return x

    return gen(rows_per_part), gen(rows_per_part)


def join_codes_expect(xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
    """Every joined row of ``xa ⋈ xb`` on word 1, as the sorted codes
    ``key << 20 | a_payload << 10 | b_payload`` (lossless: keys below
    2^24, payloads below 2^10)."""
    kb_order = np.argsort(xb[:, 1], kind="stable")
    kb, pb = xb[kb_order, 1], xb[kb_order, 2].astype(np.uint64)
    lo = np.searchsorted(kb, xa[:, 1], side="left")
    hi = np.searchsorted(kb, xa[:, 1], side="right")
    cnt = hi - lo
    a_ix = np.repeat(np.arange(len(xa)), cnt)
    starts = np.cumsum(cnt) - cnt
    b_ix = lo[a_ix] + (np.arange(len(a_ix)) - starts[a_ix])
    codes = (xa[a_ix, 1].astype(np.uint64) << np.uint64(20)) \
        | (xa[a_ix, 2].astype(np.uint64) << np.uint64(10)) | pb[b_ix]
    codes.sort()
    return codes


def join_codes_got(joined: torch.Tensor, totals) -> tuple:
    """``(sorted codes, other words all zero)`` of a ``Dataset.join``
    output at leg J's layout, computed on the card."""
    from sparkrdma_tpu_torch.kernels.sort import as_unsigned

    cap = joined.shape[1] // PARTS
    codes, zero = [], True
    for d, t in enumerate(np.asarray(totals).tolist()):
        part = joined[:, d * cap:d * cap + int(t)]
        rest = torch.cat([part[:1], part[3:2 + VAL_WORDS],
                          part[3 + VAL_WORDS:]])
        zero = zero and not bool(rest.any())
        codes.append((as_unsigned(part[1]) << 20)
                     | (as_unsigned(part[2]) << 10)
                     | as_unsigned(part[2 + VAL_WORDS]))
    return torch.sort(torch.cat(codes)).values.cpu().numpy(), zero


def leg_j() -> dict:
    """The hash join at 100-byte records: ``run_hash_join`` with 2,097,152
    rows per partition on each side (16,777,216 a side) and keys in
    [0, 2^24), then ``Dataset.join`` on the same rows, its joined rows
    held against a numpy join as a sorted multiset, exactly."""
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.workloads.join import (_numpy_reference_join,
                                                    run_hash_join)

    m = terasort_manager("cuda")
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: run_hash_join(
        m, J_ROWS, J_ROWS, key_range=J_KEY_RANGE, seed=0, verify=False))
    xa, xb = join_tables(J_ROWS, J_KEY_RANGE, seed=0)
    t0 = time.perf_counter()
    ref_count, ref_sum = _numpy_reference_join(xa, xb)
    ref_s = time.perf_counter() - t0
    da = Dataset.from_host_rows(m, xa)
    db = Dataset.from_host_rows(m, xb)
    (joined, totals), ds_join_s = timed(lambda: da.join(db))
    launches = {k: v.launches for k, v in kernels.items()}
    got_codes, zero = join_codes_got(joined, totals)
    del joined, da, db
    want_codes = join_codes_expect(xa, xb)
    rows_equal = bool(zero and np.array_equal(got_codes, want_codes))
    rel_err = abs(res.sum_products - ref_sum) / max(1.0, abs(ref_sum))
    line = {"leg": "J", "workload": "run_hash_join + Dataset.join",
            "rows_a": res.rows_a, "rows_b": res.rows_b,
            "record_bytes": 4 * (KEY_WORDS + VAL_WORDS),
            "key_range": J_KEY_RANGE, "partitions": PARTS,
            "transport": "pallas_ring",
            "matches": res.matches, "numpy_matches": ref_count,
            "sum_products": res.sum_products, "numpy_sum": ref_sum,
            "sum_rel_err": rel_err, "sum_rtol": J_SUM_RTOL,
            "shuffle_s": res.shuffle_s, "join_s": res.join_s,
            "shuffle_gbps": (res.rows_a + res.rows_b)
            * 4 * (KEY_WORDS + VAL_WORDS) / res.shuffle_s / 1e9,
            "run_hash_join_wall_s": wall, "numpy_ref_s": ref_s,
            "dataset_join_s": ds_join_s,
            "dataset_join_rows": int(np.asarray(totals).sum()),
            "joined_row_bytes": 4 * (KEY_WORDS + 2 * VAL_WORDS),
            "dataset_join_rows_equal_numpy": rows_equal,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
    report(line)
    if res.matches != ref_count:
        fail("leg J: the match count disagrees with numpy")
    if rel_err > J_SUM_RTOL:
        fail(f"leg J: the sum of products is off by {rel_err:.3g} "
             f"(> {J_SUM_RTOL})")
    if not rows_equal or int(np.asarray(totals).sum()) != ref_count:
        fail("leg J: Dataset.join's rows disagree with numpy")
    m.stop()
    return line


def k_rows(total: int, seed: int) -> np.ndarray:
    """Leg K's 100-byte records: key ``(0, id)`` with ids Zipf(1.1) folded
    into 2^22, word 2 in [0, 4), words 3..24 a fixed function of (id,
    word 2), so rows sharing both are duplicates (``distinct`` has work)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((total, KEY_WORDS + VAL_WORDS), np.uint32)
    rows[:, 1] = rng.zipf(1.1, size=total) % K_KEY_IDS
    rows[:, 2] = rng.integers(0, 4, size=total)
    rows[:, 3:] = k_derived(rows[:, 1], rows[:, 2])
    return rows


def k_derived(ids: np.ndarray, w2: np.ndarray) -> np.ndarray:
    h = ids.astype(np.uint64) * np.uint64(0x9E3779B1) \
        + w2.astype(np.uint64) * np.uint64(0x85EBCA6B)
    j = np.arange(3, KEY_WORDS + VAL_WORDS, dtype=np.uint64)
    mixed = (h[:, None] + j[None] * np.uint64(0xC2B2AE35)) \
        * np.uint64(0x27D4EB2F)
    return ((mixed >> np.uint64(17)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def group_expect(ids: np.ndarray):
    """Unique ids, ascending, with their counts and their partitions."""
    uniq, counts = np.unique(ids, return_counts=True)
    return uniq, counts, hash_pids(np.zeros_like(uniq), uniq, PARTS)


def check_groups(g, ids: np.ndarray) -> bool:
    """A ``GroupedData`` at leg K's layout against numpy: each partition's
    table is its keys ascending with their counts, offsets the exclusive
    prefix sums, and its values buffer key-sorted."""
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.kernels.sort import as_unsigned

    uniq, counts, pid = group_expect(ids)
    grp = records_from_torch(g.groups)
    cap = grp.shape[1] // PARTS
    for d in range(PARTS):
        n = int(g.group_totals[d])
        t = grp[:, d * cap:d * cap + n]
        want_c = counts[pid == d]
        if n != len(want_c) or int(g.totals[d]) != int(want_c.sum()) \
                or t[0].any() or not np.array_equal(t[1], uniq[pid == d]) \
                or not np.array_equal(t[2], want_c) \
                or not np.array_equal(t[3], np.cumsum(want_c) - want_c):
            return False
        vals = g.values[1, d * cap:d * cap + int(g.totals[d])]
        if bool((as_unsigned(vals[1:]) < as_unsigned(vals[:-1])).any()):
            return False
    return True


def check_cogroup(c, ids_a: np.ndarray, ids_b: np.ndarray) -> bool:
    """A ``CoGroupedData`` against numpy: the union of keys per
    partition, ascending, each with its count on either side."""
    from sparkrdma_tpu_torch.interop import records_from_torch

    ua, ca = np.unique(ids_a, return_counts=True)
    ub, cb = np.unique(ids_b, return_counts=True)
    union = np.union1d(ua, ub)
    want_a = np.zeros(len(union), np.int64)
    want_b = np.zeros(len(union), np.int64)
    want_a[np.searchsorted(union, ua)] = ca
    want_b[np.searchsorted(union, ub)] = cb
    pid = hash_pids(np.zeros_like(union), union, PARTS)
    ct = records_from_torch(c.cotable)
    cap = ct.shape[1] // PARTS
    for d in range(PARTS):
        sel = pid == d
        t = ct[:, d * cap:d * cap + int(c.union_totals[d])]
        if t.shape[1] != int(sel.sum()) or t[0].any() \
                or not np.array_equal(t[1], union[sel]) \
                or not np.array_equal(t[2], want_a[sel]) \
                or not np.array_equal(t[4], want_b[sel]):
            return False
    return True


def sums_expect(rows: np.ndarray):
    """Unique ids and every payload word summed per id mod 2^32."""
    order = np.argsort(rows[:, 1], kind="stable")
    ids = rows[order, 1]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    sums = np.add.reduceat(rows[order, 2:].astype(np.uint64), starts, axis=0)
    return ids[starts], (sums & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def by_key(rows: np.ndarray, words: int = 1) -> np.ndarray:
    """Rows ordered by (word 1, ..., word ``words``): leg K's outputs are
    unique in those words, and word 0 is zero."""
    code = rows[:, 1].astype(np.uint64)
    if words == 2:
        code = code << np.uint64(2) | rows[:, 2]
    return rows[np.argsort(code, kind="stable")]


def leg_k() -> dict:
    """The Dataset verbs on 16,777,216 × 100-byte records at the default
    geometry, keys Zipf(1.1) folded into 2^22 ids: each verb timed (card
    idle before and after) and held against numpy on the host, the sort
    checked on the card; then a profile of one ``sort_by_key``."""
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.workloads.terasort import (_sums,
                                                        device_verify_sort)

    rows = k_rows(K_RECORDS, seed=7)
    rows_b = k_rows(K_RECORDS // 4, seed=8)
    m = terasort_manager("cuda")
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    ds = Dataset.from_host_rows(m, rows)
    db = Dataset.from_host_rows(m, rows_b)
    secs, checks = {}, {}

    srt, secs["sort_by_key"] = timed(ds.sort_by_key)
    checks["sort_by_key"] = device_verify_sort(
        m, ds.records, srt.records, srt.totals, KEY_WORDS,
        srt.records.shape[1] // PARTS)
    del srt
    red, secs["reduce_by_key"] = timed(lambda: ds.reduce_by_key("sum"))
    wire_reduce = dict(m._exchange.wire_stats())
    uniq, sums = sums_expect(rows)
    got = by_key(red.to_host_rows())
    checks["reduce_by_key"] = bool(
        np.array_equal(got[:, 1], uniq) and not got[:, 0].any()
        and np.array_equal(got[:, 2:], sums))
    del red
    dst, secs["distinct"] = timed(ds.distinct)
    pairs = np.unique(rows[:, 1].astype(np.uint64) << np.uint64(2)
                      | rows[:, 2])
    want = np.zeros((len(pairs), KEY_WORDS + VAL_WORDS), np.uint32)
    want[:, 1] = (pairs >> np.uint64(2)).astype(np.uint32)
    want[:, 2] = (pairs & np.uint64(3)).astype(np.uint32)
    want[:, 3:] = k_derived(want[:, 1], want[:, 2])
    checks["distinct"] = bool(np.array_equal(
        by_key(dst.to_host_rows(), words=2), want))
    del dst, want
    cbk, secs["count_by_key"] = timed(ds.count_by_key)
    got = by_key(cbk.to_host_rows())
    ids_u, ids_c = np.unique(rows[:, 1], return_counts=True)
    checks["count_by_key"] = bool(
        np.array_equal(got[:, 1], ids_u) and np.array_equal(got[:, 2], ids_c)
        and not got[:, 3:].any())
    del cbk
    grp, secs["group_by_key"] = timed(ds.group_by_key)
    mesh_cap = grp.values.shape[1] // PARTS
    keep = ((torch.arange(PARTS * mesh_cap, device="cuda") % mesh_cap)
            < torch.from_numpy(np.repeat(grp.totals, mesh_cap)).cuda())
    checks["group_by_key"] = bool(
        check_groups(grp, rows[:, 1])
        and _sums(grp.values, keep.to(torch.int64))
        == _sums(ds.records, None))
    del grp, keep
    cog, secs["cogroup"] = timed(lambda: ds.cogroup(db))
    checks["cogroup"] = check_cogroup(cog, rows[:, 1], rows_b[:, 1])
    del cog

    def zero_w2(r):
        return r[2] == 0

    n_kept = int((rows[:, 2] == 0).sum())
    flt, secs["filter_repartition"] = timed(
        lambda: ds.filter(zero_w2, cache_key=("w2", 0)).repartition())
    wire_filter = dict(m._exchange.wire_stats())
    dropped = int(wire_filter.get("pushdown_rows_dropped", -1))
    row_bytes = 4 * (KEY_WORDS + VAL_WORDS)
    live = ((torch.arange(flt.records.shape[1], device="cuda")
             % (flt.records.shape[1] // PARTS))
            < flt.totals.to(torch.int64).repeat_interleave(
                flt.records.shape[1] // PARTS))
    checks["filter_repartition"] = bool(
        dropped == K_RECORDS - n_kept and flt.count == n_kept
        and (K_RECORDS - dropped) * row_bytes < K_RECORDS * row_bytes
        and _sums(flt.records, live.to(torch.int64))
        == _sums(ds.records[:, ds.records[2] == 0], None))
    del flt, live
    count, secs["count"] = timed(lambda: ds.count)
    checks["count"] = count == K_RECORDS
    launches = {k: v.launches for k, v in kernels.items()}
    line = {"leg": "K", "workload": "Dataset verbs", "records": K_RECORDS,
            "record_bytes": row_bytes, "cogroup_records_b": len(rows_b),
            "keys": f"Zipf(1.1) folded into {K_KEY_IDS} ids, "
                    "default_rng(7)",
            "partitions": PARTS, "transport": "pallas_ring",
            "verb_s": secs,
            "gbps": {k: K_RECORDS * row_bytes / s / 1e9
                     for k, s in secs.items() if k != "count"},
            "unique_keys": len(ids_u), "distinct_rows": len(pairs),
            "wire_reduce_by_key": wire_reduce,
            "wire_filter": wire_filter,
            "filter_wire_bytes": (K_RECORDS - dropped) * row_bytes,
            "unfiltered_wire_bytes": K_RECORDS * row_bytes,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "checks": checks,
            "check": "host (numpy) per verb; sort_by_key on the device",
            "launches": launches}
    report(line)
    if not all(checks.values()):
        fail("leg K: " + ", ".join(k for k, v in checks.items() if not v))
    line["profile"] = profile("leg K sort_by_key", ds.sort_by_key,
                              "profiles/torch_legK.txt")
    m.stop()
    return line


def k_small_verbs(device: str, **kw) -> dict:
    """Every ported verb on 2^20 records of leg K's mix (and a join on
    leg J's kind of rows), as host arrays."""
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.interop import records_from_torch

    def host(x):
        return records_from_torch(x) if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    m = terasort_manager(device, **kw)
    ds = Dataset.from_host_rows(m, k_rows(K_SMALL, seed=9))
    db = Dataset.from_host_rows(m, k_rows(K_SMALL // 4, seed=10))
    ja, jb = join_tables(K_SMALL // PARTS, K_SMALL, seed=11)
    out = {}
    for name, fn in (("sort_by_key", ds.sort_by_key),
                     ("reduce_by_key", ds.reduce_by_key),
                     ("distinct", ds.distinct),
                     ("count_by_key", ds.count_by_key),
                     ("filter_repartition", lambda: ds.filter(
                         lambda r: r[2] == 0, ("w2", 0)).repartition())):
        r = fn()
        out[name] = (host(r.records), host(r.totals.cpu()))
    g = ds.group_by_key()
    out["group_by_key"] = tuple(host(x) for x in (
        g.values, g.groups, g.group_totals, g.totals))
    c = ds.cogroup(db)
    out["cogroup"] = tuple(host(x) for x in (
        c.values_a, c.values_b, c.cotable, c.union_totals))
    joined, totals = Dataset.from_host_rows(m, ja).join(
        Dataset.from_host_rows(m, jb))
    out["join"] = (host(joined), host(totals))
    # the count exactly; the float32 sum of products is summed in another
    # order on the card, so it is reported, not compared
    out["join_count"], sum_products = Dataset.from_host_rows(
        m, ja).join_count(Dataset.from_host_rows(m, jb))
    out["_join_sum"] = sum_products
    out["count"] = ds.filter(lambda r: r[2] == 1).count
    m.stop()
    return out


def leg_k_small() -> dict:
    """Leg K's verbs on 2^20 records on the card and on the CPU, bit for
    bit, with ``fast_sort`` (the merge-path kernel in the sort), on the
    card in two variants: the fused ring, and ``ring_fused=False`` (the
    per-round all-to-all kernel). The transport changes no bit, so both
    are held against one CPU run."""
    kernels = zeroed_counters()
    variants = {"fast_sort": dict(fast_sort=True),
                "ring_fused_false": dict(fast_sort=True, ring_fused=False)}
    got = {(v, "cuda"): k_small_verbs("cuda", **kw)
           for v, kw in variants.items()}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    cpu = k_small_verbs("cpu", fast_sort=True)
    for v in variants:
        got[v, "cpu"] = cpu

    def equal(a, b):
        if isinstance(a, tuple):
            return all(equal(x, y) for x, y in zip(a, b))
        return bool(np.array_equal(a, b)) if isinstance(a, np.ndarray) \
            else a == b

    same = {v: {name: equal(got[v, "cuda"][name], got[v, "cpu"][name])
                for name in got[v, "cuda"] if not name.startswith("_")}
            for v in variants}
    line = {"leg": "K-small", "records": K_SMALL, "partitions": PARTS,
            "card_equals_cpu": same,
            "join_count": got["fast_sort", "cuda"]["join_count"],
            "join_sum_card_cpu": [got["fast_sort", d]["_join_sum"]
                                  for d in ("cuda", "cpu")],
            "launches": launches}
    report(line)
    if not all(ok for per in same.values() for ok in per.values()):
        fail("leg K-small: the card and the CPU disagree")
    return line


def movielens_like(users: int, items: int, ratings: int, seed: int
                   ) -> np.ndarray:
    """``[N, 3]`` (user, item, rating) at MovieLens-20M's dimensions, made
    from ``default_rng``: users uniform and sorted (the file is ordered by
    user), items uniform, ratings on the 0.5-5.0 half-star scale."""
    rng = np.random.default_rng(seed)
    out = np.empty((ratings, 3), np.float64)
    out[:, 0] = np.sort(rng.integers(0, users, size=ratings))
    out[:, 1] = rng.integers(0, items, size=ratings)
    out[:, 2] = rng.integers(1, 11, size=ratings) / 2.0
    return out


def wire_reduction(ws: dict):
    if "combine_out_bytes" not in ws:
        return None
    return ws["combine_in_bytes"] / ws["combine_out_bytes"]


def leg_l() -> dict:
    """``BASELINE.md`` config 4: ALS at MovieLens-20M's dimensions (138,493
    users, 26,744 items, 20,000,263 ratings; generated, the file is not in
    the repository), rank 8, 5 iterations, checked against ``_numpy_als``
    at the reference's rtol 2e-3, atol 2e-4."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.workloads.als import run_als

    t0 = time.perf_counter()
    ratings = movielens_like(L_USERS, L_ITEMS, L_RATINGS, seed=20)
    gen_s = time.perf_counter() - t0
    rt = MeshRuntime(ShuffleConf(transport="pallas_ring",
                                 slot_records=SLOT_B),
                     num_partitions=PARTS, device="cuda")
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: run_als(rt, ratings, L_USERS, L_ITEMS,
                                      rank=L_RANK, iterations=L_ITERS))
    launches = {k: v.launches for k, v in kernels.items()}
    line = {"leg": "L", "workload": "run_als (BASELINE.md config 4)",
            "dataset": "MovieLens-20M dimensions, default_rng(20): users "
                       "uniform and sorted, items uniform, half-star "
                       "ratings",
            "users": res.num_users, "items": res.num_items,
            "ratings": res.num_ratings, "rank": res.rank,
            "record_words": 2 + L_RANK + L_RANK * (L_RANK + 1) // 2,
            "iterations": res.iterations, "partitions": PARTS,
            "transport": "pallas_ring", "slot_records": SLOT_B,
            "per_iter_s": res.per_iter_s, "total_s": res.total_s,
            "ratings_per_s": res.num_ratings * 2 / res.per_iter_s,
            "rmse": res.rmse, "wall_s": wall, "gen_s": gen_s,
            "wire_users": res.wire.get("users"),
            "wire_items": res.wire.get("items"),
            "wire_reduction_users": wire_reduction(res.wire["users"]),
            "wire_reduction_items": wire_reduction(res.wire["items"]),
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "verified": res.verified,
            "check": "_numpy_als, rtol 2e-3 atol 2e-4",
            "launches": launches}
    report(line)
    if not res.verified:
        fail("leg L: ALS disagrees with _numpy_als")
    rt.stop()
    return line


def leg_l_small() -> dict:
    """Both ALS half-steps at MovieLens-20M's dimensions over 16, on the
    card and on the CPU from the same factors: records and exchange
    outputs bit for bit; the solved factors to a tolerance (the two
    ``torch.linalg.solve`` backends differ)."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.workloads.als import _ALS, _owner_layout

    users, items = L_USERS // 16, L_ITEMS // 16
    ratings = movielens_like(users, items, L_RATINGS // 16, seed=21)
    k = L_RANK
    kernels = zeroed_counters()
    got = {}
    factors = None
    for device in ("cpu", "cuda"):
        rt = MeshRuntime(ShuffleConf(transport="pallas_ring",
                                     slot_records=SLOT_B),
                         num_partitions=PARTS, device=device)
        als = _ALS(rt, ratings, users, items, k, 0.1)
        if factors is None:
            v0 = np.random.default_rng(0).standard_normal(
                (als.iper * PARTS, k)).astype(np.float32) * 0.1
            factors = {"users": torch.from_numpy(
                _owner_layout(v0, PARTS)).reshape(PARTS, als.iper, k)}
        res = {}
        for step, hs in (("users", als.users), ("items", als.items)):
            rec = als.build(factors[step].to(rt.device), hs)
            out, totals = als.exchange(rec, hs)
            solved = als.update(out, totals, hs)
            res[step] = (rec.cpu(), out.cpu(), totals.cpu(), solved.cpu(),
                         dict(als.ex.wire_stats()))
            if step == "users" and "items" not in factors:
                factors["items"] = solved.cpu()     # the CPU's U, for both
        got[device] = res
        rt.stop()
    torch.cuda.synchronize()
    launches = {k_: v.launches for k_, v in kernels.items()}
    same = {step: bool(all(torch.equal(got["cuda"][step][i],
                                       got["cpu"][step][i])
                           for i in range(3))
                       and got["cuda"][step][4] == got["cpu"][step][4])
            for step in ("users", "items")}
    solve_diff = {step: float((got["cuda"][step][3]
                               - got["cpu"][step][3]).abs().max())
                  for step in ("users", "items")}
    line = {"leg": "L-small", "users": users, "items": items,
            "ratings": len(ratings), "rank": k, "partitions": PARTS,
            "records_and_exchange_card_equals_cpu": same,
            "solved_max_abs_diff": solve_diff,
            "launches": launches}
    report(line)
    if not all(same.values()):
        fail("leg L-small: a half-step's exchange differs card against CPU")
    return line


# --- legs M-P: the planner's TPC-DS queries and the serde round trip ----


def planner_manager(val_words: int, device: str = "cuda", **kw):
    """The planner legs' geometry: the reference's default slots
    (4096 records, two rounds in flight, ``queue_depth`` 8; the ring
    kernel) and ``bench.py``'s ``"fine"`` classes. ``bench.py``'s
    ``run_planner`` also sizes a slot for every record of a partition,
    but stacked on one card a hash-co-located exchange (the star suite's
    reduce after its repartition) then needs a [D, D] send buffer of
    whole partitions (28.5 GiB at leg O), and 2^21-record slots stream
    it in 6.4 GB chunks, eight in flight; ``"pow2"`` classes pad leg O's
    36 M-record partitions to 2^26."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    return ShuffleManager(MeshRuntime(default_conf(val_words=val_words,
                                                   geometry_classes="fine",
                                                   **kw),
                                      num_partitions=PARTS, device=device))


def plan_counters(m) -> dict:
    return {k: int(v) for k, v in sorted(m.metrics.snapshot().items())
            if k.startswith("plan.")}


def profile_once(label: str, fn, path: str) -> dict:
    """Device busy time of one ``fn()`` under torch.profiler, against its
    wall time under the profiler: the idle share of the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs("profiles", exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    line = {"profile": label, "wall_ms_profiled": wall * 1e3,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
            "top": [[k[:60], us / 1e3, c] for us, k, c in rows[:8]]}
    report(line)
    return line


def leg_m() -> dict:
    """q64 through the planner at TPC-DS SF100's counts: 287,997,024
    ``store_sales`` rows (16 B, 4.6 GB), 204,000 items, 400 stores (402
    cut to a multiple of 8); every ``plan_*`` knob on (the store side
    broadcasts, the item side takes the shuffle join). The tables of
    ``run_q64_shape`` load into ``Dataset``s and its plan runs through
    ``PlanExecutor.run`` (launches, counters, peak memory, the numpy
    check), then again with a fresh executor (the query alone, timed)
    and once more under the profiler."""
    from sparkrdma_tpu_torch.plan import PlanExecutor
    from sparkrdma_tpu_torch.workloads import tpcds

    m = planner_manager(2)
    fact, item, store = tpcds._q64_tables(PARTS, M_FACT_PER_PART, M_ITEMS,
                                          M_STORES, 16, 8, 0)
    want = tpcds._q64_expect(fact, item, store, M_ITEMS, M_STORES, 3)
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    q, load_s = timed(lambda: tpcds._q64_plan(m, fact, item, store, 3))
    query_s, checks = [], []
    for _ in range(2):
        out, s = timed(lambda: PlanExecutor(m).run(q))
        if not query_s:
            launches = {k: v.launches for k, v in kernels.items()}
            counters = plan_counters(m)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = out.to_host_rows()
        groups = tpcds._grouped(rows[:, 1], rows[:, 3])
        checks.append(groups == want)
        query_s.append(s)
        del out
    prof = profile_once("leg M q64 query", lambda: PlanExecutor(m).run(q),
                        "profiles/torch_legM.txt")
    line = {"leg": "M", "workload": "q64 (run_q64_shape's tables and "
                                    "plan; BASELINE.md config 3)",
            "fact_rows": fact.shape[0], "record_bytes": 16,
            "fact_gb": fact.nbytes / 1e9, "n_items": M_ITEMS,
            "n_stores": M_STORES, "partitions": PARTS,
            "transport": "pallas_ring", "groups": len(groups),
            "total_value": sum(groups.values()), "load_s": load_s,
            "query_s": query_s,
            "fact_gbps": [fact.nbytes / s / 1e9 for s in query_s],
            "plan_counters": counters, "max_memory_gb": peak_gb,
            "idle_share": prof["idle_share"], "verified": checks,
            "check": "host: numpy grouped sums per category",
            "launches": launches}
    report(line)
    if not all(checks):
        fail("leg M: q64 disagrees with numpy")
    if counters.get("plan.broadcast_joins") != 1:
        fail(f"leg M: expected the store join alone to broadcast: "
             f"{counters}")
    m.stop()
    return line


def leg_n() -> dict:
    """q95 at TPC-DS SF100's counts: 72,001,232 ``web_sales`` rows and
    7,197,664 ``web_returns`` rows (each cut to a multiple of 8), 15
    warehouses, 6,000,000 orders (the port's choice: ~12 lines an
    order); checked against numpy, then once more under the profiler."""
    from sparkrdma_tpu_torch.workloads import tpcds

    m = planner_manager(2)
    kw = dict(sales_rows_per_device=N_SALES // PARTS,
              return_rows_per_device=N_RETURNS // PARTS,
              n_orders=N_ORDERS, n_warehouses=N_WAREHOUSES)
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: tpcds.run_q95_shape(m, **kw))
    launches = {k: v.launches for k, v in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_once("leg N q95", lambda: tpcds.run_q95_shape(
        m, verify=False, **kw), "profiles/torch_legN.txt")
    nbytes = (N_SALES + N_RETURNS) * 16
    line = {"leg": "N", "workload": "run_q95_shape (BASELINE.md config 3)",
            "sales_rows": N_SALES, "return_rows": N_RETURNS,
            "n_orders": N_ORDERS, "n_warehouses": N_WAREHOUSES,
            "partitions": PARTS, "transport": "pallas_ring",
            "qualifying": res.qualifying, "net_sum": res.net_sum,
            "exchange_s": res.shuffle_s, "wall_s": wall,
            "gbps": nbytes / res.shuffle_s / 1e9,
            "wall_gbps": nbytes / wall / 1e9,
            "max_memory_gb": peak_gb, "idle_share": prof["idle_share"],
            "verified": res.verified,
            "check": "host: numpy count exact, float32 net at rtol 1e-6",
            "launches": launches}
    report(line)
    if not res.verified:
        fail("leg N: q95 disagrees with numpy")
    m.stop()
    return line


def leg_o() -> dict:
    """The star suite at scale 64 (dims of 4,096, 2,048 and 1,024 rows,
    287,996,928 fact rows of 24 B, 6.9 GB) with every ``plan_*`` knob on,
    both queries checked against numpy; ``queries_per_hour`` as
    ``bench.py``'s ``run_planner`` computes it."""
    from sparkrdma_tpu_torch.plan import PlanExecutor
    from sparkrdma_tpu_torch.workloads import tpcds

    m = planner_manager(4)
    ex = PlanExecutor(m)
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, elapsed = timed(lambda: tpcds.run_star_suite(
        m, fact_rows_per_device=O_PER_DEVICE, scale=O_SCALE, executor=ex))
    launches = {k: v.launches for k, v in kernels.items()}
    counters = plan_counters(m)
    line = {"leg": "O", "workload": "run_star_suite (bench.py run_planner)",
            "scale": O_SCALE, "fact_rows_per_device": O_PER_DEVICE,
            "fact_rows": res.fact_rows, "record_bytes": 24,
            "fact_gb": res.fact_rows * 24 / 1e9, "partitions": PARTS,
            "rev": [res.rev_groups, res.rev_total],
            "all": [res.all_groups, res.all_total],
            "suite_s": res.suite_s, "elapsed_s": elapsed,
            "queries_per_hour": 2 / elapsed * 3600.0,
            "plan_counters": counters,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pool": m.runtime.pool.stats(),
            "verified": res.verified,
            "check": "host: numpy grouped sums of both queries",
            "launches": launches}
    report(line)
    if not res.verified:
        fail("leg O: the star suite disagrees with numpy")
    zero = [k for k in ("plan.reuse_hits", "plan.broadcast_joins",
                        "plan.overlapped_stages", "plan.pushdown_sunk")
            if counters.get(k, 0) <= 0]
    if zero:
        fail(f"leg O: rewrite counters at 0: {zero}")
    ex.close()
    m.stop()
    return line


def p_v1_data(rng, n: int):
    """Leg P's v1 input: keys (random word, a permutation) and 0-92 B
    payloads."""
    keys = np.stack([rng.integers(0, 2**32, size=n, dtype=np.uint32),
                     rng.permutation(n).astype(np.uint32)], axis=1)
    lens = rng.integers(0, P_MAXB + 1, size=n)
    ends = np.cumsum(lens)
    blob = rng.bytes(int(ends[-1]))
    return keys, [blob[e - ln:e]
                  for e, ln in zip(ends.tolist(), lens.tolist())]


def p_schema():
    from sparkrdma_tpu_torch.api.serde import RowSchema

    return RowSchema([("u", "uint32"), ("i", "int64"), ("f", "float64"),
                      ("b", ("bytes", P_BYTES))])


def p_cols_data(rng, n: int):
    """Leg P's columnar input under :func:`p_schema`."""
    keys = np.stack([rng.integers(0, 2**32, size=n, dtype=np.uint32),
                     rng.permutation(n).astype(np.uint32)], axis=1)
    lens = rng.integers(0, P_BYTES + 1, size=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    cols = {"u": rng.integers(0, 2**32, size=n, dtype=np.uint32),
            "i": rng.integers(-2**62, 2**62, size=n),
            "f": rng.standard_normal(n),
            "b": (offsets, rng.integers(0, 256, size=int(offsets[-1]),
                                        dtype=np.uint8))}
    return keys, cols


def leg_p() -> dict:
    """The serde round trip. v1: 4,194,304 records with 0-92 B payloads
    (W = 2 + 24) through ``from_host_payloads`` (overlap on and off),
    ``sort_by_key`` (fast sort: the merge-path kernel) and
    ``to_host_payloads``, against a numpy sort of the inputs. Columnar:
    16,777,216 rows of a uint32/int64/float64/bytes(68) schema (W = 25,
    100 B) through ``from_host_columns``, ``select`` of two columns,
    ``repartition`` and ``to_host_columns``, re-encoded and held against
    the inputs with the dropped columns zeroed. MB/s are encoded bytes
    over host seconds."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.api.serde import (codec_totals,
                                               encode_bytes_rows,
                                               encode_cols)
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rng = np.random.default_rng(31)
    keys, pays = p_v1_data(rng, P_V1)
    m = ShuffleManager(MeshRuntime(default_conf(val_words=24, fast_sort=True),
                                   num_partitions=PARTS, device="cuda"))
    kernels = zeroed_counters()
    secs = {}

    def codec(key, fn):
        """``fn()`` timed, with the host codec's own seconds in it."""
        before = codec_totals()
        res, secs[key] = timed(fn)
        after = codec_totals()
        secs[key + "_codec"] = sum(after[k_] - before[k_] for k_ in (
            "serde_encode_s", "serde_decode_s"))
        return res

    # the first load pays for the page-locked leases: it is timed apart
    codec("load_first", lambda: Dataset.from_host_payloads(
        m, keys, pays, P_MAXB))
    ds = codec("load_overlap", lambda: Dataset.from_host_payloads(
        m, keys, pays, P_MAXB))
    d2 = codec("load_no_overlap", lambda: Dataset.from_host_payloads(
        m, keys, pays, P_MAXB, overlap=False))
    rows = encode_bytes_rows(keys, pays, P_MAXB)
    checks = {"load_equals_single_shot": bool(
        torch.equal(ds.records, m.runtime.shard_records(rows))
        and torch.equal(ds.records, d2.records))}
    del d2
    srt, secs["sort_by_key"] = timed(ds.sort_by_key)
    k, p = codec("decode", srt.to_host_payloads)
    launches = {k_: v.launches for k_, v in kernels.items()}
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    checks["v1_round_trip"] = bool(np.array_equal(k, keys[order])) and \
        p == [pays[i] for i in order.tolist()]
    v1_mb = rows.nbytes / 1e6
    del ds, srt, k, p, pays, rows
    m.stop()
    torch.cuda.empty_cache()

    schema = p_schema()
    keys, cols = p_cols_data(rng, P_COLS)
    m = terasort_manager("cuda")
    ds = codec("cols_load_overlap", lambda: Dataset.from_host_columns(
        m, keys, cols, schema))
    d2 = codec("cols_load_no_overlap", lambda: Dataset.from_host_columns(
        m, keys, cols, schema, overlap=False))
    rows = encode_cols(keys, cols, schema)
    checks["cols_load_equals_single_shot"] = bool(
        torch.equal(ds.records, m.runtime.shard_records(rows))
        and torch.equal(ds.records, d2.records))
    del d2
    sel, secs["select_repartition"] = timed(
        lambda: ds.select("i", "b").repartition())
    k, c = codec("cols_decode", sel.to_host_columns)
    launches_cols = {k_: v.launches for k_, v in kernels.items()}
    idx = np.argsort(keys[:, 1])[k[:, 1]]
    want = rows[idx]
    for name in ("u", "f"):
        off, width = schema.column_word_span(name)
        want[:, 2 + off:2 + off + width] = 0
    checks["cols_round_trip"] = bool(
        np.array_equal(encode_cols(k, c, schema), want)
        and not c["u"].any() and not np.ascontiguousarray(
            c["f"]).view(np.uint64).any())
    cols_mb = rows.nbytes / 1e6
    line = {"leg": "P", "workload": "serde round trip",
            "v1_records": P_V1, "v1_max_payload_bytes": P_MAXB,
            "v1_record_bytes": 4 * 26, "cols_records": P_COLS,
            "cols_record_bytes": 4 * (2 + schema.payload_words),
            "schema": [list(f) if isinstance(f[1], str) else
                       [f[0], list(f[1])] for f in schema.fields],
            "partitions": PARTS, "transport": "pallas_ring",
            "seconds": secs,
            "mbps": {k_: (cols_mb if k_.startswith("cols") else v1_mb) / v
                     for k_, v in secs.items()
                     if k_ != "select_repartition" and k_ != "sort_by_key"},
            "checks": checks, "launches": launches_cols,
            "launches_v1": launches}
    report(line)
    if not all(checks.values()):
        fail("leg P: " + ", ".join(k_ for k_, v in checks.items() if not v))
    m.stop()
    return line


def tpcds_small(device: str, knobs: dict) -> dict:
    """q64, q95 and the star suite at the reference tests' sizes, with
    the star plans' output records: host values only."""
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.plan import PlanExecutor
    from sparkrdma_tpu_torch.workloads import tpcds

    def res(r):
        d = dataclasses.asdict(r)
        for k in ("shuffle_s", "suite_s"):
            d.pop(k, None)
        return d

    out = {}
    m = planner_manager(2, device=device, **knobs)
    out["q64"] = res(tpcds.run_q64_shape(m))
    out["q95"] = res(tpcds.run_q95_shape(m))
    m.stop()
    m = planner_manager(4, device=device, **knobs)
    out["star"] = res(tpcds.run_star_suite(m, fact_rows_per_device=16))
    fact, *dims = tpcds._star_tables(PARTS, 16, 1, 0)
    ex = PlanExecutor(m)
    for name, q in zip(("star_rev", "star_all"),
                       tpcds._star_plans(m, fact, dims, 1, 0)):
        d = ex.run(q)
        out[name] = (records_from_torch(d.records).tolist(),
                     d.totals.tolist())
    out["counters"] = plan_counters(m)
    m.stop()
    return out


def leg_m_small() -> dict:
    """q64, q95 and the star suite at the reference tests' sizes on the
    card and on the CPU, every ``plan_*`` knob on and all off: each
    result, and the star plans' output records, the same on both
    devices, and on equal to off (the naive replay)."""
    knobs = {"on": {}, "off": dict(plan_pushdown=False, plan_reuse=False,
                                   plan_broadcast_join=False,
                                   plan_overlap=False)}
    kernels = zeroed_counters()
    got = {(arm, "cuda"): tpcds_small("cuda", kw)
           for arm, kw in knobs.items()}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    for arm, kw in knobs.items():
        got[arm, "cpu"] = tpcds_small("cpu", kw)
    same = {arm: {k: got[arm, "cuda"][k] == got[arm, "cpu"][k]
                  for k in got[arm, "cuda"]} for arm in knobs}
    on_off = {k: got["on", "cuda"][k] == got["off", "cuda"][k]
              for k in ("q64", "q95", "star")}
    verified = {f"{arm}_{q}": got[arm, "cuda"][q]["verified"]
                for arm in knobs for q in ("q64", "q95", "star")}
    line = {"leg": "M-small", "partitions": PARTS,
            "card_equals_cpu": same, "on_equals_off": on_off,
            "verified": verified,
            "star": {k: v for k, v in got["on", "cuda"]["star"].items()},
            "counters_on": got["on", "cuda"]["counters"],
            "launches": launches}
    report(line)
    if not (all(v for per in same.values() for v in per.values())
            and all(on_off.values()) and all(verified.values())):
        fail("leg M-small: card against CPU, or on against off, disagree")
    return line


# --- legs Q and Q-small: durability, the retry loop, the fault plane ----


class RetryLog(logging.Handler):
    """The reader's "fetch failed ... retrying" warnings, as logged.
    ``probe``, when set, is called at each one (after the failed
    attempt, before the next) and its values kept in ``probes``."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []
        self.probe = None
        self.probes = []

    def emit(self, record):
        msg = record.getMessage()
        if "fetch failed" in msg and "retrying" in msg:
            self.messages.append(msg)
            if self.probe is not None:
                self.probes.append(self.probe())


RETRIES = RetryLog()


def no_unseen_retries(legs: str) -> dict:
    """No ``faults.*`` or ``recover.*`` counter moved and no retry was
    logged while ``legs`` ran: a real failure there would otherwise be
    absorbed by the retry loop and the leg would still pass."""
    from sparkrdma_tpu_torch.obs.metrics import global_registry

    moved = {k: v for k, v in global_registry().snapshot().items()
             if k.startswith(("faults.", "recover.")) and v}
    line = {"phase": "no_unseen_retries", "legs": legs,
            "fault_and_recovery_counters": moved,
            "retry_warnings": list(RETRIES.messages)}
    report(line)
    if moved or RETRIES.messages:
        fail(f"legs {legs} retried or recovered unseen: {line}")
    return line


def stream_fault(chunks: int, first: int, seeds) -> tuple:
    """``(seed, k, rate)``: an ``exchange.stream_round`` rate rule that,
    in a plane of ``seed``, fires exactly once over the stream hits of a
    read under ``exchange.dispatch:fail@attempt<1`` (attempt 1 fails at
    dispatch; attempt 2 streams chunks 0..k and fails at chunk ``k >=
    first``; attempt 3 streams all ``chunks``: hits 0..k+chunks). Found
    from the plane's own draws and checked with ``FaultRule.matches``."""
    from sparkrdma_tpu_torch import faults

    site = "exchange.stream_round"
    salt = zlib.crc32(site.encode())
    for seed in seeds:
        for k in range(first, chunks):
            draws = [faults._mix64(seed ^ salt ^ h) / float(1 << 64)
                     for h in range(k + chunks + 1)]
            low, second = sorted(draws)[:2]
            if draws[k] != low or second == low:
                continue
            rate = (low + second) / 2
            rule = faults.parse_fault_spec(f"{site}:fail@{rate!r}")[0]
            hits = [h for h in range(k + chunks + 1)
                    if rule.matches(h, seed)]
            if hits == [k]:
                return seed, k, rate
    fail(f"no stream_round rate fires once at a chunk >= {first} of "
         f"{chunks}")


def schedule(rate: float) -> str:
    """Step 3's schedule: attempt 1 fails at dispatch, one chunk of the
    stream fails in attempt 2."""
    return (f"exchange.dispatch:fail@attempt<1;"
            f"exchange.stream_round:fail@{rate!r}")


def fired_chunks(messages) -> list:
    return [int(m.group(1)) for m in
            (re.search(r"exchange\.stream_round, chunk (\d+)", msg)
             for msg in messages) if m]


def leg_q() -> dict:
    """Durability at full width: TeraSort on leg F's 16,777,216 × 100-byte
    records at the default geometry with ``fast_sort`` (the merge stage)
    and ``spill_to_host``. ``stop()`` checkpoints; a control read,
    verified on the card; a read under step 3's schedule (a dispatch
    failure, then a stream failure past ``queue_depth`` chunks);
    a read after the map output is lost from the card (recovered from the
    checkpoint); and a restarted manager's read of the resumed shuffle:
    each bit-identical to the control."""
    from sparkrdma_tpu_torch import faults
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import (device_verify_sort,
                                                        random_records)

    kernels = zeroed_counters()
    w = KEY_WORDS + VAL_WORDS
    checks, times = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_q_") as tmp:
        kw = dict(fast_sort=True, geometry_classes="pow2",
                  spill_to_host=True, spill_dir=tmp)
        m = terasort_manager("cuda", **kw)
        recs = random_records(RECORDS, w, Q_SEED, "cuda")
        spl = compute_splitters(make_sampler(PARTS, KEY_WORDS, 256, Q_SEED)(
            recs), PARTS)
        part = range_partitioner(spl, KEY_WORDS)
        h = m.register_shuffle(Q_SID, PARTS, part)
        real_ckpt = m.checkpoint_shuffle

        def timed_ckpt(*a, **k):
            _, times["checkpoint_s"] = timed(lambda: real_ckpt(*a, **k))

        m.checkpoint_shuffle = timed_ckpt
        # 1. stop() plans, publishes and checkpoints
        plan, times["stop_s"] = timed(
            lambda: m.get_writer(h).write(recs).stop())
        rec_bytes = recs.numel() * 4
        file_bytes = os.path.getsize(
            os.path.join(tmp, f"shuffle_{Q_SID}", "records.u32"))
        checks["checkpoint_is_records_plus_trailer"] = \
            file_bytes == rec_bytes + 8
        # 2. the control read (streaming: a fresh output the leg owns)
        reader = m.get_reader(h, key_ordering=True)
        (control, control_totals), times["control_read_s"] = timed(
            reader.read)
        checks["control_device_verified"] = device_verify_sort(
            m, recs, control, control_totals, KEY_WORDS, plan.out_capacity)
        chunks = -(-plan.num_rounds // m.conf.max_rounds_in_flight)
        checks["streamed"] = m._exchange.last_dispatches > 1
        # 3. the schedule, in a plane whose stream rule fires once, past
        # queue_depth chunks
        seed, k, rate = stream_fault(chunks, m.conf.queue_depth,
                                     range(0xFA17, 0xFA17 + 4096))
        plane = faults.FaultPlane(schedule(rate), seed=seed)
        pool = m.runtime.pool
        before = pool.stats()["outstanding"]
        n0 = len(RETRIES.messages)
        RETRIES.probes = []
        RETRIES.probe = lambda: pool.stats()["outstanding"]
        prev = faults.set_active_plane(plane)
        try:
            (out, totals), times["fault_read_s"] = timed(reader.read)
        finally:
            faults.set_active_plane(prev)
            RETRIES.probe = None
        retries = RETRIES.messages[n0:]
        fired = fired_chunks(retries)
        checks["fault_read_bit_identical"] = bool(
            torch.equal(out, control) and torch.equal(totals, control_totals))
        checks["two_retries_logged"] = len(retries) == 2
        checks["stream_fault_past_queue_depth"] = \
            fired == [k] and k >= m.conf.queue_depth
        checks["injected_as_scheduled"] = plane.injected_counts() == {
            "exchange.dispatch": {"fail": 1},
            "exchange.stream_round": {"fail": 1}}
        outstanding = {"before": before, "after_each_failed_attempt":
                       list(RETRIES.probes),
                       "after": pool.stats()["outstanding"]}
        checks["pool_outstanding_restored"] = all(
            v == before for v in RETRIES.probes) and \
            outstanding["after"] == before and len(RETRIES.probes) == 2
        del out, totals
        # 4. the map output lost from the card: the read resumes it
        real_resume = m.resume_shuffle

        def timed_resume(handle):
            wr, times["resume_s"] = timed(lambda: real_resume(handle))
            return wr

        m.resume_shuffle = timed_resume
        m._writers.clear()
        (out, totals), times["recovered_read_s"] = timed(reader.read)
        checks["recovered_read_bit_identical"] = bool(
            "resume_s" in times and torch.equal(out, control)
            and torch.equal(totals, control_totals))
        del out, totals, reader
        # 5. the process dies without unregistering; a fresh manager on
        # the same spill_dir resumes and reads
        m.stop()
        del m
        m2 = terasort_manager("cuda", **kw)
        h2 = m2.register_shuffle(Q_SID, PARTS, part)
        _, times["restart_resume_s"] = timed(lambda: m2.resume_shuffle(h2))
        (out, totals), times["restart_read_s"] = timed(
            m2.get_reader(h2, key_ordering=True).read)
        checks["restarted_read_bit_identical"] = bool(
            torch.equal(out, control) and torch.equal(totals, control_totals))
        del out, totals
        m2.unregister_shuffle(Q_SID)
        checks["unregister_deletes_checkpoint"] = not os.path.exists(
            os.path.join(tmp, f"shuffle_{Q_SID}"))
        m2.stop()
    torch.cuda.synchronize()
    launches = {k_: v.launches for k_, v in kernels.items()}
    line = {"leg": "Q", "records": RECORDS, "record_bytes": w * 4,
            "partitions": PARTS, "conf": "defaults + fast_sort, pow2, "
            "spill_to_host (tempfile spill_dir)",
            "rounds": plan.num_rounds, "chunks": chunks,
            "capacity": plan.capacity, "split_factor": plan.split_factor,
            "out_capacity": plan.out_capacity,
            "checkpoint_bytes": file_bytes, "records_bytes": rec_bytes,
            "checkpoint_gbps": rec_bytes / times["checkpoint_s"] / 1e9,
            **times, "plane_seed": seed, "stream_fault_rate": rate,
            "stream_fault_chunk": fired, "queue_depth": 8,
            "retries": retries, "pool_outstanding": outstanding,
            "checks": checks, "launches": launches}
    report(line)
    if not all(checks.values()):
        fail("leg Q: " + ", ".join(k_ for k_, v in checks.items() if not v))
    return line


def launch_failure_child() -> int:
    """Leg Q-small's child process: real launches of the ring kernel
    fail inside reads, here and not in the smoke's own CUDA context
    (an illegal address is sticky). First a launch the kernel's entry
    refuses (a grid that does not cover the chunks:
    ``KernelLaunchError``), then a good read (the context is intact),
    then a launch that writes through an address the card has not
    mapped (``torch.AcceleratorError`` at the next sync, and at every
    CUDA call after it). Prints one JSON line and exits."""
    from sparkrdma_tpu_torch._build import KernelLaunchError
    from sparkrdma_tpu_torch.exchange import ring
    from sparkrdma_tpu_torch.exchange.errors import FetchFailedError
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    m = terasort_manager("cuda")
    h = m.register_shuffle(1, PARTS, hash_partitioner(PARTS, 2))
    m.get_writer(h).write(random_records(1 << 16, KEY_WORDS + VAL_WORDS, 3,
                                         "cuda")).stop()
    good, good_totals = m.get_reader(h).read()
    good = good.clone()
    res = {"child": "launch_failure", "torch": torch.__version__,
           "max_retry_attempts": m.conf.max_retry_attempts}

    def failing_read(name):
        n0 = len(RETRIES.messages)
        try:
            m.get_reader(h).read()
            res[name] = {"raised": None}
            return
        except Exception as e:              # noqa: BLE001 — reported
            chain, c = [], e
            while c is not None:
                chain.append(type(c).__name__)
                c = c.__cause__
            res[name] = {
                "raised": type(e).__name__,
                "attempt": getattr(e, "attempt", None),
                "cause_chain": chain,
                "retries": len(RETRIES.messages) - n0,
                "fetch_failed": isinstance(e, FetchFailedError),
                "device_error_in_chain": any(
                    n in ("AcceleratorError", KernelLaunchError.__name__)
                    for n in chain[1:]),
                "message": str(e)[:300]}

    real_plan = ring.launch_plan
    ring.launch_plan = lambda d, r, c: real_plan(d, r, c)._replace(
        grid=real_plan(d, r, c).grid + 1)
    try:
        failing_read("refused_launch")
    finally:
        ring.launch_plan = real_plan
    out, totals = m.get_reader(h).read()
    res["read_after_refused_launch_equal"] = bool(
        torch.equal(out, good) and torch.equal(totals, good_totals))
    real_kernel, calls = ring._kernel, [0]

    def bad_address(send, recv, *rest):
        calls[0] += 1
        return real_kernel(send, 0x10000 if calls[0] == 1 else recv, *rest)

    ring._kernel = bad_address
    failing_read("illegal_address")
    print(json.dumps(res), flush=True)
    os._exit(0)


def leg_q_small() -> dict:
    """2^20 records at leg F-small's geometry with ``fast_sort``: step
    3's schedule on the card and on the CPU (and with
    ``ring_fused=False``), each equal to the read without faults;
    checkpoints across devices; the failure paths (a persistent fault,
    the deadline, the backoff schedule, a corrupt checkpoint); each
    storage and pool site; the books; and a real failed launch in a
    child process."""
    from sparkrdma_tpu_torch import faults
    from sparkrdma_tpu_torch.api import shuffle_manager as sm_mod
    from sparkrdma_tpu_torch.exchange.errors import (
        FetchFailedError, UnrecoverableShuffleError)
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    def qs_manager(device, **kw):
        """F-small's geometry with ``fast_sort``: the merge stage sorts."""
        return terasort_manager(device, fast_sort=True, **kw)

    faults.reset_accounting()
    kernels = zeroed_counters()
    w = KEY_WORDS + VAL_WORDS
    recs = random_records(Q_SMALL, w, 9, "cuda")
    part = hash_partitioner(PARTS, 2)
    checks, books, info = {}, {}, {}

    def write(m, sid, x=None):
        if x is None:
            x = recs if m.runtime.device.type == "cuda" else recs.cpu()
        h = m.register_shuffle(sid, PARTS, part)
        plan = m.get_writer(h).write(x).stop()
        return h, plan

    def read(m, h):
        out, totals = m.get_reader(h, key_ordering=True).read()
        return valid_rows(out, totals).cpu(), totals.cpu()

    def same(a, b):
        return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))

    def case(name, fn):
        """Run ``fn() -> (ok, injected, terminal)`` and keep its books:
        hard injections, logged retries, recoveries and terminal errors
        raised by an injected fault."""
        r0, c0 = len(RETRIES.messages), faults.recovery_total()
        ok, injected, terminal = fn()
        books[name] = {"injected": injected,
                       "retries": len(RETRIES.messages) - r0,
                       "recoveries": faults.recovery_total() - c0,
                       "terminal": terminal}
        checks[name] = bool(ok)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_q_small_") as tmp:
        # the schedule, card and CPU, two variants
        control = {}
        for variant, vkw in (("default", {}),
                             ("ring_fused=False", dict(ring_fused=False))):
            got = {}
            for device in ("cuda", "cpu"):
                m = qs_manager(device, **vkw)
                h, plan = write(m, 1)
                control[variant, device] = read(m, h)
                m.stop()
                chunks = -(-plan.num_rounds // m.conf.max_rounds_in_flight)
                seed, k, rate = stream_fault(chunks, 0, [0xFA17])
                info[variant] = {"chunks": chunks, "stream_fault_rate": rate,
                                 "stream_fault_chunk": k}

                def faulted():
                    n0 = len(RETRIES.messages)
                    mf = qs_manager(device, fault_spec=schedule(rate),
                                          **vkw)
                    hf, _ = write(mf, 1)
                    before = mf.runtime.pool.stats()["outstanding"]
                    got[device] = read(mf, hf)
                    restored = \
                        mf.runtime.pool.stats()["outstanding"] == before
                    injected = mf.faults.injected_total()
                    mf.stop()
                    fired = fired_chunks(RETRIES.messages[n0:])
                    return (same(got[device], control[variant, device])
                            and restored and fired == [k]), injected, 0

                case(f"schedule {variant} {device}", faulted)
            checks[f"schedule {variant} card_equals_cpu"] = \
                same(got["cuda"], got["cpu"]) and same(
                    control[variant, "cuda"], control[variant, "cpu"])
        want = control["default", "cuda"]
        checks["ring_fused=False equals default"] = same(
            control["ring_fused=False", "cuda"], want)

        # checkpoints across devices
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            root = os.path.join(tmp, f"{src}-to-{dst}")
            m = qs_manager(src, spill_to_host=True, spill_dir=root)
            h, _ = write(m, 2)
            first = read(m, h)
            m.stop()
            m = qs_manager(dst, spill_dir=root)
            h = m.register_shuffle(2, PARTS, part)
            m.resume_shuffle(h)
            checks[f"checkpoint {src} resumed on {dst}"] = \
                same(read(m, h), first) and same(first, want)
            m.unregister_shuffle(2)
            m.stop()

        # a persistent fault: attempt == max_retry_attempts
        def persistent():
            m = qs_manager("cuda", fault_spec="exchange.dispatch:fail")
            h, _ = write(m, 3)
            try:
                read(m, h)
                ok = False
            except FetchFailedError as e:
                info["persistent"] = {"attempt": e.attempt,
                                      "message": str(e)}
                ok = e.attempt == m.conf.max_retry_attempts == 3
            injected = m.faults.injected_total()
            m.stop()
            return ok, injected, 1

        case("persistent fault raises at max_retry_attempts", persistent)

        def deadline():
            m = qs_manager("cuda", fault_spec="exchange.dispatch:fail",
                                 max_retry_attempts=100,
                                 retry_backoff_ms=20.0, retry_deadline_s=0.05)
            h, _ = write(m, 4)
            t0 = time.perf_counter()
            try:
                read(m, h)
                ok = False
            except FetchFailedError as e:
                info["deadline"] = {"attempt": e.attempt,
                                    "seconds": time.perf_counter() - t0,
                                    "message": str(e)}
                ok = "retry deadline" in str(e) and 1 < e.attempt < 100
            injected = m.faults.injected_total()
            m.stop()
            return ok, injected, 1

        case("retry_deadline_s raises before max_retry_attempts", deadline)

        def backoff():
            slept = []
            real_time = sm_mod.time

            class Clock:
                monotonic = staticmethod(real_time.monotonic)

                @staticmethod
                def sleep(s):
                    slept.append(s)
                    real_time.sleep(s)

            m = qs_manager("cuda", retry_backoff_ms=5.0,
                                 max_retry_attempts=4,
                                 fault_spec="exchange.dispatch:fail@attempt<3")
            h, _ = write(m, 5)
            sm_mod.time = Clock
            try:
                got = read(m, h)
            finally:
                sm_mod.time = real_time
            schedule_ms = [faults.backoff_ms(a, 5.0) for a in (1, 2, 3)]
            info["backoff_ms"] = {"slept": [v * 1e3 for v in slept],
                                  "schedule": schedule_ms}
            injected = m.faults.injected_total()
            m.stop()
            return (same(got, want)
                    and slept == [v / 1e3 for v in schedule_ms]
                    and all(0.5 * 5.0 * 2 ** a <= v < 5.0 * 2 ** a
                            for a, v in enumerate(schedule_ms))), injected, 0

        case("retry_backoff_ms sleeps the schedule", backoff)

        def corrupt():
            root = os.path.join(tmp, "corrupt")
            m = qs_manager("cuda", spill_to_host=True, spill_dir=root)
            h, _ = write(m, 6)
            blob = os.path.join(root, "shuffle_6", "records.u32")
            with open(blob, "r+b") as f:
                f.seek(16)
                b = f.read(1)
                f.seek(16)
                f.write(bytes([b[0] ^ 0xFF]))
            m._writers.clear()
            calls = []
            real = m._exchange.exchange
            m._exchange.exchange = lambda *a, **k_: (calls.append(1),
                                                     real(*a, **k_))[1]
            n0 = len(RETRIES.messages)
            try:
                read(m, h)
                ok = False
            except UnrecoverableShuffleError as e:
                info["corrupt_checkpoint"] = str(e)[:200]
                ok = not calls and len(RETRIES.messages) == n0
            m.stop()
            return ok, 0, 0

        case("corrupt checkpoint raises UnrecoverableShuffleError at once",
             corrupt)

        def storage(spec, book, sid):
            def run():
                c0 = faults.recovery_counts().get(book, 0)
                m = qs_manager("cuda", spill_to_host=True,
                                     spill_dir=os.path.join(tmp, book),
                                     fault_spec=spec)
                h, _ = write(m, sid)
                m._writers.clear()     # the read resumes the checkpoint
                got = read(m, h)
                injected = m.faults.injected_total()
                m.stop()
                return (same(got, want) and faults.recovery_counts().get(
                    book, 0) - c0 == 1), injected, 0
            return run

        case("spill.write:fail@attempt<1 -> spill_rewrite",
             storage("spill.write:fail@attempt<1", "spill_rewrite", 7))
        case("checkpoint.read:fail@attempt<1 -> checkpoint_reread",
             storage("checkpoint.read:fail@attempt<1", "checkpoint_reread",
                     8))

        def pool_site(spec, sid):
            def run():
                m = qs_manager("cuda", fault_spec=spec)
                h, _ = write(m, sid)
                got = read(m, h)
                counts = m.faults.injected_counts()
                injected = m.faults.injected_total()
                m.stop()
                return same(got, want) and bool(counts), injected, 0
            return run

        case("pool.acquire:fail@attempt<1",
             pool_site("pool.acquire:fail@attempt<1", 9))
        case("pool.acquire:delay=1ms@attempt<2",
             pool_site("pool.acquire:delay=1ms@attempt<2", 10))

        # spill.read on an H-small-sized tiered run
        cols = np.random.default_rng(15).integers(
            0, 2**32, size=(w, H_CHUNKS * H_SMALL_CHUNK), dtype=np.uint32)
        m = ooc_manager(os.path.join(tmp, "tier-control"), H_SMALL_CHUNK)
        clean = run_tiered_terasort(m, cols, H_SMALL_CHUNK)
        m.stop()

        def tiered():
            c0 = faults.recovery_counts().get("spill_reread", 0)
            m = ooc_manager(os.path.join(tmp, "tier-fault"), H_SMALL_CHUNK,
                            fault_spec="spill.read:corrupt@attempt<1")
            res = run_tiered_terasort(m, cols, H_SMALL_CHUNK)
            injected = m.faults.injected_total()
            m.stop()
            rereads = faults.recovery_counts().get("spill_reread", 0) - c0
            info["tiered_store_stats"] = res.store_stats
            return (rereads == 1 and np.array_equal(res.rows, clean.rows)
                    and same_runs(res.runs, clean.runs)), injected, 0

        case("spill.read:corrupt@attempt<1 -> spill_reread", tiered)
    torch.cuda.synchronize()
    launches = {k_: v.launches for k_, v in kernels.items()}

    # the books: every hard injection is a retry or a recovery, or (a
    # persistent fault) the one terminal error after the last retry
    recovering = {n: b for n, b in books.items() if not b["terminal"]}
    checks["books: injected == retries + recoveries"] = sum(
        b["injected"] for b in recovering.values()) == sum(
        b["retries"] + b["recoveries"] for b in recovering.values()) > 0
    checks["books: each case balances"] = all(
        b["injected"] == b["retries"] + b["recoveries"] + b["terminal"]
        for b in books.values())

    # a real failed launch, in a child process
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--launch-failure-child"], capture_output=True,
                          text=True, timeout=300)
    child = None
    for ln in proc.stdout.splitlines():
        if ln.startswith('{"child"'):
            child = json.loads(ln)
    if child is None:
        fail(f"leg Q-small: the launch-failure child printed no result "
             f"(rc {proc.returncode}): {proc.stderr[-3000:]}")
    for name in ("refused_launch", "illegal_address"):
        r = child[name]
        checks[f"child {name}: FetchFailedError after max attempts"] = bool(
            r["fetch_failed"] and r["attempt"] == child["max_retry_attempts"]
            and r["device_error_in_chain"])
    checks["child read after a refused launch equal"] = \
        child["read_after_refused_launch_equal"]
    line = {"leg": "Q-small", "records": Q_SMALL, "partitions": PARTS,
            "variants": info, "books": books, "child": child,
            "child_rc": proc.returncode, "checks": checks,
            "launches": launches}
    report(line)
    if not all(checks.values()):
        fail("leg Q-small: " + ", ".join(k_ for k_, v in checks.items()
                                         if not v))
    return line


# --- native staging: the C++ host library against the numpy path -------


def native_build_line(build_s: float) -> dict:
    """The host staging library's build: seconds, compiler, cores."""
    from sparkrdma_tpu_torch import _build

    cxx = os.environ.get("CXX") or "g++"
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    line = {"phase": "native_staging", "part": "build",
            "build_s": _build.native_build_seconds.get("", build_s),
            "built_here": "" in _build.native_build_seconds,
            "library": os.path.relpath(_build.native_lib_path()),
            "compiler": version, "cpu_count": os.cpu_count()}
    report(line)
    return line


#: the three codecs of the native_staging phase: native with the default
#: threads, native on one thread, numpy
CODEC_VARIANTS = (("native", {"native": True}),
                  ("native_1_thread", {"native": True, "threads": 1}),
                  ("numpy", {"native": False}))


def native_codec_line() -> dict:
    """The four codec calls alone at leg P's own data (4,194,304 v1
    records, 16,777,216 columnar rows): each on the three codecs, bytes
    equal across them, MB/s of encoded bytes over host seconds."""
    from sparkrdma_tpu_torch.api.serde import (decode_bytes_rows,
                                               decode_cols,
                                               encode_bytes_rows,
                                               encode_cols)

    rng = np.random.default_rng(31)
    keys, pays = p_v1_data(rng, P_V1)
    secs, mb, checks = {}, {}, {}
    rows = {}
    for tag, kw in CODEC_VARIANTS:
        rows[tag], secs["encode_bytes_rows", tag] = timed(
            lambda: encode_bytes_rows(keys, pays, P_MAXB, **kw))
    checks["encode_bytes_rows_equal"] = all(
        np.array_equal(rows[t], rows["numpy"]) for t in rows)
    want = rows["numpy"]
    mb["encode_bytes_rows"] = mb["decode_bytes_rows"] = want.nbytes / 1e6
    del rows
    for tag, kw in CODEC_VARIANTS:
        (k, p), secs["decode_bytes_rows", tag] = timed(
            lambda: decode_bytes_rows(want, 2, **kw))
        checks[f"decode_bytes_rows_{tag}_equal"] = bool(
            np.array_equal(k, keys)) and p == pays
        del k, p
    del keys, pays, want
    schema = p_schema()
    keys, cols = p_cols_data(rng, P_COLS)
    rows = {}
    for tag, kw in CODEC_VARIANTS:
        rows[tag], secs["encode_cols", tag] = timed(
            lambda: encode_cols(keys, cols, schema, **kw))
    checks["encode_cols_equal"] = all(
        np.array_equal(rows[t], rows["numpy"]) for t in rows)
    want = rows["numpy"]
    mb["encode_cols"] = mb["decode_cols"] = want.nbytes / 1e6
    del rows
    offsets, heap = cols["b"]
    for tag, kw in CODEC_VARIANTS:
        (k, c), secs["decode_cols", tag] = timed(
            lambda: decode_cols(want, 2, schema, **kw))
        b = c["b"]
        checks[f"decode_cols_{tag}_equal"] = bool(
            np.array_equal(k, keys) and np.array_equal(c["u"], cols["u"])
            and np.array_equal(c["i"], cols["i"])
            and np.array_equal(np.ascontiguousarray(c["f"]).view(np.uint64),
                               cols["f"].view(np.uint64))
            and np.array_equal(b.offsets, offsets)
            and np.array_equal(b.heap, heap))
        del k, c, b
    line = {"phase": "native_staging", "part": "codec",
            "v1_records": P_V1, "cols_records": P_COLS,
            "threads_auto": min(8, os.cpu_count() or 1),
            "seconds": {f"{op}/{tag}": v for (op, tag), v in secs.items()},
            "mbps": {f"{op}/{tag}": mb[op] / v
                     for (op, tag), v in secs.items()},
            "checks": checks}
    report(line)
    return line


def native_spill_line() -> dict:
    """Leg Q's records (16,777,216 × 100 B, 1.68 GB) through a
    ``SpillWriter`` on each path into two files (byte-identical), and
    each file read back by ``read_array`` on both paths."""
    from sparkrdma_tpu_torch.hbm.host_staging import SpillWriter, read_array
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    w = KEY_WORDS + VAL_WORDS
    recs = random_records(RECORDS, w, Q_SEED, "cuda").cpu().numpy().view(
        np.uint32)
    secs, checks = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ns_") as tmp:
        paths = {}
        for tag, native in (("native", True), ("numpy", False)):
            paths[tag] = os.path.join(tmp, f"{tag}.u32")
            sw = SpillWriter(depth=4, use_native=native)

            def spill():
                sw.submit(paths[tag], recs)
                return sw.drain()

            errors, secs["write", tag] = timed(spill)
            sw.close()
            checks[f"write_{tag}_no_errors"] = errors == 0
        a, b = (np.fromfile(paths[t], np.uint8) for t in ("native",
                                                           "numpy"))
        checks["files_byte_identical"] = bool(np.array_equal(a, b))
        file_bytes = int(a.size)
        del a, b
        for tag in ("native", "numpy"):
            for reader, native in (("native", True), ("numpy", False)):
                got, secs["read", f"{tag}_file/{reader}"] = timed(
                    lambda: read_array(paths[tag], np.uint32, recs.shape,
                                       use_native=native))
                checks[f"read_{tag}_file_{reader}_equal"] = bool(
                    np.array_equal(got, recs))
                del got
    line = {"phase": "native_staging", "part": "spill",
            "records_bytes": int(recs.nbytes), "file_bytes": file_bytes,
            "seconds": {f"{op}/{tag}": v for (op, tag), v in secs.items()},
            "gbps": {f"{op}/{tag}": recs.nbytes / v / 1e9
                     for (op, tag), v in secs.items()},
            "checks": checks}
    report(line)
    return line


def native_pinned_line(leg_p_line) -> dict:
    """A lease of the pinned staging pool is page-locked, and a copy
    from it to the card returns before the bytes have landed; leg P's
    loads with and without overlap beside it."""
    from sparkrdma_tpu_torch.api.pipeline import staging_pool

    pool = staging_pool(True)
    nbytes = 1 << 28
    lease = pool.get(nbytes)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    src = lease.tensor[:nbytes]
    src.fill_(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.copy_(src, non_blocking=True)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    landed = bool((dev[::4096] == 7).all())
    checks = {"lease_is_pinned": bool(lease.tensor.is_pinned()),
              "pool_is_native": pool.stats()["native"] == 1,
              "copy_returns_before_landing": enqueue_s < 0.5 * total_s,
              "copy_landed": landed}
    lease.release()
    del dev, src
    secs = leg_p_line["seconds"] if leg_p_line else {}
    line = {"phase": "native_staging", "part": "pinned",
            "lease_bytes": nbytes, "copy_enqueue_ms": enqueue_s * 1e3,
            "copy_total_ms": total_s * 1e3,
            "copy_gbps": nbytes / total_s / 1e9,
            "pool": pool.stats(),
            "leg_p_load_overlap_s": secs.get("load_overlap"),
            "leg_p_load_no_overlap_s": secs.get("load_no_overlap"),
            "leg_p_cols_load_overlap_s": secs.get("cols_load_overlap"),
            "leg_p_cols_load_no_overlap_s": secs.get("cols_load_no_overlap"),
            "checks": checks}
    report(line)
    return line


#: the reference's numpy path: both knobs off
STAGING_OFF = dict(use_native_staging=False, serde_native=False)


def _dir_bytes(root: str) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def on_off_h_small(tmp: str) -> dict:
    """H-small's dataset through the tiered TeraSort (checkpointed) and
    the streaming spill mode, knobs on and off."""
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        run_streaming_terasort, run_tiered_terasort)

    w, chunk = KEY_WORDS + VAL_WORDS, H_SMALL_CHUNK
    cols = np.random.default_rng(15).integers(
        0, 2**32, size=(w, H_CHUNKS * chunk), dtype=np.uint32)
    got = {}
    for tag, kw in (("on", {}), ("off", STAGING_OFF)):
        root = os.path.join(tmp, "h_" + tag)
        m = ooc_manager(root, chunk, **kw)
        res = run_tiered_terasort(m, cols, chunk, checkpoint=True,
                                  shuffle_id_base=800)
        runs = os.path.join(root, "runs")
        os.makedirs(runs)
        spilled = run_streaming_terasort(
            m, ArrayChunkSource(cols, chunk), spill_dir=runs, verify=True,
            shuffle_id_base=900)
        got[tag] = (res.rows, res.runs, spilled.verified,
                    _dir_bytes(os.path.join(root, "spill")),
                    _dir_bytes(runs), res.store_stats)
        m.stop()
    on, off = got["on"], got["off"]
    return {"h_small_rows_equal": bool(np.array_equal(on[0], off[0]))
            and same_runs(on[1], off[1]),
            "h_small_spill_runs_verified": on[2] is True and off[2] is True,
            "h_small_checkpoint_files_identical": bool(on[3])
            and on[3] == off[3],
            "h_small_spill_files_identical": bool(on[4]) and on[4] == off[4],
            "h_small_spilled_to_disk": on[5][0] > 0 and off[5][0] > 0}


def on_off_q_small(tmp: str) -> dict:
    """Q-small's records: ``stop()``'s checkpoint, a read, and a read
    resumed from the checkpoint, knobs on and off."""
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    w = KEY_WORDS + VAL_WORDS
    got = {}
    for tag, kw in (("on", {}), ("off", STAGING_OFF)):
        root = os.path.join(tmp, "q_" + tag)
        m = terasort_manager("cuda", fast_sort=True,
                             geometry_classes="pow2", spill_to_host=True,
                             spill_dir=root, **kw)
        recs = random_records(Q_SMALL, w, Q_SEED, "cuda")
        spl = compute_splitters(make_sampler(PARTS, KEY_WORDS, 256, Q_SEED)(
            recs), PARTS)
        h = m.register_shuffle(Q_SID, PARTS, range_partitioner(spl,
                                                               KEY_WORDS))
        m.get_writer(h).write(recs).stop()
        reader = m.get_reader(h, key_ordering=True)
        out, totals = reader.read()
        out, totals = out.clone(), totals.clone()
        m._writers.clear()
        out2, totals2 = reader.read()
        got[tag] = (out, totals, bool(torch.equal(out2, out)
                                      and torch.equal(totals2, totals)),
                    _dir_bytes(root))
        del out2, totals2, reader
        m.stop()
    on, off = got["on"], got["off"]
    return {"q_small_reads_equal": bool(torch.equal(on[0], off[0])
                                        and torch.equal(on[1], off[1])),
            "q_small_resumed_reads_equal": on[2] and off[2],
            "q_small_checkpoints_identical": bool(on[3])
            and on[3] == off[3]}


def p_small_round_trip(kw: dict, n: int = NS_SMALL, planes=None):
    """Leg P's round trips at ``n`` records on the card: v1 load, sort,
    unload; columnar load, unload. Returns what each gave; each
    manager's fault plane is appended to ``planes``."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rng = np.random.default_rng(37)
    keys, pays = p_v1_data(rng, n)
    m = ShuffleManager(MeshRuntime(default_conf(
        val_words=24, fast_sort=True, serde_chunk_records=n // 4, **kw),
        num_partitions=PARTS, device="cuda"))
    if planes is not None:
        planes.append(m.faults)
    ds = Dataset.from_host_payloads(m, keys, pays, P_MAXB)
    v1_records = ds.records.clone()
    k, p = ds.sort_by_key().to_host_payloads()
    m.stop()
    schema = p_schema()
    ckeys, cols = p_cols_data(rng, n)
    m = terasort_manager("cuda", serde_chunk_records=n // 4, **kw)
    if planes is not None:
        planes.append(m.faults)
    cds = Dataset.from_host_columns(m, ckeys, cols, schema)
    cols_records = cds.records.clone()
    ck, cc = cds.to_host_columns()
    cc = {name: (np.array(v) if name != "b" else
                 (v.offsets.copy(), v.heap.copy())) for name, v in cc.items()}
    m.stop()
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    ok = bool(np.array_equal(k, keys[order])) and \
        list(p) == [pays[i] for i in order.tolist()]
    return (v1_records, k, list(p), cols_records, ck, cc), ok


def same_outputs(a, b) -> bool:
    """Tensors, arrays, lists, and tuples or dicts of them, equal."""
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return bool(np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_outputs(a[k], b[k])
                                            for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_outputs(x, y)
                                        for x, y in zip(a, b))
    return a == b


def on_off_p_small() -> dict:
    on, on_ok = p_small_round_trip({})
    off, off_ok = p_small_round_trip(STAGING_OFF)
    return {"p_small_round_trips_correct": on_ok and off_ok,
            "p_small_on_equals_off": same_outputs(on, off)}


def native_on_off_line() -> dict:
    """On the card, ``use_native_staging`` and ``serde_native`` on (the
    defaults) against both off: outputs, spill files and checkpoints at
    H-small's, Q-small's and a 2^16-record P-shaped size."""
    checks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_onoff_") as tmp:
        checks.update(on_off_h_small(tmp))
        checks.update(on_off_q_small(tmp))
    checks.update(on_off_p_small())
    line = {"phase": "native_staging", "part": "on_off",
            "h_small_records": H_CHUNKS * H_SMALL_CHUNK,
            "q_small_records": Q_SMALL, "p_small_records": NS_SMALL,
            "off": STAGING_OFF, "checks": checks}
    report(line)
    return line


def native_fault_line() -> dict:
    """One ``serde.encode`` and one ``serde.decode`` failure injected on
    the native codec (``fault_spec``) in each manager of a 2^16-record
    P-shaped round trip on the card: the rows equal a run without
    faults, and the books balance (hard injections = recoveries, each
    the ``serde_native`` one)."""
    from sparkrdma_tpu_torch import faults

    spec = "serde.encode:fail@attempt<1;serde.decode:fail@attempt<1"
    want, _ = p_small_round_trip({})
    planes = []
    faults.reset_accounting()
    got, ok = p_small_round_trip({"fault_spec": spec}, planes=planes)
    books = {"injected": [p.injected_counts() for p in planes],
             "recoveries": faults.recovery_counts()}
    faults.reset_accounting()
    injected = sum(p.injected_total() for p in planes)
    checks = {
        "rows_equal_without_faults": ok and same_outputs(got, want),
        "injected_once_each": len(planes) == 2 and all(
            i == {"serde.encode": {"fail": 1}, "serde.decode": {"fail": 1}}
            for i in books["injected"]),
        "books_balance": injected == sum(books["recoveries"].values())
        and books["recoveries"] == {"serde_native": injected}}
    line = {"phase": "native_staging", "part": "serde_fault",
            "spec": spec, "books": books, "checks": checks}
    report(line)
    return line


def native_staging_phase(build_s: float, legs: dict) -> list:
    """The ``native_staging`` lines: build, codec, spill, pinned leases,
    off against on, serde fault."""
    lines = [native_build_line(build_s), native_codec_line()]
    gc.collect()
    lines.append(native_spill_line())
    gc.collect()
    torch.cuda.empty_cache()
    lines += [native_pinned_line(legs.get("P")), native_on_off_line(),
              native_fault_line()]
    gc.collect()
    torch.cuda.empty_cache()
    bad = [f"{ln['part']}: {k}" for ln in lines
           for k, v in ln.get("checks", {}).items() if not v]
    if bad:
        fail("native_staging: " + ", ".join(bad))
    return lines


NEW_LEGS = (("M-small", leg_m_small), ("P", leg_p), ("N", leg_n),
            ("O", leg_o), ("M", leg_m))
DURABILITY_LEGS = (("Q", leg_q), ("Q-small", leg_q_small))


def main(argv=None) -> int:
    """``--legs M,P,Q`` runs only those of legs M-Q (M-small and Q-small
    included, and ``native_staging`` for that phase) and prints the ring
    shapes they launched, without the kernel phases or the table check:
    a quick run while a leg is brought up. ``--launch-failure-child`` is
    leg Q-small's child process."""
    args = sys.argv[1:] if argv is None else argv
    only = args[1].split(",") if args[:1] == ["--legs"] else None
    t_smoke = time.perf_counter()
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("sparkrdma_tpu_torch.api").addHandler(RETRIES)
    # legs M and O hold several 5-7 GB tables of different shapes: grow
    # segments instead of leaving freed blocks that fit no later one
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args[:1] == ["--launch-failure-child"]:
        return launch_failure_child()

    from concurrent.futures import ThreadPoolExecutor

    from sparkrdma_tpu_torch import _build

    # the host staging library's g++ beside the kernels' nvcc runs
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        native = ex.submit(_build.build_native)
        libs = _build.build_all()
        native.result()
    build_s = time.perf_counter() - t0
    report({"build_s": build_s,
            "libraries": sorted(libs) + ["libsparkstaging"]})

    if only is not None:
        ring_host_phase()
        legs, shapes = {}, {}
        for name, fn in NEW_LEGS:
            if name in only:
                run_leg(legs, shapes, name, fn)
        no_unseen_retries(", ".join(legs) or "none")
        for name, fn in DURABILITY_LEGS:
            if name in only:
                run_leg(legs, shapes, name, fn)
        if "native_staging" in only:
            native_staging_phase(build_s, legs)
        report({"smoke_s": time.perf_counter() - t_smoke})
        report({"recorded_ring_shapes": sorted(
            [leg_name, list(shape), a2a, n]
            for leg_name, counts in shapes.items()
            for (shape, a2a), n in counts.items())})
        return 0
    merge = merge_phase()
    ring_host_phase()
    ring = ring_phase()
    ring_w3 = ring_w3_phase()
    a2a = a2a_phase()
    edges = ring_edge_phase()
    combine_phase()
    torch.cuda.empty_cache()

    legs, shapes = {}, {}
    ring_chunk, ring_ooc = earlier_legs(legs, shapes)
    for name, fn in (("I", leg_i), ("J", leg_j), ("K", leg_k),
                     ("K-small", leg_k_small), ("L", leg_l),
                     ("L-small", leg_l_small)):
        run_leg(legs, shapes, name, fn)
    for name, fn in NEW_LEGS:
        run_leg(legs, shapes, name, fn)
    no_unseen_retries("A-P")
    for name, fn in DURABILITY_LEGS:
        run_leg(legs, shapes, name, fn)
    t0 = time.perf_counter()
    native_staging_phase(build_s, legs)
    report({"leg_s": "native_staging", "seconds": time.perf_counter() - t0})
    ring_legs = ring_leg_phases(shapes)
    for name in LEGS_I_TO_L:
        if legs[name]["launches"]["ring_exchange"] <= 0:
            fail(f"ring_exchange was not launched on leg {name}")
    for k in ("merge_stage", "ring_all_to_all"):
        if legs["K-small"]["launches"][k] <= 0:
            fail(f"{k} was not launched on leg K-small")
    for name in LEGS_M_TO_P:
        n = legs[name]["launches"]
        if n["ring_exchange"] + n["ring_all_to_all"] <= 0:
            fail(f"the ring kernel was not launched on leg {name}")
    if legs["P"]["launches"]["merge_stage"] <= 0:
        fail("merge_stage was not launched on leg P")
    for k, name in (("ring_exchange", "Q"), ("merge_stage", "Q"),
                    ("ring_exchange", "Q-small"), ("merge_stage", "Q-small"),
                    ("ring_all_to_all", "Q-small")):
        if legs[name]["launches"][k] <= 0:
            fail(f"{k} was not launched on leg {name}")

    def launches(k):
        return sum(legs[n]["launches"][k] for n in legs)

    def by_leg(k):
        return {n: legs[n]["launches"][k] for n in legs}

    def sub(phase, keys):
        return {k: phase[k] for k in keys}

    kernels = [
        {"name": "merge_stage", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/merge_path.cu",
         "replaces": "sparkrdma_tpu/kernels/merge_sort.py:309",
         "launches": launches("merge_stage"),
         "split_launches": launches("merge_splits"),
         "launches_by_leg": by_leg("merge_stage"),
         "max_abs_err": merge["max_abs_err"], "ms": merge["kernel_ms"],
         "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "ring_exchange", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "sparkrdma_tpu/exchange/ring.py:140",
         "launches": launches("ring_exchange"),
         "launches_by_leg": by_leg("ring_exchange"),
         "max_abs_err": max(p["max_abs_err"] for p in (
             ring, ring_w3, ring_chunk, ring_ooc, edges, *ring_legs)),
         "ms": ring["kernel_ms"],
         "plain_ms": ring["plain_ms"], "bound_ms": ring["bound_ms"],
         "bound_by": "bytes", "library_ms": ring["library_ms"],
         **sub(ring, RING_DEVICE_KEYS),
         "w3": sub(ring_w3, ("shape", "max_abs_err", "kernel_ms",
                             "plain_ms", "bound_ms", "library_ms",
                             *RING_DEVICE_KEYS)),
         "chunk": sub(ring_chunk, ("shape", "fine_shape", "max_abs_err",
                                   "kernel_ms", "plain_ms", "bound_ms",
                                   "library_ms", *RING_DEVICE_KEYS)),
         "ooc_chunk": sub(ring_ooc, ("shape", "max_abs_err", "kernel_ms",
                                     "plain_ms", "bound_ms",
                                     "library_ms", *RING_DEVICE_KEYS)),
         "edges": sub(edges, ("launches_checked", "max_abs_err")),
         "leg_shapes": [sub(p, ("shape", "a2a", "launches_by_leg",
                                "max_abs_err", "kernel_ms", "plain_ms",
                                "bound_ms", "library_ms",
                                *RING_DEVICE_KEYS)) for p in ring_legs]},
        {"name": "ring_all_to_all", "route": "cuda",
         "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
         "replaces": "sparkrdma_tpu/exchange/ring.py:87",
         "launches": launches("ring_all_to_all"),
         "launches_by_leg": by_leg("ring_all_to_all"),
         "max_abs_err": a2a["max_abs_err"], "ms": a2a["kernel_ms"],
         "plain_ms": a2a["plain_ms"], "bound_ms": a2a["bound_ms"],
         "bound_by": "bytes", "library_ms": a2a["library_ms"],
         **sub(a2a, RING_DEVICE_KEYS)},
    ]
    report({"smoke_s": time.perf_counter() - t_smoke})
    report({"kernels": kernels})
    report({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


def earlier_legs(legs: dict, shapes: dict):
    """Legs A-H, into ``legs``, and the ring shapes each launched, into
    ``shapes``; returns the ring kernel's phases at leg F's chunk shape
    and leg H's."""
    outs = {}
    for name, d, transport, fused in (("A", 1, "xla", True),
                                      ("B", 8, "pallas_ring", True),
                                      ("C", 8, "pallas_ring", False)):
        with RingShapes() as seen:
            legs[name], out, totals = leg(name, d, RECORDS, transport,
                                          fused, seed=0, full=True)
        shapes[name] = seen.counts
        if name in ("B", "C"):
            outs[name] = (out, totals)
        del out, totals
        torch.cuda.empty_cache()
        with RingShapes() as seen:
            leg(name + "-small", d, 1 << 20, transport, fused, seed=5,
                full=False)
        shapes[name + "-small"] = seen.counts
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
    profile_read("leg B read", default_conf(
        slot_records=SLOT_B, val_words=VAL_WORDS, fast_sort=True,
        fast_sort_run=RUN, pack_sort_min_payload=0,
        wide_sort_min_payload=0), "profiles/torch_legB.txt")
    torch.cuda.empty_cache()

    run_leg(legs, shapes, "D", leg_d)
    run_leg(legs, shapes, "D-small", leg_d_small)
    run_leg(legs, shapes, "E", leg_e)
    run_leg(legs, shapes, "F", lambda: leg_f(legs["B"]["gbps"]))
    profile_read("leg F read", default_conf(val_words=VAL_WORDS),
                 "profiles/torch_legF.txt")
    torch.cuda.empty_cache()
    ring_chunk = ring_chunk_phase(legs["F"])
    torch.cuda.empty_cache()
    run_leg(legs, shapes, "F-small", leg_f_small)
    run_leg(legs, shapes, "G", leg_g)
    run_leg(legs, shapes, "G-small", leg_g_small)
    run_leg(legs, shapes, "H", leg_h)
    ring_ooc = ring_ooc_phase()
    torch.cuda.empty_cache()
    run_leg(legs, shapes, "H-small", leg_h_small)
    for k, name in (("ring_exchange", "D"), ("ring_exchange", "E"),
                    ("ring_exchange", "D-small"),
                    ("ring_all_to_all", "D-small"),
                    ("merge_stage", "D-small"), ("ring_exchange", "F"),
                    ("ring_exchange", "G"), ("ring_exchange", "F-small"),
                    ("ring_all_to_all", "F-small"),
                    ("merge_stage", "F-small"),
                    ("ring_exchange", "G-small"), ("ring_exchange", "H"),
                    ("ring_exchange", "H-small"),
                    ("merge_stage", "H-small"),
                    ("ring_all_to_all", "H-small")):
        if legs[name]["launches"][k] <= 0:
            fail(f"{k} was not launched on leg {name}")
    return ring_chunk, ring_ooc


if __name__ == "__main__":
    sys.exit(main())
