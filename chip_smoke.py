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
   (leg D's ``torch.profiler`` table went in PR 12, to pay for leg S
   and the ``service`` phase: the ``obs`` phase's traces are the
   process's profiler sessions now);
4. the reference's default exchange geometry (``slot_records`` 4096,
   ``max_rounds_in_flight`` 2, ``queue_depth`` 8, the pack sort mode,
   the slot pool; only the transport and the record width set):
     F        TeraSort at 16,777,216 × 100-byte records through the
              streaming regime, device-verified, beside leg B's GB/s
              (its profile is taken in the ``obs`` phase); then the ring
              kernel at the chunk
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
              checked against numpy; then the ring kernel at the shape leg H's chunk plan gives
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
              ``Dataset.join`` on the same rows, held against a numpy
              join, which a child process of the smoke computes from the
              smoke's start (``--join-reference``);
     K        every ``Dataset`` verb on 16,777,216 Zipf-keyed 100-byte
              records, each held against numpy;
     K-small  2^20 records through every verb, card against CPU, with
              ``fast_sort`` + ``"pow2"`` and ``ring_fused=False`` variants;
     L        ``run_als``, ``BASELINE.md`` config 4, at MovieLens-20M's
              dimensions, held against ``_numpy_als``, which a child
              process of the smoke computes from the smoke's start
              (``--als-reference``), beside the legs before L;
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
   each checked against numpy (K's ``sort_by_key``, H's fold and M's
   and N's queries are not profiled: their repeated runs cost the smoke
   more time than their profiles told);
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
    on numpy: bytes equal, MB/s; the one-thread runs went in PR 12);
    ``spill`` (leg Q's 1.68 GB
    through a ``SpillWriter`` on each path: files byte-identical, GB/s,
    each file read on both paths); ``pinned`` (a pinned staging lease is
    page-locked and a copy from it returns before it lands, beside leg
    P's loads with and without overlap); ``on_off`` (H-small's,
    Q-small's and a 2^16-record P-shaped size on the card with
    ``use_native_staging`` / ``serde_native`` on and off: outputs, spill
    files and checkpoints identical); ``serde_fault`` (one injected
    ``serde.encode`` and ``serde.decode`` failure, recovered with the
    same rows, books balanced);
11. the data path's records (``phase: obs``): leg F's and leg B's cells
    with a manager whose journal is on (``metrics_sink``,
    ``collect_shuffle_read_stats``, ``watchdog_timeout_s=30``) and one
    whose journal is off, over the same records: a warm-up each, then 3
    reads each in turns (the journal's inside ``job("terasort")``, a
    stage a read), GB/s on and off; each span held against the plan
    (records, rounds, ``per_peer_records``, ``dispatches``, the chunk
    and queue-block events or the fused exchange's round pairs,
    ``phase_s`` against the wall, ``bottleneck``, the job's trace id
    and stage) and one job line; F's sync warnings with the journal on
    and off (``set_sync_debug_mode("warn")``); one read of each cell
    under ``profiling.trace``, whose Chrome trace must hold the ring
    (and B's merge-stage) kernel and the read's
    ``shuffle:exchange#s<span_id>`` range (the cell's ``profile`` line
    and ``profiles/torch_leg{F,B}.txt``); the watchdog on a real CUDA
    event wait (a ~2 s ``torch.cuda._sleep``, a 0.2 s timeout: the stall
    line lands before ``synchronize()`` returns); M-small's queries with
    the journal on, card against CPU (the same plan lines and jobs); the
    reference's ``shuffle_report.py --json`` and ``shuffle_trace.py`` on
    the phase's journals, as subprocesses (since PR 12 the journal-on
    arm also folds every read into the windowed rollup);
12. the multi-tenant service (``sparkrdma_tpu_torch/service``):
     S        ``bench.py``'s ``run_multitenant``: two tenants' TeraSorts
              (8,388,608 × 100-byte records each, tenant_a seed 11 and
              tenant_b seed 12) at once through one ``ShuffleService``,
              a warm-up and 3 reads each, with the journal, heartbeat,
              telemetry, alerts and probe on; per-tenant and aggregate
              GB/s, fairness (min/max), the wall clock and peak memory;
              each tenant device-verified and equal bit for bit to the
              same tenant run alone;
     service  one line a part, each with its checks: ``sessions`` (leg
              B's conf and ``ring_fused=False`` as sessions, each equal
              to its solo run; the shared pool's stream order on two
              streams), ``isolation`` (one tenant's injected dispatch
              failure beside another tenant's clean read: books per
              tenant), ``rpc`` (an ``RpcClient`` on localhost: every op
              of the session surface, a corrupted frame retried, a 0.5 s
              lease expiring), ``probe`` (Prometheus text, health, the
              reference's ``shuffle_top.py --connect --rpc``), ``alerts``
              (``spill_storm`` fired by a spilling out-of-core run and
              resolved, read by ``shuffle_report.py``);
13. shuffles across processes (``runtime/distributed.py``,
    ``exchange/hierarchical.py``, the ring's push into registered
    windows, ``exchange/windows.py``): the smoke spawns two workers of itself
    (``--distributed-worker``), both on this card over gloo, which meet
    through a ``file://`` rendezvous; the one-process references run
    first and the cached memory is freed before the spawn; a worker's
    non-zero exit or ``DIST_WORKER_S`` fails the smoke:
     T            leg B's records (seed 0) and conf, 4 partitions a
                  process, on ``"xla"`` (one ``all_to_all_single`` a
                  round), ``"hierarchical"`` (H = 2) and ``"pallas_ring"``
                  (the push, CUDA IPC between the two workers), a
                  warm-up and 3 reads each; per read the GB/s (the
                  global bytes over the slower worker's wall time), each
                  worker's seconds in ``all_to_all_single``, merge-path
                  and push launches, the ring window's moves, handshake
                  and push-wait seconds and size, and peak memory; each
                  partition's totals and in-order digest
                  (``part_digests``) equal to the one-process ``"xla"``
                  run's; where the machine has two cards the same over
                  ``"cpu:gloo,cuda:nccl"``, a card a process (else the
                  line says ``"nccl": "needs 2 cards"``);
     U            the ``Dataset`` verbs across the same two workers:
                  leg K's records (16,777,216 × 100 B, seed 7, Zipf(1.1)
                  keys), each worker building them from the seed, on
                  ``"xla"`` with leg B's conf (the merge-path tail);
                  ``from_host_rows``, ``sort_by_key``, ``reduce_by_key``,
                  ``distinct``, ``count_by_key`` and ``filter(w2 == 0)``
                  then ``repartition()``, each timed once after a
                  warm-up of the first; per verb the slower worker's
                  seconds, each worker's seconds in
                  ``all_to_all_single``, merge-path launches and peak
                  memory, and each partition's totals and digest equal
                  to the one-process run's;
     V-plan       the query planner on U's loaded dataset in the same
                  workers (``LogicalPlan.dataset``): ``filter`` (the low
                  key word not 7 mod 8) then ``sort_by_key``;
                  ``reduce_by_key("sum")`` (the combine hoist's decision
                  equal to one process's); ``select`` of two payload
                  columns then ``repartition(16)``; each through a fresh
                  ``PlanExecutor.run``, reported as U's verbs are and
                  held to the same plans in one process;
     V-service    in the same workers, before U: a ``ShuffleService``
                  each, with the live layer on as in leg S, leg S's two
                  tenants in threads at once, each a TeraSort of
                  8,388,608 × 100 B (leg B's conf; tenant_a on the
                  ring, in its own window, tenant_b on ``"xla"``, its
                  ``all_to_all_single`` on its own scope's group) in a
                  session with its own collective scope, a
                  warm-up and 3 reads; per tenant and read the GB/s of
                  the slower worker, the aggregate, each tenant's
                  seconds in ``all_to_all_single`` and window stats,
                  launches and peak memory; every
                  partition of every read equal to the tenant's TeraSort
                  alone in one process;
     distributed  2^20 records: TeraSort outputs bit-exact against one
                  process on ``"xla"``, ``"hierarchical"`` at H = 1, 2
                  and 4, and the ring fused and a push a round, each in
                  the fused regime and streaming (``DIST_STREAM_KNOBS``);
                  ``repartition(16)``; a sharded checkpoint
                  (each process writes only its ``proc{p}`` shards),
                  resumed by fresh managers; ``InputStreamer`` and
                  ``run_streaming_terasort`` (the fold) at 2^22 records
                  in 4 chunks, each worker's chunks its own columns and
                  the fold's sums equal on both workers, to one process
                  and to numpy; the refusals of the entry points the
                  reference cannot run across processes either (A.12,
                  each message naming
                  the reference's line: the Dataset's, a plan's reuse
                  hit, sink, broadcast join and ``group_by_key``, a
                  service with ``admission_slots > 0``); a segment
                  checkpoint written and adopted by each worker in its
                  own directory; an RPC client in each worker whose
                  ``write`` runs and whose ``read`` refuses;
     ring_push    in the same workers, the push at every shape T, V
                  and the phase launched it at: the kernel's move
                  against the plain push's and ``all_to_all_single``'s,
                  bit for bit, then each timed (both workers at once,
                  each alone, against the whole exchange's bound); and
                  the handshake's host microseconds a move;
14. the port's soaks (``phase: chaos``): ``scripts/torch_chaos_soak.py``
    (the reference's seven passes: control and chaos legs under a
    seven-site fault schedule, two tenants with the probe under fire,
    map-side combine, two RPC worker processes, alerts, the planner) at
    65,536 records a partition, every exchange streamed through the ring
    kernel, and ``scripts/torch_oversub_soak.py`` at 16 chunks of 262,144
    records, both at once, each a child of this script
    (``--soak-child``), started once leg Q-small's launch-failure child
    has exited and run beside the rest of Q-small (its lines follow
    Q-small's): each summary must read ``"ok": true``; the chaos soak's
    launches and ring shapes join the legs';
   then the stacked ring kernel at every send shape legs B-S and the
   chaos soak launched it at (recorded while each leg ran), each against
   its plain version and timed (cold only where a send/out pair is 1 MiB
   or more); and the plan's count kernel (``csrc/partition_counts.cu``)
   at every plan pass the legs, leg T's workers and both soaks gave it
   (``PlanPasses``, ``phase: partition_counts``): random words in a
   batch of the pass's shape and strides, under a partitioner of the
   same kind, bins and split, its table bit-exact against
   ``partition_counts_plain``, both timed (every leg's ``launches``
   counts the kernel's launches, set to 0 before the leg); and the
   read's bucketing kernel (``csrc/bucket_scatter.cu``) likewise at every
   map pass they gave it (``PlanPasses``, ``phase: bucket_scatter``): its
   gather source, counts and offsets bit-exact against
   ``bucket_scatter_plain``, both timed;
15. the whole smoke's seconds, one ``{"kernels": [...]}`` line and, last,
    the device line.

Every phase, leg, profile and leg-seconds line carries ``wall_s``: the
seconds since the previous such line, so they partition the smoke's
time; a leg's own timed run is its ``run_wall_s``.

Exits non-zero, without a result, if there is no CUDA device, if the
port is not beside it, or if any phase fails.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import itertools
import json
import logging
import os
import re
import shutil
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


#: the clock of the last phase or leg line, for the next one's wall_s
_LAST_LINE_AT = [time.perf_counter()]


def report(line: dict) -> None:
    """Print one result line. A phase, leg, profile or leg-seconds line
    gets ``wall_s``: the seconds since the previous such line (or the
    start), so the lines' ``wall_s`` partition the smoke's time."""
    if {"phase", "leg", "profile", "leg_s"} & set(line):
        now = time.perf_counter()
        line["wall_s"] = now - _LAST_LINE_AT[0]
        _LAST_LINE_AT[0] = now
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
#: The push shapes ``[L, R, D, ...]`` (``is_push``) are T's workers'; a
#: push a round takes its send as ``[L, D, words]``.
#: ``tests/test_torch_ring.py`` holds the kernel's launch plan and per-item
#: copy at these, the phase shapes and the edge shapes;
#: ``scripts/torch_ring_ab.py`` times these and the phase shapes.
RING_LEG_SHAPES = [
    # (legs, shape, a2a)
    ("M-small", (8, 1, 8, 1, 3, 14), False),
    ("chaos", (8, 1, 8, 1, 3, 256), False),
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
    ("service", (8, 1, 8, 1, 4, 1025), False),
    ("M", (8, 1, 8, 1, 4, 3201), False),
    ("D-small", (8, 1, 8, 1, 4, 32768), True),
    ("D-small", (8, 1, 8, 1, 4, 32769), False),
    ("D", (8, 1, 8, 1, 4, 524289), False),
    ("M-small, chaos", (8, 1, 8, 1, 6, 2), False),
    ("M-small", (8, 1, 8, 1, 6, 6), False),
    ("M-small", (8, 1, 8, 1, 6, 12), False),
    ("M-small", (8, 1, 8, 1, 6, 14), False),
    ("M-small", (8, 1, 8, 1, 6, 16), False),
    ("M-small", (8, 1, 8, 1, 6, 43), False),
    ("M-small", (8, 1, 8, 1, 6, 249), False),
    ("chaos", (8, 1, 8, 1, 6, 256), False),
    ("M-small", (8, 1, 8, 1, 6, 1665), False),
    # the chaos soak's 256-record slots (W = 9; the planner pass W = 6)
    ("chaos", (8, 1, 8, 1, 9, 256), False),
    ("chaos", (8, 1, 8, 1, 9, 257), False),
    ("H-small", (8, 1, 8, 1, 25, 1152), True),
    ("H-small, Q-small, service", (8, 1, 8, 1, 25, 1153), False),
    ("H-small", (8, 1, 8, 1, 25, 1216), True),
    ("H-small, Q-small, service", (8, 1, 8, 1, 25, 1217), False),
    ("H-small", (8, 1, 8, 1, 25, 2049), False),
    ("F-small, K-small, Q-small", (8, 1, 8, 1, 25, 4096), True),
    ("C-small, service", (8, 1, 8, 1, 25, 32768), True),
    ("B-small, service", (8, 1, 8, 1, 25, 32769), False),
    ("H", (8, 1, 8, 1, 25, 34817), False),
    ("H", (8, 1, 8, 1, 25, 36865), False),
    ("S", (8, 1, 8, 1, 25, 147457), False),
    ("C", (8, 1, 8, 1, 25, 524288), True),
    ("B", (8, 1, 8, 1, 25, 524289), False),
    ("L-small", (8, 1, 8, 1, 46, 32769), False),
    ("L", (8, 1, 8, 1, 46, 524289), False),
    ("chaos", (8, 1, 8, 4, 6, 256), False),
    ("chaos", (8, 1, 8, 26, 6, 256), False),
    ("chaos", (8, 1, 8, 184, 6, 256), False),
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
    # the push across T's two workers, [L, R, D, ...] a worker: leg T's
    # ring reads, V-service's tenants, and phase: distributed's ring
    # TeraSorts (fused; a push a round with the counts' [4, 8, 2] words;
    # the streaming chunks)
    ("distributed", (4, 1, 8, 2), True),
    ("distributed", (4, 1, 8, 102400), True),
    ("distributed", (4, 1, 8, 819200), True),
    ("distributed", (4, 1, 8, 1, 25, 4096), False),
    ("distributed", (4, 1, 8, 1, 25, 32769), False),
    ("V-service", (4, 1, 8, 1, 25, 262145), False),
    ("T", (4, 1, 8, 1, 25, 524289), False),
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
#: the ring-shape lines time a pair cold only from this size on: below
#: it the cold graph holds over 128 launches (up to ~22,000 at the
#: smallest shapes) of a kernel that launch latency bounds
COLD_MIN_PAIR = 1 << 20
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
               a2a: bool = False, cold: bool = True) -> dict:
    """Device ms of the ring kernel on ``send`` (``[D, D, ...]`` through
    ``ring_all_to_all`` when ``a2a``) and of ``permute().contiguous()``'s
    copy into a buffer allocated outside the graph, each by CUDA-graph
    replay, twice. Warm: 20 launches on the same buffers, so a pair that
    fits the 50 MB L2 is read from there (a just-gathered send partly is
    on the main path; the pooled out is not). Cold: the launches rotate
    over copies of the pair, ``COLD_BYTES`` in all, so each finds its
    buffers evicted; a pair of ``COLD_BYTES`` or more is cold when warm,
    and is timed once. The share of the HBM bound is the cold one.
    ``cold=False`` leaves the cold pair out (``None``) and takes the
    share from the warm time."""
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
    if not cold:
        line["device_cold_ms"] = line["library_device_cold_ms"] = None
    elif copies > 1:
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
    line["device_share_of_bound"] = pair / MEM_RATE * 1e3 / (
        line["device_cold_ms"] if cold else line["device_ms"])
    del lib_out
    return line


def ring_device(send: torch.Tensor, out: torch.Tensor,
                a2a: bool = False, cold: bool = True) -> dict:
    """``ring_times`` and the host cost per launch."""
    return {**ring_times(send, out, a2a, cold),
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
            "read_s": read_s, "run_wall_s": wall, "capacity": plan.capacity,
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
            "graph_gen_s": gen_s, "run_wall_s": time.perf_counter() - t0,
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
                                                   ring_exchange, ring_push,
                                                   ring_push_all_to_all)
    from sparkrdma_tpu_torch.kernels.merge_sort import (merge_splits,
                                                        merge_stage)
    from sparkrdma_tpu_torch.kernels.bucket_scatter import bucket_scatter
    from sparkrdma_tpu_torch.kernels.partition_counts import \
        partition_counts

    kernels = {"merge_stage": merge_stage, "merge_splits": merge_splits,
               "ring_exchange": ring_exchange,
               "ring_all_to_all": ring_all_to_all,
               "ring_push": ring_push,
               "ring_push_all_to_all": ring_push_all_to_all,
               "partition_counts": partition_counts,
               "bucket_scatter": bucket_scatter}
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
            "run_wall_s": wall, "capacity": plan.capacity,
            "rounds": plan.num_rounds, "out_capacity": plan.out_capacity,
            "verified": res.verified,
            "check": "device" if full else "host+device",
            "launches": launches}
    report(line)
    if not res.verified:
        fail(f"leg {name} failed verification")
    return line, out, totals


def kernel_rows(prof) -> list:
    """``(device us, name, count)`` of every kernel a profile holds,
    largest first: the device rows without the ``record_function`` /
    NVTX ranges the port names its reads with (``shuffle:exchange#s<id>``),
    whose device time is their kernels' again."""
    from torch.autograd import DeviceType

    return sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and not ev.key.startswith("shuffle:")), reverse=True)


def profile_table(label: str, prof, read_ms: float, path: str) -> dict:
    """The ``profile`` line of a profiled read (its device time by kernel
    beside ``read_ms``, a read's time unprofiled) and its table in
    ``path``. The device's idle share is the benchmark's
    (``shufflebench/trace.py``: the union of the kernels' intervals), not
    a sum of self times, which counts two streams at once twice."""
    rows = kernel_rows(prof)
    os.makedirs("profiles", exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    line = {"profile": label, "read_ms": read_ms,
            "top": [[k[:60], us / 1e3, c] for us, k, c in rows[:10]],
            "merge_kernels": [[k[:60], us / 1e3, c] for us, k, c in rows
                              if "merge_s" in k]}
    report(line)
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
            "run_wall_s": wall,
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
            "read_s": read_s, "run_wall_s": wall, "capacity": plan.capacity,
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
    peak device memory; the streaming fold over the same dataset."""
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
            "gen_s": gen_s, "run_wall_s": time.perf_counter() - t0,
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
    (both forms' one launch path) is wrapped for the duration (the launch
    counts stay the wrappers' own). Each shape is the canonical ``[D, R, D,
    ...]`` (the push's ``[L, R, D, ...]``, ``L < D``: a push shape) with a
    flag: the R = 1 forms' ``[D, D, ...]`` is ``[D, 1, D, ...]``, a2a."""

    def __enter__(self):
        from sparkrdma_tpu_torch.exchange import ring

        self.counts = {}
        self._ring = ring
        self._launch = ring._launch

        def launch(send, bases, rank, round_axis=True):
            shape = tuple(send.shape) if round_axis else \
                (send.shape[0], 1) + tuple(send.shape[1:])
            key = (shape, not round_axis)
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._launch(send, bases, rank, round_axis)

        ring._launch = launch
        return self

    def __exit__(self, *exc):
        self._ring._launch = self._launch


class PlanPasses:
    """The plan passes the ``partition_counts`` kernel counted and the
    map passes the ``bucket_scatter`` kernel bucketed while inside the
    ``with``, with their launch counts: ``exchange/protocol.py``'s names
    for the wrappers are wrapped for the duration (the launch counts stay
    the wrappers' own). A pass's key is what the kernel is given: the
    batch's shape and strides, the description's kind, ``num_parts``,
    key words, first key word, ``split_k`` and stride, the bins and the
    stacked partitions, then ``"plan"`` or ``"map"``, all plain values,
    so a worker's or a child's keys come back through JSON
    (:func:`plan_rows`)."""

    def __enter__(self):
        from sparkrdma_tpu_torch.exchange import protocol

        self.counts = {}
        self._protocol = protocol
        self._wrapped = {"plan": protocol.partition_counts,
                         "map": protocol.bucket_scatter}

        def recorder(what):
            def wrapper(records, part_fn, parts, local_partitions):
                if records.is_cuda:
                    d = part_fn.device_spec
                    key = (tuple(records.shape), tuple(records.stride()),
                           d.kind, d.num_parts, d.key_words, d.first,
                           d.split_k, d.stride, parts, local_partitions,
                           what)
                    self.counts[key] = self.counts.get(key, 0) + 1
                return self._wrapped[what](records, part_fn, parts,
                                           local_partitions)
            return wrapper

        protocol.partition_counts = recorder("plan")
        protocol.bucket_scatter = recorder("map")
        return self

    def __exit__(self, *exc):
        self._protocol.partition_counts = self._wrapped["plan"]
        self._protocol.bucket_scatter = self._wrapped["map"]


#: leg (or worker part, or soak) -> {PlanPasses key: launches}, plan
#: and map passes
PLAN_PASSES = {}


def note_plans(leg_name: str, counts: dict) -> None:
    """Add a leg's plan passes to ``PLAN_PASSES``."""
    mine = PLAN_PASSES.setdefault(leg_name, {})
    for key, n in counts.items():
        mine[key] = mine.get(key, 0) + n


def plan_rows(counts: dict) -> list:
    """``PlanPasses.counts`` as JSON rows ``[*key, launches]``."""
    return [[list(k[0]), list(k[1]), *k[2:], n]
            for k, n in sorted(counts.items())]


def plan_counts_of(rows: list) -> dict:
    """:func:`plan_rows`' rows back as ``PlanPasses.counts``."""
    return {(tuple(r[0]), tuple(r[1]), *r[2:-1]): r[-1] for r in rows}


def is_push(shape) -> bool:
    """A push shape ``[L, R, D, ...]`` (``L < D``: across processes)."""
    return shape[0] != shape[2]


def run_leg(legs: dict, shapes: dict, name: str, fn) -> dict:
    """``legs[name] = fn()``, recording the ring shapes it launched and
    its seconds."""
    t0 = time.perf_counter()
    with RingShapes() as seen, PlanPasses() as plans:
        legs[name] = fn()
    shapes[name] = seen.counts
    note_plans(name, plans.counts)
    gc.collect()
    torch.cuda.empty_cache()
    report({"leg_s": name, "seconds": time.perf_counter() - t0,
            "memory_allocated_gb_after": torch.cuda.memory_allocated() / 1e9})
    return legs[name]


def ring_leg_phases(shapes: dict) -> list:
    """The ring kernel at every send shape legs B-Q launched it at (the
    push shapes of T's workers are checked there): random
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
        if is_push(shape):
            continue     # checked in the workers that pushed it
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
                **ring_device(send, got, a2a,
                              cold=2 * send.numel() * 4 >= COLD_MIN_PAIR)}
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


def plan_partitioner(kind: str, num_parts: int, key_words: int,
                     first: int, split_k: int, stride: int, seed: int):
    """A partitioner whose description is the one a recorded plan pass
    gave the kernel; range's splitter rows are random and unsorted."""
    from sparkrdma_tpu_torch.exchange.partitioners import (
        hash_partitioner, modulo_partitioner, range_partitioner)
    from sparkrdma_tpu_torch.exchange.protocol import split_partitioner

    if kind == "hash":
        part = hash_partitioner(num_parts, key_words)
    elif kind == "mod":
        part = modulo_partitioner(num_parts, first)
    else:
        part = range_partitioner(np.random.default_rng(seed).integers(
            0, 2 ** 32, size=(num_parts - 1, key_words), dtype=np.uint32),
            key_words)
    return split_partitioner(part, stride, split_k) if stride else part


def pass_batch(shape, strides, seed: int) -> torch.Tensor:
    """Random words in a batch of a recorded pass's shape and strides (an
    expanded batch, which the wrappers read contiguous, contiguous)."""
    words = rand_words(shape, seed=seed)
    if strides[1:] == (0,) or not all(strides):
        return words
    return torch.empty_strided(shape, strides, dtype=torch.int32,
                               device="cuda").copy_(words)


def plan_counts_phase() -> list:
    """The plan's count kernel at every pass the legs, workers and soaks
    gave it (``PLAN_PASSES``): random words in a batch of the pass's
    shape and strides, the same partitioner kind, bins and split, its
    table bit-exact against ``partition_counts_plain`` and both timed
    beside the bound (the key words read once). One line per pass; fails
    on any difference, or if legs B (range) and D (hash) launched none."""
    from sparkrdma_tpu_torch.kernels.partition_counts import (
        partition_counts, partition_counts_plain)

    by_key = passes_by_key("plan")
    lines = []
    for seed, (key, legs) in enumerate(sorted(by_key.items())):
        shape, strides, kind, num_parts, kw, first, k, stride, parts, L, _ = \
            key
        part = plan_partitioner(kind, num_parts, kw, first, k, stride,
                                seed=200 + seed)
        x = pass_batch(shape, strides, seed=200 + seed)

        def kernel():
            return partition_counts(x, part, parts, L)

        def plain():
            return partition_counts_plain(x, part, parts, L)

        got, want = kernel(), plain()
        err = max_abs_err(got, want)
        if err or got.dtype != want.dtype:
            fail(f"partition_counts disagrees with its plain version at "
                 f"{key} (legs {sorted(legs)}): {err}")
        bound_ms = shape[1] // L * L * kw * 4 / MEM_RATE * 1e3
        line = {"phase": "partition_counts", "shape": list(shape),
                "strides": list(strides), "kind": kind,
                "num_parts": num_parts, "key_words": kw,
                "first_key_word": first, "split_k": k,
                "split_stride": stride, "bins": parts, "partitions": L,
                "legs": ", ".join(sorted(legs)), "launches_by_leg": legs,
                "launches": sum(legs.values()), "max_abs_err": err,
                "records": int(want.sum()),
                "kernel_ms": time_ms(kernel, reps=10,
                                     inner=20 if bound_ms < 0.5 else 1),
                "bound_ms": bound_ms,
                "plain_ms": time_ms(plain, reps=3)}
        report(line)
        lines.append(line)
        del x, got, want
        torch.cuda.empty_cache()
    for leg_name in ("B", "D"):
        if leg_name in PLAN_PASSES and not any(
                k[-1] == "plan" for k in PLAN_PASSES[leg_name]):
            fail(f"partition_counts counted no plan pass of leg {leg_name}")
    return lines


def passes_by_key(what: str) -> dict:
    """``PLAN_PASSES``' keys of ``what`` ("plan" or "map"), each with the
    launches every leg made at it."""
    by_key = {}
    for leg_name, counts in PLAN_PASSES.items():
        for key, n in counts.items():
            if key[-1] == what:
                by_key.setdefault(key, {})[leg_name] = n
    return by_key


def map_passes_phase() -> list:
    """The read's bucketing kernel at every map pass the legs, workers
    and soaks gave it (``PLAN_PASSES``' "map" keys): random words in a
    batch of the pass's shape and strides, the same partitioner kind,
    bins and split, its gather source, counts and offsets bit-exact
    against ``bucket_scatter_plain`` and both timed beside the bound
    (every word read once and written once, the key words read once
    more). One line per pass; fails on any difference, or if leg F (the
    default geometry's streaming TeraSort) launched none."""
    from sparkrdma_tpu_torch.kernels.bucket_scatter import (
        bucket_scatter, bucket_scatter_plain)

    lines = []
    for seed, (key, legs) in enumerate(sorted(passes_by_key("map").items())):
        shape, strides, kind, num_parts, kw, first, k, stride, parts, L, _ = \
            key
        part = plan_partitioner(kind, num_parts, kw, first, k, stride,
                                seed=300 + seed)
        x = pass_batch(shape, strides, seed=300 + seed)

        def kernel():
            return bucket_scatter(x, part, parts, L)

        def plain():
            return bucket_scatter_plain(x, part, parts, L)

        got, want = kernel(), plain()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err or any(a.dtype != b.dtype or a.shape != b.shape
                      for a, b in zip(got, want)):
            fail(f"bucket_scatter disagrees with its plain version at "
                 f"{key} (legs {sorted(legs)}): {err}")
        records = shape[1] // L * L
        bound_ms = records * (shape[0] * 8 + kw * 4) / MEM_RATE * 1e3
        line = {"phase": "bucket_scatter", "shape": list(shape),
                "strides": list(strides), "kind": kind,
                "num_parts": num_parts, "key_words": kw,
                "first_key_word": first, "split_k": k,
                "split_stride": stride, "bins": parts, "partitions": L,
                "legs": ", ".join(sorted(legs)), "launches_by_leg": legs,
                "launches": sum(legs.values()), "max_abs_err": err,
                "records": int(want[1].sum()),
                "kernel_ms": time_ms(kernel, reps=10,
                                     inner=20 if bound_ms < 0.5 else 1),
                "bound_ms": bound_ms,
                "plain_ms": time_ms(plain, reps=3)}
        report(line)
        lines.append(line)
        del x, got, want
        torch.cuda.empty_cache()
    if "F" in PLAN_PASSES and not any(
            k[-1] == "map" for k in PLAN_PASSES["F"]):
        fail("bucket_scatter bucketed no map pass of leg F")
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
            "plan_s": res.plan_s, "run_wall_s": wall,
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


def join_codes_expect(xa: np.ndarray, xb: np.ndarray) -> tuple:
    """Every joined row of ``xa ⋈ xb`` on word 1, as the sorted codes
    ``key << 20 | a_payload << 10 | b_payload`` (lossless: keys below
    2^24, payloads below 2^10), with the match count and the sum of
    payload products (exact: integers below 2^53 in float64)."""
    # the codes are sorted at the end, so neither side's order matters:
    # both sides key-sorted (the default sort), the A side's lookups
    # then walk the B side in order
    kb_order = np.argsort(xb[:, 1])
    kb, pb = xb[kb_order, 1], xb[kb_order, 2].astype(np.uint64)
    ka_order = np.argsort(xa[:, 1])
    ka, pa = xa[ka_order, 1], xa[ka_order, 2].astype(np.uint64)
    lo = np.searchsorted(kb, ka, side="left")
    hi = np.searchsorted(kb, ka, side="right")
    cnt = hi - lo
    a_ix = np.repeat(np.arange(len(ka)), cnt)
    starts = np.cumsum(cnt) - cnt
    b_ix = lo[a_ix] + (np.arange(len(a_ix)) - starts[a_ix])
    pa, pb = pa[a_ix], pb[b_ix]
    codes = (ka[a_ix].astype(np.uint64) << np.uint64(20)) \
        | (pa << np.uint64(10)) | pb
    codes.sort()
    return codes, len(codes), float((pa * pb).sum())


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
    from sparkrdma_tpu_torch.workloads.join import run_hash_join

    m = terasort_manager("cuda")
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: run_hash_join(
        m, J_ROWS, J_ROWS, key_range=J_KEY_RANGE, seed=0, verify=False))
    xa, xb = join_tables(J_ROWS, J_KEY_RANGE, seed=0)
    t0 = time.perf_counter()
    ref = reference("--join-reference", "J")
    want_codes, ref_count, ref_sum = (ref["codes"], int(ref["count"]),
                                      float(ref["total"]))
    check_wait_s = time.perf_counter() - t0
    da = Dataset.from_host_rows(m, xa)
    db = Dataset.from_host_rows(m, xb)
    (joined, totals), ds_join_s = timed(lambda: da.join(db))
    launches = {k: v.launches for k, v in kernels.items()}
    got_codes, zero = join_codes_got(joined, totals)
    del joined, da, db
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
            "run_hash_join_wall_s": wall,
            "numpy_ref": "join_codes_expect in a child process since the "
                         "smoke's start",
            "check_wait_s": check_wait_s,
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


#: leg K's rows kept for leg U's one-process run (``k_rows(keep=True)``)
_K_ROWS = {}


def k_rows(total: int, seed: int, keep: bool = False) -> np.ndarray:
    """Leg K's 100-byte records: key ``(0, id)`` with ids Zipf(1.1) folded
    into 2^22, word 2 in [0, 4), words 3..24 a fixed function of (id,
    word 2), so rows sharing both are duplicates (``distinct`` has work).
    ``keep`` keeps the array for the next call with the same arguments,
    which takes it (nothing writes into it in between)."""
    kept = _K_ROWS.pop((total, seed), None)
    if kept is not None:
        return kept
    rng = np.random.default_rng(seed)
    rows = np.zeros((total, KEY_WORDS + VAL_WORDS), np.uint32)
    rows[:, 1] = rng.zipf(1.1, size=total) % K_KEY_IDS
    rows[:, 2] = rng.integers(0, 4, size=total)
    k_derived(rows[:, 1], rows[:, 2], out=rows[:, 3:])
    if keep:
        _K_ROWS[total, seed] = rows
    return rows


def k_derived(ids: np.ndarray, w2: np.ndarray, out=None) -> np.ndarray:
    """Words 3..24 of leg K's rows: ``((h + j*C) * M >> 17) mod 2^32``
    with ``h`` a mix of (id, word 2), in uint64 arithmetic, a block of
    rows at a time (into ``out`` if given)."""
    if out is None:
        out = np.empty((len(ids), KEY_WORDS + VAL_WORDS - 3), np.uint32)
    j = np.arange(3, KEY_WORDS + VAL_WORDS, dtype=np.uint64) \
        * np.uint64(0xC2B2AE35)
    block = 1 << 14          # a [block, 22] uint64 temporary stays in cache
    for lo in range(0, len(ids), block):
        h = ids[lo:lo + block].astype(np.uint64) * np.uint64(0x9E3779B1)
        h += w2[lo:lo + block].astype(np.uint64) * np.uint64(0x85EBCA6B)
        mixed = h[:, None] + j[None]
        mixed *= np.uint64(0x27D4EB2F)
        mixed >>= np.uint64(17)
        out[lo:lo + block] = mixed          # the low 32 bits
    return out


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
    """Unique ids and every payload word summed per id mod 2^32. A row's
    payload is a function of its (id, word 2) pair (``k_rows``), so the
    sums are each pair's count times its payload, summed per id."""
    pairs, count = np.unique(rows[:, 1].astype(np.uint64) << np.uint64(2)
                             | rows[:, 2], return_counts=True)
    ids = (pairs >> np.uint64(2)).astype(np.uint32)
    w2 = (pairs & np.uint64(3)).astype(np.uint32)
    vals = np.empty((len(pairs), VAL_WORDS), np.uint64)
    vals[:, 0] = w2
    vals[:, 1:] = k_derived(ids, w2)
    vals *= count.astype(np.uint64)[:, None]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    sums = np.add.reduceat(vals, starts, axis=0)
    return ids[starts], sums.astype(np.uint32)


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
    checked on the card."""
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.workloads.terasort import (_sums,
                                                        device_verify_sort)

    rows = k_rows(K_RECORDS, seed=7, keep=True)
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


#: the host references of legs J and L, ``join_codes_expect`` (~7 s of
#: numpy sorts) and ``_numpy_als`` (float64 sparse products; ~20 s in
#: which scipy holds the GIL), each run in a child process of this
#: script that the full run starts first, so that it overlaps the legs
#: before its own: flag -> ``(process, output path, its directory)``
_REF_CHILDREN = {}


def start_references() -> None:
    """Start legs J's and L's checks in child processes
    (``--join-reference PATH``, ``--als-reference PATH``)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    for flag in ("--join-reference", "--als-reference"):
        root = tempfile.mkdtemp(prefix="chip_smoke_ref_")
        path = os.path.join(root, "reference.npz")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        _REF_CHILDREN[flag] = (proc, path, root)
    atexit.register(stop_references)


def stop_references() -> None:
    """Kill the children still running, and drop their directories."""
    for proc, _, root in _REF_CHILDREN.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def reference(flag: str, leg: str):
    """The arrays the ``flag`` child saved, waited for (the smoke fails
    if the child did)."""
    proc, path, _ = _REF_CHILDREN[flag]
    try:
        out = proc.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        fail(f"leg {leg}'s reference child ran past 600 s")
    if proc.returncode:
        print(out[-4000:], file=sys.stderr)
        fail(f"leg {leg}'s reference child exited {proc.returncode}")
    return np.load(path)


def join_reference_child(path: str) -> int:
    """The child: ``join_codes_expect`` on leg J's tables, saved to
    ``path``."""
    codes, count, total = join_codes_expect(
        *join_tables(J_ROWS, J_KEY_RANGE, seed=0))
    np.savez(path, codes=codes, count=count, total=total)
    return 0


def als_reference_child(path: str) -> int:
    """The child: ``_numpy_als`` on leg L's ratings from the item factors
    ``run_als`` starts from (``default_rng(0)``), saved to ``path``."""
    from sparkrdma_tpu_torch.workloads.als import _numpy_als

    ratings = movielens_like(L_USERS, L_ITEMS, L_RATINGS, seed=20)
    v0 = np.random.default_rng(0).standard_normal(
        (L_ITEMS, L_RANK), dtype=np.float32) * 0.1
    u, v = _numpy_als(ratings, L_USERS, L_ITEMS, L_RANK, L_ITERS, 0.1, v0)
    np.savez(path, u=u, v=v)
    return 0


def als_reference():
    """The ALS child's ``(U, V)``, waited for."""
    ref = reference("--als-reference", "L")
    return ref["u"], ref["v"]


def leg_l() -> dict:
    """``BASELINE.md`` config 4: ALS at MovieLens-20M's dimensions (138,493
    users, 26,744 items, 20,000,263 ratings; generated, the file is not in
    the repository), rank 8, 5 iterations, checked against ``_numpy_als``
    at the reference's rtol 2e-3, atol 2e-4 (computed by the child process
    :func:`start_references` started, from the same ratings and initial
    factors)."""
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
                                      rank=L_RANK, iterations=L_ITERS,
                                      verify=False))
    launches = {k: v.launches for k, v in kernels.items()}
    t0 = time.perf_counter()
    u_ref, v_ref = als_reference()
    check_wait_s = time.perf_counter() - t0
    verified = bool(
        np.allclose(res.user_factors, u_ref, rtol=2e-3, atol=2e-4)
        and np.allclose(res.item_factors, v_ref, rtol=2e-3, atol=2e-4))
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
            "rmse": res.rmse, "run_wall_s": wall, "gen_s": gen_s,
            "wire_users": res.wire.get("users"),
            "wire_items": res.wire.get("items"),
            "wire_reduction_users": wire_reduction(res.wire["users"]),
            "wire_reduction_items": wire_reduction(res.wire["items"]),
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "verified": verified,
            "check": "_numpy_als (a child process since the smoke's "
                     "start), rtol 2e-3 atol 2e-4",
            "check_wait_s": check_wait_s,
            "launches": launches}
    report(line)
    if not verified:
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


def leg_m() -> dict:
    """q64 through the planner at TPC-DS SF100's counts: 287,997,024
    ``store_sales`` rows (16 B, 4.6 GB), 204,000 items, 400 stores (402
    cut to a multiple of 8); every ``plan_*`` knob on (the store side
    broadcasts, the item side takes the shuffle join). The tables of
    ``run_q64_shape`` load into ``Dataset``s and its plan runs through
    ``PlanExecutor.run`` (launches, counters, peak memory, the numpy
    check), then again with a fresh executor (the query alone, timed)."""
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
            "verified": checks,
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
    order); checked against numpy."""
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
    nbytes = (N_SALES + N_RETURNS) * 16
    line = {"leg": "N", "workload": "run_q95_shape (BASELINE.md config 3)",
            "sales_rows": N_SALES, "return_rows": N_RETURNS,
            "n_orders": N_ORDERS, "n_warehouses": N_WAREHOUSES,
            "partitions": PARTS, "transport": "pallas_ring",
            "qualifying": res.qualifying, "net_sum": res.net_sum,
            "exchange_s": res.shuffle_s, "run_wall_s": wall,
            "gbps": nbytes / res.shuffle_s / 1e9,
            "wall_gbps": nbytes / wall / 1e9,
            "max_memory_gb": peak_gb, "verified": res.verified,
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


#: leg P's generated inputs (``v1``: keys and payloads; ``cols``: keys
#: and columns), kept for the native_staging codec line, which times the
#: codecs on the same data (made from the same seed) and takes them from
#: here instead of making them again
_P_INPUTS: dict = {}


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
    _P_INPUTS["v1"] = (keys, pays)
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
    _P_INPUTS["cols"] = (keys, cols)
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
    from sparkrdma_tpu_torch import _build
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
    ring.launch_plan = lambda *a: real_plan(*a)._replace(
        grid=real_plan(*a).grid + 1)
    try:
        failing_read("refused_launch")
    finally:
        ring.launch_plan = real_plan
    out, totals = m.get_reader(h).read()
    res["read_after_refused_launch_equal"] = bool(
        torch.equal(out, good) and torch.equal(totals, good_totals))
    real_kernel, calls = ring._kernel, [0]

    def bad_address(send, windows, *rest):
        calls[0] += 1
        return real_kernel(send, _build.PeerTable((0x10000,))
                           if calls[0] == 1 else windows, *rest)

    ring._kernel = bad_address
    failing_read("illegal_address")
    print(json.dumps(res), flush=True)
    os._exit(0)


def leg_q_small(after_child=None) -> dict:
    """2^20 records at leg F-small's geometry with ``fast_sort``: step
    3's schedule on the card and on the CPU (and with
    ``ring_fused=False``), each equal to the read without faults;
    checkpoints across devices; the failure paths (a persistent fault,
    the deadline, the backoff schedule, a corrupt checkpoint); each
    storage and pool site; the books; and a real failed launch in a
    child process, run first: ``after_child()``, if given, is called once
    it has exited (the smoke starts the chaos phase's soaks there, so
    that no soak runs while the child's launches fault)."""
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
    if after_child is not None:
        after_child()

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

        # checkpoints across devices: the resumed read against the
        # source device's control read of the same records and conf
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            root = os.path.join(tmp, f"{src}-to-{dst}")
            m = qs_manager(src, spill_to_host=True, spill_dir=root)
            write(m, 2)
            m.stop()
            first = control["default", src]
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


#: the codecs of the native_staging phase: native with the default
#: threads, numpy
CODEC_VARIANTS = (("native", {"native": True}),
                  ("numpy", {"native": False}))


def native_codec_line() -> dict:
    """The four codec calls alone at leg P's own data (4,194,304 v1
    records, 16,777,216 columnar rows; leg P's inputs where it ran, else
    made again from its seed): each on both codecs, bytes equal across
    them, MB/s of encoded bytes over host seconds."""
    from sparkrdma_tpu_torch.api.serde import (decode_bytes_rows,
                                               decode_cols,
                                               encode_bytes_rows,
                                               encode_cols)

    rng = np.random.default_rng(31)
    keys, pays = _P_INPUTS.pop("v1", None) or p_v1_data(rng, P_V1)
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
    keys, cols = _P_INPUTS.pop("cols", None) or p_cols_data(rng, P_COLS)
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
    one of them read back by ``read_array`` on both paths."""
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
        # the files are byte-identical (checked above): each reader
        # reads the native path's once
        for reader, native in (("native", True), ("numpy", False)):
            got, secs["read", f"native_file/{reader}"] = timed(
                lambda: read_array(paths["native"], np.uint32, recs.shape,
                                   use_native=native))
            checks[f"read_native_file_{reader}_equal"] = bool(
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


def on_off_p_small() -> tuple:
    """P-small's round trips with the knobs on and off: the checks, and
    the run with them on (the fault line's control)."""
    on, on_ok = p_small_round_trip({})
    off, off_ok = p_small_round_trip(STAGING_OFF)
    return {"p_small_round_trips_correct": on_ok and off_ok,
            "p_small_on_equals_off": same_outputs(on, off)}, on


def native_on_off_line() -> dict:
    """On the card, ``use_native_staging`` and ``serde_native`` on (the
    defaults) against both off: outputs, spill files and checkpoints at
    H-small's, Q-small's and a 2^16-record P-shaped size. The line keeps
    the P-shaped run with the knobs on under ``"_p_small_on"`` for
    :func:`native_fault_line`."""
    checks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_onoff_") as tmp:
        checks.update(on_off_h_small(tmp))
        checks.update(on_off_q_small(tmp))
    p_checks, p_on = on_off_p_small()
    checks.update(p_checks)
    line = {"phase": "native_staging", "part": "on_off",
            "h_small_records": H_CHUNKS * H_SMALL_CHUNK,
            "q_small_records": Q_SMALL, "p_small_records": NS_SMALL,
            "off": STAGING_OFF, "checks": checks}
    report(line)
    return {**line, "_p_small_on": p_on}


def native_fault_line(want) -> dict:
    """One ``serde.encode`` and one ``serde.decode`` failure injected on
    the native codec (``fault_spec``) in each manager of a 2^16-record
    P-shaped round trip on the card: the rows equal ``want``, the same
    round trip's without faults (the on-off line's), and the books
    balance (hard injections = recoveries, each the ``serde_native``
    one)."""
    from sparkrdma_tpu_torch import faults

    spec = "serde.encode:fail@attempt<1;serde.decode:fail@attempt<1"
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
    pinned = native_pinned_line(legs.get("P"))
    on_off = native_on_off_line()
    lines += [pinned, on_off, native_fault_line(on_off.pop("_p_small_on"))]
    gc.collect()
    torch.cuda.empty_cache()
    bad = [f"{ln['part']}: {k}" for ln in lines
           for k, v in ln.get("checks", {}).items() if not v]
    if bad:
        fail("native_staging: " + ", ".join(bad))
    return lines


# --- the obs phase: the journal, timeline, watchdog, job traces and
# profiler ranges on the card ------------------------------------------

#: the obs phase's cells: leg F's (the reference's default geometry, the
#: streaming regime) and leg B's (fused ring, fast_sort); reads per arm
OBS_READS = 3
OBS_CELLS = {
    "F": dict(),
    "B": dict(slot_records=SLOT_B, fast_sort=True, fast_sort_run=RUN,
              pack_sort_min_payload=0, wide_sort_min_payload=0),
}
#: the ``__global__`` names of the kernels the profiler trace must hold
OBS_KERNELS = ("ring_exchange_kernel", "merge_stage_kernel")


def sync_warnings(read) -> dict:
    """The synchronizing CUDA operations ``read()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: a count by
    the source line that made each."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            read()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def obs_span_checks(spans, plan, job_line, conf, recorded: int):
    """The journal's spans of one cell's recorded reads against the plan
    and the conf: ``(checks, summary)``."""
    from sparkrdma_tpu_torch.obs.critical_path import VERDICTS

    per_source = [int(c) for c in plan.counts.sum(axis=1)]
    chunks = -(-plan.num_rounds // conf.max_rounds_in_flight)
    streaming = plan.num_rounds > conf.max_rounds_in_flight
    job_spans = [s for s in spans if s.job == "terasort"]

    def count(s, name, ph):
        return sum(e["name"] == name and e["ph"] == ph for e in s.events)

    def phase_ok(s):
        # each phase is rounded to the microsecond, as the reference
        # rounds it: the sum is within half a microsecond a phase
        wall = s.plan_s + s.exchange_s + s.sort_s
        return abs(sum(s.phase_s.values()) - wall) <= \
            0.5e-6 * len(s.phase_s) + 1e-9

    checks = {
        "one_span_per_recorded_read": len(spans) == recorded,
        "records": all(s.records == plan.total_records for s in spans),
        "rounds": all(s.rounds == plan.num_rounds for s in spans),
        "per_peer_records": all(s.per_peer_records == per_source
                                and sum(s.per_peer_records) == s.records
                                for s in spans),
        "dispatches": all(s.dispatches == (2 + 2 * chunks if streaming
                                           else 1) for s in spans),
        "phase_s_partitions_wall": all(phase_ok(s) for s in spans),
        "bottleneck_set": all(s.bottleneck in VERDICTS for s in spans),
        "trace_id_and_stage": [(s.trace_id, s.stage, s.stage_attempt)
                               for s in job_spans]
        == [(job_line["trace_id"], "sort", i) for i in range(OBS_READS)],
        "one_job_line": job_line["stage_count"] == OBS_READS
        and job_line["spans"] == OBS_READS,
    }
    # every recorded read has its own span, so each span holds one read
    if streaming:
        blocks = max(chunks - conf.queue_depth, 0)
        checks["chunk_dispatch_events"] = all(
            count(s, "chunk:dispatch", "i") == chunks for s in spans)
        checks["queue_block_events"] = all(
            count(s, "queue:block", "B") == count(s, "queue:block", "E")
            == blocks for s in spans)
    else:
        checks["one_exchange_fused"] = all(
            count(s, "exchange:fused", "B") == 1 for s in spans)
        checks["ring_round_pairs"] = all(
            count(s, "ring:round", "B") == count(s, "ring:round", "E")
            == plan.num_rounds for s in spans)
    s = job_spans[-1]
    summary = {"dispatches": s.dispatches, "rounds": s.rounds,
               "chunk_dispatch": count(s, "chunk:dispatch", "i"),
               "queue_block": count(s, "queue:block", "B"),
               "exchange_fused": count(s, "exchange:fused", "B"),
               "ring_round_pairs": count(s, "ring:round", "B"),
               "events": len(s.events), "plan_s": s.plan_s,
               "exchange_s": s.exchange_s, "phase_s": s.phase_s,
               "bottleneck": s.bottleneck}
    return checks, summary


def obs_cell(name: str, root: str) -> dict:
    """One cell of the obs phase: a manager with the journal on and one
    with it off over the same records; a warm-up read each, then
    ``OBS_READS`` reads each in turns (on inside ``job("terasort")``, one
    stage a read); the spans held against the plan; leg F's cell also
    counts the sync warnings of one read on each, leg B's traces one read
    under ``profiling.trace``."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.obs.journal import read_entries, read_journal
    from sparkrdma_tpu_torch.utils import profiling
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    sink = os.path.join(root, f"journal-{name}.jsonl")
    kw = OBS_CELLS[name]
    recs = random_records(RECORDS, KEY_WORDS + VAL_WORDS, 11, "cuda")
    part = range_partitioner(compute_splitters(make_sampler(
        PARTS, KEY_WORDS, 256, 11)(recs), PARTS))
    ms, readers = {}, {}
    # the journal-off manager first: the journal-on one's timeline is
    # then the process-wide one
    for arm, extra in (("off", {}), ("on", dict(
            metrics_sink=sink, collect_shuffle_read_stats=True,
            watchdog_timeout_s=30.0))):
        m = ShuffleManager(MeshRuntime(default_conf(
            val_words=VAL_WORDS, **kw, **extra), num_partitions=PARTS,
            device="cuda"))
        h = m.register_shuffle(1, PARTS, part)
        plan = m.get_writer(h).write(recs).stop()
        readers[arm] = m.get_reader(h, key_ordering=True)
        readers[arm].read()                    # warm-up (a recorded read)
        ms[arm] = m
    gbps = {"on": [], "off": []}

    def timed_read(arm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        readers[arm].read()                    # ends in its device sync
        gbps[arm].append(RECORDS * (KEY_WORDS + VAL_WORDS) * 4
                         / (time.perf_counter() - t0) / 1e9)

    with ms["on"].job("terasort") as job:
        for i in range(OBS_READS):
            with job.stage("sort", attempt=i):
                timed_read("on")
            timed_read("off")
    extra = {}
    recorded = 1 + OBS_READS + 1          # warm-up, the job's, profiled
    if name == "F":
        # three rounds, the arms' order swapped each round: the first
        # read under the debug mode syncs once more (a first-call
        # effect), whichever arm makes it; rounds 2 and 3 are steady
        rounds = [{arm: sync_warnings(readers[arm].read) for arm in order}
                  for order in (("on", "off"), ("off", "on"),
                                ("on", "off"))]
        extra["sync_warnings"] = [{arm: sum(v.values())
                                   for arm, v in r.items()} for r in rounds]
        extra["sync_sites"] = rounds
        recorded += 3
    # one more read under profiling.trace: the Chrome trace must hold the
    # kernels and the read's span range; it also stands in for the
    # leg's own profile (the `profile: leg X read` line)
    tdir = os.path.join(root, f"trace-{name}")
    with profiling.trace(tdir) as prof:
        readers["on"].read()
    with open(os.path.join(tdir, profiling.TRACE_FILE)) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    span_id = read_journal(sink)[-1].span_id
    kernels = OBS_KERNELS if ms["on"].conf.fast_sort else OBS_KERNELS[:1]
    extra["trace"] = {
        "kernels": {k: sum(k in n for n in names) for k in kernels},
        "span_range": f"shuffle:exchange#s{span_id}",
        "span_range_found": f"shuffle:exchange#s{span_id}" in names}
    read_ms = 1e3 * RECORDS * (KEY_WORDS + VAL_WORDS) * 4 / 1e9 / \
        statistics.median(gbps["on"])
    extra["profile"] = profile_table(
        f"leg {name} read", prof, read_ms, f"profiles/torch_leg{name}.txt")
    watchdog = ms["on"].watchdog
    conf = ms["on"].conf
    for m in ms.values():
        m.stop()
    del readers, ms, recs
    torch.cuda.empty_cache()
    spans = read_journal(sink)
    entries = read_entries(sink)
    (job_line,) = [e for e in entries if e.get("kind") == "job"]
    rollups = [e for e in entries if e.get("kind") == "rollup"]
    checks, summary = obs_span_checks(spans, plan, job_line, conf,
                                      recorded)
    # since PR 12 the journal-on arm folds every read into the rollup
    checks["rollup_counts_every_read"] = \
        sum(e["reads"] for e in rollups) == recorded
    if name == "F":
        checks["sync_warnings_equal"] = all(
            r["on"] == r["off"] for r in extra["sync_sites"][1:])
    t = extra["trace"]
    checks["trace_kernels"] = all(t["kernels"].values())
    checks["trace_span_range"] = t["span_range_found"]
    checks["no_stall"] = watchdog.stall_count == 0
    on, off = statistics.median(gbps["on"]), statistics.median(gbps["off"])
    line = {"phase": "obs", "cell": name, "records": RECORDS,
            "record_bytes": (KEY_WORDS + VAL_WORDS) * 4,
            "rounds": plan.num_rounds, "split_factor": plan.split_factor,
            "gbps_on": gbps["on"], "gbps_off": gbps["off"],
            "gbps_on_median": on, "gbps_off_median": off,
            "on_over_off": on / off, "spans": len(spans),
            "rollup_lines": len(rollups), "span": summary,
            "job": {k: job_line[k] for k in (
                "wall_s", "stage_idle_s", "stage_count", "spans",
                "dominant_stage", "bottleneck")},
            **extra, "checks": checks}
    report(line)
    return line


def sleep_cycles_per_ms() -> float:
    """The card's ``torch.cuda._sleep`` cycles per millisecond, from a
    short sleep timed with CUDA events."""
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def obs_watchdog_line(root: str) -> dict:
    """The watchdog on a real wait: a 0.2 s watchdog armed around
    ``Event.synchronize()`` on an event recorded after a ~2 s
    ``torch.cuda._sleep``; the stall line must land while the wait is
    still blocked."""
    from sparkrdma_tpu_torch.obs.journal import ExchangeJournal, read_entries
    from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
    from sparkrdma_tpu_torch.obs.watchdog import StallWatchdog

    cycles_per_ms = sleep_cycles_per_ms()
    sink = os.path.join(root, "journal-watchdog.jsonl")
    reg = MetricsRegistry()
    wd = StallWatchdog(0.2, journal=ExchangeJournal(sink, metrics=reg),
                       metrics=reg)
    wd.set_context(shuffle_id=-1)
    ev = torch.cuda.Event()
    torch.cuda._sleep(int(cycles_per_ms * 2000))
    ev.record()
    t0 = time.perf_counter()
    with wd.armed("event_wait", phase="obs"):
        ev.synchronize()
    returned = time.time()
    wait_s = time.perf_counter() - t0
    stalls = [e for e in read_entries(sink) if e.get("kind") == "stall"]
    checks = {"one_stall": len(stalls) == 1 and wd.stall_count == 1,
              "counter": reg.counter("watchdog.stalls").value == 1}
    if stalls:
        st = stalls[0]
        checks["fired_during_wait"] = st["elapsed_s"] < wait_s
        checks["line_before_return"] = st["ts"] < returned
    line = {"phase": "obs", "part": "watchdog",
            "timeout_s": wd.timeout_s, "wait_s": wait_s,
            "cycles_per_ms": cycles_per_ms,
            "stall_elapsed_s": stalls[0]["elapsed_s"] if stalls else None,
            "stall_before_return_s": (returned - stalls[0]["ts"])
            if stalls else None, "checks": checks}
    report(line)
    return line


def obs_plan_lines(root: str) -> dict:
    """M-small's three queries once with the journal on, on the card and
    on the CPU: the same ``{"kind": "plan"}`` lines (every field but
    times and ids) and the same jobs and stages."""
    from sparkrdma_tpu_torch.obs.journal import read_entries
    from sparkrdma_tpu_torch.workloads import tpcds

    got = {}
    for device in ("cuda", "cpu"):
        plans, jobs = [], []
        for val_words in (2, 4):
            sink = os.path.join(root, f"journal-plan-{device}-{val_words}"
                                ".jsonl")
            m = planner_manager(val_words, device=device, metrics_sink=sink)
            if val_words == 2:
                tpcds.run_q64_shape(m)
                with m.job("q95"):
                    tpcds.run_q95_shape(m)
            else:
                tpcds.run_star_suite(m, fact_rows_per_device=16)
            m.stop()
            for e in read_entries(sink):
                if e.get("kind") == "plan":
                    plans.append({k: v for k, v in e.items()
                                  if k not in ("ts", "trace_id")})
                elif e.get("kind") == "job":
                    jobs.append([e["job"], [s["stage"]
                                            for s in e["stages"]]])
        got[device] = (plans, jobs)
    checks = {"plan_lines_equal": got["cuda"][0] == got["cpu"][0],
              "plan_lines_written": len(got["cuda"][0]) > 0,
              "jobs_equal": got["cuda"][1] == got["cpu"][1]}
    line = {"phase": "obs", "part": "plan_lines",
            "plan_lines": len(got["cuda"][0]),
            "rewrites": sorted({e["rewrite"] for e in got["cuda"][0]}),
            "jobs": got["cuda"][1], "checks": checks}
    report(line)
    return line


def obs_cli_line(root: str) -> dict:
    """The reference's stdlib CLIs on the phase's journals, as
    subprocesses: ``shuffle_report.py --json`` counts the spans written,
    ``shuffle_trace.py``'s output loads as JSON."""
    from sparkrdma_tpu_torch.obs.journal import read_journal

    journals = sorted(os.path.join(root, f) for f in os.listdir(root)
                      if f.startswith("journal-") and f.endswith(".jsonl"))
    spans = sum(len(read_journal(j)) for j in journals)
    here = os.path.dirname(os.path.abspath(__file__))
    rep = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "shuffle_report.py"),
         "--json", *journals], capture_output=True, text=True, timeout=300)
    out = os.path.join(root, "trace.json")
    tr = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "shuffle_trace.py"),
         *journals, "-o", out], capture_output=True, text=True, timeout=300)
    checks = {"report_rc": rep.returncode == 0,
              "trace_rc": tr.returncode == 0}
    reported = None
    if rep.returncode == 0:
        reported = json.loads(rep.stdout).get("spans")
        checks["report_counts_spans"] = reported == spans
    if tr.returncode == 0:
        with open(out) as f:
            checks["trace_loads"] = bool(json.load(f).get("traceEvents"))
    line = {"phase": "obs", "part": "cli", "journals": len(journals),
            "spans": spans, "report_spans": reported, "checks": checks}
    if rep.returncode or tr.returncode:
        line["stderr"] = (rep.stderr + tr.stderr)[-2000:]
    report(line)
    return line


def obs_phase() -> list:
    """The data path's records on the card: leg F's and leg B's cells
    with the journal on and off, the watchdog on a real CUDA event wait,
    the planner's lines card against CPU, the reference's CLIs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    lines = [obs_cell("F", root)]
    gc.collect()
    torch.cuda.empty_cache()
    lines.append(obs_cell("B", root))
    gc.collect()
    torch.cuda.empty_cache()
    lines += [obs_watchdog_line(root), obs_plan_lines(root),
              obs_cli_line(root)]
    bad = [f"{ln.get('cell', ln.get('part'))}: {k}" for ln in lines
           for k, v in ln["checks"].items() if not v]
    if bad:
        fail("obs: " + ", ".join(bad))
    return lines


# ---------------------------------------------------------------------
# leg S and the service phase: the multi-tenant shuffle service
# ---------------------------------------------------------------------
#: leg S: ``bench.py``'s ``run_multitenant`` at the port's stacked size:
#: each tenant's TeraSort over 8,388,608 × 100-byte records (1,048,576 a
#: partition, the reference's ``rpd // 2`` of leg B's cell)
S_RECORDS = RECORDS // 2
S_TENANTS = (("tenant_a", 20, 11), ("tenant_b", 21, 12))
#: the service phase's sessions: leg B-small's size (the merge-path and
#: all-to-all sessions, the isolation pair)
SVC_SMALL = 1 << 20
#: the RPC part's rows: 8 partitions × 4096 records of the default W = 4
SVC_RPC_PER_PART = 4096


def s_conf(**kw):
    """Leg S's conf, ``bench.py:452-459``'s with the ring kernel as the
    transport: slots of a tenant's partition, 64 rounds, "fine" classes,
    pack/wide off."""
    from sparkrdma_tpu_torch import ShuffleConf

    slot = S_RECORDS // PARTS
    return ShuffleConf(slot_records=slot, max_rounds=64,
                       max_slot_records=max(1 << 22, 2 * slot),
                       val_words=VAL_WORDS, geometry_classes="fine",
                       pack_sort_min_payload=0, wide_sort_min_payload=0,
                       transport="pallas_ring", **kw)


def fetch_probe(port: int, path: str) -> bytes:
    """One probe request (``GET <path>``), its body read to EOF."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=30) as sk:
        sk.sendall(f"GET {path}\n".encode())
        buf = b""
        while True:
            chunk = sk.recv(1 << 16)
            if not chunk:
                return buf
            buf += chunk


def journal_kinds(path: str) -> dict:
    """Lines of a journal by kind (spans under ``"span"``)."""
    from sparkrdma_tpu_torch.obs.journal import read_entries

    kinds = {}
    for e in read_entries(path, include_rotated=True):
        kinds.setdefault(e.get("kind") or "span", []).append(e)
    return kinds


def tenant_threads(svc, runs: dict) -> dict:
    """Each ``name -> fn(manager)`` in its own thread, on a session of
    ``svc``, all started together; returns ``name -> fn's result`` and
    fails the smoke on any error."""
    import threading

    results, errors = {}, []
    start = threading.Barrier(len(runs))

    def run(name, fn):
        m = svc.open_session(name, getattr(fn, "conf", None))
        try:
            start.wait(timeout=300)
            results[name] = fn(m)
        except Exception as e:
            errors.append(f"{name}: {e!r}")
        finally:
            svc.close_session(m)

    threads = [threading.Thread(target=run, args=kv) for kv in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(results) != len(runs):
        fail(f"tenant threads failed: {errors}")
    return results


def leg_s() -> dict:
    """``run_multitenant`` (``bench.py:434``): two tenants' TeraSorts at
    once through one ``ShuffleService`` on the card, a warm-up and 3
    reads each, device-verified; the journal, heartbeat, telemetry,
    alerts and probe on. Each tenant's output is then held against the
    same tenant run alone in a standalone manager, bit for bit."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    root = tempfile.mkdtemp(prefix="chip_smoke_s_")
    sink = os.path.join(root, "s.jsonl")
    conf = s_conf(metrics_sink=sink, heartbeat_s=1.0,
                  telemetry_window_s=1.0, alert_eval_s=1.0, probe_port=0)

    def tenant(seed, sid):
        def fn(m):
            res, out, totals = run_terasort(
                m, S_RECORDS // PARTS, seed=seed, verify=False,
                device_verify=True, warmup=True, repeats=3, shuffle_id=sid)
            return res, out, totals
        return fn

    kernels = zeroed_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = ShuffleService(conf=conf)
    runs = tenant_threads(svc, {name: tenant(seed, sid)
                                for name, sid, seed in S_TENANTS})
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    health = json.loads(fetch_probe(svc.probe.port, "/health"))
    prom = fetch_probe(svc.probe.port, "/metrics").decode()
    svc.stop()
    e2e = time.perf_counter() - t0
    kinds = journal_kinds(sink)
    rates = {name: runs[name][0].gbps for name, _, _ in S_TENANTS}
    checks = {f"device_verify_{name}": runs[name][0].verified
              for name, _, _ in S_TENANTS}
    same = {}
    for name, sid, seed in S_TENANTS:
        _, out, totals = runs.pop(name)
        solo = ShuffleManager(MeshRuntime(s_conf(), PARTS, device="cuda"))
        _, want, want_totals = run_terasort(
            solo, S_RECORDS // PARTS, seed=seed, verify=False,
            warmup=False, shuffle_id=sid)
        same[name] = bool(torch.equal(out, want)
                          and torch.equal(totals, want_totals))
        del out, totals, want, want_totals
        solo.stop()
        torch.cuda.empty_cache()
    spans = {name: sum(1 for d in kinds.get("span", [])
                       if d.get("tenant") == name) for name, _, _ in S_TENANTS}
    checks.update({f"equal_to_solo_{n}": v for n, v in same.items()})
    checks["spans_per_tenant"] = all(v == 4 for v in spans.values())
    checks["rollups_per_tenant"] = {d.get("tenant") for d in
                                    kinds.get("rollup", [])} == set(same)
    checks["heartbeats"] = len(kinds.get("heartbeat", [])) >= 1
    checks["probe_health"] = health.get("status") in ("ok", "info",
                                                      "warn", "crit")
    checks["probe_metrics"] = "service_admits" in prom
    line = {"leg": "S", "tenants": len(S_TENANTS),
            "records_per_tenant": S_RECORDS, "record_bytes": 100,
            "partitions": PARTS, "transport": "pallas_ring",
            "conf": "bench.py run_multitenant: slot_records 1048576, "
                    "max_rounds 64, fine classes, pack/wide off",
            "per_tenant_gbps": rates, "aggregate_gbps": sum(rates.values()),
            "fairness": min(rates.values()) / max(rates.values()),
            "e2e_s": e2e, "max_memory_gb": peak_gb,
            "journal_lines": {k: len(v) for k, v in sorted(kinds.items())},
            "alert_lines": [(d["rule"], d["event"])
                            for d in kinds.get("alert", [])],
            "health": health.get("status"), "checks": checks,
            "launches": launches}
    report(line)
    if not all(checks.values()):
        fail(f"leg S: {[k for k, v in checks.items() if not v]}")
    if launches["ring_exchange"] <= 0:
        fail("ring_exchange was not launched on leg S")
    return line


def leg_b_conf(**kw):
    """Leg B's conf (``fast_sort``, ``"pow2"``, pack/wide off)."""
    from sparkrdma_tpu_torch import ShuffleConf

    return ShuffleConf(slot_records=SLOT_B, transport="pallas_ring",
                       val_words=VAL_WORDS, key_words=KEY_WORDS,
                       fast_sort=True, fast_sort_run=RUN,
                       pack_sort_min_payload=0, wide_sort_min_payload=0,
                       **kw)


def solo_terasort(conf, seed: int, sid: int, per: int):
    """The same TeraSort alone in a standalone manager: ``(out,
    totals)``."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    _, out, totals = run_terasort(m, per, seed=seed, verify=False,
                                  warmup=False, shuffle_id=sid)
    m.stop()
    return out, totals


def stream_order_check(pool) -> dict:
    """The shared pool across streams on the card: a buffer put back on
    one stream behind ~0.1 s of queued work (a ``torch.cuda._sleep``,
    then a fill with 1) and taken on another stream, where it is filled
    with 2. If the getter's stream did not wait for the putter's, its
    fill would run first and the buffer would end at 1."""
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    waits = pool.stats()["cross_stream_waits"]
    buf = pool.get_shaped((1 << 20,))
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        torch.cuda._sleep(200_000_000)
        buf.fill_(1)
        pool.put_shaped(buf)
    with torch.cuda.stream(s2):
        again = pool.get_shaped((1 << 20,))
        again.fill_(2)
    torch.cuda.synchronize()
    ok = again is buf and bool((again == 2).all())
    pool.put_shaped(again)
    return {"same_buffer_ordered": ok,
            "cross_stream_waits": pool.stats()["cross_stream_waits"] - waits}


def service_sessions_line() -> dict:
    """One session at leg B's conf (the merge-path tail) and one with
    ``ring_fused=False`` (the per-round all-to-all), each at leg
    B-small's size, device-verified, and each equal to the same run
    alone; then the pool's stream order on the card."""
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    svc = ShuffleService(conf=leg_b_conf())
    kernels = zeroed_counters()
    torch.cuda.synchronize()
    got = {}
    for name, fused, sid in (("fused", True, 60), ("a2a", False, 61)):
        m = svc.open_session(f"session_{name}", leg_b_conf(ring_fused=fused))
        res, out, totals = run_terasort(
            m, SVC_SMALL // PARTS, seed=5, verify=False, device_verify=True,
            shuffle_id=sid)
        got[name] = (res.verified, out, totals, fused, sid)
        svc.close_session(m)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    checks = {}
    for name, (verified, out, totals, fused, sid) in got.items():
        want, want_totals = solo_terasort(leg_b_conf(ring_fused=fused), 5,
                                          sid, SVC_SMALL // PARTS)
        checks[f"{name}_verified"] = verified
        checks[f"{name}_equal_to_solo"] = bool(
            torch.equal(out, want) and torch.equal(totals, want_totals))
    stream = stream_order_check(svc.runtime.pool)
    checks["stream_order"] = stream["same_buffer_ordered"] and \
        stream["cross_stream_waits"] == 1
    svc.stop()
    for k in ("merge_stage", "ring_exchange", "ring_all_to_all"):
        checks[f"{k}_launched"] = launches[k] > 0
    line = {"phase": "service", "part": "sessions",
            "records": SVC_SMALL, "launches": launches, "stream": stream,
            "checks": checks}
    report(line)
    return line


def service_isolation_line(root: str) -> dict:
    """Tenant A's session fails its first dispatch while tenant B reads
    at the same time: B's plane injects nothing and B's spans show no
    retry and no fault event; A's books balance (injections = retries in
    its spans); both equal their solo runs."""
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    sink = os.path.join(root, "isolation.jsonl")
    svc = ShuffleService(conf=leg_b_conf(metrics_sink=sink))
    seeds = {"noisy": (6, 62), "clean": (7, 63)}

    def tenant(name, conf):
        seed, sid = seeds[name]

        def fn(m):
            res, out, totals = run_terasort(
                m, SVC_SMALL // PARTS, seed=seed, verify=False,
                device_verify=True, shuffle_id=sid)
            return res.verified, out, totals, m.faults
        fn.conf = conf
        return fn

    kernels = zeroed_counters()
    res = tenant_threads(svc, {
        "noisy": tenant("noisy", leg_b_conf(
            metrics_sink=sink,
            fault_spec="exchange.dispatch:fail@attempt<1")),
        "clean": tenant("clean", leg_b_conf(metrics_sink=sink))})
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    svc.stop()
    spans = journal_kinds(sink).get("span", [])
    retries = {t: sum(d["retry_count"] for d in spans if d["tenant"] == t)
               for t in seeds}
    injected = {t: res[t][3].injected_total() for t in seeds}
    fault_events = {t: sum(e["name"] == "fault:injected" for d in spans
                           if d["tenant"] == t for e in d["events"])
                    for t in seeds}
    checks = {"noisy_books_balance": injected["noisy"] == 1
              == retries["noisy"] == fault_events["noisy"],
              "clean_untouched": injected["clean"] == retries["clean"]
              == fault_events["clean"] == 0}
    for t, (seed, sid) in seeds.items():
        want, want_totals = solo_terasort(leg_b_conf(), seed, sid,
                                          SVC_SMALL // PARTS)
        checks[f"{t}_verified"] = res[t][0]
        checks[f"{t}_equal_to_solo"] = bool(
            torch.equal(res[t][1], want) and torch.equal(res[t][2],
                                                         want_totals))
    line = {"phase": "service", "part": "isolation", "records": SVC_SMALL,
            "injected": injected, "retries": retries,
            "fault_events": fault_events, "launches": launches,
            "checks": checks}
    report(line)
    return line


def service_rpc_lines(root: str) -> list:
    """An ``RpcClient`` on localhost against the daemon on the card at 8 ×
    4096 records: hello, open_session, register_shuffle, write, read,
    read with a checkpoint and resume_read, each reply's rows equal to
    the in-process read and to the same run on the CPU; one injected
    ``rpc.recv`` corruption retried with the books balanced; a 0.5 s
    lease without a heartbeat expiring (its session dropped, its
    tenant's charges back to 0). Then the probe: its Prometheus text and
    health routes, and the reference's ``scripts/shuffle_top.py --once
    --connect <probe> --rpc <rpc>`` as a subprocess, which must render
    both tenants and the lease table."""
    from sparkrdma_tpu_torch import MeshRuntime, faults
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.service import RpcClient, ShuffleService

    sink = os.path.join(root, "rpc.jsonl")
    conf = default_conf(metrics_sink=sink, rpc_port=0, probe_port=0,
                        heartbeat_s=3600.0,
                        spill_dir=os.path.join(root, "rpc_ck"))
    rows = np.random.default_rng(21).integers(
        0, 2**32, size=(PARTS * SVC_RPC_PER_PART, conf.record_words),
        dtype=np.uint32)
    kernels = zeroed_counters()
    svc = ShuffleService(conf=conf)
    c = RpcClient.from_conf(conf, port=svc.rpc.port, client_id="smoke")
    c.hello()
    c.start_heartbeat()
    s = c.open_session("tenant_a")
    c.register_shuffle(s, 801, 0)
    c.write(s, 801, rows)
    got = [c.read(s, 801), c.read(s, 801, checkpoint=True)]
    resumed = c.resume_read(s, 801)
    got.append((resumed["rows"], resumed["totals"]))

    def inproc(service, sid):
        m = service.open_session("tenant_b")
        h = m.register_shuffle(sid, PARTS,
                               hash_partitioner(PARTS, m.conf.key_words))
        m.get_writer(h).write(m.runtime.shard_records(rows)).stop(True)
        out, totals = m.get_reader(h).read()
        want = (out.cpu().numpy().view(np.uint32).copy(),
                totals.cpu().numpy().copy())
        m.unregister_shuffle(sid)
        service.close_session(m)
        return want

    want = inproc(svc, 802)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    cpu = ShuffleService(MeshRuntime(default_conf(), PARTS, device="cpu"))
    want_cpu = inproc(cpu, 802)
    cpu.stop()
    checks = {"rows_equal_inproc_and_cpu": all(
        np.array_equal(np.asarray(r, np.uint32), want[0])
        and np.array_equal(np.asarray(t), want[1]) for r, t in got)
        and np.array_equal(want[0], want_cpu[0])
        and np.array_equal(want[1], want_cpu[1]),
        "resume_adopted": sorted(resumed["adopted"]) ==
        ["rpc801:cols", "rpc801:totals"]}
    # one corrupted reply frame, in this thread's plane only
    recovered = faults.recovery_total()
    plane = faults.FaultPlane("rpc.recv:corrupt@attempt<1")
    c2 = RpcClient(port=svc.rpc.port, client_id="chaos", retry_ms=2.0,
                   deadline_s=60.0)
    with faults.scoped_plane(plane):
        c2.hello()
    checks["corruption_retried_books_balance"] = \
        plane.injected_total() == 1 == c2.stats["retries"] + \
        faults.recovery_total() - recovered
    c2.close()
    # a 0.5 s lease, no heartbeat: a daemon of its own, so that no slow
    # call of the other clients races its reaper
    lsink = os.path.join(root, "lease.jsonl")
    lconf = default_conf(metrics_sink=lsink, rpc_port=0, lease_s=0.5,
                         spill_dir=os.path.join(root, "lease_ck"))
    lsvc = ShuffleService(conf=lconf)
    c3 = RpcClient(port=lsvc.rpc.port, client_id="lapsed", retry_ms=2.0,
                   deadline_s=60.0)
    c3.hello()
    s3 = c3.open_session("tenant_c")
    c3.register_shuffle(s3, 803, 0)
    c3.write(s3, 803, rows)
    c3.read(s3, 803, checkpoint=True)
    c3.resume_read(s3, 803)
    c3.admit("tenant_c", 1)
    held = lsvc.usage_by_tenant()["tenant_c"]
    t0 = time.perf_counter()
    while (lsvc.metrics.counter("service.leases_expired").value < 1
           and time.perf_counter() - t0 < 30):
        time.sleep(0.05)
    expire_s = time.perf_counter() - t0
    lease_events = [d["event"] for d in journal_kinds(lsink).get("lease", [])]
    checks["lease_expired"] = (
        lsvc.stats()["sessions"] == 0
        and lsvc.stats()["admission"]["active"] == 0
        and held["host"] + held["disk"] > 0
        and lsvc.usage_by_tenant()["tenant_c"] ==
        {"hbm": 0, "host": 0, "disk": 0}
        and lease_events == ["grant", "adopt", "expire"])
    lsvc.stop()
    rpc_line = {"phase": "service", "part": "rpc",
                "records": PARTS * SVC_RPC_PER_PART,
                "record_words": conf.record_words, "held_before_expiry": held,
                "expired_after_s": expire_s, "lease_events": lease_events,
                "launches": launches, "checks": checks}
    report(rpc_line)
    # the probe and the reference's monitor
    svc.heartbeat.beat()
    prom = fetch_probe(svc.probe.port, "/metrics").decode()
    health = json.loads(fetch_probe(svc.probe.port, "/health"))
    here = os.path.dirname(os.path.abspath(__file__))
    top = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "shuffle_top.py"),
         "--once", "--connect", f"127.0.0.1:{svc.probe.port}",
         "--rpc", f"127.0.0.1:{svc.rpc.port}"],
        capture_output=True, text=True, timeout=120)
    tenant_rows = [ln for ln in top.stdout.splitlines()
                   if ln.startswith(("tenant_a", "tenant_b"))]
    pchecks = {"prometheus": "service_rpc_requests" in prom
               and "service_sessions_opened" in prom,
               "health": health.get("status") == "ok",
               "shuffle_top_rc": top.returncode == 0,
               "shuffle_top_tenants": {ln.split()[0] for ln in tenant_rows}
               == {"tenant_a", "tenant_b"},
               "shuffle_top_leases": "leases @ 127.0.0.1:" in top.stdout
               and any(ln.startswith("smoke") for ln in
                       top.stdout.splitlines())}
    c.close()
    svc.stop()
    probe_line = {"phase": "service", "part": "probe",
                  "prometheus_lines": len(prom.splitlines()),
                  "health": health, "shuffle_top_lines":
                  len(top.stdout.splitlines()), "checks": pchecks}
    if top.returncode:
        probe_line["stderr"] = top.stderr[-2000:]
    report(probe_line)
    return [rpc_line, probe_line]


def service_alerts_line(root: str) -> dict:
    """An H-small-sized out-of-core run through a session, twice, with a
    host tier of four chunks: the tiered store spills, and
    ``spill_storm`` fires after ``alert_fire_breaches`` (2) breaching
    windows and resolves after ``alert_resolve_windows`` (2) clean ones.
    The telemetry and the evaluator are driven window by window (their
    threads parked at a 3600 s cadence); the journal holds the fire and
    resolve lines, rollup and heartbeat lines, and the reference's
    ``shuffle_report.py --json --doctor`` reads it."""
    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.obs.metrics import global_registry
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    w, chunk = KEY_WORDS + VAL_WORDS, H_SMALL_CHUNK
    sink = os.path.join(root, "alerts.jsonl")
    slot = max(4096, chunk)
    conf = ShuffleConf(
        slot_records=slot, max_rounds=64,
        max_slot_records=max(1 << 22, 2 * slot), val_words=VAL_WORDS,
        geometry_classes="fine", transport="pallas_ring",
        spill_dir=os.path.join(root, "ooc_spill"),
        spill_tier_dir=os.path.join(root, "ooc_tier"),
        spill_tier_host_bytes=4 * w * chunk * 4, spill_tier_prefetch=2,
        metrics_sink=sink, heartbeat_s=3600.0, telemetry_window_s=3600.0,
        telemetry_history=2, alert_eval_s=3600.0, alert_fire_breaches=2,
        alert_resolve_windows=2)
    cols = np.random.default_rng(15).integers(
        0, 2**32, size=(w, H_CHUNKS * chunk), dtype=np.uint32)
    svc = ShuffleService(conf=conf)
    m = svc.open_session("tenant_ooc")
    spill = global_registry().counter("store.spill_bytes")
    spill.inc(0)
    kernels = zeroed_counters()
    now = time.time()
    svc.telemetry.sample(now=now)
    events, spilled = [], []
    for k in range(conf.alert_fire_breaches):
        before = spill.value
        run_tiered_terasort(m, cols, chunk, collect=False,
                            shuffle_id_base=9500 + 100 * k)
        spilled.append(spill.value - before)
        now += 1.0
        svc.telemetry.sample(now=now)
        events += [(d["rule"], d["event"], k + 1)
                   for d in svc.alerts.evaluate_once(now=now)]
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items()}
    health = svc.alerts.health()
    for k in range(conf.alert_resolve_windows):
        now += 1.0
        svc.telemetry.sample(now=now)
        events += [(d["rule"], d["event"], k + 1)
                   for d in svc.alerts.evaluate_once(now=now)]
    svc.heartbeat.beat()
    svc.close_session(m)
    svc.stop()
    kinds = journal_kinds(sink)
    here = os.path.dirname(os.path.abspath(__file__))
    rep = subprocess.run(
        [sys.executable, os.path.join(here, "scripts", "shuffle_report.py"),
         "--json", "--doctor", sink], capture_output=True, text=True,
        timeout=300)
    reported = json.loads(rep.stdout) if rep.returncode == 0 else {}
    checks = {
        "spilled_each_run": all(b > 0 for b in spilled),
        "fired_then_resolved": events == [
            ("spill_storm", "fired", conf.alert_fire_breaches),
            ("spill_storm", "resolved", conf.alert_resolve_windows)],
        "health_warn_while_active": health["status"] == "warn",
        "journal_alert_lines": [d["event"] for d in kinds.get("alert", [])]
        == ["fired", "resolved"],
        "journal_rollups": len(kinds.get("rollup", [])) >= 1,
        "journal_heartbeats": len(kinds.get("heartbeat", [])) >= 1,
        "report_rc": rep.returncode == 0,
        "report_reads_rollups": bool(reported.get("rollups")),
        "report_doctor_sees_alert": any(
            "spill_storm" in ln for ln in reported.get("doctor", []))}
    line = {"phase": "service", "part": "alerts", "chunks": H_CHUNKS,
            "chunk_records": chunk, "spill_bytes": spilled,
            "events": events, "health_while_active": health,
            "journal_lines": {k: len(v) for k, v in sorted(kinds.items())},
            "launches": launches, "checks": checks}
    if rep.returncode:
        line["stderr"] = rep.stderr[-2000:]
    report(line)
    return line


def service_phase() -> dict:
    """The multi-tenant service on the card: sessions, isolation, RPC,
    probe, alerts. Returns the phase's launch counts (the sum of its
    parts', each zeroed just before its part) for the kernels line."""
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    lines = [service_sessions_line(), service_isolation_line(root)]
    lines += service_rpc_lines(root)
    lines.append(service_alerts_line(root))
    bad = [f"{ln['part']}: {k}" for ln in lines
           for k, v in ln["checks"].items() if not v]
    if bad:
        fail("service: " + ", ".join(bad))
    launches = {k: sum(ln.get("launches", {}).get(k, 0) for ln in lines)
                for k in lines[0]["launches"]}
    return {"phase": "service", "launches": launches}


# --- leg T and phase: distributed (shuffles across processes) -----------
#: leg T: leg B's records (seed 0) over two worker processes on one card,
#: on each transport across processes
T_WORKERS = 2
T_READS = 3
T_TRANSPORTS = ("xla", "hierarchical", "pallas_ring")
#: what leg T's line gives of each read, worker by worker
T_READ_KEYS = ("a2a_s", "merge_stage", "ring_push", "moves", "handshake_s",
               "launch_wait_s", "window_gb", "peak_gb")
#: phase: distributed: the records of its runs, and its hierarchies
DIST_RECORDS = 1 << 20
DIST_HOSTS = (1, 2, 4)
#: phase: distributed's streaming geometry for the ring: 4096-record
#: slots, one round in flight (a plan of 4-5 rounds streams)
DIST_STREAM_KNOBS = dict(slot_records=4096, max_rounds_in_flight=1)
#: moves timed for the handshake's host cost, at a tiny push shape
PUSH_HANDSHAKE_MOVES = 200
DIST_SEED, DIST_CKPT_SID = 5, 97
#: a worker pair past this is killed and fails the smoke
DIST_WORKER_S = 600
#: leg U's verbs, in order (the first one is also the warm-up)
U_VERBS = ("from_host_rows", "sort_by_key", "reduce_by_key", "distinct",
           "count_by_key", "filter_repartition")
#: phase: distributed's input feed: 2^22 records in 4 chunks
DIST_STREAM_RECORDS, DIST_STREAM_CHUNKS = 1 << 22, 4
#: leg V-service: S's two tenants (name, seed, shuffle id) at once in each
#: of T's workers, each a warm-up and ``V_READS`` reads of its TeraSort
V_TENANTS = (("tenant_a", 11, 41), ("tenant_b", 12, 42))
#: each tenant's transport: one on the ring (its own window), one on
#: ``"xla"`` (``all_to_all_single`` on its own scope's gloo group)
V_TRANSPORTS = {"tenant_a": "pallas_ring", "tenant_b": "xla"}
V_READS = 3
#: leg V-plan: the planner's plans on leg U's loaded dataset
V_PLANS = ("filter_sort", "reduce_sum", "select_repartition16")
#: phase: distributed's segment checkpoint and RPC shuffle ids
DIST_SEG_SID, DIST_RPC_SID = 98, 99
#: where the reference's RPC read fails across processes
RPC_READ_LINE = "sparkrdma_tpu/service/rpc.py:478"
#: the entry points the reference cannot run across processes either:
#: the line where it fails there (most read a global array on the host)
DIST_REFERENCE_LINES = {
    "count": "sparkrdma_tpu/api/dataset.py:575",
    "to_host_rows": "sparkrdma_tpu/api/dataset.py:531",
    "collect_rows": "sparkrdma_tpu/api/dataset.py:1165",
    "group_by_key": "sparkrdma_tpu/api/dataset.py:1015",
    "cogroup": "sparkrdma_tpu/api/dataset.py:1064",
    "join_count": "sparkrdma_tpu/api/dataset.py:1086",
    "join": "sparkrdma_tpu/api/dataset.py:1122",
    "sort_by_key of an exchange's output": "sparkrdma_tpu/api/dataset.py:660",
    "to_host_payloads of an exchange's output":
        "sparkrdma_tpu/api/pipeline.py:245",
    "run_streaming_terasort with spill_dir":
        "sparkrdma_tpu/workloads/streaming.py:139",
    "run_tiered_terasort": "sparkrdma_tpu/workloads/streaming.py:331",
    "run_pagerank": "sparkrdma_tpu/workloads/pagerank.py:207",
    "run_hash_join": "sparkrdma_tpu/workloads/join.py:254",
    "run_als": "sparkrdma_tpu/workloads/als.py:272",
    "run_q64_shape": "sparkrdma_tpu/api/dataset.py:531",
    "run_q95_shape": "sparkrdma_tpu/workloads/tpcds.py:312",
    "run_star_suite": "sparkrdma_tpu/api/dataset.py:531",
    "read_partition": "sparkrdma_tpu/api/shuffle_manager.py:552",
    "read_view": "sparkrdma_tpu/api/shuffle_manager.py:582",
    "a plan's reuse hit": "sparkrdma_tpu/plan/executor.py:307",
    "a plan's sink": "sparkrdma_tpu/api/dataset.py:531",
    "a plan's broadcast join": "sparkrdma_tpu/api/dataset.py:531",
    "a plan's group_by_key": "sparkrdma_tpu/api/dataset.py:1015",
    "ShuffleService with admission_slots > 0":
        "sparkrdma_tpu/service/admission.py:79",
}


def part_digests(out: torch.Tensor, totals: torch.Tensor, cap: int) -> list:
    """An in-order 64-bit digest of each stacked partition's valid words
    (``[W, totals[d]]``, word-major): every word is mixed with its
    position, so a moved, lost or changed word changes the digest.
    Integer arithmetic mod 2^64, so it is the same in any process."""
    digests = []
    for d, t in enumerate(totals.tolist()):
        u = out[:, d * cap:d * cap + t].to(torch.int64) & 0xFFFFFFFF
        pos = torch.arange(u.numel(), device=u.device).reshape(u.shape)
        x = (u + 1) * (2 * pos + 1) * 0x7E3779B97F4A7C15
        digests.append(int((x ^ (x >> 29)).sum()))
    return digests


def dist_conf(transport: str, **kw):
    """Leg B's conf (merge-path tail, ``"pow2"``, pack/wide off) on a
    transport that runs across processes."""
    return leg_b_conf().replace(transport=transport, **kw)


def dist_transports() -> list:
    """``(name, transport, conf kwargs)`` of the phase: the flat
    transport, the hierarchy at each H, and the ring (fused, and a push a
    round) in the fused regime and the streaming one."""
    return ([("xla", "xla", {})]
            + [(f"hierarchical{h}", "hierarchical", {"hierarchy_hosts": h})
               for h in DIST_HOSTS]
            + [(f"ring{'' if fused else '_per_round'}"
                f"{'_stream' if stream else ''}", "pallas_ring",
                {"ring_fused": fused, **(DIST_STREAM_KNOBS if stream
                                         else {})})
               for stream in (False, True) for fused in (True, False)])


def dist_refusals(m) -> dict:
    """The entry points that run in one process only, each driven with a
    runtime across processes: whether each raised as it should, naming
    ROADMAP A.12 and the line where the reference cannot run it there
    either (``DIST_REFERENCE_LINES``)."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.api.serde import payload_words
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.plan import LogicalPlan, PlanExecutor
    from sparkrdma_tpu_torch.service.daemon import ShuffleService
    from sparkrdma_tpu_torch.workloads import (als, join, pagerank,
                                               streaming, tpcds)

    cols = np.zeros((4, 64), np.uint32)
    rt = m.runtime
    h = m.register_shuffle(DIST_CKPT_SID + 1, PARTS, hash_partitioner(PARTS))
    rows = np.ones((PARTS * 2, m.conf.record_words), np.uint32)
    spill = os.path.join(tempfile.gettempdir(), "never-written")

    def ds():
        return Dataset.from_host_rows(m, rows)

    def exchanged(d):
        d.exchanged = True       # as a verb marks its result
        return d

    def payloads():
        mp = ShuffleManager(MeshRuntime(
            dist_conf("xla").replace(val_words=payload_words(8)), PARTS,
            device="cuda"))
        try:
            return exchanged(Dataset.from_host_payloads(
                mp, rows[:, :KEY_WORDS], [b"x"] * len(rows),
                8)).to_host_payloads()
        finally:
            mp.stop()

    def memo_hit():
        ex = PlanExecutor(m)
        plan = LogicalPlan.dataset(ds()).repartition()
        ex.run(plan)
        ex.run(plan)

    def plan_of(build):
        return lambda: PlanExecutor(m).run(build(LogicalPlan.dataset(ds())))

    calls = {
        "count": lambda: ds().count,
        "to_host_rows": lambda: ds().to_host_rows(),
        "collect_rows": lambda: Dataset.collect_rows(ds().records,
                                                     ds().totals),
        "group_by_key": lambda: ds().group_by_key(),
        "cogroup": lambda: ds().cogroup(ds()),
        "join_count": lambda: ds().join_count(ds()),
        "join": lambda: ds().join(ds()),
        "sort_by_key of an exchange's output":
            lambda: exchanged(ds()).sort_by_key(),
        "to_host_payloads of an exchange's output": payloads,
        "run_pagerank": lambda: pagerank.run_pagerank(
            rt, np.zeros((8, 2), np.int64), 8),
        "run_hash_join": lambda: join.run_hash_join(m, 8, 8),
        "run_als": lambda: als.run_als(rt, np.zeros((8, 3)), 8, 8),
        "run_q64_shape": lambda: tpcds.run_q64_shape(m),
        "run_q95_shape": lambda: tpcds.run_q95_shape(m),
        "run_star_suite": lambda: tpcds.run_star_suite(m),
        "run_streaming_terasort with spill_dir":
            lambda: streaming.run_streaming_terasort(
                m, ArrayChunkSource(cols, 32), spill_dir=spill),
        "run_tiered_terasort": lambda: streaming.run_tiered_terasort(
            m, cols, 32),
        "read_partition": lambda: m.get_reader(h).read_partition(0),
        "read_view": lambda: m.get_reader(h).read_view(),
        "a plan's reuse hit": memo_hit,
        "a plan's sink": plan_of(lambda p: p.repartition().sink()),
        "a plan's broadcast join": plan_of(
            lambda p: p.join(LogicalPlan.dataset(ds()))),
        "a plan's group_by_key": plan_of(lambda p: p.group_by_key()),
        "ShuffleService with admission_slots > 0": lambda: ShuffleService(
            conf=dist_conf("xla", admission_slots=1), device="cuda"),
    }
    said = {}
    for name, call in calls.items():
        want = ["A.12", f"as the reference: `{DIST_REFERENCE_LINES[name]}`"]
        try:
            call()
        except NotImplementedError as e:
            said[name] = all(w in str(e) for w in want)
        else:
            said[name] = False
    m.unregister_shuffle(DIST_CKPT_SID + 1)
    return said


def window_stats(coll=None) -> dict:
    """The ring window of scope ``coll`` (None: the default group's) in
    this process: its moves, the handshake's host seconds, the push
    waits and its size; zeros where none is open."""
    from sparkrdma_tpu_torch.exchange.windows import open_windows

    name = None if coll is None else coll.name
    for w in open_windows():
        if w.coll.name == name:
            return {"moves": w.moves, "handshake_s": w.handshake_s,
                    "launch_wait_s": w.launch_wait_s,
                    "window_gb": w.nbytes / 1e9}
    return {"moves": 0, "handshake_s": 0.0, "launch_wait_s": 0.0,
            "window_gb": 0.0}


def t_worker(rank: int, backend: str) -> dict:
    """Leg T in one worker: for each transport, this process's share of
    leg B's records, a warm-up read and ``T_READS`` timed reads (the
    processes meet at a barrier before each), each with its wall time,
    its seconds in ``all_to_all_single``, the merge-path and push
    launches, the ring window's moves and handshake seconds, and the
    peak memory; then each local partition's totals and digest."""
    import torch.distributed as dist

    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    a2a_s = timed_all_to_all()
    per = RECORDS // PARTS
    out_lines = {}
    for name, conf in (("xla", dist_conf("xla")),
                       ("hierarchical", dist_conf("hierarchical")),
                       ("pallas_ring", dist_conf("pallas_ring"))):
        m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
        rt = m.runtime
        records = random_records(RECORDS, conf.record_words, 0, rt.device)
        first = rt.local_device_indices()[0] * per
        records = records[:, first:first + rt.local_partitions * per].clone()
        torch.cuda.empty_cache()
        spl = compute_splitters(make_sampler(
            PARTS, KEY_WORDS, 256, 0, runtime=rt)(records), PARTS)
        h = m.register_shuffle(1, PARTS, range_partitioner(spl, KEY_WORDS))
        kernels = zeroed_counters()
        plan = m.get_writer(h).write(records).stop()
        plan_passes = kernels["partition_counts"].launches
        reader = m.get_reader(h, key_ordering=True)
        reads = []
        for i in range(T_READS + 1):
            kernels = zeroed_counters()
            torch.cuda.reset_peak_memory_stats()
            a2a_s.clear()
            dist.barrier()
            torch.cuda.synchronize()
            w0 = window_stats()
            t0 = time.perf_counter()
            out, totals = reader.read()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            w1 = window_stats()
            if i:      # the first read is the warm-up
                reads.append({
                    "wall_s": wall, "a2a_s": a2a_s[None],
                    "merge_stage": kernels["merge_stage"].launches,
                    "merge_splits": kernels["merge_splits"].launches,
                    "ring_push": kernels["ring_push"].launches,
                    "moves": w1["moves"] - w0["moves"],
                    "handshake_s": w1["handshake_s"] - w0["handshake_s"],
                    "launch_wait_s": (w1["launch_wait_s"]
                                      - w0["launch_wait_s"]),
                    "window_gb": w1["window_gb"],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        out_lines[name] = {
            "reads": reads, "partition_counts": plan_passes,
            "rounds": plan.num_rounds,
            "out_capacity": plan.out_capacity,
            "totals": totals.tolist(),
            "digests": part_digests(out, totals, plan.out_capacity),
            "staged": m.metrics.counter(
                "transport.hier.staged_exchanges").value,
            "local": list(rt.local_device_indices()), "backend": backend}
        del out, totals, records, reader
        m.stop()
        torch.cuda.empty_cache()
    timed_all_to_all(off=True)
    return out_lines


_PLAIN_A2A = []


def timed_all_to_all(off: bool = False) -> dict:
    """Wrap the moves across processes (``Collectives.all_to_all_single``,
    the default group's and a session's scope's alike) so that each
    call's seconds (the card idle before and after) add to the returned
    dict under the scope's name (None: the default group's); ``off`` puts
    the plain one back."""
    import collections

    from sparkrdma_tpu_torch.runtime.distributed import Collectives

    if not _PLAIN_A2A:
        _PLAIN_A2A.append(Collectives.all_to_all_single)
    plain = _PLAIN_A2A[0]
    if off:
        Collectives.all_to_all_single = plain
        return {}
    spent = collections.defaultdict(float)

    def timed_a2a(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plain(self, *a, **kw)
        torch.cuda.synchronize()
        spent[self.name] += time.perf_counter() - t0
        return res

    Collectives.all_to_all_single = timed_a2a
    return spent


def u_verbs(ds) -> dict:
    """Leg U's verbs on a loaded dataset (``from_host_rows`` is the
    loader's, called with the rows)."""
    return {"sort_by_key": ds.sort_by_key,
            "reduce_by_key": lambda: ds.reduce_by_key("sum"),
            "distinct": ds.distinct,
            "count_by_key": ds.count_by_key,
            "filter_repartition": lambda: ds.filter(
                lambda r: r[2] == 0, cache_key=("w2", 0)).repartition()}


def u_run(m, rows: np.ndarray, sync=None, a2a_s=None,
          warm: bool = True) -> dict:
    """Leg U's verbs in order on manager ``m``: per verb its wall
    seconds, merge-path launches, peak memory (and seconds in
    ``all_to_all_single`` with ``a2a_s``), its stacked partitions'
    totals and digests; ``sync`` runs before each verb (the processes'
    barrier). With ``warm`` the first verb runs once more first, as the
    warm-up. Then leg V-plan's plans on the loaded dataset, the same
    for each (under ``"plans"``)."""
    from sparkrdma_tpu_torch.api.dataset import Dataset

    out = {}
    ds = None
    for i, name in enumerate(("warm-up",) + U_VERBS):
        if not (i or warm):
            continue
        kernels = zeroed_counters()
        torch.cuda.reset_peak_memory_stats()
        if a2a_s is not None:
            a2a_s.clear()
        if sync is not None:
            sync()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i <= 1:
            ds = None
            res = ds = Dataset.from_host_rows(m, rows)
        else:
            res = u_verbs(ds)[name]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not i:
            continue
        cap = res.records.shape[1] // m.runtime.local_partitions
        out[name] = {"wall_s": wall,
                     "a2a_s": a2a_s[None] if a2a_s is not None else None,
                     "merge_stage": kernels["merge_stage"].launches,
                     "merge_splits": kernels["merge_splits"].launches,
                     "partition_counts":
                         kernels["partition_counts"].launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "totals": res.totals.tolist(),
                     "digests": part_digests(res.records, res.totals, cap)}
        if res is not ds:
            del res
    out["plans"] = v_plan_run(m, ds, sync, a2a_s)
    del ds
    return out


def v_plans(m, ds) -> dict:
    """Leg V-plan's plans over leg U's loaded dataset ``ds`` (nothing is
    loaded again): ``filter`` (the low key word not 7 mod 8) then
    ``sort_by_key``; ``reduce_by_key("sum")`` (the combine hoist); and,
    over the same records under a schema of 23 ``uint32`` payload
    columns, ``select`` of two then ``repartition(16)``."""
    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.api.serde import RowSchema
    from sparkrdma_tpu_torch.plan import LogicalPlan

    schema = RowSchema([(f"w{j}", "uint32") for j in range(VAL_WORDS)])
    cols = Dataset(m, ds.records, schema=schema)
    src = LogicalPlan.dataset(ds)
    # the filter's filler rows all sort to the last partition: a filter
    # that drops few rows keeps that partition, and the padded send of
    # every pair, near the others' (half the rows, as an even-id filter
    # drops under these keys, took 37.7 GB a worker on the H100)
    return {"filter_sort": src.filter(lambda r: (r[1] & 7) != 7,
                                      cache_key=("w1", "not 7 mod 8"))
            .sort_by_key(),
            "reduce_sum": src.reduce_by_key("sum"),
            "select_repartition16": LogicalPlan.dataset(cols).select(
                "w0", "w1").repartition(16)}


def v_plan_run(m, ds, sync=None, a2a_s=None) -> dict:
    """Leg V-plan's plans, each through a fresh ``PlanExecutor.run``: as
    :func:`u_run` keeps each verb, and the combine hoist's plan lines."""
    from sparkrdma_tpu_torch.plan import PlanExecutor

    lines = []
    emit = m.journal.emit_raw
    m.journal.emit_raw = lambda line: (lines.append(line), emit(line))
    out = {}
    try:
        for name, plan in v_plans(m, ds).items():
            kernels = zeroed_counters()
            torch.cuda.reset_peak_memory_stats()
            if a2a_s is not None:
                a2a_s.clear()
            if sync is not None:
                sync()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = PlanExecutor(m).run(plan, job_name=f"v_{name}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cap = res.records.shape[1] // m.runtime.local_partitions
            out[name] = {
                "wall_s": wall,
                "a2a_s": a2a_s[None] if a2a_s is not None else None,
                "merge_stage": kernels["merge_stage"].launches,
                "merge_splits": kernels["merge_splits"].launches,
                "partition_counts": kernels["partition_counts"].launches,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "totals": res.totals.tolist(),
                "digests": part_digests(res.records, res.totals, cap)}
            del res
    finally:
        m.journal.emit_raw = emit
    out["hoist"] = [ln["detail"] for ln in lines
                    if ln.get("rewrite") == "combine_hoist"]
    return out


def v_service_worker(out_dir: str, rank: int) -> dict:
    """Leg V-service in one worker: one ``ShuffleService`` on the card
    with the live layer on (leg S's knobs), over leg B's conf; S's two
    tenants in threads at once, each in its session (its own collective
    scope) on its transport of ``V_TRANSPORTS`` (the ring's tenant in
    its own window, the other through ``all_to_all_single`` on its
    scope's group), each its TeraSort of ``S_RECORDS`` (this process's
    share): the
    sample, the map stage, a warm-up and ``V_READS`` reads, each read's
    wall seconds and its partitions' totals and digests; per tenant the
    seconds in ``all_to_all_single`` (the card synced around each call;
    the ring's moves go around it) and its window's moves and handshake
    seconds; the worker's merge-path and push launches and peak
    memory."""
    import torch.distributed as dist

    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    sink = os.path.join(out_dir, f"v-service-{rank}.jsonl")
    conf = dist_conf("pallas_ring", metrics_sink=sink, heartbeat_s=1.0,
                     telemetry_window_s=1.0, alert_eval_s=1.0, probe_port=0)
    per = S_RECORDS // PARTS

    def tenant(name, seed, sid):
        def fn(m):
            rt = m.runtime
            first = rt.local_device_indices()[0] * per
            records = random_records(S_RECORDS, conf.record_words, seed,
                                     rt.device)[
                :, first:first + rt.local_partitions * per].clone()
            spl = compute_splitters(make_sampler(
                PARTS, KEY_WORDS, 256, seed, runtime=rt,
                collectives=m.collectives)(records), PARTS)
            h = m.register_shuffle(sid, PARTS,
                                   range_partitioner(spl, KEY_WORDS))
            plan = m.get_writer(h).write(records).stop()
            del records
            reader = m.get_reader(h, key_ordering=True)
            reads = []
            for i in range(V_READS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, totals = reader.read()
                torch.cuda.synchronize()
                reads.append({"wall_s": time.perf_counter() - t0,
                              "warm_up": i == 0,
                              "totals": totals.tolist(),
                              "digests": part_digests(out, totals,
                                                      plan.out_capacity)})
                del out, totals
            m.unregister_shuffle(sid)
            return {"reads": reads, "scope": m.collectives.name,
                    "transport": m.conf.transport,
                    "window": window_stats(m.collectives)}
        fn.conf = conf.replace(transport=V_TRANSPORTS[name])
        return fn

    a2a_s = timed_all_to_all()
    kernels = zeroed_counters()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    svc = ShuffleService(conf=conf, device="cuda")
    try:
        runs = tenant_threads(svc, {name: tenant(name, seed, sid)
                                    for name, seed, sid in V_TENANTS})
    finally:
        svc.stop()
        timed_all_to_all(off=True)
    e2e = time.perf_counter() - t0
    for name, run in runs.items():
        run["a2a_s"] = a2a_s[run["scope"]]
    kinds = journal_kinds(sink)
    res = {"tenants": runs, "e2e_s": e2e,
           "merge_stage": kernels["merge_stage"].launches,
           "merge_splits": kernels["merge_splits"].launches,
           "ring_push": kernels["ring_push"].launches,
           "partition_counts": kernels["partition_counts"].launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "journal_lines": {k: len(v) for k, v in sorted(kinds.items())}}
    gc.collect()
    torch.cuda.empty_cache()
    return res


def u_worker() -> dict:
    """Leg U in one worker: leg K's records, built from the seed, and
    leg U's verbs on ``"xla"`` (the processes meet at a barrier before
    each verb)."""
    import torch.distributed as dist

    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rows = k_rows(K_RECORDS, seed=7)
    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device="cuda"))
    a2a_s = timed_all_to_all()
    try:
        verbs = u_run(m, rows, sync=dist.barrier, a2a_s=a2a_s)
    finally:
        timed_all_to_all(off=True)
    res = {"verbs": verbs, "local": list(m.runtime.local_device_indices())}
    m.stop()
    del rows
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dist_phase_worker(rank: int, out_dir: str) -> dict:
    """``phase: distributed`` in one worker, at ``DIST_RECORDS``: TeraSort
    on each transport of :func:`dist_transports` (outputs saved whole),
    ``repartition(16)``, a sharded checkpoint resumed by a fresh
    manager, a segment checkpoint in the worker's own directory, an RPC
    client's write and read, and the refusals."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    res = {"t0": time.perf_counter()}
    per = DIST_RECORDS // PARTS
    for name, transport, kw in dist_transports():
        conf = dist_conf(transport, **kw)
        m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
        kernels = zeroed_counters()
        ts, out, totals = run_terasort(m, per, seed=DIST_SEED,
                                       verify=False, warmup=False,
                                       shuffle_id=2)
        np.save(os.path.join(out_dir, f"ts-{name}-{rank}.npy"),
                out.cpu().numpy())
        res[name] = {"totals": totals.tolist(), "staged": m.metrics.counter(
            "transport.hier.staged_exchanges").value,
            "rounds": ts.plan.num_rounds,
            "dispatches": m._exchange.last_dispatches,
            "ring_push": kernels["ring_push"].launches,
            "ring_push_all_to_all": kernels["ring_push_all_to_all"].launches,
            "merge_stage": kernels["merge_stage"].launches,
            "merge_splits": kernels["merge_splits"].launches,
            "partition_counts": kernels["partition_counts"].launches}
        m.stop()
    out, totals = dist_repartition("cuda")
    np.save(os.path.join(out_dir, f"repart-{rank}.npy"), out)
    res["repartition"] = totals
    res["ckpt"] = dist_checkpoint(os.path.join(out_dir, "ckpt"), rank)
    res["segments"] = dist_segments(out_dir, rank)
    res["rpc"] = dist_rpc(rank)
    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device="cuda"))
    res["stream"] = dist_stream(m)
    res["refused"] = dist_refusals(m)
    m.stop()
    res["seconds"] = time.perf_counter() - res.pop("t0")
    return res


def dist_stream_cols() -> np.ndarray:
    """The phase's input feed: ``uint32[25, 2^22]`` from a seed."""
    return np.random.default_rng(DIST_SEED + 1).integers(
        0, 2**32, size=(KEY_WORDS + VAL_WORDS, DIST_STREAM_RECORDS),
        dtype=np.uint32)


def dist_stream(m) -> dict:
    """``InputStreamer`` over the phase's chunks (whether each chunk on
    the card is this process's columns of the host chunk), then
    ``run_streaming_terasort`` without ``spill_dir``: its fold sums,
    records and chunks."""
    from sparkrdma_tpu_torch.hbm.input_stream import (ArrayChunkSource,
                                                      InputStreamer)
    from sparkrdma_tpu_torch.workloads.streaming import (
        run_streaming_terasort)

    cols = dist_stream_cols()
    rt = m.runtime
    chunk = DIST_STREAM_RECORDS // DIST_STREAM_CHUNKS
    mine = chunk // rt.process_count
    own = []
    for j, dev in enumerate(InputStreamer(rt, ArrayChunkSource(cols,
                                                               chunk))):
        first = j * chunk + rt.process_index * mine
        own.append(torch.equal(dev.cpu(), torch.from_numpy(np.ascontiguousarray(
            cols[:, first:first + mine]).view(np.int32))))
    res = run_streaming_terasort(m, ArrayChunkSource(cols, chunk))
    return {"own_columns": own, "fold_sums": res.fold_sums.tolist(),
            "records": res.records, "chunks": res.chunks,
            "stream_s": res.stream_s}


def dist_repartition(device: str):
    """``repartition(16)`` of ``DIST_RECORDS`` 100-byte records through
    the SPI (and ``run_repartition`` once): ``(out, totals)`` on the
    host."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads.repartition import (generate_records,
                                                           run_repartition)

    per = DIST_RECORDS // PARTS
    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device=device))
    recs = generate_records(m, per, DIST_SEED)
    h = m.register_shuffle(3, 16, hash_partitioner(16, KEY_WORDS))
    m.get_writer(h).write(recs).stop()
    out, totals = m.get_reader(h).read()
    out, totals = out.cpu().numpy(), totals.tolist()
    r = run_repartition(m, per, num_parts=16, seed=DIST_SEED, shuffle_id=4,
                        verify=False, warmup=False)
    if r.records != DIST_RECORDS:
        fail(f"run_repartition counted {r.records} records")
    m.stop()
    return out, totals


def dist_checkpoint(root: str, rank: int) -> dict:
    """A shuffle checkpointed by ``stop(True)`` (sharded across
    processes), read, then resumed by a fresh manager and read again:
    the two reads' words, and which shard files this process wrote."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner

    conf = dist_conf("xla", spill_to_host=True, spill_dir=root)
    rows = np.random.default_rng(DIST_SEED).integers(
        0, 2**32, size=(DIST_RECORDS, conf.record_words), dtype=np.uint32)
    part = modulo_partitioner(PARTS, key_word=1)
    m1 = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    h = m1.register_shuffle(DIST_CKPT_SID, PARTS, part)
    m1.get_writer(h).write(m1.runtime.shard_records(rows)).stop(True)
    live, live_tot = m1.get_reader(h).read()
    live = live.cpu().numpy()
    local = list(m1.runtime.local_device_indices())
    m1._writers.clear()
    m1.runtime.stop()
    m2 = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    h2 = m2.register_shuffle(DIST_CKPT_SID, PARTS, part)
    m2.resume_shuffle(h2)
    again, again_tot = m2.get_reader(h2).read()
    m2.stop()
    marker = json.loads(open(os.path.join(
        root, f"shuffle_{DIST_CKPT_SID}", f"proc{rank}.json")).read())
    return {"local": local, "marker_shards": marker["shards"],
            "totals": live_tot.tolist(),
            "resumed_equal": bool(np.array_equal(again.cpu().numpy(), live)
                                  and again_tot.tolist()
                                  == live_tot.tolist()),
            "digests": part_digests(torch.from_numpy(live.view(np.int32)),
                                    live_tot.cpu(), live.shape[1]
                                    // len(local))}


def dist_segments(out_dir: str, rank: int) -> dict:
    """A segment checkpoint written into this worker's own ``spill_dir``
    and adopted by a fresh manager: the adopted keys, whether the array
    came back, and the directory's entries."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    conf = dist_conf("xla", spill_dir=os.path.join(out_dir, f"seg{rank}"))
    mine = np.random.default_rng(DIST_SEED + 10 + rank).integers(
        0, 2**32, size=(KEY_WORDS + VAL_WORDS, 1 << 16), dtype=np.uint32)
    m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    m.checkpoint_segments(DIST_SEG_SID, [(f"seg{rank}", mine)], None, PARTS)
    m.stop()
    m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    adopted = m.resume_segments(DIST_SEG_SID)
    back = np.array_equal(np.asarray(m.tiered.get(f"seg{rank}")), mine)
    m.stop()
    return {"adopted": adopted, "equal": bool(back),
            "entries": sorted(os.listdir(conf.spill_dir))}


def dist_rpc(rank: int) -> dict:
    """A client of this worker's daemon (``rpc_port=0``): ``write`` of
    ``SVC_RPC_PER_PART`` 100-byte rows a partition (the exchange runs
    in the session's scope), then ``read``, which must refuse."""
    from sparkrdma_tpu_torch.service import ShuffleService
    from sparkrdma_tpu_torch.service.client import RpcCallError, RpcClient

    rows = np.random.default_rng(DIST_SEED + 20).integers(
        0, 2**32, size=(SVC_RPC_PER_PART * PARTS, KEY_WORDS + VAL_WORDS),
        dtype=np.uint32)
    svc = ShuffleService(conf=dist_conf("xla", rpc_port=0), device="cuda")
    said = ""
    try:
        with RpcClient(port=svc.rpc.port, client_id=f"worker{rank}") as c:
            c.hello()
            sess = c.open_session("rpc")
            c.register_shuffle(sess, DIST_RPC_SID, 0)
            written = c.write(sess, DIST_RPC_SID, rows.tolist())
            try:
                c.read(sess, DIST_RPC_SID)
            except RpcCallError as e:
                said = str(e)
    finally:
        svc.stop()
    return {"written": written,
            "read_refused": "NotImplementedError" in said and "A.12" in said
            and f"`{RPC_READ_LINE}`" in said}


def dist_ckpt_single() -> dict:
    """The checkpoint scenario's read in this (one) process."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner

    conf = dist_conf("xla")
    rows = np.random.default_rng(DIST_SEED).integers(
        0, 2**32, size=(DIST_RECORDS, conf.record_words), dtype=np.uint32)
    m = ShuffleManager(MeshRuntime(conf, PARTS, device="cuda"))
    h = m.register_shuffle(DIST_CKPT_SID, PARTS,
                           modulo_partitioner(PARTS, key_word=1))
    m.get_writer(h).write(m.runtime.shard_records(rows)).stop()
    out, totals = m.get_reader(h).read()
    res = {"totals": totals.tolist(),
           "digests": part_digests(out, totals, out.shape[1] // PARTS)}
    m.stop()
    return res


def pair_ms(fn, n: int) -> float:
    """Milliseconds a call of ``fn`` while every worker calls it at once:
    the processes meet at a barrier, each makes ``n`` calls and syncs
    its card, and the wall runs to the barrier after the slower one."""
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) / n * 1e3


def pair_once(fn) -> tuple:
    """One call of ``fn`` in every worker at once, between barriers:
    ``(its result, milliseconds to the barrier after the slower)``."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return res, (time.perf_counter() - t0) * 1e3


def alone_ms(fn, n: int, rank: int) -> float:
    """Device milliseconds of ``fn`` in this worker while the others wait
    at a barrier (CUDA events, the workers in turn)."""
    import torch.distributed as dist

    ms = 0.0
    for k in range(T_WORKERS):
        dist.barrier()
        if k == rank:
            ms = time_ms(fn, reps=n)
        dist.barrier()
    return ms


def push_checks(rank: int, keys) -> dict:
    """The push kernel at each push shape ``keys`` (``(shape, a2a)``, the
    same list in every worker) on random words: the move through the
    kernel, the same handshake around the plain push (indexing copies
    into the peers' windows mapped here) and ``all_to_all_single``, each
    this worker's receive, bit for bit; then each one timed: the launch
    alone without the handshake (``kernel_ms``, every worker at once;
    ``worker_ms`` one worker alone, CUDA events), the plain push, and
    ``all_to_all_single`` over gloo. Then the handshake's host cost per
    move at a tiny shape."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.exchange import ring
    from sparkrdma_tpu_torch.exchange.hierarchical import make_flat_all_to_all
    from sparkrdma_tpu_torch.exchange.windows import close_scope, window_for
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    rt = MeshRuntime(dist_conf("pallas_ring"), PARTS, device="cuda")
    flat = make_flat_all_to_all(rt)
    lines = []
    for shape, a2a in sorted(keys):
        send = rand_words(shape, seed=zlib.crc32(repr(shape).encode()) + rank)
        if a2a:
            send = send.squeeze(1)
        kernel = ring.ring_push_all_to_all if a2a else ring.ring_push
        rounds = 1 if a2a else 0

        def plain(s, w):
            ring.ring_push_plain(s, w.views(), w.rank, rounds)

        got = ring._CrossMove(rt, WORLD, kernel)(send, torch.empty_like(send))
        want = ring._CrossMove(rt, WORLD, plain)(send, torch.empty_like(send))
        send_t = send if a2a else send.transpose(1, 2).contiguous()
        nbytes = send.numel() * 4
        # gloo's call at a large shape takes ~1 s: the checked call is
        # its one timing there
        lib, lib_ms = pair_once(lambda: flat(send_t))
        lib = lib if a2a else lib.transpose(1, 2)
        err = max(max_abs_err(got, want), max_abs_err(got, lib))
        del got, want, lib
        win = window_for(WORLD, send.device, rt.process_index,
                         rt.process_count)
        n = 10 if nbytes < 1e9 else 5
        launch = lambda: ring._launch(  # noqa: E731
            send, tuple(win.bases()), win.rank, not a2a)
        lines.append({
            "shape": list(shape), "a2a": a2a, "max_abs_err": err,
            "kernel_ms": pair_ms(launch, n),
            "worker_ms": alone_ms(launch, n, rank),
            "plain_ms": pair_ms(lambda: plain(send, win), n),
            "library_ms": lib_ms if nbytes > 1e8 else pair_ms(
                lambda: flat(send_t), 5),
            "bound_ms": 2 * nbytes * T_WORKERS / MEM_RATE * 1e3,
            "worker_bound_ms": 2 * nbytes / MEM_RATE * 1e3})
        del send, send_t
        torch.cuda.empty_cache()
    slow = slow_read_check(rt, rank)
    tiny = rand_words((rt.local_partitions, 1, PARTS, 4), seed=rank)
    out = torch.empty_like(tiny)
    move = ring._CrossMove(rt, WORLD, ring.ring_push)
    move(tiny, out)
    win = window_for(WORLD, tiny.device, rt.process_index, rt.process_count)
    h0, w0 = win.handshake_s, win.launch_wait_s
    t0 = time.perf_counter()
    for _ in range(PUSH_HANDSHAKE_MOVES):
        move(tiny, out)
    wall = time.perf_counter() - t0
    handshake = {"shape": list(tiny.shape), "moves": PUSH_HANDSHAKE_MOVES,
                 "us_per_move": wall / PUSH_HANDSHAKE_MOVES * 1e6,
                 "handshake_us_per_move": (win.handshake_s - h0)
                 / PUSH_HANDSHAKE_MOVES * 1e6,
                 "launch_wait_us_per_move": (win.launch_wait_s - w0)
                 / PUSH_HANDSHAKE_MOVES * 1e6}
    close_scope(WORLD)
    return {"shapes": lines, "handshake": handshake, "slow_read": slow}


#: the slow read's shape a worker (words) and its sleep before the read
SLOW_READ_WORDS, SLOW_READ_MS = 4096, 200


def slow_read_check(rt, rank: int) -> dict:
    """Write after read on the card: two moves of different words back
    to back through one window. The first move's receive is read by a
    clone queued behind ``SLOW_READ_MS`` of ``torch.cuda._sleep``, and
    the window released, before the second move; the next move's ready
    step must wait for that read, so the clone holds the first move's
    words bit for bit, and the second move's receive its own (each
    against the plain push's move of the same send)."""
    from sparkrdma_tpu_torch.exchange import ring
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    shape = (rt.local_partitions, 1, PARTS, SLOW_READ_WORDS)
    sends = [rand_words(shape, seed=1000 + 10 * move + rank)
             for move in range(2)]
    plain = ring._CrossMove(rt, WORLD, lambda s, w: ring.ring_push_plain(
        s, w.views(), w.rank))
    want = [plain(s, torch.empty_like(s)) for s in sends]
    cycles = int(sleep_cycles_per_ms() * SLOW_READ_MS)
    move = ring._CrossMove(rt, WORLD, ring.ring_push)
    t0 = time.perf_counter()
    first = move(sends[0])              # the window itself
    torch.cuda._sleep(cycles)
    read = first.clone()
    move.release()
    second = move(sends[1], torch.empty_like(sends[1]))
    torch.cuda.synchronize()
    return {"shape": list(shape), "sleep_ms": SLOW_READ_MS,
            "wall_s": time.perf_counter() - t0,
            "first_equal": bool(torch.equal(read, want[0])),
            "second_equal": bool(torch.equal(second, want[1])),
            "moves_differ": not torch.equal(want[0], want[1])}


def distributed_worker(args) -> int:
    """One process of leg T and ``phase: distributed``:
    ``--distributed-worker RANK WORLD INIT_FILE OUT_DIR BACKEND PHASE``
    (PHASE 1: the phase too). A card per process where the backend is
    NCCL's; else every worker on the current card."""
    import torch.distributed as dist

    from sparkrdma_tpu_torch import initialize_distributed

    rank, world = int(args[0]), int(args[1])
    init, out_dir, backend, phase = args[2], args[3], args[4], args[5] == "1"
    if backend != "gloo":
        torch.cuda.set_device(rank)
    if not initialize_distributed(num_processes=world, process_id=rank,
                                  init_method=f"file://{init}",
                                  backend=backend, timeout_s=300):
        fail("no process group")
    t0 = time.perf_counter()
    seen, plans = {}, {}
    with RingShapes() as seen["T"], PlanPasses() as plans["T"]:
        res = {"T": t_worker(rank, backend)}
    res["T_s"] = time.perf_counter() - t0
    if phase:
        t0 = time.perf_counter()
        with RingShapes() as seen["V-service"], \
                PlanPasses() as plans["V-service"]:
            res["V"] = v_service_worker(out_dir, rank)
        res["V_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with PlanPasses() as plans["U"]:
            res["U"] = u_worker()
        res["U_s"] = time.perf_counter() - t0
        with RingShapes() as seen["distributed"], \
                PlanPasses() as plans["distributed"]:
            res["distributed"] = dist_phase_worker(rank, out_dir)
    # the ring shapes each part launched at, and the push checked there
    res["ring_shapes"] = {part: [[list(shape), a2a, n] for (shape, a2a), n
                                 in sorted(rec.counts.items())]
                          for part, rec in seen.items()}
    res["plan_passes"] = {part: plan_rows(rec.counts)
                          for part, rec in plans.items()}
    if phase:
        t0 = time.perf_counter()
        res["push"] = push_checks(rank, {
            key for rec in seen.values() for key in rec.counts
            if is_push(key[0])})
        res["push"]["seconds"] = time.perf_counter() - t0
    res["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(out_dir, f"worker-{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_workers(backend: str, phase: bool) -> tuple:
    """Start ``T_WORKERS`` workers of this script and wait for them: a
    non-zero exit or ``DIST_WORKER_S`` fails the smoke. Returns
    ``(results by rank, out_dir, seconds)``."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    init = os.path.join(out_dir, "rendezvous")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--distributed-worker",
         str(r), str(T_WORKERS), init, out_dir, backend,
         "1" if phase else "0"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(T_WORKERS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_WORKER_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"distributed workers ran past {DIST_WORKER_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            print(out[-6000:], file=sys.stderr)
            fail(f"distributed worker {r} exited {p.returncode}")
    res = []
    for r in range(T_WORKERS):
        with open(os.path.join(out_dir, f"worker-{r}.json")) as f:
            res.append(json.load(f))
    return res, out_dir, time.perf_counter() - t0


def t_reference() -> dict:
    """Leg T's reference: the same records and conf in one process, the
    stacked ``"xla"`` transport: each partition's totals and digest."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device="cuda"))
    kernels = zeroed_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, out, totals = run_terasort(m, RECORDS // PARTS, seed=0,
                                    verify=False, warmup=False)
    torch.cuda.synchronize()
    line = {"totals": totals.tolist(),
            "digests": part_digests(out, totals, res.plan.out_capacity),
            "read_s": res.sort_exchange_s,
            "run_wall_s": time.perf_counter() - t0,
            "merge_stage": kernels["merge_stage"].launches}
    del out, totals
    m.stop()
    return line


def u_reference() -> dict:
    """Leg U's reference: the same records (leg K's, when it kept them),
    conf and verbs in one process, on the stacked ``"xla"`` transport,
    without a warm-up (the smoke's earlier legs have warmed the card)."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    rows = k_rows(K_RECORDS, seed=7)
    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device="cuda"))
    verbs = u_run(m, rows, warm=False)
    m.stop()
    return verbs


def v_service_reference() -> dict:
    """Leg V-service's reference: each tenant's TeraSort alone in one
    process (leg B's conf on ``"xla"``): its partitions' totals and
    digests, and the read's seconds."""
    ref = {}
    for name, seed, sid in V_TENANTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, totals = solo_terasort(dist_conf("xla"), seed, sid,
                                    S_RECORDS // PARTS)
        torch.cuda.synchronize()
        ref[name] = {"totals": totals.tolist(),
                     "digests": part_digests(out, totals,
                                             out.shape[1] // PARTS),
                     "run_wall_s": time.perf_counter() - t0}
        del out, totals
        torch.cuda.empty_cache()
    return ref


def v_lines(service_ref: dict, plan_ref: dict, workers: list) -> dict:
    """Leg V's lines: ``V-plan`` (per plan the slower worker's seconds
    beside one process's, each worker's seconds in
    ``all_to_all_single``, launches and peak memory; the hoist's
    decision) and ``V-service`` (per tenant and read the GB/s of the
    slower worker, the aggregate, ``a2a_s``, launches, peak memory).
    Fails unless every partition of every plan and every read equals
    the one-process run's, and the merge path ran in every worker."""
    checks, plans = {}, {}
    for name in V_PLANS:
        per = [w["U"]["verbs"]["plans"][name] for w in workers]
        plans[name] = {
            "wall_s": max(p["wall_s"] for p in per),
            "worker_s": [p["wall_s"] for p in per],
            "one_process_s": plan_ref[name]["wall_s"],
            "a2a_s": [p["a2a_s"] for p in per],
            "merge_stage": [p["merge_stage"] for p in per],
            "one_process_merge_stage": plan_ref[name]["merge_stage"],
            "partition_counts": [p["partition_counts"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per],
            "one_process_peak_gb": plan_ref[name]["peak_gb"],
            "partition_totals": sum((p["totals"] for p in per), []),
            "partition_digests": sum((p["digests"] for p in per), [])}
        for w, p in zip(workers, per):
            lo, hi = w["U"]["local"][0], w["U"]["local"][-1] + 1
            checks[f"plan {name} partitions {lo}-{hi - 1} equal"] = (
                p["totals"] == plan_ref[name]["totals"][lo:hi]
                and p["digests"] == plan_ref[name]["digests"][lo:hi])
    hoists = [w["U"]["verbs"]["plans"]["hoist"] for w in workers]
    checks["combine_hoist decided as in one process"] = all(
        h == plan_ref["hoist"] and len(h) == 1 for h in hoists)
    checks["plan filter_sort merge_stage launched in every worker"] = all(
        n > 0 for n in plans["filter_sort"]["merge_stage"])
    plan_line = {"leg": "V-plan", "workload": "PlanExecutor across "
                 "processes on leg U's loaded dataset",
                 "records": K_RECORDS,
                 "record_bytes": 4 * (KEY_WORDS + VAL_WORDS),
                 "partitions": PARTS, "processes": T_WORKERS,
                 "transport": "xla", "backend": "gloo",
                 "plans": plans, "combine_hoist": hoists[0],
                 "checks": checks}
    report(plan_line)
    checks_s, tenants = {}, {}
    nbytes = S_RECORDS * (KEY_WORDS + VAL_WORDS) * 4
    for name, _, _ in V_TENANTS:
        runs = [w["V"]["tenants"][name] for w in workers]
        ref = service_ref[name]
        timed_reads = []
        for i in range(V_READS + 1):
            walls = [r["reads"][i]["wall_s"] for r in runs]
            if i:
                timed_reads.append({"gbps": nbytes / max(walls) / 1e9,
                                    "wall_s": walls})
            for w, r in zip(workers, runs):
                lo, hi = w["U"]["local"][0], w["U"]["local"][-1] + 1
                checks_s[f"{name} read {i} partitions {lo}-{hi - 1} "
                         "equal"] = (
                    r["reads"][i]["totals"] == ref["totals"][lo:hi]
                    and r["reads"][i]["digests"] == ref["digests"][lo:hi])
        tenants[name] = {
            "gbps": statistics.median(r["gbps"] for r in timed_reads),
            "reads": timed_reads, "a2a_s": [r["a2a_s"] for r in runs],
            "window": [r["window"] for r in runs],
            "scope": runs[0]["scope"],
            "transport": [r["transport"] for r in runs],
            "one_process_run_wall_s": ref["run_wall_s"]}
    checks_s["each tenant's own collective scope"] = all(
        len({w["V"]["tenants"][n]["scope"] for w in workers}) == 1
        for n, _, _ in V_TENANTS) and len(
            {workers[0]["V"]["tenants"][n]["scope"]
             for n, _, _ in V_TENANTS}) == len(V_TENANTS)
    checks_s["merge_stage launched in every worker"] = all(
        w["V"]["merge_stage"] > 0 for w in workers)
    checks_s["ring_push launched in every worker"] = all(
        w["V"]["ring_push"] > 0 for w in workers)
    checks_s["each tenant on its transport"] = all(
        w["V"]["tenants"][n]["transport"] == V_TRANSPORTS[n]
        for w in workers for n, _, _ in V_TENANTS)
    ring_tenants = [n for n, t in V_TRANSPORTS.items() if t == "pallas_ring"]
    xla_tenants = [n for n, t in V_TRANSPORTS.items() if t == "xla"]
    checks_s["the ring tenant's window its own"] = all(
        w["V"]["tenants"][n]["window"]["moves"] > 0
        for w in workers for n in ring_tenants)
    checks_s["the xla tenant's all_to_all_single on its own scope"] = all(
        w["V"]["tenants"][n]["a2a_s"] > 0
        and w["V"]["tenants"][n]["window"]["moves"] == 0
        for w in workers for n in xla_tenants)
    checks_s["spans journaled"] = all(
        w["V"]["journal_lines"].get("span", 0) >= len(V_TENANTS) * V_READS
        for w in workers)
    service_line = {
        "leg": "V-service", "tenants": len(V_TENANTS),
        "records_per_tenant": S_RECORDS, "record_bytes": 100,
        "partitions": PARTS, "processes": T_WORKERS,
        "transport": dict(V_TRANSPORTS), "backend": "gloo",
        "conf": "leg B's (fast_sort, pow2, pack/wide off) on each tenant's "
                "transport; the live layer on as leg S",
        "per_tenant_gbps": {n: t["gbps"] for n, t in tenants.items()},
        "aggregate_gbps": sum(t["gbps"] for t in tenants.values()),
        "tenants_detail": tenants,
        "e2e_s": [w["V"]["e2e_s"] for w in workers],
        "worker_s": [w["V_s"] for w in workers],
        "merge_stage": [w["V"]["merge_stage"] for w in workers],
        "ring_push": [w["V"]["ring_push"] for w in workers],
        "peak_gb": [w["V"]["peak_gb"] for w in workers],
        "journal_lines": [w["V"]["journal_lines"] for w in workers],
        "checks": checks_s}
    report(service_line)
    bad = [k for k, v in {**checks, **checks_s}.items() if not v]
    if bad:
        fail("leg V: " + ", ".join(bad))
    launches = dict.fromkeys(KERNEL_COUNTS, 0)
    for w in workers:
        for k in ("merge_stage", "merge_splits", "partition_counts"):
            launches[k] += w["V"][k] + sum(
                w["U"]["verbs"]["plans"][n][k] for n in V_PLANS)
        launches["ring_push"] += w["V"]["ring_push"]
    return {"leg": "V", "launches": launches,
            "plan_s": {n: p["wall_s"] for n, p in plans.items()},
            "per_tenant_gbps": service_line["per_tenant_gbps"]}


def u_line(ref: dict, workers: list) -> dict:
    """Leg U's line: per verb the slower worker's seconds beside one
    process's, each worker's seconds in ``all_to_all_single``, launches
    and peak memory; fails unless every partition equals the
    one-process run's and the merge path ran in every worker's
    ``sort_by_key``."""
    checks, verbs = {}, {}
    for name in U_VERBS:
        per = [w["U"]["verbs"][name] for w in workers]
        verbs[name] = {
            "wall_s": max(p["wall_s"] for p in per),
            "worker_s": [p["wall_s"] for p in per],
            "one_process_s": ref[name]["wall_s"],
            "a2a_s": [p["a2a_s"] for p in per],
            "merge_stage": [p["merge_stage"] for p in per],
            "one_process_merge_stage": ref[name]["merge_stage"],
            "partition_counts": [p["partition_counts"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per],
            "one_process_peak_gb": ref[name]["peak_gb"],
            "partition_totals": sum((p["totals"] for p in per), []),
            "partition_digests": sum((p["digests"] for p in per), [])}
        for w, p in zip(workers, per):
            lo, hi = w["U"]["local"][0], w["U"]["local"][-1] + 1
            checks[f"{name} partitions {lo}-{hi - 1} equal"] = (
                p["totals"] == ref[name]["totals"][lo:hi]
                and p["digests"] == ref[name]["digests"][lo:hi])
    checks["sort_by_key merge_stage launched in every worker"] = all(
        n > 0 for n in verbs["sort_by_key"]["merge_stage"])
    checks["no jax"] = not any(w["jax_imported"] for w in workers)
    line = {"leg": "U", "workload": "Dataset verbs across processes",
            "records": K_RECORDS,
            "record_bytes": 4 * (KEY_WORDS + VAL_WORDS),
            "keys": f"Zipf(1.1) folded into {K_KEY_IDS} ids, "
                    "default_rng(7)",
            "partitions": PARTS, "processes": T_WORKERS,
            "transport": "xla", "backend": "gloo",
            "worker_s": [w["U_s"] for w in workers],
            "verbs": verbs, "checks": checks}
    report(line)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail("leg U: " + ", ".join(bad))
    return line


def t_line(name: str, ref: dict, workers: list, seconds: float,
           **extra) -> dict:
    """Leg T's line for one backend (``extra`` added to it); fails unless
    every worker's partitions equal the one-process run."""
    line = {"leg": name, "records": RECORDS, "partitions": PARTS,
            "processes": T_WORKERS, "backend": workers[0]["T"]["xla"][
                "backend"], "workers_s": seconds,
            "one_process_xla_read_s": ref["read_s"]}
    checks = {}
    for transport in T_TRANSPORTS:
        per = [w["T"][transport] for w in workers]
        reads = []
        for i in range(T_READS):
            walls = [p["reads"][i]["wall_s"] for p in per]
            reads.append({
                "gbps": RECORDS * (KEY_WORDS + VAL_WORDS) * 4
                / max(walls) / 1e9,
                "wall_s": walls, **{k: [p["reads"][i][k] for p in per]
                                    for k in T_READ_KEYS}})
        line[transport] = {"rounds": per[0]["rounds"],
                           "out_capacity": per[0]["out_capacity"],
                           "staged_exchanges": [p["staged"] for p in per],
                           "reads": reads}
        for p in per:
            lo, hi = p["local"][0], p["local"][-1] + 1
            checks[f"{transport} partitions {lo}-{hi - 1} equal"] = (
                p["totals"] == ref["totals"][lo:hi]
                and p["digests"] == ref["digests"][lo:hi])
        checks[f"{transport} merge_stage launched in every worker"] = all(
            r["merge_stage"][k] > 0 for r in reads
            for k in range(T_WORKERS))
    checks["pallas_ring pushed in every worker and read"] = all(
        n > 0 for r in line["pallas_ring"]["reads"] for n in r["ring_push"])
    checks["hierarchical staged"] = all(
        p["T"]["hierarchical"]["staged"] > 0 for p in workers)
    checks["no jax"] = not any(w["jax_imported"] for w in workers)
    line["checks"] = checks
    line.update(extra)
    report(line)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"leg {name}: " + ", ".join(bad))
    return line


def leg_t() -> dict:
    """Leg T and ``phase: distributed`` (one pair of workers runs both):
    the one-process references first, then the cached memory freed, then
    the workers; NCCL's run where the machine has two cards."""
    from sparkrdma_tpu_torch.runtime.distributed import CARD_PER_PROCESS

    ref = t_reference()
    u_ref = u_reference()
    v_ref = v_service_reference()
    ts_ref, rep_ref, stream_ref = dist_single_refs()
    ck_ref = dist_ckpt_single()
    gc.collect()
    torch.cuda.empty_cache()
    workers, out_dir, seconds = spawn_workers("gloo", phase=True)
    if torch.cuda.device_count() >= 2:
        # a card a process: the data over NCCL (its own leg line)
        nccl, _, nccl_s = spawn_workers(CARD_PER_PROCESS, phase=False)
        t_line("T nccl", ref, nccl, nccl_s)
        nccl = "ran: leg T nccl"
    else:
        nccl = "needs 2 cards"
    line = t_line("T", ref, workers, seconds, nccl=nccl)
    u = u_line(u_ref, workers)
    v = v_lines(v_ref, u_ref["plans"], workers)
    phase = dist_phase_line(workers, out_dir, ts_ref, rep_ref, ck_ref,
                            stream_ref)
    push = push_lines(workers)
    launches = dict.fromkeys(KERNEL_COUNTS, 0)
    u_launches = dict(launches)
    for w in workers:
        for transport in T_TRANSPORTS:
            launches["partition_counts"] += w["T"][transport][
                "partition_counts"]
            for r in w["T"][transport]["reads"]:
                for k in ("merge_stage", "merge_splits", "ring_push"):
                    launches[k] += r[k]
        for name in U_VERBS:
            for k in ("merge_stage", "merge_splits", "partition_counts"):
                u_launches[k] += w["U"]["verbs"][name][k]
    # each part's ring shapes, recorded in the workers
    shapes = {}
    for w in workers:
        for part, rows in w["ring_shapes"].items():
            for shape, a2a, n in rows:
                key = (tuple(shape), a2a)
                counts = shapes.setdefault(part, {})
                counts[key] = counts.get(key, 0) + n
    return {"leg": "T", "launches": launches, "gbps": {
        t: [r["gbps"] for r in line[t]["reads"]] for t in T_TRANSPORTS},
        "U": {"leg": "U", "launches": u_launches,
              "verb_s": {k: v["wall_s"] for k, v in u["verbs"].items()}},
        "V": v, "distributed": {"leg": "distributed",
                                "launches": phase["launches"]},
        "push": push, "ring_shapes": shapes,
        "plan_passes": [w["plan_passes"] for w in workers]}


#: the kernel wrappers whose launches the legs count
KERNEL_COUNTS = ("merge_stage", "merge_splits", "ring_exchange",
                 "ring_all_to_all", "ring_push", "ring_push_all_to_all",
                 "partition_counts", "bucket_scatter")


def push_lines(workers: list) -> dict:
    """One ``phase: ring_push`` line per push shape the workers checked
    (the workers' errors and times side by side) and one for the
    handshake; fails unless the kernel agreed everywhere. Returns the
    lines by ``(shape, a2a)`` and the handshake's."""
    lines = {}
    per = [w["push"]["shapes"] for w in workers]
    for rows in zip(*per):
        first = rows[0]
        line = {"phase": "ring_push", "shape": first["shape"],
                "a2a": first["a2a"], "processes": T_WORKERS,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: max(r[k] for r in rows)
                   for k in ("kernel_ms", "plain_ms", "library_ms")},
                "worker_ms": [r["worker_ms"] for r in rows],
                "bound_ms": first["bound_ms"],
                "worker_bound_ms": first["worker_bound_ms"],
                "bound_by": "bytes",
                "note": "kernel, plain and library ms: every worker at "
                        "once (host wall over launches between barriers); "
                        "worker_ms: one worker alone (CUDA events); "
                        "bound: the whole exchange's bytes read and "
                        "written over one HBM"}
        report(line)
        lines[(tuple(first["shape"]), first["a2a"])] = line
        if line["max_abs_err"]:
            fail(f"the push disagrees with its plain version or with "
                 f"all_to_all_single at {first['shape']} (a2a "
                 f"{first['a2a']}): {line['max_abs_err']}")
    hs = [w["push"]["handshake"] for w in workers]
    handshake = {"phase": "ring_push", "part": "handshake",
                 "shape": hs[0]["shape"], "moves": hs[0]["moves"],
                 **{k: [h[k] for h in hs]
                    for k in ("us_per_move", "handshake_us_per_move",
                              "launch_wait_us_per_move")},
                 "seconds": [w["push"]["seconds"] for w in workers]}
    report(handshake)
    slow = {"phase": "ring_push", "part": "slow_read",
            "workers": [w["push"]["slow_read"] for w in workers]}
    report(slow)
    if not all(r["first_equal"] and r["second_equal"] and r["moves_differ"]
               for r in slow["workers"]):
        fail("the ring's window was written before its last read was "
             f"done: {slow['workers']}")
    if not lines:
        fail("the workers checked no push shape")
    return {"lines": lines, "handshake": handshake}


def dist_single_refs():
    """The phase's one-process runs: TeraSort's whole output on the
    stacked ``"xla"`` transport, ``repartition(16)``'s, and the input
    feed's fold (with numpy's sums beside it)."""
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    m = ShuffleManager(MeshRuntime(dist_conf("xla"), PARTS, device="cuda"))
    _, out, totals = run_terasort(m, DIST_RECORDS // PARTS, seed=DIST_SEED,
                                  verify=False, warmup=False, shuffle_id=2)
    ts = (out.cpu().numpy(), totals.tolist())
    del out, totals
    stream = dist_stream(m)
    stream["numpy_sums"] = fold_expect(dist_stream_cols()).tolist()
    m.stop()
    return ts, dist_repartition("cuda"), stream


def dist_phase_line(workers, out_dir, ts_ref, rep_ref, ck_ref,
                    stream_ref) -> dict:
    """``phase: distributed``'s line: every check of the workers' runs
    against the one-process runs; fails unless each holds."""
    checks = {}
    halves = [w["distributed"] for w in workers]

    def joined(prefix):
        return np.concatenate([np.load(os.path.join(
            out_dir, f"{prefix}-{r}.npy")) for r in range(T_WORKERS)], axis=1)

    launches = dict.fromkeys(KERNEL_COUNTS, 0)
    for name, transport, kw in dist_transports():
        checks[f"terasort {name} equal"] = (
            np.array_equal(joined(f"ts-{name}"), ts_ref[0])
            and sum((h[name]["totals"] for h in halves), []) == ts_ref[1])
        hosts = kw.get("hierarchy_hosts", 0)
        checks[f"terasort {name} moves"] = all(
            (h[name]["staged"] > 0) == (hosts > 1) for h in halves)
        for h in halves:
            for k in launches:
                launches[k] += h[name].get(k, 0)
        if transport == "pallas_ring":
            pushed = "ring_push" if kw["ring_fused"] else \
                "ring_push_all_to_all"
            checks[f"terasort {name} {pushed} launched in every worker"] = \
                all(h[name][pushed] > 0 for h in halves)
            stream = "max_rounds_in_flight" in kw
            checks[f"terasort {name} "
                   f"{'streamed' if stream else 'fused'}"] = all(
                (h[name]["dispatches"] > 1) == stream for h in halves)
    checks["repartition(16) equal"] = (
        np.array_equal(joined("repart"), rep_ref[0])
        and sum((h["repartition"] for h in halves), []) == rep_ref[1])
    ck = [h["ckpt"] for h in halves]
    checks["checkpoint: each process wrote its own shards"] = all(
        c["marker_shards"] == c["local"] for c in ck)
    files = sorted(os.listdir(os.path.join(out_dir, "ckpt",
                                           f"shuffle_{DIST_CKPT_SID}")))
    checks["checkpoint files"] = files == sorted(
        ["meta.json"] + [f"proc{r}.json" for r in range(T_WORKERS)]
        + [f"shard_{c}.u32" for c in range(PARTS)])
    checks["checkpoint resumed equal"] = all(c["resumed_equal"] for c in ck)
    checks["checkpoint equal to one process"] = (
        sum((c["totals"] for c in ck), []) == ck_ref["totals"]
        and sum((c["digests"] for c in ck), []) == ck_ref["digests"])
    st = [h["stream"] for h in halves]
    checks["InputStreamer: each worker's chunks its own columns"] = all(
        len(s["own_columns"]) == DIST_STREAM_CHUNKS and all(s["own_columns"])
        for s in st)
    checks["fold sums equal on every worker and to one process"] = all(
        s["fold_sums"] == stream_ref["fold_sums"]
        and (s["records"], s["chunks"]) == (DIST_STREAM_RECORDS,
                                            DIST_STREAM_CHUNKS) for s in st)
    checks["fold sums equal to numpy"] = (stream_ref["fold_sums"]
                                          == stream_ref["numpy_sums"])
    checks["segment checkpoint: each worker adopted its own"] = all(
        h["segments"]["adopted"] == [f"seg{r}"] and h["segments"]["equal"]
        and h["segments"]["entries"] == [f"shuffle_{DIST_SEG_SID}"]
        for r, h in enumerate(halves))
    checks["rpc write"] = all(h["rpc"]["written"] == SVC_RPC_PER_PART * PARTS
                              for h in halves)
    checks["refuses the rpc read"] = all(h["rpc"]["read_refused"]
                                         for h in halves)
    for h in halves:
        for name, ok in h["refused"].items():
            checks[f"refuses {name}"] = checks.get(
                f"refuses {name}", True) and ok
    line = {"phase": "distributed", "records": DIST_RECORDS,
            "processes": T_WORKERS, "transports": [n for n, _, _ in
                                                   dist_transports()],
            "rounds": {n: halves[0][n]["rounds"]
                       for n, _, _ in dist_transports()},
            "dispatches": {n: halves[0][n]["dispatches"]
                           for n, _, _ in dist_transports()},
            "launches": launches,
            "worker_s": [h["seconds"] for h in halves],
            "stream_records": DIST_STREAM_RECORDS,
            "stream_chunks": DIST_STREAM_CHUNKS,
            "stream_s": [s["stream_s"] for s in st],
            "one_process_stream_s": stream_ref["stream_s"],
            "checks": checks}
    report(line)
    shutil.rmtree(out_dir, ignore_errors=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail("distributed: " + ", ".join(bad))
    return line


# --- the chaos phase: the port's soaks on the card --------------------

#: the ``chaos`` phase's soaks: (part, script, flags). The chaos soak
#: streams every exchange leg through the ring kernel in 32 chunks of
#: 256-record slots (65,536 records a partition: about 8,192 a pair, 32
#: rounds, inside its conf's ``max_rounds=64``); the oversubscription
#: soak runs ceil(2048 * 32,768 / 4 MiB) = 16 chunks, leg H's count, of
#: 262,144 records
CHAOS_SOAKS = (
    ("chaos_soak", "torch_chaos_soak.py",
     ("--device", "cuda", "--transport", "pallas_ring",
      "--records-per-device", "65536", "--seed", "7")),
    ("oversub_soak", "torch_oversub_soak.py",
     ("--device", "cuda", "--chunk-records", "262144", "--oversub",
      "2048")),
)
#: a soak's limit; past it the smoke fails
SOAK_TIMEOUT_S = 420


def soak_child(script: str, argv) -> int:
    """``--soak-child SCRIPT FLAGS...``: one soak's ``main(FLAGS)`` in this
    process, the kernel wrappers' counts set to 0 just before it; after
    its summary, the launches and the ring shapes it made
    (``{"soak_launches": {...}, "soak_ring_shapes": [[shape, a2a,
    launches], ...], "soak_plan_passes": [...]}``, the last
    :func:`plan_rows`)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("soak", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = zeroed_counters()
    with RingShapes() as seen, PlanPasses() as plans:
        rc = mod.main(list(argv))
    torch.cuda.synchronize()
    print(json.dumps({
        "soak_launches": {k: v.launches for k, v in kernels.items()},
        "soak_ring_shapes": [[list(shape), a2a, n] for (shape, a2a), n
                             in sorted(seen.counts.items())],
        "soak_plan_passes": plan_rows(plans.counts)}), flush=True)
    return rc


def start_chaos() -> dict:
    """Start both soaks at once, each a child of this script
    (``--soak-child``) on the card; :func:`finish_chaos` waits for
    them. Each child's output is drained by a thread of its own, and its
    seconds are taken when it exits; a child still running when the
    smoke exits (a failed leg) is killed."""
    import threading

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    done = {}

    def wait(name, proc):
        try:
            out, err = proc.communicate(timeout=SOAK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            err += f"\n{name} ran past {SOAK_TIMEOUT_S} s"
        done[name] = (proc.returncode, out, err, time.perf_counter() - t0)

    waiters, procs = [], []
    for name, script, argv in CHAOS_SOAKS:
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--soak-child",
             os.path.join(here, "scripts", script), *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        waiters.append(threading.Thread(target=wait,
                                        args=(name, procs[-1])))
        waiters[-1].start()
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"waiters": waiters, "done": done}


def finish_chaos(started: dict, legs: dict, shapes: dict,
                 overlapped_with: str = "") -> list:
    """Wait for the soaks :func:`start_chaos` started: one ``phase:
    chaos`` line each with the soak's summary, its seconds from the
    start (``run_s``), its kernel launches and the ring shapes it made,
    and ``overlapped_with``, the leg that ran meanwhile. The chaos
    soak's launches go to ``legs["chaos"]`` and its ring shapes to
    ``shapes["chaos"]`` (checked and timed against the plain version
    with every other leg's). A soak that exits non-zero, runs past
    ``SOAK_TIMEOUT_S``, prints no summary or one without ``"ok": true``,
    or a chaos soak that launched no ring kernel, fails the smoke."""
    for t in started["waiters"]:
        t.join()
    done = started["done"]
    lines = []
    for name, _, argv in CHAOS_SOAKS:
        rc, out, err, run_s = done[name]
        summary, child = None, None
        for ln in out.splitlines():
            if ln.startswith('{"ok"'):
                summary = json.loads(ln)
            elif ln.startswith('{"soak_launches"'):
                child = json.loads(ln)
        if rc != 0 or summary is None or summary.get("ok") is not True \
                or child is None:
            print(out[-8000:], err[-8000:], sep="\n", file=sys.stderr)
            verdict = None if summary is None else summary.get("ok")
            fail(f"phase chaos: {name} exited {rc} (summary ok: "
                 f"{verdict})")
        line = {"phase": "chaos", "part": name, "argv": list(argv),
                "run_s": run_s, "overlapped_with": overlapped_with,
                "launches": child["soak_launches"],
                "ring_shapes": child["soak_ring_shapes"],
                "summary": summary}
        report(line)
        lines.append(line)
        note_plans(name, plan_counts_of(child["soak_plan_passes"]))
        if name == "chaos_soak":
            legs["chaos"] = {"launches": child["soak_launches"],
                             "run_s": run_s}
            shapes["chaos"] = {(tuple(shape), a2a): n for shape, a2a, n
                               in child["soak_ring_shapes"]}
    n = legs["chaos"]["launches"]
    if n["ring_exchange"] + n["ring_all_to_all"] <= 0:
        fail("phase chaos: the chaos soak launched no ring kernel")
    return lines


def durability_and_chaos(legs: dict, shapes: dict, names) -> None:
    """Legs Q and Q-small and the chaos phase, those of them in
    ``names``. With Q-small, the soaks start once its launch-failure
    child has exited and run beside the rest of it (card against CPU
    reads, mostly on the host); the phase's lines follow Q-small's."""
    if "Q" in names:
        run_leg(legs, shapes, "Q", leg_q)
    if "chaos" in names:
        gc.collect()
        torch.cuda.empty_cache()
    if "chaos" in names and "Q-small" in names:
        started = {}
        run_leg(legs, shapes, "Q-small", lambda: leg_q_small(
            after_child=lambda: started.update(start_chaos())))
        finish_chaos(started, legs, shapes, overlapped_with="Q-small")
    elif "Q-small" in names:
        run_leg(legs, shapes, "Q-small", leg_q_small)
    elif "chaos" in names:
        finish_chaos(start_chaos(), legs, shapes)


NEW_LEGS = (("M-small", leg_m_small), ("P", leg_p), ("N", leg_n),
            ("O", leg_o), ("M", leg_m))
SERVICE_LEGS = (("S", leg_s), ("service", service_phase))


def main(argv=None) -> int:
    """``--legs M,P,Q`` runs only those of legs M-Q, S and T (M-small and
    Q-small included, and ``native_staging``, ``obs``, ``service`` and
    ``chaos`` for those phases; T brings ``phase: distributed``) and
    prints the ring shapes they launched, without the kernel phases or
    the table check: a quick run while a leg is brought up.
    ``--launch-failure-child`` is leg Q-small's child process,
    ``--distributed-worker`` leg T's, ``--join-reference`` and
    ``--als-reference`` legs J's and L's checks, ``--soak-child`` the
    chaos phase's."""
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
    if args[:1] == ["--distributed-worker"]:
        return distributed_worker(args[1:])
    if args[:1] == ["--als-reference"]:
        return als_reference_child(args[1])
    if args[:1] == ["--join-reference"]:
        return join_reference_child(args[1])
    if args[:1] == ["--soak-child"]:
        return soak_child(args[1], args[2:])
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
        durability_and_chaos(legs, shapes, only)
        if "native_staging" in only:
            native_staging_phase(build_s, legs)
        if "obs" in only:
            obs_phase()
        for name, fn in SERVICE_LEGS:
            if name in only:
                run_leg(legs, shapes, name, fn)
        if "T" in only:
            run_leg(legs, shapes, "T", leg_t)
            split_leg_t(legs, shapes)
        plan_counts_phase()
        map_passes_phase()
        report({"smoke_s": time.perf_counter() - t_smoke})
        report({"recorded_ring_shapes": sorted(
            [leg_name, list(shape), a2a, n]
            for leg_name, counts in shapes.items()
            for (shape, a2a), n in counts.items())})
        return 0
    start_references()
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
    durability_and_chaos(legs, shapes, ("Q", "Q-small", "chaos"))
    t0 = time.perf_counter()
    native_staging_phase(build_s, legs)
    report({"leg_s": "native_staging", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    obs_phase()
    report({"leg_s": "obs", "seconds": time.perf_counter() - t0})
    for name, fn in SERVICE_LEGS:
        run_leg(legs, shapes, name, fn)
    run_leg(legs, shapes, "T", leg_t)
    push = split_leg_t(legs, shapes)
    ring_legs = ring_leg_phases(shapes)
    plan_lines = plan_counts_phase()
    map_lines = map_passes_phase()
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
    for name in ("T", "U", "V", "distributed"):
        if legs[name]["launches"]["merge_stage"] <= 0:
            fail(f"merge_stage was not launched in leg {name}'s workers")
    for k, name in (("ring_push", "T"), ("ring_push", "V"),
                    ("ring_push", "distributed"),
                    ("ring_push_all_to_all", "distributed")):
        if legs[name]["launches"][k] <= 0:
            fail(f"{k} was not launched in leg {name}'s workers")
    for k, name in (("ring_exchange", "Q"), ("merge_stage", "Q"),
                    ("ring_exchange", "Q-small"), ("merge_stage", "Q-small"),
                    ("ring_all_to_all", "Q-small")):
        if legs[name]["launches"][k] <= 0:
            fail(f"{k} was not launched on leg {name}")

    def launches(k):
        return sum(legs[n]["launches"].get(k, 0) for n in legs)

    def by_leg(k):
        return {n: legs[n]["launches"].get(k, 0) for n in legs}

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
        push_entry(push, "ring_push", "sparkrdma_tpu/exchange/ring.py:140",
                   launches("ring_push"), by_leg("ring_push")),
        push_entry(push, "ring_push_all_to_all",
                   "sparkrdma_tpu/exchange/ring.py:87",
                   launches("ring_push_all_to_all"),
                   by_leg("ring_push_all_to_all")),
        plan_entry(plan_lines, launches("partition_counts"),
                   by_leg("partition_counts")),
        map_entry(map_lines, launches("bucket_scatter"),
                  by_leg("bucket_scatter")),
    ]
    report({"smoke_s": time.perf_counter() - t_smoke})
    report({"kernels": kernels})
    report({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


def split_leg_t(legs: dict, shapes: dict) -> dict:
    """Leg T's result holds U's, V's and the phase's, and the ring shapes
    its workers launched: give each its own entry. Returns the push
    lines."""
    for name in ("U", "V", "distributed"):
        legs[name] = legs["T"].pop(name)
    for part, counts in legs["T"].pop("ring_shapes").items():
        mine = shapes.setdefault(part, {})
        for key, n in counts.items():
            mine[key] = mine.get(key, 0) + n
    for worker in legs["T"].pop("plan_passes"):
        for part, rows in worker.items():
            note_plans(part, plan_counts_of(rows))
    return legs["T"].pop("push")


def push_entry(push: dict, name: str, replaces: str, launches: int,
               by_leg: dict) -> dict:
    """The ``kernels`` line's entry of a push wrapper: its numbers at the
    largest shape it was checked at (leg T's read for ``ring_push``),
    every shape's beside them."""
    a2a = name == "ring_push_all_to_all"
    lines = [v for (_, flag), v in sorted(push["lines"].items())
             if flag == a2a]
    if not lines:
        fail(f"{name} was checked at no shape")
    top = max(lines, key=lambda v: v["bound_ms"])
    return {"name": name, "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_leg": by_leg, "shape": top["shape"],
            "max_abs_err": max(v["max_abs_err"] for v in lines),
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"],
            "worker_ms": top["worker_ms"],
            "worker_bound_ms": top["worker_bound_ms"],
            "handshake_us_per_move": push["handshake"][
                "handshake_us_per_move"],
            "shapes": [{k: v[k] for k in ("shape", "max_abs_err",
                                          "kernel_ms", "bound_ms")}
                       for v in lines]}


def plan_entry(lines: list, launches: int, by_leg: dict) -> dict:
    """The ``kernels`` line's entry of ``partition_counts``: its numbers
    at the pass with the most key bytes, every pass's beside them."""
    if not lines:
        fail("partition_counts was checked at no plan pass")
    top = max(lines, key=lambda v: v["bound_ms"])
    return {"name": "partition_counts", "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/partition_counts.cu",
            "replaces": None, "launches": launches,
            "launches_by_leg": by_leg, "shape": top["shape"],
            "max_abs_err": max(v["max_abs_err"] for v in lines),
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "passes": [{k: v[k] for k in ("shape", "kind", "split_k",
                                          "bins", "legs", "max_abs_err",
                                          "kernel_ms", "bound_ms")}
                       for v in lines]}


def map_entry(lines: list, launches: int, by_leg: dict) -> dict:
    """The ``kernels`` line's entry of ``bucket_scatter``: its numbers at
    the map pass with the most bytes, every pass's beside them."""
    if not lines:
        fail("bucket_scatter was checked at no map pass")
    top = max(lines, key=lambda v: v["bound_ms"])
    return {"name": "bucket_scatter", "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/bucket_scatter.cu",
            "replaces": None, "launches": launches,
            "launches_by_leg": by_leg, "shape": top["shape"],
            "max_abs_err": max(v["max_abs_err"] for v in lines),
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "passes": [{k: v[k] for k in ("shape", "kind", "split_k",
                                          "bins", "legs", "max_abs_err",
                                          "kernel_ms", "bound_ms")}
                       for v in lines]}


def earlier_legs(legs: dict, shapes: dict):
    """Legs A-H, into ``legs``, and the ring shapes each launched, into
    ``shapes``; returns the ring kernel's phases at leg F's chunk shape
    and leg H's."""
    outs = {}
    for name, d, transport, fused in (("A", 1, "xla", True),
                                      ("B", 8, "pallas_ring", True),
                                      ("C", 8, "pallas_ring", False)):
        with RingShapes() as seen, PlanPasses() as plans:
            legs[name], out, totals = leg(name, d, RECORDS, transport,
                                          fused, seed=0, full=True)
        shapes[name] = seen.counts
        note_plans(name, plans.counts)
        if name in ("B", "C"):
            outs[name] = (out, totals)
        del out, totals
        torch.cuda.empty_cache()
        with RingShapes() as seen, PlanPasses() as plans:
            leg(name + "-small", d, 1 << 20, transport, fused, seed=5,
                full=False)
        shapes[name + "-small"] = seen.counts
        note_plans(name + "-small", plans.counts)
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

    run_leg(legs, shapes, "D", leg_d)
    run_leg(legs, shapes, "D-small", leg_d_small)
    run_leg(legs, shapes, "E", leg_e)
    run_leg(legs, shapes, "F", lambda: leg_f(legs["B"]["gbps"]))
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
