#!/usr/bin/env python3
"""Where the out-of-core path's time goes, on one NVIDIA card.

    python3 scripts/torch_ooc_breakdown.py [--chunks 16] [--chunk-records N]

At ``chip_smoke.py`` leg H's shape (``bench.py``'s ``run_oversub``: 100-byte
records, chunks of 2,097,152 records, host watermark four chunks, 8
stacked partitions on the fused ring) it prints one JSON line each for:

- ``tiered``: one ``run_tiered_terasort(collect=False)`` with its
  caller-side phases timed (publication ``put``s, the streamer's store
  ``get``s and staging copies, plan, read, unregister) and the store
  threads' disk writes and reads (summed over both threads, so they may
  exceed the run's wall time);
- ``fold``: one ``run_streaming_terasort`` fold over the same data, timed
  the same way;
- ``host_ops``: single host operations on one chunk — a store ``get`` of a
  resident segment (a fresh copy), a copy into a page-locked lease, a
  CRC32, a segment write and read — and the card's copy of one chunk
  from a page-locked lease (CUDA events).

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Timers:
    """Seconds and calls per label, from any thread."""

    def __init__(self):
        self.s = collections.defaultdict(float)
        self.n = collections.defaultdict(int)
        self._lock = threading.Lock()

    def wrap(self, owner, name: str, label: str, sync: bool = False):
        """Replace ``owner.name`` with a timed call (``sync``: wait for the
        card before stopping the clock)."""
        real = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                with self._lock:
                    self.s[label] += dt
                    self.n[label] += 1

        setattr(owner, name, timed)
        return lambda: setattr(owner, name, real)

    def line(self) -> dict:
        with self._lock:
            return {k: {"s": self.s[k], "calls": self.n[k]}
                    for k in sorted(self.s)}


def manager(root: str, chunk: int):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    slot = max(4096, chunk)
    conf = ShuffleConf(slot_records=slot, max_rounds=64,
                       max_slot_records=max(1 << 22, 2 * slot), val_words=23,
                       geometry_classes="fine", transport="pallas_ring",
                       spill_dir=os.path.join(root, "spill"),
                       spill_tier_dir=os.path.join(root, "tier"),
                       spill_tier_host_bytes=4 * 25 * chunk * 4,
                       spill_tier_prefetch=2)
    return ShuffleManager(MeshRuntime(conf, num_partitions=8, device="cuda"))


def instrumented(fn, m, timers: Timers):
    """Run ``fn()`` with the out-of-core path's phases timed."""
    import sparkrdma_tpu_torch.hbm.tiered_store as ts
    from sparkrdma_tpu_torch.api.shuffle_manager import (ShuffleReader,
                                                         ShuffleWriter)
    from sparkrdma_tpu_torch.hbm.input_stream import InputStreamer

    undo = [timers.wrap(m.tiered, "put", "caller: store put (publish)"),
            timers.wrap(m.tiered, "get", "caller: store get"),
            timers.wrap(InputStreamer, "_put",
                        "caller: staging copy + issue to card"),
            timers.wrap(ShuffleWriter, "stop", "caller: plan (syncs)",
                        sync=True),
            timers.wrap(ShuffleReader, "read", "caller: read", sync=True),
            timers.wrap(m, "unregister_shuffle", "caller: unregister"),
            timers.wrap(ts, "write_array", "threads: segment write + CRC"),
            timers.wrap(ts, "read_array", "threads: segment read + CRC")]
    try:
        torch.cuda.synchronize()
        return fn()
    finally:
        for u in undo:
            u()


def host_ops(cols: np.ndarray, chunk: int, root: str) -> dict:
    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.hbm.host_staging import (HostBufferPool,
                                                      read_array, write_array)
    from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore

    one = cols[:, :chunk]
    out = {"chunk_bytes": one.nbytes}

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    store = TieredStore(ShuffleConf(spill_tier_host_bytes=1 << 40))
    store.put("k", one)
    out["store_get_s"] = best(lambda: store.get("k"))
    store.close()
    pool = HostBufferPool(pinned=True)
    lease = pool.get(one.nbytes)
    view = lease.view(np.uint32, one.shape)
    out["copy_into_pinned_lease_s"] = best(lambda: view.__setitem__(
        Ellipsis, one))
    flat = np.ascontiguousarray(one)
    out["fresh_pageable_copy_s"] = best(lambda: np.array(flat))
    out["crc32_s"] = best(lambda: zlib.crc32(flat))
    path = os.path.join(root, "seg.bin")
    out["write_array_s"] = best(lambda: write_array(path, flat))
    out["read_array_s"] = best(lambda: read_array(path, np.uint32, one.shape))
    dev = torch.empty(one.shape, dtype=torch.int32, device="cuda")
    src = lease.tensor[:one.nbytes].view(torch.int32).view(one.shape)
    dev.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        dev.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    out["h2d_pinned_ms"] = start.elapsed_time(end) / 5
    out["h2d_gbps"] = one.nbytes / (out["h2d_pinned_ms"] / 1e3) / 1e9
    lease.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--chunk-records", type=int, default=1 << 21)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ooc_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from sparkrdma_tpu_torch import _build
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        run_streaming_terasort, run_tiered_terasort)

    _build.build_all()
    chunk = args.chunk_records
    cols = np.random.default_rng(5).integers(
        0, 2**32, size=(25, args.chunks * chunk), dtype=np.uint32)
    with tempfile.TemporaryDirectory(prefix="ooc_breakdown_") as tmp:
        # warm the card and the kernels on one small run first
        m = manager(os.path.join(tmp, "warm"), chunk)
        run_tiered_terasort(m, cols[:, :2 * chunk], chunk, collect=False)
        m.stop()
        for name in ("tiered", "fold"):
            m = manager(os.path.join(tmp, name), chunk)
            timers = Timers()
            t0 = time.perf_counter()
            if name == "tiered":
                res = instrumented(lambda: run_tiered_terasort(
                    m, cols, chunk, collect=False), m, timers)
                extra = {"store_stats": res.store_stats}
            else:
                res = instrumented(lambda: run_streaming_terasort(
                    m, ArrayChunkSource(cols, chunk)), m, timers)
                extra = {}
            wall = time.perf_counter() - t0
            print(json.dumps({"breakdown": name, "chunks": res.chunks,
                              "stream_s": res.stream_s, "wall_s": wall,
                              "gbps": res.gbps, "phases": timers.line(),
                              "staging": res.staging,
                              "store_host_pool": m.tiered.host_pool.stats(),
                              **extra}), flush=True)
            m.stop()
            torch.cuda.empty_cache()
        print(json.dumps({"host_ops": host_ops(cols, chunk, tmp)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
