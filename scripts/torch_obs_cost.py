#!/usr/bin/env python3
"""What the port's observability knobs cost a read, one knob at a time.

    python3 scripts/torch_obs_cost.py [--rounds N]

Builds ``chip_smoke.py``'s two ``obs`` cells (leg F's: the reference's
default geometry, 16,777,216 × 100-byte records streamed in 17 chunks;
leg B's: the fused ring with ``fast_sort``) and, over the same records,
one manager per arm:

  none      every knob at its default (off)
  journal   ``metrics_sink`` (the journal, and with it the timeline)
  stats     ``collect_shuffle_read_stats``
  watchdog  ``watchdog_timeout_s=30``
  all       the three together (the ``obs`` phase's journal-on arm)

After a warm-up read each, ``--rounds`` rounds of one read per arm in
turns; prints one JSON line per cell with each arm's median GB/s (record
bytes over the host time of a ``read()``, which ends in its device
sync) and its ratio to ``none``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import torch

ARMS = {
    "none": {},
    "journal": {"metrics_sink": "{root}/journal.jsonl"},
    "stats": {"collect_shuffle_read_stats": True},
    "watchdog": {"watchdog_timeout_s": 30.0},
    "all": {"metrics_sink": "{root}/all.jsonl",
            "collect_shuffle_read_stats": True, "watchdog_timeout_s": 30.0},
}


def load_smoke(here: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cell(smoke, name: str, rounds: int, root: str) -> dict:
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
    from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                   make_sampler)
    from sparkrdma_tpu_torch.workloads.terasort import random_records

    words = smoke.KEY_WORDS + smoke.VAL_WORDS
    recs = random_records(smoke.RECORDS, words, 11, "cuda")
    part = range_partitioner(compute_splitters(make_sampler(
        smoke.PARTS, smoke.KEY_WORDS, 256, 11)(recs), smoke.PARTS))
    managers, readers = [], {}
    for arm, knobs in ARMS.items():
        knobs = {k: v.format(root=os.path.join(root, name))
                 if isinstance(v, str) else v for k, v in knobs.items()}
        os.makedirs(os.path.join(root, name), exist_ok=True)
        m = ShuffleManager(MeshRuntime(smoke.default_conf(
            val_words=smoke.VAL_WORDS, **smoke.OBS_CELLS[name], **knobs),
            num_partitions=smoke.PARTS, device="cuda"))
        h = m.register_shuffle(1, smoke.PARTS, part)
        m.get_writer(h).write(recs).stop()
        readers[arm] = m.get_reader(h, key_ordering=True)
        readers[arm].read()
        managers.append(m)
    gbps = {arm: [] for arm in ARMS}
    for _ in range(rounds):
        for arm, reader in readers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reader.read()
            gbps[arm].append(smoke.RECORDS * words * 4
                             / (time.perf_counter() - t0) / 1e9)
    for m in managers:
        m.stop()
    del readers, managers, recs
    torch.cuda.empty_cache()
    med = {arm: statistics.median(v) for arm, v in gbps.items()}
    return {"cell": name, "rounds": rounds, "gbps": gbps,
            "gbps_median": med,
            "over_none": {arm: med[arm] / med["none"] for arm in ARMS}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_obs_cost: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    smoke = load_smoke(here)
    from sparkrdma_tpu_torch import _build

    _build.build_all()
    _build.build_native()
    root = tempfile.mkdtemp(prefix="torch_obs_cost_")
    for name in smoke.OBS_CELLS:
        print(json.dumps(cell(smoke, name, args.rounds, root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
