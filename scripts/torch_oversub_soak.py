#!/usr/bin/env python3
"""Out-of-core oversubscription soak of the PyTorch port: a shuffle whose
map output is >= 10x the aggregate slot budget, run through the tiered
store and proved bit-identical to an all-resident control.

The port's counterpart of ``scripts/oversub_soak.py``: the same two
passes, geometry, audit, JSON summary and exit codes, with the port's
manager (``sparkrdma_tpu_torch``), its partitions stacked on one device
(``--partitions``, on ``--device``).

Two passes over the same seeded data on the same partitions:

1. **Control** — tiered-store watermark raised above the dataset, so
   nothing spills (``store_stats`` spill bytes must be 0).
2. **Oversubscribed** — watermark clamped to ``spill_tier_prefetch + 2``
   chunks, so the map output cycles device -> host leases -> CRC'd disk
   segments while the exchange runs. The sorted stream must match the
   control bit for bit (full-record total order is unique).

The journal is then audited for the overlap contract:

- every spill/promote ran INSIDE an exchange span's event timeline
  (``spill:write`` / ``spill:promote`` events on spans — tier I/O
  overlapped rounds instead of serializing around them);
- a fault-free soak has ZERO synchronous fetches (``store_sync_fetches``
  still at 0 on the final span): the prefetcher hid every disk read.

Usage::

    python scripts/torch_oversub_soak.py                          # the card
    python scripts/torch_oversub_soak.py --device cpu             # no card
    python scripts/torch_oversub_soak.py --chunk-records 262144 --oversub 2048

Exit 0: bit-identical, >= ``--oversub`` oversubscribed, overlap proven,
no sync fetches. Exit 2: fewer than 2 partitions (gated, not a failure).
Prints one JSON summary line: the reference's fields, and the device it
ran on.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_spans(path: str) -> list:
    spans = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if not obj.get("kind"):
                spans.append(obj)
    return spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="oversubscribed out-of-core shuffle soak of the "
                    "PyTorch port (tiered store vs all-resident control)")
    ap.add_argument("--chunk-records", type=int, default=4096)
    ap.add_argument("--oversub", type=float, default=10.0,
                    help="minimum map-output / slot-budget ratio")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--partitions", type=int, default=8,
                    help="shuffle partitions stacked on the device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device (pass "
                           "--device cpu to soak on the host)")
    if args.partitions < 2:
        print(json.dumps({"ok": "skipped",
                          "reason": "needs >= 2 partitions"}))
        return 2

    mesh = args.partitions
    w = 4
    slot_records = 256
    chunk = args.chunk_records
    # aggregate slot budget: one round buffer's records per partition,
    # across the partitions — the working set the exchange keeps resident
    hbm_budget = mesh * slot_records * w * 4
    chunk_bytes = w * chunk * 4
    n_chunks = max(2, int(np.ceil(args.oversub * hbm_budget / chunk_bytes)))
    oversub = n_chunks * chunk_bytes / hbm_budget
    cols = np.random.default_rng(args.seed).integers(
        0, 2**32, size=(w, n_chunks * chunk), dtype=np.uint32)

    prefetch = 2
    with tempfile.TemporaryDirectory(prefix="torch_oversub_soak_") as tmp:
        journal = os.path.join(tmp, "journal.jsonl")
        conf = ShuffleConf(
            slot_records=slot_records,
            spill_dir=os.path.join(tmp, "spill"),
            spill_tier_dir=os.path.join(tmp, "tier"),
            # holds lookahead+2 chunks: promotions never thrash back out
            spill_tier_host_bytes=(prefetch + 2) * chunk_bytes,
            spill_tier_prefetch=prefetch,
            metrics_sink=journal)
        m = ShuffleManager(MeshRuntime(conf, mesh, device=args.device),
                           conf)
        try:
            # control: watermark >> dataset, nothing spills
            m.tiered._watermark = 1 << 40
            print("control pass (all resident)...", file=sys.stderr,
                  flush=True)
            control = run_tiered_terasort(m, cols, chunk_records=chunk,
                                          shuffle_id_base=9000)
            m.tiered._watermark = conf.spill_tier_host_bytes
            print(f"oversubscribed pass ({oversub:.1f}x slot budget, "
                  f"{n_chunks} chunks)...", file=sys.stderr, flush=True)
            tiered = run_tiered_terasort(m, cols, chunk_records=chunk,
                                         shuffle_id_base=9000 + n_chunks)
        finally:
            m.stop()

        spans = read_spans(journal)

    spill, fetch, hits, sync = tiered.store_stats
    identical = bool(np.array_equal(control.rows, tiered.rows))
    ev_names = [e.get("name") for s in spans for e in (s.get("events") or [])]
    overlap = ev_names.count("spill:write") > 0 \
        and ev_names.count("spill:promote") > 0

    ok = (identical and control.store_stats[0] == 0 and spill > 0
          and fetch > 0 and sync == 0 and overlap
          and oversub >= args.oversub)
    print(json.dumps({
        "ok": ok,
        "oversub_factor": round(oversub, 2),
        "chunks": n_chunks,
        "map_output_bytes": n_chunks * chunk_bytes,
        "hbm_slot_budget_bytes": hbm_budget,
        "bit_identical": identical,
        "control_spill_bytes": control.store_stats[0],
        "spill_bytes": spill,
        "fetch_bytes": fetch,
        "prefetch_hits": hits,
        "sync_fetches": sync,
        "overlap_events": {"spill:write": ev_names.count("spill:write"),
                           "spill:promote": ev_names.count("spill:promote")},
        "gbps": round(tiered.gbps, 4),
        "device": str(args.device),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
