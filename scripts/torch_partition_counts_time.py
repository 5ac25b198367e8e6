"""Time the plan pass's count kernel against its plain version on the card.

At the benchmark cells' shapes (TeraSort: 8 x 6,291,456 records of 25
words, range and hash over 3 key words; WordCount: 8 x 8,388,608 records
of 4 words, hash over 2), with and without the plan's split, prints one
JSON line per shape: ``device_ms`` (the kernel and its table's zeroing,
CUDA events over back-to-back launches; the key words, 537-604 MB, do
not fit in L2, so every launch reads them cold), ``bound_ms`` (key bytes
read once at 3.35 TB/s), ``share`` of the bound, ``plain_ms`` (the plain
version, which syncs with the host), ``pass_ms`` (host clock of one
kernel pass through the copy of its table to the host, as the plan
runs it) and whether the two tables are equal. Needs a CUDA card:

    python3 scripts/torch_partition_counts_time.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sparkrdma_tpu_torch.exchange import partitioners  # noqa: E402
from sparkrdma_tpu_torch.exchange.protocol import split_partitioner  # noqa: E402,E501
from sparkrdma_tpu_torch.kernels import partition_counts as pc  # noqa: E402

HBM_BYTES_S = 3.35e12
L = 8


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return {"gpu": torch.cuda.get_device_name(0),
            "smi": out[0] if out else ""}


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _host_ms(fn, reps: int) -> float:
    fn()
    best = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        best.append((time.perf_counter() - t) * 1e3)
    return float(np.median(best))


def _records(words: int, key_specs, n: int, seed: int) -> torch.Tensor:
    """``int32[words, n]`` on the card: key words uniform (the last one
    below ``high`` where given), the rest zero, as one tensor."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.zeros((words, n), dtype=torch.int32, device="cuda")
    for w, high in enumerate(key_specs):
        x[w] = torch.randint(0, high, (n,), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
    return x


def main() -> int:
    card = _card()
    print(json.dumps({"phase": "card", **card}), flush=True)
    ts = _records(25, [2 ** 32, 2 ** 32, 2 ** 16], L * 6291456, 1)
    keys = ts[:3, ::4096].T.cpu().numpy().view(np.uint32)
    keys = keys[np.lexsort(keys.T[::-1])]
    spl = keys[np.linspace(0, len(keys) - 1, 9).astype(int)[1:-1]]
    rng = partitioners.range_partitioner(spl, 3)
    h3 = partitioners.hash_partitioner(8, 3)
    wc = _records(4, [1, 1000], L * 8388608, 2)
    h2 = partitioners.hash_partitioner(8, 2)
    cases = [
        ("terasort.sort", ts, rng, 8, 3),
        ("terasort.sort", ts, split_partitioner(rng, 8, 4), 32, 3),
        ("terasort.repartition", ts, h3, 8, 3),
        ("terasort.repartition", ts, split_partitioner(h3, 8, 4), 32, 3),
        ("reducebykey.wordcount", wc, h2, 8, 2),
        ("reducebykey.wordcount", wc, split_partitioner(h2, 8, 5), 40, 2),
    ]
    ok = True
    for cell, x, part, bins, kw in cases:
        n = x.shape[1]
        got = pc.partition_counts(x, part, bins, L)
        want = pc.partition_counts_plain(x, part, bins, L)
        equal = bool(torch.equal(got, want))
        ok &= equal
        dev = _events_ms(lambda: pc.partition_counts(x, part, bins, L), 20)
        plain = _events_ms(
            lambda: pc.partition_counts_plain(x, part, bins, L), 3)
        pass_ms = _host_ms(
            lambda: pc.partition_counts(x, part, bins, L).cpu(), 10)
        bound = n * kw * 4 / HBM_BYTES_S * 1e3
        print(json.dumps({
            "phase": "partition_counts", "cell": cell,
            "shape": f"{L} x {n // L} records, {kw} key words",
            "kind": part.device_spec.kind,
            "split_k": part.device_spec.split_k, "bins": bins,
            "device_ms": round(dev, 4), "bound_ms": round(bound, 4),
            "share": round(bound / dev, 4), "plain_ms": round(plain, 3),
            "pass_ms": round(pass_ms, 4), "equal": equal,
            "total": int(got.sum())}), flush=True)
    print(json.dumps({"ok": ok, "launches": pc.partition_counts.launches,
                      **card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
