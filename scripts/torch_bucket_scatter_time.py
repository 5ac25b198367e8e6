"""Time the read's bucketing kernel against its plain version on the card.

At the benchmark cells' shapes, as their plans split them (TeraSort: 8 x
6,291,456 records of 25 words, range and hash over 3 key words, split 4
ways into 32 bins; TPC-H Q18: 8 x 16,777,216 lines of 3 words, hash over
2, split 9 ways into 72 bins), prints one JSON line per shape:
``device_ms`` (the wrapper's three kernels and its two fills: 10 calls
back to back between two CUDA events, the host enqueueing ahead; the
batch, 0.6-5 GB, does not fit in L2, so every call reads it cold),
``call_ms`` (one call at a time, the host's launch path included, median
of 10), ``bound_ms`` (every word read once and written once and the key
words read once more, (W x 4 x 2 + key words x 4) B a record, at 3.35
TB/s), ``share`` of the bound, ``plain_ms`` (the plain version: a source
at a time through the partitioner, ``bucket_records`` and the
concatenation, which sync with the host) and whether the two agree bit
for bit. Needs a CUDA card:

    python3 scripts/torch_bucket_scatter_time.py
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sparkrdma_tpu_torch.exchange import partitioners  # noqa: E402
from sparkrdma_tpu_torch.exchange.protocol import split_partitioner  # noqa: E402,E501
from sparkrdma_tpu_torch.kernels import bucket_scatter as bs  # noqa: E402

HBM_BYTES_S = 3.35e12
L = 8


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return {"gpu": torch.cuda.get_device_name(0),
            "smi": out[0] if out else ""}


def _events_ms(fn, reps: int) -> float:
    """``reps`` calls back to back between two CUDA events, a call."""
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


def _call_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls, each timed alone by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _records(words: int, key_specs, n: int, seed: int) -> torch.Tensor:
    """``int32[words, n]`` on the card: key words uniform (below ``high``
    where given), the rest uniform too."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31, (words, n), generator=gen,
                      device="cuda", dtype=torch.int64).to(torch.int32)
    for w, high in enumerate(key_specs):
        x[w] = torch.randint(0, high, (n,), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
    return x


def main() -> int:
    card = _card()
    print(json.dumps({"phase": "card", **card}), flush=True)
    ok = True
    ts = _records(25, [2 ** 32, 2 ** 32, 2 ** 16], L * 6291456, 1)
    keys = ts[:3, ::4096].T.cpu().numpy().view(np.uint32)
    keys = keys[np.lexsort(keys.T[::-1])]
    spl = keys[np.linspace(0, len(keys) - 1, 9).astype(int)[1:-1]]
    cases = [
        ("terasort.sort", split_partitioner(
            partitioners.range_partitioner(spl, 3), 8, 4), 32, 3),
        ("terasort.repartition", split_partitioner(
            partitioners.hash_partitioner(8, 3), 8, 4), 32, 3),
    ]
    for cell, part, bins, kw in cases:
        ok &= _time(cell, ts, part, bins, kw)
    del ts
    torch.cuda.empty_cache()
    q18 = _records(3, [2 ** 32, 2 ** 3], L * 16777216, 2)
    ok &= _time("tpch_q18.groupby_orderkey", q18, split_partitioner(
        partitioners.hash_partitioner(8, 2), 8, 9), 72, 2)
    print(json.dumps({"ok": ok, "launches": bs.bucket_scatter.launches,
                      **card}), flush=True)
    return 0 if ok else 1


def _time(cell, x, part, bins, kw) -> bool:
    w, n = x.shape
    got = bs.bucket_scatter(x, part, bins, L)
    want = bs.bucket_scatter_plain(x, part, bins, L)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    dev = _events_ms(lambda: bs.bucket_scatter(x, part, bins, L), 10)
    call = _call_ms(lambda: bs.bucket_scatter(x, part, bins, L), 10)
    plain = _call_ms(lambda: bs.bucket_scatter_plain(x, part, bins, L), 3)
    bound = n * (w * 4 * 2 + kw * 4) / HBM_BYTES_S * 1e3
    print(json.dumps({
        "phase": "bucket_scatter", "cell": cell,
        "shape": f"{L} x {n // L} records of {w} words, {kw} key words",
        "kind": part.device_spec.kind, "split_k": part.device_spec.split_k,
        "bins": bins, "device_ms": round(dev, 4), "call_ms": round(call, 4),
        "bound_ms": round(bound, 4), "share": round(bound / dev, 4),
        "plain_ms": round(plain, 3), "equal": equal}), flush=True)
    torch.cuda.empty_cache()
    return equal


if __name__ == "__main__":
    sys.exit(main())
