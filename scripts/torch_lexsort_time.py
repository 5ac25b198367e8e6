"""Time the sort-by-key kernel against its plain version on the card.

At the benchmark cells' shapes, a job's 8 partitions one call each, as the
exchange calls it:

- ``terasort.sort``'s tail: 8 x 6,291,456 records of 25 words, 3 key
  words (word 2 below 2^16), each partition a column slice of the
  accumulator (row stride 8 x 8,388,608 + 4096) sorted over its received
  prefix straight into its slice of a zeroed output;
- ``tpch_q18.groupby_orderkey``'s reduce-side combine: 8 x 16,777,216
  lines of 3 words, 2 key words (the sparse order keys of a contiguous
  run of 2^25 orders), an all-true mask;
- ``reducebykey.wordcount``'s map-side combine: 8 x 8,388,608 records of
  5 words (the destination, key words 0 and a word index below 1000, the
  count 1 and 0), 3 key words under a mask.

Prints one JSON line per shape: ``device_ms`` (a call: the 8 calls back to
back between two CUDA events; every partition is read cold),
``call_ms`` (one call at a time, the host's launch path included, median
of 8), ``bound_ms`` (every record read once and written once, the key
words read once more: (W x 8 + key words x 4) B a record at 3.35 TB/s),
``share`` of the bound, ``passes`` (the digits that vary, of all the key
digits: the passes that do work), ``plain_ms`` (the plain version: the
chain of stable ``torch.sort`` passes and the gather, one call) and
whether the two agree bit for bit. Needs a CUDA card:

    python3 scripts/torch_lexsort_time.py
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sparkrdma_tpu_torch.kernels import sort as S  # noqa: E402

HBM_BYTES_S = 3.35e12
L = 8


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return {"gpu": torch.cuda.get_device_name(0),
            "smi": out[0] if out else ""}


def _words(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


def _passes(x: torch.Tensor, kw: int, valid) -> list:
    """[digits that vary, key digits] of a partition's records."""
    runs = 0
    for k in range(kw):
        diff = x[k] ^ x[k, :1]
        runs += sum(int(((diff >> (8 * b)) & 0xFF).any()) for b in range(4))
    digits = 4 * kw
    if valid is not None:
        digits += 1
        runs += int(bool(valid.any()) and not bool(valid.all()))
    return [runs, digits]


def _time(cell, calls, plain_one, check, records, w, kw, passes) -> bool:
    equal = check()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def job():
        for call in calls:
            call()

    job()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        job()
    b.record()
    torch.cuda.synchronize()
    dev = a.elapsed_time(b) / (3 * len(calls))
    times = []
    for call in calls:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    plain_one()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    plain_one()
    e.record()
    torch.cuda.synchronize()
    bound = records * (w * 8 + kw * 4) / HBM_BYTES_S * 1e3
    print(json.dumps({
        "phase": "lexsort", "cell": cell,
        "shape": f"{L} x {records} records of {w} words, {kw} key words",
        "narrow": S.carries_whole_records(w, kw), "passes": passes,
        "device_ms": round(dev, 4),
        "call_ms": round(statistics.median(times), 4),
        "bound_ms": round(bound, 4), "share": round(bound / dev, 4),
        "plain_ms": round(s.elapsed_time(e), 3), "equal": equal}),
        flush=True)
    torch.cuda.empty_cache()
    return equal


def terasort(gen) -> bool:
    n, oc, cap = 6291456, 8388608, 4096
    acc = torch.zeros((25, L * oc + cap), dtype=torch.int32, device="cuda")
    for d in range(L):
        acc[:, d * oc:d * oc + n] = _words((25, n), gen)
    acc[2] &= 0xFFFF
    out = torch.zeros((25, L * oc), dtype=torch.int32, device="cuda")
    parts = [(acc[:, d * oc:(d + 1) * oc], out[:, d * oc:(d + 1) * oc])
             for d in range(L)]
    calls = [lambda x=x, o=o: S.lexsort_cols(x, 3, n=n, out=o)
             for x, o in parts]

    def check():
        got = S.lexsort_cols(parts[0][0], 3, n=n, out=parts[0][1])
        want = S.lexsort_cols_plain(parts[0][0], 3, None, n,
                                    torch.zeros_like(parts[0][0]))
        return torch.equal(got, want)

    def plain():
        S.lexsort_cols_plain(parts[1][0], 3, None, n, parts[1][1])

    return _time("terasort.sort", calls, plain, check, n, 25, 3,
                 _passes(parts[0][0][:, :n], 3, None))


def q18(gen) -> bool:
    n = 16777216
    order = torch.randint(0, 2 ** 25, (L, n), generator=gen, device="cuda",
                          dtype=torch.int64) + 123_456_789
    key = (order >> 3) * 32 + (order & 7) + 1
    xs = []
    for d in range(L):
        x = torch.empty((3, n), dtype=torch.int32, device="cuda")
        x[0] = (key[d] >> 32).to(torch.int32)
        x[1] = (key[d] & 0xFFFFFFFF).to(torch.int32)
        x[2] = torch.randint(100, 5001, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        xs.append(x)
    del order, key
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    calls = [lambda x=x: S.lexsort_cols(x, 2, valid) for x in xs]

    def check():
        return torch.equal(S.lexsort_cols(xs[0], 2, valid),
                           S.lexsort_cols_plain(xs[0], 2, valid))

    return _time("tpch_q18.groupby_orderkey", calls,
                 lambda: S.lexsort_cols_plain(xs[1], 2, valid), check, n, 3,
                 2, _passes(xs[0], 2, valid))


def wordcount(gen) -> bool:
    n = 8388608
    xs = []
    for _ in range(L):
        x = torch.zeros((5, n), dtype=torch.int32, device="cuda")
        x[0] = torch.randint(0, 8, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        x[2] = torch.randint(0, 1000, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        x[3] = 1
        xs.append(x)
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    calls = [lambda x=x: S.lexsort_cols(x, 3, valid) for x in xs]

    def check():
        return torch.equal(S.lexsort_cols(xs[0], 3, valid),
                           S.lexsort_cols_plain(xs[0], 3, valid))

    return _time("reducebykey.wordcount", calls,
                 lambda: S.lexsort_cols_plain(xs[1], 3, valid), check, n, 5,
                 3, _passes(xs[0], 3, valid))


def main() -> int:
    card = _card()
    print(json.dumps({"phase": "card", **card}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(26)
    ok = True
    for run in (terasort, q18, wordcount):
        ok &= run(gen)
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "launches": S.lexsort_cols.launches,
                      **card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
