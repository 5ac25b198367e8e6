"""The control of a cell's check: the reference put in the program's
place, with the key cut to its first word (32 of the 64 or 80 bits that
the configurations state: a narrower key than the one they state),
judged by the same comparison as a run. It has to come out not correct.

    python3 -m shufflebench.control --workload <cell> --seeds 1,2,3

builds the records of each seed's first ``run.CHECKED`` window jobs
exactly as a run does (without the program: no manager, no window) at
the cell's own size, and prints one JSON line per seed with the numbers
compared and whether they pass their limit 0. A run of the benchmark
never runs it.
"""

import argparse
import json
import sys

import torch

from shufflebench import registry
from shufflebench.cell import PAYLOAD, WINDOW_JOBS, job_seed, make_words
from shufflebench.run import CHECKED

#: the cut key: the first of the key's words
KEY_USED = 1


def read_numbers(check: str, records: torch.Tensor, parts: int,
                 key_words: int, key_used: int) -> dict:
    """The numbers the comparison gives for the reference's read with the
    key cut to ``key_used`` words."""
    mod = registry.check(check)
    rows, totals = mod.read(records, parts, key_words, key_used)
    return mod.compare(records, rows, totals, parts, key_words)


def main(argv=None, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    config = registry.config(bench, wl["config"])
    mix = registry.mix(wl["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            print("the control runs on a CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    n = (overrides or {}).get("records_per_job", config["records_per_job"])
    for seed in (int(s) for s in args.seeds.split(",")):
        payload = make_words(config["payload"], n,
                             job_seed(seed, PAYLOAD, 0), device)
        totals = {}
        for idx in range(CHECKED):
            keys = make_words(mix["keys"], n,
                              job_seed(seed, WINDOW_JOBS, idx), device)
            got = read_numbers(mix["check"], torch.cat([keys, payload]),
                               config["partitions"], config["key_words"],
                               KEY_USED)
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "jobs": CHECKED, "numbers": totals,
                          "correct": all(v <= 0 for v in totals.values())}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
