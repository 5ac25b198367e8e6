"""The control: the reference with the key cut to its first word, put in
the program's place, comes out not correct in every cell."""

import pytest
import torch

from shufflebench import control, registry
from shufflebench.cell import PAYLOAD, WINDOW_JOBS, job_seed, make_words

BENCH = registry.benchmark()
# 2^20 records: about 64 pairs share a first key word in a sort
N = 1 << 20


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(name):
    wl = registry.workload(BENCH, name)
    cfg = registry.config(BENCH, wl["config"])
    mix = registry.mix(wl["traffic"])
    seed = 2 ** 31 + 99
    records = torch.cat([
        make_words(mix["keys"], N, job_seed(seed, WINDOW_JOBS, 0), "cpu"),
        make_words(cfg["payload"], N, job_seed(seed, PAYLOAD, 0), "cpu")])
    args = (mix["check"], records, cfg["partitions"], cfg["key_words"])
    got = control.read_numbers(*args, control.KEY_USED)
    assert any(v > 0 for v in got.values()), got
    # the same comparison passes the reference's own read
    full = control.read_numbers(*args, cfg["key_words"])
    assert full and all(v == 0 for v in full.values()), full
