"""The reference against the program on the CPU at a small size: every
cell's job read by the port is what the reference works out; a read
with one record wrong, lost or out of place is not."""

import json

import pytest
import torch

from shufflebench import reference, registry
from shufflebench.cell import WINDOW_JOBS, Cell
from shufflebench.checks import reduce_sum

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# 8 partitions of 8192 records, 256-record slots: the plan streams
SMALL = {"records_per_job": 1 << 16, "conf": {"slot_records": 256}}


def _cell(name, seed=11):
    wl = registry.workload(BENCH, name)
    return Cell(registry.config(BENCH, wl["config"]),
                registry.mix(wl["traffic"]), seed, "cpu", SMALL)


@pytest.mark.parametrize("name", CELLS)
def test_port_reads_what_the_reference_works_out(name):
    cell = _cell(name)
    try:
        records = cell.records(WINDOW_JOBS, 0)
        rec, out, totals = cell.job(records,
                                    cell.sampler_seed(WINDOW_JOBS, 0))
        assert rec["plan"]["num_rounds"] > cell.conf.max_rounds_in_flight
        rows, tot = cell.keep(out, totals)
        assert rows.shape[1] == sum(tot) and min(tot) > 0
        check = cell.mix["check"]
        mod = registry.check(check)

        def numbers(rows, t=tot):
            return mod.compare(records, rows, t, cell.parts, cell.key_words)

        got = numbers(rows)
        assert got and all(v == 0 for v in got.values()), got
        last = sum(tot[:-1])
        # one word of one record of the last partition altered
        bad = rows.clone()
        bad[cell.key_words, last + tot[-1] // 2] ^= 1
        assert numbers(bad)["rows_mismatched"] > 0
        # the last record lost
        lost = numbers(rows[:, :-1], tot[:-1] + [tot[-1] - 1])
        assert lost["count_mismatch"] > 0
        # the first records of the first and last partitions swapped
        perm = list(range(rows.shape[1]))
        perm[0], perm[last] = perm[last], perm[0]
        assert sum(numbers(rows[:, perm]).values()) > 0
        # two records of one partition swapped: out of order in a sorted
        # or reduced read, where the order is part of the answer
        perm = list(range(rows.shape[1]))
        perm[last], perm[last + 1] = perm[last + 1], perm[last]
        if check != "hash_placement":
            assert sum(numbers(rows[:, perm]).values()) > 0
    finally:
        cell.stop()


def test_reduce_reference_by_hand():
    # keys (0, 5) twice and (1, 2) once; values in word 2; word 3 zero
    rec = torch.tensor([[0, 1, 0], [5, 2, 5], [7, 3, -1], [0, 0, 0]],
                       dtype=torch.int32)
    rows, totals = reduce_sum.read(rec, 2, 2, 2)
    got = {tuple(c) for c in rows.T.tolist()}
    # 7 + 0xFFFFFFFF wraps to 6
    assert got == {(0, 5, 6, 0), (1, 2, 3, 0)} and sum(totals) == 2
    p = reference.hash_pids(rows[:2], 2).tolist()
    assert [sum(1 for x in p if x == d) for d in range(2)] == totals


def test_hash_matches_the_partitioner_rule():
    # h = (h ^ w) * 2654435761 mod 2^32 over the key words, then h ^ h>>16
    keys = torch.tensor([[0, 7, -1], [1, 9, -2]], dtype=torch.int32)
    want = []
    for a, b in keys.T.tolist():
        h = 0
        for w in (a & 0xFFFFFFFF, b & 0xFFFFFFFF):
            h = ((h ^ w) * 2654435761) & 0xFFFFFFFF
        want.append((h ^ (h >> 16)) % 8)
    assert reference.hash_pids(keys, 8).tolist() == want


def test_unsigned_order():
    rows = torch.tensor([[-1, 0, 1, -2147483648], [0, 5, 0, 0]],
                        dtype=torch.int32)
    perm = reference.lexsort(rows, 2).tolist()
    assert perm == [1, 2, 3, 0]      # 0, 1, 2^31, 2^32 - 1
