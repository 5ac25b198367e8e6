"""A whole run on the CPU (the look for a card skipped), with the timed
path broken underneath: ``correct`` comes out false for each fault a
shuffle job can have, and true for the program as it is."""

import json

import pytest
import torch

from sparkrdma_tpu_torch.api import shuffle_manager
from sparkrdma_tpu_torch.exchange import ring
from shufflebench import registry, run

SMALL = {"records_per_job": 1 << 14, "conf": {"slot_records": 64}}
_READ = shuffle_manager.ShuffleReader.read


def _unchanged(self, record_stats=True):
    """The read hands back the records it was given, unshuffled."""
    recs = self._m._writers[self._h.shuffle_id].records
    d = self._m.runtime.num_partitions
    n = recs.shape[1] // d
    return recs.clone(), torch.full((d,), n, dtype=torch.int32)


def _half(self, record_stats=True):
    """Half of every partition's records left out."""
    out, totals = _READ(self, record_stats)
    return out, totals // 2


def _altered(self, record_stats=True):
    """One answer altered where it is produced."""
    out, totals = _READ(self, record_stats)
    out = out.clone()
    out[2, 0] ^= 1
    return out, totals


def _one_partition(self, record_stats=True):
    """One answer of the last partition altered, the others as read."""
    out, totals = _READ(self, record_stats)
    out = out.clone()
    d = self._m.runtime.num_partitions
    out[2, (d - 1) * (out.shape[1] // d)] ^= 1
    return out, totals


def _swapped(self, record_stats=True):
    """The first records of the first and last partitions swapped."""
    out, totals = _READ(self, record_stats)
    out = out.clone()
    last = (self._m.runtime.num_partitions - 1) * (
        out.shape[1] // self._m.runtime.num_partitions)
    out[:, [0, last]] = out[:, [last, 0]]
    return out, totals


def _no_exchange(send, out=None):
    """The move between partitions left out: each keeps its own sends."""
    return send.clone() if out is None else out.copy_(send)


FAULTS = {
    "state_unchanged": (shuffle_manager.ShuffleReader, "read", _unchanged),
    "half_left_out": (shuffle_manager.ShuffleReader, "read", _half),
    "answer_altered": (shuffle_manager.ShuffleReader, "read", _altered),
    "last_partition_altered": (shuffle_manager.ShuffleReader, "read",
                               _one_partition),
    "records_swapped_across": (shuffle_manager.ShuffleReader, "read",
                               _swapped),
    "exchange_left_out": (ring, "ring_exchange", _no_exchange),
}
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def _run(capsys, cell):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                   "--seconds", "1.5", "--trace", "0"],
                  device="cpu", overrides=SMALL)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(capsys, cell):
    line = _run(capsys, cell)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["attempted"] >= 3
    assert set(line["metrics"]) == {"shuffle_gbps", "job_p95_ms",
                                    "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(capsys, monkeypatch, cell, fault):
    owner, attr, fn = FAULTS[fault]
    monkeypatch.setattr(owner, attr, fn)
    line = _run(capsys, cell)
    assert not line["correct"], line["checks"]


def test_traced_run_reports_per_layer_metrics(capsys):
    rc = run.main(["--workload", "reducebykey.wordcount", "--seed", "7",
                   "--seconds", "0.5", "--trace", "1"],
                  device="cpu", overrides=SMALL)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"]
    assert {"plan_ms", "read_ms", "slot_fill",
            "wire_reduction"} <= set(line["metrics"])
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
