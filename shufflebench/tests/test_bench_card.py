"""On a card: every cell runs through the harness at a reduced job size
and comes out correct, with device numbers in its lines. Run on the chip
with ``python3 -m pytest shufflebench/tests -m gpu``."""

import json

import pytest

from shufflebench import registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(capsys, cuda, cell, trace):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 17),
                   "--seconds", "1", "--trace", str(trace)],
                  device=cuda, overrides={"records_per_job": 1 << 20})
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
