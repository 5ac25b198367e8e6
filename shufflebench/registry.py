"""Finds the benchmark's parts by name.

- ``BENCHMARK.json`` at the root of the checkout: the cells, the
  configurations' files and the metrics;
- ``configs/<name>.json`` (through each configuration's ``file``): the
  deployment;
- ``mixes/<traffic>.json``: the traffic mix of a cell;
- ``gen/<dist>.py``: a key or payload distribution, ``generate(n, words,
  gen, device, **params) -> int32[words, n]``;
- ``checks/<check>.py``: what a kind of read must return and the
  comparison that decides ``correct`` (the plain reference, with
  ``reference.py``);
- ``metrics/<name>.py``: a per-layer metric, ``read(run) -> float or
  None`` over the run's record (``run.py``).

A later cell, mix, distribution or metric is a new file and a new entry;
nothing here names one.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def mix(name: str) -> dict:
    with open(HERE / "mixes" / f"{name}.json") as f:
        return json.load(f)


def _load(path: Path):
    if not path.is_file():
        raise KeyError(f"no {path.parent.name} file {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"shufflebench_{path.parent.name}_{path.stem}".replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(dist: str):
    """The ``generate`` function of ``gen/<dist>.py``."""
    return _load(HERE / "gen" / f"{dist}.py").generate


def check(name: str):
    """The module of ``checks/<name>.py`` (``read`` and ``compare``)."""
    return _load(HERE / "checks" / f"{name}.py")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(HERE / "metrics" / f"{name}.py").read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    without ``workloads``, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
