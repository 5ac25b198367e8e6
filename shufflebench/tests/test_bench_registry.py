"""Discovery by name, and BENCHMARK.json against the files it names."""

import json
import re

import pytest

from shufflebench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_config_and_mix():
    for wl in BENCH["workloads"]:
        cfg = registry.config(BENCH, wl["config"])
        mix = registry.mix(wl["traffic"])
        assert cfg["name"] == wl["config"] and mix["name"] == wl["traffic"]
        assert cfg["records_per_job"] > 0 and cfg["partitions"] > 0
        assert mix["check"] in ("global_order", "hash_placement",
                                "reduce_sum")
        for spec in mix["keys"] + cfg["payload"]:
            assert callable(registry.generator(spec["dist"]))
        assert sum(s["words"] for s in mix["keys"]) == cfg["key_words"]
        assert sum(s["words"] for s in cfg["payload"]) == cfg["val_words"]


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.workload(BENCH, "no.such.cell")
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric")
    with pytest.raises(KeyError):
        registry.generator("no_such_dist")


def test_cell_metrics_follow_the_workloads_key():
    names = {m["name"] for m in registry.cell_metrics(
        BENCH, "terasort.repartition", "per_layer")}
    assert "sample_ms" not in names and "wire_reduction" not in names
    assert "slot_fill" in names
    e2e = {m["name"] for m in registry.cell_metrics(
        BENCH, "terasort.sort", "end_to_end")}
    assert e2e == {"shuffle_gbps", "job_p95_ms", "peak_mem_gb", "setup_s"}


def test_names_and_shapes_of_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    assert "device" in layers
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        with open(registry.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
