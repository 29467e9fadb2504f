"""The benchmark's files: every cell, configuration, traffic and metric is
found by name and agrees with ``BENCHMARK.json``."""
import importlib
import json
import re

import pytest

from bench import cells, correct

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    cell = cells.load_cell(w["name"])
    assert cell.chips in (1, 4)
    assert cell.traffic["job"] == "train"
    assert cell.limits is not None, "a cell needs bench/limits/<cell>.json"
    assert set(cell.limits["limits"]) == set(correct.NAMES)
    names = {m["name"] for m in cell.metrics(False)}
    assert {"setup_s", "train_tokens_per_s"} <= names
    assert cell.metrics(True), "every cell reports a per-layer metric"
    if cell.traffic["backend"] == "mesh":
        assert cell.traffic["replicas"] % cell.chips == 0
    for key in ("name", "config", "traffic"):
        assert NAME.match(w[key])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    with open(cells.ROOT / c["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"]
    assert c["file"].startswith("bench/")
    for key in c["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_size")), key


METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    mod = importlib.import_module(f"bench.metrics.{m['name']}")
    assert callable(mod.read)
    assert mod.UNIT == m["unit"]
    assert mod.LAYER == m.get("layer")
    assert mod.MOVES == m.get("moves")
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_within_range():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
