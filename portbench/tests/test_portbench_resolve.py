"""BENCHMARK.json against the benchmark's contract, and every cell and
metric it names against the files the harness finds by name."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    _, entry, traffic, config = harness.load_cell(w["name"])
    assert entry is not None and traffic["name"] == w["name"]
    assert traffic["config"] == w["config"] == config["name"]
    assert os.path.exists(harness.model_file(config))
    harness.geometry(config, traffic)  # the cell's shapes divide
    e2e, per_layer = harness.cell_metrics(BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"} and 1 <= len(c["why"]) <= 200
    assert c["file"].startswith("portbench/") and os.path.exists(
        os.path.join(harness.ROOT, c["file"]))
    assert 1 <= len(c["source"]) <= 200 and all(NAME.match(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert callable(harness.load_reader(m["name"]))


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
