"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("entry", METRICS + MAN["configs"] + MAN["workloads"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (METRICS, MAN["configs"], MAN["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_of_each_cell(m):
    """Each per-layer metric names one end-to-end metric that every cell it
    lists reports."""
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in MAN["workloads"]}
    for cell in m["workloads"]:
        assert cell in cells
        target = e2e[m["moves"]]
        assert "workloads" not in target or cell in target["workloads"]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(w):
    cell = harness.cell_spec(w["name"])
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                       cell["driver"] + ".py"))
    config = harness.config_spec(w["config"])
    assert config["name"] == w["config"]
    ends = harness.metrics_of(MAN, w["name"], False)
    assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
    assert harness.metrics_of(MAN, w["name"], True)


def test_configs_used_and_filed():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert {c["name"] for c in MAN["configs"]} == used
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/")
        spec = harness.config_spec(c["name"])
        assert spec["reduced"] == c["reduced"]


def test_four_chip_cells_at_most_one():
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= 1
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
