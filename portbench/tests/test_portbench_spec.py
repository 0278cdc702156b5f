"""BENCHMARK.json against the contract's form, and the harness finding
each cell's files and each metric's reader by name."""
import json
import os
import re

import pytest

from portbench import run as R

ROOT = R.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        mine = R.metric_names(SPEC, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = R.metric_names(SPEC, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert w["name"] in R.metric_names(
                SPEC, w["name"], "end_to_end") or m["moves"] in [
                    x["name"] for x in mine]


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_harness_finds_each_cell_by_name(w):
    entry, conf, mix, limits = R.cell(SPEC, w)
    assert entry["name"] == w
    assert conf["pattern"] and mix["mode"] in ("adam", "scan")
    assert limits and all("limit" in v for v in limits.values())


@pytest.mark.parametrize("m", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader(m):
    read = R.reader(m)
    assert read({}) is None       # nothing to read: the metric is left out
