"""BENCHMARK.json and the files it names: each found by its name."""

import json
import re

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for key in ("end_to_end", "per_layer")
           for m in BENCH[key]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + METRICS)
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] == "build_s" and "bound" not in m


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_loads_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"bench/configs/{name}.json"
    cfg = spec.config(name)
    assert cfg["name"] == name
    assert callable(spec.generator(cfg["generator"]).generate)
    assert len(cfg["attributes"]) == cfg["n_continuous"] + cfg["n_discrete"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.Spec.load().cell(cell)
    assert spec.traffic(c.traffic)["name"] == c.traffic
    assert spec.config(c.config)["name"] == c.config


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(spec.reader(name).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    s = spec.Spec.load()
    for cell in CELLS:
        e2e = [m.name for m in s.metrics_of(cell, trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert s.metrics_of(cell, trace=True)


def test_missing_names_fail():
    with pytest.raises(KeyError):
        spec.Spec.load().cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
