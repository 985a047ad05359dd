"""Every part of the benchmark loads, and every name resolves and keeps to
the contract's characters."""

from __future__ import annotations

import re

import pytest

from portbench.registry import PKG, Registry, cell_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("which", ["bench", "bench_parked"])
def test_every_part_resolves(which, request):
    bench = request.getfixturevalue(which)
    reg = Registry()
    for c in bench["configs"]:
        cfg = reg.json("configs", c["name"])
        assert cfg["name"] == c["name"] and c["file"].startswith("portbench/")
        reg.module("reference", c["name"])
        reg.module("models", c["name"])
    for w in bench["workloads"]:
        spec = cell_spec(bench, w["name"])
        cell = reg.json("workloads", w["name"])
        mix = reg.json("traffic", w["traffic"])
        kind = reg.module("traffic", mix["kind"])
        assert callable(kind.query) and callable(kind.warm)
        judge = reg.module("judges", f"{w['config']}.{mix['kind']}")
        assert callable(judge.judge)
        assert set(cell) >= {"check_queries", "trace_queries", "limits"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(reg.module("metrics", m["name"]).read)


@pytest.mark.parametrize("folder", ["configs", "traffic", "workloads"])
def test_data_files_are_json(folder):
    reg = Registry()
    for p in sorted((PKG / folder).glob("*.json")):
        assert isinstance(reg.json(folder, p.stem), dict)


def test_per_layer_metrics_name_their_cells(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
