"""Every name in BENCHMARK.json finds its files, and the files agree."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(cfg):
    data = harness.load_json("configs", cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert (data["n_verts"], data["n_joints"], data["n_shape"],
            data["n_pose_basis"]) == (778, 16, 10, 135)
    assert len(data["parents"]) == data["n_joints"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_finds_config_traffic_loop_entry_and_limits(cell):
    harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    assert callable(harness.load_entry(traffic["entry"]).build)
    assert callable(harness.load_loop(traffic["loop"]).run)
    assert cell["chips"] == 1
    limits = harness.load_json("limits", cell["name"])
    assert set(limits) and all(v > 0 for v in limits.values())


def test_every_limits_file_belongs_to_a_cell():
    cells = {w["name"] for w in SPEC["workloads"]}
    files = {p.stem for p in (harness.HERE / "limits").glob("*.json")}
    assert files == cells


@pytest.mark.parametrize(
    "metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.load_reader(metric["name"]))
    assert NAME.match(metric["name"])
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, w["name"], False)}
        per_layer = harness.cell_metrics(SPEC, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert per_layer, w["name"]
        moved = {m["moves"] for m in per_layer}
        assert moved <= e2e, w["name"]


def test_spec_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) < 64 * 1024
