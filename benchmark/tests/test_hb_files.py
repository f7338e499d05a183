"""Every name in BENCHMARK.json finds its files, and the files agree."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.small import SIZES, missing, sizes_name

SPEC = harness.load_spec()
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
HANDS = {"left", "right", "neutral"}


def check_config(data: dict, spec_entry: dict) -> None:
    """What every configuration file states holds together, whatever its
    model: the pose basis is 9 (J - 1) wide, the tree is rooted and
    ordered (each parent before its child), the sizes are positive, the
    hands are named, the arrays are float32, and nothing is cut (the
    same ``reduced`` here and in ``BENCHMARK.json``, and empty). Each
    configuration's published widths are pinned in its own test file,
    ``test_config_<config>.py``."""
    name = spec_entry["name"]
    assert spec_entry["file"] == f"benchmark/configs/{name}.json"
    assert data["name"] == name
    assert data["reduced"] == spec_entry["reduced"] == []
    j = data["n_joints"]
    assert data["n_pose_basis"] == 9 * (j - 1)
    parents = data["parents"]
    assert len(parents) == j and parents[0] == -1
    assert all(0 <= p < i for i, p in enumerate(parents) if i), parents
    for key in ("n_verts", "n_faces", "n_shape"):
        assert isinstance(data[key], int) and data[key] > 0, key
    assert data["hands"] and set(data["hands"]) <= HANDS, data["hands"]
    assert data["dtype"] == "float32"


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(cfg):
    check_config(harness.load_json("configs", cfg["name"]), cfg)


def pin_file(name: str) -> Path:
    return HERE / f"test_config_{re.sub(r'[^A-Za-z0-9_]', '_', name)}.py"


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_has_a_test_file_pinning_its_widths(cfg):
    """``check_config`` holds a configuration to itself; its published
    widths are held in a file of its own, which names it."""
    path = pin_file(cfg["name"])
    assert path.is_file(), (
        f"add benchmark/tests/{path.name}, pinning {cfg['name']}'s "
        f"published widths")
    assert f'"{cfg["name"]}"' in path.read_text()


#: SMPL-X's published widths (Pavlakos et al., CVPR 2019,
#: SMPLX_NEUTRAL.npz): a configuration that is not MANO and holds
#: together.
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31,
                 32, 20, 34, 35, 20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46,
                 47, 21, 49, 50, 21, 52, 53]


def smplx_shaped(**changes) -> tuple:
    data = {"name": "smplx_neutral", "n_verts": 10475, "n_faces": 20908,
            "n_joints": 55, "n_shape": 20, "n_pose_basis": 486,
            "parents": list(SMPLX_PARENTS), "hands": ["neutral"],
            "dtype": "float32", "reduced": []}
    data.update(changes)
    entry = {"name": data["name"],
             "file": f"benchmark/configs/{data['name']}.json",
             "reduced": []}
    return data, entry


def test_check_config_takes_a_config_that_is_not_mano():
    check_config(*smplx_shaped())


def _unordered():
    parents = list(SMPLX_PARENTS)
    parents[4] = 7
    return parents


@pytest.mark.parametrize("changes", [
    dict(n_pose_basis=485),                          # a wrong pose width
    dict(parents=_unordered()),                      # a child before its parent
    dict(parents=[0] + SMPLX_PARENTS[1:]),           # no root
    dict(parents=SMPLX_PARENTS[:-1]),                # a joint without a parent
    dict(n_faces=0),
    dict(hands=[]),
    dict(hands=["both"]),
    dict(dtype="float64"),
    dict(reduced=["n_joints"]),                      # cut, and not in the spec
], ids=["pose_width", "unordered_tree", "no_root", "short_tree",
        "no_faces", "no_hands", "unknown_hand", "float64", "reduced"])
def test_check_config_refuses_a_broken_config(changes):
    with pytest.raises(AssertionError):
        check_config(*smplx_shaped(**changes))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_has_test_sizes(cell):
    """The fault and control tests run each cell at the sizes of
    ``tests/sizes/<cell>.json`` or, without it, ``tests/sizes/<mix>.json``:
    a file with both ``small`` and ``control``."""
    assert sizes_name(cell), missing(cell)


def test_every_sizes_file_belongs_to_a_mix_or_a_cell():
    names = {w[k] for w in SPEC["workloads"] for k in ("name", "traffic")}
    assert {p.stem for p in SIZES.glob("*.json")} <= names


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
