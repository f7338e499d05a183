"""Run one cell of the benchmark once: set up, measure, check, report.

Everything a cell is made of is found by name. ``BENCHMARK.json`` at the
checkout's root names the cell's configuration, its traffic mix and its
metrics; the configuration is ``benchmark/configs/<config>.json``, the
traffic mix ``benchmark/traffic/<traffic>.json`` (which names the loop
``benchmark/loops/<loop>.py`` that drives the calls and the entry
``benchmark/entries/<entry>.py`` that calls the program), the limits of
the cell's compared numbers ``benchmark/limits/<cell>.json``, and each
metric is read by ``benchmark/metrics/<metric>.py``. Adding a cell,
configuration, traffic mix, loop, entry or metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import gen, timeline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that must never be loaded in a run: the JAX
#: package this port came from and JAX's own stack. Compared whole (the
#: port's own name starts with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mano_hand_tpu")

#: The harness's own mechanics, the same for every cell: outputs of the
#: window kept for the check, warm-up calls, and the traced window's
#: length (seconds) in a ``--trace 1`` run.
KEEP = 2
WARM_CALLS = 6
TRACE_SECONDS = 2.0


class HarnessError(RuntimeError):
    """A run that must print no result (no card, a forbidden import)."""


# ------------------------------------------------------------------ the spec
def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise HarnessError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric with
    a ``workloads`` key only in the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def load_entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def load_loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


# ----------------------------------------------------------------- the device
def require_cards(count: int) -> torch.device:
    """The run's device, its CUDA context started; raises without
    ``count`` cards."""
    if not torch.cuda.is_available():
        raise HarnessError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    have = torch.cuda.device_count()
    if have < count:
        raise HarnessError(f"the cell needs {count} CUDA devices, "
                           f"{have} present")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    sync(device)
    return device


def forbidden_loaded() -> list:
    """Forbidden top-level names present in ``sys.modules``."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ one run
def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, phases: dict | None = None,
             wrap=None, overrides: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    ``t0`` is the process's start on ``time.perf_counter``; ``phases``
    the seconds of the caller's set-up steps before this call (imports,
    the card's start), all of it counted in ``setup_s`` (by default, the
    time since ``t0`` as ``imports``). ``wrap``, for the tests, replaces
    the program under the window (a control or a planted fault);
    ``overrides`` changes traffic parameters (the tests' small sizes)."""
    t_ready = time.perf_counter()
    phases = dict(phases or {"imports": t_ready - t0})
    spec = load_spec()
    w = find_cell(spec, cell)
    cfg = load_json("configs", w["config"])
    traffic = dict(load_json("traffic", w["traffic"]), **(overrides or {}))
    limits = load_json("limits", cell)
    loop = load_loop(traffic["loop"])
    g = gen.generator(seed, device)
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, gen=g, device=device)
    entry = load_entry(traffic["entry"]).build(ctx)
    if wrap is not None:
        wrap(entry)
    sync(device)
    t_built = time.perf_counter()
    phases["build"] = t_built - t_ready
    # Warm-up: the window's shapes, depth and reservoir, a fixed count.
    loop.run(entry, traffic, 0.0, device, random.Random(0), KEEP,
             max_calls=WARM_CALLS)
    sync(device)
    setup_s = time.perf_counter() - t0
    phases["warm"] = setup_s - (t_built - t0)

    window = loop.run(entry, traffic, seconds, device, random.Random(seed),
                      KEEP)
    tl = traced = None
    if trace:
        # A further window under the profiler: the per-layer readings of
        # the device; rates stay the untraced window's.
        with timeline.capture(device) as cap:
            traced = loop.run(entry, traffic, TRACE_SECONDS, device,
                              random.Random(seed), 0, annotate=True)
        tl = timeline.Timeline.from_capture(cap.events)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.release()

    checks = entry.check(window.kept)
    window.kept = None
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in checks.items()) and set(checks) == set(limits)

    # What every metric reader gets: the cell, its entry (the work a
    # call does) and traffic, set-up, the window's record (calls, time,
    # each call's enqueue and completion), the traced window's record
    # and its timeline (None without --trace 1).
    r = SimpleNamespace(cell=cell, entry=entry, traffic=traffic,
                        setup_s=setup_s, window=window, traced=traced,
                        timeline=tl)
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = load_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak,
           "power_limit": power_limit(device)}
    line = {"correct": correct, "attempted": window.calls, "failed": 0,
            "metrics": metrics, "device": dev}
    if tl is not None:
        dev["busy_s"] = tl.busy_s
        dev["window_s"] = tl.window_s
        line["breakdown"] = tl.breakdown()
    line["setup_phases_s"] = phases
    line["checks"] = compared
    return line


def power_limit(device: torch.device):
    """The card's power limit as ``nvidia-smi`` reads it (a string such
    as "700.00 W"), or None off the card or without the tool."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().split(", ")[-1] or None

