#!/usr/bin/env python3
"""What the library spans (``mano_hand_tpu_torch/obs/spans.py``) cost on
one CUDA card. They record only under a ``torch.profiler`` capture; with
none, each span is one gate check.

    python3 scripts/span_cost.py [--seconds 2] [--seed 1] [--cells a,b]

1. Host µs of one empty span: with no profiler (the gate check), and
   under a CPU and CUDA profile (a profiler range), less the same loop
   without spans under the same profile.
2. Per benchmark cell (``BENCHMARK.json``; default all): its ``--trace 1``
   run (``benchmark/harness.py:run_cell``, untraced window of
   ``--seconds``, then the traced one), with the spans on and with them
   held off for the run (the gate patched false), in turns (off, on, on,
   off), the same seed on every run: each run's
   ``device_idle_pct.forward``, the traced window's median host µs of
   ``bench.call``, and with the spans on the three span readings.

Run from the root of a checkout; prints one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: Spans each microbenchmark loop opens.
N_SPANS = 100_000
#: The per-layer readings each cell run keeps.
READINGS = ("device_idle_pct.forward", "library_ops_pct.forward",
            "launches_per_call.forward", "entry_host_ms.forward")


def per_span_us(spans) -> dict:
    """Host µs of one empty span: no profiler, and under a profile (less
    the empty loop's µs under it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(with_span: bool) -> float:
        t = time.perf_counter_ns()
        for _ in range(N_SPANS):
            if with_span:
                with spans.span(spans.COPY):
                    pass
        return (time.perf_counter_ns() - t) / N_SPANS / 1e3

    off = loop(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        empty = loop(False)
        on = loop(True)
    torch.cuda.synchronize()
    return {"off_us": off, "profiled_us": on - empty}


def call_host_us(tl) -> float:
    """Median host µs of the traced window's ``bench.call`` spans."""
    return statistics.median(
        (b - a) / 1e3 for n, a, b in tl.host if n == "bench.call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cells", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness, timeline
    from mano_hand_tpu_torch.obs import spans

    device = harness.require_cards(1)
    out = {"device": torch.cuda.get_device_name(device),
           "power_limit": harness.power_limit(device),
           "span": per_span_us(spans), "cells": {}}
    spec = harness.load_spec()
    cells = ([c for c in args.cells.split(",") if c] or
             [w["name"] for w in spec["workloads"]])
    gate = spans._profiling
    seen = []
    capture = timeline.Timeline.from_capture

    def keep(events):
        seen.append(capture(events))
        return seen[-1]

    timeline.Timeline.from_capture = keep
    try:
        for cell in cells:
            runs = []
            for mode in ("off", "on", "on", "off"):
                spans._profiling = gate if mode == "on" else (lambda: False)
                try:
                    line = harness.run_cell(cell, args.seed, args.seconds,
                                            True, device,
                                            time.perf_counter())
                finally:
                    spans._profiling = gate
                runs.append({
                    "mode": mode, "correct": line["correct"],
                    "bench_call_us": call_host_us(seen[-1]),
                    **{k: line["metrics"][k]["value"] for k in READINGS
                       if k in line["metrics"]}})
                print(json.dumps({"cell": cell, **runs[-1]}),
                      file=sys.stderr)
            out["cells"][cell] = runs
    finally:
        timeline.Timeline.from_capture = capture
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
