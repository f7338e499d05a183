"""Time the subject store's warm promotions on the card.

Runs ``serving.subject_store_drill_run`` at ``chip_smoke.py``'s settings
(``LS_STORE``, JAX's defaults: 100,000 subjects, 2 lanes, a 32-row table,
64 warm rows, Zipf 1.2, bucket 8, K2) ``--runs`` times and prints one JSON
line a run: the drill's promotion p50/p99 (the smoke's gate holds the p99
inside the 3 ms coalesce window) and, from wrappers around the store's
methods, each warm promotion's path (prefetched or synchronous), whether
its copy had already landed when the install settled it, and the slowest
promotions.

    python scripts/time_store_promotion.py [--runs 4] [--root DIR]

``--root`` imports the port and ``chip_smoke.py`` from another checkout,
so a parent and a change can be timed in one call. Needs a CUDA card;
imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_store_promotion: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.ops import _build
    from mano_hand_tpu_torch.serving import subject_store_drill_run
    from mano_hand_tpu_torch.serving.subject_store import SubjectStore

    samples, local = [], threading.local()
    settle, promote, record = (SubjectStore._settle, SubjectStore._promote,
                               SubjectStore._record)

    def timed_settle(self, rows, event, *rest):
        if event is not None and not hasattr(local, "landed"):
            local.landed = bool(event.query())
        return settle(self, rows, event, *rest)

    def timed_promote(self, row):
        local.path = "sync"
        return promote(self, row)

    def timed_record(self, t0, tier):
        ms = (time.perf_counter() - t0) * 1e3
        if tier == "warm":
            samples.append((ms, getattr(local, "path", "prefetched"),
                            getattr(local, "landed", None)))
        local.__dict__.clear()
        return record(self, t0, tier)

    SubjectStore._settle = timed_settle
    SubjectStore._promote = timed_promote
    SubjectStore._record = timed_record

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    _build.build()
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params = synthetic_params(seed=chip_smoke.SEED, dtype=torch.float32,
                              device=dev)
    for run in range(args.runs):
        samples.clear()
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            sd = subject_store_drill_run(
                params, device=dev, posed_kernel="fused",
                seed=chip_smoke.SEED, cold_dir=os.path.join(tmp, "cold"),
                **chip_smoke.LS_STORE)
            seconds = time.perf_counter() - t
        by_path = {}
        for ms, path, landed in samples:
            p = by_path.setdefault(path, {"n": 0, "landed": 0, "ms": []})
            p["n"] += 1
            p["landed"] += bool(landed)
            p["ms"].append(ms)
        for p in by_path.values():
            ms = p.pop("ms")
            p["p50_ms"] = float(np.percentile(ms, 50))
            p["max_ms"] = float(max(ms))
        print(json.dumps({
            "root": root, "run": run, "drill_seconds": seconds,
            "promotion_stall_ms": sd["promotion_stall_ms"],
            "within_window": sd["promotion_p99_within_window"],
            "by_path": by_path,
            "slowest_ms": sorted((s[0] for s in samples), reverse=True)[:4],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
