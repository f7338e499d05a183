"""Count the K2 kernels a ``torch.profiler`` capture keeps, with and
without ``torch_trace``'s pads.

The profiler keeps a device event only inside its window on the host's
clock. Each trial makes two captures of ``--dispatches`` back-to-back
one-row K2 dispatches on a serial engine (``chip_smoke.py``'s
``pipeline_streams`` profile at B = 1): ``bare``, the profiler started and
stopped around the dispatches alone, and ``padded``, the port's
``torch_trace``. For each mode it prints the captures short of the
dispatches, the lead of a device event's start over the start of the host
call that launched it (matched by correlation id; > 0 where the device
clock, mapped onto the host's, runs ahead), and the margin from the
window's start to the first K2 kernel (the first kernel falls out where
its lead exceeds the margin).

    python scripts/probe_capture_window.py [--trials 100] [--dispatches 60]

Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def read_capture(path: str) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    frame = [e for e in events if e.get("cat") == "Trace"]
    start = min(float(e["ts"]) for e in frame)
    k2 = sorted(float(e["ts"]) for e in events
                if e.get("cat") == "kernel"
                and "posed_kernel" in e.get("name", ""))
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    leads = [launch[e["args"]["correlation"]] - float(e["ts"])
             for e in events if e.get("cat") == "kernel"
             and e.get("args", {}).get("correlation") in launch]
    return {"k2": len(k2), "lead_us": max(leads) if leads else None,
            "margin_us": k2[0] - start if k2 else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--dispatches", type=int, default=60)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_capture_window: needs a CUDA card", file=sys.stderr)
        return 2
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.serving import ServingEngine
    from mano_hand_tpu_torch.utils.profiling import TORCH_TRACE, torch_trace

    dev = torch.device("cuda", 0)
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(14)
    eng = ServingEngine(params, device=dev, min_bucket=1, max_bucket=1,
                        posed_kernel="fused", inflight_depth=1,
                        adaptive_coalesce=False)
    key = eng.specialize(rng.normal(size=params.n_shape).astype(np.float32))
    eng.warmup_posed([1])
    poses = [rng.normal(scale=0.5, size=(1, 16, 3)).astype(np.float32)
             for _ in range(args.dispatches)]

    def body():
        for f in [eng.submit(p, subject=key) for p in poses]:
            f.result(timeout=300)

    tmp = tempfile.mkdtemp(prefix="probe_capture_window_")
    runs = {"bare": [], "padded": []}
    with eng:
        eng.forward(poses[0], subject=key)
        for t in range(args.trials):
            path = os.path.join(tmp, f"bare_{t}.json")
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            try:
                body()
            finally:
                prof.stop()
            prof.export_chrome_trace(path)
            runs["bare"].append(read_capture(path))
            os.remove(path)
            d = os.path.join(tmp, f"padded_{t}")
            with torch_trace(d):
                body()
            runs["padded"].append(read_capture(os.path.join(d, TORCH_TRACE)))
            os.remove(os.path.join(d, TORCH_TRACE))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"nvidia_smi": smi, "dispatches": args.dispatches}
    for mode, caps in runs.items():
        leads = sorted(c["lead_us"] for c in caps if c["lead_us"] is not None)
        margins = [c["margin_us"] for c in caps
                   if c["margin_us"] is not None]
        out[mode] = {
            "captures": len(caps),
            "short": sum(c["k2"] != args.dispatches for c in caps),
            "k2_counts_short": [c["k2"] for c in caps
                                if c["k2"] != args.dispatches],
            "lead_us_max": leads[-1] if leads else None,
            "lead_us_median": statistics.median(leads) if leads else None,
            "captures_lead_over_0": sum(x > 0 for x in leads),
            "margin_us_min": min(margins) if margins else None,
            "margin_us_median": (statistics.median(margins)
                                 if margins else None)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
