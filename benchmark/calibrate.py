"""Read a cell's compared numbers over many seeds in one process: the
program's, and the control's (the reference in TF32 in the program's
place), at the cell's own size and load, to set each limit between them.

    python3 benchmark/calibrate.py --workload <cell> --first <seed> \
        --seeds 12 --control-seeds 3 --seconds 2

One JSON line a run on standard output, then a summary line: the largest
program reading and the smallest control reading of each number. The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() != ROOT / "benchmark"]
    from benchmark import harness

    device = harness.require_cards(1)
    readings = {"program": {}, "control": {}}
    runs = [(args.first + i, "program") for i in range(args.seeds)]
    runs += [(args.first + i, "control") for i in range(args.control_seeds)]
    for seed, side in runs:
        t = time.perf_counter()
        line = harness.run_cell(
            args.workload, seed, args.seconds, False, device, t,
            wrap=(lambda e: e.control()) if side == "control" else None)
        values = {k: c["value"] for k, c in line["checks"].items()}
        for k, v in values.items():
            readings[side].setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "side": side, "correct":
                          line["correct"], "attempted": line["attempted"],
                          "checks": values,
                          "run_s": time.perf_counter() - t}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "program_max": {k: max(v) for k, v in readings["program"].items()},
        "control_min": {k: min(v) for k, v in readings["control"].items()},
        "forbidden_loaded": harness.forbidden_loaded(),
        "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
