"""Run one cell of the port's H100 benchmark once and print its line.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``benchmark/``
and the port, ``mano_hand_tpu_torch``. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
name the same numbers. Without a CUDA device, or if the JAX stack or the
JAX package was loaded, it prints no result and exits 1.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("--seed must be a non-negative whole number", file=sys.stderr)
        return 2
    # The port's packages, and this one, import from the checkout's root
    # (not from benchmark/, whose module names could shadow others).
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT / "benchmark"]
    os.chdir(ROOT)
    from benchmark import harness

    t_imported = time.perf_counter()
    try:
        device = harness.require_cards(
            harness.find_cell(harness.load_spec(), args.workload)["chips"])
        phases = {"imports": t_imported - T0,
                  "card": time.perf_counter() - t_imported}
        line = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), device, T0, phases)
        found = harness.forbidden_loaded()
        if found:
            raise harness.HarnessError(
                f"forbidden modules loaded in the run: {found}")
    except harness.HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
