#!/usr/bin/env python3
"""Time the port's whole-forward kernel (K1, and K5 on its hand axis) on
one CUDA card, at the batch sizes the port's main paths use.

    python3 scripts/time_fused_forward.py [--root DIR]

``--root`` names the checkout whose ``mano_hand_tpu_torch`` is timed (by
default this one), so two trees can be timed in turns in one run on
one card: run it for the parent, the change, the change, the parent.
Each time is the median over 20 samples, after 3 warm-up calls, of 10
back-to-back calls between two CUDA events, divided by 10. Each shape is
also held against the kernel's plain PyTorch version (max abs error).
Prints one JSON line; needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

K1_BATCHES = (1, 1000, 8192)
K5_BATCHES = (1, 1000, 4096, 32768)
WARMUP, REPEATS, PER_SAMPLE = 3, 20, 10


def cuda_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PER_SAMPLE):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / PER_SAMPLE)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fused_forward: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops import _build, fused_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "fused_forward" in ln or "registers" in ln or "spill" in ln]
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    stacked = core.stack_params(mirror_params(params), params)
    ops1 = fused_forward.fused_operands(params)
    ops5 = fused_forward.fused_operands_hands(stacked)
    j, s = params.n_joints, params.n_shape
    rng = np.random.default_rng(0)

    def inputs(*lead):
        pose = rng.normal(scale=0.5, size=(*lead, j, 3)).astype(np.float32)
        shape = rng.normal(size=(*lead, s)).astype(np.float32)
        return torch.from_numpy(pose).to(dev), torch.from_numpy(shape).to(dev)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    result = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
              "ptxas": ptxas, "K1": {}, "K5": {}, "err": {}}
    with torch.no_grad():
        for b in K1_BATCHES:
            pose, shape = inputs(b)
            result["K1"][b] = cuda_ms(
                lambda: fused_forward.forward_verts_fused_full(
                    params, pose, shape))
            result["err"][f"K1 B={b}"] = err(
                fused_forward.forward_verts_fused_full(params, pose, shape),
                fused_forward.forward_verts_plain(ops1, pose, shape))
        for b in K5_BATCHES:
            pose, shape = inputs(2, b)
            result["K5"][b] = cuda_ms(
                lambda: fused_forward.forward_verts_fused_full_hands(
                    stacked, pose, shape))
            rows = slice(0, min(b, 4096))
            result["err"][f"K5 B={b}"] = err(
                fused_forward.forward_verts_fused_full_hands(
                    stacked, pose, shape)[:, rows],
                fused_forward.forward_verts_hands_plain(
                    ops5, pose[:, rows], shape[:, rows]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
