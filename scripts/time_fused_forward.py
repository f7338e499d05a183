#!/usr/bin/env python3
"""Time the port's whole-forward kernel (K1, and K5 on its hand axis), the
skinning kernel K3 and the blend + skin kernel K4 on one CUDA card, at
the batch sizes the port's main paths use.

    python3 scripts/time_fused_forward.py [--root DIR] [--only K3,K4]

``--root`` names the checkout whose ``mano_hand_tpu_torch`` is timed (by
default this one), so two trees can be timed in turns in one run on
one card: run it for the parent, the change, the change, the parent.
``--only`` times a subset of K1, K5, K3 and K4.
Each time is the median over 20 samples, after 3 warm-up calls, of 10
back-to-back calls between two CUDA events, divided by 10. Each shape is
also held against the kernel's plain PyTorch version (max abs error). K3
runs in its forward form (R, t) and its backward form (R^T read in
place, no t) on the plain pre-stage's transforms; K4 on the PyTorch
pre-stage's coefficients and transforms.
Prints one JSON line; needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

K1_BATCHES = (1, 1000, 8192)
K5_BATCHES = (1, 1000, 4096, 32768)
K3_BATCHES = (1024, 8192)
K4_BATCHES = (1000, 8192)
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
    ap.add_argument("--only", default="K1,K5,K3,K4",
                    help="comma-separated kernels to time")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("time_fused_forward: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch import ops as tops
    from mano_hand_tpu_torch.ops import _build, fused_forward, fused_skin

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "kernel" in ln or "registers" in ln or "spill" in ln]
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
              "ptxas": ptxas, "K1": {}, "K5": {}, "K3": {}, "K3_bwd_form": {},
              "K4": {}, "err": {}}
    with torch.no_grad():
        for b in K1_BATCHES if "K1" in only else ():
            pose, shape = inputs(b)
            result["K1"][b] = cuda_ms(
                lambda: fused_forward.forward_verts_fused_full(
                    params, pose, shape))
            result["err"][f"K1 B={b}"] = err(
                fused_forward.forward_verts_fused_full(params, pose, shape),
                fused_forward.forward_verts_plain(ops1, pose, shape))
        for b in K5_BATCHES if "K5" in only else ():
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
        for b in K3_BATCHES if "K3" in only else ():
            pose, shape = inputs(b)
            out = core.forward_batched(params, pose, shape, fused=False)
            wr, wt_ = tops.forward_kinematics(params.parents, out.rot_mats,
                                              out.joints)
            rot, t = tops.skinning_transforms(wr, wt_, out.joints)
            fwd = (params.lbs_weights.contiguous(), rot.contiguous(),
                   t.contiguous(), out.rest_verts.contiguous())
            g = out.verts.contiguous()
            result["K3"][b] = cuda_ms(lambda: fused_skin.skin_batched(*fwd))
            result["err"][f"K3 B={b}"] = err(
                fused_skin.skin_batched(*fwd),
                fused_skin.skin_batched_plain(*fwd))
            # The vertex cotangent as that tree's skin_vjp launches it: R^T
            # read in place with no t, or (a tree without those options)
            # through a transposed copy and zero t built on every call.
            if "transpose_r" in inspect.signature(
                    fused_skin.skin_batched).parameters:
                def bwd():
                    return fused_skin.skin_batched(fwd[0], fwd[1], None, g,
                                                   transpose_r=True)
            else:
                def bwd():
                    return fused_skin.skin_batched(
                        fwd[0], fwd[1].transpose(-1, -2).contiguous(),
                        fwd[2].new_zeros(fwd[2].shape), g)
            result["K3_bwd_form"][b] = cuda_ms(bwd)
            result["err"][f"K3_bwd_form B={b}"] = err(
                bwd(), fused_skin.skin_batched_plain(
                    fwd[0], fwd[1].transpose(-1, -2).contiguous(),
                    fwd[2].new_zeros(fwd[2].shape), g))
        s_ = ops1.n_shape
        for b in K4_BATCHES if "K4" in only else ():
            pose, shape = inputs(b)
            coef, rot, t = (x.contiguous() for x in fused_forward.pre_stage(
                ops1.parents_tuple, ops1.jb[..., s_], ops1.jb[..., :s_], pose,
                shape, ops1.kpad))
            result["K4"][b] = cuda_ms(
                lambda: fused_forward.blend_skin_fused(ops1, coef, rot, t))
            result["err"][f"K4 B={b}"] = err(
                fused_forward.blend_skin_fused(ops1, coef, rot, t),
                fused_forward.blend_skin_plain(ops1, coef, rot, t))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
