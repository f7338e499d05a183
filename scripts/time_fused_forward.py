#!/usr/bin/env python3
"""Time the port's whole-forward kernel (K1, and K5 on its hand axis), the
skinning kernel K3, the blend + skin kernel K4 and the gathered pose-only
kernel K2 (f32 and bf16) on one CUDA card, at the batch sizes the port's
main paths use.

    python3 scripts/time_fused_forward.py [--root DIR] [--only K2,K4]

``--root`` names the checkout whose ``mano_hand_tpu_torch`` is timed (by
default this one), so two trees can be timed in turns in one run on
one card: run it for the parent, the change, the change, the parent.
``--only`` times a subset of K1, K5, K3, K4 and K2.
Each time is the median over 20 samples, after 3 warm-up calls, of 10
back-to-back calls between two CUDA events, divided by 10. K1, K5, K4, K2
and K2-bf16 also get the same calls replayed from a CUDA graph: each of
their times is a pair, ``call`` and ``graph`` (the kernel's device time
where the wrapper's host time exceeds it, as at small batches). Each
shape is also held against the kernel's plain PyTorch version (max abs
error). K3 runs in its forward form (R, t) and its backward form (R^T
read in place, no t) on the plain pre-stage's transforms; K4 on the
PyTorch pre-stage's coefficients and transforms. K2 and K2-bf16 run at every
batch of K2_BATCHES from subject tables of K2_CAPACITIES rows (random
in-range indices), each held against ``core.forward_posed_gather`` in
its dtype; beside them ``K2_blend_matmul`` times K2's blend alone as one
``torch.matmul``, coef [B, Ppad] x basis [Ppad, 3V], in f32 (under the
IEEE pin) and in bf16 — a yardstick of the blend's share, not a library
time of K2 (no single PyTorch call computes K2's function).
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

K1_BATCHES = (1, 256, 1000, 1024, 8192)
K5_BATCHES = (1, 1000, 4096, 32768)
K3_BATCHES = (1024, 8192)
K4_BATCHES = (1, 256, 1000, 1024, 8192)
K2_BATCHES = (1, 256, 1024, 8192)
K2_CAPACITIES = (64, 1000)
WARMUP, REPEATS, PER_SAMPLE = 3, 20, 10


def graph_ms(fn) -> float:
    """Device milliseconds per call of ``fn``: PER_SAMPLE calls captured
    in one CUDA graph, replayed between two CUDA events (the median over
    REPEATS samples after WARMUP replays), so the wrapper's host time is
    not in it — the kernel's time where the call is host-bound."""
    for _ in range(WARMUP):
        fn()   # packs and builds outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(PER_SAMPLE):
            fn()
    return cuda_ms(graph.replay) / PER_SAMPLE


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


def both_ms(fn) -> dict:
    return {"call": cuda_ms(fn), "graph": graph_ms(fn)}


def time_k2(result, params, core, err) -> None:
    """K2 and K2-bf16 at K2_BATCHES x K2_CAPACITIES, and the blend alone
    as one matmul, into ``result``."""
    from mano_hand_tpu_torch.ops.common import ieee_fp32
    dev = params.device
    j, s, v = params.n_joints, params.n_shape, params.n_verts
    rng = np.random.default_rng(1)
    for c in K2_CAPACITIES:
        betas = torch.from_numpy(rng.normal(size=(c, s)).astype(
            np.float32)).to(dev)
        shaped = core.specialize(params, betas)
        table = core.SubjectTable(
            shaped.v_shaped, shaped.joints, shaped.shape, params.pose_basis,
            params.lbs_weights, params.parents)
        for b in K2_BATCHES:
            idx = torch.from_numpy(rng.integers(0, c, size=b).astype(
                np.int32)).to(dev)
            pose = torch.from_numpy(rng.normal(scale=0.5, size=(
                b, j, 3)).astype(np.float32)).to(dev)
            for name, dt in (("K2", None), ("K2_bf16", torch.bfloat16)):
                key = f"B={b} C={c}"

                def call():
                    return core.forward_posed_gather_fused(
                        table, idx, pose, compute_dtype=dt)

                result[name][key] = both_ms(call)
                result["err"][f"{name} {key}"] = err(
                    core.forward_posed_gather_fused(table, idx, pose,
                                                    compute_dtype=dt),
                    core.forward_posed_gather(table, idx, pose,
                                              compute_dtype=dt).verts)
    p = params.pose_basis.shape[-1]
    ppad = -(-p // 4) * 4
    basis = torch.zeros((ppad, 3 * v), device=dev)
    basis[:p] = params.pose_basis.permute(2, 1, 0).reshape(p, 3 * v)
    for b in K2_BATCHES:
        coef = torch.from_numpy(rng.normal(size=(b, ppad)).astype(
            np.float32)).to(dev)
        with ieee_fp32():
            f32 = cuda_ms(lambda: torch.matmul(coef, basis))
        c16, b16 = coef.to(torch.bfloat16), basis.to(torch.bfloat16)
        result["K2_blend_matmul"][b] = {
            "f32": f32, "bf16": cuda_ms(lambda: torch.matmul(c16, b16))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--only", default="K1,K5,K3,K4,K2",
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
              "K4": {}, "K2": {}, "K2_bf16": {}, "K2_blend_matmul": {},
              "err": {}}
    with torch.no_grad():
        for b in K1_BATCHES if "K1" in only else ():
            pose, shape = inputs(b)
            result["K1"][b] = both_ms(
                lambda: fused_forward.forward_verts_fused_full(
                    params, pose, shape))
            result["err"][f"K1 B={b}"] = err(
                fused_forward.forward_verts_fused_full(params, pose, shape),
                fused_forward.forward_verts_plain(ops1, pose, shape))
        for b in K5_BATCHES if "K5" in only else ():
            pose, shape = inputs(2, b)
            result["K5"][b] = both_ms(
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
            result["K4"][b] = both_ms(
                lambda: fused_forward.blend_skin_fused(ops1, coef, rot, t))
            result["err"][f"K4 B={b}"] = err(
                fused_forward.blend_skin_fused(ops1, coef, rot, t),
                fused_forward.blend_skin_plain(ops1, coef, rot, t))
        if "K2" in only:
            time_k2(result, params, core, err)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
