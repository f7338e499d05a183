"""Bulk offline registration: a stored dataset of target meshes, fitted
at throughput with the batched LM solver + the input pipeline.

The mocap post-processing workflow: thousands of captured frames on
disk, each needing (pose, shape) recovered — throughput matters, not
single-frame latency. The pieces composing here:

1. ``utils.data.batches`` slices the dataset into STATIC-shape batches
   (every batch the same shape: a ragged tail would be a new shape for
   every shape-keyed cache);
2. ``utils.data.prefetch_to_device`` keeps the next batches' host-to-
   device copies in flight while the card solves the current one;
3. ``fit_lm`` solves the damped Gauss-Newton problems of a whole batch at
   once — every frame in a batch converges in the same ~15 steps.

    python examples_torch/20_bulk_registration.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device, sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit_lm
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.utils.data import batches, prefetch_to_device

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)

    # The "captured dataset": target vertex clouds for random poses.
    rng = np.random.default_rng(0)
    true_pose = rng.normal(scale=0.3, size=(args.frames, 16, 3)).astype(
        np.float32)
    true_beta = rng.normal(scale=0.5, size=(args.frames, 10)).astype(
        np.float32)
    targets = core.forward_batched(
        params, torch.as_tensor(true_pose, device=dev),
        torch.as_tensor(true_beta, device=dev)).verts.cpu().numpy()
    print(f"dataset: {args.frames} frames of [778, 3] targets "
          f"({targets.nbytes / 2**20:.1f} MiB)")

    # Fit every batch with one solver configuration; prefetch keeps the
    # next batch's transfer overlapped with the current solve.
    t0 = time.perf_counter()
    done = 0
    worst = torch.zeros((), device=dev)
    for b in prefetch_to_device(
            batches({"target": targets}, batch_size=args.batch), size=2,
            device=dev):
        res = fit_lm(params, b["target"], n_steps=args.steps)
        verts = core.forward_batched(params, res.pose, res.shape).verts
        worst = torch.maximum(worst, (verts - b["target"]).abs().max())
        done += len(b["target"])
    sync(dev)
    dt = time.perf_counter() - t0
    worst = float(worst)
    print(f"fit {done} frames in {dt:.2f} s "
          f"({done / dt:,.1f} frames/s, {args.steps} LM steps each); "
          f"worst vertex error {worst * 1e3:.4f} mm")
    assert worst < 1e-4
    return 0


if __name__ == "__main__":
    sys.exit(main())
