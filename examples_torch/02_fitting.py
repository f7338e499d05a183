"""Inverse MANO: recover pose/shape from a target mesh or 3D keypoints.

The reference has no fitting at all; here it is an optimisation loop on
the device (Adam, or damped Gauss-Newton) — no host round-trip per step,
over a batch of independent problems at once.

    python examples_torch/02_fitting.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit, fit_lm, max_vertex_error
    from mano_hand_tpu_torch.io.checkpoints import save_fit_result
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(1)

    # Ground truth to recover: a batch of random poses/shapes.
    true_pose = rng.normal(scale=0.3, size=(args.batch, 16, 3)).astype("f")
    true_shape = rng.normal(scale=0.5, size=(args.batch, 10)).astype("f")
    target = core.forward_batched(
        params, torch.as_tensor(true_pose, device=dev),
        torch.as_tensor(true_shape, device=dev))

    # 1. Dense: fit to the full 778-vertex mesh with Levenberg-Marquardt.
    res = fit_lm(params, target.verts, n_steps=20)
    out = core.forward_batched(params, res.pose, res.shape)
    # The worst vertex over every problem: the max of the per-problem max.
    err = float(max_vertex_error(out.verts, target.verts))
    print(f"LM mesh fit: worst max-vertex error {err:.2e} over "
          f"{args.batch} problems")

    # 2. Sparse: fit to 16 posed joints only (detector/mocap input).
    res_j = fit(params, target.posed_joints, n_steps=300, lr=0.05,
                data_term="joints", shape_prior_weight=1e-3)
    out_j = core.forward_batched(params, res_j.pose, res_j.shape)
    jerr = float(torch.linalg.norm(
        out_j.posed_joints - target.posed_joints, dim=-1).max())
    print(f"Adam joints fit: worst joint error {jerr:.2e}")

    path = save_fit_result(res, "fit_result")
    print(f"checkpointed LM fit -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
