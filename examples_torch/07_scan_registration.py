"""Scan registration: fit pose/shape to a partial point cloud.

The classic depth-sensor workflow, correspondence-free: a synthetic "scan"
(a shuffled, subsampled, noisy view of a posed hand) is registered with the
canonical two-stage pipeline —

  1. coarse fit to 16 detected joints (well-conditioned, global);
  2. chamfer refinement against the raw points, warm-started from stage 1
     (ICP-family losses plateau from a cold start; the warm start is the
     point of the pipeline).

    python examples_torch/07_scan_registration.py [--device cpu]
        [--points 400] [--noise 0.0005] [--steps 300]
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
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--noise", type=float, default=5e-4,
                    help="per-point sensor noise sigma, meters")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="registration.npz")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit, objectives
    from mano_hand_tpu_torch.io.checkpoints import save_fit_result
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(3)

    # Ground truth the "sensor" observed.
    pose_true = rng.normal(scale=0.3, size=(16, 3)).astype(np.float32)
    truth = core.forward(params, torch.as_tensor(pose_true, device=dev))
    verts = truth.verts.cpu().numpy()

    # The scan: half the surface, shuffled, with sensor noise. Nothing
    # reveals which mesh vertex any point came from.
    idx = rng.permutation(verts.shape[0])[: args.points]
    cloud = verts[idx] + rng.normal(scale=args.noise, size=(len(idx), 3))
    cloud = torch.as_tensor(cloud, dtype=torch.float32, device=dev)

    # Stage 1: coarse joints fit (a keypoint detector's output).
    coarse = fit(params, truth.posed_joints, n_steps=200, lr=0.05,
                 data_term="joints", shape_prior_weight=1e-3)

    # Stage 2: chamfer refinement against the raw points.
    res = fit(params, cloud, n_steps=args.steps, lr=0.01,
              data_term="points", robust="huber", robust_scale=0.01,
              shape_prior_weight=1e-3, pose_prior_weight=1e-4,
              init={"pose": coarse.pose, "shape": coarse.shape})

    out = core.forward(params, res.pose, res.shape)
    nn = torch.sqrt(objectives.nearest_vertex_sq_dist(out.verts, cloud)
                    ).cpu().numpy()
    path = save_fit_result(res, args.out)
    print(f"fit (two-stage, {args.steps} chamfer steps) -> {path}")
    print(f"scan-to-surface distance: mean {nn.mean() * 1e3:.2f} mm, "
          f"worst {nn.max() * 1e3:.2f} mm over {len(idx)} points "
          f"(sensor noise {args.noise * 1e3:.2f} mm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
