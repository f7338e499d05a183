"""Image-space inverse MANO: fit pose + global translation to 2D keypoints.

Detector-style input — 16 joints observed only as 2D image points through a
pinhole camera — fitted by projecting the model's posed joints through the
same differentiable camera and descending the confidence-weighted
reprojection error. Depth enters only through perspective scaling, so
priors and the translation DOF do the work the missing third coordinate
can't.

    python examples_torch/04_keypoint2d_fitting.py [--device cpu]
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
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz.camera import default_hand_camera

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    camera = default_hand_camera(device=dev)
    rng = np.random.default_rng(2)

    # Ground truth: a posed hand, translated off the origin.
    true_pose = rng.normal(scale=0.25, size=(16, 3)).astype("f")
    true_trans = np.array([0.03, -0.02, 0.05], "f")
    gt = core.forward(params, torch.as_tensor(true_pose, device=dev))
    keypoints_2d = camera.project(
        gt.posed_joints + torch.as_tensor(true_trans, device=dev))[..., :2]

    # Simulated detector confidences: one joint "occluded" (zero weight),
    # its observation corrupted — the fit must ignore it.
    conf = np.ones(16, "f")
    conf[9] = 0.0
    observed = keypoints_2d.cpu().numpy().copy()
    observed[9] += 5.0

    res = fit(
        params, observed, n_steps=args.steps, lr=0.02,
        data_term="keypoints2d", camera=camera, target_conf=conf,
        fit_trans=True, pose_space="pca", n_pca=15,
        pose_prior_weight=1e-4, shape_prior_weight=1e-3,
    )

    out = core.forward(params, res.pose, res.shape)
    reproj = camera.project(out.posed_joints + res.trans)[..., :2]
    err = torch.linalg.norm(reproj - keypoints_2d, dim=-1).cpu().numpy()
    print(f"2D keypoint fit: {args.steps} steps, "
          f"trusted-joint reprojection max err {err[conf > 0].max():.2e} NDC, "
          f"occluded joint err {err[9]:.2e} (excluded from the loss)")
    print(f"recovered translation {res.trans.cpu().numpy().round(4).tolist()} "
          f"vs true {true_trans.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
