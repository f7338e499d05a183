"""Fit dataset-style annotations: pixel keypoints + mask + a real K matrix.

FreiHAND/HO-3D-style datasets ship a pixel-unit calibration matrix K,
OpenCV-convention pixel keypoints, and segmentation masks. This example
runs that workflow end to end: build the camera with ``from_intrinsics``,
convert the pixel keypoints ONCE with ``pixels_to_ndc``, fit the
combined detector+segmenter energy (keypoints pin the skeleton, the mask
soft-IoU refines the outline), and report mean reprojection error back
in PIXELS on the dataset image — the metric dataset leaderboards speak.

    python examples_torch/14_dataset_calibration.py [--device cpu]
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
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--size", type=int, default=48,
                    help="calibrated image size (square)")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz.camera import from_intrinsics
    from mano_hand_tpu_torch.viz.silhouette import soft_silhouette

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    s = args.size
    # A plausible calibration: ~2x image-width focal, principal point
    # slightly off centre (real calibrations never sit exactly at W/2).
    K = np.array([[2.0 * s, 0.0, 0.52 * s],
                  [0.0, 2.0 * s, 0.47 * s],
                  [0.0, 0.0, 1.0]])
    cam = from_intrinsics(K, width=s, height=s, trans=(0.0, 0.0, 0.45),
                          device=dev)

    # "Dataset frame": ground truth the annotations were made from.
    true_t = torch.tensor([0.02, -0.015, 0.0], device=dev)
    gt = core.forward(params)
    uv = cam.ndc_to_pixels(
        cam.project(gt.posed_joints + true_t)[..., :2]
    ).cpu().numpy()                              # pixel keypoints
    mask = (soft_silhouette(gt.verts + true_t, params.faces, cam,
                            height=s, width=s, sigma=1.0) > 0.5
            ).to(torch.float32)                  # segmentation mask
    print(f"{s}x{s} image, {int(mask.sum())} mask px, "
          f"keypoints in [{uv.min():.1f}, {uv.max():.1f}] px")

    res = fit(
        params, cam.pixels_to_ndc(torch.as_tensor(uv, device=dev)),
        n_steps=args.steps, lr=0.02, data_term="keypoints2d", camera=cam,
        fit_trans=True, target_mask=mask, mask_weight=0.3,
        pose_prior_weight=1.0, shape_prior_weight=1.0,
    )
    out = core.forward(params, res.pose, res.shape)
    uv_fit = cam.ndc_to_pixels(
        cam.project(out.posed_joints + res.trans)[..., :2]).cpu().numpy()
    px_err = float(np.linalg.norm(uv_fit - uv, axis=-1).mean())
    print(f"fit: mean reprojection error {px_err:.2f} px over "
          f"{uv.shape[0]} keypoints")
    assert px_err < 1.0, px_err
    return 0


if __name__ == "__main__":
    sys.exit(main())
