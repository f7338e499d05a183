"""Mask-based inverse MANO: fit translation + pose to segmentation masks.

The one supervision a segmenter provides with no keypoint detector: binary
[H, W] masks. The mesh is differentiably rasterised (SoftRas-style soft
silhouette, viz/silhouette.py) and scored by soft IoU. A single view
cannot observe depth — any outline-preserving motion is free — so this
example fits TWO calibrated weak-perspective views jointly (the
visual-hull setup, ``camera=(front, side)``): with the second view the
full 3D translation becomes observable, including the z that view one
cannot see.

    python examples_torch/12_silhouette_fitting.py [--device cpu]
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
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=32, help="mask resolution")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit, objectives
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz import WeakPerspectiveCamera, view_rotation
    from mano_hand_tpu_torch.viz.silhouette import soft_silhouette

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    h = w = args.size

    # Two calibrated views, 90 degrees apart around the vertical axis.
    front = WeakPerspectiveCamera(rot=torch.eye(3, device=dev), scale=3.0)
    side = WeakPerspectiveCamera(
        rot=view_rotation([0.0, np.pi / 2, 0.0], device=dev), scale=3.0)
    cams = (front, side)

    # Ground truth: the hand displaced in all THREE axes. Binarize the
    # rendered silhouettes — the form real segmenter output takes.
    true_trans = torch.tensor([0.03, 0.02, 0.04], device=dev)
    gt = core.forward(params)
    masks = torch.stack([
        (soft_silhouette(gt.verts + true_trans, params.faces, c,
                         height=h, width=w, sigma=1.0) > 0.5
         ).to(torch.float32)
        for c in cams
    ])                                                     # [2, H, W]
    print(f"two {h}x{w} masks, {int(masks[0].sum())}/{int(masks[1].sum())} "
          "foreground px")

    res = fit(
        params, masks, n_steps=args.steps, lr=0.01,
        data_term="silhouette", camera=cams, sil_sigma=1.0,
        fit_trans=True, pose_prior_weight=1.0, shape_prior_weight=1.0,
    )
    trans = res.trans.cpu().numpy()
    truth = true_trans.cpu().numpy()
    err = np.linalg.norm(trans - truth)
    print(f"fit translation: {np.round(trans, 4).tolist()} "
          f"(true {np.round(truth, 4).tolist()}, "
          f"error {err * 1000:.1f} mm)")

    # Per-view IoU of the refit mesh against the target masks.
    refit = core.forward(params, res.pose, res.shape)
    for name, cam, mask in zip(("front", "side"), cams, masks):
        sil = soft_silhouette(refit.verts + res.trans, params.faces, cam,
                              height=h, width=w, sigma=1.0)
        iou = 1.0 - float(objectives.silhouette_iou_loss(sil, mask))
        print(f"{name} view soft IoU: {iou:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
