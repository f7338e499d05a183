"""Depth-image fitting, and WHY it exists: depth observes z; outlines don't.

The same scene fitted two ways from one camera: a silhouette fit (the
mask term) and a depth fit (the soft z-buffer term). The hand is
displaced along ALL three axes — including straight toward the camera.
The mask fit recovers the image-plane motion but is structurally blind
to z; the depth fit recovers all three axes, because the depth image IS
the z measurement. This is the experiment to run when choosing a data
term for sensor input.

    python examples_torch/15_depth_fitting.py [--device cpu]
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
    ap.add_argument("--size", type=int, default=32, help="image resolution")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz.camera import default_hand_camera
    from mano_hand_tpu_torch.viz.silhouette import soft_depth, soft_silhouette

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    cam = default_hand_camera(device=dev)    # pinhole: depth is meaningful
    s = args.size

    # Ground truth: displaced in x, y AND z (toward the camera).
    true_t = torch.tensor([0.02, 0.015, 0.03], device=dev)
    truth = true_t.cpu().numpy()
    gt = core.forward(params)

    depth_img = soft_depth(gt.verts + true_t, params.faces, cam,
                           height=s, width=s, sigma=1.0)
    depth_img = torch.where(depth_img > 5.0, 0.0, depth_img)  # sensor holes
    mask = (soft_silhouette(gt.verts + true_t, params.faces, cam,
                            height=s, width=s, sigma=1.0) > 0.5
            ).to(torch.float32)
    n_valid = int((depth_img > 0).sum())
    print(f"{s}x{s} depth image ({n_valid} valid px) + mask "
          f"({int(mask.sum())} px); true displacement "
          f"{np.round(truth, 3).tolist()} m")

    kw = dict(n_steps=args.steps, lr=0.01, camera=cam, sil_sigma=1.0,
              fit_trans=True, pose_prior_weight=1.0, shape_prior_weight=1.0)
    res_mask = fit(params, mask, data_term="silhouette", **kw)
    res_depth = fit(params, depth_img, data_term="depth", **kw)

    for name, res in (("silhouette", res_mask), ("depth", res_depth)):
        t = res.trans.cpu().numpy()
        z_err = abs(t[2] - float(truth[2]))
        xy_err = float(np.linalg.norm(t[:2] - truth[:2]))
        print(f"{name:10s} fit: xy err {xy_err * 1e3:5.1f} mm, "
              f"z err {z_err * 1e3:5.1f} mm "
              f"(trans {np.round(t, 4).tolist()})")

    z_mask = abs(float(res_mask.trans[2] - true_t[2]))
    z_depth = abs(float(res_depth.trans[2] - true_t[2]))
    # The structural claim, asserted: depth sees z; the outline doesn't.
    assert z_depth < 0.005, z_depth
    assert z_depth < 0.5 * z_mask, (z_depth, z_mask)
    print("depth fit pinned z; the mask fit could not — choose the "
          "depth term for sensor input")
    return 0


if __name__ == "__main__":
    sys.exit(main())
