"""Second-order registration of an UNCENTERED scan: LM + translation DOF.

Example 07 registers a centered cloud with the first-order pipeline; real
depth-sensor crops arrive in CAMERA coordinates — rigidly offset from the
model frame by an amount no pose articulation can absorb. The
second-order answer:

  1. closed-form Kabsch seed from 16 detected joints (one SVD: rotation
     AND the pivot-compensating translation);
  2. trimmed point-to-point ICP with ``fit_lm(fit_trans=True)`` — the
     translation column block is exact, so Gauss-Newton moves the rigid
     offset and the articulation together;
  3. one point-to-plane polish pass (normal-distance rows; the documented
     polish-only stage).

    python examples_torch/18_uncentered_scan_lm.py [--device cpu]
        [--points 500] [--offset 0.15] [--steps 15]
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
    ap.add_argument("--points", type=int, default=500)
    ap.add_argument("--offset", type=float, default=0.15,
                    help="rigid offset magnitude, meters (a camera-frame "
                         "crop is typically decimeters off)")
    ap.add_argument("--noise", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--out", default="uncentered_registration.npz")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import fit_lm
    from mano_hand_tpu_torch.fitting.initialize import initialize_from_joints
    from mano_hand_tpu_torch.io.checkpoints import save_fit_result
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(7)

    # Ground truth: a posed hand, then the whole observation shifted into
    # a "camera frame" by a rigid offset.
    pose_true = rng.normal(scale=0.25, size=(16, 3)).astype(np.float32)
    offset = (args.offset * np.asarray([0.6, -0.3, 0.74])).astype(
        np.float32)
    truth = core.forward(params, torch.as_tensor(pose_true, device=dev),
                         torch.zeros(10, device=dev))
    pick = rng.permutation(truth.verts.shape[0])[:args.points]
    cloud = (truth.verts.cpu().numpy()[pick] + offset
             + rng.normal(scale=args.noise, size=(len(pick), 3))
             ).astype(np.float32)
    joints_obs = (truth.posed_joints.cpu().numpy() + offset
                  + rng.normal(scale=2e-3, size=(16, 3))).astype(np.float32)
    cloud_t = torch.as_tensor(cloud, device=dev)

    # 1. Kabsch: rotation + translation in closed form from the detector
    #    joints (the offset lands almost entirely in seed["trans"]).
    seed = initialize_from_joints(params, torch.as_tensor(joints_obs,
                                                          device=dev))
    print(f"Kabsch seed trans: {np.round(seed['trans'].cpu().numpy(), 4)} "
          f"(true offset {np.round(offset, 4)})")

    # 2. Trimmed ICP with the translation DOF, warm-started by the seed.
    coarse = fit_lm(
        params, cloud_t, n_steps=args.steps,
        data_term="points", fit_trans=True, trim_fraction=0.05,
        shape_weight=0.1,
        init={"pose": seed["pose"], "trans": seed["trans"]},
    )

    # 3. Point-to-plane polish from the converged ICP state.
    polish = fit_lm(
        params, cloud_t, n_steps=max(3, args.steps // 3),
        data_term="point_to_plane", fit_trans=True, shape_weight=0.1,
        init={"pose": coarse.pose, "shape": coarse.shape,
              "trans": coarse.trans},
    )

    fitted = (core.forward(params, polish.pose, polish.shape).verts
              + polish.trans).cpu().numpy()
    trans = polish.trans.cpu().numpy()
    d = np.sqrt(((cloud[:, None] - fitted[None]) ** 2).sum(-1)).min(1)
    print(f"trans error:  {np.abs(trans - offset).max():.2e} m")
    print(f"cloud->mesh:  mean {d.mean():.2e} m, p95 "
          f"{np.quantile(d, 0.95):.2e} m")
    out_path = save_fit_result(polish, args.out)
    print(f"wrote {out_path}")
    # Registration must absorb the decimeter offset down to noise scale.
    ok = (np.abs(trans - offset).max() < 5e-3
          and float(np.quantile(d, 0.95)) < 5e-3)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
