"""Detector to engine: 21 noisy keypoints -> closed-form init ->
limit-constrained fit -> skinned glTF.

The full production path a pose-estimation stack needs, end to end:

1. a detector emits 21 noisy 3D keypoints of a hand rotated FAR from
   the rest orientation (the case that defeats cold-started local
   solvers);
2. ``initialize_from_joints`` recovers the global pose in ONE Kabsch
   SVD — no restart sweep;
3. the articulated fit runs with a corpus-derived anatomical joint-limit
   box (``pose_limits_from_corpus`` + the squared-hinge prior) walling
   off hyperextension the sparse keypoints cannot rule out;
4. the result ships as a SKINNED GLB (joint hierarchy, LBS weights,
   quaternion track) any engine can drive — not a baked mesh.

    python examples_torch/17_detector_to_glb.py [--device cpu]
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
    ap.add_argument("--out", default="detector_fit.glb")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import (
        fit, initialize_from_joints, pose_limits_from_corpus,
    )
    from mano_hand_tpu_torch.io.gltf import export_glb_skinned
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(21)

    # Anatomical box from a flexion-style corpus (with official assets:
    # their scan poses via assets.scans.decode_scan_poses).
    corpus = np.zeros((400, 16, 3), np.float32)
    corpus[:, 1:, 0] = rng.uniform(0.0, 1.1, size=(400, 15))
    lo, hi = pose_limits_from_corpus(params, corpus)

    # "Detector output": 21 keypoints of a far-rotated, bent hand + noise.
    true_pose = np.zeros((16, 3), np.float32)
    true_pose[0] = [0.3, 2.8, 0.2]             # ~2.8 rad from rest
    true_pose[1:, 0] = rng.uniform(0.2, 0.9, size=15)
    truth = core.forward(params, torch.as_tensor(true_pose, device=dev),
                         torch.zeros(10, device=dev))
    kp21 = torch.as_tensor(
        core.keypoints(truth, "smplx").cpu().numpy()
        + rng.normal(scale=2e-3, size=(21, 3)).astype(np.float32),
        device=dev)

    # 2. One SVD instead of a restart sweep.
    init = initialize_from_joints(params, kp21, tip_vertex_ids="smplx")
    print(f"Kabsch init: global rot |aa| = "
          f"{float(torch.linalg.norm(init['pose'][0])):.2f} rad recovered "
          "closed-form")

    # 3. Articulated fit inside the anatomical box.
    res = fit(params, kp21, data_term="joints",
              tip_vertex_ids="smplx", n_steps=300, lr=0.03,
              shape_prior_weight=1e-3,
              joint_limits=(lo, hi), joint_limit_weight=1.0,
              init={"pose": init["pose"]})
    fitted = core.forward(params, res.pose, res.shape)
    kp_err = float((core.keypoints(fitted, "smplx") - kp21).abs().max())
    flat = res.pose[1:].reshape(-1)
    viol = max(float(torch.clamp(lo - flat, min=0).max()),
               float(torch.clamp(flat - hi, min=0).max()))
    print(f"fit: keypoint err {kp_err * 1e3:.2f} mm, worst limit "
          f"violation {viol:.3f} rad")
    assert kp_err < 0.01 and viol < 0.05

    # 4. Ship the skeleton, not a baked mesh: pose clip = rest -> fit.
    clip = np.stack([np.zeros((16, 3), np.float32),
                     res.pose.cpu().numpy().astype(np.float32)])
    rest = core.forward(params, torch.zeros((16, 3), device=dev), res.shape)
    path = export_glb_skinned(
        rest.verts.cpu().numpy(), params.faces.cpu().numpy(),
        rest.joints.cpu().numpy(), params.parents,
        params.lbs_weights.cpu().numpy(), args.out,
        pose_frames=clip, fps=2.0,
    )
    print(f"wrote skinned GLB to {path} (drivable joints, "
          "rest->fit clip)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
