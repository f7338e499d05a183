"""Anatomical joint limits: corpus-derived bounds that wall off
hyperextension.

A 2D keypoint fit cannot tell a knuckle bent forward from one folded
backward — both project to the same pixels. The joint-limit prior
(`objectives.pose_limit_prior`) fixes the class of failure the
interior-shaping priors (l2 / Mahalanobis) cannot: it is exactly zero
inside a per-DOF axis-angle box and a squared hinge outside it, so it
never fights observations in range and only forbids the impossible.

The box comes from data — `pose_limits_from_corpus` over any pose
corpus (with official assets: the scan poses they ship). Nothing
anatomical is hardcoded in the framework.

    python examples_torch/16_joint_limits.py [--device cpu]
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
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import (
        fit, objectives, pose_limits_from_corpus,
    )
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(7)

    # 1. A pose corpus stands in for the official scan poses: flexion-only
    #    bends (x-axis positive rotations), the way real fingers move.
    corpus = np.zeros((500, 16, 3), np.float32)
    corpus[:, 1:, 0] = rng.uniform(0.0, 1.2, size=(500, 15))
    lo, hi = pose_limits_from_corpus(params, corpus, expand=0.15)
    print(f"corpus-derived bounds: lo in [{float(lo.min()):+.2f}, "
          f"{float(lo.max()):+.2f}], hi in [{float(hi.min()):+.2f}, "
          f"{float(hi.max()):+.2f}] rad")

    # 2. Ground truth inside the feasible box, observed only as 16 noisy
    #    3D joints (sparse data — the prior-hungry regime).
    true_pose = np.zeros((16, 3), np.float32)
    true_pose[1:, 0] = rng.uniform(0.2, 1.0, size=15)
    truth = core.forward(params, torch.as_tensor(true_pose, device=dev),
                         torch.zeros(10, device=dev))
    noisy = truth.posed_joints.cpu().numpy() + rng.normal(
        scale=3e-3, size=(16, 3)).astype(np.float32)

    # 3. Fit with and without the wall. Same data, same steps.
    kw = dict(data_term="joints", n_steps=300, lr=0.05,
              shape_prior_weight=1e-3)
    res_free = fit(params, noisy, **kw)
    res_lim = fit(params, noisy, joint_limits=(lo, hi),
                  joint_limit_weight=1.0, **kw)

    def report(tag, res):
        flat = res.pose[1:].reshape(-1)
        viol = torch.clamp(lo - flat, min=0) + torch.clamp(flat - hi, min=0)
        err = core.forward(params, res.pose, res.shape).posed_joints \
            - truth.posed_joints
        print(f"{tag} fit: joint err "
              f"{float(err.abs().max()) * 1e3:.2f} mm, "
              f"worst bound violation {float(viol.max()):.3f} rad")
        return float(viol.max())

    report("unconstrained", res_free)
    v = report("joint-limited", res_lim)
    assert v < 0.05, "limited fit escaped the admissible box"

    # 4. The hinge energy itself, directly: zero inside, quadratic out.
    inside = ((lo + hi) / 2)[None]
    assert float(objectives.pose_limit_prior(inside, lo, hi)) == 0.0
    print("hinge is exactly zero inside the box — the prior never "
          "fights in-range observations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
