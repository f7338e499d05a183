"""Hand-object grasp fitting: compose your own energy from the library's
objective terms.

The built-in solvers cover the common energies; when a workflow needs a
custom one — here, a hand grasping a RIGID OBJECT — the pure functions
compose directly into an eager PyTorch loop under ``OptaxAdam`` (optax's
``adam`` arithmetic):

    E(theta, beta) = keypoint attraction        (objectives.joint_l2)
                   + object non-penetration     (objectives.inter_penetration
                                                 vs the object point cloud)
                   + pose prior                 (objectives.l2_prior)

The object term is the two-hand repulsion reused verbatim: a hinge on
hand-vertex-to-object-point distances inside a contact radius. Without
it, the keypoint fit drives fingers THROUGH the object; with it, the
hand wraps the surface (penetration drops orders of magnitude at
millimeter-level keypoint cost).

    python examples_torch/21_grasp_fitting.py [--device cpu]
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
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import objectives
    from mano_hand_tpu_torch.fitting.solvers import OptaxAdam
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(21)

    # The grasp target: a curled pose, keypoints observed with noise.
    true_pose = np.zeros((16, 3), np.float32)
    true_pose[1:, 0] = rng.uniform(0.3, 0.9, size=15)
    truth = core.forward(params, torch.as_tensor(true_pose, device=dev),
                         torch.zeros(10, device=dev))
    kp = core.keypoints(truth, "smplx").cpu().numpy()
    kp = torch.as_tensor(
        kp + rng.normal(scale=1.5e-3, size=kp.shape).astype(np.float32),
        device=dev)

    # The rigid object: a small ball sitting against the palm — exactly
    # where a naive keypoint fit pushes vertices through.
    palm = truth.verts.cpu().numpy().mean(axis=0)
    centre = palm + np.float32([0.0, 0.015, 0.012])
    sph = rng.normal(size=(256, 3)).astype(np.float32)
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    obj = torch.as_tensor(centre + 0.012 * sph, device=dev)  # r = 12 mm

    contact_r = 0.004  # hinge radius: "skin thickness" of the contact

    def penetration(verts):
        return objectives.inter_penetration(verts, obj, radius=contact_r)

    def energy(state, w_pen):
        out = core.forward(params, state["pose"], state["shape"])
        e_kp = objectives.joint_l2(core.keypoints(out, "smplx"), kp)
        return (e_kp + w_pen * penetration(out.verts)
                + 1e-3 * objectives.l2_prior(state["shape"]))

    def solve(w_pen):
        state = {"pose": torch.zeros((16, 3), device=dev,
                                     requires_grad=True),
                 "shape": torch.zeros(10, device=dev, requires_grad=True)}
        opt = OptaxAdam(list(state.values()), lr=0.02)
        for _ in range(args.steps):
            opt.zero_grad()
            energy(state, w_pen).backward()
            opt.step()
        with torch.no_grad():
            out = core.forward(params, state["pose"], state["shape"])
        kp_err = float((core.keypoints(out, "smplx") - kp).abs().max())
        return out, kp_err

    naive, kp_naive = solve(w_pen=0.0)
    pen_naive = float(penetration(naive.verts))
    grasp, kp_grasp = solve(w_pen=50.0)
    pen_grasp = float(penetration(grasp.verts))

    print(f"naive keypoint fit: kp err {kp_naive * 1e3:.2f} mm, "
          f"object penetration energy {pen_naive:.2e}")
    print(f"grasp fit (+object term): kp err {kp_grasp * 1e3:.2f} mm, "
          f"object penetration energy {pen_grasp:.2e} "
          f"({pen_naive / max(pen_grasp, 1e-12):.0f}x less)")
    assert kp_grasp < 0.01
    assert pen_grasp < pen_naive * 0.2 or pen_grasp < 1e-8
    return 0


if __name__ == "__main__":
    sys.exit(main())
