"""Joint two-hand fitting: one observation, two hands, no interpenetration.

The reference treats hands as two unrelated model instances evaluated in
separate calls (its ``dump_model.py:48-49``). Real two-hand data
is one frame containing both — and fitting them independently lets noisy
or sparse observations pull the meshes through each other. ``fit_hands``
solves both hands as one problem over stacked parameters, with an
inter-penetration hinge that lets the fitted surfaces touch but not
overlap.

    python examples_torch/10_two_hands_fitting.py [--device cpu]
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
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_pair
    from mano_hand_tpu_torch.fitting import fit_hands, inter_penetration
    from mano_hand_tpu_torch.models import core

    left, right = synthetic_pair(seed=0, device=dev)
    stacked = core.stack_params(
        left.astype(torch.float32), right.astype(torch.float32)
    )

    def both(pose, shape):
        """Each hand's forward under its own params: [2, ...] leaves."""
        out = core.forward_hands(stacked, pose[:, None], shape[:, None])
        return core.ManoOutput(*(x[:, 0] for x in out))

    # Ground truth: two hands ALMOST touching (4 mm apart) — then observe
    # only their 21-keypoint skeletons, the typical detector output.
    rng = np.random.default_rng(0)
    pose = torch.as_tensor(rng.normal(scale=0.2, size=(2, 16, 3)),
                           dtype=torch.float32, device=dev)
    shape = torch.zeros((2, 10), device=dev)
    out = both(pose, shape)
    trans = torch.tensor([[0.0, 0, 0], [0.004, 0, 0]], device=dev)
    targets = core.keypoints(out, "smplx") + trans[:, None, :]

    def report(label, res):
        o = both(res.pose, res.shape)
        verts = o.verts + res.trans[:, None, :]
        kp = core.keypoints(o, "smplx") + res.trans[:, None, :]
        pen = float(inter_penetration(verts[0], verts[1], radius=0.004))
        fit_err = float((kp - targets).abs().max())
        print(f"{label}: keypoint err {fit_err * 1e3:.2f} mm, "
              f"penetration energy {pen:.3e}")
        return pen

    common = dict(n_steps=args.steps, lr=0.03, data_term="joints",
                  fit_trans=True, tip_vertex_ids="smplx",
                  shape_prior_weight=1e-3)
    pen_off = report(
        "without repulsion",
        fit_hands(stacked, targets, repulsion_weight=0.0, **common),
    )
    pen_on = report(
        "with repulsion   ",
        fit_hands(stacked, targets, repulsion_weight=20.0,
                  repulsion_radius=0.004, **common),
    )
    print(f"fit: repulsion cut penetration {pen_off / max(pen_on, 1e-12):.1f}x "
          "while the keypoints still fit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
