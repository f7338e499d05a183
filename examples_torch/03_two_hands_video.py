"""Two-hand animation clip -> rendered AVI, on the device.

The reference loops set_params per frame into an external OpenGL viewer
(its ``data_explore.py:8-18``). Here the whole clip — both hands,
every frame — evaluates as one hand-batched forward, renders with the
built-in z-buffer rasteriser, and writes a dependency-free AVI.

    python examples_torch/03_two_hands_video.py [--device cpu] [--frames 24]
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
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default="two_hands.avi")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch import viz
    from mano_hand_tpu_torch.assets import synthetic_pair
    from mano_hand_tpu_torch.models import anim

    left, right = synthetic_pair(seed=0, dtype=torch.float32, device=dev)

    # A keyframed wiggle, slerp-retimed to the requested frame count:
    # [T, 2, 16, 3] — frame-major, hand axis (L, R).
    rng = np.random.default_rng(2)
    keys = rng.normal(scale=0.35, size=(4, 2, 16, 3))
    poses = anim.resample_poses_slerp(
        keys.reshape(4, 2 * 16, 3), args.frames
    ).reshape(args.frames, 2, 16, 3)

    verts = anim.evaluate_two_hand_sequence(
        left, right, torch.as_tensor(poses, dtype=torch.float32, device=dev)
    )  # [T, 2, 778, 3]
    print(f"evaluated {args.frames} frames x 2 hands: {tuple(verts.shape)}")

    # Offset the hands apart and render both meshes per frame by
    # concatenating their geometry (faces of the right hand re-indexed).
    lv = verts[:, 0] + torch.tensor([-0.12, 0, 0], device=dev)
    rv = verts[:, 1] + torch.tensor([+0.12, 0, 0], device=dev)
    both = torch.cat([lv, rv], dim=1)
    faces = left.faces
    both_faces = torch.cat([faces, faces + lv.shape[1]])

    frames = viz.render_sequence(both, both_faces,
                                 height=args.size, width=args.size)
    viz.write_avi(frames, args.out, fps=12)
    print(f"wrote {args.out} "
          f"({viz.read_avi_info(args.out)['n_frames']} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
