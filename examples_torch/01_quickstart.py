"""Quickstart: load an asset, run the forward pass, export a mesh.

Covers the reference's demo workflow (its ``mano_np.py:205-219``)
through the PyTorch port. Runs on the card, or on the CPU when asked:

    python examples_torch/01_quickstart.py [--device cpu] [--asset path.npz]

Without a real MANO asset the synthetic generator stands in (same schema,
random arrays) — swap in a converted official asset via --asset.
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
    ap.add_argument("--asset", default="synthetic")
    ap.add_argument("--out", default="quickstart_hand.obj")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import load_model, synthetic_params
    from mano_hand_tpu_torch.io import export_obj_pair
    from mano_hand_tpu_torch.models import core

    params = (
        synthetic_params(seed=0, device=dev) if args.asset == "synthetic"
        else load_model(args.asset, device=dev)
    ).astype(torch.float32)

    # One forward: axis-angle pose [16, 3] + shape coeffs [10].
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.normal(scale=0.3, size=(16, 3)), **f32)
    shape = torch.as_tensor(rng.normal(size=10), **f32)
    out = core.forward(params, pose, shape)
    print(f"verts {tuple(out.verts.shape)}, joints "
          f"{tuple(out.posed_joints.shape)}, device {dev}")

    # Batched + differentiable come for free:
    batch = core.forward_batched(
        params,
        torch.as_tensor(rng.normal(scale=0.3, size=(64, 16, 3)), **f32),
        torch.zeros((64, 10), **f32),
    )
    print(f"batched verts {tuple(batch.verts.shape)}")

    export_obj_pair(out.verts, out.rest_verts, params.faces, args.out)
    print(f"wrote {args.out} (+ restpose twin)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
