"""Deploy the forward as a self-contained ahead-of-time artifact
(``torch.export``).

The serving story: export the MANO forward once, serialize the program
WITH the parameters baked in as constants, and run it anywhere torch
runs — no model asset, no package internals at inference time. One
artifact covers every batch size (a symbolic batch dimension) and, when
exported on the card, both the CPU and the card (one program each). With
``tip_vertex_ids`` the artifact emits the 21-keypoint set detectors
consume, in OpenPose order.

    python examples_torch/09_aot_serving.py [--device cpu]
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--out", default="mano_fwd.torchexp")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.io.export_aot import load_forward, save_forward
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)

    # -- export side: one call, one file ---------------------------------
    platforms = ("cpu", "cuda") if dev.type == "cuda" else ("cpu",)
    path = save_forward(
        params, args.out, tip_vertex_ids="smplx", keypoint_order="openpose",
        platforms=platforms,
    )
    print(f"wrote {path} ({os.path.getsize(path)} bytes, params baked in)")

    # -- serving side: load and run; no asset, any batch size ------------
    fwd = load_forward(path)
    print(repr(fwd))
    rng = np.random.default_rng(0)
    for batch in (1, 16):
        pose = torch.as_tensor(
            rng.normal(scale=0.3, size=(batch, 16, 3)), dtype=torch.float32,
            device=dev)
        shape = torch.as_tensor(rng.normal(size=(batch, 10)),
                                dtype=torch.float32, device=dev)
        out = fwd(pose, shape)
        # Cross-check against the live forward: same program, same numbers.
        ref = core.forward_batched(params, pose, shape)
        err = float((out["verts"] - ref.verts).abs().max())
        print(
            f"batch={batch}: verts{tuple(out['verts'].shape)} "
            f"keypoints{tuple(out['keypoints'].shape)} "
            f"max err vs live forward {err:.2e}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
