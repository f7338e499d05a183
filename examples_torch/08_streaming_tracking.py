"""Streaming (online) tracking: solve each frame as it arrives.

The causal counterpart of examples_torch/05: no future frames, no joint
clip solve — each frame's inverse problem warm-starts from the previous
frame's solution, so a handful of second-order steps per frame keeps up.
This is the live-sensor workflow; the reference's analogue is its
forward-only serial animation loop
(its ``data_explore.py:12-15``).

    python examples_torch/08_streaming_tracking.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device, sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--steps", type=int, default=6,
                    help="LM steps per frame")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import make_tracker
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    rng = np.random.default_rng(8)
    t = args.frames

    # A smooth "sensor" clip: rest pose easing into a random grasp.
    end = rng.normal(scale=0.3, size=(16, 3)).astype("f")
    w = np.linspace(0.0, 1.0, t, dtype=np.float32)[:, None, None]
    true_poses = w * end[None]
    frames = core.forward_batched(
        params, torch.as_tensor(true_poses, device=dev),
        torch.zeros((t, 10), device=dev)).verts

    state, step = make_tracker(params, solver="lm", n_steps=args.steps)
    errs, times = [], []
    for i in range(t):
        t0 = time.perf_counter()
        state, res = step(state, frames[i])
        sync(dev)
        times.append(time.perf_counter() - t0)
        got = core.forward(params, state.pose, state.shape).verts
        errs.append(float(torch.linalg.norm(got - frames[i], dim=-1).max()))
    # Nothing compiles here. Frame 0 pays the closed-form (Kabsch) seed of
    # the rest skeleton and the first use of the solver's kernels and
    # caches; steady state is what a live loop sees.
    print(f"tracked {t} frames causally ({args.steps} LM steps each)")
    print(f"  first frame (Kabsch seed, first use): {times[0] * 1e3:8.1f} ms")
    print(f"  steady state:          {np.mean(times[1:]) * 1e3:8.1f} "
          f"ms/frame")
    print(f"  worst per-frame vertex error: {max(errs):.2e} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
