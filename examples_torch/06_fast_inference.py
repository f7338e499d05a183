"""High-throughput inference: the hand-written CUDA kernel paths.

The fastest differentiable batched forward on the card runs the blend and
the skinning in ONE kernel launch (K4, ``csrc/fused_forward.cu``) after a
PyTorch pre-stage, so the blended vertices never reach device memory.
This example shows the three ways to consume it:

  * ``core.forward_batched_pallas_fused``   — one launch, moderate batches
  * ``core.forward_chunked(use_pallas_fused=True)`` — huge batches, bounded
    memory
  * ``parallel.pallas_forward_dp``          — the same kernel on each
    rank's rows of a batch sharded over a mesh of ranks (data
    parallelism, no collectives)

    python examples_torch/06_fast_inference.py [--device cpu]

On the CPU the kernel wrappers run the kernel's plain PyTorch version
(functional, not fast); on the card they launch the kernel. (The names
``*_pallas_*`` keep the JAX package's, whose kernels are Pallas.)
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device, sync


def main(argv=None, outputs=None) -> int:
    """``outputs``, when a dict, receives the inputs and each route's
    vertices (for a caller that holds them against a reference)."""
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    import torch.distributed as dist

    from mano_hand_tpu_torch import parallel
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.parallel import sharding as shd

    on_card = dev.type == "cuda"  # CPU: the plain versions; card: kernels
    params = synthetic_params(seed=0, device=dev).astype(torch.float32)

    rng = np.random.default_rng(0)
    b = args.batch if on_card else min(args.batch, 64)
    if b != args.batch:
        print(f"plain path: clamping --batch {args.batch} -> {b}")
    pose = torch.as_tensor(rng.normal(scale=0.5, size=(b, 16, 3)),
                           dtype=torch.float32, device=dev)
    beta = torch.as_tensor(rng.normal(size=(b, 10)), dtype=torch.float32,
                           device=dev)

    # 1. One fused-kernel launch. Differentiable: autograd flows through
    #    a hybrid backward (including true parameter gradients).
    verts = core.forward_batched_pallas_fused(params, pose, beta)
    print(f"fused kernel: verts {tuple(verts.shape)}")

    # Cross-check against the plain path — the kernel must agree to <1e-4.
    want = core.forward_batched(params, pose, beta).verts
    err = float((verts - want).abs().max())
    print(f"max err vs plain path: {err:.2e}")
    assert err < 1e-4

    # 2. Huge batches: chunked launches bound the live intermediate.
    big = core.forward_chunked(
        params, pose, beta, chunk_size=max(b // 4, 1),
        use_pallas_fused=True,
    )
    print(f"chunked fused: verts {tuple(big.shape)}")

    # 3. Multi-device shape: the same kernel on each rank's rows over the
    #    mesh ('data' dim = every rank of the process group; with no group
    #    a one-rank group starts here, and ends before we return).
    started = not dist.is_initialized()
    mesh = parallel.make_mesh(devices=[dev] if started else None)
    try:
        dp = shd.pallas_forward_dp(params, mesh)
        n_dev = mesh.size()  # batch shards over every rank in the mesh
        b_dp = (b // n_dev) * n_dev
        verts_dp = dp(pose[:b_dp], beta[:b_dp])
        print(f"sharded ({n_dev} device(s)): verts {tuple(verts_dp.shape)}")
        if outputs is not None:
            outputs.update(pose=pose, beta=beta, fused=verts, chunked=big,
                           sharded=verts_dp.full_tensor())
    finally:
        if started:
            parallel.mesh.destroy_group()

    if on_card:
        sync(dev)
        t0 = time.perf_counter()
        core.forward_batched_pallas_fused(params, pose, beta)
        sync(dev)
        dt = time.perf_counter() - t0
        print(f"one warm launch: {dt * 1e3:.2f} ms wall "
              f"({b / dt:,.0f} evals/s incl. the pre-stage and the host's "
              "launches; the kernel alone is timed in chip_smoke.py)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
