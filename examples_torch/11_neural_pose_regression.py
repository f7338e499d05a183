"""Train a neural hand-pose estimator THROUGH the differentiable mesh head.

The use case every torch MANO layer (manopth, smplx) exists for: a
network regresses pose from observations, the mesh head turns pose into
geometry, and the loss is on the geometry — gradients flow through
Rodrigues, FK, and skinning into the network weights. Here the network
is an ``nn.Module`` whose head is ``interop.TorchManoLayer`` fed 6D
rotations (the standard continuous regression target) decoded to
matrices, trained by ``OptaxAdam`` (optax's ``adam`` arithmetic).

The toy task: map noisy 21-keypoint detections to full pose, supervised
only by keypoint + vertex reconstruction (no pose labels — the mesh head
IS the decoder). Tiny sizes so it runs in the tests; the structure is the
real one.

    python examples_torch/11_neural_pose_regression.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from examples_torch._common import (
    add_device_flag, example_device, init_dense_, load_dense_,
)

#: The identity rotation's 6D form: the pose head starts at the rest pose.
ID6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class PoseNet(torch.nn.Module):
    """Keypoints [B, 21, 3] -> (verts, posed joints, shape), through two
    128-wide ReLU layers, a 6D pose head and a shape head (the JAX
    example's flax widths), decoded by the MANO head: ONE mesh-head pass
    serves both loss terms (verts and the 21 keypoints)."""

    def __init__(self, params, n_keypoints: int = 21):
        super().__init__()
        self.hidden = torch.nn.ModuleList([
            torch.nn.Linear(n_keypoints * 3, 128), torch.nn.Linear(128, 128)])
        self.pose_head = torch.nn.Linear(128, params.n_joints * 6)
        self.shape_head = torch.nn.Linear(128, params.n_shape)
        self.layers = [*self.hidden, self.pose_head, self.shape_head]
        from mano_hand_tpu_torch.interop import TorchManoLayer

        self.head = TorchManoLayer(params, pose2rot=False,
                                   device=params.device)
        self.register_buffer("id6d", torch.tensor(ID6D))

    def forward(self, kp):
        from mano_hand_tpu_torch import ops

        x = kp.reshape(kp.shape[0], -1)
        for layer in self.hidden:
            x = torch.relu(layer(x))
        pose6d = self.pose_head(x).reshape(x.shape[0], -1, 6) + self.id6d
        shape = self.shape_head(x)
        verts, joints = self.head(ops.matrix_from_6d(pose6d), shape)
        return verts, joints, shape


def load_jax_weights(net: PoseNet, dense: dict) -> None:
    """Start ``net`` from the JAX example's flax weights (numpy
    ``{"Dense_i": {"kernel", "bias"}}``, the ``params`` collection)."""
    load_dense_(net.layers, dense)


def loss_fn(net: PoseNet, kp_in, verts_gt, kp_gt, tips):
    """Vertex + keypoint reconstruction, and a small shape prior."""
    from mano_hand_tpu_torch.models import core

    verts, joints, shape = net(kp_in)
    kp_pred = core.select_keypoints(verts, joints, tips)
    return (
        torch.mean(torch.sum((verts - verts_gt) ** 2, dim=-1))
        + torch.mean(torch.sum((kp_pred - kp_gt) ** 2, dim=-1))
        + 1e-4 * torch.mean(shape ** 2)
    )


def sample_batch(params, gen: torch.Generator, batch: int):
    """(noisy keypoints, target verts, clean keypoints) for random poses
    drawn from ``gen`` (a CPU generator, so the card and the CPU draw the
    same batches)."""
    from mano_hand_tpu_torch.models import core

    dev = params.device
    kp_pose = (torch.randn((batch, 16, 3), generator=gen) * 0.25).to(dev)
    with torch.no_grad():
        out = core.forward_batched(
            params, kp_pose, torch.zeros((batch, params.n_shape), device=dev))
        kp = core.keypoints(out, "smplx")
    noise = (torch.randn(kp.shape, generator=gen) * 0.002).to(dev)
    return kp + noise, out.verts, kp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting.solvers import OptaxAdam
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    tips = core.resolve_tip_ids("smplx", params.n_verts)

    net = PoseNet(params).to(dev)
    gen = torch.Generator().manual_seed(0)
    for layer in net.layers:            # flax's Dense init, from gen
        init_dense_(layer, gen)
    opt = OptaxAdam(net.parameters(), lr=1e-3)

    losses = []
    for step in range(args.steps):
        kp_in, verts_gt, kp_gt = sample_batch(params, gen, args.batch)
        opt.zero_grad()
        loss = loss_fn(net, kp_in, verts_gt, kp_gt, tips)
        loss.backward()
        opt.step()
        if step % max(1, args.steps // 5) == 0 or step == args.steps - 1:
            losses.append(loss.item())
            print(f"step {step:4d}: loss {losses[-1]:.5f}")

    assert losses[-1] < 0.5 * losses[0], "training did not reduce the loss"
    # Held-out check: mean per-vertex error of the trained estimator.
    kp_in, verts_gt, _ = sample_batch(
        params, torch.Generator().manual_seed(999), args.batch)
    with torch.no_grad():
        verts, _, _ = net(kp_in)
    mpve = float(torch.linalg.norm(verts - verts_gt, dim=-1).mean())
    print(f"trained: held-out mean per-vertex error {mpve * 1e3:.2f} mm "
          f"(loss {losses[0]:.4f} -> {losses[-1]:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
