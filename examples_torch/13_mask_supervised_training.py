"""Train a 2D-to-3D lifter with MASK-ONLY supervision (no 3D labels).

The weakly-supervised setup differentiable rendering exists for: a
network maps noisy 2D keypoint detections to global rotation +
translation, the mesh head poses the hand, the soft rasteriser renders
it into TWO calibrated views, and the ONLY loss is silhouette IoU
against segmentation masks — no 3D pose, translation, or vertex labels
anywhere. Gradients flow network -> pose/trans -> FK/skinning ->
rasteriser -> IoU. Two views make translation (z included) observable;
a second view is cheaper than a single 3D label.

Tiny sizes so the tests run it; the structure is the real one.

    python examples_torch/13_mask_supervised_training.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import (
    add_device_flag, example_device, init_dense_, load_dense_,
)

ID6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class LiftNet(torch.nn.Module):
    """Noisy 2D keypoints [B, J, 2] -> (global 6D rotation, translation),
    through two 96-wide ReLU layers (the JAX example's flax widths)."""

    def __init__(self, n_joints: int):
        super().__init__()
        self.hidden = torch.nn.ModuleList([
            torch.nn.Linear(n_joints * 2, 96), torch.nn.Linear(96, 96)])
        self.rot_head = torch.nn.Linear(96, 6)
        self.trans_head = torch.nn.Linear(96, 3)
        self.layers = [*self.hidden, self.rot_head, self.trans_head]
        self.register_buffer("id6d", torch.tensor(ID6D))

    def forward(self, kp2d):
        x = kp2d.reshape(kp2d.shape[0], -1)
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.rot_head(x) + self.id6d, 0.1 * self.trans_head(x)


def load_jax_weights(net: LiftNet, dense: dict) -> None:
    """Start ``net`` from the JAX example's flax weights (numpy
    ``{"Dense_i": {"kernel", "bias"}}``)."""
    load_dense_(net.layers, dense)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=24, help="mask resolution")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch import ops
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import objectives
    from mano_hand_tpu_torch.fitting.solvers import OptaxAdam
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz import WeakPerspectiveCamera, view_rotation
    from mano_hand_tpu_torch.viz.silhouette import soft_silhouette

    # Small asset: the rasteriser's [pixels, faces] slabs dominate the
    # step, and 96 faces keep the tests fast with the full pipeline intact.
    params = synthetic_params(seed=0, n_verts=64, n_faces=96,
                              dtype=torch.float32, device=dev)
    h = w = args.size
    front = WeakPerspectiveCamera(rot=torch.eye(3, device=dev), scale=3.0)
    side = WeakPerspectiveCamera(
        rot=view_rotation([0.0, np.pi / 2, 0.0], device=dev), scale=3.0)
    cams = (front, side)
    n_joints = params.n_joints

    def pose_rotmats(rot6d):                     # [B, 6] global only
        """Full [B, 16, 3, 3] rotations: predicted global, rest fingers."""
        glob = ops.matrix_from_6d(rot6d)[:, None]          # [B, 1, 3, 3]
        eye = torch.eye(3, dtype=rot6d.dtype, device=dev).expand(
            rot6d.shape[0], n_joints - 1, 3, 3)
        return torch.cat([glob, eye], dim=1)

    def geometry(rot6d, trans):
        out = core.forward_batched_rotmats(
            params, pose_rotmats(rot6d),
            torch.zeros((rot6d.shape[0], params.n_shape), device=dev))
        verts = out.verts + trans[:, None, :]
        joints = out.posed_joints + trans[:, None, :]
        return verts, joints

    def render_views(verts):                     # [B, V, 3] -> [B, 2, H, W]
        # The whole batch and image in one [B, H * W, F] slab a view
        # (under 2 MB at the default sizes): few, large ops on any device.
        return torch.stack(
            [soft_silhouette(verts, params.faces, c, height=h, width=w,
                             sigma=1.0, chunk_rows=h, batch_mode="vmap")
             for c in cams],
            dim=1,
        )

    def sample_batch(gen, batch):
        """(noisy 2D keypoints, target masks, true trans, true rot6d),
        drawn from ``gen`` (a CPU generator: the same batches on the card
        and on the CPU)."""
        aa = (0.4 * torch.randn((batch, 3), generator=gen)).to(dev)
        trans = (0.04 * torch.randn((batch, 3), generator=gen)).to(dev)
        with torch.no_grad():
            rot6d_true = ops.matrix_to_6d(
                ops.rotation_matrix(aa[:, None, :]).reshape(batch, 3, 3))
            verts, joints = geometry(rot6d_true, trans)
            masks = (render_views(verts) > 0.5).to(torch.float32)
            kp2d = front.project(joints)[..., :2]
        kp2d = kp2d + 0.01 * torch.randn(kp2d.shape, generator=gen).to(dev)
        return kp2d, masks, trans, rot6d_true

    net = LiftNet(n_joints).to(dev)
    gen = torch.Generator().manual_seed(0)
    for layer in net.layers:            # flax's Dense init, from gen
        init_dense_(layer, gen)
    opt = OptaxAdam(net.parameters(), lr=2e-3)

    def loss_fn(kp2d, masks):
        rot6d, trans = net(kp2d)
        verts, _ = geometry(rot6d, trans)
        sils = render_views(verts)
        # The ONLY supervision: per-view soft IoU against the masks.
        return torch.mean(objectives.silhouette_iou_loss(sils, masks))

    # The loss has an IRREDUCIBLE floor: a soft rendering scored against
    # a binarised mask pays for every fractional boundary pixel even at
    # the true pose (~0.25 at these sizes). Judge training by the EXCESS
    # over that floor, computed from ground-truth geometry.
    kp_ev, masks_ev, trans_true, rot6d_ev = sample_batch(
        torch.Generator().manual_seed(777), args.batch)
    with torch.no_grad():
        verts_true, _ = geometry(rot6d_ev, trans_true)
        floor = float(torch.mean(objectives.silhouette_iou_loss(
            render_views(verts_true), masks_ev)))

    losses = []
    for step in range(args.steps):
        kp2d, masks, _, _ = sample_batch(gen, args.batch)
        opt.zero_grad()
        loss = loss_fn(kp2d, masks)
        loss.backward()
        opt.step()
        if step % max(1, args.steps // 5) == 0 or step == args.steps - 1:
            losses.append(loss.item())
            print(f"step {step:4d}: 1 - IoU = {losses[-1]:.4f} "
                  f"(floor ~{floor:.3f})")

    excess0, excess1 = losses[0] - floor, losses[-1] - floor
    assert excess1 < 0.6 * excess0, (
        f"training did not close the gap to the floor: "
        f"{excess0:.4f} -> {excess1:.4f}"
    )
    # Held-out: translation error of the lifter — learned from masks
    # alone, never from a translation label.
    with torch.no_grad():
        _, trans = net(kp_ev)
    terr = float(torch.linalg.norm(trans - trans_true, dim=-1).mean())
    # No-information baseline: predicting zero translation.
    base = float(torch.linalg.norm(trans_true, dim=-1).mean())
    assert terr < 0.8 * base, (terr, base)
    print(f"trained (mask-only supervision): held-out mean translation "
          f"error {terr * 1e3:.1f} mm (predict-zero baseline "
          f"{base * 1e3:.1f} mm); excess-over-floor 1-IoU "
          f"{excess0:.3f} -> {excess1:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
