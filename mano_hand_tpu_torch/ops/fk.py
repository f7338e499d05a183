"""Forward kinematics over a static kinematic tree.

(rotation, translation) pairs instead of 4x4 homogeneous matrices, and
level-parallel composition: all joints at one depth compose against
their parents in one batched step (3 steps for MANO instead of 15).
Levels are derived from the ``parents`` tuple and cached. Every function
here broadcasts over leading batch dimensions.

Each 3-term dot product is written out as ``(p0 + p1) + p2`` of separately
rounded products: K2's bf16 variant (``csrc/mano_common.cuh``, the
``kExact`` prelude) performs the same operations in the same order
without fused multiply-adds, so its skinning transforms agree bit for bit
with these and its bf16 rounding of them agrees too.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from mano_hand_tpu_torch.ops.common import index_tensor


@functools.lru_cache(maxsize=None)
def tree_levels(parents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Group joint indices by depth (root excluded). Static, cached."""
    depth = [0] * len(parents)
    for i, p in enumerate(parents):
        if p >= 0:
            depth[i] = depth[p] + 1
    levels = []
    for d in range(1, max(depth) + 1):
        levels.append(tuple(i for i, dd in enumerate(depth) if dd == d))
    return tuple(levels)


def forward_kinematics(
    parents: Tuple[int, ...],
    rot_local: torch.Tensor,   # [..., J, 3, 3] per-joint local rotations
    joints: torch.Tensor,      # [..., J, 3] rest-pose joint positions
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compose the kinematic chain; returns (world_rot [..., J, 3, 3],
    world_t [..., J, 3]) — world_t are the posed joint positions.

    The 3x3 composes are elementwise products and sums, not matrix
    products, so no TF32 setting can reach them.
    """
    parents = tuple(parents)
    batch = torch.broadcast_shapes(rot_local.shape[:-3], joints.shape[:-2])
    rot_local = rot_local.expand(*batch, *rot_local.shape[-3:])
    joints = joints.expand(*batch, *joints.shape[-2:])
    world_rot = torch.empty_like(rot_local)
    world_t = torch.empty_like(joints)
    world_rot[..., 0, :, :] = rot_local[..., 0, :, :]
    world_t[..., 0, :] = joints[..., 0, :]
    dev = rot_local.device
    for level in tree_levels(parents):
        # Index tensors made once per level and device: a Python list
        # would be copied to the device, and wait for it, at every call.
        idx = index_tensor(level, dev)
        par = index_tensor(tuple(parents[i] for i in level), dev)
        parent_rot = world_rot[..., par, :, :]                 # [..., k, 3, 3]
        local_t = joints[..., idx, :] - joints[..., par, :]    # [..., k, 3]
        world_rot[..., idx, :, :] = _dot3(
            parent_rot[..., :, :, None], rot_local[..., idx, None, :, :], -2)
        world_t[..., idx, :] = (
            _dot3(parent_rot, local_t[..., None, :], -1)
            + world_t[..., par, :]
        )
    return world_rot, world_t


def _dot3(u: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (of size 3) of ``u * v`` as ``(p0 + p1) + p2``.
    ``unbind``, not three ``select``s: its backward is one ``stack``
    where each ``select``'s would allocate and fill a zero tensor."""
    p0, p1, p2 = (u * v).unbind(dim)
    return (p0 + p1) + p2


def skinning_transforms(
    world_rot: torch.Tensor,  # [..., J, 3, 3]
    world_t: torch.Tensor,    # [..., J, 3]
    joints: torch.Tensor,     # [..., J, 3] rest-pose joints
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse bind: map rest-pose space to posed space per joint —
    rotation unchanged, translation world_t - world_rot @ J_rest."""
    skin_t = world_t - _dot3(world_rot, joints[..., None, :], -1)
    return world_rot, skin_t
