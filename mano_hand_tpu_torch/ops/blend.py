"""Blendshape application and joint regression (fp32 contractions).

Each function broadcasts over leading batch dimensions of its per-sample
input (``beta``, ``v_shaped``, ``rot_mats``); the asset tensors are
shared. The contractions run in IEEE fp32 whatever the caller's TF32
setting (``ops/common.py:einsum``).
"""

from __future__ import annotations

import torch

from mano_hand_tpu_torch.ops.common import (
    check_compute_dtype, einsum, round_bf16,
)


def shape_blend(
    v_template: torch.Tensor,   # [V, 3]
    shape_basis: torch.Tensor,  # [V, 3, S]
    beta: torch.Tensor,         # [..., S]
) -> torch.Tensor:
    """Template + shape blendshape offsets: [..., V, 3]."""
    return v_template + einsum("vcs,...s->...vc", shape_basis, beta)


def pose_blend(
    v_shaped: torch.Tensor,    # [..., V, 3]
    pose_basis: torch.Tensor,  # [V, 3, P]
    rot_mats: torch.Tensor,    # [..., J, 3, 3] incl. root
    compute_dtype=None,
) -> torch.Tensor:
    """Pose-corrective offsets driven by (R - I) of the articulated
    joints; the root/global rotation is excluded.

    ``compute_dtype=torch.bfloat16`` (the bf16 serving tier): the
    contraction's operands are rounded to bf16 and accumulated in f32;
    the residual add stays in ``v_shaped``'s dtype."""
    check_compute_dtype(compute_dtype)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feat = (rot_mats[..., 1:, :, :] - eye).flatten(-3)   # [..., P]
    if compute_dtype is not None:
        pose_basis, pose_feat = round_bf16(pose_basis), round_bf16(pose_feat)
    return v_shaped + einsum("vcp,...p->...vc", pose_basis, pose_feat)


def regress_joints(
    j_regressor: torch.Tensor,  # [J, V]
    v_shaped: torch.Tensor,     # [..., V, 3]
) -> torch.Tensor:
    """Joint locations as convex combinations of vertices: [..., J, 3]."""
    return einsum("jv,...vc->...jc", j_regressor, v_shaped)
