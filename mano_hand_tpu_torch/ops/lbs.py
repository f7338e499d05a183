"""Fused linear blend skinning.

Blends (rotation, translation) pairs per vertex and contracts straight to
vertices, never materializing per-vertex 4x4 transforms:

    verts[v] = (sum_j w[v,j] R_j) @ v_posed[v] + sum_j w[v,j] t_j
"""

from __future__ import annotations

import torch

from mano_hand_tpu_torch.ops.common import (
    check_compute_dtype, einsum, round_bf16,
)


def skin(
    weights: torch.Tensor,    # [V, J] LBS weights
    world_rot: torch.Tensor,  # [..., J, 3, 3] skinning rotations
    skin_t: torch.Tensor,     # [..., J, 3] skinning translations
    v_posed: torch.Tensor,    # [..., V, 3] blendshaped rest-pose verts
    compute_dtype=None,
) -> torch.Tensor:
    """Pose the mesh: [..., V, 3] skinned vertices.

    ``compute_dtype=torch.bfloat16`` (the bf16 serving tier): the two
    weight contractions take bf16-rounded operands (the weights and the
    12 transform entries) and accumulate in f32; the per-vertex 3x3
    apply and the translation add stay f32."""
    check_compute_dtype(compute_dtype)
    rot_flat = world_rot.flatten(-2)                             # [..., J, 9]
    if compute_dtype is not None:
        weights, rot_flat = round_bf16(weights), round_bf16(rot_flat)
        skin_t, v_posed = round_bf16(skin_t), v_posed.to(torch.float32)
    blend_rot = einsum("vj,...jr->...vr", weights, rot_flat)
    blend_rot = blend_rot.unflatten(-1, (3, 3))                  # [..., V, 3, 3]
    blend_t = einsum("vj,...jc->...vc", weights, skin_t)
    return (blend_rot * v_posed[..., None, :]).sum(dim=-1) + blend_t
