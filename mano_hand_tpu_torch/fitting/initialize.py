"""Closed-form fit initialisation: the global pose from keypoints.

The port of the JAX package's ``fitting/initialize.py``. The optimal
rigid alignment of the rest skeleton to observed 3D keypoints (Kabsch,
one 3 x 3 SVD) drops into ``fit``/``fit_lm``'s warm-start ``init`` dict,
so a target rotated far from the rest orientation starts in the right
basin. The model rotates about the root joint, so the recovered
translation compensates the pivot: ``T = tau + R j0 - j0`` for the Kabsch
frame ``target ~= R x + tau``.

The SVD's signs are free (a CUDA ``svd`` may return other signs for U
and V than the CPU); the determinant correction makes the rotation
independent of them wherever the singular values are distinct.
"""

from __future__ import annotations

from typing import Optional

import torch

from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.fitting.solvers import _as_target
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import einsum


def rigid_align(src, dst):
    """Kabsch: the rotation/translation minimising ||R src + t - dst||^2.

    ``src``/``dst`` are [..., K, 3] paired points (K >= 3, not all
    collinear). Returns ``(rot [..., 3, 3], t [..., 3])`` in ``src``'s
    dtype, proper rotations only (a reflection is folded out by flipping
    the smallest singular direction). The 3 x 3 algebra runs in float64:
    it costs nothing, and an f32 cross-covariance of a whole mesh loses
    digits the rotation then shows.
    """
    src = torch.as_tensor(src)
    rot, t = _rigid_align64(src, dst)
    return rot.to(src.dtype), t.to(src.dtype)


def _rigid_align64(src, dst):
    src = torch.as_tensor(src).double()
    dst = torch.as_tensor(dst).to(src)
    c_src = src.mean(dim=-2, keepdim=True)
    c_dst = dst.mean(dim=-2, keepdim=True)
    h = einsum("...ka,...kb->...ab", src - c_src, dst - c_dst)
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(einsum("...ba,...cb->...ac", vt, u))
    ones = torch.ones_like(det)
    flip = torch.stack([ones, ones, det], dim=-1)
    rot = einsum("...ba,...b,...cb->...ac", vt, flip, u)
    t = c_dst[..., 0, :] - einsum("...ab,...b->...a", rot, c_src[..., 0, :])
    return rot, t


def initialize_from_joints(
    params,
    target_keypoints,                 # [..., K, 3]; K = 16 or 16 + tips
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    shape: Optional[torch.Tensor] = None,   # [..., S] if already estimated
) -> dict:
    """Closed-form ``init`` dict for ``fit``/``fit_lm`` from 3D keypoints:
    the rest skeleton (plus fingertip vertices when ``tip_vertex_ids`` is
    given) rigidly aligned to the target, as ``{"pose": [..., 16, 3]
    zeros with the global row set, "trans": [..., 3]}``. Articulation
    stays at rest (the solver's job). Batched targets broadcast."""
    target_keypoints = _as_target(params, target_keypoints)
    rest = _rest_forward(params, shape)
    rest_kp = (core.keypoints(rest, tip_vertex_ids, keypoint_order)
               if tip_vertex_ids is not None else rest.posed_joints)
    if target_keypoints.shape[-2] != rest_kp.shape[-2]:
        raise ValueError(
            f"target has {target_keypoints.shape[-2]} keypoints but the "
            f"spec yields {rest_kp.shape[-2]} (16 joints"
            + (" + tips" if tip_vertex_ids is not None else
               "; pass tip_vertex_ids for 21-keypoint targets") + ")")
    return _init_from_pairs(params, rest, rest_kp, target_keypoints)


def initialize_from_verts(
    params,
    target_verts,                    # [..., V, 3] full-mesh targets
    shape: Optional[torch.Tensor] = None,
) -> dict:
    """The same closed form from dense correspondence: rest-pose vertices
    against a full [V, 3] target mesh."""
    target_verts = _as_target(params, target_verts)
    rest = _rest_forward(params, shape)
    if target_verts.shape[-2] != rest.verts.shape[-2]:
        raise ValueError(
            f"target has {target_verts.shape[-2]} rows but the mesh has "
            f"{rest.verts.shape[-2]} vertices (for unstructured clouds "
            "use the ICP terms; Kabsch needs correspondences)")
    return _init_from_pairs(params, rest, rest.verts, target_verts)


def _rest_forward(params, shape):
    """Rest-pose forward for the seeds: shape [S], per-problem [B, S], or
    a named error."""
    if shape is None:
        shape = torch.zeros((params.n_shape,), dtype=params.dtype,
                            device=params.device)
    shape = _as_target(params, shape)
    if shape.dim() not in (1, 2):
        raise ValueError(
            f"shape must be [S] or [B, S], got {tuple(shape.shape)}")
    rest_rot = torch.eye(3, dtype=params.dtype, device=params.device).expand(
        *shape.shape[:-1], params.n_joints, 3, 3)
    with torch.no_grad():
        return core.forward_rotmats(params, rest_rot, shape)


def _init_from_pairs(params, rest, rest_points, target) -> dict:
    """Kabsch on paired points -> the solver init dict (shared tail, in
    float64 until the result)."""
    rot, tau = _rigid_align64(rest_points.expand(target.shape), target)
    global_aa = ops.axis_angle_from_matrix(rot)
    # The FK pivots the root rotation at the rest root joint j0.
    j0 = rest.joints[..., 0, :].double()
    trans = tau + einsum("...ab,...b->...a", rot, j0.expand(tau.shape)) - j0
    pose = torch.zeros((*target.shape[:-2], params.n_joints, 3),
                       dtype=target.dtype, device=target.device)
    pose[..., 0, :] = global_aa
    return {"pose": pose, "trans": trans.to(target.dtype)}
