"""Analytic residual Jacobian for the LM solver.

The port of the JAX package's ``fitting/jacobian.py``. With pose and
shape as the unknowns, the skinned vertices are

    verts_v = M_v @ v_posed_v + sum_j w_vj b_j,   M_v = sum_j w_vj A_j

where (A_j, b_j) are the 16 skinning transforms (a function of theta with
no vertex axis) and v_posed is linear in theta's effects (the shape basis
columns; the pose-corrective basis columns through R). So only the small
joint chain is differentiated by forward-mode AD (``torch.func.jacfwd``,
vmapped over problems), and the [B, V, 3, P] vertex Jacobian is three
bounded contractions. It is exact, held against ``torch.func.jacfwd`` of
the full residual in the tests.

Problems lead every tensor here ([B, ...]); the AD transforms act on one
problem at a time under ``torch.func.vmap``. ``unravel(flat, const)``
maps a flat parameter vector [..., P] (and ``const``, a per-problem
constant such as frozen betas, or None) to ``{"pose": [..., J, 3],
"shape": [..., S]}``, for one problem and for a batch alike. Run it under
``torch.no_grad()``: the port's ``einsum`` is an autograd Function under
grad mode, which ``torch.func`` transforms cannot enter.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import einsum


# Forward-mode AD levels are process-wide in PyTorch, not per thread: two
# threads inside jacfwd at once (concurrent stream sessions' fits) exit
# each other's level. One jacfwd at a time.
_JACFWD_LOCK = threading.Lock()


class ForwardJacobian(NamedTuple):
    """Forward values + exact Jacobians wrt the flat (pose, shape) vector."""

    verts: torch.Tensor         # [B, V, 3]
    posed_joints: torch.Tensor  # [B, J, 3]
    verts_jac: torch.Tensor     # [B, V, 3, P]
    joints_jac: torch.Tensor    # [B, J, 3, P]
    shape_jac: torch.Tensor     # [B, S, P] selector rows (Tikhonov block)


def _small_chain(params, unravel):
    """The joint-dimension-only forward: the part worth differentiating
    (no vertex axis anywhere); one problem or a batch."""
    _, joint_template, joint_shape_basis = core.fused_blend_bases(params)

    def small(flat, const):
        th = unravel(flat, const)
        rot = ops.rotation_matrix(th["pose"])
        jnt = joint_template + einsum("jcs,...s->...jc", joint_shape_basis,
                                      th["shape"])
        world_rot, world_t = ops.forward_kinematics(params.parents, rot, jnt)
        skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, jnt)
        return skin_rot, skin_t, world_t, rot, th["shape"]

    return small


def _values(params, skin_rot, skin_t, v_posed):
    """Skinned vertices and the per-vertex blended rotation M: the value
    expression ``forward_values`` and ``forward_with_jacobian`` share, so
    both estimators give the same bits (the LM accept test compares
    losses across them)."""
    w = params.lbs_weights
    m_per_vertex = einsum("vj,...jab->...vab", w, skin_rot)
    verts = ((m_per_vertex * v_posed[..., None, :]).sum(dim=-1)
             + einsum("vj,...ja->...va", w, skin_t))
    return m_per_vertex, verts


def _v_posed(params, rot, shape):
    v_shaped = ops.shape_blend(params.v_template, params.shape_basis, shape)
    return ops.pose_blend(v_shaped, params.pose_basis, rot)


def forward_values(params, unravel, flat: torch.Tensor, const=None):
    """(verts [B, V, 3], posed_joints [B, J, 3]) by exactly the numeric
    path of ``forward_with_jacobian``, for scoring candidates without
    paying for the Jacobian."""
    skin_rot, skin_t, world_t, rot, shape = _small_chain(params, unravel)(
        flat, const)
    v_posed = _v_posed(params, rot, shape)
    _, verts = _values(params, skin_rot, skin_t, v_posed)
    return verts, world_t


def forward_with_jacobian(params, unravel, flat: torch.Tensor, const=None,
                          shape_frozen: bool = False) -> ForwardJacobian:
    """One forward pass + its full analytic Jacobian, flat [B, P].

    ``unravel`` defines the column layout (the solver's own). With
    ``shape_frozen`` ``unravel`` injects beta as a constant (``const``),
    so the shape-basis term of the vertex Jacobian, a contraction of
    exact zeros, is skipped.
    """
    n_b, n_params = flat.shape
    small = _small_chain(params, unravel)
    # The values come from the batched chain, as in forward_values (the
    # same bits); jacfwd gives only the derivatives.
    skin_rot, skin_t, world_t, rot, shape = small(flat, const)
    with _JACFWD_LOCK:
        d_skin_rot, d_skin_t, d_world_t, d_rot, d_shape = torch.func.vmap(
            torch.func.jacfwd(small),
            in_dims=(0, None if const is None else 0))(flat, const)

    # v_posed is linear in beta (shape basis) and in vec(R[1:]) (the
    # pose-corrective basis); d_rot carries rot's dependence on theta.
    v_posed = _v_posed(params, rot, shape)
    n_pose_basis = params.pose_basis.shape[-1]
    d_vec_rot = d_rot[:, 1:].reshape(n_b, n_pose_basis, n_params)
    dv = einsum("vcf,bfp->bvcp", params.pose_basis, d_vec_rot)
    if not shape_frozen:
        dv = dv + einsum("vcs,bsp->bvcp", params.shape_basis, d_shape)

    # verts_v = (sum_j w_vj A_j) v_v + sum_j w_vj b_j: the product rule
    # over the three theta-dependent factors, intermediates [B, V, 3, P].
    w = params.lbs_weights
    m_per_vertex, verts = _values(params, skin_rot, skin_t, v_posed)
    # The dA term contracts (j, b) together: the per-vertex outer product
    # O[v, (j, b)] = w[v, j] v[v, b] makes it one [V, 3J] x [3J, 3P]
    # product per problem, with no [V, 3, 3, P] intermediate.
    n_joints = w.shape[1]
    outer = (w[:, :, None] * v_posed[:, :, None, :]).reshape(
        n_b, -1, n_joints * 3)
    da_flat = d_skin_rot.permute(0, 1, 3, 2, 4).reshape(
        n_b, n_joints * 3, 3 * n_params)
    # M @ dv, a [3, 3] x [3, P] product per vertex, unrolled over K = 3.
    m_dot_dv = sum(m_per_vertex[..., :, b, None] * dv[..., b, None, :]
                   for b in range(3))
    verts_jac = (
        m_dot_dv
        + einsum("bvk,bkq->bvq", outer, da_flat).reshape(
            n_b, -1, 3, n_params)
        + einsum("vj,bjap->bvap", w, d_skin_t)
    )
    return ForwardJacobian(verts=verts, posed_joints=world_t,
                           verts_jac=verts_jac, joints_jac=d_world_t,
                           shape_jac=d_shape)


def keypoint_jacobian(fj: ForwardJacobian, tips, keypoint_order: str):
    """(keypoints [B, K, 3], jac [B, K, 3, P]) under the selection and
    ordering of ``core.keypoints``: tip rows are vertex rows of the mesh
    Jacobian, picked by the same helper."""
    kp = core.select_keypoints(fj.verts, fj.posed_joints, tips,
                               keypoint_order)
    jac = core.select_keypoints(fj.verts_jac, fj.joints_jac, tips,
                                keypoint_order, axis=-3)
    return kp, jac
