"""The plain SMPL-X forward: the reference the ``smplx_*`` cells are judged by.

Pavlakos, Choutas, Ghorbani, Bolkart, Osman, Tzionas and Black,
"Expressive Body Capture: 3D Hands, Face, and Body from a Single Image"
(CVPR 2019), section 3: MANO's equations with a second shape space,

    v_shaped = T + S beta + E psi          (betas, expression)
    J        = Jreg v_shaped
    R_k      = Rodrigues(theta_k),          k = 0 .. J - 1
    v_posed  = v_shaped + P vec(R_k - I, k = 1 .. J - 1)
    G_k      = G_parent(k) [R_k | J_k - J_parent(k)]
    A_k      = G_k [I | -J_k]
    v_i      = sum_k w_ik A_k [v_posed_i; 1]

written from them in plain torch: Rodrigues in its cos / sin form,
forward kinematics as (rotation, translation) pairs, the skinning as
the weighted sum of the A_k. Betas and expression are separate inputs
against separate ``shapedirs`` and ``exprdirs``. Face landmarks and the
hand pose's PCA are not part of it: the pose is full axis-angle in the
``smplx`` package's ``full_pose`` order, and the output is the vertices.

A ``model`` is a dict of SMPL-X's own names: ``v_template`` [V, 3],
``shapedirs`` [V, 3, n_betas], ``exprdirs`` [V, 3, n_expression],
``posedirs`` [V, 3, 9 (J - 1)], ``J_regressor`` [J, V], ``weights``
[V, J] and ``parents`` (J ints, the root's -1). It imports nothing of the
program; in float64 by default, a block of rows at a time so that it fits
beside a run's state. ``precision="tf32"`` computes it in float32 with
TF32 matrix products: the control, the nearest precision below the
configurations' IEEE fp32. Every other precision runs with TF32 off.
"""

from __future__ import annotations

import torch

from benchmark.reference.mano import matmul_precision

#: Below this angle (radians) the rotation is I + skew(r): the next term
#: of the series is under float64's rounding of 1.
_SMALL_ANGLE = 1e-8


def _skew(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3]."""
    a, b, c = x.unbind(-1)
    zero = torch.zeros_like(a)
    return torch.stack([zero, -c, b, c, zero, -a, -b, a, zero],
                       dim=-1).unflatten(-1, (3, 3))


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotations [..., 3, 3]:
    R = cos(t) I + (1 - cos(t)) u u^T + sin(t) [u]x for the unit axis u."""
    theta = aa.norm(dim=-1, keepdim=True)
    small = theta < _SMALL_ANGLE
    u = aa / torch.where(small, torch.ones_like(theta), theta)
    cos, sin = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    rot = (cos * eye + (1 - cos) * (u[..., :, None] * u[..., None, :])
           + sin * _skew(u))
    return torch.where(small[..., None], eye + _skew(aa), rot)


def forward(model: dict, pose: torch.Tensor, betas: torch.Tensor,
            expression: torch.Tensor,
            precision: str = "float64") -> torch.Tensor:
    """Vertices [B, V, 3] of ``pose`` [B, J, 3], ``betas`` [B, n_betas]
    and ``expression`` [B, n_expression] in ``precision`` ("float64",
    "ieee" float32, or "tf32")."""
    dt = torch.float64 if precision == "float64" else torch.float32
    with matmul_precision(precision):
        return _forward(model, pose.to(dt), betas.to(dt),
                        expression.to(dt), dt)


def _forward(model, pose, betas, expression, dt):
    m = {k: v.to(dt) for k, v in model.items() if torch.is_tensor(v)}
    parents = model["parents"]
    b, n_joints = pose.shape[0], pose.shape[1]

    # Shape and expression blendshapes, then the joints.
    v_shaped = (m["v_template"]
                + torch.einsum("bl,vcl->bvc", betas, m["shapedirs"])
                + torch.einsum("bl,vcl->bvc", expression, m["exprdirs"]))
    joints = torch.einsum("jv,bvc->bjc", m["J_regressor"], v_shaped)

    # Pose correctives from (R_k - I), k >= 1, flattened row-major.
    rot = rodrigues(pose)                                    # [B, J, 3, 3]
    eye = torch.eye(3, dtype=dt, device=pose.device)
    feature = (rot[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + torch.einsum("bp,vcp->bvc", feature,
                                      m["posedirs"])

    # G_k as (rotation, translation), root first (parents[k] < k).
    g_rot, g_t = [rot[:, 0]], [joints[:, 0]]
    for k in range(1, n_joints):
        p = parents[k]
        bone = joints[:, k] - joints[:, p]
        g_rot.append(g_rot[p] @ rot[:, k])
        g_t.append(g_t[p] + (g_rot[p] @ bone[..., None])[..., 0])
    g_rot, g_t = torch.stack(g_rot, dim=1), torch.stack(g_t, dim=1)

    # A_k = G_k [I | -J_k]; v_i = sum_k w_ik A_k [v_posed_i; 1].
    a_t = g_t - (g_rot @ joints[..., None])[..., 0]
    blend_rot = torch.einsum("vk,bkrc->bvrc", m["weights"], g_rot)
    blend_t = torch.einsum("vk,bkr->bvr", m["weights"], a_t)
    return (blend_rot @ v_posed[..., None])[..., 0] + blend_t


def forward_blocks(model: dict, pose: torch.Tensor, betas: torch.Tensor,
                   expression: torch.Tensor, precision: str = "float64",
                   block: int = 4096):
    """Yield ``(lo, hi, verts[lo:hi])`` over the rows, ``block`` at a
    time, so the reference fits beside a run's state."""
    for lo in range(0, pose.shape[0], block):
        hi = min(lo + block, pose.shape[0])
        yield lo, hi, forward(model, pose[lo:hi], betas[lo:hi],
                              expression[lo:hi], precision)
