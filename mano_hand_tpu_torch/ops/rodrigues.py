"""Autodiff-safe Rodrigues rotations (axis-angle -> SO(3)), and the other
rotation forms: the 6D representation, the SO(3) log map and quaternions.

Uses the unnormalized form

    R = I + a(theta) * K + b(theta) * K @ K,   K = skew(r)

with a = sin(theta)/theta and b = (1 - cos(theta))/theta^2 computed
through Taylor guards below theta^2 = 1e-8, so R and its derivatives are
finite at theta = 0. Since K @ K = r r^T - |r|^2 I, the matrix is built
as (1 - b theta^2) I + a K + b r r^T, elementwise (no matrix product).

Each entry is one fixed sequence of separately rounded IEEE fp32
operations (adding the zero entries of I and K is exact), and theta^2 is
summed as (x^2 + y^2) + z^2. K2's bf16 variant (``csrc/mano_common.cuh``:
``rodrigues`` with ``kExact``) performs the same operations without fused
multiply-adds, so both give the same bits: that tier rounds (R - I) to
bf16, and equal bits before the rounding round alike. (The fp32 kernels
fuse multiply-adds and agree to fp32 rounding.)
"""

from __future__ import annotations

import math

import torch

# Below this theta^2, the Taylor series is more accurate than the closed
# form in f32 *and* keeps gradients finite.
_SMALL = 1e-8


def skew(r: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product (skew-symmetric) matrices."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], dim=-1
    ).reshape(*r.shape[:-1], 3, 3)


def rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    xx, yy, zz = (axis_angle * axis_angle).unbind(-1)
    theta2 = ((xx + yy) + zz)[..., None, None]
    small = theta2 < _SMALL
    # Guard the sqrt so its gradient never sees 0 (the double-where rule:
    # the unselected branch must stay finite too).
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(theta)) / (theta * theta))
    k = skew(axis_angle)
    outer = axis_angle[..., :, None] * axis_angle[..., None, :]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return (1.0 - b * theta2) * eye + a * k + b * outer


def matrix_from_6d(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """6D rotation representation [..., 6] -> rotation matrices [..., 3, 3].

    The continuous representation of Zhou et al., "On the Continuity of
    Rotation Representations in Neural Networks" (CVPR 2019): the first
    two columns of a rotation matrix, re-orthonormalised by Gram-Schmidt,
    the third their cross product. Continuous and surjective onto SO(3).

    CONVENTION: the 6 numbers are the first two COLUMNS of R (the paper's
    formulation). pytorch3d's ``rotation_6d_to_matrix`` uses the first two
    ROWS instead: a pytorch3d-trained regressor's 6D output decodes here
    to R^T (the inverse rotation).
    """
    a1, a2 = x[..., 0:3], x[..., 3:6]
    n1 = torch.sqrt((a1 * a1).sum(-1, keepdim=True) + eps)
    b1 = a1 / n1
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    n2 = torch.sqrt((a2p * a2p).sum(-1, keepdim=True) + eps)
    b2 = a2p / n2
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)  # columns


def matrix_to_6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> 6D representation [..., 6]: the
    first two COLUMNS, flattened (the inverse of ``matrix_from_6d`` on
    SO(3))."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


def axis_angle_from_matrix(rot: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: rotation matrices [..., 3, 3] -> axis-angle [..., 3].

    Inverse of ``rotation_matrix`` up to the usual angle wrap: the output
    angle lies in [0, pi]. Three guarded regimes, each evaluated
    everywhere and selected with ``torch.where`` (the unselected branches
    stay finite), in the JAX package's branch structure:

      * small angle (theta < 1e-3): vec / 2 with a Taylor correction
        (vec = 2 sin(theta) axis);
      * generic: theta * vec / (2 sin(theta));
      * near pi (theta > pi - 1e-3): sin(theta) -> 0 kills vec, so the
        axis comes from the symmetric part, (R + I) / 2 == axis axis^T at
        pi: magnitudes from the diagonal, the row of the largest diagonal
        entry for the direction, and the sign of vec where it still
        carries one (below pi), so the chart stays continuous up to pi.

    Like every log map it is not differentiable AT theta == pi.
    """
    vec = torch.stack([
        rot[..., 2, 1] - rot[..., 1, 2],
        rot[..., 0, 2] - rot[..., 2, 0],
        rot[..., 1, 0] - rot[..., 0, 1],
    ], dim=-1)                                   # 2 sin(theta) * axis
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)[..., None]
    theta = torch.arccos(cos_t)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))

    small = theta < 1e-3
    near_pi = theta > math.pi - 1e-3
    generic = ~(small | near_pi)
    # Guarded denominator: dead branches must stay finite (double-where).
    safe_sin = torch.where(generic, sin_t, torch.ones_like(sin_t))
    aa_generic = vec * (theta / (2.0 * safe_sin))
    t2 = theta * theta
    aa_small = vec * 0.5 * (1.0 + t2 / 6.0 + 7.0 * t2 * t2 / 360.0)

    # Near pi: (R + I) / 2 ~= axis axis^T. Magnitudes from the diagonal;
    # direction from the row of the largest diagonal entry.
    sym = 0.5 * (rot + rot.transpose(-1, -2))
    m = 0.5 * (sym + torch.eye(3, dtype=rot.dtype, device=rot.device))
    diag = torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1), 0.0, 1.0)
    k = torch.argmax(diag, dim=-1, keepdim=True)            # [..., 1]
    row = torch.gather(
        m, -2, k[..., None].expand(*k.shape[:-1], 1, 3))[..., 0, :]
    axis_pi = row / torch.sqrt(
        torch.clamp(torch.gather(diag, -1, k), 1e-12, 1.0))
    norm = torch.sqrt(torch.clamp(
        (axis_pi * axis_pi).sum(-1, keepdim=True), min=1e-12))
    # Below pi, vec = 2 sin(theta) axis still carries the true sign: align
    # with it. Only AT pi (vec == 0) is the global sign free.
    align = (axis_pi * vec).sum(-1, keepdim=True)
    sign = torch.where(align.abs() > 1e-12, torch.sign(align),
                       torch.ones_like(align))
    aa_pi = axis_pi * sign / norm * theta

    return torch.where(small, aa_small,
                       torch.where(near_pi, aa_pi, aa_generic))


def matrix_from_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Quaternions [..., 4] (scalar first: w, x, y, z) -> [..., 3, 3].

    Inputs are normalised first, so any nonzero 4-vector maps onto SO(3);
    q and -q give the same rotation (double cover).
    """
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + eps)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)
