"""Autodiff-safe Rodrigues rotations (axis-angle -> SO(3)).

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
