"""Derive the opposite-side MANO asset by mirroring across the x = 0 plane.

The official release ships left and right as two separate files; given
one side, ``mirror_params`` makes a geometrically consistent other side
(the JAX package's ``assets/mirror.py``).

Math (reflection M = diag(-1, 1, 1), M = M^-1):

- points mirror as ``x' = M x`` (template, shape blendshapes' offsets);
- rotations conjugate: ``R' = M R M``, which on axis-angle is the
  ``[1, -1, -1]`` component flip (axes are pseudo-vectors), and on the
  pose-corrective coefficients ``(R - I)_ab`` a sign ``s_a s_b`` per
  matrix entry — so the pose basis re-signs as
  ``basis'[v, c, (j, a, b)] = s_c s_a s_b basis[v, c, (j, a, b)]``;
- the PCA statistics live in flat axis-angle space: mean and component
  rows multiply by the tiled ``[1, -1, -1]``;
- the triangle winding reverses so outward orientation survives the
  reflection; regressor and skinning weights are per-vertex scalars and
  carry over unchanged.

The defining invariant (exact up to float rounding, pinned in float64):
``forward(mirror_params(p), mirror_pose(pose), shape).verts ==
M @ forward(p, pose, shape).verts``. Every flip is a sign, so the result
is exact in any dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from mano_hand_tpu_torch import constants as C
from mano_hand_tpu_torch.assets.scans import MIRROR_AA, mirror_verts
from mano_hand_tpu_torch.assets.schema import ManoParams, validate

_OTHER_SIDE = {C.LEFT: C.RIGHT, C.RIGHT: C.LEFT, C.NEUTRAL: C.NEUTRAL}


def mirror_params(params: ManoParams) -> ManoParams:
    """The opposite-side asset (see the module docstring for the math)."""
    def signs(values):
        return torch.as_tensor(values, dtype=params.dtype,
                               device=params.device)

    s = signs(-MIRROR_AA)                        # x = 0 reflection [-1, 1, 1]
    p = params.pose_basis.shape[-1]              # (J - 1) * 9
    ab = torch.outer(s, s).reshape(9)            # s_a s_b, row-major (a, b)
    aa_sign = signs(MIRROR_AA).repeat(params.pca_mean.shape[-1] // 3)
    return validate(dataclasses.replace(
        params,
        v_template=mirror_verts(params.v_template),
        shape_basis=params.shape_basis * s[None, :, None],
        pose_basis=(params.pose_basis * s[None, :, None]
                    * ab.repeat(p // 9)[None, None, :]),
        pca_basis=params.pca_basis * aa_sign[None, :],
        pca_mean=params.pca_mean * aa_sign,
        faces=params.faces.flip(-1),
        side=_OTHER_SIDE[params.side],
    ))
