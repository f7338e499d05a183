"""Left/right mirroring of poses and vertices.

The subset of the JAX package's ``assets/scans.py`` that mirroring needs:
an axis-angle pose mirrors between the hands by negating its y and z
components (the reference's scan extractor flips right-hand poses into the
left-hand frame this way), and vertices mirror across the x = 0 plane.
Both accept a NumPy array or a tensor and return the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

# Axis-angle mirror between left/right hands: negate the y and z components
# of every rotation vector.
MIRROR_AA = np.array([1.0, -1.0, -1.0])
# The x = 0 reflection of points: negate x.
MIRROR_X = np.array([-1.0, 1.0, 1.0])


def _scale(x, signs: np.ndarray):
    if torch.is_tensor(x):
        return x * torch.as_tensor(signs, dtype=x.dtype, device=x.device)
    return np.asarray(x) * signs


def mirror_pose(pose):
    """Mirror axis-angle pose(s) [..., 3] between left and right hands."""
    return _scale(pose, MIRROR_AA)


def mirror_verts(verts):
    """Mirror vertices [..., 3] across the x = 0 plane (the left/right
    template relation)."""
    return _scale(verts, MIRROR_X)
