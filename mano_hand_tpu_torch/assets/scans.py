"""Scan-pose extraction from official MANO pickles, and left/right
mirroring of poses and vertices.

A port copy of the JAX package's ``assets/scans.py``. The reference's
``dump_scans`` decodes the per-scan PCA coefficients shipped inside the
official pickles (``hands_coeffs @ hands_components + hands_mean``),
mirrors the right-hand poses into the left-hand frame by negating the y
and z axis-angle components, concatenates them and saves the bank as
``axangles.npy`` for the animation path. Vertices mirror across the
x = 0 plane. The mirrors accept a NumPy array or a tensor and return the
same kind; the scan bank is float64 NumPy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from mano_hand_tpu_torch.assets.loader import _dense, _tolerant_load

PathLike = Union[str, Path]

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


def decode_scan_poses(official_pkl: PathLike) -> np.ndarray:
    """Scan poses [N, 15, 3] stored in one official MANO pickle. Read with
    the loader's tolerant unpickler, so the chumpy wrappers of the other
    keys need no chumpy."""
    with open(official_pkl, "rb") as f:
        raw = _tolerant_load(f, encoding="latin1")
    coeffs = _dense(raw["hands_coeffs"])
    basis = _dense(raw["hands_components"])
    mean = _dense(raw["hands_mean"])
    flat = coeffs @ basis + mean
    return flat.reshape(-1, 15, 3)


def extract_scan_poses(left_pkl: PathLike, right_pkl: PathLike) -> np.ndarray:
    """All scan poses in the left-hand frame: left as-is, right mirrored,
    in ``dump_scans``' order (the left block, then the right block)."""
    left = decode_scan_poses(left_pkl)
    right = mirror_pose(decode_scan_poses(right_pkl))
    return np.concatenate([left, right], axis=0)


def save_scan_poses(left_pkl: PathLike, right_pkl: PathLike,
                    out_path: PathLike = "axangles.npy") -> Path:
    """``dump_scans`` parity: write the pooled pose bank as .npy."""
    out_path = Path(out_path)
    np.save(out_path, extract_scan_poses(left_pkl, right_pkl))
    return out_path
