"""Pinhole, weak-perspective and calibrated cameras.

The port of the JAX package's ``viz/camera.py``. ``view_rotation`` gives
an axis-angle view matrix through the model's own Rodrigues op;
``look_at`` and ``Camera`` give a pinhole projection; ``IntrinsicsCamera``
speaks a dataset's K matrix in pixel units. ``keypoints2d`` fitting
projects the posed keypoints through any of them (each exposes
``project``).

A camera's tensors follow the verts it projects: ``transform`` casts them
to the verts' dtype and device (a no-op when they already match), and the
solvers move a camera once, up front, with ``to``. The 3 x 3 rotation
runs through ``ops/common.py:einsum``, so a caller's TF32 switch never
reaches it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.ops.common import EPS, einsum, resolve_device
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix


def _rotate(verts: torch.Tensor, rot) -> torch.Tensor:
    """``verts @ rot.T`` in IEEE fp32, rot cast to the verts' dtype and
    device."""
    return einsum("...c,rc->...r", verts, torch.as_tensor(rot).to(verts))


def _moved(cam, device, dtype):
    """``cam`` with its array fields (``rot``, ``trans``, ``trans2d``) as
    tensors on ``device`` in ``dtype``."""
    return cam._replace(**{
        k: torch.as_tensor(v).to(device=device, dtype=dtype)
        for k, v in cam._asdict().items()
        if k in ("rot", "trans", "trans2d") and v is not None})


class Camera(NamedTuple):
    """Pinhole camera: world -> view rotation R, translation t, focal.

    ``project(v) = focal * (R @ v + t).xy / (R @ v + t).z`` in NDC units;
    z after transform must be positive (camera looks down +z).
    """

    rot: torch.Tensor     # [3, 3]
    trans: torch.Tensor   # [3]
    focal: float = 1.0

    def to(self, device=None, dtype=None) -> "Camera":
        return _moved(self, device, dtype)

    def transform(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> view space [..., 3]."""
        return _rotate(verts, self.rot) + torch.as_tensor(self.trans).to(verts)

    def project(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> (x_ndc, y_ndc, depth) [..., 3]."""
        v = self.transform(verts)
        z = torch.clamp(v[..., 2:3], min=EPS)
        xy = self.focal * v[..., :2] / z
        return torch.cat([xy, v[..., 2:3]], dim=-1)


class WeakPerspectiveCamera(NamedTuple):
    """Weak-perspective (scaled-orthographic) camera.

    ``project(v) = scale * (R @ v).xy + trans2d`` — the (s, tx, ty)
    convention of HMR-family regressors and many hand datasets: no depth
    division, so image position is linear in the joints. The third
    output column is view-space depth, as for ``Camera``, and never part
    of the 2D residual.
    """

    rot: torch.Tensor      # [3, 3]
    scale: float = 1.0
    trans2d: Optional[torch.Tensor] = None  # [2]; None = origin

    def to(self, device=None, dtype=None) -> "WeakPerspectiveCamera":
        return _moved(self, device, dtype)

    def transform(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> view space [..., 3] (rotation only)."""
        return _rotate(verts, self.rot)

    def project(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> (x, y, depth) [..., 3]."""
        v = self.transform(verts)
        xy = self.scale * v[..., :2]
        if self.trans2d is not None:
            xy = xy + torch.as_tensor(self.trans2d).to(v)
        return torch.cat([xy, v[..., 2:3]], dim=-1)


class IntrinsicsCamera(NamedTuple):
    """Pinhole camera from a real calibration matrix (pixel units).

    ``project`` returns NDC such that the rasteriser's NDC -> pixel
    mapping at this ``width``/``height`` lands each vertex on the raster
    sample of its intrinsic pixel (u, v) = (fx X/Z + cx, fy Y/Z + cy),
    i.e. raster coordinate u + 0.5, the centre of OpenCV pixel u. Convert
    pixel-space detector keypoints once with ``pixels_to_ndc`` and fit
    as usual (residuals then live in NDC: 2/width pixel units).
    """

    rot: torch.Tensor     # [3, 3] world -> camera
    trans: torch.Tensor   # [3]
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def to(self, device=None, dtype=None) -> "IntrinsicsCamera":
        return _moved(self, device, dtype)

    def transform(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> view space [..., 3]."""
        return _rotate(verts, self.rot) + torch.as_tensor(self.trans).to(verts)

    def project(self, verts: torch.Tensor) -> torch.Tensor:
        """World verts [..., 3] -> (x_ndc, y_ndc, depth) [..., 3]."""
        v = self.transform(verts)
        z = torch.clamp(v[..., 2:3], min=EPS)
        u = self.fx * v[..., 0:1] / z + self.cx
        w = self.fy * v[..., 1:2] / z + self.cy
        # One uv -> NDC mapping serves projection and keypoint conversion.
        xy = self.pixels_to_ndc(torch.cat([u, w], dim=-1))
        return torch.cat([xy, v[..., 2:3]], dim=-1)

    def pixels_to_ndc(self, uv) -> torch.Tensor:
        """OpenCV-convention pixel coords [..., 2] (u right, v down,
        integer values at pixel centres) -> the NDC space ``project``
        emits. The +0.5: the rasteriser samples pixel i at continuous
        coordinate i + 0.5."""
        uv = torch.as_tensor(uv)
        return torch.stack(
            [2.0 * (uv[..., 0] + 0.5) / self.width - 1.0,
             1.0 - 2.0 * (uv[..., 1] + 0.5) / self.height], dim=-1)

    def ndc_to_pixels(self, xy) -> torch.Tensor:
        """Inverse of ``pixels_to_ndc``: OpenCV pixel-centre coordinates
        (integer u at the centre of pixel u, hence the -0.5)."""
        xy = torch.as_tensor(xy)
        return torch.stack(
            [(xy[..., 0] + 1.0) * 0.5 * self.width - 0.5,
             (1.0 - xy[..., 1]) * 0.5 * self.height - 0.5], dim=-1)


def from_intrinsics(
    k_matrix,                      # [3, 3] calibration matrix K
    width: int,
    height: int,
    rot=None,                      # [3, 3] world->camera; default identity
    trans=(0.0, 0.0, 0.5),         # [3]; hands need positive view z
    device=None,
) -> IntrinsicsCamera:
    """Build an ``IntrinsicsCamera`` from a dataset's K matrix (float32
    tensors on ``device``, default ``cuda``)."""
    k = np.asarray(k_matrix, np.float64)
    if k.shape != (3, 3):
        raise ValueError(f"K must be [3, 3], got {k.shape}")
    if k[0, 0] <= 0 or k[1, 1] <= 0:
        raise ValueError(f"fx/fy must be > 0, got {k[0, 0]}, {k[1, 1]}")
    if abs(k[0, 1]) > 1e-6:
        # Dropping the skew term would bias every projected u by
        # skew * Y/Z pixels; refuse the unsupported calibration.
        raise ValueError(
            f"skewed calibrations (K[0,1]={k[0, 1]:g}) are not supported"
        )
    if width <= 0 or height <= 0:
        raise ValueError(
            f"width/height must be > 0, got {width}x{height}"
        )
    dev = resolve_device(device)
    return IntrinsicsCamera(
        rot=torch.as_tensor(np.eye(3) if rot is None else np.asarray(rot),
                            dtype=torch.float32, device=dev),
        trans=torch.as_tensor(np.asarray(trans), dtype=torch.float32,
                              device=dev),
        fx=float(k[0, 0]), fy=float(k[1, 1]),
        cx=float(k[0, 2]), cy=float(k[1, 2]),
        width=int(width), height=int(height),
    )


def view_rotation(axis_angle: Sequence[float], device=None) -> torch.Tensor:
    """Axis-angle view matrix [3, 3] float32 (angle = norm of the
    length-3 vector), through the model's Rodrigues op."""
    aa = torch.as_tensor(np.asarray(axis_angle, np.float32).reshape(1, 3),
                         device=resolve_device(device))
    return rotation_matrix(aa)[0]


def look_at(
    eye: Sequence[float],
    target: Sequence[float] = (0.0, 0.0, 0.0),
    up: Sequence[float] = (0.0, 1.0, 0.0),
    focal: float = 1.2,
    device=None,
) -> Camera:
    """Camera at ``eye`` looking at ``target`` (built in NumPy float64,
    stored float32 on ``device``)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), EPS)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right = right / max(np.linalg.norm(right), EPS)
    cam_up = np.cross(fwd, right)  # right-handed: right x up = fwd
    rot = np.stack([right, cam_up, fwd])        # rows = camera axes, y = up
    trans = -rot @ eye
    dev = resolve_device(device)
    return Camera(
        rot=torch.as_tensor(rot, dtype=torch.float32, device=dev),
        trans=torch.as_tensor(trans, dtype=torch.float32, device=dev),
        focal=float(focal),
    )


def default_hand_camera(scale: float = 0.25, device=None) -> Camera:
    """A framing that keeps a MANO hand (~0.2 m span near the origin) in
    view: straight-on, slightly pulled back along -z."""
    return look_at(eye=(0.0, 0.0, -3.0 * scale), focal=2.2, device=device)
