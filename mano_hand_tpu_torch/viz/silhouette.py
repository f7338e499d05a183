"""Differentiable soft rasterisers: the soft silhouette and soft depth.

The port of the JAX package's ``viz/silhouette.py`` (SoftRas-style
aggregation, Liu et al., ICCV 2019). Every face contributes a per-pixel
occupancy

    occ_f(p) = sigmoid(d_signed(p, f) / sigma)

where ``d_signed`` is the screen-space distance in pixels from the pixel
centre to the projected triangle's boundary, positive inside, so
gradients reach uncovered target pixels from several ``sigma`` away.
Faces combine by the probabilistic union ``1 - prod_f (1 - occ_f)``,
evaluated as ``1 - exp(sum log1p(-occ))``. The soft depth weighs the
covering faces' interpolated z by a coverage-weighted softmin.

The [pixels, faces] slabs are chunked by pixel rows as in the hard
rasteriser. A batch of meshes renders either as one batched slab per row
chunk (``batch_mode="vmap"``, JAX's vmap written out) or one image at a
time (``"map"``); ``"auto"`` batches on a GPU while the slab stays under
``_VMAP_SLAB_BYTES`` and maps otherwise, and on the CPU always maps.

Where JAX clips (``jnp.clip``, i.e. ``minimum(maximum(x, lo), hi)``) or
takes ``jnp.maximum``/``jnp.minimum`` against a constant, the port takes
``torch.maximum``/``torch.minimum`` too: both split the gradient evenly
at a tie, where ``torch.clamp`` passes all of it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mano_hand_tpu_torch.viz.camera import Camera, default_hand_camera
from mano_hand_tpu_torch.viz.render import (
    best_chunk_rows, chunked_pixel_grid, ndc_to_pixels,
)

# Occupancies are clamped below 1 so log1p(-occ) and its gradient stay
# finite when the sigmoid saturates deep inside the mesh.
_OCC_MAX = 1.0 - 1e-6

# The auto batch policy's budget for one [B, chunk_pixels, F] distance
# slab (about 6 live temporaries inside the chunk body): batch the whole
# set when it fits, render one image at a time beyond.
_VMAP_SLAB_BYTES = 64 * 1024 * 1024


def _cmax(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: the tie splits the gradient. ``c`` rides as
    a host scalar (no device copy)."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype))


def _cmin(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.minimum(x, c)``, as ``_cmax``."""
    return torch.minimum(x, torch.tensor(c, dtype=x.dtype))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with JAX's gradient at the bounds."""
    return _cmin(_cmax(x, 0.0), 1.0)


def _point_segment_sq(px, py, ax, ay, bx, by):
    """Squared distance from pixels [P] to segments [..., 1, F] ->
    [..., P, F]."""
    abx, aby = bx - ax, by - ay                          # [..., 1, F]
    apx = px[:, None] - ax                               # [..., P, F]
    apy = py[:, None] - ay
    denom = _cmax(abx * abx + aby * aby, 1e-12)
    t = _clip01((apx * abx + apy * aby) / denom)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _signed_dists(px, py, corners):
    """The shared screen-space geometry of the soft rasterisers.

    px/py: [P] pixel centres; corners: [..., F, 3, 2] screen xy. Returns
    (signed [..., P, F] pixel distance to each triangle's boundary,
    positive inside; barycentrics l0/l1/l2 [..., P, F]).
    """
    ax, ay = corners[..., 0, 0].unsqueeze(-2), corners[..., 0, 1].unsqueeze(-2)
    bx, by = corners[..., 1, 0].unsqueeze(-2), corners[..., 1, 1].unsqueeze(-2)
    cx, cy = corners[..., 2, 0].unsqueeze(-2), corners[..., 2, 1].unsqueeze(-2)
    # The hard rasteriser's barycentric inside test, so the soft
    # silhouette's 0.5 level set matches its hit mask up to the blur.
    d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)    # [..., 1, F]
    safe_d = torch.where(d.abs() < 1e-12, 1.0, d)
    pxc = px[:, None] - cx
    pyc = py[:, None] - cy
    l0 = ((by - cy) * pxc + (cx - bx) * pyc) / safe_d
    l1 = ((cy - ay) * pxc + (ax - cx) * pyc) / safe_d
    l2 = 1.0 - l0 - l1
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (d.abs() > 1e-12)
    # Distance to the boundary = min over the three edges; the +1e-12
    # keeps the sqrt's gradient finite for pixels exactly on an edge.
    e2 = torch.minimum(
        torch.minimum(_point_segment_sq(px, py, ax, ay, bx, by),
                      _point_segment_sq(px, py, bx, by, cx, cy)),
        _point_segment_sq(px, py, cx, cy, ax, ay))
    dist = torch.sqrt(e2 + 1e-12)                        # [..., P, F]
    return torch.where(inside, dist, -dist), l0, l1, l2


def _sil_chunk(px, py, corners, sigma):
    """Soft coverage of a pixel chunk against every face: [..., P]."""
    signed, _, _, _ = _signed_dists(px, py, corners)
    occ = _cmin(torch.sigmoid(signed / sigma), _OCC_MAX)
    return 1.0 - torch.exp(torch.sum(torch.log1p(-occ), dim=-1))


def _depth_chunk(px, py, corners, depths, sigma, gamma, z_background):
    """Soft depth of a pixel chunk: [..., P].

    Coverage (the silhouette's union) decides foreground against
    background; which face, a coverage-weighted softmin over z at
    temperature ``gamma`` in log space with the max subtracted. The
    barycentric z is clamped and renormalised so near-edge pixels read
    the face's edge depth instead of extrapolating.
    """
    signed, l0, l1, l2 = _signed_dists(px, py, corners)
    occ = _cmin(torch.sigmoid(signed / sigma), _OCC_MAX)
    lc0, lc1, lc2 = (_clip01(lk) for lk in (l0, l1, l2))
    norm = _cmax(lc0 + lc1 + lc2, 1e-12)
    z = (lc0 * depths[..., None, :, 0] + lc1 * depths[..., None, :, 1]
         + lc2 * depths[..., None, :, 2]) / norm            # [..., P, F]
    sil = 1.0 - torch.exp(torch.sum(torch.log1p(-occ), dim=-1))
    # log_sigmoid keeps the coverage penalty unbounded (about -d/sigma),
    # so no nearer face far outside can steal the softmin.
    logw = F.logsigmoid(signed / sigma) - z / gamma
    m = torch.amax(logw, dim=-1)                            # [..., P]
    w = torch.exp(logw - m[..., None])
    depth_faces = (w * z).sum(dim=-1) / _cmax(w.sum(dim=-1), 1e-12)
    return sil * depth_faces + (1.0 - sil) * z_background


def _screen(verts, faces, camera, height, width):
    """(corners [..., F, 3, 2] in raster space, view-space depths
    [..., F, 3]) of [..., V, 3] verts."""
    proj = camera.project(verts)
    corners = ndc_to_pixels(proj[..., :2], height, width)[..., faces, :]
    return corners, proj[..., 2][..., faces]


def _rows(chunk, height, width, chunk_rows, dtype, device):
    """Run ``chunk(px, py) -> [..., P]`` over the row chunks of the image
    and assemble [..., H, W]."""
    gx, gy = chunked_pixel_grid(height, width, chunk_rows, dtype, device)
    out = torch.cat([chunk(gx[i], gy[i]) for i in range(gx.shape[0])],
                    dim=-1)
    return out.unflatten(-1, (height, width))


def _render_batched(render, verts, n_faces, width, chunk_rows, height,
                    batch_mode):
    """The batch dispatch shared by the soft renderers: one batched slab
    per row chunk (``"vmap"``) or one image at a time (``"map"``);
    ``"auto"`` batches on a GPU while the [B, chunk_pixels, F] slab fits
    ``_VMAP_SLAB_BYTES`` and maps otherwise (and always on the CPU, where
    JAX measured mapping faster)."""
    if batch_mode not in ("auto", "vmap", "map"):
        raise ValueError(
            f"batch_mode must be 'auto', 'vmap' or 'map', got {batch_mode!r}"
        )
    if verts.dim() == 2:
        return render(verts)
    lead = verts.shape[:-2]
    flat = verts.reshape((-1,) + tuple(verts.shape[-2:]))
    if batch_mode == "auto":
        slab = (flat.shape[0] * chunk_rows * width * n_faces
                * flat.element_size())
        batch_mode = ("vmap" if slab <= _VMAP_SLAB_BYTES
                      and verts.device.type != "cpu" else "map")
    if batch_mode == "vmap":
        out = render(flat)
    else:
        out = torch.stack([render(v) for v in flat])
    return out.reshape(tuple(lead) + (height, width))


def _check_positive(name: str, val, unit: str = "") -> None:
    """Refuse a non-positive render parameter given as a host value (a
    Python number or a CPU tensor). A value on the card passes unread:
    reading it would make the caller wait for the device; the solvers
    check theirs once at their entry."""
    if torch.is_tensor(val) and val.device.type != "cpu":
        return
    if float(val) <= 0:
        raise ValueError(f"{name} must be > 0{unit}, got {val}")


def _faces_on(faces, verts: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(faces).to(device=verts.device, dtype=torch.long)


def _camera_for(camera, verts: torch.Tensor):
    if camera is None:
        return default_hand_camera(device=verts.device)
    return camera


def soft_depth(
    verts: torch.Tensor,             # [V, 3] or [..., V, 3]
    faces,                           # [F, 3] int
    camera: Optional[Camera] = None,
    height: int = 64,
    width: int = 64,
    sigma: float = 0.7,
    gamma: float = 0.005,
    z_background: float = 10.0,
    chunk_rows: int = 8,
    batch_mode: str = "auto",        # "auto" | "vmap" | "map"
) -> torch.Tensor:
    """Soft depth image(s) in view-space meters: [..., H, W].

    The differentiable z-buffer: pixels covered by the mesh read the
    softmin (temperature ``gamma``, meters) of the covering faces'
    interpolated z, the front surface a depth sensor sees; uncovered
    pixels read ``z_background``. One depth image pins full 3D
    translation (``fitting.fit(data_term="depth")``).
    """
    camera = _camera_for(camera, verts)
    for name, val in (("sigma", sigma), ("gamma", gamma)):
        _check_positive(name, val)
    chunk_rows = best_chunk_rows(height, chunk_rows)
    faces = _faces_on(faces, verts)

    def render(v):
        corners, depths = _screen(v, faces, camera, height, width)
        return _rows(
            lambda px, py: _depth_chunk(px, py, corners, depths, sigma,
                                        gamma, z_background),
            height, width, chunk_rows, v.dtype, v.device)

    return _render_batched(render, verts, faces.shape[0], width,
                           chunk_rows, height, batch_mode)


def soft_silhouette(
    verts: torch.Tensor,             # [V, 3] or [..., V, 3]
    faces,                           # [F, 3] int
    camera: Optional[Camera] = None,
    height: int = 64,
    width: int = 64,
    sigma: float = 0.7,
    chunk_rows: int = 8,
    batch_mode: str = "auto",        # "auto" | "vmap" | "map"
) -> torch.Tensor:
    """Soft occupancy image(s) in [0, 1]: [..., H, W].

    ``sigma`` is the edge softness in pixels (occupancy crosses 0.5 at a
    triangle's boundary and saturates about 3 sigma away). Small sigma:
    a crisp mask, short-range gradients; large sigma: gradients reach
    further. Leading batch axes render by ``batch_mode`` (see the module
    docstring).
    """
    camera = _camera_for(camera, verts)
    # sigma 0 divides by zero (NaN occupancy); negative inverts inside
    # and outside, and a fit would optimise the complement.
    _check_positive("sigma", sigma, " pixels")
    chunk_rows = best_chunk_rows(height, chunk_rows)
    faces = _faces_on(faces, verts)

    def render(v):
        corners, _ = _screen(v, faces, camera, height, width)
        return _rows(lambda px, py: _sil_chunk(px, py, corners, sigma),
                     height, width, chunk_rows, v.dtype, v.device)

    return _render_batched(render, verts, faces.shape[0], width,
                           chunk_rows, height, batch_mode)
