"""Z-buffer triangle rasteriser with Gouraud shading, in plain PyTorch.

The port of the JAX package's ``viz/render.py``: a brute-force pixel x
face coverage test, chunked by pixel rows so the [pixels, faces]
barycentric slabs stay bounded while every chunk is dense tensor math.
JAX maps the row chunks one at a time (``lax.map``); every pixel's value
depends on its own row of the slab only, so the port groups row chunks,
and the frames of a clip, into passes of up to ``_SLAB_BYTES`` per slab
and gets the same value for every pixel.

Depth is interpolated in screen space (not perspective-correct): exact at
the vertices and ample for mesh inspection at MANO scale. The renderer
runs on the device of the vertices it is given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.ops.common import einsum, resolve_device
from mano_hand_tpu_torch.ops.normals import vertex_normals
from mano_hand_tpu_torch.utils.arrays import as_numpy
from mano_hand_tpu_torch.viz.camera import Camera, default_hand_camera

_BG = (1.0, 1.0, 1.0)
_BASE = (0.82, 0.68, 0.58)  # skin-ish albedo
_FAR = 1e30

# The budget of one [frames, pixels, faces] slab of a rasterising pass
# (about 20 such temporaries are alive inside a pass).
_SLAB_BYTES = 64 * 1024 * 1024


def _shade(verts: torch.Tensor, faces: torch.Tensor,
           light_dir: torch.Tensor) -> torch.Tensor:
    """Per-vertex Lambert intensity in [ambient, 1], [V]."""
    normals = vertex_normals(verts, faces)
    light = light_dir / torch.linalg.norm(light_dir)
    lambert = torch.clamp(-einsum("vc,c->v", normals, light), 0.0, 1.0)
    return 0.35 + 0.65 * lambert


def ndc_to_pixels(proj_xy: torch.Tensor, height: int, width: int):
    """NDC xy [..., 2] -> raster coordinates [..., 2], y flipped so +y in
    the world points up on screen. The one raster-space mapping: the hard
    renderer and the soft renders both use it, so masks fitted through
    ``soft_silhouette`` line up pixel for pixel with ``render_mesh``.

    Not the mapping of ``IntrinsicsCamera.ndc_to_pixels``: raster
    coordinates put pixel u's centre at u + 0.5, the camera method at u
    (OpenCV). Keep renders in this space and annotations in the
    camera's."""
    sx = (proj_xy[..., 0] * 0.5 + 0.5) * width
    sy = (1.0 - (proj_xy[..., 1] * 0.5 + 0.5)) * height
    return torch.stack([sx, sy], dim=-1)


def chunked_pixel_grid(height: int, width: int, chunk_rows: int, dtype,
                       device=None):
    """Pixel-centre coordinates grouped into row chunks: (gx, gy), each
    [height // chunk_rows, chunk_rows * width], on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    ys = torch.arange(height, dtype=dtype, device=dev) + 0.5
    xs = torch.arange(width, dtype=dtype, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return (gx.reshape(height // chunk_rows, chunk_rows * width),
            gy.reshape(height // chunk_rows, chunk_rows * width))


def best_chunk_rows(height: int, chunk_rows: int) -> int:
    """Largest divisor of ``height`` that is <= ``chunk_rows``: odd image
    heights (100- or 180-row masks) keep chunks of several rows."""
    return max(c for c in range(1, chunk_rows + 1) if height % c == 0)


def pass_rows(n_images: int, height: int, width: int, n_faces: int,
              chunk_rows: int, itemsize: int):
    """(images, rows) a rasterising pass covers: whole row chunks of one
    image until the slab budget is met, then whole images at a time."""
    row_bytes = width * n_faces * itemsize
    rows = min(height, max(1, _SLAB_BYTES // row_bytes) // chunk_rows
               * chunk_rows)
    rows = max(rows, chunk_rows)
    if rows < height:
        return 1, rows
    return max(1, min(n_images, _SLAB_BYTES // (height * row_bytes))), height


def _corner(corners: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Corner ``k``'s coordinate ``axis`` of every face as [..., 1, F],
    ready to broadcast against a [..., P, F] slab."""
    return corners[..., k, axis].unsqueeze(-2)


def _gather(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``x`` [..., P, F] at face ``best`` [..., P, 1] -> [..., P]."""
    return torch.gather(x, -1, best).squeeze(-1)


def _raster_chunk(px, py, corners, depths, attrs):
    """Coverage test of a pixel chunk against every face.

    px/py: [P] pixel centres; corners: [..., F, 3, 2] screen xy;
    depths: [..., F, 3]; attrs: [..., F, 3, C] per-corner attributes.
    Returns (interpolated attrs [..., P, C], hit [..., P]).
    """
    ax, ay = _corner(corners, 0, 0), _corner(corners, 0, 1)
    bx, by = _corner(corners, 1, 0), _corner(corners, 1, 1)
    cx, cy = _corner(corners, 2, 0), _corner(corners, 2, 1)
    d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)          # [..., 1, F]
    safe_d = torch.where(d.abs() < 1e-12, 1.0, d)
    pxc = px[:, None] - cx                                      # [..., P, F]
    pyc = py[:, None] - cy
    l0 = ((by - cy) * pxc + (cx - bx) * pyc) / safe_d
    l1 = ((cy - ay) * pxc + (ax - cx) * pyc) / safe_d
    l2 = 1.0 - l0 - l1
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (d.abs() > 1e-12)
    z = (l0 * depths[..., None, :, 0] + l1 * depths[..., None, :, 1]
         + l2 * depths[..., None, :, 2])
    inside = inside & (z > 0)
    z = torch.where(inside, z, _FAR)
    best = torch.argmin(z, dim=-1, keepdim=True)                # first on ties
    hit = _gather(inside, best)
    lam = [_gather(lk, best) for lk in (l0, l1, l2)]            # 3 x [..., P]
    n_ch = attrs.shape[-1]
    # The winning face's corner attributes: [..., P, 3, C].
    flat = attrs.flatten(-2)                                    # [..., F, 3C]
    idx = best.expand(*best.shape[:-1], flat.shape[-1])
    picked = torch.gather(flat, -2, idx).unflatten(-1, (3, n_ch))
    vals = (picked[..., 0, :] * lam[0][..., None]
            + picked[..., 1, :] * lam[1][..., None]
            + picked[..., 2, :] * lam[2][..., None])
    return vals, hit


def _faces_setup(verts, faces, camera, light_dir, height, width,
                 vertex_colors):
    """One mesh's per-face operands: screen corners [F, 3, 2], depths
    [F, 3] and per-corner attributes [F, 3, C]."""
    proj = camera.project(verts)                                # [V, 3]
    screen = ndc_to_pixels(proj[:, :2], height, width)          # [V, 2]
    intens = _shade(verts, faces, light_dir)[faces]             # [F, 3]
    if vertex_colors is None:
        attrs = intens[:, :, None]                              # [F, 3, 1]
    else:
        # Gouraud per-vertex colours, still Lambert-shaded so the
        # geometry reads under the heatmap or albedo.
        attrs = vertex_colors[faces] * intens[:, :, None]       # [F, 3, 3]
    return screen[faces], proj[:, 2][faces], attrs


def _render(verts, faces, camera, light_dir, base_color, bg_color,
            height: int, width: int, chunk_rows: int, vertex_colors=None):
    """Render [N, V, 3] verts to [N, H, W, 3] in passes of whole row
    chunks (and, under the slab budget, of several images). The per-face
    operands are set up one mesh at a time, so a clip's frame gets the
    very pixels ``render_mesh`` gives it alone (a batched projection
    could round differently)."""
    corners, depths, attrs = (torch.stack(x) for x in zip(*(
        _faces_setup(v, faces, camera, light_dir, height, width,
                     vertex_colors) for v in verts)))
    gx, gy = chunked_pixel_grid(height, width, chunk_rows, verts.dtype,
                                verts.device)
    gx, gy = gx.reshape(height, width), gy.reshape(height, width)
    n = verts.shape[0]
    group, rows = pass_rows(n, height, width, faces.shape[0], chunk_rows,
                            verts.element_size())
    images = []
    for i in range(0, n, group):
        sl = slice(i, i + group)
        parts_v, parts_h = [], []
        for r in range(0, height, rows):
            v, h = _raster_chunk(gx[r:r + rows].reshape(-1),
                                 gy[r:r + rows].reshape(-1), corners[sl],
                                 depths[sl], attrs[sl])
            parts_v.append(v)
            parts_h.append(h)
        vals = torch.cat(parts_v, dim=-2).unflatten(-2, (height, width))
        hit = torch.cat(parts_h, dim=-1).unflatten(-1, (height, width))
        rgb = vals * base_color if vertex_colors is None else vals
        images.append(torch.where(hit[..., None], rgb, bg_color))
    return torch.cat(images)


def _vec3(x, like: torch.Tensor) -> torch.Tensor:
    """A length-3 option (a colour or a direction) as a float32 tensor on
    ``like``'s device."""
    return torch.as_tensor(as_numpy(x, np.float32), device=like.device)


def _prepare(verts, faces, camera, vertex_colors, device):
    """The shared argument handling of ``render_mesh`` and
    ``render_sequence``: float32 verts on their own device (``device``,
    default ``cuda``, for host arrays), int64 faces and the camera moved
    there, the ``vertex_colors`` check."""
    if torch.is_tensor(verts):
        verts = verts.to(torch.float32)
    else:
        verts = torch.as_tensor(as_numpy(verts, np.float32),
                                device=resolve_device(device))
    dev = verts.device
    faces = torch.as_tensor(faces).to(device=dev, dtype=torch.long)
    camera = (default_hand_camera(device=dev) if camera is None
              else camera.to(dev, torch.float32))
    if vertex_colors is not None:
        vertex_colors = torch.as_tensor(vertex_colors).to(
            device=dev, dtype=torch.float32)
        if tuple(vertex_colors.shape) != (verts.shape[-2], 3):
            raise ValueError(
                f"vertex_colors must be [V, 3] matching verts, got "
                f"{tuple(vertex_colors.shape)}"
            )
    return verts, faces, camera, vertex_colors


def render_mesh(
    verts,
    faces,
    camera: Optional[Camera] = None,
    height: int = 256,
    width: int = 256,
    light_dir: Sequence[float] = (0.3, -0.4, 1.0),
    base_color: Sequence[float] = _BASE,
    bg_color: Sequence[float] = _BG,
    chunk_rows: int = 16,
    vertex_colors=None,            # [V, 3] per-vertex RGB (Gouraud)
    device=None,                   # for host-array verts; default cuda
) -> torch.Tensor:
    """Render one mesh to an [H, W, 3] float image in [0, 1], on the
    device of ``verts`` (host arrays go to ``device``, default ``cuda``).

    ``vertex_colors`` swaps the uniform albedo for per-vertex RGB,
    barycentrically interpolated and Lambert-shaded: map per-vertex
    errors through ``error_colormap`` to see where a registration is off.
    """
    verts, faces, camera, vertex_colors = _prepare(
        verts, faces, camera, vertex_colors, device)
    return _render(verts[None], faces, camera, _vec3(light_dir, verts),
                   _vec3(base_color, verts), _vec3(bg_color, verts),
                   height, width, best_chunk_rows(height, chunk_rows),
                   vertex_colors)[0]


def error_colormap(
    values,                        # [V] per-vertex scalars (e.g. meters)
    vmax: Optional[float] = None,  # None = max of values
    device=None,                   # for host-array values; default cuda
) -> torch.Tensor:
    """Map per-vertex scalars to a blue -> white -> red ramp ([V, 3] RGB).

    0 = cool blue, midscale = white, ``vmax`` (default the max) = red.
    Pass the result as ``render_mesh``'s ``vertex_colors`` to see where a
    fit deviates, e.g. ``error_colormap(torch.linalg.norm(fit - target,
    dim=-1))``.
    """
    if torch.is_tensor(values):
        v = values.to(torch.float32)
    else:
        v = torch.as_tensor(as_numpy(values, np.float32),
                            device=resolve_device(device))
    # Both branches guard /0: an explicit vmax=0 (a shared scale from a
    # perfect fit) must give all blue, not NaN.
    top = torch.clamp(v.max() if vmax is None
                      else torch.full((), float(vmax), device=v.device),
                      min=1e-12)
    t = torch.clamp(v / top, 0.0, 1.0)
    lo = _vec3([0.23, 0.30, 0.75], v)   # cool blue
    mid = _vec3([0.96, 0.96, 0.96], v)  # white
    hi = _vec3([0.71, 0.02, 0.15], v)   # red
    s = t[:, None]
    return torch.where(s < 0.5, lo + (mid - lo) * (2.0 * s),
                       mid + (hi - mid) * (2.0 * s - 1.0))


def render_sequence(
    verts_seq,                       # [T, V, 3]
    faces,
    camera: Optional[Camera] = None,
    height: int = 256,
    width: int = 256,
    light_dir: Sequence[float] = (0.3, -0.4, 1.0),
    base_color: Sequence[float] = _BASE,
    bg_color: Sequence[float] = _BG,
    chunk_rows: int = 16,
    vertex_colors=None,
    device=None,
) -> np.ndarray:
    """Render an animation clip to a host [T, H, W, 3] array; frames are
    rasterised together on the device, several to a pass where the slab
    budget allows."""
    verts, faces, camera, vertex_colors = _prepare(
        verts_seq, faces, camera, vertex_colors, device)
    frames = _render(verts, faces, camera, _vec3(light_dir, verts),
                     _vec3(base_color, verts), _vec3(bg_color, verts),
                     height, width, best_chunk_rows(height, chunk_rows),
                     vertex_colors)
    return as_numpy(frames)
