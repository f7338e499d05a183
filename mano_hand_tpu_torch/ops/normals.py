"""Face and vertex normals (the JAX package's ``ops/normals.py``).

One gather, one cross product and one scatter-add (``index_add``) per
mesh; plain PyTorch, differentiable. Every function broadcasts over
leading batch dimensions of ``verts``.
"""

from __future__ import annotations

import torch

from mano_hand_tpu_torch.ops.common import EPS


def face_normals(verts: torch.Tensor,   # [..., V, 3]
                 faces: torch.Tensor,   # [F, 3] int
                 normalize: bool = True) -> torch.Tensor:
    """Per-face normals [..., F, 3] (right-hand winding, CCW = outward).

    Un-normalised, the magnitude is twice the triangle area: the area
    weighting wanted for vertex accumulation.
    """
    faces = faces.long()
    fv = verts[..., faces, :]                  # [..., F, 3 corners, 3 xyz]
    n = torch.linalg.cross(fv[..., 1, :] - fv[..., 0, :],
                           fv[..., 2, :] - fv[..., 0, :])
    if normalize:
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=EPS)
    return n


def vertex_normals(verts: torch.Tensor,   # [..., V, 3]
                   faces: torch.Tensor,   # [F, 3] int
                   ) -> torch.Tensor:
    """Area-weighted vertex normals [..., V, 3], unit length.

    The un-normalised face normals (|n| = 2A) are scatter-added to their
    three corners, so large triangles dominate their corners' normals.
    A vertex referenced by no face gets a zero normal (the eps guard
    keeps it finite).
    """
    fn = face_normals(verts, faces, normalize=False)        # [..., F, 3]
    corners = fn.repeat_interleave(3, dim=-2)               # [..., F*3, 3]
    acc = torch.zeros_like(verts).index_add(
        -2, faces.reshape(-1).long(), corners)              # [..., V, 3]
    return acc / torch.clamp(torch.linalg.norm(acc, dim=-1, keepdim=True),
                             min=EPS)


def batched_vertex_normals(verts: torch.Tensor,
                           faces: torch.Tensor) -> torch.Tensor:
    """``vertex_normals`` over a leading batch axis of verts [B, V, 3]."""
    if verts.dim() != 3:
        raise ValueError(f"verts must be [B, V, 3], got {list(verts.shape)}")
    return vertex_normals(verts, faces)
