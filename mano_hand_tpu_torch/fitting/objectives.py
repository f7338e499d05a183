"""Fitting objectives and priors.

The port of the JAX package's ``fitting/objectives.py``: pure functions
of (predicted, target) plus parameter priors, composed by the solvers
into one loss. Each reduction that JAX takes over a whole (vmapped)
problem takes ``lead`` here, the number of leading problem axes to keep
(0, the default, reduces to a scalar as in JAX). The solvers write the
problem axis out and keep it, so a batched fit is one batched loss whose
sum differentiates to every problem's own gradient.

Contractions go through ``ops/common.py:einsum`` (IEEE fp32 whatever the
caller's TF32 switch).
"""

from __future__ import annotations

import numpy as np
import torch

from mano_hand_tpu_torch.ops.common import IdentityCache, einsum


def _mean(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Mean over every axis after the first ``lead`` ones."""
    if x.dim() == lead:
        return x
    return x.mean() if lead == 0 else x.flatten(lead).mean(-1)


def _pairwise_sq_dist(pred_verts: torch.Tensor,     # [..., V, 3]
                      target_points: torch.Tensor,  # [..., N, 3]
                      ) -> torch.Tensor:
    """[..., N, V] squared distances: the one implementation of the
    pairwise expansion |t|^2 - 2 t.v + |v|^2 that the chamfer term, the
    ICP assignment and the penetration terms share."""
    return (
        torch.sum(target_points ** 2, dim=-1)[..., :, None]
        - 2.0 * einsum("...nc,...vc->...nv", target_points, pred_verts)
        + torch.sum(pred_verts ** 2, dim=-1)[..., None, :]
    )


def nearest_vertex_sq_dist(pred_verts: torch.Tensor,
                           target_points: torch.Tensor) -> torch.Tensor:
    """Per-point squared distance to the nearest mesh vertex: [..., N],
    clamped at 0 (the expansion can go slightly negative in fp)."""
    return torch.clamp(
        _pairwise_sq_dist(pred_verts, target_points).amin(dim=-1), min=0.0)


def nearest_vertex_idx(pred_verts: torch.Tensor,
                       target_points: torch.Tensor) -> torch.Tensor:
    """Index of the nearest mesh vertex per point: [..., N] int64 (the
    ICP correspondence assignment)."""
    return torch.argmin(_pairwise_sq_dist(pred_verts, target_points), dim=-1)


def point_cloud_l2(pred_verts: torch.Tensor, target_points: torch.Tensor,
                   penalty=None, lead: int = 0) -> torch.Tensor:
    """One-sided chamfer: each observed point to its nearest mesh vertex
    (partial views are fine: unobserved mesh regions cost nothing)."""
    sq = nearest_vertex_sq_dist(pred_verts, target_points)
    return _mean(sq if penalty is None else penalty(sq), lead)


def vertex_l2(pred_verts: torch.Tensor, target_verts: torch.Tensor,
              penalty=None, lead: int = 0) -> torch.Tensor:
    """Mean per-vertex penalty (the data term). ``penalty`` maps per-point
    squared distances elementwise (e.g. ``huber``); None = plain squared
    distance."""
    sq = torch.sum((pred_verts - target_verts) ** 2, dim=-1)
    return _mean(sq if penalty is None else penalty(sq), lead)


def joint_l2(pred_joints: torch.Tensor, target_joints: torch.Tensor,
             penalty=None, lead: int = 0) -> torch.Tensor:
    """Mean per-joint penalty (sparser, better conditioned early)."""
    sq = torch.sum((pred_joints - target_joints) ** 2, dim=-1)
    return _mean(sq if penalty is None else penalty(sq), lead)


def max_vertex_error(pred_verts: torch.Tensor,
                     target_verts: torch.Tensor) -> torch.Tensor:
    """Max per-vertex Euclidean error (the BASELINE.json accuracy
    metric)."""
    return torch.linalg.norm(pred_verts - target_verts, dim=-1).max()


def keypoint2d_l2(pred_xy: torch.Tensor, target_xy: torch.Tensor,
                  conf=None, penalty=None) -> torch.Tensor:
    """(Confidence-weighted) mean squared 2D reprojection error, reduced
    over the keypoint axis only (one loss per problem). Weights are
    normalised, so the scale is independent of how many keypoints are
    trusted."""
    err = torch.sum((pred_xy - target_xy) ** 2, dim=-1)
    if penalty is not None:
        err = penalty(err)
    if conf is None:
        return err.mean(dim=-1)
    return torch.sum(conf * err, dim=-1) / torch.clamp(
        torch.sum(conf, dim=-1), min=1e-12)


def silhouette_iou_loss(pred_sil: torch.Tensor,
                        target_mask: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU between a soft silhouette [..., H, W] in [0, 1] and a
    target mask (the SoftRas convention: intersection sum(p t), union
    sum(p + t - p t)); one loss per image. The epsilon makes the
    empty-empty case a zero loss."""
    inter = torch.sum(pred_sil * target_mask, dim=(-2, -1))
    union = torch.sum(pred_sil + target_mask, dim=(-2, -1)) - inter
    return 1.0 - (inter + 1e-6) / (union + 1e-6)


def depth_loss(pred_depth: torch.Tensor, target_depth: torch.Tensor,
               penalty=None) -> torch.Tensor:
    """Masked mean squared depth error against a sensor depth image
    [..., H, W]: pixels <= 0 or NaN carry no reading and are excluded,
    and an image with no valid pixel contributes 0. One loss per
    image."""
    valid = target_depth > 0.0          # NaN > 0 is False: NaN-invalid too
    # The double where: sanitise the input before the residual, so a NaN
    # target never reaches a gradient.
    safe_target = torch.where(valid, target_depth,
                              torch.zeros_like(target_depth))
    zero = torch.zeros_like(pred_depth)
    sq = torch.where(valid, (pred_depth - safe_target) ** 2, zero)
    if penalty is not None:
        sq = torch.where(valid, penalty(sq), zero)  # penalty(0) need not be 0
    v = valid.to(pred_depth.dtype)
    return (torch.sum(sq, dim=(-2, -1))
            / torch.clamp(torch.sum(v, dim=(-2, -1)), min=1.0))


def huber(sq_dist: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber penalty on per-point SQUARED distances: quadratic within
    ``delta``, linear in distance beyond. The inlier branch takes no
    sqrt and the outlier branch's argument is clamped from below by
    delta^2, so the gradient stays finite at exact zero."""
    d2 = delta * delta
    safe = torch.sqrt(torch.clamp(sq_dist, min=d2))
    return torch.where(sq_dist <= d2, sq_dist, 2.0 * delta * safe - d2)


def inter_penetration(verts_a: torch.Tensor, verts_b: torch.Tensor,
                      radius: float) -> torch.Tensor:
    """Soft inter-mesh repulsion: a symmetric hinge on nearest-neighbour
    DISTANCES between two meshes, zero once every vertex of each is at
    least ``radius`` from the other. One pairwise expansion serves both
    directions."""
    d2 = torch.clamp(_pairwise_sq_dist(verts_a, verts_b), min=0.0)

    def hinge(sq):
        d = torch.sqrt(torch.clamp(sq, min=1e-12))
        return torch.mean(torch.clamp(radius - d, min=0.0) ** 2)

    return 0.5 * (hinge(d2.amin(dim=-1)) + hinge(d2.amin(dim=-2)))


def self_penetration_mask(params, radius: float = 0.004) -> torch.Tensor:
    """[V, V] bool mask of the vertex pairs the self-penetration term may
    penalise, on the params' device: pairs whose body parts (dominant
    skinning weight) lie on different kinematic chains, and which are
    farther than ``radius`` apart in the rest pose.

    A finger's whole non-root ancestor chain is excluded (a curling
    finger brings its distal pad near its own proximal segment); the root
    keeps only direct parent/child adjacency, so thumb-through-palm pairs
    stay penalised. Computed in NumPy on the host; constant per asset, so
    build it once and reuse it.
    """
    w = params.lbs_weights.detach().cpu().numpy()
    parents = list(params.parents)
    n_joints = w.shape[1]
    part = w.argmax(axis=1)                               # [V]
    excluded = np.eye(n_joints, dtype=bool)
    for j in range(n_joints):
        p = parents[j]
        if p is not None and p >= 0:
            excluded[p, j] = excluded[j, p] = True        # direct
            k = parents[p]
            while (k is not None and k >= 0 and parents[k] is not None
                   and parents[k] >= 0):
                # k is a non-root strict ancestor of j.
                excluded[k, j] = excluded[j, k] = True
                k = parents[k]
    rest = params.v_template.detach().cpu().numpy()
    d2 = ((rest[:, None, :] - rest[None, :, :]) ** 2).sum(-1)
    far_at_rest = d2 > radius * radius
    return torch.as_tensor(~excluded[part[:, None], part[None, :]]
                           & far_at_rest, device=params.device)


def self_penetration(verts: torch.Tensor, mask: torch.Tensor, radius: float,
                     lead: int = 0) -> torch.Tensor:
    """Soft self-collision repulsion for one hand (leading axes
    broadcast): a hinge on the distance of each vertex to its nearest
    masked neighbour. Unmasked pairs are pushed beyond the hinge rather
    than dropped, so each row's min stays defined."""
    d2 = torch.clamp(_pairwise_sq_dist(verts, verts), min=0.0)
    d2 = torch.where(mask, d2, torch.full_like(d2, (2.0 * radius) ** 2))
    d = torch.sqrt(torch.clamp(d2.amin(dim=-1), min=1e-12))
    return _mean(torch.clamp(radius - d, min=0.0) ** 2, lead)


def l2_prior(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Quadratic prior toward zero (pose/shape regulariser)."""
    return _mean(x ** 2, lead)


_pinv = IdentityCache()


def pca_pinv(params) -> torch.Tensor:
    """pinv(pca_basis) [45, C], cached per basis tensor (built once: an
    SVD, which waits for the device)."""
    def build(basis):
        with torch.no_grad():
            return torch.linalg.pinv(basis)
    return _pinv.get(params.pca_basis, build)


def mahalanobis_pose_prior(params, fingers_flat: torch.Tensor,
                           component_vars=None, lead: int = 0,
                           ) -> torch.Tensor:
    """Data-driven pose prior: squared deviation of the articulated pose
    [..., 3(J-1)] from the asset's mean pose, in PCA-whitened component
    space (``z = (theta - mean) pinv(basis)``, mean(z^2 / var)). The
    global rotation is not part of it."""
    dtype = fingers_flat.dtype
    mean = params.pca_mean.to(dtype)
    z = einsum("...f,fc->...c", fingers_flat - mean,
               pca_pinv(params).to(dtype))
    if component_vars is not None:
        z = z / torch.sqrt(torch.as_tensor(component_vars).to(z))
    return _mean(z ** 2, lead)


def pose_limit_prior(fingers_flat: torch.Tensor, lo, hi,
                     lead: int = 0) -> torch.Tensor:
    """Anatomical joint-limit prior: squared hinge outside per-DOF bounds
    (zero everywhere inside the admissible box)."""
    x = fingers_flat
    lo = torch.as_tensor(lo).to(x)
    hi = torch.as_tensor(hi).to(x)
    under = torch.clamp(lo - x, min=0.0)
    over = torch.clamp(x - hi, min=0.0)
    return _mean(under ** 2 + over ** 2, lead)


def _flat_articulated(params, poses) -> torch.Tensor:
    """A pose corpus as flat articulated axis-angle [N, 3(J-1)] on the
    params' device: [N, J, 3] full (global row dropped), [N, J-1, 3] or
    already flat [N, 3(J-1)] (e.g. ``assets.decode_scan_poses``)."""
    poses = torch.as_tensor(np.asarray(poses) if not torch.is_tensor(poses)
                            else poses).to(params.pca_mean)
    n_aa = params.pca_mean.shape[-1]
    if poses.dim() == 3 and poses.shape[-2] * 3 == n_aa + 3:
        poses = poses[..., 1:, :]  # drop the global-rotation row
    return poses.reshape(poses.shape[0], n_aa)


def pose_limits_from_corpus(params, poses, expand: float = 0.15):
    """Per-DOF axis-angle bounds ``(lo, hi)`` from a pose corpus: the
    corpus min/max per flat DOF, widened by ``expand`` radians."""
    flat = _flat_articulated(params, poses)
    return flat.amin(dim=0) - expand, flat.amax(dim=0) + expand


def mirror_pose_limits(lo, hi):
    """Right-hand bounds from left-hand ones (or the reverse): the y/z
    axis-angle components negate between the sides, which swaps and
    flips their bound pair; x carries over."""
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi).to(lo)
    sign = torch.tensor([1.0, -1.0, -1.0], dtype=lo.dtype,
                        device=lo.device).repeat(lo.shape[-1] // 3)
    flipped = sign < 0
    return torch.where(flipped, -hi, lo), torch.where(flipped, -lo, hi)


def pose_component_variances(params, poses) -> torch.Tensor:
    """Per-component variances of a pose corpus in PCA component space
    (feed to ``mahalanobis_pose_prior``), floored at 1e-6."""
    flat = _flat_articulated(params, poses)
    z = einsum("nf,fc->nc", flat - params.pca_mean,
               pca_pinv(params).to(flat))
    return torch.clamp(torch.var(z, dim=0, unbiased=False), min=1e-6)
