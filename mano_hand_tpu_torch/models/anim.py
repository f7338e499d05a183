"""Temporal sequence evaluation: a clip of frames, one or two hands.

A single-hand clip is one batched forward over its frames
(``core.forward_batched``); a two-hand clip is one hand-batched forward
over (hand, frame) through ``core.forward_hands``, each hand under its own
params (the JAX package's ``models/anim.py``, BASELINE config 5). The pose
resamplers retime axis-angle tracks on the host, in NumPy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mano_hand_tpu_torch.assets.schema import ARRAY_FIELDS, ManoParams
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import IdentityCache


def _on(params, x) -> torch.Tensor:
    return torch.as_tensor(x, device=params.device).to(params.dtype)


def evaluate_sequence(params: ManoParams, poses,
                      shapes=None) -> torch.Tensor:
    """Verts [T, V, 3] for a single-hand clip: poses [T, J, 3], shapes
    [T, S] or [S] (broadcast), default zeros."""
    poses = _on(params, poses)
    t = poses.shape[0]
    if shapes is None:
        shapes = torch.zeros((t, params.n_shape), dtype=params.dtype,
                             device=params.device)
    else:
        shapes = _on(params, shapes).expand(t, params.n_shape)
    return core.forward_batched(params, poses, shapes).verts


def evaluate_two_hand_sequence(left: ManoParams, right: ManoParams, poses,
                               shapes=None) -> torch.Tensor:
    """Verts [T, 2, V, 3] for a two-hand clip: poses [T, 2, J, 3] (hand
    axis: left, right), shapes [T, 2, S] (default zeros). Both hands run
    as one hand-batched forward, each under its own params."""
    poses = _on(left, poses)
    t = poses.shape[0]
    if shapes is None:
        shapes = torch.zeros((t, 2, left.n_shape), dtype=left.dtype,
                             device=left.device)
    stacked = _stacked_cached(left, right)
    out = core.forward_hands(stacked, poses.transpose(0, 1),
                             _on(left, shapes).transpose(0, 1))
    return out.verts.transpose(0, 1)


def _pair_tensors(pair):
    left, right = pair
    return tuple(getattr(p, f) for p in (left, right) for f in ARRAY_FIELDS)


# stack_params copies both hands' tensors; a clip evaluated repeatedly
# reuses the stack while the pair and its tensors are unchanged. Keyed on
# both objects' identity and their tensors' versions, so an in-place
# parameter update restacks.
_stacks = IdentityCache(sources=_pair_tensors)


def _stacked_cached(left: ManoParams, right: ManoParams):
    return _stacks.get((left, right), lambda pair: core.stack_params(*pair))


def resample_poses(poses: np.ndarray, n_frames: int) -> np.ndarray:
    """Linearly retime an axis-angle pose track [T, ...] to n_frames.

    Linear interpolation of axis-angle vectors is exact for fixed axes and
    a good small-angle approximation otherwise; ``resample_poses_slerp``
    is the long-arc-exact path.
    """
    poses = np.asarray(poses)
    t = poses.shape[0]
    if t == n_frames:
        return poses.copy()
    src = np.linspace(0.0, t - 1.0, n_frames)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    w = (src - lo).reshape((-1,) + (1,) * (poses.ndim - 1))
    return (1.0 - w) * poses[lo] + w * poses[hi]


def _aa_to_quat(aa: np.ndarray) -> np.ndarray:
    """Axis-angle [..., 3] -> unit quaternion [..., 4] (w, xyz)."""
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = 0.5 * angle
    # sin(x)/x via sinc (numpy sinc is sin(pi x)/(pi x)): exact limit at 0.
    k = 0.5 * np.sinc(half / np.pi)
    return np.concatenate([np.cos(half), aa * k], axis=-1)


def _quat_to_aa(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [..., 4] -> axis-angle [..., 3], angle in [0, pi]."""
    q = q * np.sign(np.where(q[..., :1] == 0, 1.0, q[..., :1]))  # w >= 0
    w = np.clip(q[..., :1], -1.0, 1.0)
    vec = q[..., 1:]
    norm = np.linalg.norm(vec, axis=-1, keepdims=True)
    angle = 2.0 * np.arctan2(norm, w)
    scale = np.where(norm > 1e-12, angle / np.maximum(norm, 1e-12), 2.0)
    # Near identity, q_vec ~= aa/2, so aa ~= 2*vec: the 2.0 fallback above.
    return vec * scale


def resample_poses_slerp(poses: np.ndarray, n_frames: int) -> np.ndarray:
    """Retime an axis-angle track [T, J, 3] via per-joint quaternion slerp.

    Exact on SO(3) geodesics for any arc length. The output is in
    canonical axis-angle form, angle in [0, pi]: an input with
    |aa| > pi comes back as the same rotation in that form.
    """
    poses = np.asarray(poses, np.float64)
    t = poses.shape[0]
    if t == n_frames:
        # Still canonicalize (quat round-trip) so the output representation
        # is n_frames-independent.
        return _quat_to_aa(_aa_to_quat(poses))
    q = _aa_to_quat(poses)                          # [T, J, 4]
    src = np.linspace(0.0, t - 1.0, n_frames)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    w = (src - lo).reshape(-1, 1, 1)
    qa, qb = q[lo], q[hi]                           # [N, J, 4]
    # Shortest path: flip hemisphere where the pair straddles it.
    dot = (qa * qb).sum(-1, keepdims=True)
    qb = np.where(dot < 0, -qb, qb)
    dot = np.clip(np.abs(dot), -1.0, 1.0)
    theta = np.arccos(dot)
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    safe = np.where(small, 1.0, sin_theta)
    wa = np.where(small, 1.0 - w, np.sin((1.0 - w) * theta) / safe)
    wb = np.where(small, w, np.sin(w * theta) / safe)
    out = wa * qa + wb * qb
    out = out / np.linalg.norm(out, axis=-1, keepdims=True)
    return _quat_to_aa(out)
