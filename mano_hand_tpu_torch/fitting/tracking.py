"""Streaming (online) hand tracking: one frame at a time, warm-started.

The port of the JAX package's ``fitting/tracking.py``. ``fit_sequence``
solves a whole clip jointly (offline); this is the online counterpart: a
``track_step(state, frame_target) -> (state, result)`` API whose every
frame warm-starts from the previous frame's solution, so a handful of
solver steps per frame suffices.

Typical use::

    state, step = make_tracker(params, n_steps=10, data_term="verts")
    for frame in sensor:
        state, res = step(state, frame)
        consume(res.pose, res.shape)
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mano_hand_tpu_torch.fitting import hands as hands_mod
from mano_hand_tpu_torch.fitting import lm as lm_mod
from mano_hand_tpu_torch.fitting import objectives, solvers
from mano_hand_tpu_torch.fitting.initialize import (
    initialize_from_joints, initialize_from_verts,
)
from mano_hand_tpu_torch.runtime.supervise import supervised_call


class TrackState(NamedTuple):
    """Warm start carried between frames (the previous frame's solution)."""

    pose: torch.Tensor           # [J, 3] axis-angle
    shape: torch.Tensor          # [S]
    trans: Optional[torch.Tensor] = None  # [3] when the tracker fits it
    frame: int = 0               # frames consumed so far (host-side int)


def _synchronized(res):
    """``res`` after its device work has finished (the supervised window
    must cover the device work, not only the Python call)."""
    if res.pose.is_cuda:
        torch.cuda.synchronize(res.pose.device)
    return res


def _kabsch_seed(params, target, data_term, solver_kw):
    """The closed-form frame-0 seed on the 3D correspondence terms, or
    None where it does not apply (row-count mismatch etc.)."""
    try:
        if data_term == "joints":
            return initialize_from_joints(
                params, target, solver_kw.get("tip_vertex_ids"),
                solver_kw.get("keypoint_order", "mano"))
        return initialize_from_verts(params, target)
    except ValueError:
        return None


def make_tracker(
    params,
    n_steps: int = 10,
    solver: str = "adam",
    data_term: str = "verts",
    lr: float = 0.02,
    fit_trans: bool = False,
    shape_prior_weight: float = 1e-3,
    camera=None,
    frozen_shape=None,           # [S]: pose-only tracking, betas pinned
    deadline_s: Optional[float] = None,
    retries: int = 0,
    init_pose=None,              # [J, 3]: seed the warm start directly
    **solver_kw,
) -> Tuple[TrackState, Callable]:
    """Build a streaming tracker; returns ``(initial_state, track_step)``.

    ``track_step(state, target) -> (state, result)`` fits one frame,
    seeded from ``state`` (frame 0: the rest pose, or on the 3D
    correspondence terms "verts"/"joints" the closed-form Kabsch
    alignment of the rest skeleton to the first target). ``solver`` is
    ``"adam"`` (any data term, robust/priors via ``**solver_kw``) or
    ``"lm"`` (verts/joints/ICP terms, the lowest-latency choice on clean
    targets). The shape is re-optimised each frame from its warm start.

    ``frozen_shape`` pins beta for the whole stream (pose-only frames).
    ``init_pose`` seeds the warm start from a known pose (a resumed
    stream); the frame-0 Kabsch seed is then skipped (``frame`` starts
    at 1). ``deadline_s``/``retries`` run every frame's solve under
    ``runtime.supervise.supervised_call``, the device work inside the
    supervised window: a failure raises (``RetriesExhausted``) without
    touching ``state``, so the caller keeps the last good warm start.
    """
    if solver not in ("adam", "lm"):
        raise ValueError(f"solver must be 'adam' or 'lm', got {solver!r}")
    if solver == "lm" and solver_kw.get("self_penetration_weight"):
        raise ValueError("self_penetration_weight requires solver='adam' "
                         "(LM's GN residual has no hinge term)")
    if solver == "lm" and solver_kw.get("joint_limits") is not None:
        raise ValueError("joint_limits requires solver='adam' (the limit "
                         "hinge is a first-order energy term)")
    if solver_kw.get("pose_space", "aa") != "aa":
        # The tracker warm-starts the decoded pose every frame.
        raise ValueError(
            "make_tracker warm-starts the decoded pose each frame; "
            f"pose_space must stay 'aa', got "
            f"{solver_kw['pose_space']!r}"
        )
    if solver == "adam" and solver_kw.get("self_penetration_weight"):
        # The [V, V] mask once per stream, not once per frame.
        solver_kw.setdefault(
            "_self_pen_mask", objectives.self_penetration_mask(
                params, solver_kw.get("self_penetration_radius", 0.004)))
    dtype, dev = params.dtype, params.device
    if frozen_shape is not None:
        frozen_shape = solvers._as_target(params, frozen_shape).reshape(
            params.n_shape)
    if init_pose is not None:
        init_pose = solvers._as_target(params, init_pose).reshape(
            params.n_joints, 3)
    state0 = TrackState(
        pose=(torch.zeros((params.n_joints, 3), dtype=dtype, device=dev)
              if init_pose is None else init_pose),
        shape=(torch.zeros((params.n_shape,), dtype=dtype, device=dev)
               if frozen_shape is None else frozen_shape),
        trans=(torch.zeros((3,), dtype=dtype, device=dev)
               if fit_trans else None),
        frame=0 if init_pose is None else 1,
    )

    def track_step(state: TrackState, target) -> Tuple[TrackState, object]:
        target = solvers._as_target(params, target)
        pose0, trans0 = state.pose, state.trans
        if (state.frame == 0 and data_term in ("verts", "joints")
                and target.dim() == 2 and target.shape[-1] == 3):
            seed = _kabsch_seed(params, target, data_term, solver_kw)
            if seed is not None:
                pose0 = seed["pose"]
                if fit_trans:
                    trans0 = seed["trans"]
        init = {"pose": pose0}
        if frozen_shape is None:
            init["shape"] = state.shape
        if fit_trans:
            init["trans"] = trans0

        def solve():
            if solver == "lm":
                return lm_mod.fit_lm(
                    params, target, n_steps=n_steps, data_term=data_term,
                    fit_trans=fit_trans, init=init,
                    frozen_shape=frozen_shape, **solver_kw)
            return solvers.fit(
                params, target, n_steps=n_steps, lr=lr,
                data_term=data_term, camera=camera, fit_trans=fit_trans,
                shape_prior_weight=shape_prior_weight, init=init,
                frozen_shape=frozen_shape, **solver_kw)

        if deadline_s is not None or retries:
            res = supervised_call(
                lambda: _synchronized(solve()), deadline_s=deadline_s,
                retries=retries, name=f"track-step-{solver}")
        else:
            res = solve()
        new_state = TrackState(pose=res.pose, shape=res.shape,
                               trans=getattr(res, "trans", None),
                               frame=state.frame + 1)
        return new_state, res

    return state0, track_step


def make_hands_tracker(
    stacked,                     # core.stack_params(left, right)
    n_steps: int = 10,
    data_term: str = "joints",
    lr: float = 0.02,
    fit_trans: bool = True,
    shape_prior_weight: float = 1e-3,
    camera=None,
    **solver_kw,
) -> Tuple[TrackState, Callable]:
    """Streaming two-hand tracker over ``fit_hands``: the state carries
    both hands ([2, ...] leaves) and each frame solves them jointly
    (shared camera, optional inter-penetration repulsion via
    ``repulsion_weight``). ``fit_trans`` defaults on: real two-hand
    observations are never both origin-centred."""
    # Pass-through options are checked now, not at the first live frame;
    # names the tracker supplies itself are invalid there too.
    allowed = set(inspect.signature(hands_mod.fit_hands).parameters) - {
        "stacked", "targets", "n_steps", "lr", "data_term", "camera",
        "fit_trans", "shape_prior_weight", "init",
    }
    unknown = set(solver_kw) - allowed
    if unknown:
        raise ValueError(
            f"make_hands_tracker got options it cannot pass to fit_hands: "
            f"{sorted(unknown)} (tracker-managed arguments like 'init' are "
            "set per frame; self_penetration_*/ICP options are single-hand "
            "fit/fit_lm features)"
        )
    dtype, dev = stacked.dtype, stacked.device
    state0 = TrackState(
        pose=torch.zeros((2, stacked.n_joints, 3), dtype=dtype, device=dev),
        shape=torch.zeros((2, stacked.n_shape), dtype=dtype, device=dev),
        trans=(torch.zeros((2, 3), dtype=dtype, device=dev)
               if fit_trans else None),
        frame=0,
    )

    def track_step(state: TrackState, target) -> Tuple[TrackState, object]:
        target = solvers._as_target(stacked, target)
        pose0, trans0 = state.pose, state.trans
        if (state.frame == 0 and data_term in ("verts", "joints")
                and target.dim() == 3 and target.shape[0] == 2
                and target.shape[-1] == 3):
            # The frame-0 closed-form seed, per hand (each hand's rest
            # skeleton differs).
            seeds = [_kabsch_seed(hand, target[h], data_term, solver_kw)
                     for h, hand in enumerate(stacked.hands)]
            if all(s is not None for s in seeds):
                pose0 = torch.stack([s["pose"] for s in seeds])
                if fit_trans:
                    trans0 = torch.stack([s["trans"] for s in seeds])
        init = {"pose": pose0, "shape": state.shape}
        if fit_trans:
            init["trans"] = trans0
        res = hands_mod.fit_hands(
            stacked, target, n_steps=n_steps, lr=lr, data_term=data_term,
            camera=camera, fit_trans=fit_trans,
            shape_prior_weight=shape_prior_weight, init=init, **solver_kw)
        new_state = TrackState(pose=res.pose, shape=res.shape,
                               trans=res.trans, frame=state.frame + 1)
        return new_state, res

    return state0, track_step


def track_clip(params, targets, **tracker_kw):
    """Run the streaming tracker over a recorded clip [T, rows, coords].

    Returns ``(poses [T, J, 3], shapes [T, S], final_state)``. Strictly
    causal: frame t sees only frames <= t."""
    targets = solvers._as_target(params, targets)
    state, step = make_tracker(params, **tracker_kw)
    return _run_clip(state, step, targets)


def _run_clip(state, step, targets):
    """The one frame loop both clip conveniences share."""
    poses, shapes = [], []
    for t in range(targets.shape[0]):
        state, _ = step(state, targets[t])
        poses.append(state.pose)
        shapes.append(state.shape)
    return torch.stack(poses), torch.stack(shapes), state


def track_hands_clip(stacked, targets, **tracker_kw):
    """Two-hand ``track_clip`` over a frame-major [T, 2, rows, coords]
    clip. Returns ``(poses [T, 2, J, 3], shapes [T, 2, S],
    final_state)``. Mask clips are [T, H, W] combined or [T, 2, H, W]
    per hand, ``mask_layout`` resolving a [2, H, W] clip as in
    ``fit_hands_sequence``."""
    targets = solvers._as_target(stacked, targets)
    if tracker_kw.get("data_term") == "silhouette":
        solvers.check_hands_silhouette(
            tracker_kw.get("camera"), tracker_kw.get("robust", "none"),
            targets, seq=True, fn_name="track_hands_clip",
            mask_layout=tracker_kw.pop("mask_layout", "auto"))
    elif targets.dim() != 4 or targets.shape[1] != 2:
        raise ValueError(
            f"targets must be [T, 2, rows, coords], got "
            f"{tuple(targets.shape)}"
        )
    state, step = make_hands_tracker(stacked, **tracker_kw)
    return _run_clip(state, step, targets)
