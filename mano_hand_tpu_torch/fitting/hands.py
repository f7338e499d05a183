"""Joint two-hand fitting (interacting hands).

The port of the JAX package's ``fitting/hands.py``. One observation of
two hands in one frame of reference is fitted as ONE problem: both hands
through ``core.forward_hands`` over a ``core.stack_params`` pair,
per-hand pose/shape/translation, one camera for 2D terms, and an optional
inter-penetration repulsion (``objectives.inter_penetration``) that lets
the surfaces touch but not overlap. The solve is one Adam loop
(``solvers._run_adam``), as for one hand. The silhouette term renders
each hand with its own faces through the soft rasteriser and scores
per-hand instance masks, or one combined mask against the soft union of
the two renders.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mano_hand_tpu_torch.fitting import objectives, solvers
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.viz.silhouette import soft_silhouette


def _hands_silhouette_loss(stacked, verts, targets, camera, sil_sigma,
                           per_hand: bool):
    """Mask loss of the two-hand solvers. ``verts`` carries the hand axis
    at -3 ([2, V, 3] or [T, 2, V, 3]); each hand renders with its own
    faces (the left and right windings differ). ``per_hand`` scores
    [..., 2, H, W] instance masks hand by hand; otherwise the two renders
    combine by the rasteriser's probabilistic union into one soft image
    of both hands against one combined mask."""
    h, w = targets.shape[-2], targets.shape[-1]
    sil_l = soft_silhouette(verts[..., 0, :, :], stacked.faces[0], camera,
                            height=h, width=w, sigma=sil_sigma)
    sil_r = soft_silhouette(verts[..., 1, :, :], stacked.faces[1], camera,
                            height=h, width=w, sigma=sil_sigma)
    if per_hand:
        sil = torch.stack([sil_l, sil_r], dim=-3)
    else:
        sil = 1.0 - (1.0 - sil_l) * (1.0 - sil_r)
    return torch.mean(objectives.silhouette_iou_loss(sil, targets))


class HandsFitResult(NamedTuple):
    pose: torch.Tensor          # [2, 16, 3] axis-angle (left, right)
    shape: torch.Tensor         # [2, S]
    final_loss: torch.Tensor    # [] final data loss (both hands)
    loss_history: torch.Tensor  # [n_steps]
    trans: Optional[torch.Tensor] = None  # [2, 3] when fit_trans=True


class HandsSequenceFitResult(NamedTuple):
    pose: torch.Tensor          # [T, 2, 16, 3] per-frame, per-hand
    shape: torch.Tensor         # [2, S] one shape per hand for the clip
    final_loss: torch.Tensor    # []
    loss_history: torch.Tensor  # [n_steps]
    trans: Optional[torch.Tensor] = None  # [T, 2, 3] when fit_trans=True


def _check_hands(stacked, data_term, camera, target_conf, fn_name, one):
    if stacked.side != "stacked":
        raise ValueError(
            f"{fn_name} takes core.stack_params(left, right) output "
            f"([2, ...] leaves); got side={stacked.side!r}. For one hand "
            f"use {one}()."
        )
    # The unsupported terms first: the generic check would demand a
    # camera for a term this entry point does not take at all.
    if data_term in ("points", "depth"):
        raise ValueError(
            f"{fn_name} supports verts/joints/keypoints2d/silhouette; for "
            "scan registration fit each hand with fit_lm (ICP needs "
            "per-hand correspondence anyway), and for depth images fit "
            "each hand on its cropped depth region"
        )
    solvers._check_data_term(data_term, camera, target_conf)


def _data(stacked, out, offset, targets, data_term, camera, conf, robust,
          robust_scale, tips, keypoint_order, sil_sigma, per_hand_masks):
    """The two-hand data term: the mask loss, or the single-hand dispatch
    over the hand (and frame) axes."""
    if data_term == "silhouette":
        return _hands_silhouette_loss(stacked, out.verts + offset, targets,
                                      camera, sil_sigma, per_hand_masks)
    return solvers._data_loss(out, offset, targets, data_term, camera, conf,
                              robust, robust_scale, tips, keypoint_order)


def _reg(p, pose_prior_weight, shape_prior_weight, joint_limits,
         joint_limit_weight, verts, repulsion_weight, repulsion_radius,
         hand_axis):
    """The two-hand priors: l2 on the articulated poses and the shapes,
    the joint-limit hinge (bounds [45] shared or [2, 45] per hand), and
    the repulsion between the two surfaces."""
    arti = p["pose"][..., 1:, :]
    reg = (pose_prior_weight * objectives.l2_prior(arti)
           + shape_prior_weight * objectives.l2_prior(p["shape"]))
    if joint_limits is not None:
        lo, hi = joint_limits
        reg = reg + joint_limit_weight * objectives.pose_limit_prior(
            arti.flatten(-2), lo, hi)
    if repulsion_weight:
        reg = reg + repulsion_weight * objectives.inter_penetration(
            verts.select(hand_axis, 0), verts.select(hand_axis, 1),
            repulsion_radius)
    return reg


@solvers.validate_mask_target
@solvers.normalize_tips_kwarg
def fit_hands(
    stacked,                    # core.stack_params(left, right)
    targets,                    # [2, rows, coords], hand-major (L, R)
    n_steps: int = 200,
    lr: float = 0.05,
    data_term: str = "verts",
    camera=None,                # ONE camera observing both hands
    target_conf=None,           # [K] or [2, K]
    fit_trans: bool = False,
    robust: str = "none",
    robust_scale: float = 0.01,
    pose_prior_weight: float = 0.0,
    shape_prior_weight: float = 0.0,
    joint_limits=None,          # (lo, hi), each [45] shared or [2, 45]
    joint_limit_weight: float = 1.0,
    repulsion_weight: float = 0.0,
    repulsion_radius: float = 0.004,
    init: Optional[dict] = None,
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    sil_sigma: float = 0.7,
) -> HandsFitResult:
    """Recover both hands' pose/shape (and translation) from one frame.

    ``stacked`` is ``core.stack_params(left, right)``; ``targets`` is
    hand-major (``targets[0]`` observes the left hand). Every data term of
    ``fit`` except the ICP one applies, the 21-keypoint extension
    included; ``fit_trans=True`` gives each hand its own translation.
    ``repulsion_weight > 0`` adds ``objectives.inter_penetration`` between
    the two surfaces at ``repulsion_radius`` (meters): zero whenever the
    hands are apart, so it acts only in close interaction.

    ``data_term="silhouette"`` fits per-hand ``[2, H, W]`` instance masks,
    or ONE combined ``[H, W]`` mask against the soft union of both
    renders. A combined mask cannot say which hand explains which region
    (the swapped assignment is an equally good optimum from a cold
    start), so warm-start ``init["trans"]``.
    """
    _check_hands(stacked, data_term, camera, target_conf, "fit_hands",
                 "fit")
    dtype, dev = stacked.dtype, stacked.device
    targets = solvers._as_target(stacked, targets)
    per_hand_masks = False
    if data_term == "silhouette":
        # [H, W]: one combined mask of both hands; [2, H, W]: per hand.
        per_hand_masks = solvers.check_hands_silhouette(
            camera, robust, targets, seq=False, fn_name="fit_hands")
    elif targets.dim() != 3 or targets.shape[0] != 2:
        raise ValueError(
            f"targets must be [2, rows, coords] hand-major, got "
            f"{tuple(targets.shape)}"
        )
    one = stacked.hands[0]
    tips, n_kp = solvers.check_keypoint_spec(
        one, data_term, tip_vertex_ids, keypoint_order, targets,
        "fit_hands")
    solvers._check_robust(robust, robust_scale)
    target_conf = solvers.normalize_conf(target_conf, n_kp, targets)
    if target_conf is not None:
        target_conf = target_conf.expand(2, n_kp)
    if camera is not None:
        camera = solvers._camera_on(camera, targets)
    _, joint_limits = solvers._prior_operands(stacked, None, joint_limits)

    theta0 = {
        "pose": torch.zeros((2, one.n_joints, 3), dtype=dtype, device=dev),
        "shape": torch.zeros((2, one.n_shape), dtype=dtype, device=dev),
    }
    if fit_trans:
        theta0["trans"] = torch.zeros((2, 3), dtype=dtype, device=dev)
    if init:
        unknown = set(init) - set(theta0)
        if unknown:
            raise ValueError(
                f"init keys {sorted(unknown)} not in {sorted(theta0)}")
        for k, v in init.items():
            v = torch.as_tensor(v).to(theta0[k])
            if v.shape != theta0[k].shape:
                raise ValueError(
                    f"init[{k!r}] shape {tuple(v.shape)} != "
                    f"{tuple(theta0[k].shape)} (hand-major: both hands)")
            theta0[k] = v

    def loss_fn(p):
        out = core.ManoOutput(*(x[:, 0] for x in core.forward_hands(
            stacked, p["pose"][:, None], p["shape"][:, None])))
        offset = p["trans"][:, None, :] if fit_trans else 0.0
        data = _data(stacked, out, offset, targets, data_term, camera,
                     target_conf, robust, robust_scale, tips, keypoint_order,
                     sil_sigma, per_hand_masks)
        reg = _reg(p, pose_prior_weight, shape_prior_weight, joint_limits,
                   joint_limit_weight, out.verts + offset, repulsion_weight,
                   repulsion_radius, hand_axis=0)
        return data + reg, data

    p_final, final_loss, history = solvers._run_adam(
        loss_fn, theta0, solvers.adam(lr), n_steps)
    return HandsFitResult(pose=p_final["pose"], shape=p_final["shape"],
                          final_loss=final_loss, loss_history=history,
                          trans=p_final.get("trans"))


@solvers.validate_mask_target
@solvers.normalize_tips_kwarg
def fit_hands_sequence(
    stacked,                    # core.stack_params(left, right)
    targets,                    # [T, 2, rows, coords] frame-major
    n_steps: int = 300,
    lr: float = 0.03,
    data_term: str = "verts",
    camera=None,
    target_conf=None,           # [K] or [2, K]
    fit_trans: bool = False,
    robust: str = "none",
    robust_scale: float = 0.01,
    smooth_pose_weight: float = 1e-3,
    smooth_trans_weight: float = 1e-3,
    pose_prior_weight: float = 0.0,
    shape_prior_weight: float = 1e-3,
    joint_limits=None,          # (lo, hi), each [45] shared or [2, 45]
    joint_limit_weight: float = 1.0,
    repulsion_weight: float = 0.0,
    repulsion_radius: float = 0.004,
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    sil_sigma: float = 0.7,
    mask_layout: str = "auto",   # "combined" | "per_hand" | "auto"
) -> HandsSequenceFitResult:
    """Fit a two-hand clip as ONE problem: one shape per hand for the
    clip, per-frame pose (and translation) coupled by squared-velocity
    smoothness, and the repulsion applied per frame. Frame-major
    ``[T, 2, rows, coords]`` targets (``anim.evaluate_two_hand_sequence``'s
    layout)."""
    if mask_layout != "auto" and data_term != "silhouette":
        raise ValueError(
            "mask_layout only applies to data_term='silhouette', got "
            f"data_term={data_term!r}"
        )
    _check_hands(stacked, data_term, camera, target_conf,
                 "fit_hands_sequence", "fit_sequence")
    dtype, dev = stacked.dtype, stacked.device
    targets = solvers._as_target(stacked, targets)
    per_hand_masks = False
    if data_term == "silhouette":
        # [T, H, W] combined per frame, or [T, 2, H, W] per hand.
        per_hand_masks = solvers.check_hands_silhouette(
            camera, robust, targets, seq=True, fn_name="fit_hands_sequence",
            mask_layout=mask_layout)
    elif targets.dim() != 4 or targets.shape[1] != 2:
        raise ValueError(
            "targets must be [T, 2, rows, coords] frame-major, got "
            f"{tuple(targets.shape)}; for one frame use fit_hands()"
        )
    one = stacked.hands[0]
    tips, n_kp = solvers.check_keypoint_spec(
        one, data_term, tip_vertex_ids, keypoint_order, targets,
        "fit_hands_sequence")
    solvers._check_robust(robust, robust_scale)
    t_frames = targets.shape[0]
    target_conf = solvers.normalize_conf(target_conf, n_kp, targets)
    if target_conf is not None:
        target_conf = target_conf.expand(t_frames, 2, n_kp)
    if camera is not None:
        camera = solvers._camera_on(camera, targets)
    _, joint_limits = solvers._prior_operands(stacked, None, joint_limits)

    theta0 = {
        "pose": torch.zeros((t_frames, 2, one.n_joints, 3), dtype=dtype,
                            device=dev),
        "shape": torch.zeros((2, one.n_shape), dtype=dtype, device=dev),
    }
    if fit_trans:
        theta0["trans"] = torch.zeros((t_frames, 2, 3), dtype=dtype,
                                      device=dev)

    def loss_fn(p):
        out_hm = core.forward_hands(
            stacked, p["pose"].transpose(0, 1),
            p["shape"][:, None, :].expand(2, t_frames, one.n_shape))
        out = core.ManoOutput(*(x.transpose(0, 1) for x in out_hm))
        offset = p["trans"][..., None, :] if fit_trans else 0.0
        data = _data(stacked, out, offset, targets, data_term, camera,
                     target_conf, robust, robust_scale, tips, keypoint_order,
                     sil_sigma, per_hand_masks)
        if t_frames > 1:
            vel = p["pose"][1:] - p["pose"][:-1]
            reg = smooth_pose_weight * torch.mean(vel ** 2)
            if fit_trans:
                tvel = p["trans"][1:] - p["trans"][:-1]
                reg = reg + smooth_trans_weight * torch.mean(tvel ** 2)
        else:
            reg = torch.zeros((), dtype=dtype, device=dev)
        reg = reg + _reg(p, pose_prior_weight, shape_prior_weight,
                         joint_limits, joint_limit_weight,
                         out.verts + offset, repulsion_weight,
                         repulsion_radius, hand_axis=1)
        return data + reg, data

    p_final, final_loss, history = solvers._run_adam(
        loss_fn, theta0, solvers.adam(lr), n_steps)
    return HandsSequenceFitResult(
        pose=p_final["pose"], shape=p_final["shape"],
        final_loss=final_loss, loss_history=history,
        trans=p_final.get("trans"))
