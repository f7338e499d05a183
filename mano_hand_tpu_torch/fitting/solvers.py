"""Gradient-based pose/shape recovery (inverse MANO) with Adam.

The port of the JAX package's ``fitting/solvers.py``. JAX runs the
optimiser steps as one ``lax.scan`` and vmaps independent problems; here
the problem axis is written out, as in the port's core: a batch of B
problems is one batched forward, and the loss that is differentiated is
the SUM of the per-problem losses. Each problem's gradient is then its
own and Adam is elementwise, so a batched fit equals B single fits
(a mean would scale every gradient by 1/B and move Adam's ``eps``). The
steps run as a Python loop that keeps the loss and its history on the
device: no step reads a value back to the host, and the one
synchronisation is the caller's, when it reads the result.

Only the fit's own variables are differentiated (``torch.autograd.grad``
of the loss with respect to theta), so a caller whose ``ManoParams``
tensors require grad gets no ``.grad`` written into them. The forward is
the plain core (``core.forward_rotmats``, the staged path of JAX's
``core.forward``); no kernel runs here.

Pose is parameterised as full axis-angle ([16, 3]), PCA coefficients +
global rotation (the reference's own), or the 6D continuous rotation
representation (decoded back to axis-angle through the SO(3) log map).

The rasterising data terms (``silhouette``, ``depth``, and the auxiliary
``target_mask`` beside ``keypoints2d``) render the mesh through the soft
rasterisers of ``viz/silhouette.py``. Their value checks (mask range,
valid depth pixels, ``sil_sigma``, the camera's magnification and
calibrated resolution) run once, at the entry (``validate_mask_target``),
never inside a step.

``fit`` and ``fit_sequence`` also take a target sharded over ranks (a
``DTensor`` split over a mesh's ``data`` dim), as JAX's take a target
placed with ``P('data')``: ``fitting/sharded.py``.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.fitting import objectives, sharded
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import IdentityCache
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.viz.silhouette import soft_depth, soft_silhouette


def _id6d(dtype, device) -> torch.Tensor:
    """The identity rotation in the 6D representation (the first two
    columns of I), made on the device (no host copy)."""
    return ops.matrix_to_6d(torch.eye(3, dtype=dtype, device=device))


# --- pose-space machinery shared by fit and fit_sequence -----------------
def _pose_shapes(pose_space, n_joints, n_pca, allowed):
    """Per-problem pose-parameter shapes: the one shape source for the
    initial values and the warm-start validation."""
    if pose_space not in allowed:
        raise ValueError(
            f"pose_space must be one of {sorted(allowed)}, "
            f"got {pose_space!r}"
        )
    if pose_space == "aa":
        return {"pose": (n_joints, 3)}
    if pose_space == "pca":
        return {"pca": (n_pca,), "global_rot": (3,)}
    return {"rot6d": (n_joints, 6)}


def _pose_init(pose_space, prefix, n_joints, n_pca, dtype, device, allowed):
    shapes = _pose_shapes(pose_space, n_joints, n_pca, allowed)
    if pose_space == "6d":
        # The identity rotation, not zeros (a zero 6D vector is degenerate
        # under Gram-Schmidt).
        return {"rot6d": _id6d(dtype, device)
                .expand(*prefix, *shapes["rot6d"]).clone()}
    return {k: torch.zeros((*prefix, *s), dtype=dtype, device=device)
            for k, s in shapes.items()}


def _batched_init_shapes(pose_space, n_joints, n_pca, n_shape, fit_trans,
                         allowed=frozenset({"aa", "pca", "6d"}),
                         freeze_shape=False):
    """Full per-problem parameter shapes of the active parameterisation
    (``freeze_shape`` drops beta, so a seeded ``init["shape"]`` fails the
    key check by name)."""
    shapes = dict(_pose_shapes(pose_space, n_joints, n_pca, allowed))
    if not freeze_shape:
        shapes["shape"] = (n_shape,)
    if fit_trans:
        shapes["trans"] = (3,)
    return shapes


def validate_batched_init(init, b, expected, target_shape, fn_name):
    """One up-front check for every batched warm start (Adam and LM): a
    single-problem seed or a misspelt key fails here, by name.
    ``expected`` maps key -> per-problem shape."""
    unknown = set(init) - set(expected)
    if unknown:
        raise ValueError(
            f"init keys {sorted(unknown)} not in this parameterization "
            f"{sorted(expected)}"
        )
    for k, v in init.items():
        shape = tuple(torch.as_tensor(v).shape)
        want = (b, *expected[k])
        if shape != want:
            raise ValueError(
                f"batched {fn_name} needs one seed per problem: "
                f"init[{k!r}] has shape {shape}, expected {want} for "
                f"target batch {tuple(target_shape)}"
            )


def _pose_deviation(pose_space, p):
    """What the l2 pose prior penalises: distance from the rest pose in
    the active parameterisation."""
    if pose_space == "pca":
        return p["pca"]
    if pose_space == "6d":
        rot6d = p["rot6d"]
        return rot6d - _id6d(rot6d.dtype, rot6d.device)
    return p["pose"]


def _check_pose_prior(pose_prior: str, pose_space: str,
                      joint_limits=None) -> None:
    if pose_prior not in ("l2", "mahalanobis"):
        raise ValueError(
            f"pose_prior must be 'l2' or 'mahalanobis', got {pose_prior!r}"
        )
    if pose_prior == "mahalanobis" and pose_space not in ("aa", "pca"):
        raise ValueError(
            "pose_prior='mahalanobis' needs the axis-angle statistics, so "
            f"pose_space must be 'aa' or 'pca'; got {pose_space!r}"
        )
    if joint_limits is not None:
        if pose_space not in ("aa", "pca"):
            raise ValueError(
                "joint_limits are per-axis-angle-DOF bounds, so pose_space "
                f"must be 'aa' or 'pca'; got {pose_space!r}"
            )
        if len(joint_limits) != 2:
            raise ValueError(
                "joint_limits must be a (lo, hi) pair (e.g. from "
                "objectives.pose_limits_from_corpus); got "
                f"{len(joint_limits)} elements"
            )


def _fingers_flat(pose_space, params, p):
    """The articulated pose as flat axis-angle [..., 3(J-1)]: the
    coordinates of the Mahalanobis statistics and the joint limits."""
    if pose_space == "aa":
        pose = p["pose"]
        return pose[..., 1:, :].flatten(-2)
    pca = p["pca"]
    n = pca.shape[-1]
    return (ops.common.einsum("...n,nf->...f", pca, params.pca_basis[:n])
            + params.pca_mean)


def _pose_reg(pose_space, pose_prior, pose_prior_vars, params, p,
              pose_prior_weight, joint_limits=None, joint_limit_weight=0.0,
              lead=0):
    """The pose prior term, the one dispatch every solver loss uses:
    the l2 or Mahalanobis prior, plus the joint-limit hinge when
    ``joint_limits`` is given."""
    ff = (_fingers_flat(pose_space, params, p)
          if pose_prior == "mahalanobis" or joint_limits is not None
          else None)
    if pose_prior == "mahalanobis":
        reg = pose_prior_weight * objectives.mahalanobis_pose_prior(
            params, ff, pose_prior_vars, lead=lead)
    else:
        reg = pose_prior_weight * objectives.l2_prior(
            _pose_deviation(pose_space, p), lead=lead)
    if joint_limits is not None:
        lo, hi = joint_limits
        reg = reg + joint_limit_weight * objectives.pose_limit_prior(
            ff, lo, hi, lead=lead)
    return reg


def _pose_to_aa(pose_space, params, p):
    """Final parameters -> axis-angle pose [..., 16, 3]."""
    if pose_space == "aa":
        return p["pose"]
    if pose_space == "6d":
        return ops.axis_angle_from_matrix(ops.matrix_from_6d(p["rot6d"]))
    return core.decode_pca(params, p["pca"], p["global_rot"])


def _model_out(pose_space, params, p, shape):
    """The plain staged forward of the active parameterisation."""
    if pose_space == "6d":
        rot = ops.matrix_from_6d(p["rot6d"])
    else:
        rot = ops.rotation_matrix(_pose_to_aa(pose_space, params, p))
    return core.forward_rotmats(params, rot, shape)


class FitResult(NamedTuple):
    pose: torch.Tensor          # [..., 16, 3] recovered axis-angle pose
    shape: torch.Tensor         # [..., S] recovered shape coefficients
    final_loss: torch.Tensor    # [...] last-step data loss
    loss_history: torch.Tensor  # [..., n_steps] data-loss curve
    pca: Optional[torch.Tensor] = None    # [..., n_pca] when pose_space="pca"
    trans: Optional[torch.Tensor] = None  # [..., 3] when fit_trans=True


def is_multiview(camera) -> bool:
    """True when ``camera`` is a list of cameras (multi-view). A camera
    is whatever exposes ``project``; the cameras are NamedTuples, so a
    plain tuple check would read one camera as a list of its fields."""
    return (isinstance(camera, (list, tuple))
            and not hasattr(camera, "project"))


def check_silhouette_views(camera, target, fn_name: str) -> int:
    """Per-problem target rank for the silhouette term (2, or 3 when
    multi-view), after checking the view axis against the camera list."""
    if not is_multiview(camera):
        return 2
    if target.dim() < 3 or target.shape[-3] != len(camera):
        # dim < 3 = a single [H, W] mask with a camera list: without this
        # the batched dispatch would read mask rows as problems.
        views = target.shape[-3] if target.dim() >= 3 else "no"
        raise ValueError(
            f"{fn_name}: {len(camera)} cameras but target has "
            f"{views} views on axis -3 (shape {tuple(target.shape)}; "
            "multi-view silhouette targets are [..., n_views, H, W])"
        )
    return 3


def check_aux_mask(data_term, target_mask, params, n_frames=None):
    """The one validation of the auxiliary keypoints2d mask (``fit`` and
    ``fit_sequence``). Returns the mask as a tensor like the params."""
    if data_term != "keypoints2d":
        # The pure-mask problem is data_term='silhouette'; the aux mask
        # exists to combine with the keypoint term.
        raise ValueError(
            "target_mask is the auxiliary mask for "
            "data_term='keypoints2d' (for mask-only fitting use "
            f"data_term='silhouette'); got data_term={data_term!r}"
        )
    target_mask = _as_target(params, target_mask)
    shape = tuple(target_mask.shape)
    if n_frames is None:
        if target_mask.dim() not in (2, 3) or 0 in shape:
            raise ValueError(
                "target_mask must be a non-empty [H, W] (or batched "
                f"[B, H, W]) mask, got {shape}"
            )
    elif (target_mask.dim() != 3 or shape[0] != n_frames or 0 in shape):
        raise ValueError(
            "fit_sequence target_mask must be [T, H, W] per-frame "
            f"masks matching {n_frames} frames, got {shape}"
        )
    return target_mask


def check_hands_silhouette(camera, robust, targets, seq: bool,
                           fn_name: str,
                           mask_layout: str = "auto") -> bool:
    """Shared validation of the two-hand mask term; returns ``per_hand``
    (instance masks against one combined mask). A [2, H, W] target at a
    sequence entry point (a 2-frame combined clip, or one frame of
    per-hand masks) is refused unless ``mask_layout`` names the reading."""
    if is_multiview(camera):
        raise ValueError(
            f"{fn_name} takes ONE camera; multi-view silhouette is a "
            "single-hand feature (fit with a camera tuple)"
        )
    if robust != "none":
        raise ValueError("robust does not apply to data_term='silhouette'")
    if mask_layout not in ("auto", "combined", "per_hand"):
        raise ValueError(
            "mask_layout must be 'auto', 'combined' or 'per_hand', got "
            f"{mask_layout!r}"
        )
    combined_ndim = 3 if seq else 2          # [T, H, W] / [H, W]
    hand_axis = 1 if seq else 0
    per_hand_ok = (targets.dim() == combined_ndim + 1
                   and targets.shape[hand_axis] == 2)
    combined_ok = targets.dim() == combined_ndim
    if mask_layout == "combined":
        ok = combined_ok
    elif mask_layout == "per_hand":
        ok = per_hand_ok
    else:
        ok = combined_ok or per_hand_ok
        if seq and combined_ok and targets.shape[0] == 2:
            raise ValueError(
                f"{fn_name}: a [2, H, W] mask target is ambiguous — a "
                "2-frame combined clip or ONE frame of per-hand instance "
                "masks. Pass mask_layout='combined' for the clip reading; "
                "for one frame of per-hand masks use fit_hands()"
            )
    ok = ok and 0 not in tuple(targets.shape)
    if not ok:
        t = "[T, " if seq else "["
        raise ValueError(
            f"silhouette targets must be {t}H, W] combined masks or "
            f"per-hand {t}2, H, W] instance masks "
            f"(mask_layout={mask_layout!r}), got {tuple(targets.shape)}"
            + ("; for one frame use fit_hands()" if seq else "")
        )
    return per_hand_ok and mask_layout != "combined"


def _check_data_term(data_term: str, camera, conf) -> None:
    """One validation policy for every solver entry point."""
    if data_term not in ("verts", "joints", "keypoints2d", "points",
                         "silhouette", "depth"):
        raise ValueError(
            "data_term must be 'verts', 'joints', 'keypoints2d', "
            f"'points', 'silhouette' or 'depth', got {data_term!r}"
        )
    if data_term in ("keypoints2d", "silhouette", "depth"):
        if camera is None:
            raise ValueError(
                f"data_term={data_term!r} needs a viz.camera.Camera (or "
                "WeakPerspectiveCamera)"
            )
        if data_term == "depth" and hasattr(camera, "scale"):
            # Weak perspective's z column is rotation-only: a meters-scale
            # depth target against it is a meaningless residual.
            raise ValueError(
                "data_term='depth' needs a real projection (Camera or "
                "IntrinsicsCamera); weak perspective has no depth axis"
            )
        if is_multiview(camera):
            if data_term != "silhouette":
                raise ValueError(
                    "a camera list (multi-view) is only supported for "
                    f"data_term='silhouette'; {data_term} takes one camera"
                )
            if len(camera) == 0:
                raise ValueError("camera list is empty")
        for c in (camera if is_multiview(camera) else (camera,)):
            if not hasattr(c, "project"):
                # JAX's jit refuses such an argument with a TypeError.
                raise TypeError(
                    "camera must be a viz camera (anything with "
                    f"project(verts)), got {type(c).__name__}"
                )
        if conf is not None and data_term != "keypoints2d":
            raise ValueError(
                "target_conf only applies to data_term='keypoints2d'"
            )
    elif camera is not None or conf is not None:
        # Accepting these would silently fit unweighted/unprojected data.
        raise ValueError(
            "camera/target_conf only apply to the image-space data terms "
            "('keypoints2d', 'silhouette', 'depth'), got "
            f"data_term={data_term!r}"
        )


# Data terms whose rows are skeleton keypoints (the terms the fingertip
# extension applies to; 'verts'/'points' address mesh vertices directly).
KEYPOINT_TERMS = ("joints", "keypoints2d")


def normalize_tips_kwarg(fn):
    """Resolve ``tip_vertex_ids`` (a convention name, ids, or None) to a
    tuple up front, so a bad spec fails by name before any work."""
    @functools.wraps(fn)
    def wrapper(params, *args, tip_vertex_ids=None, **kw):
        # shape[-2] is the vertex axis for single ([V, 3]) AND stacked
        # two-hand ([2, V, 3]) parameter sets.
        tip_vertex_ids = core.resolve_tip_ids(
            tip_vertex_ids, params.v_template.shape[-2])
        return fn(params, *args, tip_vertex_ids=tip_vertex_ids, **kw)

    return wrapper


# Host summaries of image targets, read once per tensor and version: a
# target on the card is read back (one wait) the first time it is
# checked, not again when the same unchanged tensor is fitted again.
_RANGE = IdentityCache()
_DEPTH_VALID = IdentityCache()


def _value_range(x):
    """(min, max) of a mask target as floats, or None when it is empty."""
    if not torch.is_tensor(x):
        t = np.asarray(x)
        return (float(t.min()), float(t.max())) if t.size else None

    def build(t):
        if t.numel() == 0:
            return None
        lo, hi = torch.stack([t.min(), t.max()]).double().cpu().tolist()
        return lo, hi

    return _RANGE.get(x, build)


def _every_image_valid(x) -> bool:
    """True when every [H, W] image of a depth target has a positive
    (valid) pixel; an empty target is valid."""
    if not torch.is_tensor(x):
        t = np.asarray(x)
        return not t.size or bool((t > 0).any(axis=(-2, -1)).all())
    return _DEPTH_VALID.get(x, lambda t: t.numel() == 0 or bool(
        (t > 0).flatten(-2).any(-1).all()))


def validate_mask_target(fn):
    """Check the rasterising terms' targets and render parameters once, at
    the entry, before any step.

    Segmentation masks arrive as uint8 0/255; the soft-IoU loss's [0, 1]
    precondition would otherwise fail silently (a negative, ~255x-scaled
    loss). A depth image with no valid pixel fits to nothing; a zero
    ``sil_sigma`` or camera magnification renders a constant image
    (the init returned as a fit); an ``IntrinsicsCamera`` against a
    mask of another resolution rescales the projection. The call is
    bound to the wrapped function's signature, so keyword targets and a
    positional ``data_term`` both resolve.
    """
    sig = inspect.signature(fn)
    target_name = list(sig.parameters)[1]   # fit: target_verts; seq: targets

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        try:
            bound = sig.bind(*args, **kw)
        except TypeError:
            # Malformed call: let the real function raise its own error.
            return fn(*args, **kw)
        data_term = bound.arguments.get("data_term")
        is_sil = data_term == "silhouette"
        is_depth = data_term == "depth"
        target = bound.arguments.get(target_name)
        masks = [target] if is_sil else []
        masks.append(bound.arguments.get("target_mask"))  # aux (kp2d+mask)
        for m in masks:
            rng = None if m is None else _value_range(m)
            if rng is not None and (rng[0] < 0.0 or rng[1] > 1.0):
                raise ValueError(
                    "silhouette target mask must be in [0, 1], got "
                    f"range [{rng[0]:g}, {rng[1]:g}] "
                    "— divide a 0/255 uint8 mask by 255"
                )
        if (is_sil or is_depth) and target is not None:
            # Image targets need at least [H, W]: name the shape error here.
            shape = (tuple(target.shape) if torch.is_tensor(target)
                     else np.shape(target))
            if len(shape) < 2:
                raise ValueError(
                    f"data_term='{data_term}' targets must be image-"
                    f"shaped [..., H, W]; got shape {shape}"
                )
        if is_depth and target is not None:
            # Per image: one all-invalid frame (sensor dropout) would get
            # zero gradients and report its init as converged.
            if not _every_image_valid(target):
                raise ValueError(
                    "depth target has image(s) with no valid "
                    "(positive) pixels — drop dropped-out frames "
                    "before fitting"
                )
            masks.append(target)   # joins the resolution check below
        if is_sil or is_depth or bound.arguments.get("target_mask") is not None:
            sigma = bound.arguments.get("sil_sigma", 1.0)
            if float(sigma) <= 0:
                raise ValueError(f"sil_sigma must be > 0 pixels, "
                                 f"got {sigma}")
            cam = bound.arguments.get("camera")
            for c in (cam if is_multiview(cam) else (cam,)):
                # Any projection's magnification: zero collapses every
                # vertex to one point (constant mask, zero gradients).
                for attr in ("scale", "focal", "fx", "fy"):
                    val = getattr(c, attr, None)
                    if val is not None and float(val) <= 0:
                        raise ValueError(
                            f"camera {attr} must be > 0 (a zero {attr} "
                            "projects every vertex to one point — "
                            f"constant mask, zero gradients), got {val}"
                        )
                # An IntrinsicsCamera bakes the resolution into its NDC.
                cw, ch = getattr(c, "width", None), getattr(c, "height",
                                                           None)
                if cw is not None and ch is not None:
                    for m in masks:
                        if m is None:
                            continue
                        mh, mw = tuple(m.shape if torch.is_tensor(m)
                                       else np.shape(m))[-2:]
                        if (mh, mw) != (int(ch), int(cw)):
                            raise ValueError(
                                f"mask resolution {mh}x{mw} does not "
                                "match the IntrinsicsCamera calibration "
                                f"{int(ch)}x{int(cw)} — crop/resize "
                                "masks AND adjust K together"
                            )
        return fn(*args, **kw)

    return wrapper


def prepare_self_pen(fn):
    """Build the [V, V] self-penetration mask once, up front, when the
    term is on (``self_penetration_weight`` nonzero): zero-weight fits
    skip the [V, V] pairwise term and its backward entirely. A prebuilt
    mask passes through ``_self_pen_mask`` (the tracker builds one per
    stream)."""
    @functools.wraps(fn)
    def wrapper(params, *args, self_penetration_weight=0.0,
                self_penetration_radius=0.004, _self_pen_mask=None, **kw):
        if self_penetration_weight and _self_pen_mask is None:
            _self_pen_mask = objectives.self_penetration_mask(
                params, self_penetration_radius)
        return fn(params, *args,
                  self_penetration_weight=self_penetration_weight,
                  self_penetration_radius=self_penetration_radius,
                  _self_pen_mask=_self_pen_mask, **kw)

    return wrapper


def check_keypoint_spec(params, data_term, tip_vertex_ids, keypoint_order,
                        target, fn_name):
    """Shared tip/order validation and target row check for every solver.
    Returns ``(tips, n_kp)``: the resolved tip tuple (or None) and the
    keypoint count the spec yields."""
    if keypoint_order not in ("mano", "openpose"):
        raise ValueError(
            f"keypoint_order must be 'mano' or 'openpose', "
            f"got {keypoint_order!r}"
        )
    n_joints = params.j_regressor.shape[-2]
    if data_term not in KEYPOINT_TERMS:
        if tip_vertex_ids is not None or keypoint_order != "mano":
            raise ValueError(
                "tip_vertex_ids/keypoint_order only apply to the keypoint "
                f"data terms {KEYPOINT_TERMS}, got data_term={data_term!r}"
            )
        return None, n_joints
    tips = core.resolve_tip_ids(tip_vertex_ids, params.v_template.shape[-2])
    n_kp = n_joints + (len(tips) if tips else 0)
    if keypoint_order == "openpose" and n_kp != 21:
        raise ValueError(
            "keypoint_order='openpose' is the 21-keypoint convention "
            f"(16 joints + 5 tips); this spec yields {n_kp} keypoints"
        )
    if target.shape[-2] != n_kp:
        raise ValueError(
            f"{fn_name}: target has {target.shape[-2]} keypoint rows but "
            f"the model produces {n_kp} ({n_joints} joints"
            f"{f' + {len(tips)} tips' if tips else ''}); pass "
            "tip_vertex_ids='smplx'|'manopth' (or explicit vertex ids) "
            "for 21-keypoint targets"
        )
    return tips, n_kp


def normalize_conf(target_conf, n_kp: int, like: torch.Tensor):
    """The one conf policy: a scalar lifts to a per-keypoint vector; a
    vector must match the keypoint count. Returns a tensor like ``like``
    (dtype and device), or None."""
    if target_conf is None:
        return None
    target_conf = torch.as_tensor(target_conf).to(like)
    if target_conf.dim() == 0:
        return target_conf.expand(n_kp)
    if target_conf.shape[-1] != n_kp:
        raise ValueError(
            f"target_conf has {target_conf.shape[-1]} entries but this "
            f"keypoint spec yields {n_kp} keypoints"
        )
    return target_conf


def _check_robust(robust, robust_scale) -> None:
    if robust not in ("none", "huber"):
        raise ValueError(f"robust must be 'none' or 'huber', got {robust!r}")
    if robust == "huber" and float(robust_scale) <= 0:
        # A zero scale makes the data term identically zero (the fit would
        # return its initialisation); a negative one rewards outliers.
        raise ValueError(f"robust_scale must be > 0, got {robust_scale}")


def _data_loss(out, offset, target, data_term: str, camera, conf,
               robust: str = "none", robust_scale: float = 0.01,
               tips=None, keypoint_order: str = "mano", lead: int = 0,
               faces=None, sil_sigma: float = 0.7):
    """The one data-term dispatch shared by every Adam solver, one loss
    per problem (``lead`` leading problem axes kept).

    - ``verts``: full-mesh L2 (known correspondence);
    - ``joints``: sparse 3D keypoints (16 joints, plus tips);
    - ``keypoints2d``: posed keypoints through the pinhole projection;
    - ``points``: one-sided chamfer to an unstructured cloud;
    - ``silhouette``: soft IoU of the soft silhouette (``faces``, edge
      softness ``sil_sigma`` pixels) against an [H, W] mask at its
      resolution; a camera list with [..., C, H, W] targets fits every
      view (mean per-view IoU);
    - ``depth``: a sensor depth image [H, W] in view-space meters (<= 0
      or NaN: no reading) against the soft depth render.

    ``robust="huber"`` replaces the per-point (per-pixel for depth)
    squared distance with a Huber penalty at scale ``robust_scale``.
    """
    _check_robust(robust, robust_scale)
    penalty = ((lambda sq: objectives.huber(sq, robust_scale))
               if robust == "huber" else None)
    if data_term == "depth":
        pred = soft_depth(out.verts + offset, faces, camera,
                          height=target.shape[-2], width=target.shape[-1],
                          sigma=sil_sigma)
        return objectives._mean(objectives.depth_loss(pred, target, penalty),
                                lead)
    if data_term == "silhouette":
        if robust != "none":
            # The IoU is bounded per image already: no per-point distance
            # for Huber to act on.
            raise ValueError("robust does not apply to data_term='silhouette'")
        verts = out.verts + offset
        h, w = target.shape[-2], target.shape[-1]
        if is_multiview(camera):
            # One render per camera, the view axis at -3 to line up with
            # [..., C, H, W] targets.
            sil = torch.stack(
                [soft_silhouette(verts, faces, c, height=h, width=w,
                                 sigma=sil_sigma) for c in camera], dim=-3)
        else:
            sil = soft_silhouette(verts, faces, camera, height=h, width=w,
                                  sigma=sil_sigma)
        return objectives._mean(objectives.silhouette_iou_loss(sil, target),
                                lead)
    if data_term == "verts":
        return objectives.vertex_l2(out.verts + offset, target, penalty,
                                    lead=lead)
    if data_term == "points":
        return objectives.point_cloud_l2(out.verts + offset, target,
                                         penalty, lead=lead)
    kp = core.select_keypoints(out.verts, out.posed_joints, tips,
                               keypoint_order)
    if data_term == "joints":
        return objectives.joint_l2(kp + offset, target, penalty, lead=lead)
    xy = camera.project(kp + offset)[..., :2]
    return objectives._mean(
        objectives.keypoint2d_l2(xy, target, conf, penalty), lead)


def _run_adam(loss_fn, theta0: dict, make_optimizer, n_steps: int):
    """The shared optimisation loop. ``loss_fn(p) -> (total, data)``,
    each one value per problem; the summed total is differentiated with
    respect to theta only. The history records the data loss before each
    update and stays on the device; the returned parameters are scored
    once more so ``final_loss`` describes them.

    Returns ``(p_final, final_loss, history [..., n_steps])``.
    """
    names = sorted(theta0)
    leaves = {k: theta0[k].detach().clone().requires_grad_(True)
              for k in names}
    opt = make_optimizer([leaves[k] for k in names])
    history = []
    for _ in range(n_steps):
        with torch.enable_grad():
            total, data = loss_fn(leaves)
            grads = torch.autograd.grad(
                total.sum(), [leaves[k] for k in names],
                allow_unused=True, materialize_grads=True)
        for k, g in zip(names, grads):
            leaves[k].grad = g
        opt.step()
        history.append(data.detach())
    p_final = {k: v.detach() for k, v in leaves.items()}
    with torch.no_grad():
        _, final_loss = loss_fn(p_final)
    empty = torch.zeros((*final_loss.shape, 0), dtype=final_loss.dtype,
                        device=final_loss.device)
    hist = torch.stack(history, dim=-1) if history else empty
    return p_final, final_loss, hist


class OptaxAdam(torch.optim.Optimizer):
    """Adam in optax's ``adam(lr)`` arithmetic, op for op: moments
    ``(1 - b) * g + b * m``, bias corrections ``1 - b ** count`` in the
    parameters' dtype with the step count on the device (as optax keeps
    it), the update ``m_hat / (sqrt(v_hat) + eps)`` scaled by ``-lr``.
    ``torch.optim.Adam`` forms its corrections in float64 on the host and
    its moments by ``lerp``: an f32 step then differs from optax's by
    about 7e-6 relative, which a sharp loss (the soft depth) amplifies.
    Nothing here reads the device."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, eps, lr = (group[k] for k in ("b1", "b2", "eps", "lr"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = torch.zeros((), dtype=p.dtype,
                                                 device=p.device)
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["count"] += 1
                mu = (1 - b1) * g + b1 * state["mu"]
                nu = (1 - b2) * (g * g) + b2 * state["nu"]
                state["mu"], state["nu"] = mu, nu
                mu_hat = mu / (1 - torch.pow(b1, state["count"]))
                nu_hat = nu / (1 - torch.pow(b2, state["count"]))
                p.add_((mu_hat / (torch.sqrt(nu_hat) + eps)) * (-lr))
        return None


def adam(lr: float):
    """The optimizer factory of ``fit``: ``OptaxAdam`` (optax's ``adam(lr)``:
    b1 0.9, b2 0.999, eps 1e-8 outside the square root)."""
    def make(leaves):
        return OptaxAdam(leaves, lr=lr)
    return make


def _prior_operands(params, pose_prior_vars, joint_limits):
    """The prior operands as tensors on the params' device (moved once,
    before the loop, so no step copies from the host)."""
    if pose_prior_vars is not None:
        pose_prior_vars = _as_target(params, pose_prior_vars)
    if joint_limits is not None and len(joint_limits) == 2:
        joint_limits = tuple(_as_target(params, x) for x in joint_limits)
    return pose_prior_vars, joint_limits


def _camera_on(camera, like: torch.Tensor):
    """The camera (or each camera of a multi-view list) with its tensors
    on ``like``'s device and dtype (moved once, before the loop)."""
    if is_multiview(camera):
        return tuple(_camera_on(c, like) for c in camera)
    mover = getattr(camera, "to", None)
    return camera if mover is None else mover(like.device, like.dtype)


def _as_target(params, x) -> torch.Tensor:
    """``x`` (a tensor, array or sequence) as a tensor on the params'
    device and dtype; a tensor already there passes through uncopied."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(device=params.device, dtype=params.dtype)


def _check_single_init(init, shapes: dict, note: str) -> None:
    """A single-problem warm start: known keys, exact per-problem shapes
    (no silent reshape: a transposed seed has the right element count
    but scrambled joints)."""
    unknown = set(init) - set(shapes)
    if unknown:
        raise ValueError(
            f"init keys {sorted(unknown)} not in this parameterization "
            f"{sorted(shapes)}{note}")
    for k, v in init.items():
        got = tuple(torch.as_tensor(v).shape)
        if got != tuple(shapes[k]):
            raise ValueError(
                f"init[{k!r}] shape {got} != expected {tuple(shapes[k])}")


def _fit_batched(
    params, target, conf, *, init, frozen_shape, make_optimizer,
    n_steps, pose_space, n_pca, pose_prior_weight, shape_prior_weight,
    data_term, camera, fit_trans, robust, robust_scale, pose_prior,
    pose_prior_vars, joint_limits, joint_limit_weight, tips,
    keypoint_order, self_penetration_weight, self_penetration_radius,
    self_pen_mask, sil_sigma, target_mask, mask_weight,
) -> FitResult:
    """B independent problems ([B, rows, coords] targets; [B, H, W] or
    [B, C, H, W] images) as one batched loss; ``init`` leaves are
    [B, ...], ``frozen_shape`` [S] or [B, S], ``target_mask`` [H, W]
    (shared) or [B, H, W]."""
    _check_pose_prior(pose_prior, pose_space, joint_limits)
    pose_prior_vars, joint_limits = _prior_operands(params, pose_prior_vars,
                                                    joint_limits)
    dtype, dev = params.dtype, params.device
    b = target.shape[0]
    freeze = frozen_shape is not None
    theta0 = _pose_init(pose_space, (b,), params.n_joints, n_pca, dtype,
                        dev, allowed={"aa", "pca", "6d"})
    if not freeze:
        theta0["shape"] = torch.zeros((b, params.n_shape), dtype=dtype,
                                      device=dev)
    if fit_trans:
        theta0["trans"] = torch.zeros((b, 3), dtype=dtype, device=dev)
    for k, v in (init or {}).items():
        theta0[k] = torch.as_tensor(v).to(theta0[k])
    if freeze:
        frozen_shape = frozen_shape.expand(b, params.n_shape)
    if camera is not None:
        camera = _camera_on(camera, target)

    def loss_fn(p):
        shape = frozen_shape if freeze else p["shape"]
        out = _model_out(pose_space, params, p, shape)
        offset = p["trans"][:, None, :] if fit_trans else 0.0
        data = _data_loss(out, offset, target, data_term, camera, conf,
                          robust, robust_scale, tips, keypoint_order, lead=1,
                          faces=params.faces, sil_sigma=sil_sigma)
        if target_mask is not None:
            # The tracking energy: sparse keypoints pin the skeleton, the
            # mask refines the outline, both through the one camera.
            data = data + mask_weight * _data_loss(
                out, offset, target_mask, "silhouette", camera, None,
                "none", robust_scale, None, "mano", lead=1,
                faces=params.faces, sil_sigma=sil_sigma)
        reg = _pose_reg(pose_space, pose_prior, pose_prior_vars, params, p,
                        pose_prior_weight, joint_limits, joint_limit_weight,
                        lead=1)
        if not freeze:
            reg = reg + shape_prior_weight * objectives.l2_prior(
                p["shape"], lead=1)
        if self_pen_mask is not None and self_penetration_weight:
            reg = reg + self_penetration_weight * objectives.self_penetration(
                out.verts, self_pen_mask, self_penetration_radius, lead=1)
        return data + reg, data

    p_final, final_loss, history = _run_adam(loss_fn, theta0, make_optimizer,
                                             n_steps)
    return FitResult(
        pose=_pose_to_aa(pose_space, params, p_final),
        shape=frozen_shape if freeze else p_final["shape"],
        final_loss=final_loss,
        loss_history=history,
        pca=p_final.get("pca"),
        trans=p_final.get("trans"),
    )


@sharded.over_data_rows
@validate_mask_target
@normalize_tips_kwarg
@prepare_self_pen
def fit(
    params,
    target_verts,               # [V, 3] or [B, V, 3] ([J, 3] joints;
                                # [J, 2] keypoints2d; [N, 3] points)
    n_steps: int = 200,
    lr: float = 0.05,
    pose_space: str = "aa",
    n_pca: int = 45,
    pose_prior_weight: float = 0.0,
    shape_prior_weight: float = 0.0,
    data_term: str = "verts",
    camera=None,
    target_conf=None,            # [J] or [B, J]
    fit_trans: bool = False,
    robust: str = "none",
    robust_scale: float = 0.01,
    init: Optional[dict] = None,
    pose_prior: str = "l2",
    pose_prior_vars=None,        # [C] component variances
    joint_limits=None,           # (lo, hi) per flat articulated DOF
    joint_limit_weight: float = 1.0,
    tip_vertex_ids=None,         # None | "smplx" | "manopth" | vertex ids
    keypoint_order: str = "mano",  # "mano" | "openpose" (21-kp targets)
    self_penetration_weight: float = 0.0,
    self_penetration_radius: float = 0.004,
    _self_pen_mask=None,         # built by prepare_self_pen; do not pass
    sil_sigma: float = 0.7,      # silhouette/depth edge softness, pixels
    target_mask=None,            # [H, W] / [B, H, W] aux mask (kp2d)
    mask_weight: float = 0.1,
    frozen_shape=None,           # [S] or [B, S]
) -> FitResult:
    """Recover pose/shape for one target or a batch of them, by Adam.

    Batched targets fit as independent problems in one batched loss (this
    is BASELINE.json config 4 at batch 256); the result carries one
    ``final_loss`` and one ``loss_history`` row per problem.
    ``data_term='keypoints2d'`` fits 2D detector output projected through
    ``camera`` (a pinhole ``viz.Camera``, ``IntrinsicsCamera`` or a
    ``WeakPerspectiveCamera``), optionally confidence-weighted; pair it
    with ``fit_trans=True`` and nonzero priors.

    ``pose_prior="mahalanobis"`` swaps the isotropic pose prior for the
    data-driven ``objectives.mahalanobis_pose_prior``; ``joint_limits``
    adds the joint-limit hinge; ``tip_vertex_ids`` extends the keypoint
    terms with fingertip vertices (``keypoint_order="openpose"`` for
    OpenPose-ordered targets); ``self_penetration_weight > 0`` adds the
    self-collision hinge; ``frozen_shape`` pins beta ([B, S]: one subject
    per problem) and fits pose only (``init`` must not seed ``"shape"``).
    ``data_term='silhouette'`` fits a segmentation mask through the soft
    rasteriser (edge softness ``sil_sigma`` pixels, scored by soft IoU at
    the mask's resolution; a camera list fits [..., C, H, W] multi-view
    masks); ``data_term='depth'`` a sensor depth image through the soft
    depth render. With both a detector and a segmenter, fit
    ``keypoints2d`` and pass the mask as ``target_mask`` (weighted by
    ``mask_weight``). For another optimizer use ``fit_with_optimizer``.
    """
    return fit_with_optimizer(
        params, target_verts, adam(lr),
        n_steps=n_steps, pose_space=pose_space, n_pca=n_pca,
        pose_prior_weight=pose_prior_weight,
        shape_prior_weight=shape_prior_weight,
        data_term=data_term, camera=camera, target_conf=target_conf,
        fit_trans=fit_trans, robust=robust, robust_scale=robust_scale,
        init=init, pose_prior=pose_prior, pose_prior_vars=pose_prior_vars,
        joint_limits=joint_limits, joint_limit_weight=joint_limit_weight,
        tip_vertex_ids=tip_vertex_ids, keypoint_order=keypoint_order,
        self_penetration_weight=self_penetration_weight,
        self_penetration_radius=self_penetration_radius,
        _self_pen_mask=_self_pen_mask, sil_sigma=sil_sigma,
        target_mask=target_mask, mask_weight=mask_weight,
        frozen_shape=frozen_shape,
    )


@validate_mask_target
@prepare_self_pen
def fit_with_optimizer(
    params,
    target_verts,
    make_optimizer: Callable,
    n_steps: int = 200,
    pose_space: str = "aa",
    n_pca: int = 45,
    pose_prior_weight: float = 0.0,
    shape_prior_weight: float = 0.0,
    data_term: str = "verts",
    camera=None,
    target_conf=None,
    fit_trans: bool = False,
    robust: str = "none",
    robust_scale: float = 0.01,
    init: Optional[dict] = None,
    pose_prior: str = "l2",
    pose_prior_vars=None,
    joint_limits=None,
    joint_limit_weight: float = 1.0,
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    self_penetration_weight: float = 0.0,
    self_penetration_radius: float = 0.004,
    _self_pen_mask=None,
    sil_sigma: float = 0.7,
    target_mask=None,
    mask_weight: float = 0.1,
    frozen_shape=None,
) -> FitResult:
    """``fit`` with any optimizer. Where the JAX package takes an optax
    transformation, this takes ``make_optimizer``: a factory from the list
    of the fit's parameter tensors to a ``torch.optim.Optimizer`` over
    them (``fit`` passes ``adam(lr)``). The optimizer sees the summed
    loss's gradients, one problem's own per row."""
    _check_data_term(data_term, camera, target_conf)
    if target_mask is not None:
        target_mask = check_aux_mask(data_term, target_mask, params)
    target_verts = _as_target(params, target_verts)
    n_sh = params.n_shape
    if frozen_shape is not None:
        frozen_shape = _as_target(params, frozen_shape)
        if frozen_shape.dim() not in (1, 2) or frozen_shape.shape[-1] != n_sh:
            raise ValueError(
                f"frozen_shape must be [{n_sh}] (or [B, {n_sh}] for "
                f"batched problems), got {tuple(frozen_shape.shape)}"
            )
    tips, n_kp = check_keypoint_spec(
        params, data_term, tip_vertex_ids, keypoint_order, target_verts,
        "fit")
    if data_term == "points" and target_verts.shape[-2] == 0:
        # A zero-point cloud would mean() over an empty axis -> NaN.
        raise ValueError("points target cloud is empty ([..., 0, 3])")
    target_conf = normalize_conf(target_conf, n_kp, target_verts)
    run = functools.partial(
        _fit_batched, params, make_optimizer=make_optimizer,
        n_steps=n_steps, pose_space=pose_space, n_pca=n_pca,
        pose_prior_weight=pose_prior_weight,
        shape_prior_weight=shape_prior_weight, data_term=data_term,
        camera=camera, fit_trans=fit_trans, robust=robust,
        robust_scale=robust_scale, pose_prior=pose_prior,
        pose_prior_vars=pose_prior_vars, joint_limits=joint_limits,
        joint_limit_weight=joint_limit_weight, tips=tips,
        keypoint_order=keypoint_order,
        self_penetration_weight=self_penetration_weight,
        self_penetration_radius=self_penetration_radius,
        self_pen_mask=_self_pen_mask, sil_sigma=sil_sigma,
        mask_weight=mask_weight)
    single_ndim = 2
    if data_term == "silhouette":
        single_ndim = check_silhouette_views(camera, target_verts, "fit")
    if target_verts.dim() == single_ndim:
        if target_mask is not None and target_mask.dim() != 2:
            raise ValueError(
                "single-problem fits take one [H, W] target_mask, got "
                f"{tuple(target_mask.shape)}"
            )
        if frozen_shape is not None and frozen_shape.dim() != 1:
            raise ValueError(
                "single-problem fits take one frozen_shape [S], got "
                f"{tuple(frozen_shape.shape)}"
            )
        shapes = _batched_init_shapes(
            pose_space, params.n_joints, n_pca, n_sh, fit_trans,
            freeze_shape=frozen_shape is not None)
        if init:
            _check_single_init(
                init, shapes,
                f" (pose_space={pose_space!r}, fit_trans={fit_trans})")
        res = run(target_verts[None], target_conf,
                  init={k: torch.as_tensor(v)[None]
                        for k, v in (init or {}).items()},
                  frozen_shape=frozen_shape, target_mask=target_mask)
        return FitResult(*(None if x is None else x[0] for x in res))
    if init:
        validate_batched_init(
            init, target_verts.shape[0],
            _batched_init_shapes(pose_space, params.n_joints, n_pca, n_sh,
                                 fit_trans,
                                 freeze_shape=frozen_shape is not None),
            target_verts.shape, "fit")
    if (target_mask is not None and target_mask.dim() == 3
            and target_mask.shape[0] != target_verts.shape[0]):
        raise ValueError(
            f"batched target_mask has {target_mask.shape[0]} masks for "
            f"{target_verts.shape[0]} problems (shapes "
            f"{tuple(target_mask.shape)} vs {tuple(target_verts.shape)}); "
            "pass one [H, W] mask to share it"
        )
    if (frozen_shape is not None and frozen_shape.dim() == 2
            and frozen_shape.shape[0] != target_verts.shape[0]):
        raise ValueError(
            f"batched frozen_shape has {frozen_shape.shape[0]} rows for "
            f"{target_verts.shape[0]} problems; pass one [S] vector to "
            "share the subject"
        )
    return run(target_verts, target_conf, init=init,
               frozen_shape=frozen_shape, target_mask=target_mask)


# ------------------------------------------------------------- sequences
class SequenceFitResult(NamedTuple):
    pose: torch.Tensor          # [T, 16, 3] per-frame axis-angle pose
    shape: torch.Tensor         # [S] one shape for the whole clip
    final_loss: torch.Tensor    # [] mean per-frame data loss at the end
    loss_history: torch.Tensor  # [n_steps] data-loss curve
    trans: Optional[torch.Tensor] = None  # [T, 3] when fit_trans=True


@sharded.over_data_frames
@validate_mask_target
@normalize_tips_kwarg
@prepare_self_pen
def fit_sequence(
    params,
    targets,                    # [T, V, 3] | [T, J, 3] | [T, J, 2] | [T, N, 3]
    n_steps: int = 300,
    lr: float = 0.03,
    data_term: str = "verts",
    camera=None,
    target_conf=None,           # [T, J] or [J]
    fit_trans: bool = False,
    robust: str = "none",
    robust_scale: float = 0.01,
    smooth_pose_weight: float = 1e-3,
    smooth_trans_weight: float = 1e-3,
    pose_prior_weight: float = 0.0,
    shape_prior_weight: float = 1e-3,
    pose_space: str = "aa",
    pose_prior: str = "l2",
    pose_prior_vars=None,
    joint_limits=None,
    joint_limit_weight: float = 1.0,
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    self_penetration_weight: float = 0.0,
    self_penetration_radius: float = 0.004,
    _self_pen_mask=None,
    sil_sigma: float = 0.7,
    target_mask=None,            # [T, H, W] aux masks
    mask_weight: float = 0.1,
) -> SequenceFitResult:
    """Fit a whole motion clip as ONE optimisation problem: one shape for
    the clip, per-frame pose (axis-angle, or ``pose_space="6d"`` whose
    velocity coupling is wrap-free) and translation, coupled by
    squared-velocity smoothness priors, so frames with poor observations
    borrow from their neighbours. All T frames' forwards are one batched
    forward inside one Adam loop. A clip sharded over ranks (a DTensor
    over a mesh's ``data`` dim) is fitted whole on every rank, each
    keeping its frames (``fitting/sharded.py``)."""
    _check_data_term(data_term, camera, target_conf)
    _check_pose_prior(pose_prior, pose_space, joint_limits)
    pose_prior_vars, joint_limits = _prior_operands(params, pose_prior_vars,
                                                    joint_limits)
    dtype, dev = params.dtype, params.device
    targets = _as_target(params, targets)
    want_ndim = 3
    if data_term == "silhouette":
        want_ndim = 1 + check_silhouette_views(camera, targets,
                                               "fit_sequence")
    if targets.dim() != want_ndim:
        # A [V, 3] single frame would otherwise read as V one-point frames.
        raise ValueError(
            "fit_sequence targets must be [T, rows, coords] ([T, H, W] "
            "masks / [T, n_views, H, W] multi-view for the silhouette "
            "term); for a single frame use fit(). Got shape "
            f"{tuple(targets.shape)}"
        )
    if data_term == "points" and targets.shape[-2] == 0:
        raise ValueError("points target cloud is empty ([T, 0, 3])")
    if target_mask is not None:
        target_mask = check_aux_mask(data_term, target_mask, params,
                                     n_frames=targets.shape[0])
    tips, n_kp = check_keypoint_spec(
        params, data_term, tip_vertex_ids, keypoint_order, targets,
        "fit_sequence")
    t_frames = targets.shape[0]
    target_conf = normalize_conf(target_conf, n_kp, targets)
    if target_conf is not None:
        target_conf = target_conf.expand(t_frames, n_kp)
    if camera is not None:
        camera = _camera_on(camera, targets)

    theta0 = _pose_init(pose_space, (t_frames,), params.n_joints, 0, dtype,
                        dev, allowed={"aa", "6d"})
    theta0["shape"] = torch.zeros((params.n_shape,), dtype=dtype, device=dev)
    if fit_trans:
        theta0["trans"] = torch.zeros((t_frames, 3), dtype=dtype, device=dev)
    pose_key = "pose" if pose_space == "aa" else "rot6d"

    def loss_fn(p):
        shapes = p["shape"].expand(t_frames, params.n_shape)
        out = _model_out(pose_space, params, p, shapes)
        offset = p["trans"][:, None, :] if fit_trans else 0.0
        data = _data_loss(out, offset, targets, data_term, camera,
                          target_conf, robust, robust_scale, tips,
                          keypoint_order, faces=params.faces,
                          sil_sigma=sil_sigma)
        if target_mask is not None:
            # Per-frame aux masks over the clip, one camera.
            data = data + mask_weight * _data_loss(
                out, offset, target_mask, "silhouette", camera, None,
                "none", robust_scale, None, "mano", faces=params.faces,
                sil_sigma=sil_sigma)
        if t_frames > 1:
            vel = p[pose_key][1:] - p[pose_key][:-1]
            reg = smooth_pose_weight * torch.mean(vel ** 2)
            if fit_trans:
                tvel = p["trans"][1:] - p["trans"][:-1]
                reg = reg + smooth_trans_weight * torch.mean(tvel ** 2)
        else:
            # Mean over an empty velocity array would be NaN.
            reg = torch.zeros((), dtype=dtype, device=dev)
        reg = (reg
               + _pose_reg(pose_space, pose_prior, pose_prior_vars, params,
                           p, pose_prior_weight, joint_limits,
                           joint_limit_weight)
               + shape_prior_weight * objectives.l2_prior(p["shape"]))
        if _self_pen_mask is not None and self_penetration_weight:
            reg = reg + self_penetration_weight * objectives.self_penetration(
                out.verts, _self_pen_mask, self_penetration_radius)
        return data + reg, data

    p_final, final_loss, history = _run_adam(loss_fn, theta0, adam(lr),
                                             n_steps)
    return SequenceFitResult(
        pose=_pose_to_aa(pose_space, params, p_final),
        shape=p_final["shape"],
        final_loss=final_loss,
        loss_history=history,
        trans=p_final.get("trans"),
    )


# ----------------------------------------------------- bucketed wrappers
# The per-bucket programs each solver has run, the port's reading of the
# JAX jit cache: a (solver, padded target shape, warm-start keys, static
# options) key counts one compile the first time it is seen.
_programs: set = set()
_programs_lock = threading.Lock()

#: The options JAX's ``fit`` declares static (a change recompiles there).
FIT_STATIC = ("n_steps", "pose_space", "n_pca", "data_term", "fit_trans",
              "robust", "robust_scale", "pose_prior", "tip_vertex_ids",
              "keypoint_order", "self_penetration_weight",
              "self_penetration_radius")


def _pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """``x``'s leading dim padded to ``bucket`` by repeating row 0 (the
    ``serving/buckets.py`` policy, on the device)."""
    n = x.shape[0]
    if n == bucket:
        return x
    return torch.cat([x, x[:1].expand(bucket - n, *x.shape[1:])])


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


def bucketed_fit_call(fit_fn, params, targets, *, min_bucket, max_bucket,
                      counters, init, fn_name, static, **kw):
    """Shared engine of ``fit_bucketed``/``fit_lm_bucketed``: pad the
    problem axis up to a power-of-two bucket (pad problems repeat problem
    0), run, and slice the pad problems off every leaf of the result.
    ``init`` leaves and the per-problem auxiliary kwargs pad alike (by
    rank: [B, J] conf, [B, H, W] masks, [B, S] frozen betas; a shared
    [H, W] mask whose height equals B stays unpadded). ``counters`` (a
    ``utils.profiling.ServingCounters``) counts one compile the first
    time the solver runs a bucket with these static options, and one
    dispatch per call."""
    targets = _as_target(params, targets)
    if targets.dim() < 3:
        raise ValueError(
            f"{fn_name} wraps BATCHED problems ([B, rows, coords] / "
            f"[B, H, W] targets); got {tuple(targets.shape)} — call the "
            "unbucketed solver for a single problem")
    b = targets.shape[0]
    bucket = bucket_mod.bucket_for(
        b, bucket_mod.bucket_sizes(min_bucket, max_bucket))
    padded = _pad_rows(targets, bucket)
    if init is not None:
        init = {k: _pad_rows(_as_target(params, v), bucket)
                for k, v in init.items()}
    for aux, batched_ndim in (("target_conf", 2), ("target_mask", 3),
                              ("frozen_shape", 2)):
        v = kw.get(aux)
        if v is not None:
            v = _as_target(params, v)
            if v.dim() == batched_ndim and v.shape[0] == b:
                kw[aux] = _pad_rows(v, bucket)
    key = (fn_name, tuple(padded.shape), tuple(sorted(init or ())),
           tuple((k, _hashable(kw[k])) for k in static if k in kw))
    with _programs_lock:
        new = key not in _programs
        _programs.add(key)
    res = fit_fn(params, padded, init=init, **kw)
    if counters is not None:
        if new:
            counters.count_compile()
        counters.count_dispatch(bucket, b)
    return type(res)(*(None if x is None else x[:b] for x in res))


def fit_bucketed(params, target_verts, *, min_bucket: int = 1,
                 max_bucket: int = 1024, counters=None,
                 init: Optional[dict] = None, **kw) -> FitResult:
    """``fit`` for streams of many small problems with ragged counts: the
    problem batch is padded to the nearest power-of-two bucket and the
    pad problems' results are dropped, so steady traffic reuses a handful
    of batch shapes. All ``fit`` kwargs pass through; ``counters``
    observes compiles and padding."""
    return bucketed_fit_call(
        fit, params, target_verts, min_bucket=min_bucket,
        max_bucket=max_bucket, counters=counters, init=init,
        fn_name="fit_bucketed", static=FIT_STATIC, **kw)
