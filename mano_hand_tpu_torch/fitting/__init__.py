"""Fitting: recover pose and shape from observations (inverse MANO).

The port of the JAX package's ``fitting/``: the objectives and priors,
the Kabsch initialisers, the Adam solvers (``fit``,
``fit_with_optimizer``, ``fit_sequence``, ``fit_bucketed``), the
Levenberg-Marquardt solver with the analytic Jacobian (``fit_lm``,
``fit_lm_bucketed``), restarts, streaming trackers and two-hand fits, on
the port's plain core; the silhouette and depth terms (and the auxiliary
``target_mask``) render through ``viz/silhouette.py``.
"""

from mano_hand_tpu_torch.fitting.objectives import (
    huber,
    inter_penetration,
    joint_l2,
    keypoint2d_l2,
    l2_prior,
    mahalanobis_pose_prior,
    max_vertex_error,
    mirror_pose_limits,
    pose_component_variances,
    pose_limit_prior,
    pose_limits_from_corpus,
    self_penetration,
    self_penetration_mask,
    vertex_l2,
)
from mano_hand_tpu_torch.fitting.initialize import (
    initialize_from_joints,
    initialize_from_verts,
    rigid_align,
)
from mano_hand_tpu_torch.fitting.hands import (
    HandsFitResult,
    HandsSequenceFitResult,
    fit_hands,
    fit_hands_sequence,
)
from mano_hand_tpu_torch.fitting.solvers import (
    FitResult,
    SequenceFitResult,
    fit,
    fit_bucketed,
    fit_sequence,
    fit_with_optimizer,
)
from mano_hand_tpu_torch.fitting.lm import LMResult, fit_lm, fit_lm_bucketed
from mano_hand_tpu_torch.fitting.restarts import fit_restarts
from mano_hand_tpu_torch.fitting.tracking import (
    TrackState,
    make_hands_tracker,
    make_tracker,
    track_clip,
    track_hands_clip,
)

__all__ = [
    "FitResult",
    "HandsFitResult",
    "SequenceFitResult",
    "fit_hands",
    "fit_hands_sequence",
    "HandsSequenceFitResult",
    "inter_penetration",
    "self_penetration",
    "self_penetration_mask",
    "fit",
    "fit_bucketed",
    "fit_sequence",
    "fit_with_optimizer",
    "LMResult",
    "fit_lm",
    "fit_lm_bucketed",
    "fit_restarts",
    "TrackState",
    "make_hands_tracker",
    "make_tracker",
    "track_clip",
    "track_hands_clip",
    "vertex_l2",
    "joint_l2",
    "keypoint2d_l2",
    "huber",
    "l2_prior",
    "mahalanobis_pose_prior",
    "mirror_pose_limits",
    "pose_component_variances",
    "pose_limit_prior",
    "pose_limits_from_corpus",
    "initialize_from_joints",
    "initialize_from_verts",
    "rigid_align",
    "max_vertex_error",
]
