"""Multi-restart fitting: escape local minima by solving many inits at once.

The port of the JAX package's ``fitting/restarts.py``. Sparse, 2D or
partial targets are multi-modal: one descent from the zero pose can lock
into the wrong basin. R anatomically plausible inits
(``core.sample_poses``: z ~ N(0, I) through the asset's PCA basis) are
solved as one batched fit, then the best final loss wins. Wall-clock is
one fit, not R.

The sampled inits come from a ``torch.Generator`` where JAX takes a PRNG
key: a different random stream, so the sampled restarts differ from the
JAX package's for the same seed. The zero-pose and Kabsch rows do not.
"""

from __future__ import annotations

from typing import Union

import torch

from mano_hand_tpu_torch.fitting import lm as lm_mod
from mano_hand_tpu_torch.fitting import solvers
from mano_hand_tpu_torch.fitting.initialize import (
    initialize_from_joints, initialize_from_verts,
)
from mano_hand_tpu_torch.models import core


def fit_restarts(
    params,
    target,                     # [V|J|N, 3] | [J, 2]: ONE problem
    n_restarts: int = 8,
    key: Union[int, torch.Generator] = 0,
    solver: str = "adam",       # "adam" (fitting.fit) | "lm" (fit_lm)
    pca_scale: float = 1.0,
    global_rot_scale: float = 0.5,
    component_vars=None,
    include_zero: bool = True,
    include_kabsch: bool = True,
    **solver_kw,
):
    """Solve one fitting problem from ``n_restarts`` inits; keep the best.

    Returns ``(best, restart_losses)``: the single-problem
    ``FitResult``/``LMResult`` of the winning restart, and the final loss
    of every restart. ``include_zero`` keeps the zero pose as restart 0,
    so the result is never worse than a plain fit; ``include_kabsch``
    seeds one restart from the closed-form rigid alignment of the rest
    model to the target (the correspondence terms "verts"/"joints").
    ``key`` is a ``torch.Generator`` for the sampled poses, or an int
    seed of a fresh CPU generator. ``solver_kw`` passes through to
    ``fitting.fit``/``fitting.fit_lm``. Restarts own the warm start, so
    ``init=`` and a non-axis-angle ``pose_space`` are refused.
    """
    if solver not in ("adam", "lm"):
        raise ValueError(f"solver must be 'adam' or 'lm', got {solver!r}")
    if "init" in solver_kw:
        raise ValueError("fit_restarts owns init; remove the init kwarg")
    if solver_kw.get("pose_space", "aa") != "aa":
        raise ValueError(
            "fit_restarts samples axis-angle inits; pose_space must stay "
            f"'aa', got {solver_kw['pose_space']!r}"
        )
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    target = solvers._as_target(params, target)
    want_ndim = 2
    if solver_kw.get("data_term") == "silhouette":
        # Masks are [H, W] per problem, or [n_views, H, W] with a camera
        # list; outlines are the most multi-modal data of all.
        want_ndim = solvers.check_silhouette_views(
            solver_kw.get("camera"), target, "fit_restarts")
    if target.dim() != want_ndim:
        raise ValueError(
            "fit_restarts solves ONE problem (target [rows, 2|3], or an "
            "[H, W] / [n_views, H, W] mask for the silhouette term); for "
            f"independent batches call the solver directly, got shape "
            f"{tuple(target.shape)}"
        )
    dtype, dev = params.dtype, params.device

    kabsch = None
    if include_kabsch and target.shape[-1] == 3:
        dt = solver_kw.get("data_term", "verts")
        if dt == "joints":
            kabsch = initialize_from_joints(
                params, target,
                tip_vertex_ids=solver_kw.get("tip_vertex_ids"),
                keypoint_order=solver_kw.get("keypoint_order", "mano"))
        elif dt == "verts":
            kabsch = initialize_from_verts(params, target)

    n_sampled = n_restarts - int(include_zero) - int(kabsch is not None)
    if n_sampled < 0:
        # No row left for the Kabsch seed: drop it rather than break the
        # never-worse-than-a-plain-fit contract.
        kabsch = None
        n_sampled = n_restarts - int(include_zero)
    if isinstance(key, int):
        key = torch.Generator().manual_seed(key)
    poses = []
    if include_zero:
        poses.append(torch.zeros((1, params.n_joints, 3), dtype=dtype,
                                 device=dev))
    if kabsch is not None:
        poses.append(kabsch["pose"][None])
    if n_sampled:
        poses.append(core.sample_poses(
            params, key, n_sampled, pca_scale=pca_scale,
            global_rot_scale=global_rot_scale,
            component_vars=component_vars).to(dtype))
    init = {
        "pose": torch.cat(poses, dim=0),
        "shape": torch.zeros((n_restarts, params.n_shape), dtype=dtype,
                             device=dev),
    }
    if solver_kw.get("fit_trans"):
        trans = torch.zeros((n_restarts, 3), dtype=dtype, device=dev)
        if kabsch is not None:
            # The Kabsch rotation lands in the right basin only together
            # with its pivot-compensating translation.
            trans[int(include_zero)] = kabsch["trans"]
        init["trans"] = trans

    tiled = target.expand(n_restarts, *target.shape)
    if solver == "adam":
        result = solvers.fit(params, tiled, init=init, **solver_kw)
    else:
        result = lm_mod.fit_lm(params, tiled, init=init, **solver_kw)
    losses = result.final_loss
    # A wild sampled init can diverge to NaN under Adam; argmin would then
    # pick it. NaN = worst.
    i = int(torch.argmin(torch.where(torch.isnan(losses),
                                     torch.full_like(losses, float("inf")),
                                     losses)))
    best = type(result)(*(None if leaf is None else leaf[i]
                          for leaf in result))
    return best, losses
