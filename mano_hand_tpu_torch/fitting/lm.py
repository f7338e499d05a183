"""Levenberg-Marquardt pose/shape fitting (second-order inverse MANO).

The port of the JAX package's ``fitting/lm.py``: damped Gauss-Newton over
the ~58-dim (pose, shape) space. The residual Jacobian [B, R, P] is
assembled analytically by default (``fitting/jacobian.py``: AD touches
only the 16-joint chain); ``jacobian="ad"`` keeps ``torch.func.jacfwd``
of the full residual, vmapped over problems, as the cross-check. The
normal matrix JtJ is one batched product, the solve one batched LU
(``torch.linalg.solve_ex``, which leaves its status on the device), and
accept/reject is branch-free (``torch.where``), so a step reads nothing
back to the host.

Problems are written out along a leading axis, as in the port's core;
every problem keeps its own damping, accept pattern and history. The
solver runs under ``torch.no_grad()`` (it needs no reverse AD), on the
plain core: no kernel runs here.

``normal_eq="high"`` forms JtJ and Jtr in IEEE fp32 (``ieee_fp32``, the
port's precision contract); ``"bf16"`` rounds their operands to bf16 and
accumulates in fp32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.fitting import jacobian as jacobian_mod
from mano_hand_tpu_torch.fitting import objectives, solvers
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import einsum, round_bf16

# Data terms with per-step ICP correspondence assignment.
_ICP_TERMS = ("points", "point_to_plane")

#: The options JAX's ``fit_lm`` declares static (a change recompiles there).
LM_STATIC = ("n_steps", "data_term", "trim_fraction", "robust_weights",
             "robust_scale", "tip_vertex_ids", "keypoint_order", "jacobian",
             "normal_eq", "pose_space", "n_pca", "fit_trans")


class LMResult(NamedTuple):
    pose: torch.Tensor          # [..., 16, 3] recovered axis-angle pose
    shape: torch.Tensor         # [..., S] recovered shape coefficients
    final_loss: torch.Tensor    # [...] final mean-squared residual over ALL
    #   rows: vertex or joint rows per data_term, plus the Tikhonov shape
    #   rows (not comparable across data terms or to Adam's data loss).
    loss_history: torch.Tensor  # [..., n_steps]
    damping_history: torch.Tensor  # [..., n_steps] lambda per step
    trans: Optional[torch.Tensor] = None  # [..., 3] when fit_trans


class _Layout:
    """The flat parameter vector's columns: the keys in sorted order (the
    JAX package's ``ravel_pytree`` order), each flattened."""

    def __init__(self, shapes: dict):
        self.shapes = {k: shapes[k] for k in sorted(shapes)}
        self.slices, off = {}, 0
        for k, s in self.shapes.items():
            size = 1
            for n in s:
                size *= n
            self.slices[k] = slice(off, off + size)
            off += size
        self.size = off

    def ravel(self, leaves: dict) -> torch.Tensor:
        return torch.cat([leaves[k].flatten(-len(s))
                          for k, s in self.shapes.items()], dim=-1)

    def unravel(self, flat: torch.Tensor) -> dict:
        lead = flat.shape[:-1]
        return {k: flat[..., self.slices[k]].reshape(*lead, *s)
                for k, s in self.shapes.items()}


def _fit_batched(
    params, target, *, init, frozen_shape, n_steps, init_damping,
    damping_up, damping_down, shape_weight, data_term, trim_fraction,
    robust_weights, robust_scale, tips, keypoint_order, jacobian,
    normal_eq, pose_space, n_pca, fit_trans,
) -> LMResult:
    """B problems, target [B, rows, 3]; ``init`` leaves [B, ...],
    ``frozen_shape`` [B, S] or None."""
    dtype, dev = params.dtype, params.device
    n_b = target.shape[0]
    freeze = frozen_shape is not None
    shapes = solvers._batched_init_shapes(
        pose_space, params.n_joints, n_pca, params.n_shape, fit_trans,
        allowed=frozenset({"aa", "pca"}), freeze_shape=freeze)
    layout = _Layout(shapes)
    leaves = {k: torch.zeros((n_b, *s), dtype=dtype, device=dev)
              for k, s in shapes.items()}
    for k, v in (init or {}).items():
        leaves[k] = torch.as_tensor(v).to(leaves[k])
    flat0 = layout.ravel(leaves)
    n_params = layout.size
    const = frozen_shape

    def unravel(flat, c):
        """The decode (PCA) and the frozen beta live in the unravel, so
        every consumer, the Jacobian's jacfwd included, sees
        {"pose", "shape"}."""
        raw = layout.unravel(flat)
        pose = (core.decode_pca(params, raw["pca"],
                                global_rot=raw["global_rot"])
                if pose_space == "pca" else raw["pose"])
        return {"pose": pose, "shape": c if freeze else raw["shape"]}

    def trans_of(flat):
        return layout.unravel(flat)["trans"] if fit_trans else None

    def values_of(flat, c):
        """(verts, posed_joints) by the active backend's estimator: one
        estimator per run, so the accept test compares like with like."""
        if jacobian == "analytic":
            verts, pj = jacobian_mod.forward_values(params, unravel, flat, c)
        else:
            p = unravel(flat, c)
            out = core.forward_fused_rotmats(
                params, ops.rotation_matrix(p["pose"]), p["shape"])
            verts, pj = out.verts, out.posed_joints
        if fit_trans:
            tr = trans_of(flat)[..., None, :]
            verts, pj = verts + tr, pj + tr
        return verts, pj

    def rows_from(verts, pj, p_shape, corr, tgt):
        """The per-data-term residual rows, shared by the AD path (one
        problem under jacfwd), the analytic path and scoring."""
        if data_term == "points":
            idx, w = corr
            d = torch.take_along_dim(verts, idx[..., None], dim=-2) - tgt
            res = (d * w[..., None]).flatten(-2)
        elif data_term == "point_to_plane":
            idx, normals, w = corr
            d = torch.take_along_dim(verts, idx[..., None], dim=-2) - tgt
            res = torch.sum(d * normals, dim=-1) * w
        else:
            pred = (verts if data_term == "verts"
                    else core.select_keypoints(verts, pj, tips,
                                               keypoint_order))
            res = (pred - tgt).flatten(-2)
        # Tikhonov rows keep beta near 0 when the rows underdetermine it
        # (zero rows at weight 0: a no-op on JtJ/Jtr).
        return torch.cat([res, shape_weight * p_shape], dim=-1)

    def residual(flat, c, tgt, corr):
        verts, pj = values_of(flat, c)
        return rows_from(verts, pj, unravel(flat, c)["shape"], corr, tgt)

    def assignment(flat):
        """Nearest-vertex correspondences of this step, frozen for its
        solve, with trim and IRLS weights per point."""
        verts = values_of(flat, const)[0]
        idx = objectives.nearest_vertex_idx(verts, target)
        d2 = torch.sum((torch.take_along_dim(verts, idx[..., None], dim=-2)
                        - target) ** 2, dim=-1)
        thresh = torch.quantile(d2, 1.0 - trim_fraction, dim=-1,
                                keepdim=True)
        w = (d2 <= thresh).to(dtype)
        if robust_weights != "none":
            d = torch.sqrt(torch.clamp(d2, min=1e-18))
            if robust_scale is None:
                # Robust sigma from the median distance (MAD-to-sigma),
                # floored for near-perfect late fits. The median is the
                # 0.5 quantile (interpolated, as jnp.median).
                sigma = torch.clamp(1.4826 * torch.quantile(
                    d, 0.5, dim=-1, keepdim=True), min=1e-6)
            else:
                sigma = float(robust_scale)
            if robust_weights == "tukey":
                u = d / (4.685 * sigma)
                w_irls = torch.where(u < 1.0, (1.0 - u * u) ** 2,
                                     torch.zeros_like(u))
            else:  # "geman" (Geman-McClure)
                w_irls = 1.0 / (1.0 + (d / sigma) ** 2) ** 2
            w = w * torch.sqrt(w_irls)
        if data_term == "point_to_plane":
            normals = torch.take_along_dim(
                ops.vertex_normals(verts, params.faces), idx[..., None],
                dim=-2)
            return idx, normals, w
        return idx, w

    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def analytic_res_jac(flat, corr):
        """Residual + exact Jacobian without the full forward replay
        (``fitting/jacobian.py``). Rows match ``residual`` exactly."""
        fj = jacobian_mod.forward_with_jacobian(params, unravel, flat, const,
                                                shape_frozen=freeze)
        verts, pj = fj.verts, fj.posed_joints
        if fit_trans:
            tr = trans_of(flat)[..., None, :]
            verts, pj = verts + tr, pj + tr
        res = rows_from(verts, pj, unravel(flat, const)["shape"], corr,
                        target)
        if data_term == "points":
            idx, w = corr
            jac = (torch.take_along_dim(fj.verts_jac, idx[..., None, None],
                                        dim=-3)
                   * w[..., None, None]).reshape(n_b, -1, n_params)
            if fit_trans:
                # d res/d trans for w-scaled point rows: w (x) I3 (the
                # small chain never sees trans, so its columns are zero).
                jac[..., layout.slices["trans"]] += (
                    w[..., None, None] * eye3).reshape(n_b, -1, 3)
        elif data_term == "point_to_plane":
            idx, normals, w = corr
            jac = w[..., None] * einsum(
                "bnc,bncp->bnp", normals,
                torch.take_along_dim(fj.verts_jac, idx[..., None, None],
                                     dim=-3))
            if fit_trans:  # d(n.(x + t - p))/dt = n, w-scaled
                jac[..., layout.slices["trans"]] += normals * w[..., None]
        elif data_term == "verts":
            jac = fj.verts_jac.reshape(n_b, -1, n_params)
            if fit_trans:
                jac[..., layout.slices["trans"]] += eye3.repeat(
                    verts.shape[-2], 1)
        else:  # joints (optionally extended with fingertips)
            _, kp_jac = jacobian_mod.keypoint_jacobian(fj, tips,
                                                       keypoint_order)
            jac = kp_jac.reshape(n_b, -1, n_params)
            if fit_trans:  # every keypoint (joint or tip) translates
                jac[..., layout.slices["trans"]] += eye3.repeat(
                    kp_jac.shape[-3], 1)
        jac = torch.cat([jac, shape_weight * fj.shape_jac], dim=-2)
        return res, jac

    def loss_of(flat):
        # A fresh assignment when scoring (ICP's true objective is the
        # chamfer, not the residual under a stale correspondence).
        corr = assignment(flat) if data_term in _ICP_TERMS else None
        r = residual(flat, const, target, corr)
        return (r * r).mean(dim=-1)

    def ad_jacobian(flat, corr):
        dims = (0, None if const is None else 0, 0,
                None if corr is None else 0)
        return torch.func.vmap(torch.func.jacfwd(residual), in_dims=dims)(
            flat, const, target, corr)

    reg = 1e-9 * torch.eye(n_params, dtype=dtype, device=dev)
    flat = flat0
    damping = torch.full((n_b,), float(init_damping), dtype=dtype,
                         device=dev)
    history, dhist = [], []
    for _ in range(n_steps):
        corr = assignment(flat) if data_term in _ICP_TERMS else None
        if jacobian == "analytic":
            r, jac = analytic_res_jac(flat, corr)
        else:
            r = residual(flat, const, target, corr)
            jac = ad_jacobian(flat, corr)                   # [B, R, P]
        jq, rq = ((round_bf16(jac), round_bf16(r)) if normal_eq == "bf16"
                  else (jac, r))
        jtj = einsum("brp,brq->bpq", jq, jq)                # [B, P, P]
        jtr = einsum("brp,br->bp", jq, rq)
        a = (jtj + damping[:, None, None]
             * torch.diag_embed(torch.diagonal(jtj, dim1=-2, dim2=-1))
             + reg)
        # Batched LU; solve_ex leaves its status on the device (solve
        # would read it back every step). The 1e-9 I keeps A regular.
        delta = torch.linalg.solve_ex(a, jtr[..., None])[0][..., 0]
        candidate = flat - delta
        old = (r * r).mean(dim=-1)
        new = loss_of(candidate)
        accept = new < old
        flat = torch.where(accept[:, None], candidate, flat)
        damping = torch.clamp(
            torch.where(accept, damping * damping_down,
                        damping * damping_up), 1e-10, 1e8)
        history.append(torch.where(accept, new, old))
        dhist.append(damping)
    p_fin = unravel(flat, const)

    def stacked(xs):
        return (torch.stack(xs, dim=-1) if xs
                else flat.new_zeros((n_b, 0)))

    return LMResult(
        pose=p_fin["pose"],
        shape=p_fin["shape"],
        final_loss=loss_of(flat),
        loss_history=stacked(history),
        damping_history=stacked(dhist),
        trans=trans_of(flat),
    )


@solvers.normalize_tips_kwarg
def fit_lm(
    params,
    target_verts,               # [V, 3] or [B, V, 3] ([J, 3] joints;
                                # [N, 3] points)
    n_steps: int = 30,
    init_damping: float = 1e-3,
    damping_up: float = 10.0,
    damping_down: float = 0.3,
    shape_weight: float = 0.0,
    data_term: str = "verts",
    init: Optional[dict] = None,
    trim_fraction: float = 0.0,
    robust_weights: str = "none",
    robust_scale: Optional[float] = None,
    tip_vertex_ids=None,         # None | "smplx" | "manopth" | vertex ids
    keypoint_order: str = "mano",  # "mano" | "openpose"
    jacobian: str = "analytic",  # "analytic" | "ad"
    normal_eq: str = "high",     # "high" | "bf16"
    pose_space: str = "aa",      # "aa" | "pca"
    n_pca: int = 45,
    fit_trans: bool = False,
    frozen_shape=None,           # [S] or [B, S]
) -> LMResult:
    """Recover (pose, shape) by damped Gauss-Newton, one problem or a
    batch. Converges to the numerical floor in tens of steps where Adam
    needs hundreds; the solver of choice for clean targets.

    ``data_term="joints"`` fits 16 posed joints (pair with a nonzero
    ``shape_weight``), extended with fingertips by ``tip_vertex_ids``
    (``keypoint_order="openpose"`` for OpenPose-ordered targets).
    ``"points"`` is point-to-point ICP (nearest-vertex correspondences
    re-assigned every step; warm-start it through ``init``);
    ``trim_fraction`` rejects that fraction of the worst points each
    step, ``robust_weights`` ("tukey" | "geman") reweights them
    continuously (IRLS; ``robust_scale`` pins the scale, default the
    median distance). ``"point_to_plane"`` is the Chen & Medioni
    refinement, a polish stage after a point-to-point fit.

    ``jacobian="ad"`` replays ``torch.func.jacfwd`` of the full residual
    instead of the analytic Jacobian; ``normal_eq="bf16"`` forms JtJ/Jtr
    from bf16 operands; ``pose_space="pca"`` runs GN in the truncated PCA
    space (the returned pose is decoded); ``fit_trans=True`` adds a
    global translation (``LMResult.trans``); ``frozen_shape`` pins beta
    ([B, S]: one subject per problem) and solves pose only (``init``
    must not seed ``"shape"``).
    """
    if data_term not in ("verts", "joints", "points", "point_to_plane"):
        raise ValueError(
            "fit_lm data_term must be 'verts', 'joints', 'points' or "
            f"'point_to_plane', got {data_term!r}"
        )
    target_verts = solvers._as_target(params, target_verts)
    if data_term in _ICP_TERMS and target_verts.shape[-2] == 0:
        raise ValueError("points target cloud is empty ([..., 0, 3])")
    tips, _ = solvers.check_keypoint_spec(
        params, data_term, tip_vertex_ids, keypoint_order, target_verts,
        "fit_lm")
    if not 0.0 <= float(trim_fraction) < 1.0:
        # A quantile would clamp an out-of-range fraction: 1.0 keeps only
        # the nearest point and returns a garbage fit with a tiny loss.
        raise ValueError(
            f"trim_fraction must be in [0, 1), got {trim_fraction}")
    if trim_fraction and data_term not in _ICP_TERMS:
        raise ValueError(
            "trim_fraction only applies to the ICP data terms "
            f"{_ICP_TERMS}, got data_term={data_term!r}")
    if robust_weights not in ("none", "tukey", "geman"):
        raise ValueError(
            "robust_weights must be 'none', 'tukey' or 'geman', "
            f"got {robust_weights!r}")
    if robust_weights != "none" and data_term not in _ICP_TERMS:
        raise ValueError(
            "robust_weights only applies to the ICP data terms "
            f"{_ICP_TERMS}, got data_term={data_term!r}")
    if robust_scale is not None and float(robust_scale) <= 0:
        raise ValueError(f"robust_scale must be > 0, got {robust_scale}")
    if jacobian not in ("analytic", "ad"):
        raise ValueError(
            f"jacobian must be 'analytic' or 'ad', got {jacobian!r}")
    if normal_eq not in ("high", "bf16"):
        raise ValueError(
            f"normal_eq must be 'high' or 'bf16', got {normal_eq!r}")
    if pose_space not in ("aa", "pca"):
        raise ValueError(
            "fit_lm pose_space must be 'aa' or 'pca' (6D adds nothing to "
            f"GN — it optimizes rotations via the chain anyway), got "
            f"{pose_space!r}")
    if pose_space == "pca":
        max_pca = params.pca_basis.shape[0]
        if not 1 <= int(n_pca) <= max_pca:
            raise ValueError(
                f"n_pca must be in [1, {max_pca}], got {n_pca}")
    n_shape = params.n_shape
    if frozen_shape is not None:
        frozen_shape = solvers._as_target(params, frozen_shape)
        if frozen_shape.dim() not in (1, 2) \
                or frozen_shape.shape[-1] != n_shape:
            raise ValueError(
                f"frozen_shape must be [{n_shape}] (or [B, {n_shape}] for "
                f"batched problems), got {tuple(frozen_shape.shape)}")
    run = functools.partial(
        _fit_batched, params, n_steps=n_steps, init_damping=init_damping,
        damping_up=damping_up, damping_down=damping_down,
        shape_weight=shape_weight, data_term=data_term,
        trim_fraction=trim_fraction, robust_weights=robust_weights,
        robust_scale=robust_scale, tips=tips, keypoint_order=keypoint_order,
        jacobian=jacobian, normal_eq=normal_eq, pose_space=pose_space,
        n_pca=n_pca, fit_trans=fit_trans)
    shapes = solvers._batched_init_shapes(
        pose_space, params.n_joints, n_pca, n_shape, fit_trans=fit_trans,
        freeze_shape=frozen_shape is not None)
    single = target_verts.dim() == 2
    if single:
        if frozen_shape is not None and frozen_shape.dim() != 1:
            raise ValueError(
                "single-problem fit_lm takes one frozen_shape [S], got "
                f"{tuple(frozen_shape.shape)}")
        if init:
            solvers._check_single_init(init, shapes, "")
            init = {k: torch.as_tensor(v)[None] for k, v in init.items()}
        target_verts = target_verts[None]
    elif init:
        solvers.validate_batched_init(init, target_verts.shape[0], shapes,
                                      target_verts.shape, "fit_lm")
    n_b = target_verts.shape[0]
    if frozen_shape is not None:
        if frozen_shape.dim() == 2 and frozen_shape.shape[0] != n_b:
            raise ValueError(
                f"batched frozen_shape has {frozen_shape.shape[0]} rows "
                f"for {n_b} problems")
        frozen_shape = frozen_shape.expand(n_b, n_shape)
    with torch.no_grad():
        res = run(target_verts, init=init, frozen_shape=frozen_shape)
    if single:
        return LMResult(*(None if x is None else x[0] for x in res))
    return res


def fit_lm_bucketed(params, target_verts, *, min_bucket: int = 1,
                    max_bucket: int = 1024, counters=None,
                    init: Optional[dict] = None, **kw) -> LMResult:
    """``fit_lm`` for streams of many small problems with ragged counts:
    the problem batch pads to the nearest power-of-two bucket (pad
    problems repeat problem 0) and every leaf of the ``LMResult`` is
    sliced back to the live problems. All ``fit_lm`` kwargs pass through;
    ``counters`` observes compiles and padding."""
    return solvers.bucketed_fit_call(
        fit_lm, params, target_verts, min_bucket=min_bucket,
        max_bucket=max_bucket, counters=counters, init=init,
        fn_name="fit_lm_bucketed", static=LM_STATIC, **kw)
