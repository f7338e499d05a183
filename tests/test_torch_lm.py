"""The port's analytic Jacobian and Levenberg-Marquardt solver against the
JAX package's (``fitting/jacobian.py``, ``fitting/lm.py``), and the
analytic Jacobian against ``torch.func.jacfwd`` of the full residual.

Same numpy inputs from a seed on both sides, the synthetic asset in f32.
Tolerances: ``forward_values`` and the analytic Jacobian (values and the
[V, 3, P] J) within 1e-5 absolute of JAX's; ``fit_lm`` in every mode with
the same accept pattern over the first 5 steps and ``loss_history``
within 1e-3 relative while it stays above 1e-10 (below that the two
sides' float32 floors differ, about 2e-17 against 4e-17 here, and an
accept there is a coin toss), and both sides under the JAX test's bar.
The sparse-keypoint modes (16 joints; 21 keypoints, "barely
overdetermined" in the JAX test's words) amplify float32 rounding into
the trajectory from the first step, so their loss is held over the first
step, their accepts over five, and the JAX tests' bars on what they
observe.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.fitting import fit_lm as j_fit_lm
from mano_hand_tpu.fitting import jacobian as j_jac
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu_torch import fitting
from mano_hand_tpu_torch.assets import params_from_numpy
from mano_hand_tpu_torch.fitting import jacobian
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.utils.profiling import ServingCounters

TOL = 1e-5
HIST_RTOL = 1e-3
FLOOR = 1e-10
CPU = "cpu"
TIPS = (744, 320, 443, 554, 671)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fits are many small ops: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def jp():
    return jax_synthetic(seed=0).astype(np.float32)


@pytest.fixture(scope="module")
def tp():
    return params_from_numpy(jax_synthetic(seed=0), device=CPU)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).max())


def _unravel(flat, const):
    """The port's {"pose", "shape"} layout of a flat [..., 58] vector (the
    JAX ``ravel_pytree`` order: pose, then shape)."""
    return {"pose": flat[..., :48].unflatten(-1, (16, 3)),
            "shape": flat[..., 48:] if const is None else const}


def _flats(seed, b=3, scale=0.4):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=scale, size=(b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(b, 10)).astype(np.float32)
    return np.concatenate([pose.reshape(b, 48), beta], axis=-1)


# ------------------------------------------------------------- the Jacobian
@pytest.mark.parametrize("seed,scale", [(0, 0.4), (1, 1.2), (2, 0.0)])
def test_forward_with_jacobian_matches_jax(jp, tp, seed, scale):
    """Values and every Jacobian against JAX's analytic ones, at random,
    large and zero poses (the Rodrigues Taylor branch)."""
    flats = _flats(seed, scale=scale)
    _, unravel = ravel_pytree({"pose": jnp.zeros((16, 3), jnp.float32),
                               "shape": jnp.zeros(10, jnp.float32)})
    with torch.no_grad():
        fj = jacobian.forward_with_jacobian(tp, _unravel,
                                            torch.tensor(flats))
        verts, pj = jacobian.forward_values(tp, _unravel,
                                            torch.tensor(flats))
    assert fj.verts_jac.shape == (3, 778, 3, 58)
    assert _err(verts, fj.verts) == 0.0 and _err(pj, fj.posed_joints) == 0.0
    for i, f in enumerate(flats):
        want = j_jac.forward_with_jacobian(jp, unravel, jnp.asarray(f))
        for name in ("verts", "posed_joints", "verts_jac", "joints_jac",
                     "shape_jac"):
            assert _err(getattr(fj, name)[i], getattr(want, name)) <= TOL, \
                name


def test_frozen_shape_and_keypoint_jacobians(jp, tp):
    flats = torch.tensor(_flats(3))
    beta = flats[:, 48:].clone()
    with torch.no_grad():
        full = jacobian.forward_with_jacobian(tp, _unravel, flats)
        frozen = jacobian.forward_with_jacobian(
            tp, _unravel, flats[:, :48], beta, shape_frozen=True)
        kp, kp_jac = jacobian.keypoint_jacobian(full, TIPS, "openpose")
    assert _err(frozen.verts_jac, full.verts_jac[..., :48]) <= 1e-7
    assert float(frozen.shape_jac.abs().max()) == 0.0
    _, unravel = ravel_pytree({"pose": jnp.zeros((16, 3), jnp.float32),
                               "shape": jnp.zeros(10, jnp.float32)})
    want = j_jac.forward_with_jacobian(jp, unravel, jnp.asarray(_np(flats[1])))
    wkp, wjac = j_jac.keypoint_jacobian(want, TIPS, "openpose")
    assert kp.shape == (3, 21, 3) and kp_jac.shape == (3, 21, 3, 58)
    assert _err(kp[1], wkp) <= TOL and _err(kp_jac[1], wjac) <= TOL


@pytest.mark.parametrize("term", ["verts", "joints", "tips_openpose"])
def test_analytic_jacobian_equals_jacfwd_of_the_full_residual(tp, term):
    """The only property that matters for the solver: the assembled
    Jacobian IS the derivative of the residual, by torch's own AD through
    the plain forward."""
    flats = torch.tensor(_flats(4, b=2))

    def rows(f):
        p = _unravel(f, None)
        out = core.forward_rotmats(tp, core.ops.rotation_matrix(p["pose"]),
                                   p["shape"])
        if term == "verts":
            return out.verts
        if term == "joints":
            return out.posed_joints
        return core.select_keypoints(out.verts, out.posed_joints, TIPS,
                                     "openpose")

    with torch.no_grad():
        fj = jacobian.forward_with_jacobian(tp, _unravel, flats)
        want = torch.func.vmap(torch.func.jacfwd(rows))(flats)
        got = {"verts": fj.verts_jac, "joints": fj.joints_jac,
               "tips_openpose": jacobian.keypoint_jacobian(
                   fj, TIPS, "openpose")[1]}[term]
    scale = max(1.0, float(want.abs().max()))
    assert _err(got, want) <= 1e-5 * scale


# ------------------------------------------------------------------ fit_lm
def _lm_case(jp, name):
    rng = np.random.default_rng(1)
    pose = rng.normal(scale=0.25, size=(3, 16, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(3, 10)).astype(np.float32)
    out = j_core.forward_batched(jp, jnp.asarray(pose), jnp.asarray(beta))
    verts = np.asarray(out.verts)
    tr = np.array([0.05, -0.02, 0.1], np.float32)
    near = {"pose": pose[0] + 0.05, "shape": beta[0]}
    cloud = verts[0][::2]
    return {
        "verts_batched": (verts, {}),
        "verts_ad": (verts, {"jacobian": "ad"}),
        "bf16": (verts[0], {"normal_eq": "bf16"}),
        "points": (cloud, {"data_term": "points", "init": near}),
        "point_to_plane": (cloud, {"data_term": "point_to_plane",
                                   "init": near}),
        "trim": (cloud, {"data_term": "points", "init": near,
                         "trim_fraction": 0.1}),
        "tukey": (cloud, {"data_term": "points", "init": near,
                          "robust_weights": "tukey"}),
        "geman": (cloud, {"data_term": "points", "init": near,
                          "robust_weights": "geman", "robust_scale": 0.01}),
        "pca": (verts[0], {"pose_space": "pca", "n_pca": 12}),
        "pca_ad": (verts[0], {"pose_space": "pca", "n_pca": 12,
                              "jacobian": "ad"}),
        "fit_trans": (verts[0] + tr, {"fit_trans": True}),
        "fit_trans_points": (cloud + tr, {
            "data_term": "points", "fit_trans": True,
            "init": {**near, "trans": tr}}),
        "frozen_batched": (verts, {"frozen_shape": beta}),
        "frozen_ad": (verts[0], {"frozen_shape": beta[0], "jacobian": "ad"}),
    }[name]


def _accepts(damping):
    """Accepted steps: the damping falls (x0.3) on accept, rises on
    reject; step 0 against the initial 1e-3."""
    d = np.concatenate([np.full((*damping.shape[:-1], 1), 1e-3), damping],
                       axis=-1)
    return d[..., 1:] < d[..., :-1]


def _hold_lm(got, want, n_hist, n_accept=5):
    """The loss history within 1e-3 relative over the first ``n_hist``
    steps and the same accept pattern over the first ``n_accept``,
    wherever JAX's loss is above the float floor."""
    a = np.asarray(want.loss_history, np.float64)
    b = _np(got.loss_history).astype(np.float64)
    live = a[..., :n_hist] > FLOOR
    assert (np.abs(a - b)[..., :n_hist][live]
            / a[..., :n_hist][live]).max(initial=0.0) <= HIST_RTOL
    prev = (np.concatenate([np.full((*a.shape[:-1], 1), np.inf),
                            a[..., :-1]], axis=-1) > FLOOR)[..., :n_accept]
    ja = _accepts(np.asarray(want.damping_history))[..., :n_accept]
    ta = _accepts(_np(got.damping_history))[..., :n_accept]
    assert np.array_equal(ja[prev], ta[prev])


@pytest.mark.parametrize("name", [
    "verts_batched", "verts_ad", "bf16", "points", "point_to_plane", "trim",
    "tukey", "geman", "pca", "pca_ad", "fit_trans", "fit_trans_points",
    "frozen_batched", "frozen_ad"])
def test_fit_lm_matches_jax(jp, tp, name):
    target, kw = _lm_case(jp, name)
    want = j_fit_lm(jp, jnp.asarray(target), n_steps=8, **kw)
    got = fitting.fit_lm(tp, target, n_steps=8, **kw)
    for leaf in ("pose", "shape", "final_loss", "loss_history",
                 "damping_history"):
        assert getattr(got, leaf).shape == tuple(getattr(want, leaf).shape)
    assert (got.trans is None) == (want.trans is None)
    _hold_lm(got, want, 5)
    # Both sides at the floor of a clean target (PCA: the truncated
    # space's own floor), and on the same solution.
    bar = 1e-4 if name.startswith("pca") else 1e-12
    assert float(np.max(want.final_loss)) < bar
    assert float(got.final_loss.max()) < bar
    assert _err(got.pose, want.pose) <= 1e-3


def test_fit_lm_recovers_batch_like_jax(jp, tp):
    """The JAX test's bar (test_lm_recovers_pose_and_shape_batch): floor
    loss and exact parameters, 25 steps."""
    rng = np.random.default_rng(1)
    pose = rng.normal(scale=0.25, size=(3, 16, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(3, 10)).astype(np.float32)
    target = core.forward_batched(tp, torch.tensor(pose),
                                  torch.tensor(beta)).verts
    res = fitting.fit_lm(tp, target, n_steps=25)
    assert float(res.final_loss.max()) < 1e-12
    assert _err(res.pose, pose) < 1e-4 and _err(res.shape, beta) < 1e-4
    one = fitting.fit_lm(tp, target[1], n_steps=25)
    assert one.pose.shape == (16, 3) and one.loss_history.shape == (25,)
    assert _err(one.pose, res.pose[1]) <= TOL
    assert (np.diff(_np(one.loss_history)) <= 1e-20).all()


@pytest.mark.parametrize("tips", [False, True])
def test_fit_lm_sparse_keypoints_like_jax(jp, tp, tips):
    """16 joints (test_lm_joints_converges_to_floor) and 21 OpenPose
    keypoints (test_fit_lm_21_keypoints): the first step's loss and the
    first 5 accepts against JAX, then the JAX test's bar on the observed
    rows, both sides. (On the 21-keypoint target JAX's own float32 step-1
    loss is 1.2e-3 off a float64 run of the same solve, the port's
    1.2e-4: the 1e-3 history bar cannot hold past the first step.)"""
    rng = np.random.default_rng(4 if tips else 17)
    pose = rng.normal(scale=0.3, size=(16, 3)).astype(np.float32)
    out = j_core.forward(jp, jnp.asarray(pose),
                         jnp.asarray(rng.normal(scale=0.5, size=10)
                                     if tips else np.zeros(10), jnp.float32))
    if tips:
        kw = dict(n_steps=60, data_term="joints", shape_weight=1e-3,
                  tip_vertex_ids="smplx", keypoint_order="openpose")
        target, bar = np.asarray(j_core.keypoints(out, "smplx",
                                                  "openpose")), 2e-3
    else:
        kw = dict(n_steps=25, data_term="joints", shape_weight=0.1)
        target, bar = np.asarray(out.posed_joints), 1e-6
    want = j_fit_lm(jp, jnp.asarray(target), **kw)
    got = fitting.fit_lm(tp, target, **kw)
    _hold_lm(got, want, 1)
    for res, kps in (
            (want, lambda r: j_core.keypoints(
                j_core.forward(jp, r.pose, r.shape), kw.get("tip_vertex_ids"),
                kw.get("keypoint_order", "mano"))),
            (got, lambda r: core.keypoints(
                core.forward(tp, r.pose, r.shape), kw.get("tip_vertex_ids"),
                kw.get("keypoint_order", "mano")))):
        assert _err(kps(res), target) < bar


def test_fit_lm_bucketed_matches_and_reuses(tp):
    rng = np.random.default_rng(5)
    pose = torch.tensor(rng.normal(scale=0.25, size=(3, 16, 3)),
                        dtype=torch.float32)
    targets = core.forward_batched(tp, pose, torch.zeros(3, 10)).verts
    counters = ServingCounters()
    res = fitting.fit_lm_bucketed(tp, targets, min_bucket=4, max_bucket=8,
                                  counters=counters, n_steps=8)
    assert res.pose.shape == (3, 16, 3) and res.loss_history.shape == (3, 8)
    assert res.trans is None and float(res.final_loss.max()) < 1e-4
    first = counters.compiles
    for b in (2, 1, 3):
        r = fitting.fit_lm_bucketed(tp, targets[:b], min_bucket=4,
                                    max_bucket=8, counters=counters,
                                    n_steps=8)
        assert r.pose.shape == (b, 16, 3)
    assert counters.compiles == first and counters.dispatches == 4
    assert counters.rows_padded > 0
    direct = fitting.fit_lm(tp, targets, n_steps=8)
    assert _err(res.pose, direct.pose) <= TOL
    with pytest.raises(ValueError, match="BATCHED problems"):
        fitting.fit_lm_bucketed(tp, targets[0], n_steps=8)


def test_fit_lm_validation_messages(tp):
    verts = core.forward(tp).verts
    cloud = verts[::3]
    bad = [
        (verts, dict(data_term="keypoints2d"), "data_term"),
        (cloud, dict(data_term="points", trim_fraction=1.0),
         "trim_fraction"),
        (verts, dict(trim_fraction=0.1), "ICP data terms"),
        (cloud, dict(data_term="points", robust_weights="cauchy"),
         "robust_weights"),
        (verts, dict(robust_weights="tukey"), "robust_weights"),
        (cloud, dict(data_term="points", robust_weights="tukey",
                     robust_scale=-1.0), "robust_scale"),
        (verts, dict(jacobian="fd"), "jacobian"),
        (verts, dict(normal_eq="fp8"), "normal_eq"),
        (verts, dict(pose_space="6d"), "pose_space"),
        (verts, dict(pose_space="pca", n_pca=0), "n_pca"),
        (verts, dict(frozen_shape=np.zeros(9)), "frozen_shape"),
        (verts, dict(frozen_shape=np.zeros(10), init={"shape": np.zeros(10)}),
         "init keys"),
        (torch.zeros(3, 778, 3), dict(init={"pose": np.zeros((16, 3))}),
         "one seed per problem"),
        (torch.zeros(0, 3), dict(data_term="points"), "empty"),
    ]
    for target, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            fitting.fit_lm(tp, target, n_steps=2, **kw)
