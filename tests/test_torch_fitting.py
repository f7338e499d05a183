"""The port's cameras, objectives, initialisers and Adam solvers against
the JAX package's (``mano_hand_tpu.viz.camera``, ``fitting.objectives``,
``fitting.initialize``, ``fitting.solvers``).

Same numpy inputs from a seed on both sides, the synthetic asset in f32
(``astype(np.float32)`` on the JAX side, ``params_from_numpy`` on the
port's). Tolerances: cameras, objectives and initialisers 1e-5 absolute;
Adam fits' ``loss_history`` within 1e-4 relative of JAX's over their
first 20 steps, and the JAX tests' convergence bars (loss down 100x,
every vertex within 5 mm); batched against single 1e-5, as in JAX. The
rasterising calls the port once refused are held against JAX (more of
them in ``test_torch_silhouette.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.fitting import initialize as j_init
from mano_hand_tpu.fitting import objectives as j_obj
from mano_hand_tpu.fitting import fit as j_fit, fit_sequence as j_fit_sequence
from mano_hand_tpu import fitting as j_fit_mod
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.viz import camera as j_cam
from mano_hand_tpu_torch import fitting
from mano_hand_tpu_torch.assets import params_from_numpy
from mano_hand_tpu_torch.fitting import initialize, objectives
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.utils.profiling import ServingCounters
from mano_hand_tpu_torch.viz import camera

TOL = 1e-5
HIST_RTOL = 1e-4
CPU = "cpu"



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


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def _targets(jp, seed, batch=3, scale=0.3):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=scale, size=(batch, 16, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(batch, 10)).astype(np.float32)
    out = j_core.forward_batched(jp, jnp.asarray(pose), jnp.asarray(beta))
    return pose, beta, out


# ------------------------------------------------------------------ cameras
def _cameras():
    rng = np.random.default_rng(0)
    rot = np.asarray(j_cam.view_rotation([0.2, -0.4, 0.1]))
    k = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    return [
        (j_cam.default_hand_camera(), camera.default_hand_camera(device=CPU)),
        (j_cam.look_at((0.3, 0.2, -0.8), focal=1.7),
         camera.look_at((0.3, 0.2, -0.8), focal=1.7, device=CPU)),
        (j_cam.WeakPerspectiveCamera(jnp.asarray(rot), 2.5,
                                     jnp.asarray([0.1, -0.2])),
         camera.WeakPerspectiveCamera(torch.tensor(rot), 2.5,
                                      torch.tensor([0.1, -0.2]))),
        (j_cam.from_intrinsics(k, 640, 480),
         camera.from_intrinsics(k, 640, 480, device=CPU)),
    ], rng.normal(scale=0.1, size=(2, 21, 3)).astype(np.float32)


def test_cameras_project_like_jax():
    cams, pts = _cameras()
    for jc, tc in cams:
        assert _err(tc.project(torch.tensor(pts)),
                    jc.project(jnp.asarray(pts))) <= TOL
        assert _err(tc.transform(torch.tensor(pts)),
                    jc.transform(jnp.asarray(pts))) <= TOL
    assert _err(camera.view_rotation([0.3, 2.0, -1.0], device=CPU),
                j_cam.view_rotation([0.3, 2.0, -1.0])) <= TOL


def test_intrinsics_pixel_mapping_and_validation():
    k = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    jc = j_cam.from_intrinsics(k, 640, 480)
    tc = camera.from_intrinsics(k, 640, 480, device=CPU)
    uv = np.array([[0.0, 0.0], [319.5, 239.5], [639.0, 479.0]])
    assert _err(tc.pixels_to_ndc(uv), jc.pixels_to_ndc(jnp.asarray(uv))) \
        <= TOL
    assert _err(tc.ndc_to_pixels(tc.pixels_to_ndc(uv)), uv) <= 1e-4
    for bad, match in ((np.eye(2), r"\[3, 3\]"),
                       (np.diag([0.0, 1.0, 1.0]), "fx/fy"),
                       (np.array([[1.0, 0.5, 0], [0, 1, 0], [0, 0, 1]]),
                        "skewed")):
        with pytest.raises(ValueError, match=match):
            camera.from_intrinsics(bad, 64, 64, device=CPU)
    with pytest.raises(ValueError, match="width/height"):
        camera.from_intrinsics(k, 0, 480, device=CPU)


def test_camera_follows_the_verts_and_ignores_tf32():
    """The rotation runs in IEEE fp32 under the caller's "high", and a
    camera moves with ``to`` (the solvers move it once, up front)."""
    cam = camera.default_hand_camera(device=CPU)
    pts = 0.05 * torch.randn(4, 21, 3, dtype=torch.float64)
    want = cam.to(CPU, torch.float64).project(pts)
    assert want.dtype == torch.float64
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = cam.project(pts.float())
    finally:
        torch.set_float32_matmul_precision(prev)
    assert _err(got, want) <= 1e-5


# --------------------------------------------------------------- objectives
def test_objectives_match_jax(jp, tp):
    rng = np.random.default_rng(1)
    a = rng.normal(scale=0.05, size=(2, 40, 3)).astype(np.float32)
    b = rng.normal(scale=0.05, size=(2, 40, 3)).astype(np.float32)
    cloud = rng.normal(scale=0.05, size=(2, 17, 3)).astype(np.float32)
    xy = rng.normal(size=(2, 21, 2)).astype(np.float32)
    xy2 = rng.normal(size=(2, 21, 2)).astype(np.float32)
    conf = rng.uniform(size=(2, 21)).astype(np.float32)
    sil = rng.uniform(size=(2, 8, 9)).astype(np.float32)
    mask = (rng.uniform(size=(2, 8, 9)) > 0.5).astype(np.float32)
    depth = rng.uniform(0.3, 0.6, size=(2, 8, 9)).astype(np.float32)
    sensor = np.where(mask > 0, depth + 0.01, 0.0).astype(np.float32)
    sensor[0, 0, 0] = np.nan
    t = torch.tensor
    j = jnp.asarray

    def hub(sq):
        return objectives.huber(sq, 0.01)

    def jhub(sq):
        return j_obj.huber(sq, 0.01)

    pairs = [
        (objectives.vertex_l2(t(a), t(b)), j_obj.vertex_l2(j(a), j(b))),
        (objectives.vertex_l2(t(a), t(b), hub),
         j_obj.vertex_l2(j(a), j(b), jhub)),
        (objectives.joint_l2(t(a), t(b), hub),
         j_obj.joint_l2(j(a), j(b), jhub)),
        (objectives.point_cloud_l2(t(a), t(cloud)),
         j_obj.point_cloud_l2(j(a), j(cloud))),
        (objectives.nearest_vertex_idx(t(a), t(cloud)),
         j_obj.nearest_vertex_idx(j(a), j(cloud))),
        (objectives.max_vertex_error(t(a), t(b)),
         j_obj.max_vertex_error(j(a), j(b))),
        (objectives.keypoint2d_l2(t(xy), t(xy2)),
         j_obj.keypoint2d_l2(j(xy), j(xy2))),
        (objectives.keypoint2d_l2(t(xy), t(xy2), t(conf), hub),
         j_obj.keypoint2d_l2(j(xy), j(xy2), j(conf), jhub)),
        (objectives.silhouette_iou_loss(t(sil), t(mask)),
         j_obj.silhouette_iou_loss(j(sil), j(mask))),
        (objectives.depth_loss(t(depth), t(sensor), hub),
         j_obj.depth_loss(j(depth), j(sensor), jhub)),
        (objectives.inter_penetration(t(a[0]), t(b[0]), 0.02),
         j_obj.inter_penetration(j(a[0]), j(b[0]), 0.02)),
        (objectives.l2_prior(t(a)), j_obj.l2_prior(j(a))),
    ]
    for got, want in pairs:
        assert got.shape == tuple(want.shape)
        assert _err(got, want) <= TOL


def test_lead_axes_are_per_problem_losses(tp):
    """``lead=1`` keeps one loss per problem: each row equals the scalar
    of that problem alone (JAX's vmap of the scalar form)."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(scale=0.05, size=(3, 40, 3)))
    b = torch.tensor(rng.normal(scale=0.05, size=(3, 40, 3)))
    for fn in (objectives.vertex_l2, objectives.point_cloud_l2):
        rows = fn(a, b, lead=1)
        assert rows.shape == (3,)
        for i in range(3):
            assert float(rows[i]) == pytest.approx(float(fn(a[i], b[i])),
                                                   rel=1e-12)
    ff = torch.tensor(rng.normal(scale=0.5, size=(3, 45)))
    rows = objectives.mahalanobis_pose_prior(tp, ff.float(), lead=1)
    for i in range(3):
        assert float(rows[i]) == pytest.approx(
            float(objectives.mahalanobis_pose_prior(tp, ff[i].float())),
            rel=1e-6)


def test_priors_and_corpus_statistics_match_jax(jp, tp):
    rng = np.random.default_rng(3)
    corpus = rng.normal(scale=0.4, size=(50, 15, 3))
    full = np.concatenate([rng.normal(size=(50, 1, 3)), corpus], axis=1)
    ff = rng.normal(scale=0.5, size=(4, 45)).astype(np.float32)
    for poses in (corpus, full, corpus.reshape(50, 45)):
        var = objectives.pose_component_variances(tp, poses)
        assert _err(var, j_obj.pose_component_variances(jp, poses)) <= TOL
        lo, hi = objectives.pose_limits_from_corpus(tp, poses)
        jlo, jhi = j_obj.pose_limits_from_corpus(jp, poses)
        assert _err(lo, jlo) <= TOL and _err(hi, jhi) <= TOL
    var = np.asarray(j_obj.pose_component_variances(jp, corpus))
    assert _err(objectives.mahalanobis_pose_prior(tp, torch.tensor(ff),
                                                  torch.tensor(var)),
                j_obj.mahalanobis_pose_prior(jp, jnp.asarray(ff),
                                             jnp.asarray(var))) <= TOL
    lo, hi = -0.3 * np.ones(45, np.float32), 0.2 * np.ones(45, np.float32)
    assert _err(objectives.pose_limit_prior(torch.tensor(ff), lo, hi),
                j_obj.pose_limit_prior(jnp.asarray(ff), lo, hi)) <= TOL
    for got, want in zip(objectives.mirror_pose_limits(torch.tensor(lo),
                                                       torch.tensor(hi)),
                         j_obj.mirror_pose_limits(lo, hi)):
        assert _err(got, want) == 0.0


def test_corpus_priors_from_scan_poses_match_jax(jp, tp, tmp_path):
    """The scan-pose bank of an official pickle, read through the port's
    ``assets/scans.py``, feeds ``pose_component_variances`` and
    ``pose_limits_from_corpus``; a Mahalanobis fit with joint limits on
    them matches JAX's over 20 steps."""
    import pickle

    from mano_hand_tpu.assets import scans as j_scans
    from mano_hand_tpu_torch.assets import decode_scan_poses

    hand = jax_synthetic(seed=0)
    raw = {"hands_components": np.asarray(hand.pca_basis),
           "hands_mean": np.asarray(hand.pca_mean),
           "hands_coeffs": np.random.default_rng(13).normal(size=(40, 45))}
    path = tmp_path / "MANO_RIGHT.pkl"
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)
    poses, jposes = decode_scan_poses(path), j_scans.decode_scan_poses(path)
    var = objectives.pose_component_variances(tp, poses)
    assert _err(var, j_obj.pose_component_variances(jp, jposes)) <= TOL
    limits = objectives.pose_limits_from_corpus(tp, poses)
    jlimits = j_obj.pose_limits_from_corpus(jp, jposes)
    assert _err(limits[0], jlimits[0]) <= TOL
    assert _err(limits[1], jlimits[1]) <= TOL
    _, _, out = _targets(jp, seed=14, batch=1)
    target = np.asarray(out.posed_joints[0])
    kw = dict(n_steps=20, data_term="joints", pose_prior="mahalanobis",
              pose_prior_weight=1e-3, joint_limit_weight=10.0)
    want = j_fit(jp, jnp.asarray(target), pose_prior_vars=np.asarray(var),
                 joint_limits=tuple(np.asarray(x) for x in jlimits), **kw)
    got = fitting.fit(tp, target, pose_prior_vars=var, joint_limits=limits,
                      **kw)
    assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL


def test_self_penetration_mask_value_and_gradient_match_jax(jp, tp):
    mask = objectives.self_penetration_mask(tp)
    jmask = np.asarray(j_obj.self_penetration_mask(jp))
    assert mask.dtype == torch.bool and np.array_equal(_np(mask), jmask)
    rng = np.random.default_rng(4)
    pose = rng.normal(scale=0.6, size=(16, 3)).astype(np.float32)
    verts = np.asarray(j_core.forward(jp, jnp.asarray(pose)).verts)
    v = torch.tensor(verts, requires_grad=True)
    e = objectives.self_penetration(v, mask, 0.004)
    e.backward()
    import jax

    je, jg = jax.value_and_grad(
        lambda x: j_obj.self_penetration(x, jnp.asarray(jmask), 0.004))(
        jnp.asarray(verts))
    assert _err(e, je) <= 1e-9 and _err(v.grad, jg) <= 1e-9


# -------------------------------------------------------------- initialisers
def test_rigid_align_matches_jax_and_folds_reflections():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(4, 21, 3)).astype(np.float32)
    rot = np.asarray(j_cam.view_rotation([0.4, -1.2, 2.0]))
    dst = src @ rot.T + np.array([0.1, -0.2, 0.3], np.float32)
    dst[1] = -dst[1]        # a reflected target: still a proper rotation
    r, t = initialize.rigid_align(torch.tensor(src), torch.tensor(dst))
    jr, jt = j_init.rigid_align(jnp.asarray(src), jnp.asarray(dst))
    assert _err(r, jr) <= TOL and _err(t, jt) <= TOL
    assert _err(torch.linalg.det(r), np.ones(4)) <= 1e-5
    assert _err(r[0], rot) <= 1e-5


def test_initializers_match_jax(jp, tp):
    rng = np.random.default_rng(6)
    pose = np.zeros((2, 16, 3), np.float32)
    pose[:, 0] = [[0.1, 2.8, 0.3], [-1.0, 0.4, 0.9]]
    pose[:, 1:] = rng.normal(scale=0.1, size=(2, 15, 3))
    beta = rng.normal(scale=0.5, size=(2, 10)).astype(np.float32)
    out = j_core.forward_batched(jp, jnp.asarray(pose), jnp.asarray(beta))
    kp21 = j_core.keypoints(out, "smplx", "openpose")
    cases = [
        (initialize.initialize_from_joints(tp, _np(out.posed_joints)),
         j_init.initialize_from_joints(jp, out.posed_joints)),
        (initialize.initialize_from_joints(tp, _np(kp21), "smplx",
                                           "openpose", shape=beta),
         j_init.initialize_from_joints(jp, kp21, "smplx", "openpose",
                                       shape=jnp.asarray(beta))),
        (initialize.initialize_from_verts(tp, _np(out.verts)[0]),
         j_init.initialize_from_verts(jp, out.verts[0])),
    ]
    for got, want in cases:
        for k in ("pose", "trans"):
            assert got[k].shape == tuple(want[k].shape)
            assert _err(got[k], want[k]) <= TOL
    with pytest.raises(ValueError, match="tip_vertex_ids"):
        initialize.initialize_from_joints(tp, _np(kp21))
    with pytest.raises(ValueError, match="vertices"):
        initialize.initialize_from_verts(tp, _np(out.posed_joints))


# ------------------------------------------------------------- Adam solvers
def _fit_case(jp, name):
    """(target, kwargs, jax-only kwargs, port-only kwargs) of one case."""
    _, beta, out = _targets(jp, seed=0)
    verts, pj = np.asarray(out.verts), np.asarray(out.posed_joints)
    jc, tc = j_cam.default_hand_camera(), camera.default_hand_camera(
        device=CPU)
    xy = np.asarray(jc.project(out.posed_joints
                               + jnp.asarray([0.03, -0.02, 0.05]))[..., :2])
    lo, hi = -0.5 * np.ones(45, np.float32), 0.5 * np.ones(45, np.float32)
    kp21 = np.asarray(j_core.keypoints(out, "smplx", "openpose"))
    conf = np.linspace(0.2, 1.0, 16).astype(np.float32)
    return {
        "single": (verts[0], {}),
        "batched": (verts, {}),
        "pca": (verts[0], {"pose_space": "pca", "n_pca": 12,
                           "pose_prior_weight": 1e-3}),
        "6d": (verts[0], {"pose_space": "6d", "pose_prior_weight": 1e-3}),
        "joints": (pj[0], {"data_term": "joints",
                           "shape_prior_weight": 1e-3}),
        "joints_21_openpose": (kp21, {"data_term": "joints",
                                      "tip_vertex_ids": "smplx",
                                      "keypoint_order": "openpose"}),
        "keypoints2d": (xy, {"lr": 0.02, "data_term": "keypoints2d",
                             "fit_trans": True, "pose_space": "pca",
                             "n_pca": 15, "pose_prior_weight": 1e-4,
                             "shape_prior_weight": 1e-3, "target_conf": conf,
                             "camera": (jc, tc)}),
        "points": (verts[0][::3], {"data_term": "points",
                                   "shape_prior_weight": 1e-3}),
        "huber": (verts[0], {"robust": "huber", "robust_scale": 0.005}),
        "mahalanobis": (pj[0], {"data_term": "joints",
                                "pose_prior": "mahalanobis",
                                "pose_prior_weight": 1e-3}),
        "joint_limits": (verts[0], {"joint_limits": (lo, hi)}),
        "self_penetration": (verts[0], {"self_penetration_weight": 1.0}),
        "frozen_shape": (verts, {"frozen_shape": beta}),
        "fit_trans_init": (verts[0] + 0.05, {
            "fit_trans": True,
            "init": {"trans": np.full(3, 0.04, np.float32)}}),
    }[name]


@pytest.mark.parametrize("name", [
    "single", "batched", "pca", "6d", "joints", "joints_21_openpose",
    "keypoints2d", "points", "huber", "mahalanobis", "joint_limits",
    "self_penetration", "frozen_shape", "fit_trans_init"])
def test_fit_loss_history_matches_jax(jp, tp, name):
    """Every Adam mode: the first 20 steps' data losses within 1e-4
    relative of JAX's (optax's Adam against torch.optim.Adam, the same
    arithmetic), and the recovered parameters close."""
    target, kw = _fit_case(jp, name)
    jkw, tkw = dict(kw, n_steps=20), dict(kw, n_steps=20)
    if "camera" in kw:
        jkw["camera"], tkw["camera"] = kw["camera"]
    want = j_fit(jp, jnp.asarray(target), **jkw)
    got = fitting.fit(tp, target, **tkw)
    assert got.loss_history.shape == tuple(want.loss_history.shape)
    assert got.final_loss.shape == tuple(want.final_loss.shape)
    assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL
    assert _rel(got.final_loss, want.final_loss) <= HIST_RTOL
    assert _err(got.pose, want.pose) <= 1e-3
    for k in ("pca", "trans"):
        assert (getattr(got, k) is None) == (getattr(want, k) is None)


def test_fit_single_recovers_mesh_like_jax(jp, tp):
    """The JAX test's bar on both sides: loss down 100x, every vertex
    within 5 mm after 300 steps."""
    _, _, out = _targets(jp, seed=11, batch=1)
    target = np.asarray(out.verts[0])
    for res, fwd in (
            (j_fit(jp, jnp.asarray(target), n_steps=300, lr=0.05),
             lambda r: j_core.forward(jp, r.pose, r.shape).verts),
            (fitting.fit(tp, target, n_steps=300, lr=0.05),
             lambda r: core.forward(tp, r.pose, r.shape).verts)):
        assert float(res.loss_history[0]) > 100 * float(res.final_loss)
        assert _err(fwd(res), target) < 5e-3


def test_batched_fit_equals_single_fits(jp, tp):
    """The summed loss gives each problem its own gradient: a batched fit
    equals the single fits (1e-5, the JAX test's bar)."""
    _, _, out = _targets(jp, seed=1, batch=3)
    targets = np.asarray(out.verts)
    res = fitting.fit(tp, targets, n_steps=60, lr=0.05)
    assert res.pose.shape == (3, 16, 3) and res.loss_history.shape == (3, 60)
    for i in (0, 2):
        one = fitting.fit(tp, targets[i], n_steps=60, lr=0.05)
        assert _err(res.pose[i], one.pose) <= TOL
        assert _err(res.loss_history[i], one.loss_history) <= TOL


def test_fit_with_optimizer_takes_a_factory_and_leaves_params_alone(tp):
    params = params_from_numpy(jax_synthetic(seed=0), device=CPU)
    for f in ("v_template", "shape_basis"):
        getattr(params, f).requires_grad_(True)
    target = core.forward(tp, torch.full((16, 3), 0.1)).verts.detach()
    seen = []

    def make(leaves):
        seen.append([tuple(x.shape) for x in leaves])
        return torch.optim.SGD(leaves, lr=1.0)

    res = fitting.fit_with_optimizer(params, target, make, n_steps=30)
    # One problem runs as a batch of one; sorted keys: pose, shape.
    assert seen == [[(1, 16, 3), (1, 10)]]
    assert float(res.final_loss) < float(res.loss_history[0])
    assert params.v_template.grad is None and params.shape_basis.grad is None


def test_fit_sequence_matches_jax(jp, tp):
    rng = np.random.default_rng(7)
    base = rng.normal(scale=0.3, size=(16, 3))
    poses = (base + np.cumsum(rng.normal(scale=0.05, size=(4, 16, 3)), 0)
             ).astype(np.float32)
    targets = j_core.forward_batched(jp, jnp.asarray(poses),
                                     jnp.zeros((4, 10), jnp.float32)).verts
    for kw in ({}, {"pose_space": "6d", "fit_trans": True}):
        want = j_fit_sequence(jp, targets, n_steps=20, **kw)
        got = fitting.fit_sequence(tp, np.asarray(targets), n_steps=20, **kw)
        assert got.pose.shape == (4, 16, 3) and got.shape.shape == (10,)
        assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL
        assert _err(got.pose, want.pose) <= 1e-3
    res = fitting.fit_sequence(tp, np.asarray(targets), n_steps=300,
                               lr=0.05, smooth_pose_weight=1e-4,
                               shape_prior_weight=0.0)
    outs = core.forward_batched(tp, res.pose, res.shape.expand(4, 10))
    assert _err(outs.verts, targets) < 5e-3
    one = fitting.fit_sequence(tp, np.asarray(targets[:1]), n_steps=5)
    assert bool(torch.isfinite(one.loss_history).all())
    with pytest.raises(ValueError, match=r"\[T, rows, coords\]"):
        fitting.fit_sequence(tp, np.asarray(targets[0]), n_steps=2)


def test_fit_bucketed_pads_slices_and_counts(tp):
    rng = np.random.default_rng(8)
    pose = torch.tensor(rng.normal(scale=0.2, size=(3, 16, 3)),
                        dtype=torch.float32)
    targets = core.forward_batched(tp, pose, torch.zeros(3, 10)).verts
    counters = ServingCounters()
    res = fitting.fit_bucketed(tp, targets, max_bucket=8, counters=counters,
                               n_steps=30, lr=0.05)
    assert res.pose.shape == (3, 16, 3) and res.loss_history.shape == (3, 30)
    direct = fitting.fit(tp, targets, n_steps=30, lr=0.05)
    assert _err(res.pose, direct.pose) <= TOL
    first = counters.compiles
    assert first == 1
    for b in (2, 1, 3):     # buckets 2, 1, 4 (4 seen already)
        fitting.fit_bucketed(tp, targets[:b], max_bucket=8,
                             counters=counters, n_steps=30, lr=0.05)
    assert counters.compiles == first + 2 and counters.dispatches == 4
    assert counters.rows_padded == 1 + 0 + 0 + 1
    init = {"pose": _np(res.pose), "shape": _np(res.shape)}
    res2 = fitting.fit_bucketed(tp, targets, max_bucket=8,
                                counters=counters, n_steps=5, lr=0.01,
                                init=init)
    assert float(res2.final_loss.max()) <= max(
        1e-5, 2.0 * float(res.final_loss.max()))
    with pytest.raises(ValueError, match="BATCHED problems"):
        fitting.fit_bucketed(tp, targets[0], n_steps=2)


# ------------------------------------------------------ refusals and checks
@pytest.mark.parametrize("call", ["fit", "fit_target_mask", "fit_sequence",
                                  "fit_with_optimizer", "fit_depth"])
def test_rasterising_terms_name_rendering(jp, tp, call):
    """The five rasterising calls the port refused before it had the soft
    rasteriser, now held against JAX: the same call gives the same loss
    history (first 20 steps within 1e-4 relative) and pose, or the same
    exception (an all-invalid depth image)."""
    import optax

    target = np.zeros((16, 16), np.float32)
    cams = (j_cam.default_hand_camera(),
            camera.default_hand_camera(device=CPU))
    kw = dict(n_steps=20)

    def run(side):
        mod, prm, cam = ((j_fit_mod, jp, cams[0]) if side == "jax"
                         else (fitting, tp, cams[1]))
        if call == "fit":
            return mod.fit(prm, target, data_term="silhouette", camera=cam,
                           **kw)
        if call == "fit_depth":
            return mod.fit(prm, target, data_term="depth", camera=cam,
                           **kw)
        if call == "fit_target_mask":
            return mod.fit(prm, np.zeros((16, 2), np.float32),
                           data_term="keypoints2d", camera=cam,
                           target_mask=target, **kw)
        if call == "fit_sequence":
            return mod.fit_sequence(prm, target[None], data_term="silhouette",
                                    camera=cam, **kw)
        opt = optax.adam(0.1) if side == "jax" else fitting.solvers.adam(0.1)
        return mod.fit_with_optimizer(prm, target, opt,
                                      data_term="silhouette", camera=cam,
                                      **kw)

    if call == "fit_depth":
        for side in ("jax", "torch"):
            with pytest.raises(ValueError, match="no valid"):
                run(side)
        return
    want, got = run("jax"), run("torch")
    assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL
    assert _err(got.pose, want.pose) <= 1e-3


def test_fit_validation_messages(tp):
    verts = core.forward(tp).verts
    bad = [
        (dict(data_term="nope"), "data_term"),
        (dict(pose_space="quaternion"), "pose_space"),
        (dict(data_term="keypoints2d"), "needs a viz.camera.Camera"),
        (dict(target_conf=np.ones(16)), "camera/target_conf"),
        (dict(robust="cauchy"), "robust must be"),
        (dict(robust="huber", robust_scale=np.float32(0.0)), "robust_scale"),
        (dict(init={"pose": np.zeros((3, 16))}), "shape"),
        (dict(init={"bogus": np.zeros(3)}), "not in this parameterization"),
        (dict(pose_space="6d", pose_prior="mahalanobis"), "mahalanobis"),
        (dict(pose_space="6d", joint_limits=(np.zeros(45), np.ones(45))),
         "joint_limits"),
        (dict(frozen_shape=np.zeros(9)), "frozen_shape"),
        (dict(tip_vertex_ids="smplx"), "keypoint data terms"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            fitting.fit(tp, verts, n_steps=1, **kw)
    with pytest.raises(ValueError, match="empty"):
        fitting.fit(tp, torch.zeros(0, 3), n_steps=1, data_term="points")
    batch = torch.zeros(3, 778, 3)
    with pytest.raises(ValueError, match="one seed per problem"):
        fitting.fit(tp, batch, n_steps=1, init={"pose": np.zeros((16, 3))})
    with pytest.raises(ValueError, match="batched frozen_shape"):
        fitting.fit(tp, batch, n_steps=1, frozen_shape=np.zeros((2, 10)))
    with pytest.raises(ValueError, match="21 keypoint|tip_vertex_ids"):
        fitting.fit(tp, torch.zeros(21, 3), n_steps=1, data_term="joints")
