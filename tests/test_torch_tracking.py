"""The port's restarts, streaming trackers, two-hand fits, supervision and
``MANOModel.fit`` against the JAX package's (``fitting/restarts.py``,
``fitting/tracking.py``, ``fitting/hands.py``, ``runtime/supervise.py``,
``models/layer.py``), and ``chip_smoke.py``'s ``fitting`` phase rehearsed
on the CPU at a reduced batch.

Same numpy inputs from a seed on both sides, the synthetic assets in
f32. Adam fits are held by ``loss_history`` within 1e-4 relative of
JAX's over the first 20 steps; LM solves by their result at the floor;
and each by the JAX test's own bar. The restart set is a different
random stream from JAX's (a ``torch.Generator`` where JAX takes a PRNG
key), so restarts are held by outcome and, on their deterministic rows
(the zero pose and the Kabsch seed), against JAX.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from mano_hand_tpu.assets.synthetic import (
    synthetic_pair as jax_pair, synthetic_params as jax_synthetic,
)
from mano_hand_tpu import fitting as j_fit
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.models.layer import MANOModel as JaxMANOModel
from mano_hand_tpu_torch import fitting
from mano_hand_tpu_torch.assets import params_from_numpy
from mano_hand_tpu_torch.models import MANOModel, core
from mano_hand_tpu_torch.runtime import supervise

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


@pytest.fixture(scope="module")
def stacks():
    left, right = jax_pair(seed=0)
    return (j_core.stack_params(left.astype(np.float32),
                                right.astype(np.float32)),
            core.stack_params(params_from_numpy(left, device=CPU),
                              params_from_numpy(right, device=CPU)))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).max())


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def _far_rotated(jp, seed=31, rot=(0.1, 3.0, 0.3)):
    rng = np.random.default_rng(seed)
    pose = np.zeros((16, 3), np.float32)
    pose[0] = rot
    pose[1:] = rng.normal(scale=0.2, size=(15, 3))
    return pose, j_core.forward(jp, jnp.asarray(pose),
                                jnp.zeros(10, jnp.float32))


# ----------------------------------------------------------------- restarts
def test_restarts_deterministic_rows_match_jax(jp, tp):
    """Two restarts leave no sampled row: the zero pose and the Kabsch
    seed. Their solves equal JAX's, and the Kabsch row wins on a target
    rotated ~pi from rest (test_kabsch_seed_wins_on_far_rotation)."""
    _, truth = _far_rotated(jp)
    target = np.asarray(truth.verts)
    want_best, want = j_fit.fit_restarts(jp, jnp.asarray(target),
                                         n_restarts=2, solver="lm",
                                         n_steps=10)
    best, losses = fitting.fit_restarts(tp, target, n_restarts=2,
                                        solver="lm", n_steps=10)
    assert losses.shape == (2,) and int(torch.argmin(losses)) == 1
    assert int(np.argmin(np.asarray(want))) == 1
    assert _err(core.forward(tp, best.pose, best.shape).verts, target) < 1e-4
    assert _err(best.pose, want_best.pose) < 1e-4
    # The zero row is the plain fit, and the plain fit's first 5 steps are
    # JAX's, both to the LM bar, 1e-3: this row descends into the wrong
    # basin, whose later steps part at that level even between JAX's own
    # batched and single runs (1.4e-3 after 10 steps here).
    plain = fitting.fit_lm(tp, target, n_steps=10)
    assert _rel(losses[0], plain.final_loss) < 1e-3
    jplain = j_fit.fit_lm(jp, jnp.asarray(target), n_steps=10)
    assert _rel(plain.loss_history[:5], jplain.loss_history[:5]) < 1e-3
    no_kabsch, losses_no = fitting.fit_restarts(
        tp, target, n_restarts=2, solver="lm", n_steps=10,
        include_kabsch=False)
    assert float(losses_no.min()) > float(losses.min())


def test_restarts_adam_never_worse_and_seeded(jp, tp):
    rng = np.random.default_rng(3)
    target = core.forward(tp, torch.tensor(
        rng.normal(scale=0.1, size=(16, 3)), dtype=torch.float32)).verts
    plain = fitting.fit(tp, target, n_steps=40, lr=0.05)
    best, losses = fitting.fit_restarts(tp, target, n_restarts=4, key=1,
                                        n_steps=40, lr=0.05)
    assert best.pose.shape == (16, 3) and losses.shape == (4,)
    assert float(losses[0]) == pytest.approx(float(plain.final_loss),
                                             rel=1e-5)
    assert float(best.final_loss) <= float(losses[0]) * (1 + 1e-6)
    # The same seed (int or generator) draws the same restarts.
    _, again = fitting.fit_restarts(
        tp, target, n_restarts=4, key=torch.Generator().manual_seed(1),
        n_steps=40, lr=0.05)
    assert _err(again, losses) == 0.0
    # fit_trans: the Kabsch row carries its translation seed (LM).
    pose, truth = _far_rotated(jp, seed=21, rot=(0.2, 2.6, 0.1))
    tr = np.array([0.12, -0.06, 0.2], np.float32)
    best, losses = fitting.fit_restarts(
        tp, np.asarray(truth.verts) + tr, n_restarts=3, solver="lm",
        n_steps=25, fit_trans=True)
    assert float(best.final_loss) < 1e-10
    assert _err(best.trans, tr) < 1e-3


def test_restarts_validation(jp, tp):
    target = core.forward(tp).verts
    for kw, match in ((dict(solver="bfgs"), "solver"),
                      (dict(init={}), "owns init"),
                      (dict(pose_space="pca"), "pose_space"),
                      (dict(n_restarts=0), "n_restarts")):
        with pytest.raises(ValueError, match=match):
            fitting.fit_restarts(tp, target, n_steps=1, **kw)
    with pytest.raises(ValueError, match="ONE problem"):
        fitting.fit_restarts(tp, target[None], n_steps=1)
    # A mask target without a camera: JAX's own ValueError, on both sides.
    for mod, prm in ((j_fit, jp), (fitting, tp)):
        with pytest.raises(ValueError, match="needs a viz.camera.Camera"):
            mod.fit_restarts(prm, np.zeros((8, 8), np.float32), n_steps=1,
                             data_term="silhouette")


# ----------------------------------------------------------------- trackers
def _smooth_clip(jp, t_frames, seed):
    rng = np.random.default_rng(seed)
    end = rng.normal(scale=0.3, size=(16, 3)).astype(np.float32)
    alphas = np.linspace(0.0, 1.0, t_frames, dtype=np.float32)
    return np.asarray(j_core.forward_batched(
        jp, jnp.asarray(alphas[:, None, None] * end),
        jnp.zeros((t_frames, 10), jnp.float32)).verts)


def test_lm_tracker_follows_clip_like_jax(jp, tp):
    """test_tracker_follows_smooth_clip_lm on both sides: the end of the
    clip within 1e-4 m, causal state, the same end pose as JAX."""
    targets = _smooth_clip(jp, 8, 2)
    poses, shapes, state = fitting.track_clip(tp, targets, solver="lm",
                                              n_steps=6)
    jposes, _, jstate = j_fit.track_clip(jp, targets, solver="lm",
                                         n_steps=6)
    assert state.frame == jstate.frame == 8
    assert poses.shape == (8, 16, 3) and shapes.shape == (8, 10)
    end = core.forward(tp, poses[-1], shapes[-1]).verts
    assert _err(end, targets[-1]) < 1e-4
    assert _err(poses[-1], jposes[-1]) < 1e-4


def test_adam_tracker_matches_jax_and_beats_cold(jp, tp):
    """test_tracker_warm_start_beats_cold on both sides, and a fresh
    tracker's first frame (the Kabsch seed, then 25 Adam steps) against
    JAX's history."""
    targets = _smooth_clip(jp, 6, 7)
    for t in range(2):
        state, step = fitting.make_tracker(tp, solver="adam", n_steps=25,
                                           lr=0.05)
        jstate, jstep = j_fit.make_tracker(jp, solver="adam", n_steps=25,
                                           lr=0.05)
        if t == 0:
            _, res = step(state, targets[-1])
            _, jres = jstep(jstate, jnp.asarray(targets[-1]))
            assert _rel(res.loss_history[:20], jres.loss_history[:20]) \
                <= HIST_RTOL
            continue
        for frame in targets:
            state, res = step(state, frame)
            jstate, jres = jstep(jstate, jnp.asarray(frame))
    cold = fitting.fit(tp, targets[-1], n_steps=25, lr=0.05)
    assert float(res.final_loss) < 0.1 * float(cold.final_loss)
    assert float(jres.final_loss) < 0.1 * float(cold.final_loss)


def test_tracker_modes(jp, tp):
    targets = _smooth_clip(jp, 3, 4)
    beta = np.zeros(10, np.float32)
    # frozen betas: pose-only frames, the state carries the constant.
    state, step = fitting.make_tracker(tp, solver="lm", n_steps=4,
                                       frozen_shape=beta)
    for t in range(3):
        state, res = step(state, targets[t])
    assert _err(state.shape, beta) == 0.0
    assert _err(core.forward(tp, state.pose, state.shape).verts,
                targets[-1]) < 1e-4
    # init_pose: the warm start is the caller's, frame-0 Kabsch skipped.
    state, step = fitting.make_tracker(tp, solver="lm", n_steps=1,
                                       init_pose=np.full((16, 3), 0.01))
    assert state.frame == 1 and _err(state.pose, np.full((16, 3), 0.01)) \
        < 1e-7
    # fit_trans + the Kabsch seed with its translation, Adam.
    pose, truth = _far_rotated(jp, seed=5, rot=(0.3, 2.0, -0.4))
    tr = np.array([0.05, 0.02, -0.03], np.float32)
    state, step = fitting.make_tracker(tp, solver="lm", n_steps=10,
                                       fit_trans=True)
    state, res = step(state, np.asarray(truth.verts) + tr)
    assert _err(state.trans, tr) < 1e-4
    for kw, match in ((dict(solver="newton"), "solver"),
                      (dict(solver="lm", pose_space="pca"), "pose_space"),
                      (dict(solver="lm", self_penetration_weight=1.0),
                       "self_penetration_weight"),
                      (dict(solver="lm", joint_limits=(0, 1)),
                       "joint_limits")):
        with pytest.raises(ValueError, match=match):
            fitting.make_tracker(tp, **kw)
    # A mask tracker builds as JAX's does; its first frame without a
    # camera raises JAX's ValueError on both sides.
    jstate, jstep = j_fit.make_tracker(jp, data_term="silhouette")
    state, step = fitting.make_tracker(tp, data_term="silhouette")
    assert state.frame == jstate.frame == 0
    assert tuple(state.pose.shape) == jstate.pose.shape
    assert tuple(state.shape.shape) == jstate.shape.shape
    for stepper, st in ((jstep, jstate), (step, state)):
        with pytest.raises(ValueError, match="needs a viz.camera.Camera"):
            stepper(st, np.zeros((8, 8), np.float32))


def test_supervised_tracker_retries_transient_and_keeps_state(
        tp, monkeypatch):
    targets = core.forward_batched(tp, torch.zeros(2, 16, 3),
                                   torch.zeros(2, 10)).verts
    real = fitting.lm.fit_lm
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("connection reset by peer")
        return real(*a, **kw)

    monkeypatch.setattr(fitting.lm, "fit_lm", flaky)
    state, step = fitting.make_tracker(tp, solver="lm", n_steps=3,
                                       deadline_s=120.0, retries=1)
    state, res = step(state, targets[0])
    assert len(calls) == 2 and state.frame == 1

    def broken(*a, **kw):
        raise ConnectionError("connection refused")

    monkeypatch.setattr(fitting.lm, "fit_lm", broken)
    with pytest.raises(supervise.RetriesExhausted):
        step(state, targets[1])
    assert state.frame == 1     # the caller's state is untouched


# ------------------------------------------------------------------- hands
def _two_hands(jstack, seed, separation=0.12):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.25, size=(2, 16, 3)).astype(np.float32)
    shape = rng.normal(scale=0.5, size=(2, 10)).astype(np.float32)
    out = jax.vmap(lambda prm, p, s: j_core.forward(prm, p, s))(
        jstack, jnp.asarray(pose), jnp.asarray(shape))
    trans = np.array([[0.0, 0, 0], [separation, 0, 0]], np.float32)
    return out, trans


def test_fit_hands_matches_jax_and_recovers_both(stacks):
    jstack, tstack = stacks
    out, trans = _two_hands(jstack, seed=0)
    targets = np.asarray(out.verts) + trans[:, None, :]
    for kw in (dict(fit_trans=True),
               dict(fit_trans=True, repulsion_weight=5.0,
                    pose_prior_weight=1e-3,
                    joint_limits=(-0.6 * np.ones(45, np.float32),
                                  0.6 * np.ones(45, np.float32)))):
        want = j_fit.fit_hands(jstack, jnp.asarray(targets), n_steps=20,
                               **kw)
        got = fitting.fit_hands(tstack, targets, n_steps=20, **kw)
        assert got.pose.shape == (2, 16, 3) and got.trans.shape == (2, 3)
        assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL
    res = fitting.fit_hands(tstack, targets, n_steps=300, lr=0.05,
                            fit_trans=True)
    verts = core.forward_hands(tstack, res.pose[:, None],
                               res.shape[:, None]).verts[:, 0]
    assert _err(verts + res.trans[:, None], targets) < 5e-3
    assert float(res.loss_history[0]) > 100 * float(res.final_loss)


def test_fit_hands_keypoints2d_and_sequence_match_jax(stacks):
    from mano_hand_tpu.viz import camera as j_cam
    from mano_hand_tpu_torch.viz import camera

    jstack, tstack = stacks
    out, trans = _two_hands(jstack, seed=1, separation=0.08)
    jc, tc = j_cam.default_hand_camera(), camera.default_hand_camera(
        device=CPU)
    xy = np.asarray(jc.project(j_core.keypoints(out, "smplx")
                               + trans[:, None, :])[..., :2])
    kw = dict(n_steps=20, lr=0.02, data_term="keypoints2d", fit_trans=True,
              tip_vertex_ids="smplx", pose_prior_weight=1e-4,
              shape_prior_weight=1e-3)
    want = j_fit.fit_hands(jstack, jnp.asarray(xy), camera=jc, **kw)
    got = fitting.fit_hands(tstack, xy, camera=tc, **kw)
    assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL

    rng = np.random.default_rng(6)
    poses = (rng.normal(scale=0.2, size=(2, 16, 3))
             + np.cumsum(rng.normal(scale=0.02, size=(3, 2, 16, 3)), 0)
             ).astype(np.float32)
    outs = jax.vmap(lambda prm, pp, ss: j_core.forward_batched(prm, pp, ss))(
        jstack, jnp.swapaxes(jnp.asarray(poses), 0, 1),
        jnp.zeros((2, 3, 10), jnp.float32))
    targets = np.asarray(jnp.swapaxes(j_core.keypoints(outs, "smplx"), 0, 1))
    kw = dict(n_steps=20, lr=0.04, data_term="joints", fit_trans=True,
              tip_vertex_ids="smplx", repulsion_weight=1.0)
    want = j_fit.fit_hands_sequence(jstack, jnp.asarray(targets), **kw)
    got = fitting.fit_hands_sequence(tstack, targets, **kw)
    assert got.pose.shape == (3, 2, 16, 3) and got.shape.shape == (2, 10)
    assert got.trans.shape == (3, 2, 3)
    assert _rel(got.loss_history, want.loss_history) <= HIST_RTOL


def test_hands_trackers_and_validation(stacks, tp):
    jstack, tstack = stacks
    rng = np.random.default_rng(7)
    poses = (rng.normal(scale=0.15, size=(2, 16, 3))
             + np.cumsum(rng.normal(scale=0.02, size=(3, 2, 16, 3)), 0)
             ).astype(np.float32)
    outs = core.forward_hands(tstack, torch.tensor(poses).transpose(0, 1),
                              torch.zeros(2, 3, 10))
    targets = outs.posed_joints.transpose(0, 1)          # [T, 2, 16, 3]
    p, s, state = fitting.track_hands_clip(
        tstack, targets, n_steps=120, data_term="joints", lr=0.05,
        fit_trans=False)
    assert p.shape == (3, 2, 16, 3) and s.shape == (3, 2, 10)
    assert state.frame == 3
    last = core.forward_hands(tstack, p[-1][:, None], s[-1][:, None])
    assert _err(last.posed_joints[:, 0], targets[-1]) < 5e-3
    with pytest.raises(ValueError, match=r"\[T, 2, rows"):
        fitting.track_hands_clip(tstack, targets[0], n_steps=2)
    with pytest.raises(ValueError, match="cannot pass"):
        fitting.make_hands_tracker(tstack, init={})
    with pytest.raises(ValueError, match="stack_params"):
        fitting.fit_hands(tp, targets[0], n_steps=2, data_term="joints")
    with pytest.raises(ValueError, match="verts/joints/keypoints2d"):
        fitting.fit_hands(tstack, targets[0], n_steps=2, data_term="points")
    with pytest.raises(ValueError, match="frame-major"):
        fitting.fit_hands_sequence(tstack, targets[0], n_steps=2,
                                   data_term="joints")
    # A combined mask with something that is not a camera: JAX's jit
    # refuses the argument with a TypeError, and so does the port.
    for mod, stack in ((j_fit, jstack), (fitting, tstack)):
        with pytest.raises(TypeError):
            mod.fit_hands(stack, np.zeros((8, 8), np.float32), n_steps=2,
                          data_term="silhouette", camera=object())


# -------------------------------------------------------------- supervision
def test_supervised_call_classifies_retries_and_deadlines():
    assert supervise.classify_failure(ValueError()) == supervise.DETERMINISTIC
    assert supervise.classify_failure(ConnectionError()) == \
        supervise.TRANSIENT
    assert supervise.classify_failure(
        RuntimeError("UNAVAILABLE: socket closed")) == supervise.TRANSIENT
    assert supervise.classify_failure(RuntimeError("boom")) == \
        supervise.DETERMINISTIC
    assert supervise.backoff_delay(3, 0.05, 2.0, 0.0) == pytest.approx(0.4)
    assert supervise.backoff_delay(10, 0.05, 2.0, 0.0) == 2.0

    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise TimeoutError("slow")
        return 42

    assert supervise.supervised_call(flaky, retries=2, backoff_s=0.0,
                                     sleep=lambda s: None) == 42
    with pytest.raises(ValueError):
        supervise.supervised_call(lambda: int("x"), retries=5)
    release = threading.Event()
    with pytest.raises(supervise.RetriesExhausted) as info:
        supervise.supervised_call(lambda: release.wait(10), deadline_s=0.05,
                                  retries=1, backoff_s=0.0,
                                  sleep=lambda s: None)
    release.set()
    assert info.value.attempts == 2
    assert isinstance(info.value.cause, supervise.DeadlineExceeded)


# -------------------------------------------------------------- MANOModel.fit
@pytest.mark.parametrize("solver", ["adam", "lm"])
def test_model_fit_adopts_its_solution_like_jax(jp, tp, solver):
    rng = np.random.default_rng(12)
    pose = rng.normal(scale=0.2, size=(16, 3)).astype(np.float32)
    target = np.asarray(j_core.forward(jp, jnp.asarray(pose),
                                       jnp.zeros(10, jnp.float32)).verts)
    kw = {"n_steps": 300, "lr": 0.05} if solver == "adam" else \
        {"n_steps": 20}
    model = MANOModel(tp, backend="torch", device=CPU)
    res = model.fit(target, solver=solver, **kw)
    jm = JaxMANOModel(jax_synthetic(seed=0), backend="jax")
    jres = jm.fit(jnp.asarray(target), solver=solver, **kw)
    assert model.pose.dtype == np.float64
    assert np.array_equal(model.pose, _np(res.pose).astype(np.float64))
    assert np.array_equal(model.shape, _np(res.shape).astype(np.float64))
    bar = 5e-3 if solver == "adam" else 1e-4
    assert _err(model.verts, target) < bar and _err(jm.verts, target) < bar
    assert _err(model.pose, jm.pose) < (1e-2 if solver == "adam" else 1e-4)


def test_model_fit_refusals_and_supervision(tp):
    model = MANOModel(tp, backend="torch", device=CPU)
    target = core.forward(tp, torch.full((16, 3), 0.1)).verts
    for kw, match in ((dict(solver="bfgs"), "solver"),
                      (dict(fit_trans=True), "translation")):
        with pytest.raises(ValueError, match=match):
            model.fit(target, **kw)
    before = model.pose.copy()
    with pytest.raises(ValueError, match="ONE solution"):
        model.fit(target[None].expand(2, -1, -1), solver="lm", n_steps=2)
    assert np.array_equal(model.pose, before)
    res = model.fit(target, solver="lm", n_steps=10, fit_trans=False,
                    deadline_s=120.0, retries=1)
    assert _err(model.verts, target) < 1e-4 and res.pose.shape == (16, 3)


# ------------------------------------------------------------- chip smoke
def test_chip_smoke_fitting_phase_rehearsed_on_the_cpu():
    """The smoke's ``fitting`` phase end to end on the CPU at a reduced
    batch (every gate of the card run; the host-sync check is the card's
    only)."""
    launches = {"K1": 0}
    line = chip_smoke.fitting(torch.device(CPU), lambda: dict(launches),
                              lambda: None, batch=4, steps=300,
                              lm_steps=20, frames=10, cpu_rows=2)
    assert line["phase"] == "fitting" and line["batch"] == 4
    assert line["fit"]["share_within_5mm"] == 1.0
    assert line["fit_lm"]["max_vertex_err_m"] <= chip_smoke.ORACLE_TOL
    for key in ("fit", "fit_lm"):
        assert line[key]["ms_per_step"] > 0
        assert line[key]["problems_per_s"] > 0
    assert line["track"]["lm"]["ms_per_frame"] > 0
    assert line["model_fit"]["pose_adopted"]
    assert line["kernel_launches"] == launches
