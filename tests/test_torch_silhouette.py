"""The port's soft rasterisers (``viz/silhouette.py``) and rasterising fit
terms against the JAX package's.

Same seeded numpy inputs through JAX on the CPU and through the port with
CPU tensors, on the JAX tests' small asset (``synthetic_params(seed=3,
n_verts=64, n_faces=96)``) and once on the full MANO topology (1538
faces). Tolerances: soft silhouette and soft depth values within 1e-5;
their gradients at the JAX tests' relative bar, max|a - b| / max(1,
max|b|) < 1e-4; ``"vmap"`` against ``"map"`` within 1e-6; fits by their
first 20 losses within 1e-4 relative of JAX's history; every invalid
input of ``tests/test_silhouette.py`` raises the exception type JAX
raises, with JAX's message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mano_hand_tpu import fitting as j_fit
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.viz import camera as j_cam
from mano_hand_tpu.viz import silhouette as j_sil
from mano_hand_tpu_torch import fitting
from mano_hand_tpu_torch.assets import params_from_numpy
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.viz import camera, silhouette

CPU = "cpu"
VAL_TOL = 1e-5
GRAD_TOL = 1e-4
HIST_RTOL = 1e-4
STEPS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_np(seed=3, side="right"):
    return jax_synthetic(seed=seed, side=side, n_verts=64, n_faces=96)


@pytest.fixture(scope="module")
def small():
    """(JAX f32 params, port f32 params) of the small asset."""
    p = _small_np()
    return p.astype(np.float32), params_from_numpy(p, device=CPU,
                                                   dtype=torch.float32)


@pytest.fixture(scope="module")
def stacks():
    """The small left/right pair of the JAX two-hand mask tests."""
    left, right = _small_np(seed=4, side="left"), _small_np(seed=3)
    jst = j_core.stack_params(left.astype(np.float32),
                              right.astype(np.float32))
    tst = core.stack_params(
        params_from_numpy(left, device=CPU, dtype=torch.float32),
        params_from_numpy(right, device=CPU, dtype=torch.float32))
    return jst, tst


def _cams(kind):
    """(JAX camera, port camera): weak perspective (the mask tests') or
    the default pinhole framing (the depth tests')."""
    if kind == "weak":
        return (j_cam.WeakPerspectiveCamera(rot=jnp.eye(3, dtype=jnp.float32),
                                            scale=3.0),
                camera.WeakPerspectiveCamera(rot=torch.eye(3), scale=3.0))
    return j_cam.default_hand_camera(), camera.default_hand_camera(device=CPU)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).max())


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def _grad_err(got, want):
    want = _np(want)
    return _err(got, want) / max(1.0, float(np.abs(want).max()))


def _posed(jp, seed, scale=0.3, trans=(0.0, 0.0, 0.0)):
    pose = np.random.default_rng(seed).normal(
        scale=scale, size=(16, 3)).astype(np.float32)
    out = j_core.forward(jp, jnp.asarray(pose), jnp.zeros(10, jnp.float32))
    return np.array(out.verts + jnp.asarray(trans, jnp.float32))


# ------------------------------------------------------------- the renders
@pytest.mark.parametrize("full", [False, True], ids=["small", "mano1538"])
def test_soft_renders_and_gradients_match_jax(full):
    if full:
        jp = jax_synthetic(seed=0).astype(np.float32)
        h = w = 32
    else:
        jp = _small_np().astype(np.float32)
        h, w = 24, 20
    verts = _posed(jp, seed=1)
    faces = np.asarray(jp.faces)
    weights = np.random.default_rng(2).random((h, w)).astype(np.float32)
    jc, tc = _cams("pinhole")
    for name, kw in (("soft_silhouette", dict(sigma=0.7)),
                     ("soft_depth", dict(sigma=1.0, gamma=0.005))):
        j_fn, t_fn = getattr(j_sil, name), getattr(silhouette, name)
        want = j_fn(verts, faces, jc, height=h, width=w, **kw)
        v = torch.from_numpy(verts).requires_grad_(True)
        got = t_fn(v, torch.from_numpy(faces), tc, height=h, width=w, **kw)
        assert got.shape == (h, w)
        assert _err(got, want) <= VAL_TOL, name
        g_want = jax.grad(lambda x: (j_fn(x, faces, jc, height=h, width=w,
                                          **kw) * weights).sum())(
            jnp.asarray(verts))
        g_got, = torch.autograd.grad((got * torch.from_numpy(weights)).sum(),
                                     v)
        assert _grad_err(g_got, g_want) <= GRAD_TOL, name
        assert float(np.abs(_np(g_want)).max()) > 0.0


def test_batch_modes_agree_and_match_jax(small):
    jp, _ = small
    faces = np.asarray(jp.faces)
    batch = np.stack([_posed(jp, seed=s) for s in range(3)])
    jc, tc = _cams("pinhole")
    for name in ("soft_silhouette", "soft_depth"):
        j_fn, t_fn = getattr(j_sil, name), getattr(silhouette, name)
        want = j_fn(batch, faces, jc, height=16, width=16)
        out = {mode: t_fn(torch.from_numpy(batch), faces, tc, height=16,
                          width=16, batch_mode=mode)
               for mode in ("auto", "vmap", "map")}
        assert out["vmap"].shape == (3, 16, 16)
        assert _err(out["vmap"], out["map"]) <= 1e-6
        # On the CPU "auto" maps, one image at a time.
        assert torch.equal(out["auto"], out["map"])
        assert _err(out["map"], want) <= VAL_TOL
        # A leading axis of its own: [2, 3/2...] batches flatten back.
        two = t_fn(torch.from_numpy(batch[:2]).reshape(2, 1, 64, 3), faces,
                   tc, height=16, width=16, batch_mode="vmap")
        assert two.shape == (2, 1, 16, 16)
        with pytest.raises(ValueError, match="batch_mode must be"):
            t_fn(torch.from_numpy(batch), faces, tc, height=16, width=16,
                 batch_mode="loop")


def test_auto_policy_reads_the_device_and_the_slab():
    """``"auto"`` decides on ``verts.device.type`` (JAX reads its default
    backend): a GPU batches while the slab fits 64 MB, else maps."""
    calls = []

    def render(v):
        calls.append(tuple(v.shape))
        return torch.zeros(v.shape[:-2] + (4, 64))

    class Meta:      # a [B, V, 3] batch that claims to live on a GPU
        def __init__(self, b):
            self.t = torch.zeros(b, 5, 3)
            self.shape, self.device = self.t.shape, torch.device("cuda")

        def dim(self):
            return 3

        def reshape(self, shape):
            return self.t.reshape(shape)

    for b, want in ((16, [(16, 5, 3)]), (64, [(5, 3)] * 64)):
        calls.clear()
        out = silhouette._render_batched(render, Meta(b), 1538, 64, 8, 4,
                                         "auto")
        assert out.shape == (b, 4, 64) and calls == want


# --------------------------------------------------- invalid inputs: as JAX
def _invalid_calls(jp, tp, jst, tst):
    """(name, JAX thunk, port thunk) of every invalid input of
    ``tests/test_silhouette.py``."""
    jw, tw = _cams("weak")
    jpin, tpin = _cams("pinhole")
    mask = np.zeros((16, 16), np.float32)
    mask255 = np.zeros((16, 16), np.uint8)
    mask255[4:12, 4:12] = 255
    ones = np.ones((16, 16), np.float32)
    dropout = np.ones((3, 16, 16), np.float32)
    dropout[1] = 0.0
    kp = np.zeros((16, 2), np.float32)
    masks2 = np.zeros((2, 16, 16), np.float32)
    masks2[:, 5:11, 5:11] = 1.0
    verts = np.zeros((3, 64, 3), np.float32)
    tri = np.zeros((4, 3), np.float32)
    tri_f = np.array([[0, 1, 2]], np.int32)
    jbad_scale = j_cam.WeakPerspectiveCamera(rot=jnp.eye(3), scale=0.0)
    tbad_scale = camera.WeakPerspectiveCamera(rot=torch.eye(3), scale=0.0)
    jbad_focal = j_cam.Camera(rot=jnp.eye(3), trans=jnp.asarray([0, 0, 1.0]),
                              focal=0.0)
    tbad_focal = camera.Camera(rot=torch.eye(3),
                               trans=torch.tensor([0, 0, 1.0]), focal=0.0)
    jk = j_cam.from_intrinsics([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], 24,
                               16)
    tk = camera.from_intrinsics([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], 24,
                                16, device=CPU)
    cases = []

    def case(name, fn):
        cases.append((name, lambda: fn(j_fit, jp, jw, jpin, jst, j_sil,
                                       jbad_scale, jbad_focal, jk),
                      lambda: fn(fitting, tp, tw, tpin, tst, silhouette,
                                 tbad_scale, tbad_focal, tk)))

    case("sil_no_camera", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette"))
    case("sil_robust", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=pin, robust="huber",
        n_steps=2))
    case("sil_conf", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=pin,
        target_conf=np.ones(16, np.float32), n_steps=2))
    case("sil_255", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask255, data_term="silhouette", camera=pin, n_steps=2))
    case("sil_255_sequence", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_sequence(p, np.stack([mask255] * 2), data_term="silhouette",
                        camera=pin, n_steps=2))
    case("sil_255_positional", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_sequence(p, np.stack([mask255] * 2), 2, 0.03, "silhouette",
                        pin))
    case("sil_sigma_zero", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=pin, sil_sigma=0.0,
        n_steps=2))
    case("camera_scale_zero", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=bs, n_steps=2))
    case("camera_focal_zero", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=bf, n_steps=2))
    case("intrinsics_resolution", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit(p, mask, data_term="silhouette", camera=k, n_steps=2))
    case("render_sigma_negative", lambda m, p, w, pin, st, sil, bs, bf, k:
         sil.soft_silhouette(tri if m is j_fit else torch.from_numpy(tri),
                             tri_f, pin, height=8, width=8, sigma=-1.0))
    case("render_gamma_zero", lambda m, p, w, pin, st, sil, bs, bf, k:
         sil.soft_depth(tri if m is j_fit else torch.from_numpy(tri), tri_f,
                        pin, height=8, width=8, gamma=0.0))
    case("depth_no_camera", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, ones, data_term="depth", n_steps=2))
    case("depth_no_valid", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="depth", camera=pin, n_steps=2))
    case("depth_conf", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, ones, data_term="depth", camera=pin,
        target_conf=np.ones(16, np.float32), n_steps=2))
    case("depth_multiview", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, np.ones((2, 16, 16), np.float32), data_term="depth",
        camera=(pin, pin), n_steps=2))
    case("depth_weak", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, ones, data_term="depth", camera=w, n_steps=2))
    case("depth_dropout_frame", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_sequence(p, dropout, data_term="depth", camera=pin,
                        n_steps=2))
    case("depth_1d", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, np.ones(16, np.float32), data_term="depth", camera=pin,
        n_steps=2))
    case("multiview_kp2d", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, kp, data_term="keypoints2d", camera=(w, w), n_steps=2))
    case("multiview_views", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, np.zeros((3, 16, 16), np.float32), data_term="silhouette",
        camera=(w, w), n_steps=2))
    case("multiview_empty", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, mask, data_term="silhouette", camera=(), n_steps=2))
    case("multiview_no_views", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit(p, mask, data_term="silhouette", camera=(w, w), n_steps=2))
    case("aux_mask_term", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, verts[0], target_mask=mask, n_steps=2))
    case("aux_mask_255", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, kp, target_mask=mask255, data_term="keypoints2d", camera=w,
        n_steps=2))
    case("aux_mask_count", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit(
        p, np.stack([kp] * 2), target_mask=np.stack([mask] * 3),
        data_term="keypoints2d", camera=w, n_steps=2))
    case("aux_mask_frames", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_sequence(p, np.stack([kp] * 3), data_term="keypoints2d",
                        camera=w, target_mask=np.stack([mask] * 2),
                        n_steps=2))
    case("aux_mask_sequence_term", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_sequence(p, verts, target_mask=np.stack([mask] * 3),
                        n_steps=2))
    case("hands_ambiguous", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_hands_sequence(st, masks2, data_term="silhouette", camera=w,
                              n_steps=2))
    case("hands_mask_layout", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_hands_sequence(st, np.zeros((3, 2, 16, 3), np.float32),
                              mask_layout="combined", n_steps=2))
    case("hands_one_camera", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_hands(st, masks2, data_term="silhouette", camera=(w, w)))
    case("hands_combined_shape", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.fit_hands(st, np.zeros((3, 16, 16), np.float32),
                     data_term="silhouette", camera=w))
    case("hands_255", lambda m, p, w, pin, st, sil, bs, bf, k: m.fit_hands(
        st, masks2 * 255.0, data_term="silhouette", camera=w))
    case("hands_clip_ambiguous", lambda m, p, w, pin, st, sil, bs, bf, k:
         m.track_hands_clip(st, masks2, n_steps=2, data_term="silhouette",
                            camera=w))
    return cases


def test_invalid_inputs_raise_as_jax(small, stacks):
    jp, tp = small
    jst, tst = stacks
    cases = _invalid_calls(jp, tp, jst, tst)
    assert len(cases) == 34
    for name, j_call, t_call in cases:
        with pytest.raises(Exception) as want:
            j_call()
        with pytest.raises(Exception) as got:
            t_call()
        assert got.type is want.type, (name, got.value, want.value)
        # The same message, up to how each side prints a shape.
        strip = str.maketrans("", "", "()[], ")
        msg = str(want.value).split("(shape")[0].split(", got")[0]
        assert msg.translate(strip) in str(got.value).translate(strip), (
            name, str(got.value), str(want.value))


# ------------------------------------------------------------------- fits
def _hist(got, want):
    return _rel(got.loss_history[..., :STEPS], want.loss_history[..., :STEPS])


def _mask(jp, cam, trans, h=24, w=24):
    gt = j_core.forward(jp)
    return np.asarray((j_sil.soft_silhouette(
        gt.verts + jnp.asarray(trans, jnp.float32), jp.faces, cam,
        height=h, width=w, sigma=1.0) > 0.5).astype(jnp.float32))


PRIORS = dict(pose_prior_weight=1.0, shape_prior_weight=1.0)


def test_silhouette_and_multiview_fits_match_jax(small):
    jp, tp = small
    jw, tw = _cams("weak")
    jside = j_cam.WeakPerspectiveCamera(
        rot=j_cam.view_rotation([0.0, np.pi / 2, 0.0]), scale=3.0)
    tside = camera.WeakPerspectiveCamera(
        rot=camera.view_rotation([0.0, np.pi / 2, 0.0], device=CPU),
        scale=3.0)
    kw = dict(n_steps=STEPS, lr=0.01, data_term="silhouette", sil_sigma=1.0,
              fit_trans=True, **PRIORS)
    target = _mask(jp, jw, [0.05, 0.04, 0.0])
    want = j_fit.fit(jp, target, camera=jw, **kw)
    got = fitting.fit(tp, target, camera=tw, **kw)
    assert _hist(got, want) <= HIST_RTOL
    assert float(got.trans[2]) == 0.0      # weak perspective: no z
    multi = np.stack([_mask(jp, c, [0.03, 0.02, 0.04]) for c in (jw, jside)])
    want = j_fit.fit(jp, multi, camera=(jw, jside), **kw)
    got = fitting.fit(tp, multi, camera=[tw, tside], **kw)
    assert _hist(got, want) <= HIST_RTOL
    # Batched multi-view problems: [B, C, H, W].
    got_b = fitting.fit(tp, np.stack([multi, multi[::-1]]),
                        camera=(tw, tside), **kw)
    assert got_b.pose.shape == (2, 16, 3)
    assert _rel(got_b.loss_history[0], got.loss_history) <= 1e-5


def test_two_hand_mask_fits_match_jax(stacks):
    jst, tst = stacks
    jw, tw = _cams("weak")
    true_t = np.array([[-0.08, 0.02, 0.0], [0.08, -0.02, 0.0]], np.float32)
    outs = [np.asarray(j_core.forward(jax.tree_util.tree_map(
        lambda x: x[h], jst)).verts) + true_t[h] for h in range(2)]
    per_hand = np.stack([np.asarray((j_sil.soft_silhouette(
        outs[h], jst.faces[h], jw, height=24, width=24, sigma=1.0) > 0.5
    ).astype(jnp.float32)) for h in range(2)])
    combined = per_hand.max(0)
    init = {"pose": np.zeros((2, 16, 3), np.float32),
            "shape": np.zeros((2, 10), np.float32),
            "trans": true_t + np.array([[0.02, -0.015, 0.0],
                                        [-0.02, 0.015, 0.0]], np.float32)}
    kw = dict(n_steps=STEPS, lr=0.01, data_term="silhouette", sil_sigma=1.0,
              fit_trans=True, init=init, **PRIORS)
    for target in (combined, per_hand):
        want = j_fit.fit_hands(jst, target, camera=jw, **kw)
        got = fitting.fit_hands(tst, target, camera=tw, **kw)
        assert _hist(got, want) <= HIST_RTOL
    clip = np.stack([combined] * 2)
    seq = dict(n_steps=STEPS, data_term="silhouette", mask_layout="combined")
    want = j_fit.fit_hands_sequence(jst, clip, camera=jw, **seq)
    got = fitting.fit_hands_sequence(tst, clip, camera=tw, **seq)
    assert got.pose.shape == (2, 2, 16, 3)
    assert _hist(got, want) <= HIST_RTOL
    poses, _, _ = fitting.track_hands_clip(
        tst, clip, n_steps=2, data_term="silhouette", camera=tw,
        sil_sigma=1.0, mask_layout="combined")
    assert poses.shape == (2, 2, 16, 3)


def test_restarts_accept_masks_and_depth(small):
    """JAX's ``test_restarts_accept_masks`` on the port (its sampled
    restarts are a different random stream, so it is held by outcome)."""
    jp, tp = small
    jw, tw = _cams("weak")
    jpin, tpin = _cams("pinhole")
    mask = _mask(jp, jw, [0.0, 0.0, 0.0])
    kw = dict(n_steps=5, data_term="silhouette", camera=tw, fit_trans=True,
              **PRIORS)
    best, losses = fitting.fit_restarts(tp, mask, n_restarts=3, **kw)
    assert best.pose.shape == (16, 3) and losses.shape == (3,)
    single = fitting.fit(tp, mask, **kw)
    assert float(best.final_loss) <= float(single.final_loss) + 1e-6
    # Restart 0 is the zero pose: the plain fit, as in JAX.
    want = j_fit.fit(jp, mask, **dict(kw, camera=jw))
    assert _rel(single.loss_history, want.loss_history) <= HIST_RTOL
    best2, _ = fitting.fit_restarts(tp, np.stack([mask, mask]), n_restarts=2,
                                    n_steps=3, data_term="silhouette",
                                    camera=(tw, tw), fit_trans=True)
    assert best2.pose.shape == (16, 3)
    gt = core.forward(tp)
    dimg = silhouette.soft_depth(gt.verts, tp.faces, tpin, height=16,
                                 width=16)
    best3, losses3 = fitting.fit_restarts(tp, dimg, n_restarts=2, n_steps=3,
                                          data_term="depth", camera=tpin,
                                          fit_trans=True)
    assert best3.pose.shape == (16, 3) and torch.isfinite(losses3).all()


def test_bucketed_fit_pads_per_problem_masks(small):
    jp, tp = small
    jw, tw = _cams("weak")
    gt = j_core.forward(jp)
    kp2d = np.asarray(jw.project(gt.posed_joints)[..., :2])
    masks = np.stack([_mask(jp, jw, [0.01 * i, 0.0, 0.0], 16, 16)
                      for i in range(3)])
    kw = dict(n_steps=3, data_term="keypoints2d", camera=tw, fit_trans=True)
    direct = fitting.fit(tp, np.stack([kp2d] * 3), target_mask=masks, **kw)
    res = fitting.fit_bucketed(tp, np.stack([kp2d] * 3), target_mask=masks,
                               **kw)
    assert res.pose.shape == (3, 16, 3)
    assert _err(res.loss_history, direct.loss_history) <= 1e-6
