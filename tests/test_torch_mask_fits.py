"""The port's depth and auxiliary-mask fit terms against the JAX
package's: ``fit``/``fit_sequence``/``make_tracker`` with
``data_term="depth"`` and ``keypoints2d`` with ``target_mask``.

The helpers, assets and tolerances of ``test_torch_silhouette.py``: the
first 20 losses of each fit within 1e-4 relative of JAX's history, the
same seeded numpy inputs through JAX on the CPU and through the port with
CPU tensors.
"""

import numpy as np
import torch

import jax.numpy as jnp

from mano_hand_tpu import fitting as j_fit
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.viz import silhouette as j_sil
from mano_hand_tpu_torch import fitting
from test_torch_silhouette import (  # noqa: F401 (fixtures)
    HIST_RTOL, PRIORS, STEPS, _cams, _hist, _mask, _np, _one_thread, _rel,
    small,
)


def test_depth_fit_sequence_and_tracker_match_jax(small):
    jp, tp = small
    jpin, tpin = _cams("pinhole")
    gt = j_core.forward(jp)
    # 32 px, as JAX's depth recovery test: at lower resolutions a depth
    # fit's two f32 trajectories can part past step 8, when a boundary
    # pixel's coverage flips on one side only.
    depth = np.asarray(j_sil.soft_depth(
        gt.verts + jnp.asarray([0.02, 0.015, 0.03]), jp.faces, jpin,
        height=32, width=32, sigma=1.0))
    depth = np.where(depth > 5.0, 0.0, depth).astype(np.float32)
    kw = dict(n_steps=STEPS, lr=0.01, data_term="depth", sil_sigma=1.0,
              fit_trans=True, **PRIORS)
    want = j_fit.fit(jp, depth, camera=jpin, **kw)
    got = fitting.fit(tp, depth, camera=tpin, **kw)
    assert _hist(got, want) <= HIST_RTOL
    huber = dict(kw, robust="huber", robust_scale=0.05)
    want = j_fit.fit(jp, depth, camera=jpin, **huber)
    got = fitting.fit(tp, depth, camera=tpin, **huber)
    assert _hist(got, want) <= HIST_RTOL
    # Frames displaced from the rest pose: the tracker's frame 0 starts
    # at the rest pose, and a frame it already fits exactly has a zero
    # gradient whose Adam steps are rounding noise on either side.
    frames = np.stack([np.asarray(j_sil.soft_depth(
        gt.verts + jnp.asarray([0.01 * t, 0.0, 0.01 * t]), jp.faces, jpin,
        height=16, width=16, sigma=1.0)) for t in range(1, 4)])
    seq = dict(n_steps=STEPS, data_term="depth", fit_trans=True)
    want = j_fit.fit_sequence(jp, frames, camera=jpin, **seq)
    got = fitting.fit_sequence(tp, frames, camera=tpin, **seq)
    assert got.pose.shape == (3, 16, 3)
    assert _hist(got, want) <= HIST_RTOL
    trk = dict(n_steps=STEPS, data_term="depth", fit_trans=True,
               sil_sigma=1.0)
    jstate, jstep = j_fit.make_tracker(jp, camera=jpin, **trk)
    state, step = fitting.make_tracker(tp, camera=tpin, **trk)
    for t in range(2):
        jstate, jout = jstep(jstate, frames[t])
        state, out = step(state, frames[t])
        assert _hist(out, jout) <= HIST_RTOL, t
        # Each frame starts both sides from the port's warm start, so the
        # next frame holds the step itself, not the drift of the last.
        jstate = jstate._replace(pose=jnp.asarray(_np(state.pose)),
                                 shape=jnp.asarray(_np(state.shape)),
                                 trans=jnp.asarray(_np(state.trans)))
    # NaN pixels are invalid, not poison.
    nan = np.ones((16, 16), np.float32)
    nan[:8] = np.nan
    res = fitting.fit(tp, nan, data_term="depth", camera=tpin, n_steps=2)
    assert torch.isfinite(res.final_loss) and torch.isfinite(res.pose).all()


def test_target_mask_fits_match_jax(small):
    jp, tp = small
    jw, tw = _cams("weak")
    true_t = np.array([0.03, 0.02, 0.0], np.float32)
    gt = j_core.forward(jp)
    kp2d = np.asarray(jw.project(gt.posed_joints + true_t)[..., :2]) + 0.05
    mask = _mask(jp, jw, true_t, 32, 32)
    kw = dict(n_steps=STEPS, lr=0.01, data_term="keypoints2d",
              fit_trans=True, target_mask=mask, mask_weight=0.5, **PRIORS)
    want = j_fit.fit(jp, kp2d, camera=jw, **kw)
    got = fitting.fit(tp, kp2d, camera=tw, **kw)
    assert _hist(got, want) <= HIST_RTOL
    # Batched: [B, H, W] masks map per problem, one [H, W] is shared.
    two = np.stack([kp2d, kp2d - 0.05])
    per = dict(kw, target_mask=np.stack([mask, mask[::-1]]))
    want = j_fit.fit(jp, two, camera=jw, **per)
    got = fitting.fit(tp, two, camera=tw, **per)
    assert _hist(got, want) <= HIST_RTOL
    shared = fitting.fit(tp, two, camera=tw, **kw)
    assert _rel(shared.loss_history[0], got.loss_history[0]) <= 1e-5
    seq = dict(n_steps=STEPS, data_term="keypoints2d", fit_trans=True,
               target_mask=np.stack([mask] * 3), mask_weight=0.2)
    want = j_fit.fit_sequence(jp, np.stack([kp2d] * 3), camera=jw, **seq)
    got = fitting.fit_sequence(tp, np.stack([kp2d] * 3), camera=tw, **seq)
    assert _hist(got, want) <= HIST_RTOL
