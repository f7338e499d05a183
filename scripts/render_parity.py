#!/usr/bin/env python3
"""Parity of the port's rendering and rasterising fit terms with the JAX
package's, on the CPU: one JSON line of measured differences.

    JAX_PLATFORMS=cpu python3 scripts/render_parity.py

* the hard rasteriser: flipped hit pixels and the largest colour
  difference where both hit, on seeded meshes (the small test asset at
  48 x 40, the full mesh at 32 x 32);
* the soft silhouette and soft depth: the largest value difference and
  the gradient difference at the relative bar max|a - b| / max(1,
  max|b|);
* Adam fits of the depth and silhouette terms: the largest relative
  difference of the first 20 losses from JAX's, with the port's
  ``OptaxAdam`` and with ``torch.optim.Adam`` (what ``fit`` ran before);
* a depth fit of the full mesh at 16, 24 and 32 px: where the two
  trajectories part.

Imports both packages (it compares them); the port itself never imports
JAX.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from mano_hand_tpu import fitting as j_fit  # noqa: E402
from mano_hand_tpu.assets.synthetic import (  # noqa: E402
    synthetic_params as jax_synthetic,
)
from mano_hand_tpu.models import core as j_core  # noqa: E402
from mano_hand_tpu.viz import camera as j_cam  # noqa: E402
from mano_hand_tpu.viz import render as j_render  # noqa: E402
from mano_hand_tpu.viz import silhouette as j_sil  # noqa: E402
from mano_hand_tpu_torch import fitting  # noqa: E402
from mano_hand_tpu_torch.assets import params_from_numpy  # noqa: E402
from mano_hand_tpu_torch.viz import camera, render, silhouette  # noqa: E402


def _assets(full):
    p = jax_synthetic(seed=0) if full else jax_synthetic(
        seed=3, n_verts=64, n_faces=96)
    return p.astype(np.float32), params_from_numpy(p, device="cpu",
                                                   dtype=torch.float32)


def _posed(jp, seed=1):
    pose = np.random.default_rng(seed).normal(
        scale=0.3, size=(16, 3)).astype(np.float32)
    return np.array(j_core.forward(jp, jnp.asarray(pose),
                                   jnp.zeros(10, jnp.float32)).verts)


def hard(full):
    jp, _ = _assets(full)
    verts, faces = _posed(jp), np.asarray(jp.faces)
    h, w = (32, 32) if full else (48, 40)
    want = np.asarray(j_render.render_mesh(verts, faces, height=h, width=w))
    got = render.render_mesh(torch.from_numpy(verts), faces, height=h,
                             width=w).numpy()
    hit_w, hit_g = (np.abs(x - 1.0).max(-1) > 0 for x in (want, got))
    both = hit_w & hit_g
    return {"size": [h, w], "hit_pixels": int(hit_w.sum()),
            "flipped_pixels": int((hit_w != hit_g).sum()),
            "max_abs_err_colour": float(np.abs(want[both]
                                               - got[both]).max())}


def soft(full):
    jp, _ = _assets(full)
    verts, faces = _posed(jp), np.asarray(jp.faces)
    h = w = 32 if full else 24
    wts = np.random.default_rng(2).random((h, w)).astype(np.float32)
    jc, tc = j_cam.default_hand_camera(), camera.default_hand_camera(
        device="cpu")
    out = {}
    for name in ("soft_silhouette", "soft_depth"):
        j_fn, t_fn = getattr(j_sil, name), getattr(silhouette, name)
        want = np.asarray(j_fn(verts, faces, jc, height=h, width=w))
        g_want = np.asarray(jax.grad(lambda x: (j_fn(
            x, faces, jc, height=h, width=w) * wts).sum())(
            jnp.asarray(verts)))
        v = torch.from_numpy(verts).requires_grad_(True)
        got = t_fn(v, torch.from_numpy(faces), tc, height=h, width=w)
        g, = torch.autograd.grad((got * torch.from_numpy(wts)).sum(), v)
        out[name] = {
            "max_abs_err": float(np.abs(got.detach().numpy() - want).max()),
            "grad_rel_err": float(np.abs(g.numpy() - g_want).max()
                                  / max(1.0, np.abs(g_want).max()))}
    return out


def _history_rel(got, want):
    a, b = np.asarray(got.loss_history), np.asarray(want.loss_history)
    return float((np.abs(a - b) / np.abs(b)).max())


def fits():
    jp, tp = _assets(False)
    gt = j_core.forward(jp)
    jpin, tpin = j_cam.default_hand_camera(), camera.default_hand_camera(
        device="cpu")
    jw = j_cam.WeakPerspectiveCamera(rot=jnp.eye(3, dtype=jnp.float32),
                                     scale=3.0)
    tw = camera.WeakPerspectiveCamera(rot=torch.eye(3), scale=3.0)
    depth = np.asarray(j_sil.soft_depth(
        gt.verts + jnp.asarray([0.02, 0.015, 0.03]), jp.faces, jpin,
        height=16, width=16, sigma=1.0))
    depth = np.where(depth > 5.0, 0.0, depth).astype(np.float32)
    mask = np.asarray((j_sil.soft_silhouette(
        gt.verts + jnp.asarray([0.05, 0.04, 0.0]), jp.faces, jw, height=24,
        width=24, sigma=1.0) > 0.5).astype(jnp.float32))
    kw = dict(n_steps=20, lr=0.01, sil_sigma=1.0, fit_trans=True,
              pose_prior_weight=1.0, shape_prior_weight=1.0)
    torch_adam = (lambda leaves: torch.optim.Adam(
        leaves, lr=0.01, betas=(0.9, 0.999), eps=1e-8))
    out = {}
    for term, target, jc, tc in (("depth", depth, jpin, tpin),
                                 ("silhouette", mask, jw, tw)):
        want = j_fit.fit(jp, target, data_term=term, camera=jc, **kw)
        got = fitting.fit(tp, target, data_term=term, camera=tc, **kw)
        kw_opt = {k: v for k, v in kw.items() if k != "lr"}
        old = fitting.fit_with_optimizer(tp, target, torch_adam,
                                         data_term=term, camera=tc,
                                         **kw_opt)
        out[term] = {"size": list(target.shape),
                     "optax_adam_rel": _history_rel(got, want),
                     "torch_optim_adam_rel": _history_rel(old, want)}
    return out


def depth_by_resolution():
    jp, tp = _assets(True)
    pose = np.random.default_rng(0).normal(scale=0.2, size=(16, 3))
    gt = j_core.forward(jp, jnp.asarray(pose, jnp.float32),
                        jnp.zeros(10, jnp.float32))
    jpin, tpin = j_cam.default_hand_camera(), camera.default_hand_camera(
        device="cpu")
    kw = dict(n_steps=20, lr=0.01, data_term="depth", sil_sigma=1.0,
              fit_trans=True, pose_prior_weight=1.0, shape_prior_weight=1.0)
    out = {}
    for px in (16, 24, 32):
        depth = np.array(j_sil.soft_depth(
            gt.verts + jnp.asarray([0.02, 0.01, 0.02]), jp.faces, jpin,
            height=px, width=px, sigma=1.0))
        depth[depth > 5.0] = 0.0
        want = np.asarray(j_fit.fit(jp, depth, camera=jpin,
                                    **kw).loss_history)
        got = fitting.fit(tp, depth, camera=tpin, **kw).loss_history.numpy()
        rel = np.abs(got - want) / np.abs(want)
        out[str(px)] = {"rel_step_8": float(rel[:9].max()),
                        "rel_step_20": float(rel.max())}
    return out


def main() -> int:
    torch.set_num_threads(1)
    print(json.dumps({
        "hard": {"small": hard(False), "mano1538": hard(True)},
        "soft": {"small": soft(False), "mano1538": soft(True)},
        "fits": fits(),
        "depth_full_mesh_by_px": depth_by_resolution(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
