"""The port's hard rasteriser (``viz/render.py``) against the JAX package's.

Same seeded numpy meshes through JAX on the CPU and through the port with
CPU tensors. The hit mask is held pixel for pixel, except for at most
MAX_FLIPS pixels whose hit may flip between the two (XLA may contract a
product and a sum into one FMA where PyTorch rounds twice, moving a
barycentric coordinate by an ulp); each flipped pixel must lie within
EDGE_TOL (barycentric) of some face's edge. Where both renders hit, the
colours agree within COLOUR_TOL. Measured on these inputs: 0 flipped
pixels, colours within 1.8e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.viz import camera as j_cam
from mano_hand_tpu.viz import render as j_render
from mano_hand_tpu_torch.viz import camera, render

CPU = "cpu"
MAX_FLIPS = 3
EDGE_TOL = 1e-5
COLOUR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_verts, n_faces, seed=3, pose_seed=0):
    """A posed synthetic mesh (the JAX forward, f32): (verts, faces)."""
    p = jax_synthetic(seed=seed, n_verts=n_verts,
                      n_faces=n_faces).astype(np.float32)
    pose = np.random.default_rng(pose_seed).normal(
        scale=0.3, size=(16, 3)).astype(np.float32)
    out = j_core.forward(p, jnp.asarray(pose), jnp.zeros(10, jnp.float32))
    return np.array(out.verts), np.array(p.faces)


def _near_edge(px, py, corners) -> bool:
    """Whether pixel centre (px, py) lies within EDGE_TOL (barycentric) of
    an edge of some face: float64 barycentrics of every face."""
    c = corners.astype(np.float64)
    ax, ay, bx, by, cx, cy = (c[:, 0, 0], c[:, 0, 1], c[:, 1, 0],
                              c[:, 1, 1], c[:, 2, 0], c[:, 2, 1])
    d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    ok = np.abs(d) > 1e-12
    d = np.where(ok, d, 1.0)
    l0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / d
    l1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / d
    lam = np.stack([l0, l1, 1.0 - l0 - l1], -1)
    on_edge = (np.abs(lam).min(-1) <= EDGE_TOL) & (lam.min(-1) >= -EDGE_TOL)
    return bool((on_edge & ok).any())


def _screen_corners(verts, faces, cam, height, width):
    proj = np.asarray(cam.project(jnp.asarray(verts)))
    return np.asarray(j_render.ndc_to_pixels(proj[:, :2], height, width))[faces]


def _hold(want, got, bg, corners):
    """The edge-pixel rule; returns the number of flipped pixels."""
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape
    hit_w = np.abs(want - bg).max(-1) > 0
    hit_g = np.abs(got - bg).max(-1) > 0
    flips = np.argwhere(hit_w != hit_g)
    assert len(flips) <= MAX_FLIPS, len(flips)
    for y, x in flips:
        assert _near_edge(x + 0.5, y + 0.5, corners), (y, x)
    both = hit_w & hit_g
    assert np.abs(want[both] - got[both]).max(initial=0.0) <= COLOUR_TOL
    assert np.array_equal(got[~hit_g], np.broadcast_to(bg, got[~hit_g].shape))
    return len(flips)


# (n_verts, n_faces, height, width): the JAX tests' small asset, two odd
# heights (17 rows, a prime: one-row chunks; 45 rows: 15-row chunks) and
# the full MANO topology.
SHAPES = [(64, 96, 48, 40), (64, 96, 17, 24), (64, 96, 45, 32),
          (778, 1538, 32, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_render_mesh_matches_jax(shape):
    n_verts, n_faces, h, w = shape
    verts, faces = _mesh(n_verts, n_faces)
    want = j_render.render_mesh(verts, faces, height=h, width=w)
    got = render.render_mesh(torch.from_numpy(verts), torch.from_numpy(faces),
                             height=h, width=w)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    corners = _screen_corners(verts, faces, j_cam.default_hand_camera(), h, w)
    _hold(want, got, np.ones(3, np.float32), corners)
    assert (np.asarray(want) != 1.0).any()      # the mesh is in frame


@pytest.mark.parametrize("vmax", [None, 0.05, 0.0])
def test_vertex_colors_and_error_colormap_match_jax(vmax):
    verts, faces = _mesh(64, 96, pose_seed=1)
    err = np.linalg.norm(verts - verts.mean(0), axis=-1).astype(np.float32)
    want_c = np.asarray(j_render.error_colormap(err, vmax=vmax))
    got_c = render.error_colormap(torch.from_numpy(err), vmax=vmax)
    assert np.abs(want_c - got_c.numpy()).max() <= 1e-6
    bg = (0.0, 0.0, 0.0)
    want = j_render.render_mesh(verts, faces, height=40, width=36,
                                vertex_colors=want_c, bg_color=bg)
    got = render.render_mesh(torch.from_numpy(verts), faces, height=40,
                             width=36, vertex_colors=got_c, bg_color=bg)
    corners = _screen_corners(verts, faces, j_cam.default_hand_camera(),
                              40, 36)
    _hold(want, got, np.zeros(3, np.float32), corners)


def test_render_sequence_matches_jax_and_its_frames():
    clip = np.stack([_mesh(64, 96, pose_seed=s)[0] for s in range(3)])
    faces = _mesh(64, 96)[1]
    want = j_render.render_sequence(clip, faces, height=24, width=24)
    got = render.render_sequence(torch.from_numpy(clip), faces, height=24,
                                 width=24)
    assert isinstance(got, np.ndarray) and got.shape == (3, 24, 24, 3)
    cam = j_cam.default_hand_camera()
    for t in range(3):
        _hold(want[t], got[t], np.ones(3, np.float32),
              _screen_corners(clip[t], faces, cam, 24, 24))
        # A frame of the clip is that frame alone (several to a pass).
        one = render.render_mesh(torch.from_numpy(clip[t]), faces,
                                 height=24, width=24)
        assert np.array_equal(got[t], one.numpy())


def test_passes_of_any_size_give_the_same_pixels(monkeypatch):
    verts, faces = _mesh(64, 96)
    v = torch.from_numpy(verts)
    whole = render.render_mesh(v, faces, height=40, width=24)
    clip = render.render_sequence(torch.stack([v, v + 0.01]), faces,
                                  height=40, width=24)
    # A budget of one row chunk a pass: 5 passes of 8 rows, one image
    # each.
    monkeypatch.setattr(render, "_SLAB_BYTES", 8 * 24 * 96 * 4)
    assert render.pass_rows(2, 40, 24, 96, 8, 4) == (1, 8)
    assert torch.equal(render.render_mesh(v, faces, height=40, width=24),
                       whole)
    assert np.array_equal(render.render_sequence(
        torch.stack([v, v + 0.01]), faces, height=40, width=24), clip)


def test_triangle_coverage_depth_and_colors():
    """JAX's analytic cases (``tests/test_viz.py``) on the port, and the
    port against JAX on them."""
    verts = np.array([
        [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0],   # near
        [-0.1, -0.9, 2.0], [1.7, -0.9, 2.0], [0.8, 0.9, 2.0],   # far
    ], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    jc = j_cam.Camera(rot=jnp.eye(3), trans=jnp.zeros(3), focal=1.0)
    tc = camera.Camera(rot=torch.eye(3), trans=torch.zeros(3), focal=1.0)
    kw = dict(height=64, width=64, base_color=(1.0, 0.0, 0.0),
              bg_color=(0.0, 0.0, 1.0))
    img = render.render_mesh(torch.from_numpy(verts), faces, tc, **kw).numpy()
    assert img[32, 32, 0] > 0.1 and img[32, 32, 2] == 0.0   # the near face
    assert img[2, 2, 2] == 1.0                              # background
    assert img[40, 50, 0] > 0.0 and img[40, 50, 2] == 0.0   # the far face
    want = np.asarray(j_render.render_mesh(verts, faces, jc, **kw))
    _hold(want, img, np.array([0.0, 0.0, 1.0], np.float32),
          _screen_corners(verts, faces, jc, 64, 64))
    tri = verts[:3] * np.array([1.2, 1.2, 1.0], np.float32)
    colors = np.eye(3, dtype=np.float32)
    kw = dict(height=64, width=64, light_dir=(0.0, 0.0, 1.0),
              bg_color=(0.0, 0.0, 0.0))
    img = render.render_mesh(torch.from_numpy(tri), faces[:1], tc,
                             vertex_colors=torch.from_numpy(colors),
                             **kw).numpy()
    assert img[50, 16, 0] > 2.0 * max(img[50, 16, 1], img[50, 16, 2])
    assert img[18, 32, 2] > 2.0 * max(img[18, 32, 0], img[18, 32, 1])
    want = np.asarray(j_render.render_mesh(tri, faces[:1], jc,
                                           vertex_colors=colors, **kw))
    _hold(want, img, np.zeros(3, np.float32),
          _screen_corners(tri, faces[:1], jc, 64, 64))
    with pytest.raises(ValueError, match="vertex_colors must be"):
        render.render_mesh(torch.from_numpy(tri), faces[:1], tc,
                           vertex_colors=torch.eye(4))


def test_raster_helpers_match_jax():
    for h, c in ((20, 8), (100, 8), (7, 8), (13, 8), (256, 16)):
        assert render.best_chunk_rows(h, c) == j_render.best_chunk_rows(h, c)
    xy = np.random.default_rng(2).normal(size=(5, 2)).astype(np.float32)
    assert np.abs(np.asarray(j_render.ndc_to_pixels(xy, 30, 40))
                  - render.ndc_to_pixels(torch.from_numpy(xy), 30,
                                         40).numpy()).max() == 0.0
    for a, b in zip(j_render.chunked_pixel_grid(12, 10, 4, jnp.float32),
                    render.chunked_pixel_grid(12, 10, 4, torch.float32,
                                              CPU)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_renders_follow_the_verts_device():
    """A tensor renders on its own device; host arrays go to ``device``,
    which defaults to ``cuda`` (absent here: it raises, never falls back)."""
    verts, faces = _mesh(64, 96)
    img = render.render_mesh(verts, faces, height=16, width=16, device=CPU)
    assert img.device.type == "cpu"
    assert render.error_colormap(np.ones(3), device=CPU).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            render.render_mesh(verts, faces, height=16, width=16)


def test_chip_smoke_render_phase_rehearsed_on_the_cpu():
    """``chip_smoke.render`` on the CPU at reduced sizes (no recoveries, no
    command-line subprocesses): every gate of the phase holds and no
    kernel is launched."""
    import chip_smoke
    from mano_hand_tpu_torch.ops import fused_forward, fused_posed, fused_skin

    mods = (fused_forward, fused_posed, fused_skin)
    names = ("launches", "blend_skin_launches", "hands_launches",
             "bf16_launches")

    def zero_counts():
        for m in mods:
            for n in names:
                if hasattr(m, n):
                    setattr(m, n, 0)

    def counts():
        return {f"{m.__name__}.{n}": getattr(m, n) for m in mods
                for n in names if hasattr(m, n)}

    line = chip_smoke.render(torch.device(CPU), counts, zero_counts,
                             size=32, frames=3, batch=2, soft=16, steps=3, held=16,
                             recover_steps=0, cli=False)
    assert line["render_mesh"]["flipped_pixels"] == 0
    assert line["render_sequence"]["ends_vs_render_mesh"] == 0.0
    assert line["fit"]["silhouette"]["loss_rel_vs_cpu"] == 0.0
    assert line["glb"]["max_abs_err"] == 0.0
    assert not any(line["kernel_launches"].values())
