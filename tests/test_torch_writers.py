"""The port's PNG/GIF/AVI writers (``viz/png.py``, ``viz/avi.py``) and GLB
writers (``io/gltf.py``) against the JAX package's: the same seeded numpy
arrays give the same bytes, tensors (copied to the host once) the same
bytes as their arrays, and every invalid input of ``tests/test_viz.py``
and ``tests/test_gltf.py`` the exception JAX raises."""

import numpy as np
import pytest
import torch

from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.io import gltf as j_gltf
from mano_hand_tpu.viz import avi as j_avi
from mano_hand_tpu.viz import png as j_png
from mano_hand_tpu_torch.io import gltf
from mano_hand_tpu_torch.viz import avi, png


def _frames(seed=0, t=3, h=9, w=7):
    """Float frames, some values outside [0, 1] for the writers to clip."""
    f = np.random.default_rng(seed).uniform(-0.1, 1.1, size=(t, h, w, 3))
    return f.astype(np.float32)


def _same_bytes(tmp_path, name, j_write, t_write, *args, **kw):
    a, b = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    j_write(*[x.numpy() if torch.is_tensor(x) else x for x in args[:1]],
            a, *args[1:], **kw)
    t_write(args[0], b, *args[1:], **kw)
    assert a.read_bytes() == b.read_bytes(), name
    return b


@pytest.mark.parametrize("kind", ["float", "uint8", "gray", "tensor"])
def test_png_and_gif_bytes_equal_jax(tmp_path, kind):
    frames = _frames()
    if kind == "uint8":
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    elif kind == "gray":
        frames = frames[..., 0]
    elif kind == "tensor":
        frames = torch.from_numpy(frames)
    _same_bytes(tmp_path, "x.png", j_png.write_png, png.write_png, frames[0])
    for fps, levels in ((20, 64), (7, 16)):
        _same_bytes(tmp_path, f"x{fps}.gif", j_png.write_gif, png.write_gif,
                    frames, fps=fps, levels=levels)


@pytest.mark.parametrize("kind", ["float", "uint8", "odd_width", "tensor"])
def test_avi_bytes_and_info_equal_jax(tmp_path, kind):
    frames = _frames(w=8 if kind != "odd_width" else 5)
    if kind == "uint8":
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    elif kind == "tensor":
        frames = torch.from_numpy(frames)
    path = _same_bytes(tmp_path, "x.avi", j_avi.write_avi, avi.write_avi,
                       frames, fps=24)
    want, got = j_avi.read_avi_info(path), avi.read_avi_info(path)
    assert np.array_equal(want.pop("first_frame"), got.pop("first_frame"))
    assert got == want and got["n_frames"] == 3


@pytest.mark.parametrize("frames", [np.zeros((0, 4, 4, 3), np.uint8),
                                    np.zeros((4, 4, 3), np.uint8)],
                         ids=["no_frames", "not_4d"])
def test_avi_refuses_as_jax(tmp_path, frames):
    with pytest.raises(ValueError) as want:
        j_avi.write_avi(frames, tmp_path / "a.avi")
    with pytest.raises(ValueError) as got:
        avi.write_avi(frames, tmp_path / "b.avi")
    assert str(got.value) == str(want.value)
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFF1234WAVE")
    for mod in (j_avi, avi):
        with pytest.raises(ValueError, match="not a RIFF/AVI"):
            mod.read_avi_info(bad)


@pytest.fixture(scope="module")
def mesh():
    """A small synthetic mesh, its skinning and a seeded clip."""
    p = jax_synthetic(seed=3, n_verts=64, n_faces=96)
    rng = np.random.default_rng(5)
    verts = (np.asarray(p.v_template)
             + rng.normal(scale=0.01, size=(64, 3))).astype(np.float32)
    joints = rng.normal(scale=0.05, size=(16, 3)).astype(np.float32)
    return dict(
        verts=verts, faces=np.asarray(p.faces), joints=joints,
        parents=tuple(p.parents), weights=np.asarray(p.lbs_weights),
        frames=[verts + 0.01 * t for t in range(3)],
        poses=rng.normal(scale=0.3, size=(4, 16, 3)).astype(np.float32),
        trans=rng.normal(scale=0.05, size=(4, 3)).astype(np.float32),
        colors=rng.random((64, 3)).astype(np.float32),
    )


def _glb_calls(m):
    """(name, maker) of each GLB export; a maker passes every array
    through ``a`` (the identity, or a conversion to a tensor) and returns
    (function name, args, kwargs)."""
    return [
        ("static", lambda a: ("export_glb", (a(m["verts"]), a(m["faces"])),
                              {})),
        ("normals_colors", lambda a: ("export_glb",
                                      (a(m["verts"]), a(m["faces"])),
                                      dict(normals=a(m["verts"] * 2.0),
                                           vertex_colors=a(m["colors"])))),
        ("morph", lambda a: ("export_glb", (a(m["verts"]), a(m["faces"])),
                             dict(morph_frames=[a(f) for f in m["frames"]],
                                  fps=12.0,
                                  vertex_colors=a(m["colors"])))),
        ("skinned", lambda a: ("export_glb_skinned",
                               (a(m["verts"]), a(m["faces"]),
                                a(m["joints"]), m["parents"],
                                a(m["weights"])), {})),
        ("skinned_clip", lambda a: ("export_glb_skinned",
                                    (a(m["verts"]), a(m["faces"]),
                                     a(m["joints"]), m["parents"],
                                     a(m["weights"])),
                                    dict(pose_frames=a(m["poses"]),
                                         trans_frames=a(m["trans"]),
                                         fps=24.0, max_influences=3,
                                         vertex_colors=a(m["colors"])))),
    ]


@pytest.mark.parametrize("call", range(5),
                         ids=["static", "normals_colors", "morph", "skinned",
                              "skinned_clip"])
def test_glb_bytes_equal_jax(tmp_path, mesh, call):
    name, build = _glb_calls(mesh)[call]
    fn, args, kw = build(lambda x: x)
    a, b, c = (tmp_path / f"{k}.glb" for k in ("jax", "port", "tensor"))
    getattr(j_gltf, fn)(*args, a, **kw)
    getattr(gltf, fn)(*args, b, **kw)
    assert a.read_bytes() == b.read_bytes(), name
    # Tensors (the morph frames one stacked tensor) give the same bytes.
    fn, targs, tkw = build(lambda x: torch.from_numpy(np.asarray(x)))
    if "morph_frames" in tkw:
        tkw["morph_frames"] = torch.stack(tkw["morph_frames"])
    getattr(gltf, fn)(*targs, c, **tkw)
    assert c.read_bytes() == a.read_bytes(), name
    want, got = j_gltf.read_glb(a), gltf.read_glb(b)
    assert got == want


def _glb_invalid(m, tmp_path):
    v, f, j, w = m["verts"], m["faces"], m["joints"], m["weights"]
    par, out = m["parents"], tmp_path / "x.glb"
    return [
        ("verts", "export_glb", (v[:, :2], f, out), {}),
        ("morph_shape", "export_glb", (v, f, out),
         dict(morph_frames=[v[:10]])),
        ("morph_empty", "export_glb", (v, f, out), dict(morph_frames=[])),
        ("fps", "export_glb", (v, f, out), dict(morph_frames=[v], fps=0.0)),
        ("colors", "export_glb", (v, f, out), dict(vertex_colors=v[:5])),
        ("parents", "export_glb_skinned", (v, f, j, (0,) * 16, w, out), {}),
        ("weights", "export_glb_skinned", (v, f, j, par, w[:, :8], out), {}),
        ("pose_frames", "export_glb_skinned", (v, f, j, par, w, out),
         dict(pose_frames=np.zeros((2, 16, 2)))),
        ("influences", "export_glb_skinned", (v, f, j, par, w, out),
         dict(max_influences=5)),
        ("trans_frames", "export_glb_skinned", (v, f, j, par, w, out),
         dict(pose_frames=np.zeros((2, 16, 3)),
              trans_frames=np.zeros((3, 3)))),
        ("trans_alone", "export_glb_skinned", (v, f, j, par, w, out),
         dict(trans_frames=np.zeros((3, 3)))),
        ("faces", "export_glb_skinned",
         (v, np.zeros((10, 4), np.uint32), j, par, w, out), {}),
    ]


def test_glb_refuses_as_jax(tmp_path, mesh):
    for name, fn, args, kw in _glb_invalid(mesh, tmp_path):
        with pytest.raises(Exception) as want:
            getattr(j_gltf, fn)(*args, **kw)
        with pytest.raises(Exception) as got:
            getattr(gltf, fn)(*args, **kw)
        assert got.type is want.type and str(got.value) == str(want.value), \
            name
    good = tmp_path / "good.glb"
    gltf.export_glb(mesh["verts"], mesh["faces"], good)
    bad, trunc = tmp_path / "bad.glb", tmp_path / "trunc.glb"
    bad.write_bytes(b"not a glb")
    trunc.write_bytes(good.read_bytes()[:-10])
    for path, match in ((bad, "bad magic"), (trunc, "truncated")):
        for mod in (j_gltf, gltf):
            with pytest.raises(ValueError, match=match):
                mod.read_glb(path)
