"""The port's mesh and array I/O against the JAX package's writers.

For the same float64 arrays the port writes the SAME BYTES: the OBJ
(single mesh, the ``_restpose`` pair, sequences, with and without
normals) and the PLY (binary and ASCII, with and without normals, point
clouds). The port's native writer (``native/objio.cpp`` compiled into
``mano_hand_tpu_torch/_build/``) writes the Python writer's bytes. The
readers give back what the JAX readers give, and checkpoints round-trip
tensors and arrays in both packages.
"""

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.io import checkpoints as jckpt
from mano_hand_tpu.io import obj as jobj
from mano_hand_tpu.io import ply as jply
from mano_hand_tpu_torch.io import checkpoints, native, obj, ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh():
    """(verts [V, 3] f64, rest [V, 3] f64, seq [4, V, 3] f64, faces int32):
    posed-looking float64 meshes, negative and positive coordinates."""
    p = jax_synthetic(seed=0)
    rng = np.random.default_rng(0)
    verts = np.asarray(p.v_template) + rng.normal(scale=0.01, size=(778, 3))
    seq = verts[None] + rng.normal(scale=0.02, size=(4, 778, 3))
    return verts, np.asarray(p.v_template), seq, np.asarray(p.faces)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("with_normals", [False, True])
def test_format_obj_equals_jax(mesh, as_tensor, with_normals):
    verts, _, _, faces = mesh
    normals = jply.vertex_normals_np(verts, faces) if with_normals else None
    want = jobj.format_obj(verts, faces, normals)
    if as_tensor:
        verts, faces = torch.from_numpy(verts), torch.from_numpy(faces)
        normals = None if normals is None else torch.from_numpy(normals)
    assert obj.format_obj(verts, faces, normals) == want


@pytest.mark.parametrize("use_native", [False, True])
def test_export_obj_pair_bytes_equal_jax(mesh, tmp_path, use_native):
    verts, rest, _, faces = mesh
    if use_native:
        assert native.available()
        obj.export_obj(verts, faces, tmp_path / "n.obj", use_native=True)
        jobj.export_obj(verts, faces, tmp_path / "j.obj", use_native=False)
        assert _bytes(tmp_path / "n.obj") == _bytes(tmp_path / "j.obj")
        return
    paths = obj.export_obj_pair(verts, rest, faces, tmp_path / "port.obj")
    jpaths = jobj.export_obj_pair(verts, rest, faces, tmp_path / "jax.obj")
    assert [p.name for p in paths] == ["port.obj", "port_restpose.obj"]
    for a, b in zip(paths, jpaths):
        assert _bytes(a) == _bytes(b)
    text = _bytes(paths[0]).decode().splitlines()
    assert sum(ln.startswith("v ") for ln in text) == 778
    assert sum(ln.startswith("f ") for ln in text) == 1538
    with pytest.raises(ValueError, match="obj"):
        obj.export_obj_pair(verts, rest, faces, tmp_path / "hand.ply")


@pytest.mark.parametrize("use_native", [False, True])
def test_export_obj_sequence_bytes_equal_jax(mesh, tmp_path, use_native):
    _, _, seq, faces = mesh
    got = obj.export_obj_sequence(torch.from_numpy(seq), faces,
                                  tmp_path / "port", use_native=use_native)
    want = jobj.export_obj_sequence(seq, faces, tmp_path / "jax",
                                    use_native=False)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert _bytes(a) == _bytes(b)


def test_native_builds_into_the_port_build_dir(mesh, tmp_path):
    """The port's native library is compiled from ``native/objio.cpp``
    into ``mano_hand_tpu_torch/_build/``; ``native/`` is only read."""
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    assert native.build()
    lib = native.lib_path()
    assert lib.parent == Path(ROOT, "mano_hand_tpu_torch", "_build")
    assert lib.exists() and lib.name.startswith("libmanoio_")
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
    verts, _, _, faces = mesh
    native.write_obj(torch.from_numpy(verts), faces, tmp_path / "a.obj")
    with open(tmp_path / "b.obj", "w") as f:
        f.write(obj.format_obj(verts, faces))
    assert _bytes(tmp_path / "a.obj") == _bytes(tmp_path / "b.obj")
    with pytest.raises(RuntimeError):
        native.write_obj(verts, faces, tmp_path / "missing" / "x.obj")
    with pytest.raises(ValueError, match="normals"):
        obj.export_obj(verts, faces, tmp_path / "c.obj", use_native=True,
                       normals=np.zeros_like(verts))


def test_no_compiler_falls_back_to_python(mesh, tmp_path, monkeypatch):
    """The JAX binding's contract: no compiler, the Python writer."""
    verts, _, seq, faces = mesh
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_SOURCE",
                        native._SOURCE.with_name("absent.cpp"))
    assert not native.available()
    obj.export_obj(verts, faces, tmp_path / "a.obj")
    with pytest.raises(RuntimeError, match="unavailable"):
        obj.export_obj(verts, faces, tmp_path / "b.obj", use_native=True)
    paths = obj.export_obj_sequence(seq, faces, tmp_path / "seq")
    assert len(paths) == 4
    assert _bytes(tmp_path / "a.obj") == jobj.format_obj(
        verts, faces).encode()


def test_read_obj_equals_jax(mesh, tmp_path):
    verts, _, _, faces = mesh
    normals = jply.vertex_normals_np(verts, faces)
    path = tmp_path / "n.obj"
    obj.export_obj(verts, faces, path, normals=normals)
    dialect = tmp_path / "d.obj"
    dialect.write_text(
        "# comment\nv 0 0 0 1 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nf 1/1 2/1 3/1 4/1\nf -4 -2 -1\n")
    for p in (path, dialect):
        got, want = obj.read_obj(p), jobj.read_obj(p)
        assert isinstance(got, ply.PlyMesh)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    back = obj.read_obj(path)
    np.testing.assert_allclose(back.verts, verts, atol=1e-6)
    np.testing.assert_array_equal(back.faces, faces)
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0\n")
    with pytest.raises(ValueError, match="3 components"):
        obj.read_obj(bad)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_normals", [True, False])
@pytest.mark.parametrize("with_faces", [True, False])
def test_export_ply_bytes_equal_jax(mesh, tmp_path, binary, with_normals,
                                    with_faces):
    verts, _, _, faces = mesh
    normals = ply.vertex_normals_np(verts, faces) if with_normals else None
    f = faces if with_faces else None
    got = ply.export_ply(torch.from_numpy(verts), f, tmp_path / "p.ply",
                         normals=normals, binary=binary)
    jply.export_ply(verts, f, tmp_path / "j.ply", normals=normals,
                    binary=binary)
    assert _bytes(got) == _bytes(tmp_path / "j.ply")
    back, jback = ply.read_ply(got), jply.read_ply(got)
    for a, b in zip(back, jback):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(back.verts, verts, atol=1e-6)


def test_ply_validation(tmp_path):
    with pytest.raises(ValueError, match="out of range"):
        ply.export_ply(np.zeros((3, 3)), np.array([[0, 1, 3]]),
                       tmp_path / "x.ply")
    with pytest.raises(ValueError, match="normals shape"):
        ply.export_ply(np.zeros((3, 3)), None, tmp_path / "x.ply",
                       normals=np.zeros((2, 3)))
    (tmp_path / "y.ply").write_bytes(b"nope")
    with pytest.raises(ValueError, match="not a PLY"):
        ply.read_ply(tmp_path / "y.ply")


class _Result(NamedTuple):
    pose: object
    shape: object
    final_loss: object
    pca: object = None


def test_checkpoints_round_trip_in_both_packages(tmp_path):
    rng = np.random.default_rng(1)
    pose = torch.from_numpy(rng.normal(size=(2, 16, 3)).astype(np.float32))
    shape = rng.normal(size=(2, 10))
    path = checkpoints.save_arrays(tmp_path / "bank", pose=pose, shape=shape)
    assert path.name == "bank.npz"
    for load in (checkpoints.load_arrays, jckpt.load_arrays):
        got = load(tmp_path / "bank")
        np.testing.assert_array_equal(got["pose"], pose.numpy())
        np.testing.assert_array_equal(got["shape"], shape)
    res = _Result(pose=pose, shape=torch.from_numpy(shape),
                  final_loss=torch.tensor(0.5))
    out = checkpoints.save_fit_result(res, tmp_path / "fit.npz")
    jout = jckpt.save_fit_result(
        _Result(pose.numpy(), shape, np.float32(0.5)), tmp_path / "jfit.npz")
    got, want = checkpoints.load_fit_result(out), jckpt.load_fit_result(jout)
    assert sorted(got) == sorted(want) == ["final_loss", "pose", "shape"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
