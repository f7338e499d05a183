"""The port's command line (``python -m mano_hand_tpu_torch``) against the
JAX package's ``cli.py``.

Each subcommand runs through both ``main``s in this process, the port's
with ``--device cpu`` (JAX runs on the CPU under the test harness), on
the same input files. Output files are held byte for byte where both
sides write the same arrays (the float64 oracle's meshes, assets,
writers), and otherwise decoded and held within 1e-5 (f32 meshes, float
renders) or, for fits, by their checkpoints (the loss history within
1e-4 relative, as the solvers' parity tests hold it). Every error case
of ``tests/test_cli.py`` for these subcommands exits with JAX's code and
prints JAX's message.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mano_hand_tpu import cli as j_cli
from mano_hand_tpu.assets import save_npz as j_save_npz
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.io.gltf import read_glb
from mano_hand_tpu.models import core as j_core
from mano_hand_tpu.viz import camera as j_cam
from mano_hand_tpu.viz import silhouette as j_sil
from mano_hand_tpu.viz.avi import read_avi_info
from mano_hand_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, args, out_dir=None):
    """Run ``args`` through JAX's CLI then the port's; output paths given as
    ``{out}/name`` land in ``out_dir/jax`` and ``out_dir/port``. Returns
    ((rc, stdout, stderr) of JAX, of the port)."""
    res = []
    for side, main, extra in (("jax", j_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        argv = [a.replace("{out}", str(out_dir / side)) if out_dir else a
                for a in args]
        if out_dir:
            (out_dir / side).mkdir(parents=True, exist_ok=True)
        capsys.readouterr()
        rc = main(extra + argv)
        out, err = capsys.readouterr()
        if out_dir:
            out = out.replace(str(out_dir / side), "{out}")
        res.append((rc, out, err))
    return res


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The input files of ``tests/test_cli.py``'s cases."""
    d = tmp_path_factory.mktemp("cli_inputs")
    p = jax_synthetic(seed=0)
    p32 = p.astype(np.float32)
    rng = np.random.default_rng(0)
    pose = rng.normal(scale=0.2, size=(16, 3)).astype(np.float32)
    out = j_core.forward(p32, jnp.asarray(pose), jnp.zeros(10, jnp.float32))
    verts = np.asarray(out.verts)
    np.save(d / "t.npy", verts)
    np.save(d / "batch.npy", np.stack([verts, verts]))
    np.save(d / "joints.npy", np.asarray(out.posed_joints))
    np.save(d / "cloud.npy", verts[rng.permutation(778)[:200]])
    np.save(d / "bad.npy", np.zeros((5, 3)))
    np.save(d / "kp.npy", np.zeros((16, 2), np.float32))
    np.save(d / "uv.npy", np.full((16, 2), 30.0, np.float32))
    np.save(d / "j.npy", np.zeros((16, 3), np.float32))
    np.save(d / "conf.npy", np.ones(16, np.float32))
    np.save(d / "badconf.npy", np.ones((3, 16), np.float32))
    np.save(d / "v.npy", np.zeros((778, 3), np.float32))
    np.save(d / "mask.npy", np.zeros((32, 32), np.float32))
    np.save(d / "mask16.npy", np.ones((16, 16), np.float32))
    np.save(d / "zero.npy", np.zeros((16, 16), np.float32))
    np.save(d / "vec.npy", np.zeros((16,), np.float32))
    np.save(d / "empty.npy", np.zeros((0, 32), np.float32))
    mask255 = np.zeros((32, 32), np.float32)
    mask255[8:24, 8:24] = 255.0
    np.save(d / "mask255.npy", mask255)
    flat = pose[1:].reshape(45)
    np.savez(d / "lim.npz", lo=flat - 0.3, hi=flat + 0.3)
    np.savez(d / "badlim.npz", lo=flat + 1.0, hi=flat - 1.0)
    np.savez(d / "short.npz", lo=flat[:10], hi=flat[:10])
    np.savez(d / "keys.npz", low=flat)
    np.savez(d / "badinit.npz", pose=np.zeros((16, 3)))
    np.savez(d / "seed.npz", pose=pose)
    from mano_hand_tpu.io.ply import export_ply
    from mano_hand_tpu.viz.png import write_png
    export_ply(np.zeros((5, 3)), None, d / "scan.ply")
    write_png(np.zeros((8, 8, 3)), d / "mask.png")
    j_save_npz(p, d / "hand.npz")
    np.save(d / "poses.npy", rng.normal(scale=0.3, size=(2, 15, 3)))
    cam = j_cam.default_hand_camera()
    # 32 px, as JAX's CLI depth test: at 16-24 px a depth fit of the full
    # mesh parts from JAX's past step 8 (a pixel's coverage flips and the
    # two f32 trajectories separate); at 32 px it stays within 2e-6.
    depth = np.array(j_sil.soft_depth(
        out.verts + jnp.asarray([0.02, 0.01, 0.02]), p32.faces, cam,
        height=32, width=32, sigma=1.0))
    depth[depth > 5.0] = 0.0
    np.save(d / "depth.npy", depth.astype(np.float32))
    wcam = j_cam.WeakPerspectiveCamera(rot=jnp.eye(3, dtype=jnp.float32),
                                       scale=3.0)
    sil = np.asarray(j_sil.soft_silhouette(
        out.verts + jnp.asarray([0.04, 0.03, 0.0]), p32.faces, wcam,
        height=16, width=16, sigma=1.0) > 0.5).astype(np.float32)
    np.save(d / "sil.npy", sil)
    return d


# Error cases of tests/test_cli.py for the ported subcommands (paths
# relative to the ``files`` directory; ``{out}`` is a scratch output).
ERRORS = [
    ["convert", "hand.npz", "{out}/hand.xyz"],
    ["convert", "missing.npz", "{out}/hand.npz"],
    ["convert", "hand.npz", "{out}/hand.pkl", "--mirror"],
    ["fit", "t.npy", "--solver", "lm", "--joint-limits", "lim.npz"],
    ["fit", "t.npy", "--joint-limits", "lim.npz"],
    ["fit", "t.npy", "--solver", "adam", "--joint-limit-weight", "2.0"],
    ["fit", "t.npy", "--solver", "adam", "--joint-limits", "badlim.npz"],
    ["fit", "t.npy", "--solver", "adam", "--joint-limits", "short.npz"],
    ["fit", "t.npy", "--solver", "adam", "--joint-limits", "keys.npz"],
    ["fit", "t.npy", "--solver", "adam", "--pose-space", "6d",
     "--joint-limits", "lim.npz"],
    ["fit", "t.npy", "--solver", "lm", "--pose-space", "6d"],
    ["fit", "cloud.npy", "--data-term", "point_to_plane", "--solver", "adam"],
    ["fit", "cloud.npy", "--data-term", "points", "--trim", "0.1"],
    ["fit", "joints.npy", "--data-term", "joints", "--solver", "lm",
     "--trim", "0.1"],
    ["fit", "cloud.npy", "--data-term", "points", "--solver", "lm",
     "--trim", "1.0"],
    ["fit", "joints.npy", "--data-term", "joints", "--solver", "lm",
     "--robust", "huber"],
    ["fit", "cloud.npy", "--data-term", "points", "--init", "badinit.npz"],
    ["fit", "bad.npy"],
    ["fit", "uv.npy", "--data-term", "keypoints2d", "--camera-k",
     "240,240,32"],
    ["fit", "uv.npy", "--data-term", "keypoints2d", "--camera-size",
     "64x56"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--camera-k",
     "240,240,32,28", "--camera-size", "64x56"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--camera-k",
     "240,240,32,28", "--camera-size", "64x56", "--camera-scale", "2.0"],
    ["fit", "v.npy", "--camera-k", "240,240,32,28", "--camera-size", "64x56"],
    ["fit", "uv.npy", "--data-term", "keypoints2d", "--camera-k",
     "240,240,32,28", "--camera-size", "64x56", "--focal", "5.0"],
    ["fit", "uv.npy", "--data-term", "keypoints2d", "--camera-k",
     "240,240,32,28", "--camera-size", "0x56"],
    ["fit", "zero.npy", "--data-term", "depth"],
    ["fit", "depth.npy", "--data-term", "depth", "--camera-scale", "3.0"],
    ["fit", "depth.npy", "--data-term", "depth", "--solver", "lm"],
    ["fit", "depth.npy", "--data-term", "depth", "--focal", "3.0"],
    ["fit", "mask16.npy", "--data-term", "silhouette", "--camera-eye",
     "0,0,-1"],
    ["fit", "mask16.npy", "--data-term", "silhouette", "--focal", "3.0"],
    ["fit", "j.npy", "--data-term", "joints", "--heatmap", "{out}/e.png"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--solver", "lm"],
    ["fit", "mask.png"],
    ["fit", "mask255.npy", "--data-term", "silhouette"],
    ["fit", "vec.npy", "--data-term", "silhouette"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--robust", "huber"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--camera-rot", "1,2"],
    ["fit", "v.npy", "--sil-sigma", "2.0"],
    ["fit", "scan.ply", "--data-term", "silhouette"],
    ["fit", "empty.npy", "--data-term", "silhouette"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--camera-scale", "0"],
    ["fit", "mask.npy", "--data-term", "silhouette", "--sil-sigma", "-1"],
    ["fit", "kp.npy", "--data-term", "keypoints2d", "--solver", "lm"],
    ["fit", "j.npy", "--data-term", "joints", "--conf", "conf.npy",
     "--steps", "2"],
    ["fit", "kp.npy", "--data-term", "keypoints2d", "--camera-eye", "0,0",
     "--steps", "2"],
    ["fit", "kp.npy", "--data-term", "keypoints2d", "--conf", "badconf.npy",
     "--steps", "2"],
    ["fit", "j.npy", "--data-term", "joints", "--solver", "lm",
     "--pose-prior", "mahalanobis"],
    ["fit", "j.npy", "--data-term", "joints", "--solver", "lm",
     "--pose-prior-weight", "0.01"],
    ["fit", "j.npy", "--data-term", "joints", "--pose-space", "6d",
     "--pose-prior", "mahalanobis"],
    ["fit", "batch.npy", "--solver", "lm", "--restarts", "2"],
    ["fit", "t.npy", "--restarts", "2", "--init", "seed.npz"],
    ["fit", "t.npy", "--solver", "adam", "--pose-space", "6d",
     "--restarts", "2"],
    ["fit", "t.npy", "--solver", "lm", "--pose-space", "pca",
     "--restarts", "2"],
    ["fit", "joints.npy", "--data-term", "joints", "--tips", "smplx"],
    ["fit", "t.npy", "--tips", "smplx"],
    ["fit", "t.npy", "--keypoint-order", "openpose"],
    ["fit", "joints.npy", "--data-term", "joints",
     "--keypoint-order", "openpose"],
]


def test_error_cases_exit_and_print_as_jax(files, capsys, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(files)
    for args in ERRORS:
        (jrc, jout, jerr), (rc, out, err) = _run(capsys, args, tmp_path)
        assert jrc == 2, (args, jrc, jerr)
        assert (rc, out, err) == (jrc, jout, jerr), args


def test_demo_info_and_verify_as_jax(files, capsys, tmp_path):
    # The float64 oracle on both sides: the same bytes.
    for out in ("hand.obj", "hand.ply"):
        (jrc, jout, _), (rc, pout, _) = _run(
            capsys, ["demo", "--backend", "np", "--out", "{out}/" + out],
            tmp_path)
        assert rc == jrc == 0 and pout == jout
        names = [out] + (["hand_restpose.obj"] if out.endswith(".obj")
                         else [])
        for name in names:
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes()), name
    # f32 backends: the same mesh within 1e-5.
    j_cli.main(["demo", "--backend", "jax", "--out",
                str(tmp_path / "j32.obj")])
    assert cli.main(["--device", "cpu", "demo", "--out",
                     str(tmp_path / "t32.obj")]) == 0
    assert _obj_err(tmp_path / "j32.obj", tmp_path / "t32.obj") <= 1e-5
    for args in (["info"], ["info", "--side", "left"],
                 ["verify", str(files / "hand.npz")],
                 ["verify", str(files / "hand.npz"), "--json"],
                 ["verify", str(files / "hand.npz"), "--expect", "0" * 64],
                 ["verify", str(files / "missing.npz")]):
        (jrc, jout, jerr), (rc, out, err) = _run(capsys, args)
        assert (rc, out, err) == (jrc, jout, jerr), args
        if args == ["info"]:
            assert json.loads(out)["n_verts"] == 778


def test_convert_as_jax(files, capsys, tmp_path):
    for args in (["convert", str(files / "hand.npz"), "{out}/hand.pkl"],
                 ["convert", str(files / "hand.npz"), "{out}/hand.npz"],
                 ["convert", str(files / "hand.npz"), "{out}/left.npz",
                  "--mirror"],
                 ["convert", str(files / "hand.npz"),
                  "{out}/mano_left.pkl", "--mirror"]):
        (jrc, jout, jerr), (rc, out, err) = _run(capsys, args, tmp_path)
        assert (rc, out, err) == (jrc, jout, jerr) and rc == 0, args
        name = args[2].split("/")[-1]
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert np.array_equal(x[k], y[k]), (name, k)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def _obj_err(a, b):
    def verts(path):
        return np.array([ln.split()[1:] for ln in Path(path).read_text()
                         .splitlines() if ln.startswith("v ")], float)
    return float(np.abs(verts(a) - verts(b)).max())


def _glb_err(a, b):
    """Two GLBs: the same JSON up to float rounding, every float buffer
    within the returned error, every integer buffer equal."""
    x, y = read_glb(a), read_glb(b)
    jx, jy = x["gltf"], y["gltf"]
    for acc in jx["accessors"] + jy["accessors"]:
        acc.pop("min", None), acc.pop("max", None)
    for node in jx["nodes"] + jy["nodes"]:
        node.pop("translation", None)
    assert jx == jy
    err = 0.0
    for acc in x["gltf"]["accessors"]:
        view = x["gltf"]["bufferViews"][acc["bufferView"]]
        sl = slice(view["byteOffset"], view["byteOffset"]
                   + view["byteLength"])
        dt = {5126: np.float32, 5125: np.uint32, 5121: np.uint8}[
            acc["componentType"]]
        u, v = (np.frombuffer(z["bin"][sl], dt) for z in (x, y))
        if dt is np.float32:
            err = max(err, float(np.abs(u - v).max(initial=0.0)))
        else:
            assert np.array_equal(u, v)
    return err


def test_animate_as_jax(files, capsys, tmp_path):
    poses = str(files / "poses.npy")
    (jrc, jout, _), (rc, out, _) = _run(
        capsys, ["animate", poses, "--out", "{out}/frames"], tmp_path)
    assert rc == jrc == 0 and out == jout
    for name in ("frame_00000.obj", "frame_00001.obj"):
        assert _obj_err(tmp_path / "jax" / "frames" / name,
                        tmp_path / "port" / "frames" / name) <= 1e-5
    for extra in ([], ["--skinned"]):
        (jrc, jout, _), (rc, out, _) = _run(
            capsys, ["animate", poses, "--out", "{out}/clip.glb", "--fps",
                     "12", *extra], tmp_path)
        assert rc == jrc == 0 and out == jout
        assert _glb_err(tmp_path / "jax" / "clip.glb",
                        tmp_path / "port" / "clip.glb") <= 1e-5


def test_render_as_jax(files, capsys, tmp_path):
    poses = str(files / "poses.npy")
    for out_name in ("clip.avi", "clip.gif", "pngs"):
        (jrc, jout, _), (rc, out, _) = _run(
            capsys, ["render", "--poses", poses, "--size", "32",
                     "--out", "{out}/" + out_name], tmp_path)
        assert rc == jrc == 0 and out == jout
    # The AVI frames are the 8-bit renders: equal where no pixel sits on
    # a rounding boundary (every pixel on these inputs).
    a, b = (read_avi_info(tmp_path / s / "clip.avi") for s in ("jax", "port"))
    assert np.array_equal(a.pop("first_frame"), b.pop("first_frame"))
    assert a == b and a["n_frames"] == 2
    for name in ("clip.avi", "clip.gif", "pngs/frame_00000.png",
                 "pngs/frame_00001.png"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


def test_module_entry_point_runs_and_refuses_a_missing_card(tmp_path):
    """``python -m mano_hand_tpu_torch``: ``--device cpu`` runs; the default
    ``cuda`` raises where there is no card (never a silent CPU run)."""
    env_cmd = [sys.executable, "-m", "mano_hand_tpu_torch"]
    ok = subprocess.run(env_cmd + ["--device", "cpu", "info"], cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and json.loads(ok.stdout)["n_faces"] == 1538
    if not torch.cuda.is_available():
        bad = subprocess.run(env_cmd + ["info"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert bad.returncode == 1 and "CUDA is not available" in bad.stderr
    subs = cli.build_parser()._subparsers._group_actions[0].choices
    assert sorted(subs) == ["analyze", "animate", "convert", "demo",
                            "export-aot", "fit", "info", "proxy", "render",
                            "serve", "serve-bench", "status",
                            "trace-report", "verify"]
