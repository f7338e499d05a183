"""The port's AOT export (``io/export_aot.py``, ``torch.export``) against
the JAX package's (``jax.export``), on the CPU.

The port's tests of the JAX file ``tests/test_export_aot.py``: one
artifact with parameters baked in and a symbolic (or pinned) batch,
keypoints baked in, loadable without any asset. The exported program is
held bit for bit against the port's own eager forward (the same aten
operations) and within 1e-5 of the JAX artifact's output (two
frameworks' float32 sums). Each package refuses the other's file.
``params_digest`` is the same hex as JAX's. And the repair of the caches
an export used to poison (``ops/common.py``): in a fresh interpreter an
export BEFORE any eager call leaves only plain tensors cached.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mano_hand_tpu.io import export_aot as jea
from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
from mano_hand_tpu_torch.io.export_aot import (
    export_forward, load_forward, params_digest,
)
from mano_hand_tpu_torch.models import core

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


@pytest.fixture(scope="module")
def artifact(params32):
    """The default artifact: symbolic batch, the 16 joints as keypoints."""
    return export_forward(params32)


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.3, size=(b, 16, 3)).astype(np.float32),
            rng.normal(size=(b, 10)).astype(np.float32))


def _eager(params, pose, shape):
    with torch.no_grad():
        return core.forward_batched(params, torch.from_numpy(pose),
                                    torch.from_numpy(shape))


def test_roundtrip_symbolic_batch(params, params32, artifact, tmp_path):
    path = tmp_path / "fwd.torchexp"
    path.write_bytes(artifact)
    fwd = load_forward(path)
    assert fwd.platforms == ("cpu",)
    jfwd = jea.load_forward(jea.export_forward(params.astype(np.float32),
                                               platforms=("cpu",)))
    for b in (1, 5):
        pose, shape = _inputs(b, seed=b)
        out = fwd(pose, shape)
        ref = _eager(params32, pose, shape)
        assert out["verts"].shape == (b, 778, 3)
        # The same operations as the eager forward: bit for bit.
        assert torch.equal(out["verts"], ref.verts)
        assert torch.equal(out["keypoints"], ref.posed_joints)
        want = jfwd(pose, shape)
        for k in ("verts", "keypoints"):
            err = float(np.abs(out[k].numpy() - np.asarray(want[k])).max())
            assert err <= JAX_TOL, (k, b, err)


def test_keypoints_baked_in(params, params32):
    blob = export_forward(params32, tip_vertex_ids="smplx",
                          keypoint_order="openpose")
    fwd = load_forward(blob)     # from raw bytes, no file
    assert fwd.meta["tip_vertex_ids"] is not None
    pose, shape = _inputs(3, seed=7)
    out = fwd(pose, shape)
    assert out["keypoints"].shape == (3, 21, 3)
    ref = _eager(params32, pose, shape)
    assert torch.equal(out["keypoints"],
                       core.keypoints(ref, "smplx", order="openpose"))
    jfwd = jea.load_forward(jea.export_forward(
        params.astype(np.float32), tip_vertex_ids="smplx",
        keypoint_order="openpose", platforms=("cpu",)))
    err = float(np.abs(out["keypoints"].numpy()
                       - np.asarray(jfwd(pose, shape)["keypoints"])).max())
    assert err <= JAX_TOL


def test_pinned_batch_rejects_other_sizes(params32):
    fwd = load_forward(export_forward(params32, batch=2))
    assert fwd.meta["batch"] == 2
    pose, shape = _inputs(2)
    assert fwd(pose, shape)["verts"].shape == (2, 778, 3)
    pose3, shape3 = _inputs(3)
    with pytest.raises(Exception):  # shape mismatch against the pinned input
        fwd(pose3, shape3)


def test_custom_marker_set_and_repr(params32):
    fwd = load_forward(export_forward(params32, tip_vertex_ids=(0, 5, 777)))
    assert fwd.n_keypoints == 19
    assert "keypoints=19" in repr(fwd)
    assert "batch=symbolic" in repr(fwd)
    pose, shape = _inputs(2)
    assert fwd(pose, shape)["keypoints"].shape == (2, 19, 3)
    with pytest.raises(ValueError, match="exported for"):
        fwd(torch.zeros((2, 16, 3), device="meta"),
            torch.zeros((2, 10), device="meta"))


def test_rejects_non_artifacts_and_the_other_packages(tmp_path, params,
                                                      artifact):
    bad = tmp_path / "not_an_artifact.bin"
    bad.write_bytes(b"definitely not an exported program")
    with pytest.raises(ValueError, match="bad magic"):
        load_forward(bad)
    with pytest.raises(ValueError, match="truncated"):
        load_forward(artifact[:10])     # magic survives, header length gone
    with pytest.raises(ValueError, match="truncated"):
        load_forward(artifact[:20])     # header cut mid-JSON
    with pytest.raises(ValueError, match="truncated"):
        load_forward(artifact[:-10])    # program cut short
    # Neither package takes the other's artifact for its own.
    jblob = jea.export_forward(params.astype(np.float32), platforms=("cpu",))
    with pytest.raises(ValueError, match="bad magic"):
        load_forward(jblob)
    with pytest.raises(ValueError, match="bad magic"):
        jea.load_forward(artifact)


def test_cli_export_aot(params32, tmp_path, capsys):
    from mano_hand_tpu_torch.cli import main

    out = tmp_path / "fwd.torchexp"
    rc = main(["--device", "cpu", "export-aot", "--out", str(out),
               "--tips", "manopth", "--batch", "3"])
    assert rc == 0
    assert "exported AOT forward" in capsys.readouterr().out
    fwd = load_forward(out)
    assert fwd.platforms == ("cpu",) and fwd.meta["batch"] == 3
    assert fwd.meta["params_digest"] == params_digest(
        synthetic_params(seed=0, device="cpu").astype(torch.float32))
    pose, shape = _inputs(3, seed=9)
    assert fwd(pose, shape)["keypoints"].shape == (3, 21, 3)
    with pytest.raises(ValueError, match="device types"):
        main(["--device", "cpu", "export-aot", "--out", str(out),
              "--platforms", "tpu"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mirrored", [False, True])
def test_params_digest_matches_jax(params, dtype, mirrored):
    from mano_hand_tpu.assets import mirror_params as jmirror

    port = synthetic_params(seed=0, device="cpu").astype(getattr(torch,
                                                                 dtype))
    jax_params = params.astype(np.dtype(dtype))
    if mirrored:
        port, jax_params = mirror_params(port), jmirror(jax_params)
    assert params_digest(port) == jea.params_digest(jax_params)
    assert params_digest(port, n_hex=64) == jea.params_digest(jax_params,
                                                              n_hex=64)


_STEP0 = r"""
import json, sys
import numpy as np, torch
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import common

p = synthetic_params(seed=0, device="cpu").astype(torch.float32)
rng = np.random.default_rng(0)
pose = torch.from_numpy(rng.normal(scale=0.3, size=(3, 16, 3)).astype(np.float32))
shape = torch.from_numpy(rng.normal(size=(3, 10)).astype(np.float32))
out = {}
if sys.argv[1] == "export-first":
    class M(torch.nn.Module):
        def forward(self, pose, shape):
            return core.forward_batched(p, pose, shape).verts
    b = torch.export.Dim("b")
    with torch.no_grad():
        ep = torch.export.export(M(), (pose[:2], shape[:2]),
                                 dynamic_shapes=({0: b}, {0: b}))
    out["cached_types"] = sorted({type(v).__name__
                                  for v in common._constants.values()})
with torch.no_grad():
    eager = core.forward_batched(p, pose, shape).verts
np.save(sys.argv[2], eager.numpy())
if sys.argv[1] == "export-first":
    out["cached_after"] = sorted({type(v).__name__
                                  for v in common._constants.values()})
    errs = []
    for n in (1, 3, 17):
        pz = torch.from_numpy(rng.normal(scale=0.3, size=(n, 16, 3)).astype(np.float32))
        sz = torch.from_numpy(rng.normal(size=(n, 10)).astype(np.float32))
        with torch.no_grad():
            errs.append(float((ep.module()(pz, sz)
                               - core.forward_batched(p, pz, sz).verts).abs().max()))
    out["exported_vs_eager"] = errs
print(json.dumps(out))
"""


def test_export_first_leaves_the_caches_plain(tmp_path):
    """An export before any eager call once cached FakeTensors for the FK
    levels (``index_tensor``), and the eager forward after it read them
    (NaN and ~1e19 in one run). In a clean interpreter now: the caches
    hold plain tensors, the eager result equals a fresh process's bit for
    bit, and the exported program equals eager bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(mode, out):
        done = subprocess.run(
            [sys.executable, "-c", _STEP0, mode, str(out)], env=env,
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr
        return json.loads(done.stdout.strip().splitlines()[-1])

    got = run("export-first", tmp_path / "after_export.npy")
    run("eager-only", tmp_path / "fresh.npy")
    assert got["cached_types"] in ([], ["Tensor"])
    assert got["cached_after"] == ["Tensor"]
    after = np.load(tmp_path / "after_export.npy")
    assert np.isfinite(after).all()
    np.testing.assert_array_equal(after, np.load(tmp_path / "fresh.npy"))
    assert got["exported_vs_eager"] == [0.0, 0.0, 0.0]
