"""The port's ``MANOModel`` against the golden fixture, the float64 oracle
and the JAX package's ``MANOModel``.

The golden demo (``tests/fixtures/golden_demo.npz``, as
``tests/test_golden.py`` holds the JAX package): the ``np`` backend within
1e-12, the ``torch`` backend on the CPU within 1e-4. The reference quirks
of ``tests/test_layer.py`` hold: a fresh model holds the rest pose,
``set_params`` returns a copy, ``global_rot`` is honoured only in the PCA
branch and persists, the same argument checks. ``forward_bucketed`` is
held to ``__call__`` within 1e-6 (a tolerance: the JAX side's own
bit-identity test misses by 2.98e-8 on the CPU), with its compile and
dispatch counts.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mano_hand_tpu import cli
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.models.layer import MANOModel as JaxMANOModel
from mano_hand_tpu_torch.assets import (
    save_dumped_pickle, save_npz, synthetic_params,
)
from mano_hand_tpu_torch.io.obj import read_obj, restpose_path
from mano_hand_tpu_torch.io.ply import read_ply
from mano_hand_tpu_torch.models import core, oracle
from mano_hand_tpu_torch.models.layer import MANOModel

FIXTURE = Path(__file__).parent / "fixtures" / "golden_demo.npz"
TOL = 1e-5
ORACLE_TOL = 1e-4


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def params():
    return synthetic_params(seed=0, device="cpu")


@pytest.fixture(scope="module")
def model(params):
    return MANOModel(params, backend="torch", device="cpu")


@pytest.mark.parametrize("backend,tol", [("np", 1e-12), ("torch", 1e-4)])
def test_demo_matches_golden(params, backend, tol):
    golden = np.load(FIXTURE)
    m = MANOModel(params, backend=backend, device="cpu")
    m.set_params(pose_pca=cli.DEMO_POSE_PCA, shape=cli.DEMO_SHAPE,
                 global_rot=cli.DEMO_GLOBAL_ROT)
    assert m.verts.dtype == np.float64
    assert _err(m.verts, golden["verts"]) <= tol
    assert _err(m.rest_verts, golden["rest_verts"]) <= tol
    assert _err(m.J, golden["joints"]) <= tol


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_state_equals_jax_model(params, backend):
    """Every exposed attribute after a PCA set_params equals the JAX
    model's (np: both float64 oracles, 1e-12; torch vs jax: f32, 1e-5)."""
    jm = JaxMANOModel(jax_synthetic(seed=0),
                      backend="np" if backend == "np" else "jax")
    m = MANOModel(params, backend=backend, device="cpu")
    rng = np.random.default_rng(9608)
    pca, shape = rng.normal(size=9), rng.normal(size=10)
    for mm in (jm, m):
        mm.set_params(pose_pca=pca, shape=shape, global_rot=[1, 0, 0])
        mm.set_params(pose_pca=pca * 0.5)          # rot persists
    tol = 1e-12 if backend == "np" else TOL
    for name in ("verts", "rest_verts", "J", "R", "posed_J", "pose",
                 "shape", "rot"):
        assert _err(getattr(m, name), getattr(jm, name)) <= tol, name
    np.testing.assert_array_equal(m.faces, np.asarray(jm.faces))
    assert m.side == jm.side and m.n_joints == jm.n_joints


def test_construction_holds_rest_pose(params):
    m = MANOModel(params, backend="np")   # the np backend needs no device
    np.testing.assert_allclose(m.verts, params.v_template.numpy(),
                               atol=1e-12)
    t = MANOModel(params, device="cpu")
    assert _err(t.verts, params.v_template) <= 1e-6


def test_set_params_returns_a_copy(model):
    rng = np.random.default_rng(0)
    verts = model.set_params(pose_abs=rng.normal(scale=0.5, size=(16, 3)))
    assert verts.shape == (778, 3)
    verts[0] = 999.0
    assert model.verts[0, 0] != 999.0


def test_global_rot_only_in_pca_branch(params):
    """The reference quirk: global_rot is honoured only through the PCA
    branch, persists across calls, and an absolute pose replaces it."""
    m = MANOModel(params, device="cpu")
    pca = np.random.default_rng(1).normal(size=9)
    v1 = m.set_params(pose_pca=pca, global_rot=[1.0, 0.0, 0.0])
    np.testing.assert_allclose(m.rot, [[1.0, 0.0, 0.0]])
    v2 = m.set_params(pose_pca=pca)
    np.testing.assert_allclose(m.rot, [[1.0, 0.0, 0.0]])
    assert _err(v1, v2) <= TOL
    # global_rot beside an absolute pose is ignored (the PCA branch only).
    pose = np.zeros((16, 3))
    v3 = m.set_params(pose_abs=pose, global_rot=[0.0, 2.0, 0.0])
    np.testing.assert_allclose(m.rot, [[1.0, 0.0, 0.0]])
    assert _err(v3, params.v_template) <= 1e-6


def test_backends_agree(model):
    rng = np.random.default_rng(2)
    pose, shape = rng.normal(scale=0.5, size=(16, 3)), rng.normal(size=10)
    assert _err(model(pose=pose, shape=shape, backend="np"),
                model(pose=pose, shape=shape, backend="torch")) <= ORACLE_TOL


@pytest.mark.parametrize("kind", ["pose", "pca"])
def test_call_batched_torch(model, params, kind):
    rng = np.random.default_rng(3)
    shape = rng.normal(size=(4, 10))
    if kind == "pose":
        pose = rng.normal(scale=0.5, size=(4, 16, 3))
        v = model(pose=pose, shape=shape)
        each = [model(pose=pose[i], shape=shape[i], backend="np")
                for i in range(4)]
        with pytest.raises(ValueError, match="unbatched"):
            model(pose=pose, shape=shape, backend="np")
    else:
        pca = rng.normal(size=(4, 9))
        v = model(pose_pca=pca, global_rot=[1.0, 0.0, 0.0], shape=shape)
        each = [model(pose_pca=pca[i], global_rot=[1.0, 0.0, 0.0],
                      shape=shape[i], backend="np") for i in range(4)]
        with pytest.raises(ValueError, match="unbatched"):
            model(pose_pca=pca, backend="np")
    assert v.shape == (4, 778, 3) and v.dtype == np.float32
    for i in range(4):
        assert _err(v[i], each[i]) <= ORACLE_TOL


def test_call_equals_jax_call(model):
    jm = JaxMANOModel(jax_synthetic(seed=0))
    rng = np.random.default_rng(4)
    pca = rng.normal(size=(3, 9))
    shape = rng.normal(size=(3, 10))
    assert _err(model(pose_pca=pca, shape=shape, global_rot=[0.3, 0, 0]),
                jm(pose_pca=pca, shape=shape, global_rot=[0.3, 0, 0])) <= TOL
    pose = rng.normal(scale=0.4, size=(16, 3))
    assert _err(model(pose=pose), jm(pose=pose)) <= TOL


@pytest.mark.parametrize("kwargs,match", [
    (dict(pose=np.zeros((16, 3)), pose_pca=np.zeros(9)), "exactly one"),
    (dict(backend="jax"), "backend"),
    (dict(pose=np.zeros((16, 3)), global_rot=[1.0, 0.0, 0.0]), "global_rot"),
])
def test_call_argument_checks(params, kwargs, match):
    m = MANOModel(params, backend="np")
    with pytest.raises(ValueError, match=match):
        m(**kwargs)


def test_bad_backend_refused(params):
    with pytest.raises(ValueError, match="backend must be"):
        MANOModel(params, backend="jax")


def test_single_pose_path_uses_the_specialisation_cache(params):
    m = MANOModel(params, device="cpu")
    rng = np.random.default_rng(5)
    shape = rng.normal(size=10)
    m.set_params(pose_abs=rng.normal(scale=0.3, size=(16, 3)), shape=shape)
    baked = m.specialize(shape)
    m.set_params(pose_abs=rng.normal(scale=0.3, size=(16, 3)))
    assert m.specialize(shape) is baked           # pose-only: no re-bake
    m.set_params(shape=shape + 1.0)
    assert m.specialize(shape + 1.0) is not baked
    want = oracle.forward(params, m.pose, m.shape)
    assert _err(m.verts, want.verts) <= ORACLE_TOL
    # Betas already on the device take the one-call forward, same result.
    direct = m(pose=m.pose, shape=torch.from_numpy(m.shape))
    assert _err(direct, m.verts) <= TOL


def test_keypoints_accessor(model, params):
    model.set_params(pose_abs=np.random.default_rng(11).normal(
        scale=0.2, size=(16, 3)), shape=np.zeros(10))
    kp21 = model.keypoints("smplx", order="openpose")
    assert kp21.shape == (21, 3) and kp21.dtype == np.float64
    p32 = params.astype(torch.float32)
    out = core.forward(p32, torch.from_numpy(model.pose).float(),
                       torch.zeros(10))
    assert _err(kp21, core.keypoints(out, "smplx", "openpose")) <= TOL
    assert _err(model.keypoints(), model.posed_J) == 0.0
    with pytest.raises(ValueError, match="21-keypoint"):
        model.keypoints(None, order="openpose")
    with pytest.raises(ValueError, match="order must be"):
        model.keypoints("smplx", order="freihand")
    jm = JaxMANOModel(jax_synthetic(seed=0), backend="np")
    m = MANOModel(params, backend="np")
    for mm in (jm, m):
        mm.set_params(pose_pca=np.ones(6), global_rot=[0, 1, 0])
    for tips, order in (("manopth", "openpose"), ((1, 2), "mano")):
        assert _err(m.keypoints(tips, order), jm.keypoints(tips, order)) \
            <= 1e-12


def test_forward_bucketed(params):
    m = MANOModel(params, device="cpu")
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 9, 15):
        pose = rng.normal(scale=0.4, size=(n, 16, 3)).astype(np.float32)
        shape = rng.normal(size=(n, 10)).astype(np.float32)
        got = m.forward_bucketed(pose, shape, max_bucket=16)
        assert got.shape == (n, 778, 3) and got.dtype == np.float32
        assert _err(got, m(pose=pose, shape=shape)) <= 1e-6
    snap = m.serving_counters.snapshot()
    # Buckets 1, 2, 8 (n = 5), 16 (n = 9 and 15): four callables built.
    assert snap["compiles"] == 4 and snap["dispatches"] == 5
    assert snap["rows_live"] == 32 and snap["rows_padded"] == 3 + 0 + 7 + 1
    m.forward_bucketed(pose[:3], shape[:3], max_bucket=16)   # bucket 4
    assert m.serving_counters.compiles == 5
    m.forward_bucketed(pose[:3], max_bucket=16)
    assert m.serving_counters.compiles == 5   # steady: no new build
    with pytest.raises(ValueError, match="forward_bucketed pose"):
        m.forward_bucketed(pose[0])
    with pytest.raises(ValueError, match="forward_bucketed shape"):
        m.forward_bucketed(pose, shape[:2], max_bucket=16)
    big = rng.normal(scale=0.4, size=(17, 16, 3))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        m.forward_bucketed(big, max_bucket=16)


def test_export_obj_and_ply(model, tmp_path):
    model.set_params(pose_abs=np.random.default_rng(5).normal(
        scale=0.3, size=(16, 3)))
    out = tmp_path / "hand.obj"
    model.export_obj(out)
    twin = restpose_path(out)
    assert out.exists() and twin.exists()
    back, rest = read_obj(out), read_obj(twin)
    assert _err(back.verts, model.verts) <= 1e-6
    assert _err(rest.verts, model.rest_verts) <= 1e-6
    np.testing.assert_array_equal(back.faces, model.faces)
    with pytest.raises(ValueError, match="obj"):
        model.export_obj(tmp_path / "hand.ply")
    # Byte-identical to the JAX model's pair for the same float64 state.
    jm = JaxMANOModel(jax_synthetic(seed=0), backend="np")
    jm.verts, jm.rest_verts = model.verts, model.rest_verts
    jm.export_obj(tmp_path / "jax.obj")
    assert out.read_bytes() == (tmp_path / "jax.obj").read_bytes()
    assert twin.read_bytes() == (tmp_path / "jax_restpose.obj").read_bytes()
    for binary in (True, False):
        ply = tmp_path / f"hand_{binary}.ply"
        model.export_ply(ply, binary=binary)
        jm.export_ply(tmp_path / "jax.ply", binary=binary)
        assert ply.read_bytes() == (tmp_path / "jax.ply").read_bytes()
        mesh = read_ply(ply)
        assert _err(mesh.verts, model.verts) <= 1e-6
        assert mesh.normals is not None


def test_model_from_a_path(params, tmp_path):
    """A path loads through ``load_model`` into the host master (the .npz
    carries its side; a pickle's side comes from its name)."""
    npz, pkl = tmp_path / "hand.npz", tmp_path / "dump_mano_left.pkl"
    save_npz(params, npz)
    save_dumped_pickle(params, pkl)
    m = MANOModel(npz, backend="np")
    assert m.side == "right" and m.params.dtype == torch.float64
    assert m.params.device == torch.device("cpu")
    assert _err(m.verts, params.v_template) <= 1e-12
    assert MANOModel(pkl, backend="np").side == "left"


def test_torch_backend_defaults_to_cuda_and_raises_without_it(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MANOModel(params)
    m = MANOModel(params, backend="np")      # touches no device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m(pose=np.zeros((16, 3)), backend="torch")


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_stateful_wrapper_on_body_model(backend):
    """The wrapper is model-family generic: a 24-joint body (pass-through
    PCA) drives set_params, verts and the joints; the torch backend agrees
    with the oracle."""
    body = synthetic_params(seed=6, n_verts=437, n_joints=24, n_shape=16,
                            n_faces=870, device="cpu")
    import dataclasses

    body = dataclasses.replace(body, pca_basis=torch.eye(69,
                                                         dtype=torch.float64),
                               pca_mean=torch.zeros(69, dtype=torch.float64))
    m = MANOModel(body, backend=backend, device="cpu")
    assert m.verts.shape == (437, 3)
    rng = np.random.default_rng(0)
    pose, shape = rng.normal(scale=0.25, size=(24, 3)), rng.normal(size=16)
    verts = m.set_params(pose_abs=pose, shape=shape)
    assert np.isfinite(verts).all() and m.J.shape == (24, 3)
    assert _err(verts, oracle.forward(body, pose, shape).verts) <= ORACLE_TOL
    v2 = m.set_params(pose_pca=np.zeros(9), global_rot=np.zeros(3),
                      shape=np.zeros(16))
    assert _err(v2, MANOModel(body, backend=backend,
                              device="cpu").verts) <= 1e-6
    batch = m(pose=rng.normal(scale=0.2, size=(3, 24, 3)), backend="torch")
    assert batch.shape == (3, 437, 3)
    assert m.forward_bucketed(np.zeros((3, 24, 3))).shape == (3, 437, 3)
