"""The port's torch-facing API against the JAX package's torch bridge.

``params_from_torch`` takes the same names and aliases as the JAX bridge
(this package's, smplx/manopth's, transposed ``posedirs``, a sparse
``J_regressor``, ``kintree_table`` with its uint32 root, missing PCA) and
builds equal arrays. ``forward_from_torch`` matches the JAX bridge within
1e-5. ``TorchManoLayer`` is a real ``nn.Module`` whose gradients come
from torch autograd; they are held to the JAX ``make_torch_layer``'s
(``jax.vjp`` through the JAX core) within relative 1e-4, and a plain Adam
loop through it drives the loss down (the cases of
``tests/test_interop.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu import ops as jops
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.interop import torch_bridge as jbridge
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu_torch.assets import ARRAY_FIELDS, synthetic_params
from mano_hand_tpu_torch.interop import (
    TorchManoLayer, forward_from_torch, make_torch_layer, params_from_torch,
    to_torch,
)
from mano_hand_tpu_torch.models import core

TOL = 1e-5
REL = 1e-4


def _err(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _rel(a, b):
    """max|a - b| / max(1, max|b|): the JAX tests' relative bar."""
    b = np.asarray(b, np.float64)
    return _err(a, b) / max(1.0, float(np.abs(b).max()))


@pytest.fixture(scope="module")
def jp32():
    return jax_synthetic(seed=0).astype(np.float32)


@pytest.fixture(scope="module")
def tp32():
    return synthetic_params(seed=0, dtype=torch.float32, device="cpu")


def _dicts(jp, kind):
    """The same asset under one naming convention, as the JAX bridge's
    tests build it."""
    v = jp.n_verts
    if kind == "native":
        d = {f: torch.from_numpy(np.asarray(getattr(jp, f)))
             for f in ARRAY_FIELDS}
        d["parents"] = np.asarray(jp.parents)
    elif kind == "smplx":
        kintree = np.asarray(jp.parents, np.int64)
        kintree[0] = np.iinfo(np.uint32).max
        d = {
            "v_template": torch.from_numpy(np.asarray(jp.v_template)),
            "shapedirs": torch.from_numpy(np.asarray(jp.shape_basis)),
            "posedirs": torch.from_numpy(np.asarray(
                jp.pose_basis).reshape(v * 3, -1).T.copy()),
            "J_regressor": torch.from_numpy(np.asarray(jp.j_regressor)),
            "weights": torch.from_numpy(np.asarray(jp.lbs_weights)),
            "hands_components": torch.from_numpy(np.asarray(jp.pca_basis)),
            "hands_mean": torch.from_numpy(np.asarray(jp.pca_mean)),
            "f": np.asarray(jp.faces),
            "kintree_table": np.stack([kintree, np.arange(16)]),
        }
    elif kind == "sparse":
        import scipy.sparse as sp

        d = {f: np.asarray(getattr(jp, f)) for f in ARRAY_FIELDS}
        d["j_regressor"] = sp.csc_matrix(d["j_regressor"])
        d["parents"] = [None] + list(jp.parents[1:])
    elif kind == "no_pca":
        d = {f: np.asarray(getattr(jp, f)) for f in ARRAY_FIELDS
             if f not in ("pca_basis", "pca_mean")}
        d["parents"] = np.asarray(jp.parents)
    return d


@pytest.mark.parametrize("kind", ["native", "smplx", "sparse", "no_pca"])
def test_params_from_torch_equals_jax(jp32, kind):
    d = _dicts(jp32, kind)
    want = jbridge.params_from_torch(d)
    got = params_from_torch(d, device="cpu")
    for f in ARRAY_FIELDS:
        g = getattr(got, f)
        assert g.dtype == (torch.int32 if f == "faces" else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.parents == want.parents and got.parents[0] == -1
    assert got.side == want.side == "right"
    if kind == "no_pca":
        np.testing.assert_array_equal(got.pca_basis.numpy(), np.eye(45))


def test_params_from_torch_missing_required_keys(jp32):
    d = {"v_template": np.asarray(jp32.v_template)}
    with pytest.raises(ValueError, match="missing required keys") as want:
        jbridge.params_from_torch(d)
    with pytest.raises(ValueError, match="missing required keys") as got:
        params_from_torch(d, device="cpu")
    assert str(got.value) == str(want.value)


def test_to_torch_trees(tp32):
    out = core.forward(tp32, torch.zeros(16, 3), torch.zeros(10))
    np_out = core.ManoOutput(*(x.numpy() for x in out))
    t = to_torch(np_out)
    assert isinstance(t, core.ManoOutput) and torch.is_tensor(t.verts)
    np.testing.assert_array_equal(t.verts.numpy(), out.verts.numpy())
    tree = to_torch({"a": [np.ones(2), (np.zeros(3), None)], "b": "s",
                     "c": out.verts})
    assert torch.is_tensor(tree["a"][0]) and tree["a"][1][1] is None
    assert tree["b"] == "s" and tree["c"] is out.verts
    d = to_torch(tp32)      # a dataclass becomes a dict of its fields
    assert d["side"] == "right" and torch.is_tensor(d["v_template"])


@pytest.mark.parametrize("form", ["batched", "flat", "single", "rotmats",
                                  "rotmats_single"])
def test_forward_from_torch_equals_jax(jp32, tp32, form):
    rng = np.random.default_rng(0)
    pose = rng.normal(scale=0.4, size=(3, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(3, 10)).astype(np.float32)
    rots = np.array(jops.rotation_matrix(jnp.asarray(pose)))
    args = {
        "batched": (pose, beta, True),
        "flat": (pose.reshape(3, 48), beta, True),
        "single": (pose[0], None, True),
        "rotmats": (rots, beta, False),
        "rotmats_single": (rots[0], None, False),
    }[form]
    x, b, pose2rot = args
    want = jbridge.forward_from_torch(
        jp32, torch.from_numpy(x), None if b is None else torch.from_numpy(b),
        pose2rot=pose2rot)
    got = forward_from_torch(
        tp32, torch.from_numpy(x), None if b is None else torch.from_numpy(b),
        pose2rot=pose2rot)
    assert isinstance(got, core.ManoOutput)
    for name in ("verts", "joints", "posed_joints", "rest_verts"):
        w = getattr(want, name)
        assert tuple(getattr(got, name).shape) == tuple(w.shape), name
        assert _err(getattr(got, name), w.numpy()) <= TOL, name


def test_torch_layer_grads_match_jax(jp32, tp32):
    """Gradients through the native layer (torch autograd over the plain
    core) equal those through the JAX bridge (jax.vjp through the JAX
    core) within relative 1e-4; the losses too."""
    rng = np.random.default_rng(41)
    pose = rng.normal(scale=0.3, size=(2, 16, 3)).astype(np.float32)
    shape = rng.normal(scale=0.5, size=(2, 10)).astype(np.float32)
    trans = rng.normal(scale=0.05, size=(2, 3)).astype(np.float32)
    wv = torch.from_numpy(rng.normal(size=(2, 778, 3)).astype(np.float32))
    wj = torch.from_numpy(rng.normal(size=(2, 16, 3)).astype(np.float32))

    def run(layer):
        leaves = [torch.tensor(x, requires_grad=True)
                  for x in (pose, shape, trans)]
        verts, joints = layer(*leaves)
        loss = (verts * wv).sum() + (joints * wj).sum()
        loss.backward()
        return loss.item(), [x.grad.numpy() for x in leaves]

    layer = make_torch_layer(tp32, device="cpu")
    assert isinstance(layer, TorchManoLayer)
    assert isinstance(layer, torch.nn.Module)
    loss, grads = run(layer)
    jloss, jgrads = run(jbridge.make_torch_layer(jp32))
    assert abs(loss - jloss) <= REL * max(1.0, abs(jloss))
    for g, w in zip(grads, jgrads):
        assert _rel(g, w) <= REL
    # Against jax.grad of the JAX core directly, as the JAX test holds it.
    import jax

    def loss_j(p, s, t):
        out = jcore.forward_batched(jp32, p, s)
        return (jnp.sum((out.verts + t[:, None, :]) * wv.numpy())
                + jnp.sum((out.posed_joints + t[:, None, :]) * wj.numpy()))

    for g, w in zip(grads, jax.grad(loss_j, argnums=(0, 1, 2))(
            pose, shape, trans)):
        assert _rel(g, np.asarray(w)) <= REL


def test_torch_layer_training_loop(jp32, tp32):
    """A plain torch Adam loop optimises pose THROUGH the layer."""
    rng = np.random.default_rng(7)
    true_pose = rng.normal(scale=0.25, size=(16, 3)).astype(np.float32)
    target = torch.from_numpy(np.array(
        jcore.forward(jp32, jnp.asarray(true_pose)).verts))
    module = torch.nn.Sequential(TorchManoLayer(tp32, device="cpu"))
    pose_t = torch.zeros((16, 3), requires_grad=True)
    opt = torch.optim.Adam([pose_t], lr=0.05)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        verts, _ = module(pose_t)
        loss = ((verts - target) ** 2).sum(-1).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.05 * losses[0], losses[::10]


def test_torch_layer_unbatched_and_rotmat(jp32, tp32):
    rng = np.random.default_rng(3)
    pose = rng.normal(scale=0.3, size=(16, 3)).astype(np.float32)
    layer = make_torch_layer(tp32, device="cpu")
    verts, joints = layer(torch.from_numpy(pose))
    assert verts.shape == (778, 3) and joints.shape == (16, 3)
    want = jcore.forward(jp32, jnp.asarray(pose))
    assert _err(verts, want.verts) <= TOL
    assert _err(joints, want.posed_joints) <= TOL
    trans = torch.tensor([0.1, -0.2, 0.3])
    v2, j2 = layer(torch.from_numpy(pose), None, trans)
    assert _err(v2 - trans, verts.detach()) <= 1e-6
    assert _err(j2 - trans, joints.detach()) <= 1e-6

    rots = np.array(jops.rotation_matrix(jnp.asarray(pose)))
    layer_rm = TorchManoLayer(tp32, pose2rot=False, device="cpu")
    rot_t = torch.tensor(rots[None], requires_grad=True)
    verts_rm, _ = layer_rm(rot_t)
    assert verts_rm.shape == (1, 778, 3)
    assert _err(verts_rm[0], want.verts) <= TOL
    verts_rm.sum().backward()
    assert torch.isfinite(rot_t.grad).all()
    assert float(rot_t.grad.abs().sum()) > 0.0


def test_layer_is_model_family_generic():
    """The layer carries no hand constants: a 24-joint body rig runs
    through it with gradients."""
    body = synthetic_params(seed=8, n_verts=437, n_joints=24, n_shape=16,
                            n_faces=870, device="cpu")
    jbody = jax_synthetic(seed=8, n_verts=437, n_joints=24, n_shape=16,
                          n_faces=870).astype(np.float32)
    layer = TorchManoLayer(body, device="cpu")
    pose_t = torch.zeros((2, 24, 3), requires_grad=True)
    beta_t = torch.zeros((2, 16), requires_grad=True)
    verts_t, joints_t = layer(pose_t, beta_t)
    assert verts_t.shape == (2, 437, 3) and joints_t.shape == (2, 24, 3)
    want = jcore.forward_batched(jbody, jnp.zeros((2, 24, 3)),
                                 jnp.zeros((2, 16))).verts
    assert _err(verts_t, want) <= TOL
    verts_t.sum().backward()
    assert torch.isfinite(pose_t.grad).all()
    assert torch.isfinite(beta_t.grad).all()


def test_entry_points_default_to_cuda_and_raise_without_it(jp32, tp32):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchManoLayer(tp32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_torch_layer(tp32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_torch(_dicts(jp32, "native"))
