"""The port's pose PCA, rotation-matrix entry and keypoints against the
JAX package's.

Full MANO width on the synthetic asset, float32 on the CPU, <= 1e-5 (the
two differ only in summation order): ``decode_pca`` and ``forward_pca``
(every coefficient count, no / shared / per-row global rotation),
``forward_batched_rotmats`` (both staging forms), and ``keypoints`` /
``keypoints_chunked`` over every tip convention and both orders, with the
same ``ValueError``s. ``sample_poses`` takes a ``torch.Generator`` where
JAX takes a key, so its draws are held to their distribution and to
JAX's decode of the same coefficients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu import constants as jconstants
from mano_hand_tpu import ops as jops
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu_torch import constants, ops
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core, oracle

TOL = 1e-5


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def assets():
    """(JAX f32 params, port f32 params, port f64 params) on the CPU."""
    tp64 = synthetic_params(seed=0, device="cpu")
    return (jax_synthetic(seed=0).astype(np.float32),
            tp64.astype(torch.float32), tp64)


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.4, size=(b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(b, 10)).astype(np.float32)
    return pose, beta


def test_constants_equal_jax():
    assert constants.TIP_VERTEX_IDS == jconstants.TIP_VERTEX_IDS
    assert constants.MANO21_TO_OPENPOSE == jconstants.MANO21_TO_OPENPOSE


@pytest.mark.parametrize("n", [1, 9, 45])
@pytest.mark.parametrize("rot", ["none", "shared", "per_row"])
@pytest.mark.parametrize("batch", [None, 4])
def test_decode_pca_equals_jax(assets, n, rot, batch):
    jp, tp, _ = assets
    rng = np.random.default_rng(n)
    lead = () if batch is None else (batch,)
    coeffs = rng.normal(size=(*lead, n)).astype(np.float32)
    grot = {"none": None,
            "shared": np.array([1.0, 0.2, -0.3], np.float32),
            "per_row": rng.normal(size=(*lead, 3)).astype(np.float32)}[rot]
    want = jcore.decode_pca(jp, jnp.asarray(coeffs),
                            None if grot is None else jnp.asarray(grot))
    got = core.decode_pca(tp, torch.from_numpy(coeffs),
                          None if grot is None else torch.from_numpy(grot))
    assert got.shape == (*lead, 16, 3) and got.dtype == torch.float32
    assert _err(got, want) <= TOL


def test_decode_pca_float64_equals_oracle(assets):
    _, _, tp64 = assets
    c = np.random.default_rng(3).normal(size=9)
    got = core.decode_pca(tp64, torch.from_numpy(c), torch.tensor([1., 0, 0]))
    want = oracle.decode_pca_pose(tp64, c, np.array([1.0, 0, 0]))
    assert _err(got, want) <= 1e-12


@pytest.mark.parametrize("rot", [None, [1.0, 0.0, 0.0]])
def test_forward_pca_equals_jax(assets, rot):
    jp, tp, tp64 = assets
    rng = np.random.default_rng(5)
    coeffs = rng.normal(size=12).astype(np.float32)
    beta = rng.normal(size=10).astype(np.float32)
    grot = None if rot is None else np.asarray(rot, np.float32)
    want = jcore.forward_pca(jp, jnp.asarray(coeffs),
                             None if grot is None else jnp.asarray(grot),
                             jnp.asarray(beta))
    got = core.forward_pca(tp, torch.from_numpy(coeffs),
                           None if grot is None else torch.from_numpy(grot),
                           torch.from_numpy(beta))
    for name in ("verts", "joints", "rest_verts", "rot_mats",
                 "posed_joints"):
        assert _err(getattr(got, name), getattr(want, name)) <= TOL, name
    ref = oracle.forward(tp64, oracle.decode_pca_pose(tp64, coeffs, grot),
                         beta)
    assert _err(got.verts, ref.verts) <= 1e-4


@pytest.mark.parametrize("fused", [True, False])
def test_forward_batched_rotmats_equals_jax(assets, fused):
    jp, tp, _ = assets
    pose, beta = _inputs(5, seed=1)
    rots = np.array(jops.rotation_matrix(jnp.asarray(pose)))
    want = jcore.forward_batched_rotmats(jp, jnp.asarray(rots),
                                         jnp.asarray(beta), fused=fused)
    got = core.forward_batched_rotmats(tp, torch.from_numpy(rots),
                                       torch.from_numpy(beta), fused=fused)
    for name in ("verts", "joints", "rest_verts", "posed_joints"):
        assert _err(getattr(got, name), getattr(want, name)) <= TOL, name
    # The same poses through Rodrigues agree with the matrix entry.
    direct = core.forward_batched(tp, torch.from_numpy(pose),
                                  torch.from_numpy(beta))
    assert _err(got.verts, direct.verts) <= TOL


TIPS = [None, "smplx", "manopth", (0, 5, 777), (), [744, 320, 443, 554, 671]]


@pytest.mark.parametrize("tips", TIPS, ids=str)
@pytest.mark.parametrize("order", ["mano", "openpose"])
def test_keypoints_equal_jax(assets, tips, order):
    """Every tip convention in both orders: the same keypoints as JAX, or
    the same ValueError (openpose needs exactly 21 keypoints)."""
    jp, tp, _ = assets
    pose, beta = _inputs(3, seed=2)
    jout = jcore.forward_batched(jp, jnp.asarray(pose), jnp.asarray(beta))
    tout = core.forward_batched(tp, torch.from_numpy(pose),
                                torch.from_numpy(beta))
    try:
        want = jcore.keypoints(jout, tips, order)
    except ValueError as e:
        with pytest.raises(ValueError) as got_err:
            core.keypoints(tout, tips, order)
        assert str(got_err.value) == str(e)
        return
    got = core.keypoints(tout, tips, order)
    assert got.shape == want.shape
    assert _err(got, want) <= TOL
    if tips is None or tips == ():
        np.testing.assert_array_equal(got.numpy(),
                                      tout.posed_joints.numpy())


@pytest.mark.parametrize("tips,order,match", [
    ("nonsense", "mano", "unknown tip convention"),
    ((778,), "mano", "out of range"),
    ((-1,), "mano", "out of range"),
    (None, "openpose", "21-keypoint"),
    ("smplx", "freihand", "order must be"),
])
def test_keypoint_validations_equal_jax(assets, tips, order, match):
    jp, tp, _ = assets
    jout = jcore.forward(jp, jnp.zeros((16, 3)), jnp.zeros((10,)))
    tout = core.forward(tp, torch.zeros(16, 3), torch.zeros(10))
    with pytest.raises(ValueError, match=match) as want:
        jcore.keypoints(jout, tips, order)
    with pytest.raises(ValueError, match=match) as got:
        core.keypoints(tout, tips, order)
    assert str(got.value) == str(want.value)


def test_select_keypoints_along_axis0_equals_jax(assets):
    """The selection on rows of a [K, 3, P] tensor (``axis=0``), the form
    the analytic Jacobian uses: rows select in lockstep."""
    rng = np.random.default_rng(9)
    verts = rng.normal(size=(778, 3, 7)).astype(np.float32)
    joints = rng.normal(size=(16, 3, 7)).astype(np.float32)
    tips = core.resolve_tip_ids("smplx", 778)
    assert tips == jcore.resolve_tip_ids("smplx", 778)
    want = jcore.select_keypoints(jnp.asarray(verts), jnp.asarray(joints),
                                  tips, "openpose", axis=0)
    got = core.select_keypoints(torch.from_numpy(verts),
                                torch.from_numpy(joints), tips, "openpose",
                                axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tips,order", [("smplx", "openpose"),
                                        ("manopth", "mano"), (None, "mano")])
@pytest.mark.parametrize("b,chunk", [(37, 16), (5, 1024)])
def test_keypoints_chunked_equals_jax(assets, tips, order, b, chunk):
    jp, tp, _ = assets
    pose, beta = _inputs(b, seed=13)
    want = jcore.keypoints_chunked(jp, jnp.asarray(pose), jnp.asarray(beta),
                                   tips, order=order, chunk_size=chunk)
    got = core.keypoints_chunked(tp, torch.from_numpy(pose),
                                 torch.from_numpy(beta), tips, order=order,
                                 chunk_size=chunk)
    assert got.shape == want.shape
    assert _err(got, want) <= TOL
    # Padding never leaks: the chunked reducer equals the direct path.
    direct = core.keypoints(core.forward_batched(
        tp, torch.from_numpy(pose), torch.from_numpy(beta)), tips, order)
    assert _err(got, direct) <= 1e-6


def test_keypoints_chunked_empty_batch(assets):
    _, tp, _ = assets
    got = core.keypoints_chunked(tp, torch.zeros(0, 16, 3),
                                 torch.zeros(0, 10), "smplx")
    assert got.shape == (0, 21, 3)


def test_sample_poses(assets):
    """At scale 0 the samples ARE the mean pose; the draws come from the
    generator (same seed, same poses; a CPU generator gives the same
    poses whatever the params' device) and decode as JAX decodes the same
    coefficients."""
    jp, tp, _ = assets
    zero = core.sample_poses(tp, torch.Generator().manual_seed(0), 4,
                             pca_scale=0.0)
    assert zero.shape == (4, 16, 3)
    mean = jp.pca_mean.reshape(15, 3)
    assert _err(zero[:, 1:], np.broadcast_to(mean, (4, 15, 3))) <= 1e-6
    assert float(zero[:, 0].abs().max()) == 0.0
    want0 = jcore.sample_poses(jp, np.array([0, 0], np.uint32), 4,
                               pca_scale=0.0)
    assert _err(zero, want0) <= 1e-6

    a = core.sample_poses(tp, torch.Generator().manual_seed(7), 256,
                          global_rot_scale=0.3)
    b = core.sample_poses(tp, torch.Generator().manual_seed(7), 256,
                          global_rot_scale=0.3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a[:, 0].abs().max()) > 0.0       # global rotation drawn
    # Re-whitening the samples under the (orthonormal) basis gives unit
    # variance per component: the samples sit in the asset's distribution.
    z = ((a[:, 1:].reshape(256, 45) - tp.pca_mean) @ tp.pca_basis.T)
    assert 0.8 < float(z.var(0).mean()) < 1.2
    np.testing.assert_allclose(
        jcore.decode_pca(jp, jnp.asarray(z.numpy()),
                         jnp.asarray(a[:, 0].numpy())),
        a.numpy(), atol=TOL)
    # Per-component variances scale the draws.
    var = torch.linspace(0.25, 4.0, 45)
    s = core.sample_poses(tp, torch.Generator().manual_seed(1), 4096,
                          component_vars=var)
    zs = (s[:, 1:].reshape(4096, 45) - tp.pca_mean) @ tp.pca_basis.T
    ratio = zs.var(0) / var
    assert float((ratio - 1).abs().max()) < 0.15


def test_pca_and_keypoints_on_a_24_joint_body():
    """The pose-space and keypoint functions carry no hand constants: a
    24-joint body (69-dim pass-through PCA) runs through them."""
    body = synthetic_params(seed=6, n_verts=437, n_joints=24, n_shape=16,
                            n_faces=870, device="cpu")
    jbody = jax_synthetic(seed=6, n_verts=437, n_joints=24, n_shape=16,
                          n_faces=870)
    c = np.random.default_rng(0).normal(scale=0.3, size=(2, 20))
    got = core.decode_pca(body, torch.from_numpy(c))
    assert got.shape == (2, 24, 3)
    assert _err(got, jcore.decode_pca(jbody, jnp.asarray(c))) <= TOL
    out = core.forward_batched(body, got, torch.zeros(2, 16,
                                                     dtype=torch.float64))
    kp = core.keypoints(out, (0, 436))
    assert kp.shape == (2, 26, 3)
    kpc = core.keypoints_chunked(body, got, torch.zeros(
        2, 16, dtype=torch.float64), (0, 436), chunk_size=1)
    assert _err(kpc, kp) <= 1e-12
