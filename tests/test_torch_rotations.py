"""The port's rotation forms and normals against the JAX package's.

Rotations: the 6D representation (both directions), quaternions and the
SO(3) log map (``axis_angle_from_matrix``) in float32 on the same inputs
as JAX, <= 1e-6, in every regime of the log map: tiny angles, generic
ones, just below pi and exactly pi. Normals: face and vertex normals of a
posed synthetic mesh, <= 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu import ops as jops
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu.io.ply import vertex_normals_np as jax_normals_np
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.io.ply import vertex_normals_np

TOL = 1e-6


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _axis_angles(mags, seed):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(len(mags), 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return (axes * np.asarray(mags)[:, None]).astype(np.float32)


REGIMES = {
    "zero": np.zeros(4),
    "tiny": np.full(16, 1e-6),
    "small": np.full(16, 5e-4),
    "generic": np.random.default_rng(1).uniform(0.01, 3.0, 64),
    "below_pi": np.full(16, np.pi - 1e-2),
    "near_pi": np.full(16, np.pi - 1e-5),
    "pi": np.full(8, np.pi),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_axis_angle_from_matrix_equals_jax(regime):
    aa = _axis_angles(REGIMES[regime], seed=len(regime))
    rot = np.array(jops.rotation_matrix(jnp.asarray(aa)))
    want = np.asarray(jops.axis_angle_from_matrix(jnp.asarray(rot)))
    got = ops.axis_angle_from_matrix(torch.from_numpy(rot))
    assert got.dtype == torch.float32 and got.shape == (len(aa), 3)
    assert _err(got, want) <= TOL
    # The round trip reproduces the rotation (at pi the axis sign is free)
    # as closely as JAX's does: f32 arccos conditioning near pi costs both
    # up to ~5e-3.
    jax_trip = _err(jops.rotation_matrix(jnp.asarray(want)), rot)
    assert _err(ops.rotation_matrix(got), rot) <= max(jax_trip, 1e-6) + TOL


def test_axis_angle_from_matrix_batched_and_finite():
    aa = _axis_angles(np.linspace(0.0, np.pi, 48), seed=2).reshape(4, 12, 3)
    rot = ops.rotation_matrix(torch.from_numpy(aa))
    got = ops.axis_angle_from_matrix(rot)
    assert got.shape == (4, 12, 3) and torch.isfinite(got).all()
    want = jops.axis_angle_from_matrix(jnp.asarray(rot.numpy()))
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("scale", [1.0, 1e-3, 25.0])
def test_matrix_from_6d_equals_jax(scale):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 6)) * scale).astype(np.float32)
    got = ops.matrix_from_6d(torch.from_numpy(x))
    assert _err(got, jops.matrix_from_6d(jnp.asarray(x))) <= TOL
    if scale >= 1.0:   # at 1e-3 the eps guard (1e-12) shows in both
        rtr = torch.einsum("bij,bik->bjk", got, got)
        assert _err(rtr, np.broadcast_to(np.eye(3), rtr.shape)) <= 1e-5
        assert _err(torch.linalg.det(got), np.ones(64)) <= 1e-5


def test_matrix_to_6d_round_trip_equals_jax():
    aa = _axis_angles(np.random.default_rng(4).uniform(0, 3, 32), seed=4)
    rot = ops.rotation_matrix(torch.from_numpy(aa))
    six = ops.matrix_to_6d(rot)
    np.testing.assert_array_equal(
        six.numpy(), np.asarray(jops.matrix_to_6d(jnp.asarray(rot.numpy()))))
    assert _err(ops.matrix_from_6d(six), rot) <= 1e-5


def test_matrix_from_6d_gradients_finite():
    x = torch.zeros((2, 16, 6))
    x[..., 0] = 1.0
    x[..., 4] = 1.0
    x.requires_grad_(True)
    ops.matrix_from_6d(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_matrix_from_quaternion_equals_jax():
    from mano_hand_tpu.models.anim import _aa_to_quat

    rng = np.random.default_rng(15)
    aa = rng.normal(scale=1.0, size=(32, 3))
    q = _aa_to_quat(aa).astype(np.float32)
    want = jops.matrix_from_quaternion(jnp.asarray(q))
    for k in (1.0, 3.7, -1.0):   # scaled and negated: the same rotation
        got = ops.matrix_from_quaternion(torch.from_numpy(q * k))
        assert _err(got, jops.matrix_from_quaternion(jnp.asarray(q * k))) \
            <= TOL
        assert _err(got, want) <= 1e-5
    assert _err(ops.matrix_from_quaternion(torch.from_numpy(q)),
                ops.rotation_matrix(torch.from_numpy(aa.astype(np.float32)))
                ) <= 1e-5


# ------------------------------------------------------------------ normals
@pytest.fixture(scope="module")
def posed_mesh():
    """A posed synthetic mesh (float32 verts [2, V, 3]) and its faces."""
    p = jax_synthetic(seed=0).astype(np.float32)
    rng = np.random.default_rng(6)
    pose = jnp.asarray(rng.normal(scale=0.4, size=(2, 16, 3)), jnp.float32)
    beta = jnp.asarray(rng.normal(size=(2, 10)), jnp.float32)
    verts = np.array(jcore.forward_batched(p, pose, beta).verts)
    return verts, np.asarray(p.faces)


@pytest.mark.parametrize("normalize", [True, False])
def test_face_normals_equal_jax(posed_mesh, normalize):
    verts, faces = posed_mesh
    want = jops.face_normals(jnp.asarray(verts[0]), jnp.asarray(faces),
                             normalize=normalize)
    got = ops.face_normals(torch.from_numpy(verts[0]),
                           torch.from_numpy(faces), normalize=normalize)
    assert got.shape == (faces.shape[0], 3)
    assert _err(got, want) <= TOL


def test_vertex_normals_equal_jax(posed_mesh):
    verts, faces = posed_mesh
    f = torch.from_numpy(faces)
    got = ops.vertex_normals(torch.from_numpy(verts[0]), f)
    assert _err(got, jops.vertex_normals(jnp.asarray(verts[0]),
                                         jnp.asarray(faces))) <= TOL
    batched = ops.batched_vertex_normals(torch.from_numpy(verts), f)
    want = jops.batched_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    assert batched.shape == verts.shape
    assert _err(batched, want) <= TOL
    # The float64 NumPy twin the PLY writer uses agrees, in both packages.
    np64 = vertex_normals_np(verts[0], faces)
    np.testing.assert_array_equal(np64, jax_normals_np(verts[0], faces))
    assert _err(got, np64) <= 1e-5
    with pytest.raises(ValueError, match=r"\[B, V, 3\]"):
        ops.batched_vertex_normals(torch.from_numpy(verts[0]), f)


def test_vertex_normals_unreferenced_vertex_and_grad():
    verts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                          [5.0, 5.0, 5.0]], requires_grad=True)
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    n = ops.vertex_normals(verts, faces)
    want = jops.vertex_normals(jnp.asarray(verts.detach().numpy()),
                               jnp.asarray(faces.numpy()))
    assert _err(n.detach(), want) <= TOL
    assert n[3].abs().max() == 0.0          # no face: a zero normal
    np.testing.assert_allclose(n[0].detach().numpy(), [0, 0, 1])
    n[:, 2].sum().backward()
    assert torch.isfinite(verts.grad).all()
    g = jax.grad(lambda v: jops.vertex_normals(v, jnp.asarray(
        faces.numpy()))[:, 2].sum())(jnp.asarray(verts.detach().numpy()))
    assert _err(verts.grad, g) <= TOL
