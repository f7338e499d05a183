"""Two hands on the CPU: mirroring, stacked params, the two-hand forward,
K5's plain version and clip evaluation, against the JAX package.

Inputs are made with seeded NumPy and handed to both packages. JAX's K5
runs in interpret mode, as tests/test_pallas_forward.py runs it.

Tolerances: mirrored arrays equal exactly (sign flips); the mirror
invariant in float64 <= 1e-12; f32 forwards vs the JAX XLA path and vs
the interpret-mode JAX K5 <= 1e-5 (summation order, and the JAX kernel's
3-pass bf16 split of HIGH at about 2.6e-6); K5's plain version vs the
port's one-hand K1 route <= 1e-6 (the same packed arithmetic); the flat
pose form exactly; the NumPy resamplers <= 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import mirror as jmirror
from mano_hand_tpu.assets import scans as jscans
from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.models import anim as janim
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.ops import pallas_forward
from mano_hand_tpu_torch.assets import (
    ARRAY_FIELDS, mirror_params, mirror_pose, mirror_verts, synthetic_params,
)
from mano_hand_tpu_torch.assets import scans
from mano_hand_tpu_torch.models import anim, core
from mano_hand_tpu_torch.ops import fused_forward

TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).max())


@pytest.fixture(scope="module")
def pair():
    """(JAX left, JAX right, port left, port right), f32: seed 0 and its
    mirror in both packages."""
    jr = jax_synthetic(seed=0)
    tr = synthetic_params(seed=0, device="cpu")
    return (jmirror.mirror_params(jr).astype(np.float32),
            jr.astype(np.float32),
            mirror_params(tr).astype(torch.float32),
            tr.astype(torch.float32))


@pytest.fixture(autouse=True)
def _zero_counts():
    fused_forward.launches = 0
    fused_forward.hands_launches = 0


def _inputs(h, b, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(h, b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(h, b, 10)).astype(np.float32)
    return pose, beta


def test_mirror_arrays_equal_jax():
    rng = np.random.default_rng(1)
    pose = rng.normal(size=(4, 16, 3))
    verts = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(scans.MIRROR_AA, jscans.MIRROR_AA)
    np.testing.assert_array_equal(mirror_pose(pose), jscans.mirror_pose(pose))
    np.testing.assert_array_equal(mirror_verts(verts),
                                  jscans.mirror_verts(verts))
    np.testing.assert_array_equal(_np(mirror_pose(torch.from_numpy(pose))),
                                  jscans.mirror_pose(pose))
    jp = jmirror.mirror_params(jax_synthetic(seed=0))
    tp = mirror_params(synthetic_params(seed=0, device="cpu"))
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.side == jp.side == "left"
    assert mirror_params(tp).side == "right"


def test_mirror_invariant_float64():
    """forward(mirror(p), mirror_pose(pose), shape) == M forward(p, pose,
    shape), in float64 to 1e-12."""
    p = synthetic_params(seed=3, device="cpu")
    m = mirror_params(p)
    rng = np.random.default_rng(4)
    pose = torch.from_numpy(rng.normal(scale=0.6, size=(6, 16, 3)))
    shape = torch.from_numpy(rng.normal(size=(6, 10)))
    got = core.forward_batched(m, mirror_pose(pose), shape).verts
    want = mirror_verts(core.forward_batched(p, pose, shape).verts)
    assert got.dtype == torch.float64
    assert _err(got, want) <= 1e-12


def test_stack_params_refuses_mismatched_trees(pair):
    _, _, tl, tr = pair
    other = dataclasses.replace(tr, parents=(-1,) + (0,) * 15)
    with pytest.raises(ValueError, match="kinematic trees"):
        core.stack_params(tl, other)
    st = core.stack_params(tl, tr)
    assert st.side == "stacked" and st.sides == ("left", "right")
    assert (st.n_hands, st.n_verts, st.n_joints, st.n_shape) == (
        2, 778, 16, 10)
    assert st.v_template.shape == (2, 778, 3)
    assert torch.equal(st.hands[1].pose_basis, tr.pose_basis)
    assert st.hands is st.hands        # built once


def test_forward_hands_matches_jax(pair):
    jl, jr, tl, tr = pair
    pose, beta = _inputs(2, 6, seed=5)
    want = jcore.forward_hands(jcore.stack_params(jl, jr),
                               jnp.asarray(pose), jnp.asarray(beta))
    got = core.forward_hands(core.stack_params(tl, tr),
                             torch.from_numpy(pose), torch.from_numpy(beta))
    for name in ("verts", "joints", "rest_verts", "posed_joints"):
        a, b = getattr(got, name), getattr(want, name)
        assert tuple(a.shape) == tuple(b.shape), name
        assert _err(a, b) <= TOL, name


def test_k5_plain_matches_jax_interpret_kernel(pair):
    """Distinct L/R assets (seed 0 and its mirror), as in
    test_pallas_forward.py::test_full_fusion_hands_single_launch."""
    jl, jr, tl, tr = pair
    pose, beta = _inputs(2, 6, seed=9)
    pose[1] *= 0.5
    beta[1] = -beta[0]
    want = jcore.forward_hands_pallas_fused_full(
        jcore.stack_params(jl, jr), jnp.asarray(pose), jnp.asarray(beta),
        block_b=4, interpret=True)
    st = core.stack_params(tl, tr)
    pose_t, beta_t = torch.from_numpy(pose), torch.from_numpy(beta)
    got = core.forward_hands_pallas_fused_full(st, pose_t, beta_t)
    assert got.shape == (2, 6, 778, 3) and got.dtype == torch.float32
    assert _err(got, want) <= TOL
    # Each hand against the port's one-hand K1 route (its plain version).
    for h, prm in enumerate((tl, tr)):
        one = core.forward_batched_pallas_fused_full(prm, pose_t[h],
                                                     beta_t[h])
        assert _err(got[h], one) <= 1e-6
    flat = core.forward_hands_pallas_fused_full(st, pose_t.reshape(2, 6, 48),
                                                beta_t)
    assert _err(flat, got) == 0.0
    with pytest.raises(ValueError, match="pose must be"):
        core.forward_hands_pallas_fused_full(st, pose_t[0], beta_t[0])
    empty = core.forward_hands_pallas_fused_full(st, pose_t[:, :0],
                                                 beta_t[:, :0])
    assert empty.shape == (2, 0, 778, 3)
    assert fused_forward.hands_launches == 0    # CPU tensors: no kernel


def test_k5_wrapper_refuses_grad_and_follows_updates(pair):
    _, _, tl, tr = pair
    st = core.stack_params(tl, tr)
    pose, beta = (torch.from_numpy(x) for x in _inputs(2, 3, seed=2))
    with pytest.raises(ValueError, match="inference only"):
        fused_forward.forward_verts_fused_full_hands(
            st, pose.clone().requires_grad_(True), beta)
    with pytest.raises(ValueError, match="shape must be"):
        fused_forward.forward_verts_fused_full_hands(st, pose, beta[:, :2])
    ops1 = fused_forward.fused_operands_hands(st)
    assert fused_forward.fused_operands_hands(st) is ops1
    assert ops1.basis.shape == (2, 148, 3, 778)
    before = fused_forward.forward_verts_fused_full_hands(st, pose, beta)
    st.hands[1].v_template.add_(0.01)           # in place, through a view
    after = fused_forward.forward_verts_fused_full_hands(st, pose, beta)
    assert fused_forward.fused_operands_hands(st) is not ops1
    assert _err(after[0], before[0]) == 0.0
    assert abs(_err(after[1], before[1]) - 0.01) <= 1e-6


def test_evaluate_sequences_match_jax(pair):
    jl, jr, tl, tr = pair
    rng = np.random.default_rng(7)
    poses = rng.normal(scale=0.5, size=(5, 2, 16, 3)).astype(np.float32)
    shapes = rng.normal(size=(5, 2, 10)).astype(np.float32)
    want = janim.evaluate_two_hand_sequence(jl, jr, poses, shapes)
    got = anim.evaluate_two_hand_sequence(tl, tr, poses, shapes)
    assert got.shape == (5, 2, 778, 3)
    assert _err(got, want) <= TOL
    want0 = janim.evaluate_two_hand_sequence(jl, jr, poses)
    assert _err(anim.evaluate_two_hand_sequence(tl, tr, poses), want0) <= TOL
    one = janim.evaluate_sequence(jr, poses[:, 1], shapes[0, 1])
    assert _err(anim.evaluate_sequence(tr, poses[:, 1], shapes[0, 1]),
                one) <= TOL
    assert _err(anim.evaluate_sequence(tr, poses[:, 1]),
                janim.evaluate_sequence(jr, poses[:, 1])) <= TOL


def test_stack_cache_follows_in_place_updates():
    left = synthetic_params(seed=5, device="cpu").astype(torch.float32)
    right = mirror_params(left)
    poses = np.random.default_rng(8).normal(
        scale=0.5, size=(3, 2, 16, 3)).astype(np.float32)
    first = anim.evaluate_two_hand_sequence(left, right, poses)
    assert anim._stacked_cached(left, right) is anim._stacked_cached(
        left, right)
    right.v_template.add_(0.01)
    second = anim.evaluate_two_hand_sequence(left, right, poses)
    assert _err(second[:, 0], first[:, 0]) == 0.0
    assert abs(_err(second[:, 1], first[:, 1]) - 0.01) <= 1e-6


@pytest.mark.parametrize("n_frames", [5, 9, 17])
def test_resamplers_match_jax(n_frames):
    rng = np.random.default_rng(n_frames)
    poses = rng.normal(scale=1.2, size=(5, 16, 3))
    assert _err(anim.resample_poses(poses, n_frames),
                janim.resample_poses(poses, n_frames)) <= 1e-12
    assert _err(anim.resample_poses_slerp(poses, n_frames),
                janim.resample_poses_slerp(poses, n_frames)) <= 1e-12
    assert _err(anim._quat_to_aa(anim._aa_to_quat(poses[0])),
                janim._quat_to_aa(janim._aa_to_quat(poses[0]))) <= 1e-12
