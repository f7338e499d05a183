"""The two kernel modules on the CPU: their plain versions against the JAX
Pallas kernels (run in interpret mode, as tests/test_pallas_forward.py and
tests/test_pallas_posed.py run them) and the plain JAX paths.

On a CPU tensor each wrapper takes its kernel's plain version and counts
no launch; the CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: port vs the interpret-mode JAX kernels <= 1e-5 (the JAX
kernels' 3-pass bf16 split of HIGH measures about 2.6e-6 against f32);
port vs the port's own plain core <= 1e-5 (the same f32 arithmetic
grouped into one packed contraction).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.ops import pallas_forward, pallas_posed
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import (
    fk, fused_forward, fused_posed, fused_skin, lbs,
)
from mano_hand_tpu_torch.ops.common import einsum, round_bf16
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def assets():
    jp = jax_synthetic(seed=0).astype(np.float32)
    tp = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    return jp, tp


@pytest.fixture(autouse=True)
def _zero_counts():
    fused_forward.launches = 0
    fused_forward.blend_skin_launches = 0
    fused_posed.launches = 0
    fused_posed.bf16_launches = 0
    fused_skin.launches = 0


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(b, 10)).astype(np.float32)
    return pose, beta


def test_k1_plain_matches_jax_interpret_kernel(assets):
    jp, tp = assets
    pose, beta = _inputs(5)   # block_b=4 leaves a ragged second tile
    want = pallas_forward.forward_verts_fused_full(
        jp, jnp.asarray(pose), jnp.asarray(beta), block_b=4, interpret=True)
    got = core.forward_batched_pallas_fused_full(
        tp, torch.from_numpy(pose), torch.from_numpy(beta))
    assert got.shape == (5, 778, 3) and got.dtype == torch.float32
    assert _err(got, want) <= TOL
    assert fused_forward.launches == 0        # CPU tensors: no kernel


def test_k1_plain_matches_port_core(assets):
    _, tp = assets
    pose, beta = _inputs(7, seed=1)
    got = core.forward_batched_pallas_fused_full(
        tp, torch.from_numpy(pose.reshape(7, 48)), torch.from_numpy(beta))
    want = core.forward_batched(tp, torch.from_numpy(pose),
                                torch.from_numpy(beta)).verts
    assert _err(got, want) <= TOL
    empty = core.forward_batched_pallas_fused_full(
        tp, torch.zeros(0, 16, 3), torch.zeros(0, 10))
    assert empty.shape == (0, 778, 3)
    assert fused_forward.launches == 0


def test_k1_operands_are_packed_once_per_params(assets):
    _, tp = assets
    ops1 = fused_forward.fused_operands(tp)
    assert fused_forward.fused_operands(tp) is ops1
    # [beta | 1 | (R - I)] padded to a multiple of 4 rows.
    assert ops1.n_coef == 10 + 1 + 135
    assert ops1.basis.shape == (148, 3, 778) and ops1.basis.is_contiguous()
    assert float(ops1.basis[146:].abs().max()) == 0.0
    assert torch.allclose(ops1.basis[10], tp.v_template.T)
    assert ops1.wt.shape == (16, 778) and ops1.jb.shape == (16, 3, 11)


def _untile(tiles, n_verts):
    """A plain reader of K1/K5's vertex-tiled layout: [nsub, ..., T] back
    to [..., V]."""
    return tiles.movedim(0, -2).flatten(-2)[..., :n_verts]


@pytest.mark.parametrize("n_joints,n_verts", [(16, 778), (7, 13), (5, 128)])
def test_k1_tiled_operands_read_back_to_the_plain_forward(n_joints, n_verts):
    """The kernels' tiled basis and weights (the one packed copy) hold the
    packed operands, the padding zero: read back plainly they equal a
    direct packing of the params bit for bit, and ``basis``/``wt`` are that
    read-back; the plain forward over them follows the port's core, and
    after an in-place template update they repack with it."""
    tp = synthetic_params(seed=3, n_joints=n_joints, n_verts=n_verts,
                          n_faces=20, device="cpu").astype(torch.float32)
    tp = dataclasses.replace(tp, v_template=tp.v_template.clone())
    ops = fused_forward.fused_operands(tp)
    t = fused_forward.VERT_TILE
    nsub = -(-n_verts // t)
    assert ops.basis_tiles.shape == (nsub, ops.kpad, 3, t)
    assert ops.wt_tiles.shape == (nsub, n_joints, t)
    assert ops.basis_tiles.is_contiguous() and ops.wt_tiles.is_contiguous()
    pad = nsub * t - n_verts
    if pad:
        assert float(ops.basis_tiles[-1, ..., t - pad:].abs().max()) == 0.0
        assert float(ops.wt_tiles[-1, :, t - pad:].abs().max()) == 0.0
    k = ops.n_coef
    direct = torch.cat([tp.shape_basis.permute(2, 1, 0), tp.v_template.T[None],
                        tp.pose_basis.permute(2, 1, 0),
                        torch.zeros(ops.kpad - k, 3, n_verts)])
    assert torch.equal(_untile(ops.basis_tiles, n_verts), direct)
    assert torch.equal(_untile(ops.wt_tiles, n_verts), tp.lbs_weights.T)
    assert torch.equal(ops.basis, direct) and ops.basis.is_contiguous()
    assert torch.equal(ops.wt, tp.lbs_weights.T) and ops.wt.is_contiguous()
    rng = np.random.default_rng(n_verts)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(3, n_joints, 3))
                            .astype(np.float32))
    shape = torch.from_numpy(rng.normal(size=(3, 10)).astype(np.float32))
    want = fused_forward.forward_verts_plain(ops, pose, shape)
    assert _err(want, core.forward_batched(tp, pose, shape).verts) <= TOL
    with torch.no_grad():
        tp.v_template.add_(0.01)
    moved = fused_forward.forward_verts_plain(
        fused_forward.fused_operands(tp), pose, shape)
    assert _err(moved, want + 0.01) <= TOL


def _posed_setup(jp, tp, c, seed):
    _, beta = _inputs(c, seed=seed)
    jtab = jcore.stack_shaped([jcore.specialize(jp, jnp.asarray(b))
                               for b in beta])
    ttab = core.stack_shaped([core.specialize(tp, torch.from_numpy(b))
                              for b in beta])
    return jtab, ttab


def test_k2_plain_matches_jax_interpret_kernel(assets):
    jp, tp = assets
    jtab, ttab = _posed_setup(jp, tp, 3, seed=2)
    pose, _ = _inputs(5, seed=3)
    idx = np.array([1, 0, 2, 2, 1], np.int32)
    want = pallas_posed.forward_posed_gather_fused(
        jtab, jnp.asarray(idx), jnp.asarray(pose), block_b=4,
        interpret=True)
    got = core.forward_posed_gather_fused(ttab, torch.from_numpy(idx),
                                          torch.from_numpy(pose))
    assert got.shape == (5, 778, 3)
    assert _err(got, want) <= TOL
    assert fused_posed.launches == 0


def test_k2_plain_matches_port_gather_and_clamps(assets):
    """Out-of-range indices map to rows as JAX's XLA gather maps them
    (negative ones wrap once, then every index is clamped), in the plain
    K2 version as in the port's gather."""
    jp, tp = assets
    c = 3
    jtab, ttab = _posed_setup(jp, tp, c, seed=4)
    wild = np.array([-c - 3, -c, -3, -1, 0, c - 1, c, c + 7], np.int32)
    pose, _ = _inputs(len(wild), seed=5)
    got = core.forward_posed_gather_fused(ttab, torch.from_numpy(wild),
                                          torch.from_numpy(pose))
    want = jcore.forward_posed_gather(jtab, jnp.asarray(wild),
                                      jnp.asarray(pose)).verts
    assert _err(got, want) <= TOL
    plain = core.forward_posed_gather(ttab, torch.from_numpy(wild),
                                      torch.from_numpy(pose)).verts
    assert _err(got, plain) <= TOL
    assert fused_posed.launches == 0


def test_k2_operands_cached_across_table_updates(assets):
    _, tp = assets
    table = core.subject_table(tp, 2)
    first = fused_posed.posed_operands(table)
    shaped = core.specialize(tp, torch.ones(10))
    later = core.table_grow(core.table_set_row(table, 0, shaped), 4)
    assert fused_posed.posed_operands(later) is first
    assert first.basis_tiles.shape == (7, 136, 3, 128)
    assert first.basis.shape == (136, 3, 778)


def _old_k2_plain(table, idx, pose, bf16):
    """K2's plain version as it read its untiled operands before they were
    tiled (the basis [cdiv(P, 4) 4, 3, V], the weights [J, V], each
    rounded to bf16 for the bf16 tier), with the index mapping of
    ``core.forward_posed_gather``."""
    v, _, p = table.pose_basis.shape
    basis = torch.cat([table.pose_basis.permute(2, 1, 0).float(),
                       torch.zeros(-(-p // 4) * 4 - p, 3, v)])
    wt = table.lbs_weights.T.float().contiguous()
    if bf16:
        basis, wt = basis.to(torch.bfloat16), wt.to(torch.bfloat16)
    b = pose.shape[0]
    r = idx.long()
    r = torch.where(r < 0, r + table.capacity, r).clamp(0, table.capacity - 1)
    rot = rotation_matrix(pose)
    coef = (rot[:, 1:] - torch.eye(3)).flatten(1)
    coef = torch.cat([coef, coef.new_zeros(b, basis.shape[0] - p)], 1)
    if bf16:
        coef = round_bf16(coef)
    v_posed = table.v_shaped[r] + einsum("bk,kcv->bvc", coef, basis.float())
    j_rows = table.joints[r]
    world_rot, world_t = fk.forward_kinematics(tuple(table.parents), rot,
                                               j_rows)
    _, skin_t = fk.skinning_transforms(world_rot, world_t, j_rows)
    if bf16:
        world_rot, skin_t = round_bf16(world_rot), round_bf16(skin_t)
    return lbs.skin(wt.T.float(), world_rot, skin_t, v_posed)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_joints,n_verts", [(16, 778), (7, 13), (24, 128)])
def test_k2_tiled_operands_read_back_to_the_plain_version(bf16, n_joints,
                                                          n_verts):
    """K2's packs in the kernels' tiled layouts (Ppad 136 in f32, 144 in
    bf16 at MANO width; bf16 weights vertex-major, J padded to 16), the
    padding zero; read back plainly they equal a direct packing of the
    asset, and the plain version over them is bit for bit what it was over
    the untiled packs."""
    tp = synthetic_params(seed=3, n_joints=n_joints, n_verts=n_verts,
                          n_faces=20, device="cpu").astype(torch.float32)
    rng = np.random.default_rng(n_verts)
    betas = torch.from_numpy(rng.normal(size=(3, 10)).astype(np.float32))
    table = core.stack_shaped([core.specialize(tp, bt) for bt in betas])
    dt = torch.bfloat16 if bf16 else None
    ops = fused_posed.posed_operands(table, dt)
    t = fused_forward.VERT_TILE
    nsub, p = -(-n_verts // t), 9 * (n_joints - 1)
    step = 16 if bf16 else 4
    kpad = -(-p // step) * step
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert ops.basis_tiles.dtype == ops.wt_tiles.dtype == dtype
    assert ops.basis_tiles.shape == (nsub, kpad, 3, t)
    assert ops.basis_tiles.is_contiguous() and ops.wt_tiles.is_contiguous()
    basis = _untile(ops.basis_tiles, n_verts)
    want = table.pose_basis.permute(2, 1, 0).to(dtype)
    assert torch.equal(basis[:p], want)
    assert not basis[p:].any()
    weights = table.lbs_weights.to(dtype)
    if bf16:
        jpad = -(-n_joints // 16) * 16
        assert ops.wt_tiles.shape == (nsub, t, jpad)
        flat = ops.wt_tiles.flatten(0, 1)
        assert torch.equal(flat[:n_verts, :n_joints], weights)
        assert not flat[:, n_joints:].any() and not flat[n_verts:].any()
    else:
        assert ops.wt_tiles.shape == (nsub, n_joints, t)
        assert torch.equal(_untile(ops.wt_tiles, n_verts), weights.T)
    assert torch.equal(ops.wt, weights.T) and ops.wt.is_contiguous()
    assert ops.basis.shape == (-(-p // 4) * 4, 3, n_verts)
    idx = torch.tensor([2, -1, 0, 5, 1], dtype=torch.int32)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(5, n_joints, 3))
                            .astype(np.float32))
    got = core.forward_posed_gather_fused(table, idx, pose,
                                          compute_dtype=dt)
    assert torch.equal(got, _old_k2_plain(table, idx, pose, bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,c", [(1, 1), (7, 1), (33, 1), (1, 3), (7, 3),
                                 (33, 3)])
def test_k2_tiled_plain_matches_jax(assets, bf16, b, c):
    """Both plain versions over the tiled packs against JAX: f32 against
    the interpret-mode Pallas K2, bf16 against JAX's XLA bf16 family (the
    interpreter runs the kernel's bf16 dots in f32)."""
    jp, tp = assets
    jtab, ttab = _posed_setup(jp, tp, c, seed=20 + c)
    pose, _ = _inputs(b, seed=b)
    idx = np.random.default_rng(b + c).integers(0, c, size=b).astype(
        np.int32)
    if bf16:
        want = jcore.forward_posed_gather(
            jtab, jnp.asarray(idx), jnp.asarray(pose),
            compute_dtype=jnp.bfloat16).verts
    else:
        want = pallas_posed.forward_posed_gather_fused(
            jtab, jnp.asarray(idx), jnp.asarray(pose), block_b=8,
            interpret=True)
    got = core.forward_posed_gather_fused(
        ttab, torch.from_numpy(idx), torch.from_numpy(pose),
        compute_dtype=torch.bfloat16 if bf16 else None)
    assert got.shape == (b, 778, 3)
    assert _err(got, want) <= TOL
    assert fused_posed.launches == fused_posed.bf16_launches == 0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("field", ["pose_basis", "lbs_weights"])
def test_k2_packs_follow_in_place_asset_updates(assets, bf16, field):
    """An in-place update of the table's pose basis or weights repacks
    both forms: the plain version follows the port's gather."""
    _, tp = assets
    prm = dataclasses.replace(
        tp, **{f: getattr(tp, f).clone() for f in FORWARD_FIELDS})
    pose, beta = _inputs(4, seed=30)
    pose, beta = torch.from_numpy(pose), torch.from_numpy(beta)
    table = core.stack_shaped([core.specialize(prm, bt) for bt in beta[:3]])
    idx = torch.tensor([2, 0, -1, 1], dtype=torch.int32)
    dt = torch.bfloat16 if bf16 else None
    first = fused_posed.posed_operands(table, dt)
    before = core.forward_posed_gather_fused(table, idx, pose,
                                             compute_dtype=dt)
    delta = torch.from_numpy(np.random.default_rng(31).normal(
        scale=0.01, size=tuple(getattr(prm, field).shape)).astype(np.float32))
    with torch.no_grad():
        getattr(prm, field).add_(delta)
    assert fused_posed.posed_operands(table, dt) is not first
    got = core.forward_posed_gather_fused(table, idx, pose, compute_dtype=dt)
    want = core.forward_posed_gather(table, idx, pose, compute_dtype=dt).verts
    assert _err(got, want) <= TOL
    assert _err(got, before) > 1e-3                    # it really moved


@pytest.mark.parametrize("case,exc,match", [
    ("grad", ValueError, "inference only"),
    ("f64", ValueError, "float32"),
    ("shape", ValueError, "shape must be"),
    ("tree", ValueError, "topologically ordered"),
])
def test_k1_wrapper_rejects(assets, case, exc, match):
    _, tp = assets
    pose = torch.zeros(2, 16, 3)
    shape = torch.zeros(2, 10)
    params = tp
    if case == "grad":
        pose.requires_grad_(True)
    elif case == "f64":
        pose = pose.double()
    elif case == "shape":
        shape = torch.zeros(3, 10)
    elif case == "tree":
        params = dataclasses.replace(
            tp, parents=tp.parents[:3] + (5,) + tp.parents[4:])
    with pytest.raises(exc, match=match):
        fused_forward.forward_verts_fused_full(params, pose, shape)


@pytest.mark.parametrize("case,exc,match", [
    ("f16", ValueError, "compute_dtype"),
    ("idx_dtype", ValueError, "int32"),
    ("idx_len", ValueError, "subject_idx must be"),
    ("grad", ValueError, "inference only"),
])
def test_k2_wrapper_rejects(assets, case, exc, match):
    jp, tp = assets
    _, ttab = _posed_setup(jp, tp, 2, seed=6)
    pose = torch.zeros(3, 16, 3)
    idx = torch.zeros(3, dtype=torch.int32)
    kw = {}
    if case == "f16":     # bf16 is the one reduced tier
        kw["compute_dtype"] = torch.float16
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "idx_len":
        idx = idx[:2]
    elif case == "grad":
        pose.requires_grad_(True)
    with pytest.raises(exc, match=match):
        fused_posed.forward_posed_gather_fused(ttab, idx, pose, **kw)


@pytest.mark.parametrize("field", ["v_template", "pose_basis",
                                   "lbs_weights"])
@pytest.mark.parametrize("route", ["K1", "K4", "K2"])
def test_kernel_routes_follow_in_place_param_updates(assets, route, field):
    """After an in-place update of a parameter tensor (an optimizer
    step), the packed operands are rebuilt: each route (its plain version
    on the CPU) follows the unfused path to <= 1e-5. K2's table shares
    ``pose_basis`` and ``lbs_weights`` with the params; its baked
    ``v_shaped`` is re-baked after a template update, as the engine does."""
    _, tp = assets
    prm = dataclasses.replace(
        tp, **{f: getattr(tp, f).clone() for f in FORWARD_FIELDS})
    pose, beta = _inputs(4, seed=10)
    pose, beta = torch.from_numpy(pose), torch.from_numpy(beta)
    idx = torch.tensor([2, 0, 1, 2], dtype=torch.int32)

    def table():
        return core.stack_shaped([core.specialize(prm, b) for b in beta[:3]])

    tab = table()

    def run():
        if route == "K1":
            return core.forward_batched_pallas_fused_full(prm, pose, beta)
        if route == "K4":
            return core.forward_batched_pallas_fused(prm, pose, beta)
        return core.forward_posed_gather_fused(tab, idx, pose)

    before = run()
    delta = torch.from_numpy(np.random.default_rng(11).normal(
        scale=0.01, size=tuple(getattr(prm, field).shape)).astype(np.float32))
    with torch.no_grad():
        getattr(prm, field).add_(delta)
    if route == "K2" and field == "v_template":
        tab = table()
    got = run()
    rows = beta[idx.long()] if route == "K2" else beta
    want = core.forward_batched(prm, pose, rows, fused=False).verts
    assert _err(got, want) <= TOL
    assert _err(got, before) > 1e-3                    # it really moved
    assert (fused_forward.launches, fused_forward.blend_skin_launches,
            fused_posed.launches) == (0, 0, 0)


def test_k4_plain_matches_port_core(assets):
    _, tp = assets
    pose, beta = _inputs(6, seed=12)
    got = core.forward_batched_pallas_fused(
        tp, torch.from_numpy(pose.reshape(6, 48)), torch.from_numpy(beta))
    want = core.forward_batched(tp, torch.from_numpy(pose),
                                torch.from_numpy(beta)).verts
    assert got.shape == (6, 778, 3) and _err(got, want) <= TOL
    empty = core.forward_batched_pallas_fused(
        tp, torch.zeros(0, 16, 3), torch.zeros(0, 10))
    assert empty.shape == (0, 778, 3)
    assert fused_forward.blend_skin_launches == 0


def test_k3_plain_matches_port_core(assets):
    _, tp = assets
    pose, beta = _inputs(6, seed=13)
    got = core.forward_batched_pallas(tp, torch.from_numpy(pose),
                                      torch.from_numpy(beta))
    want = core.forward_batched(tp, torch.from_numpy(pose),
                                torch.from_numpy(beta)).verts
    assert got.shape == (6, 778, 3) and _err(got, want) <= TOL
    empty = core.forward_batched_pallas(tp, torch.zeros(0, 16, 3),
                                        torch.zeros(0, 10))
    assert empty.shape == (0, 778, 3)
    assert fused_skin.launches == 0


def _skin_args(b=3, v=20, j=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((v, j)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    return [torch.from_numpy(a) for a in (
        w, rng.normal(size=(b, j, 3, 3)).astype(np.float32),
        rng.normal(size=(b, j, 3)).astype(np.float32),
        rng.normal(scale=0.1, size=(b, v, 3)).astype(np.float32))]


@pytest.mark.parametrize("transpose_r", [False, True])
@pytest.mark.parametrize("with_t", [True, False])
def test_k3_plain_options_equal_the_explicit_call(transpose_r, with_t):
    """``transpose_r`` and ``t=None`` compute bit for bit what the explicit
    transposed copy and zero translations computed, in the plain version
    and in the wrapper's CPU path (no launch)."""
    w, rot, t, vp = _skin_args(seed=int(transpose_r) + 2 * int(with_t))
    want = fused_skin.skin_batched_plain(
        w, rot.transpose(-1, -2).contiguous() if transpose_r else rot,
        t if with_t else torch.zeros_like(t), vp)
    opt_t = t if with_t else None
    got = fused_skin.skin_batched_plain(w, rot, opt_t, vp,
                                        transpose_r=transpose_r)
    assert torch.equal(got, want)
    assert torch.equal(fused_skin.skin_batched(
        w, rot, opt_t, vp, transpose_r=transpose_r), want)
    assert fused_skin.launches == 0


@pytest.mark.parametrize("route", ["K3", "K1"])
def test_k3_backward_reads_the_rotations_in_place(assets, monkeypatch, route):
    """The vertex cotangent of every route's backward is one K3 call on the
    saved rotations themselves (``transpose_r``, no t): no transposed copy,
    no zero translations."""
    calls = []
    real = fused_skin.skin_batched

    def spy(weights, rot, t, v_posed, **kw):
        calls.append((rot, t, kw))
        return real(weights, rot, t, v_posed, **kw)

    monkeypatch.setattr(fused_skin, "skin_batched", spy)
    if route == "K3":
        args = [a.requires_grad_(True) for a in _skin_args(seed=5)]
        (fused_skin.skin_batched_ad(*args) ** 2).sum().backward()
        fwd_rot, fwd_t, fwd_kw = calls[0]
        assert fwd_t is not None and fwd_kw == {}
        assert calls[1][0].data_ptr() == args[1].data_ptr()
    else:
        _, tp = assets
        pose, beta = _inputs(3, seed=6)
        pose = torch.from_numpy(pose).requires_grad_(True)
        core.forward_batched_pallas_fused_full(
            tp, pose, torch.from_numpy(beta)).sum().backward()
        assert pose.grad is not None
    rot, t, kw = calls[-1]
    assert t is None and kw == {"transpose_r": True}
    assert rot.is_contiguous()


@pytest.mark.parametrize("case,match", [
    ("grad", "inference only"),
    ("f64", "float32"),
    ("strided", "contiguous"),
    ("shape", "must be"),
    ("tree", "at most 64 joints"),
])
def test_k3_wrapper_rejects(case, match):
    j = 65 if case == "tree" else 16
    w = torch.full((20, j), 1.0 / j)
    rot = torch.eye(3).expand(2, j, 3, 3).contiguous()
    t = torch.zeros(2, j, 3)
    vp = torch.zeros(2, 20, 3)
    if case == "grad":
        vp.requires_grad_(True)
    elif case == "f64":
        t = t.double()
    elif case == "strided":
        rot = rot.transpose(-1, -2)
    elif case == "shape":
        vp = torch.zeros(2, 21, 3)
    with pytest.raises(ValueError, match=match):
        fused_skin.skin_batched(w, rot, t, vp)


@pytest.mark.parametrize("case,match", [
    ("grad", "inference only"),
    ("coef", "coef must be"),
    ("strided", "contiguous"),
])
def test_k4_wrapper_rejects(assets, case, match):
    _, tp = assets
    ops = fused_forward.fused_operands(tp)
    coef = torch.zeros(2, ops.kpad)
    rot = torch.eye(3).expand(2, 16, 3, 3).contiguous()
    t = torch.zeros(2, 16, 3)
    if case == "grad":
        coef.requires_grad_(True)
    elif case == "coef":
        coef = torch.zeros(2, ops.n_coef)
    elif case == "strided":
        rot = rot.transpose(-1, -2)
    with pytest.raises(ValueError, match=match):
        fused_forward.blend_skin_fused(ops, coef, rot, t)


def test_kernel_modules_import_without_triton_or_nvcc():
    """Importing the kernel modules compiles and imports nothing: the
    build happens at the first CUDA launch."""
    code = (
        "import sys\n"
        "from mano_hand_tpu_torch.ops import _build, fused_forward, "
        "fused_posed, fused_skin\n"
        "from mano_hand_tpu_torch.models import core\n"
        "assert 'triton' not in sys.modules\n"
        "assert _build._lib is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
