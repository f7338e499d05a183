"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test here needs an NVIDIA card and skips without
one (the CUDA kernels have no CPU or interpret mode). On a machine with
a card, run them without the JAX test harness (``tests/conftest.py``
imports JAX), registering the marker on the command line:

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs an NVIDIA card" tests/test_torch_cuda.py

Shapes cover what ``chip_smoke.py`` does not: ragged and tiny batches,
generic kinematic trees (J = 7 to 64), V from 1 to 778, rows that are
not 16-byte aligned, subject tables of 1 to 1000 rows and out-of-range
(negative: wrapped once) subject indices. Tolerance: kernel vs plain
version, both fp32 with TF32 off, <= 1e-5 (summation order only; K2's
bf16 tier too, whose roundings act on bit-equal values in both and whose
bf16 products, exact in fp32, accumulate in fp32 on the tensor cores).
K2-bf16 vs f32 K2: nonzero and inside the policy's stated envelope
(2e-3 m). Gradients through the three kernel routes against autograd of
the plain path: the JAX tests' relative bar, max|a - b| / max(1,
max|b|) < 1e-4.
"""

import dataclasses


import numpy as np
import pytest
import torch

from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS as FIELDS
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import fused_forward, fused_posed, fused_skin
from mano_hand_tpu_torch.serving import PrecisionPolicy, ServingEngine
from mano_hand_tpu_torch.serving.precision import DEFAULT_ENVELOPE_M

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(dev, n_joints=16, n_verts=778, n_shape=10):
    if n_verts < 3:   # the generator's faces need 3 vertices: cut them off
        p = _params(dev, n_joints, 3, n_shape)
        return dataclasses.replace(
            p, v_template=p.v_template[:n_verts].contiguous(),
            shape_basis=p.shape_basis[:n_verts].contiguous(),
            pose_basis=p.pose_basis[:n_verts].contiguous(),
            j_regressor=p.j_regressor[:, :n_verts].contiguous(),
            lbs_weights=p.lbs_weights[:n_verts].contiguous())
    return synthetic_params(seed=1, n_joints=n_joints, n_verts=n_verts,
                            n_shape=n_shape, n_faces=50,
                            dtype=torch.float32, device=dev)


def _err(a, b):
    a, b = (torch.as_tensor(x).detach().double().cpu() for x in (a, b))
    return float((a - b).abs().max())


def _k1(params, b, seed=0):
    rng = np.random.default_rng(seed)
    pose = torch.from_numpy(rng.normal(
        scale=0.5, size=(b, params.n_joints, 3)).astype(np.float32))
    shape = torch.from_numpy(rng.normal(
        size=(b, params.n_shape)).astype(np.float32))
    dev = params.device
    before = fused_forward.launches
    got = core.forward_batched_pallas_fused_full(params, pose.to(dev),
                                                 shape.to(dev))
    torch.cuda.synchronize()
    assert fused_forward.launches == before + 1
    want = fused_forward.forward_verts_plain(
        fused_forward.fused_operands(params), pose.to(dev), shape.to(dev))
    return got, want


# B one below, at and one above the 8-row tile and its multiples; on 132
# SMs MANO takes 8-row tiles up to B = 288, then 16, 32 (577 to 1152) and
# 64 rows (with_row_tile), each ragged here (300, 1000, 2000).
@pytest.mark.parametrize("b", [1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 257,
                               300, 1000, 2000])
def test_k1_kernel_matches_plain(dev, b):
    got, want = _k1(_params(dev), b)
    assert got.shape == (b, 778, 3) and bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL


# J = 64 takes the 8-row tile (B = 7, 8, 9 straddle it), J = 40 the
# 16-row one; V = 1 and 13 leave one ragged vertex tile; S != 10.
@pytest.mark.parametrize("n_joints,n_verts,n_shape,b", [
    (7, 300, 10, 45), (40, 300, 10, 45), (64, 778, 10, 7),
    (64, 778, 10, 8), (64, 300, 10, 9), (16, 1, 10, 33),
    (16, 13, 10, 33), (16, 778, 4, 33), (16, 300, 23, 70),
])
def test_k1_generic_tree(dev, n_joints, n_verts, n_shape, b):
    params = _params(dev, n_joints=n_joints, n_verts=n_verts,
                     n_shape=n_shape)
    got, want = _k1(params, b, seed=n_joints)
    assert got.shape == (b, n_verts, 3)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("split", [1, 2, 3, 4, 7, 9])
def test_k1_every_vertex_split_matches_plain(dev, split):
    """Each vertex split (sub-tile spans per row tile; 7 sub-tiles of 128
    for V = 778, so 2, 3 and 4 leave a short last span) gives the plain
    forward; B = 45 is not a multiple of the row tile."""
    params = _params(dev)
    ops = fused_forward.fused_operands(params)
    rng = np.random.default_rng(split)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(1, 45, 16, 3))
                            .astype(np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(1, 45, 10)).astype(
        np.float32)).to(dev)
    got = fused_forward._launch_forward(ops, pose, shape, split=split)[0]
    torch.cuda.synchronize()
    want = fused_forward.forward_verts_plain(ops, pose[0], shape[0])
    assert _err(got, want) <= TOL


def test_k1_follows_an_in_place_template_update(dev):
    """``v_template.add_`` between two launches repacks the tiled operands:
    the second launch moves by the update (a translation of the mesh)."""
    params = _params(dev)
    params = dataclasses.replace(params, v_template=params.v_template.clone())
    before, _ = _k1(params, 40)
    with torch.no_grad():
        params.v_template.add_(0.01)
    after, want = _k1(params, 40)
    assert _err(after, want) <= TOL
    assert _err(after, before + 0.01) <= TOL


def _table(params, c, seed=2):
    rng = np.random.default_rng(seed)
    betas = torch.from_numpy(rng.normal(size=(c, params.n_shape)).astype(
        np.float32)).to(params.device)
    return core.stack_shaped([core.specialize(params, bt) for bt in betas])


@pytest.mark.parametrize("c,b", [(1, 1), (3, 45), (700, 1024)])
def test_k2_kernel_matches_plain_and_clamps(dev, c, b):
    """Against the port's gather, which maps indices as JAX's does: a
    negative index i selects row i + C, then all are clamped."""
    params = _params(dev)
    table = _table(params, c)
    rng = np.random.default_rng(c)
    idx = rng.integers(-2, c + 2, size=b).astype(np.int32)
    wild = [-c - 3, -c, -3, -1, 0, c - 1, c, c + 7][:b]
    idx[:len(wild)] = wild
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(b, 16, 3)).astype(
        np.float32)).to(dev)
    idx_t = torch.from_numpy(idx).to(dev)
    before = fused_posed.launches
    got = core.forward_posed_gather_fused(table, idx_t, pose)
    torch.cuda.synchronize()
    assert fused_posed.launches == before + 1
    want = core.forward_posed_gather(table, idx_t, pose).verts
    assert _err(got, want) <= TOL


@pytest.fixture(scope="module")
def k2_tables(dev):
    """A MANO-width subject table per capacity (built once)."""
    params = _params(dev)
    return {c: _table(params, c, seed=c) for c in (1, 64, 1000)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [1, 64, 1000])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 63, 65, 255, 256, 1024, 4099])
def test_k2_both_variants_match_plain(dev, k2_tables, bf16, c, b):
    """Each row tile and vertex split the launch picks, against the plain
    version over the same packs: indices over [-C - 3, C + 8) (negative
    ones wrap, every subject row is as likely odd as even — an odd row of
    v_shaped is only 8-byte aligned)."""
    table = k2_tables[c]
    rng = np.random.default_rng(b * 7 + c)
    idx = torch.from_numpy(rng.integers(-c - 3, c + 8, size=b).astype(
        np.int32)).to(dev)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(b, 16, 3)).astype(
        np.float32)).to(dev)
    dt = torch.bfloat16 if bf16 else None
    count = "bf16_launches" if bf16 else "launches"
    before = getattr(fused_posed, count)
    got = core.forward_posed_gather_fused(table, idx, pose, compute_dtype=dt)
    torch.cuda.synchronize()
    assert getattr(fused_posed, count) == before + 1
    want = fused_posed.forward_posed_gather_plain(
        table.v_shaped, table.joints, idx, pose,
        fused_posed.posed_operands(table, dt), table.parents)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_joints", [7, 24, 64])
def test_k2_generic_tree(dev, bf16, n_joints):
    """Generic trees in both variants: J padded to whole 16-joint mma
    steps in bf16 (24 -> 32), up to kMaxJoints = 64 (the smallest row
    tile)."""
    params = _params(dev, n_joints=n_joints, n_verts=300)
    table = _table(params, 5)
    rng = np.random.default_rng(7)
    idx_t = torch.from_numpy(rng.integers(-5, 5, size=40).astype(
        np.int32)).to(dev)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(
        40, n_joints, 3)).astype(np.float32)).to(dev)
    dt = torch.bfloat16 if bf16 else None
    got = core.forward_posed_gather_fused(table, idx_t, pose,
                                          compute_dtype=dt)
    want = core.forward_posed_gather(table, idx_t, pose,
                                     compute_dtype=dt).verts
    assert _err(got, want) <= TOL


def _pair(dev, n_joints=16, n_verts=778):
    right = _params(dev, n_joints, n_verts)
    return core.stack_params(mirror_params(right), right)


@pytest.mark.parametrize("b,n_joints", [(1, 16), (33, 16), (1000, 16),
                                        (45, 7), (17, 64)])
def test_k5_kernel_matches_plain_and_k1(dev, b, n_joints):
    stacked = _pair(dev, n_joints, 778 if n_joints == 16 else 300)
    rng = np.random.default_rng(b)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(
        2, b, n_joints, 3)).astype(np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(2, b, 10)).astype(
        np.float32)).to(dev)
    before = fused_forward.hands_launches
    got = core.forward_hands_pallas_fused_full(stacked, pose, shape)
    torch.cuda.synchronize()
    assert fused_forward.hands_launches == before + 1
    assert got.shape == (2, b, stacked.n_verts, 3)
    want = fused_forward.forward_verts_hands_plain(
        fused_forward.fused_operands_hands(stacked), pose, shape)
    assert _err(got, want) <= TOL
    k1 = fused_forward.launches
    for h, hand in enumerate(stacked.hands):
        one = fused_forward.forward_verts_fused_full(hand, pose[h], shape[h])
        assert _err(got[h], one) <= TOL
    assert fused_forward.launches == k1 + 2


@pytest.mark.parametrize("c,b", [(1, 1), (3, 45), (700, 1024)])
def test_k2_bf16_kernel_matches_plain_and_envelope(dev, c, b):
    params = _params(dev)
    table = _table(params, c)
    rng = np.random.default_rng(c + 1)
    idx_t = torch.from_numpy(rng.integers(-2, c + 2, size=b).astype(
        np.int32)).to(dev)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(b, 16, 3)).astype(
        np.float32)).to(dev)
    bf16, f32 = fused_posed.bf16_launches, fused_posed.launches
    got = core.forward_posed_gather_fused(table, idx_t, pose,
                                          compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_posed.bf16_launches == bf16 + 1
    assert fused_posed.launches == f32
    want = core.forward_posed_gather(table, idx_t, pose,
                                     compute_dtype=torch.bfloat16).verts
    assert _err(got, want) <= TOL
    full = core.forward_posed_gather_fused(table, idx_t, pose)
    assert 1e-6 < _err(got, full) <= DEFAULT_ENVELOPE_M


def test_engine_tiers_on_the_card(dev):
    params = _params(dev)
    rng = np.random.default_rng(6)
    betas = rng.normal(size=(4, 10)).astype(np.float32)
    eng = ServingEngine(params, max_bucket=64, max_delay_s=0.05,
                        posed_kernel="fused",
                        precision_policy=PrecisionPolicy())
    poses = [rng.normal(scale=0.5, size=(int(n), 16, 3)).astype(np.float32)
             for n in rng.integers(1, 9, size=8)]
    f32, bf16 = fused_posed.launches, fused_posed.bf16_launches
    with eng:
        keys = [eng.specialize(bt) for bt in betas]
        eng.warmup_posed([8, 64])
        futs = [eng.submit(p, subject=keys[i % 4], priority=i % 2)
                for i, p in enumerate(poses)]
        outs = [f.result(timeout=120) for f in futs]
    assert fused_posed.launches > f32 and fused_posed.bf16_launches > bf16
    table = eng.table
    envelope = eng.precision_policy.max_vertex_err_m
    for i, (p, o) in enumerate(zip(poses, outs)):
        slot = eng._subject_slots[keys[i % 4]]
        idx = torch.full((p.shape[0],), slot, dtype=torch.int32, device=dev)
        pose = torch.from_numpy(p).to(dev)
        err = _err(torch.from_numpy(o), core.forward_posed_gather_fused(
            table, idx, pose))
        if i % 2:
            assert err <= TOL, (i, err)
        else:
            assert 1e-6 < err <= envelope, (i, err)
            want = core.forward_posed_gather(
                table, idx, pose, compute_dtype=torch.bfloat16).verts
            assert _err(torch.from_numpy(o), want) <= TOL, i
    snap = eng.counters.snapshot()
    assert 1 <= snap["dispatches_bf16"] < snap["dispatches"]


def test_wrappers_raise_instead_of_falling_back(dev):
    params = _params(dev)
    pose = torch.zeros(2, 16, 3, device=dev)
    shape = torch.zeros(2, 10, device=dev)
    with pytest.raises(ValueError, match="inference only"):
        fused_forward.forward_verts_fused_full(
            params, pose.clone().requires_grad_(True), shape)
    with pytest.raises(ValueError, match="float32"):
        fused_forward.forward_verts_fused_full(params, pose.double(), shape)
    with pytest.raises(ValueError, match="params are on"):
        fused_forward.forward_verts_fused_full(params, pose.cpu(),
                                               shape.cpu())
    empty = fused_forward.forward_verts_fused_full(
        params, pose[:0], shape[:0])
    assert empty.shape == (0, 778, 3)


def test_engine_serves_pose_only_through_k2(dev):
    params = _params(dev)
    rng = np.random.default_rng(4)
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    eng = ServingEngine(params, max_bucket=64, max_delay_s=0.2,
                        posed_kernel="fused")
    assert eng.device.type == "cuda"
    before = fused_posed.launches
    with eng:
        keys = [eng.specialize(bt) for bt in betas]
        poses = [rng.normal(scale=0.5, size=(n, 16, 3)).astype(np.float32)
                 for n in (5, 9, 2)]
        futs = [eng.submit(p, subject=k) for p, k in zip(poses, keys)]
        outs = [f.result(timeout=120) for f in futs]
    assert fused_posed.launches > before
    assert eng.counters.mixed_subject_batches >= 1
    for p, bt, o in zip(poses, betas, outs):
        shaped = core.specialize(params, torch.from_numpy(bt).to(dev))
        want = core.forward_posed_batched(
            shaped, torch.from_numpy(p).to(dev)).verts
        assert _err(torch.from_numpy(o), want) <= TOL


def _skin_inputs(b, v, j, dev, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((v, j)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    arrays = (w, rng.normal(size=(b, j, 3, 3)).astype(np.float32),
              rng.normal(size=(b, j, 3)).astype(np.float32),
              rng.normal(scale=0.1, size=(b, v, 3)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("b,v,j", [(1, 778, 16), (45, 778, 16),
                                   (1000, 778, 16), (45, 300, 7),
                                   (45, 300, 40)])
def test_k3_kernel_matches_plain(dev, b, v, j):
    args = _skin_inputs(b, v, j, dev, seed=b + j)
    before = fused_skin.launches
    got = fused_skin.skin_batched(*args)
    torch.cuda.synchronize()
    assert fused_skin.launches == before + 1
    want = fused_skin.skin_batched_plain(*args)
    assert got.shape == (b, v, 3)
    assert _err(got, want) <= TOL


# B one below and above K3's 32-row tile, one row, 1000; V = 1 and 13 (a
# lone ragged vertex tile: several rows a warp pass), 300 (16-byte rows, a
# 44-vertex tail), 778 (rows alternately 16- and 8-byte aligned, a
# 10-vertex tail); J up to the kernel's 64.
@pytest.mark.parametrize("b", [1, 31, 33, 1000])
@pytest.mark.parametrize("v", [1, 13, 300, 778])
@pytest.mark.parametrize("j", [7, 16, 40, 64])
def test_k3_both_forms_match_plain(dev, b, v, j):
    """K3's forward form (R, t) and its backward form (R^T read in place,
    no t) against the plain version with the same options, and the
    backward form against the explicit transposed copy and zero t."""
    w, rot, t, vp = _skin_inputs(b, v, j, dev, seed=b * v + j)
    before = fused_skin.launches
    got = fused_skin.skin_batched(w, rot, t, vp)
    got_t = fused_skin.skin_batched(w, rot, None, vp, transpose_r=True)
    torch.cuda.synchronize()
    assert fused_skin.launches == before + 2
    assert got.shape == got_t.shape == (b, v, 3)
    assert _err(got, fused_skin.skin_batched_plain(w, rot, t, vp)) <= TOL
    assert _err(got_t, fused_skin.skin_batched_plain(
        w, rot, None, vp, transpose_r=True)) <= TOL
    assert _err(got_t, fused_skin.skin_batched_plain(
        w, rot.transpose(-1, -2).contiguous(), torch.zeros_like(t),
        vp)) <= TOL


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k3_unaligned_rows_match_plain(dev, offset):
    """v_posed and out a whole number of floats but not 16 bytes from an
    aligned address (views ``offset`` floats into their storage): the
    kernel falls back to narrower copies and stores, same result."""
    w, rot, t, vp = _skin_inputs(45, 777, 16, dev, seed=offset)
    flat = torch.zeros(offset + vp.numel(), device=dev)
    flat[offset:] = vp.flatten()
    vp_off = flat[offset:].view(vp.shape)
    got = fused_skin.skin_batched(w, rot, t, vp_off)
    got_t = fused_skin.skin_batched(w, rot, None, vp_off, transpose_r=True)
    torch.cuda.synchronize()
    assert _err(got, fused_skin.skin_batched_plain(w, rot, t, vp)) <= TOL
    assert _err(got_t, fused_skin.skin_batched_plain(
        w, rot, None, vp, transpose_r=True)) <= TOL


def _k4(params, b, seed=0):
    rng = np.random.default_rng(seed)
    pose = torch.from_numpy(rng.normal(
        scale=0.5, size=(b, params.n_joints, 3)).astype(np.float32))
    shape = torch.from_numpy(rng.normal(
        size=(b, params.n_shape)).astype(np.float32))
    dev = params.device
    before = fused_forward.blend_skin_launches
    got = core.forward_batched_pallas_fused(params, pose.to(dev),
                                            shape.to(dev))
    torch.cuda.synchronize()
    assert fused_forward.blend_skin_launches == before + 1
    want = fused_forward.forward_verts_plain(
        fused_forward.fused_operands(params), pose.to(dev), shape.to(dev))
    return got, want


@pytest.mark.parametrize("b", [1, 45, 1000])
def test_k4_kernel_matches_plain(dev, b):
    got, want = _k4(_params(dev), b)
    assert got.shape == (b, 778, 3) and bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("n_joints", [7, 40])
def test_k4_generic_tree(dev, n_joints):
    params = _params(dev, n_joints=n_joints, n_verts=300)
    got, want = _k4(params, 45, seed=n_joints)
    assert got.shape == (45, 300, 3)
    assert _err(got, want) <= TOL


# V edges (one ragged vertex tile at 1 and 13) and J edges (J = 40 takes
# the 16-row tile, 64 the 8-row one); B = 33 straddles the small tiles.
@pytest.mark.parametrize("n_joints", [7, 16, 40, 64])
@pytest.mark.parametrize("n_verts", [1, 13, 300, 778])
def test_k4_matches_plain_and_k1(dev, n_joints, n_verts):
    """K4 against its plain version, and against K1 on the same (pose,
    shape): the two share phase D, so they differ only by the transforms'
    rounding (K1 computes them in the kernel, K4 takes PyTorch's)."""
    params = _params(dev, n_joints=n_joints, n_verts=n_verts)
    got, want = _k4(params, 33, seed=n_joints + n_verts)
    k1, _ = _k1(params, 33, seed=n_joints + n_verts)
    assert got.shape == (33, n_verts, 3) and bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL
    assert _err(got, k1) <= 1e-6


ROUTES = ("forward_batched_pallas", "forward_batched_pallas_fused",
          "forward_batched_pallas_fused_full")


def _grads(params, route, pose, shape):
    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in FIELDS}
    prm = dataclasses.replace(params, **leaves)
    pose = pose.clone().requires_grad_(True)
    shape = shape.clone().requires_grad_(True)
    if route is None:
        out = core.forward_batched(prm, pose, shape).verts
    else:
        out = getattr(core, route)(prm, pose, shape)
    (out * out).sum().backward()
    return {"pose": pose.grad, "shape": shape.grad,
            **{f: leaves[f].grad for f in FIELDS}}


@pytest.mark.parametrize("route", ROUTES)
def test_route_grads_match_plain_autograd(dev, route):
    params = _params(dev)
    rng = np.random.default_rng(11)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(64, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(64, 10)).astype(
        np.float32)).to(dev)
    k3 = fused_skin.launches
    got = _grads(params, route, pose, shape)
    torch.cuda.synchronize()
    assert fused_skin.launches >= k3 + 1     # the backward's K3
    want = _grads(params, None, pose, shape)
    for name, b in want.items():
        a = got[name]
        rel = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        assert rel < 1e-4, (name, rel)
        assert float(b.abs().max()) > 0, name


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def test_f32_family_ignores_the_callers_tf32_switch(dev):
    """``torch.set_float32_matmul_precision("high")`` (TF32 in cuBLAS) in
    the caller must not move the port's f32 family: the plain forward,
    the plain gather, the engine's f32 pose-only family and the K1-route
    gradient stay within 1e-4 of the oracle (gradients: the relative
    1e-4 bar against autograd of the plain path at "highest") and within
    1e-5 of their kernels. A TF32 product keeps about three digits."""
    from mano_hand_tpu_torch.models import oracle

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(17)
    b = 256
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(b, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(b, 10)).astype(
        np.float32)).to(dev)
    table = _table(params, 8)
    idx = torch.from_numpy(rng.integers(0, 8, size=b).astype(
        np.int32)).to(dev)
    n = 16
    want = oracle.forward_batch_verts(params, pose[:n].cpu(), shape[:n].cpu())
    want_plain_grads = _grads(params, None, pose[:64], shape[:64])
    eng = ServingEngine(params, max_bucket=64, max_delay_s=0.001,
                        precision_policy=PrecisionPolicy())
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        full = core.forward_batched(params, pose, shape).verts
        k1 = core.forward_batched_pallas_fused_full(params, pose, shape)
        gather = core.forward_posed_gather(table, idx, pose).verts
        k2 = core.forward_posed_gather_fused(table, idx, pose)
        with eng:
            key = eng.specialize(table.shape[3].cpu().numpy())
            served = eng.forward(pose[:n].cpu().numpy(), subject=key,
                                 priority=1)
        k1_grads = _grads(params, "forward_batched_pallas_fused_full",
                          pose[:64], shape[:64])
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    served_k2 = core.forward_posed_gather_fused(
        table, torch.full((n,), 3, dtype=torch.int32, device=dev), pose[:n])
    errs = {
        "forward_batched_vs_oracle": _err(full[:n], torch.from_numpy(want)),
        "forward_batched_vs_k1": _err(full, k1),
        "forward_posed_gather_vs_k2": _err(gather, k2),
        "engine_f32_vs_k2": _err(torch.from_numpy(served), served_k2),
        **{f"k1_grad_{k}": _rel(k1_grads[k], v)
           for k, v in want_plain_grads.items()},
    }
    print(errs)
    bars = {k: (1e-4 if "oracle" in k or "grad" in k else TOL)
            for k in errs}
    assert all(errs[k] <= bars[k] for k in errs), errs


def test_k3_wrapper_raises_on_a_strided_rotation(dev):
    w, rot, t, vp = _skin_inputs(4, 778, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_skin.skin_batched(w, rot.transpose(-1, -2), t, vp)
    with pytest.raises(ValueError, match="inference only"):
        fused_skin.skin_batched(w, rot.requires_grad_(True), t, vp)


def test_plain_backward_ignores_the_callers_tf32_switch(dev):
    """``loss.backward()`` through the plain ``core.forward_batched`` under
    ``torch.set_float32_matmul_precision("high")``: the gradients in pose,
    shape and the five parameter tensors stay within relative 1e-6
    (max|a - b| / max|b|) of the same gradients under "highest". Autograd's
    backward matmuls follow that switch unless ``ops/common.py:einsum``
    pins them; TF32 would move them by about 1e-3 relative."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(23)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(256, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(256, 10)).astype(
        np.float32)).to(dev)
    want = _grads(params, None, pose, shape)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = _grads(params, None, pose, shape)
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    rel = {k: float((got[k] - w).abs().max()) / float(w.abs().max())
           for k, w in want.items()}
    print(rel)
    assert all(r <= 1e-6 for r in rel.values()), rel


# ---------------------------------------------------------------- quick start
# The quick-start path (assets, MANOModel, keypoints, rotation forms and
# normals, TorchManoLayer) runs the plain core: held on the card against
# the same calls on the CPU (<= 1e-5; the layer's gradients within relative
# 1e-4) and against the float64 oracle (<= 1e-4).
def _demo_model(device):
    from mano_hand_tpu_torch.models import MANOModel

    params = synthetic_params(seed=0, device="cpu")
    m = (MANOModel(params) if device is None
         else MANOModel(params, device=device))
    m.set_params(pose_pca=np.array([-0.32, 0.74, -1.18, 1.51, -1.89, 0.68,
                                    -0.33, 0.23, -1.44]),
                 shape=np.linspace(-1.0, 1.0, 10), global_rot=[1.0, 0, 0])
    return m


def test_quick_start_load_model_to_the_card(dev, tmp_path):
    from mano_hand_tpu_torch.assets import (
        load_model, save_dumped_pickle, save_npz,
    )

    params = synthetic_params(seed=0, device="cpu")
    save_npz(params, tmp_path / "hand.npz")
    save_dumped_pickle(params, tmp_path / "dump_mano_left.pkl")
    for name, side in (("hand.npz", "right"), ("dump_mano_left.pkl", "left")):
        card = load_model(tmp_path / name)        # cuda by default
        assert card.device.type == "cuda" and card.side == side
        assert card.dtype == torch.float64
        cpu = load_model(tmp_path / name, device="cpu")
        for f in ("v_template", "pose_basis", "j_regressor", "faces"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f))


def test_mano_model_on_the_card_matches_the_cpu(dev):
    from mano_hand_tpu_torch.models import oracle

    card, cpu = _demo_model(None), _demo_model("cpu")
    assert card.device.type == "cuda"
    for name in ("verts", "rest_verts", "J", "R", "posed_J"):
        assert _err(getattr(card, name), getattr(cpu, name)) <= TOL, name
    ref = oracle.forward(card.params, card.pose, card.shape)
    assert _err(card.verts, ref.verts) <= 1e-4
    assert _err(card.keypoints("smplx", "openpose"),
                cpu.keypoints("smplx", "openpose")) <= TOL
    rng = np.random.default_rng(1)
    pca = rng.normal(size=(256, 45))
    grot = rng.normal(scale=0.5, size=(256, 3))
    assert _err(card(pose_pca=pca, global_rot=grot),
                cpu(pose_pca=pca, global_rot=grot)) <= TOL


@pytest.mark.parametrize("n", [1, 5, 300, 1024])
def test_forward_bucketed_on_the_card(dev, n):
    m = _demo_model(None)
    rng = np.random.default_rng(n)
    pose = rng.normal(scale=0.5, size=(n, 16, 3)).astype(np.float32)
    shape = rng.normal(size=(n, 10)).astype(np.float32)
    got = m.forward_bucketed(pose, shape)
    assert got.shape == (n, 778, 3)
    assert _err(got, m(pose=pose, shape=shape)) <= 1e-6
    m.forward_bucketed(pose, shape)
    snap = m.serving_counters.snapshot()
    assert snap["compiles"] == 1 and snap["dispatches"] == 2


def test_torch_layer_on_the_card_matches_the_cpu(dev):
    from mano_hand_tpu_torch.interop import TorchManoLayer

    params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(41)
    inputs = [rng.normal(scale=s, size=sz).astype(np.float32)
              for s, sz in ((0.3, (256, 16, 3)), (0.5, (256, 10)),
                            (0.05, (256, 3)))]
    wv = torch.from_numpy(rng.normal(size=(256, 778, 3)).astype(np.float32))

    def run(device):
        layer = TorchManoLayer(params, device=device)
        leaves = [torch.tensor(x, device=device, requires_grad=True)
                  for x in inputs]
        verts, joints = layer(*leaves)
        loss = (verts * wv.to(device)).sum() + joints.sum()
        loss.backward()
        return loss.item(), [x.grad.cpu() for x in leaves]

    loss, grads = run(dev)
    cpu_loss, cpu_grads = run("cpu")
    assert abs(loss - cpu_loss) <= 1e-4 * max(1.0, abs(cpu_loss))
    for g, w in zip(grads, cpu_grads):
        assert float((g - w).abs().max()) / max(
            1.0, float(w.abs().max())) <= 1e-4


def test_rotation_forms_and_normals_on_the_card_match_the_cpu(dev):
    from mano_hand_tpu_torch import ops

    rng = np.random.default_rng(7)
    axes = rng.normal(size=(96, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    mags = np.concatenate([np.full(16, 1e-6), rng.uniform(0.01, 3.0, 64),
                           np.full(16, np.pi - 1e-5)])
    aa = torch.from_numpy((axes * mags[:, None]).astype(np.float32))
    rot = ops.rotation_matrix(aa)
    card = ops.axis_angle_from_matrix(rot.to(dev))
    cpu = ops.axis_angle_from_matrix(rot)
    assert _err(card[:80], cpu[:80]) <= 1e-6
    assert _err(ops.rotation_matrix(card), ops.rotation_matrix(cpu)) <= 1e-5
    six = torch.from_numpy(rng.normal(size=(64, 6)).astype(np.float32))
    assert _err(ops.matrix_from_6d(six.to(dev)), ops.matrix_from_6d(six)) \
        <= 1e-6
    q = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    assert _err(ops.matrix_from_quaternion(q.to(dev)),
                ops.matrix_from_quaternion(q)) <= 1e-6
    params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    out = core.forward_batched(params, aa[:4, None].expand(4, 16, 3) * 0.2,
                               torch.zeros(4, 10))
    card_n = ops.batched_vertex_normals(out.verts.to(dev),
                                        params.faces.to(dev))
    assert _err(card_n, ops.batched_vertex_normals(out.verts, params.faces)) \
        <= 1e-5


def test_keypoints_chunked_and_sample_poses_on_the_card(dev):
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    cpu_params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)      # a CPU generator
    pose = core.sample_poses(params, gen, 1000, global_rot_scale=0.3)
    cpu_pose = core.sample_poses(cpu_params, torch.Generator().manual_seed(3),
                                 1000, global_rot_scale=0.3)
    assert pose.device.type == "cuda"
    assert _err(pose, cpu_pose) <= 1e-6
    shape = torch.zeros(1000, 10)
    kp = core.keypoints_chunked(params, pose, shape.to(dev), "smplx",
                                "openpose", chunk_size=256)
    want = core.keypoints_chunked(cpu_params, cpu_pose, shape, "smplx",
                                  "openpose", chunk_size=256)
    assert kp.shape == (1000, 21, 3)
    assert _err(kp, want) <= TOL


# ------------------------------------------------------------------ fitting
def _fit_targets(params, b=8, seed=9):
    rng = np.random.default_rng(seed)
    pose = torch.tensor(rng.normal(scale=0.3, size=(b, 16, 3)),
                        dtype=torch.float32)
    beta = torch.tensor(rng.normal(scale=0.5, size=(b, 10)),
                        dtype=torch.float32)
    with torch.no_grad():
        return pose, beta, core.forward_batched(params, pose, beta).verts


def test_fit_on_the_card_matches_the_cpu(dev):
    """Batched Adam (``fitting.fit``) on the card against the same fit on
    the CPU: the first 20 steps' losses within 1e-3 relative; the steps
    make the host wait for the card nowhere (sync debug mode "error")."""
    from mano_hand_tpu_torch import fitting

    cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    card = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    _, _, target = _fit_targets(cpu)
    want = fitting.fit(cpu, target, n_steps=20, lr=0.05)
    target_card = target.to(dev)
    fitting.fit(card, target_card, n_steps=2, lr=0.05)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fitting.fit(card, target_card, n_steps=20, lr=0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rel = ((got.loss_history.cpu() - want.loss_history).abs()
           / want.loss_history.abs()).max()
    assert float(rel) <= 1e-3
    assert _err(got.pose, want.pose) <= 1e-3


@pytest.mark.parametrize("normal_eq", ["high", "bf16"])
def test_fit_lm_on_the_card_matches_the_cpu(dev, normal_eq):
    """Batched LM (``fitting.fit_lm``) on the card: every problem at the
    floor, the pose within 1e-4 of the CPU's and of the truth (the bf16
    normal equations to their JAX test's bar), no host wait per step."""
    from mano_hand_tpu_torch import fitting

    cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    card = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    pose, _, target = _fit_targets(cpu)
    want = fitting.fit_lm(cpu, target, n_steps=20, normal_eq=normal_eq)
    target_card = target.to(dev)
    fitting.fit_lm(card, target_card, n_steps=1, normal_eq=normal_eq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fitting.fit_lm(card, target_card, n_steps=20,
                             normal_eq=normal_eq)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(got.final_loss.max()) < 1e-12
    assert _err(got.pose, want.pose) <= 1e-4
    assert _err(got.pose, pose) <= 1e-4


# ---------------------------------------------------------------- rendering
def _posed_verts(params, b, seed=11):
    rng = np.random.default_rng(seed)
    pose = torch.tensor(rng.normal(scale=0.3, size=(b, 16, 3)),
                        dtype=torch.float32)
    with torch.no_grad():
        return core.forward_batched(params, pose, torch.zeros(b, 10)).verts


@pytest.mark.parametrize("size", [(64, 64), (45, 32)])
def test_render_mesh_on_the_card_matches_the_cpu(dev, size):
    """The hard rasteriser on the card against the CPU under the
    edge-pixel rule of ``chip_smoke.hold_render`` (hit masks equal but
    for a few pixels on an edge, colours within 1e-5), and a clip's
    frames against their single renders within 1e-5 (the card's
    index_add, the vertex normals' scatter, sums in no fixed order)."""
    import chip_smoke
    from mano_hand_tpu_torch import viz

    cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    verts = _posed_verts(cpu, 3)
    h, w = size
    cam = viz.camera.default_hand_camera(device="cpu")
    corners = viz.render.ndc_to_pixels(cam.project(verts[0])[:, :2], h,
                                       w)[cpu.faces.long()].numpy()
    got = viz.render_mesh(verts[0].to(dev), cpu.faces.to(dev), height=h,
                          width=w)
    assert got.device.type == "cuda"
    want = viz.render_mesh(verts[0], cpu.faces, height=h, width=w)
    chip_smoke.hold_render(got, want, (1.0, 1.0, 1.0), corners)
    clip = viz.render_sequence(verts.to(dev), cpu.faces, height=h, width=w)
    assert _err(clip[0], got) <= TOL


@pytest.mark.parametrize("name", ["soft_silhouette", "soft_depth"])
def test_soft_renders_on_the_card_match_the_cpu(dev, name):
    """Soft renders of a batch on the card: values within 1e-5 of the
    CPU, gradients at the JAX relative bar, ``"vmap"`` against ``"map"``
    within 1e-5."""
    from mano_hand_tpu_torch import viz

    cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    verts = _posed_verts(cpu, 4)
    fn = getattr(viz, name)
    wts = torch.rand(32, 32, generator=torch.Generator().manual_seed(0))

    def run(v, faces, **kw):
        v = v.clone().requires_grad_(True)
        out = fn(v, faces, height=32, width=32, **kw)
        g, = torch.autograd.grad((out * wts.to(v.device)).sum(), v)
        return out.detach().cpu(), g.cpu()

    want, g_want = run(verts, cpu.faces)
    got, g_got = run(verts.to(dev), cpu.faces.to(dev))
    assert _err(got, want) <= TOL
    assert _err(g_got, g_want) / max(1.0, float(g_want.abs().max())) <= 1e-4
    by_map, _ = run(verts.to(dev), cpu.faces.to(dev), batch_mode="map")
    by_vmap, _ = run(verts.to(dev), cpu.faces.to(dev), batch_mode="vmap")
    assert _err(by_map, by_vmap) <= TOL


@pytest.mark.parametrize("term", ["silhouette", "depth"])
def test_raster_fit_on_the_card_matches_the_cpu(dev, term):
    """``fit`` with a rasterising term on the card against the CPU: the
    first 20 losses within 1e-3 relative, and the steady steps make the
    host wait for the card nowhere (sync debug mode "error")."""
    from mano_hand_tpu_torch import fitting, viz

    cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    card = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    with torch.no_grad():
        rest = core.forward(cpu).verts
    shifts = torch.tensor([[[0.02, 0.01, 0.0]], [[-0.01, 0.02, 0.01]]])
    if term == "silhouette":
        camera = viz.WeakPerspectiveCamera(rot=torch.eye(3), scale=3.0)
        target = (viz.soft_silhouette(rest + shifts, cpu.faces, camera,
                                      height=32, width=32, sigma=1.0)
                  > 0.5).float()
    else:
        camera = viz.camera.default_hand_camera(device="cpu")
        target = viz.soft_depth(rest + shifts, cpu.faces, camera,
                                height=32, width=32, sigma=1.0)
        target = torch.where(target > 5.0, torch.zeros_like(target), target)
    kw = dict(lr=0.01, data_term=term, sil_sigma=1.0, fit_trans=True,
              pose_prior_weight=1.0, shape_prior_weight=1.0)
    want = fitting.fit(cpu, target, n_steps=20, camera=camera, **kw)
    target_card, cam_card = target.to(dev), camera.to(dev)
    fitting.fit(card, target_card, n_steps=2, camera=cam_card, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fitting.fit(card, target_card, n_steps=20, camera=cam_card,
                          **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rel = ((got.loss_history.cpu() - want.loss_history).abs()
           / want.loss_history.abs()).max()
    assert float(rel) <= 1e-3


def test_cli_renders_and_fits_on_the_card(dev, tmp_path):
    """``python -m mano_hand_tpu_torch`` on its default device: a clip to
    AVI and a mask fit."""
    from mano_hand_tpu_torch import cli, viz

    np.save(tmp_path / "poses.npy", np.zeros((3, 16, 3)))
    assert cli.main(["render", "--poses", str(tmp_path / "poses.npy"),
                     "--size", "64", "--out", str(tmp_path / "c.avi")]) == 0
    assert viz.read_avi_info(tmp_path / "c.avi")["n_frames"] == 3
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 10:22] = 1.0
    np.save(tmp_path / "m.npy", mask)
    assert cli.main(["fit", str(tmp_path / "m.npy"), "--data-term",
                     "silhouette", "--steps", "5", "--out",
                     str(tmp_path / "f.npz")]) == 0
    assert np.load(tmp_path / "f.npz")["pose"].shape == (16, 3)
