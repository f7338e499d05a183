"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test here needs an NVIDIA card and skips without
one (the CUDA kernels have no CPU or interpret mode). On a machine with
a card, run them without the JAX test harness (``tests/conftest.py``
imports JAX), registering the marker on the command line:

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs an NVIDIA card" tests/test_torch_cuda.py

The serving engine's CUDA-graph programs are held against eager calls,
across table installs between captures and replays, against a woken
supervised attempt, under the caller's TF32 switch and against a
CPU-baked lattice; the pipelined dispatch against its direct calls with
a side stream current in another thread, an attempt abandoned after its
launch, a warm promotion prefetched on a stalled side stream and one
whose copy landed (settled with no wait); the
dispatch lanes (two lanes replaying concurrently against one, a row
installed on a stalled engine stream, a staging slab fenced behind a
stalled lane, captures while lanes serve, every lane down). Shapes cover what ``chip_smoke.py`` does not: ragged
and tiny batches, generic kinematic trees (J = 7 to 64), V from 1 to
778, SMPL-X's published widths (V = 10,475, J = 55, K = 507: K1, K4
and f32 K2 against ``benchmark/reference/smplx.py`` in float64, within
1e-5), the row tile each K1 launch counts, rows that are not 16-byte
aligned, subject tables of 1 to 1000
rows and out-of-range (negative: wrapped once) subject indices. Tolerance: kernel vs plain
version, both fp32 with TF32 off, <= 1e-5 (summation order only; K2's
bf16 tier too, whose roundings act on bit-equal values in both and whose
bf16 products, exact in fp32, accumulate in fp32 on the tensor cores).
K2-bf16 vs f32 K2: nonzero and inside the policy's stated envelope
(2e-3 m). Gradients through the three kernel routes against autograd of
the plain path: the JAX tests' relative bar, max|a - b| / max(1,
max|b|) < 1e-4.
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS as FIELDS
from mano_hand_tpu_torch.constants import SMPLX_PARENTS
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


@pytest.mark.parametrize("b", [65536, 20000])
def test_forward_chunked_k1_writes_chunks_in_place(dev, b):
    """``forward_chunked``'s K1 route in chunks of 8,192 against the same
    chunks launched into tensors of their own (the last zero-padded to a
    whole chunk) and concatenated: bit for bit on whole chunks (the same
    launches, another destination), within TOL on a short last chunk
    (launched with its own rows); one ``chunks_in_place`` and one K1
    launch a chunk; and the call's peak memory is the output's, plus at
    most 1 % of it."""
    chunk = 8192
    params = _params(dev)
    g = torch.Generator(device=dev).manual_seed(b)
    pose = 0.5 * torch.randn(b, 16, 3, generator=g, device=dev)
    shape = torch.randn(b, 10, generator=g, device=dev)
    with torch.no_grad():
        pose_c, shape_c, _ = core._pad_and_chunk(pose, shape, chunk)
        want = torch.cat([core.forward_batched_pallas_fused_full(
            params, p, s) for p, s in zip(pose_c, shape_c)])[:b]
        del pose_c, shape_c
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n_chunks = -(-b // chunk)
        before = (fused_forward.chunks_in_place, fused_forward.launches)
        got = core.forward_chunked(params, pose, shape, chunk_size=chunk,
                                   use_pallas_fused_full=True)
        torch.cuda.synchronize()
    assert (fused_forward.chunks_in_place - before[0],
            fused_forward.launches - before[1]) == (n_chunks, n_chunks)
    out_bytes = got.numel() * got.element_size()
    assert torch.cuda.max_memory_allocated(dev) - base <= 1.01 * out_bytes
    assert got.shape == want.shape == (b, 778, 3)
    whole = b // chunk * chunk
    assert torch.equal(got[:whole], want[:whole])
    if whole < b:
        assert _err(got[whole:], want[whole:]) <= TOL


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


def _grads(params, route, pose, shape, **kw):
    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in FIELDS}
    prm = dataclasses.replace(params, **leaves)
    pose = pose.clone().requires_grad_(True)
    shape = shape.clone().requires_grad_(True)
    if route is None:
        out = core.forward_batched(prm, pose, shape).verts
    else:
        out = getattr(core, route)(prm, pose, shape, **kw)
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


def test_forward_chunked_k1_grads_match_plain_autograd(dev):
    """``forward_chunked``'s K1 route over a ragged batch (37 rows in
    chunks of 16: one K1 launch and one backward K3 a chunk): pose, shape
    and the five parameter gradients against the plain path's autograd,
    relative 1e-4 as the other routes."""
    params = _params(dev)
    rng = np.random.default_rng(12)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(37, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(37, 10)).astype(
        np.float32)).to(dev)
    before = (fused_forward.launches, fused_skin.launches)
    got = _grads(params, "forward_chunked", pose, shape,
                 chunk_size=16, use_pallas_fused_full=True)
    torch.cuda.synchronize()
    assert (fused_forward.launches - before[0],
            fused_skin.launches - before[1]) == (3, 3)
    want = _grads(params, None, pose, shape)
    for name, b in want.items():
        assert _rel(got[name], b) < 1e-4, (name, _rel(got[name], b))
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


# ------------------------------------------------ engine resilience (card)
def _supervised(spec, probe, **kw):
    """A supervised policy; a card engine's has no CPU tier."""
    from mano_hand_tpu_torch import runtime

    plan = runtime.ChaosPlan(spec)
    breaker = runtime.CircuitBreaker(
        failure_threshold=2, probe=probe, probe_interval_s=0.0,
        respect_priority_claim=False)
    kw.setdefault("deadline_s", 30.0)
    kw.setdefault("cpu_fallback", False)
    return runtime.DispatchPolicy(retries=1, backoff_s=0.001, jitter=0.0,
                                  breaker=breaker, chaos=plan, **kw), plan


def _cpu_direct(params_cpu, pose, shape, bucket):
    from mano_hand_tpu_torch.serving import buckets

    pose, shape = (torch.from_numpy(np.array(
        buckets.pad_rows(x, bucket), np.float32, order="C"))
        for x in (pose, shape))
    with torch.no_grad():
        return core.forward_batched(params_cpu, pose, shape).verts.numpy()


def test_supervised_fused_engine_under_burst_and_outage(dev):
    """A supervised ``posed_kernel="fused"`` engine on the card: an error
    burst is retried through K2; a persistent outage resolves every
    request to its ``ServingError`` with nothing run on the host (a card
    engine refuses the CPU tier); failback serves through K2 again. A
    CPU engine under the same outage fails over to its CPU tier: bit for
    bit the direct CPU call at the bucket, within 1e-5 of the card."""
    import warnings

    from mano_hand_tpu_torch.serving import ServingError, buckets

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    params_cpu = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(12)
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    poses = [rng.normal(scale=0.5, size=(n, 16, 3)).astype(np.float32)
             for n in (3, 5, 2, 4)]
    full = (poses[0], rng.normal(size=(3, 10)).astype(np.float32))
    with pytest.raises(ValueError, match="cpu_fallback=False"):
        ServingEngine(params, policy=_supervised(
            "", lambda: True, cpu_fallback=True)[0])
    device_up = [True]
    policy, plan = _supervised("error@0,error@2", lambda: device_up[0])
    eng = ServingEngine(params, max_bucket=8, posed_kernel="fused",
                        policy=policy)
    with eng, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        keys = [eng.specialize(b) for b in betas]
        eng.warmup([4, 8])
        # Every bucket the pose-only requests reach: a program built at
        # dispatch launches K2 once more, in its eager warm call.
        eng.warmup_posed([2, 4, 8])
        k2 = fused_posed.launches
        card = [eng.forward(p, subject=keys[i % 3])
                for i, p in enumerate(poses[1:])]
        card_full = eng.forward(*full)
        assert eng.counters.retries == 2 and eng.counters.failovers == 0
        assert fused_posed.launches == k2 + 3
        plan.schedule("error@0-")
        device_up[0] = False
        futs = [eng.submit(p, subject=keys[i % 3])
                for i, p in enumerate(poses[1:])] + [eng.submit(*full)]
        for f in futs:
            with pytest.raises(ServingError) as err:
                f.result(timeout=120)
            assert err.value.kind == "error"
        assert eng.counters.failovers == 0 and not eng._cpu_exes
        assert fused_posed.launches == k2 + 3   # chaos fails before K2
        plan.clear()
        device_up[0] = True
        again = eng.forward(poses[1], subject=keys[0])
        assert fused_posed.launches == k2 + 4   # failback: K2 again
        assert eng.counters.failovers == 0
    assert not any("failed over" in str(w.message) for w in caught)
    assert _err(again, card[0]) <= TOL
    # The CPU tier, on a CPU engine under the same outage.
    device_up[0] = False
    policy, plan = _supervised("error@0-", lambda: device_up[0],
                               cpu_fallback=True)
    host = ServingEngine(params_cpu, device="cpu", max_bucket=8,
                         posed_kernel="fused", policy=policy)
    with host, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        keys = [host.specialize(b) for b in betas]
        failed = [host.forward(p, subject=keys[i % 3])
                  for i, p in enumerate(poses[1:])]
        failed_full = host.forward(*full)
        assert host.counters.failovers == 4
    assert sum("failed over" in str(w.message) for w in caught) == 4
    for i, (p, c, f) in enumerate(zip(poses[1:], card, failed)):
        rows = np.broadcast_to(betas[i % 3][None], (p.shape[0], 10))
        bucket = buckets.bucket_for(p.shape[0], host.buckets)
        want = _cpu_direct(params_cpu, p, rows, bucket)
        np.testing.assert_array_equal(f, want[:p.shape[0]])
        assert _err(f, c) <= TOL
    np.testing.assert_array_equal(
        failed_full, _cpu_direct(params_cpu, *full, 4)[:3])
    assert _err(failed_full, card_full) <= TOL


def test_smplh_52_joint_rig_kernels_on_the_card(dev):
    """The SMPL-H tree (52 joints, levels not in index order): K1, K4 and
    K2 within 1e-5 of their plain versions and 1e-4 of the oracle (JAX's
    ``test_smplh_scale_52_joint_rig`` asset)."""
    from mano_hand_tpu_torch.constants import SMPLH_PARENTS
    from mano_hand_tpu_torch.models import oracle

    rig64 = dataclasses.replace(
        synthetic_params(seed=13, n_verts=389, n_joints=52, n_shape=16,
                         n_faces=700, device="cpu"),
        parents=SMPLH_PARENTS)
    rig = rig64.astype(torch.float32).to(dev)
    rng = np.random.default_rng(6)
    pose = rng.normal(scale=0.3, size=(3, 52, 3)).astype(np.float32)
    beta = rng.normal(size=(3, 16)).astype(np.float32)
    pose_t, beta_t = (torch.from_numpy(x).to(dev) for x in (pose, beta))
    want = oracle.forward_batch_verts(rig64, pose, beta)
    plain = core.forward_batched(rig, pose_t, beta_t).verts
    assert _err(plain, want) <= 1e-4
    ops = fused_forward.fused_operands(rig)
    k1_plain = fused_forward.forward_verts_plain(ops, pose_t, beta_t)
    counts = (fused_forward.launches, fused_forward.blend_skin_launches,
              fused_posed.launches)
    k1 = core.forward_batched_pallas_fused_full(rig, pose_t, beta_t)
    k4 = core.forward_batched_pallas_fused(rig, pose_t, beta_t)
    table = core.stack_shaped([core.specialize(rig, b) for b in beta_t])
    idx = torch.arange(3, dtype=torch.int32, device=dev)
    k2 = core.forward_posed_gather_fused(table, idx, pose_t)
    k2_plain = fused_posed.forward_posed_gather_plain(
        table.v_shaped, table.joints, idx, pose_t,
        fused_posed.posed_operands(table), table.parents)
    torch.cuda.synchronize()
    assert (fused_forward.launches, fused_forward.blend_skin_launches,
            fused_posed.launches) == tuple(c + 1 for c in counts)
    for got, ref in ((k1, k1_plain), (k4, k1_plain), (k2, k2_plain)):
        assert got.shape == (3, 389, 3)
        assert _err(got, ref) <= TOL
        assert _err(got, want) <= 1e-4


# ---------------------------------- SMPL-X at its published widths
#: Kernel vs the float64 SMPL-X reference: fp32 rounding of a 507-term
#: blend and an 11-level chain on a ~10 cm mesh (the repo's kernel bar).
SMPLX_TOL = 1e-5


@pytest.fixture(scope="module")
def smplx_rig(dev):
    """SMPL-X's published widths (V = 10,475, J = 55, S = 10 betas + 10
    expression, P = 486, K = 507) with synthetic weights, fp32 on the
    card: a 64 MB packed basis, past the 50 MB L2."""
    p = synthetic_params(seed=26, n_verts=10475, n_joints=55, n_shape=20,
                         n_faces=50, dtype=torch.float32, device=dev)
    return dataclasses.replace(p, parents=SMPLX_PARENTS)


def _smplx_inputs(params, b, seed=0):
    """The benchmark's spreads: root 1.0 rad, every other joint 0.4,
    shape 1.0."""
    g = torch.Generator(device=params.device).manual_seed(seed)
    pose = 0.4 * torch.randn(b, params.n_joints, 3, generator=g,
                             device=params.device)
    pose[:, 0] *= 2.5
    shape = torch.randn(b, params.n_shape, generator=g, device=params.device)
    return pose, shape


def _smplx_err(params, got, pose, shape):
    """max |got - reference| over every vertex, the float64 reference
    (``benchmark/reference/smplx.py``) in blocks: betas against
    ``shapedirs``, expression against ``exprdirs``."""
    from benchmark.entries.forward_chunked_smplx import reference_model
    from benchmark.reference import smplx

    model = reference_model({f.name: getattr(params, f.name)
                             for f in dataclasses.fields(params)}, 10)
    err = 0.0
    for lo, hi, ref in smplx.forward_blocks(model, pose, shape[:, :10],
                                            shape[:, 10:]):
        err = max(err, float((got[lo:hi].double() - ref).abs().max()))
    return err


@pytest.mark.parametrize("b", [1, 8191, 16384])
def test_smplx_k1_through_forward_chunked(dev, smplx_rig, b):
    """``forward_chunked``'s K1 route at SMPL-X's widths in chunks of
    8,192: B = 1 (the 8-row tile), 8,191 (one short chunk) and 2 x 8,192,
    which take the 16-row tile (its carve of kpad + 15 J floats a row
    leaves no room for 32). One launch and one chunk in place a chunk,
    each counted under its row tile; every vertex within SMPLX_TOL of
    the float64 reference."""
    pose, shape = _smplx_inputs(smplx_rig, b)
    n, tile = -(-b // 8192), "tile_rows_8" if b == 1 else "tile_rows_16"
    names = ("launches", "chunks_in_place", tile)
    before = [getattr(fused_forward, k) for k in names]
    with torch.no_grad():
        got = core.forward_chunked(smplx_rig, pose, shape, chunk_size=8192,
                                   use_pallas_fused_full=True)
    torch.cuda.synchronize()
    assert [getattr(fused_forward, k) - c
            for k, c in zip(names, before)] == [n, n, n]
    assert got.shape == (b, 10475, 3) and bool(torch.isfinite(got).all())
    assert _smplx_err(smplx_rig, got, pose, shape) <= SMPLX_TOL


def test_official_smplx_file_runs_k1_on_the_card(dev, tmp_path):
    """An official-layout SMPL-X ``.npz`` at the published widths (400
    shape columns, the uint32 root sentinel, the per-hand PCA keys) goes
    through ``load_model`` (float64 on the card) and unchanged into
    ``forward_chunked``'s K1 route: two chunks of 16-row tiles, within
    SMPLX_TOL of the float64 reference on the file's own columns."""
    from mano_hand_tpu_torch.assets import load_model
    from mano_hand_tpu_torch.assets.synthetic import synthetic_arrays

    a = synthetic_arrays(seed=27, n_verts=10475, n_joints=55, n_shape=400,
                         n_faces=50)
    root = np.uint32(4294967295)
    np.savez(tmp_path / "SMPLX_NEUTRAL.npz", v_template=a["v_template"],
             shapedirs=a["shape_basis"], posedirs=a["pose_basis"],
             J_regressor=a["j_regressor"], weights=a["lbs_weights"],
             f=np.asarray(a["faces"], np.uint32),
             kintree_table=np.stack([
                 np.asarray([root] + list(SMPLX_PARENTS[1:]), np.uint32),
                 np.arange(55, dtype=np.uint32)]),
             hands_componentsl=np.eye(45), hands_componentsr=np.eye(45))
    params = load_model(tmp_path / "SMPLX_NEUTRAL.npz", device=dev)
    assert (params.n_verts, params.n_joints, params.n_shape,
            params.pose_basis.shape[-1]) == (10475, 55, 20, 486)
    assert params.parents == SMPLX_PARENTS
    dirs = torch.from_numpy(a["shape_basis"]).to(dev)
    assert torch.equal(params.shape_basis, torch.cat(
        [dirs[..., :10], dirs[..., 300:310]], dim=-1))
    pose, shape = _smplx_inputs(params, 3000, seed=2)
    before = (fused_forward.launches, fused_forward.tile_rows_16)
    with torch.no_grad():
        got = core.forward_chunked(params, pose, shape, chunk_size=2048,
                                   use_pallas_fused_full=True)
    torch.cuda.synchronize()
    assert (fused_forward.launches - before[0],
            fused_forward.tile_rows_16 - before[1]) == (2, 2)
    assert _smplx_err(params, got, pose, shape) <= SMPLX_TOL


def test_smplx_k4_and_k2_at_the_serving_batch(dev, smplx_rig):
    """K4 (blend + skin behind the PyTorch pre-stage) and f32 K2 (four
    baked subjects, gathered) at B = 256, SMPL-X's widths, against the
    float64 reference."""
    pose, shape = _smplx_inputs(smplx_rig, 256, seed=1)
    idx = torch.arange(256, dtype=torch.int32, device=dev) % 4
    table = core.stack_shaped([core.specialize(smplx_rig, s)
                               for s in shape[:4]])
    counts = (fused_forward.blend_skin_launches, fused_posed.launches)
    with torch.no_grad():
        k4 = core.forward_batched_pallas_fused(smplx_rig, pose, shape)
        k2 = core.forward_posed_gather_fused(table, idx, pose)
    torch.cuda.synchronize()
    assert (fused_forward.blend_skin_launches,
            fused_posed.launches) == tuple(c + 1 for c in counts)
    assert _smplx_err(smplx_rig, k4, pose, shape) <= SMPLX_TOL
    assert _smplx_err(smplx_rig, k2, pose, shape[idx.long()]) <= SMPLX_TOL


def test_row_tile_counters_and_the_basis_metric(dev, smplx_rig):
    """K1 at B = 8,192 counts under its row tile, 16 at SMPL-X's widths
    and 64 at MANO's; the benchmark's ``basis_mb_per_mesh.forward`` reads
    the same tiles off a short profiler capture of those launches: 4.14
    and 0.0258 MB of packed operand a mesh."""
    from torch.profiler import record_function

    from benchmark import harness, timeline

    read = harness.load_reader("basis_mb_per_mesh.forward")
    runs = {"smplx_neutral.bulk_forward": (smplx_rig, 16, 4.143296),
            "mano_right.bulk_forward": (_params(dev), 64, 0.02576)}
    tiles = (64, 32, 16, 8)
    for cell, (params, rows, mb) in runs.items():
        pose, shape = _smplx_inputs(params, 8192)

        def call():
            return core.forward_chunked(params, pose, shape,
                                        chunk_size=8192,
                                        use_pallas_fused_full=True)
        with torch.no_grad():
            call()
            torch.cuda.synchronize()
            before = [getattr(fused_forward, f"tile_rows_{r}") for r in tiles]
            with timeline.capture(dev) as cap:
                time.sleep(0.01)   # the profiler drops a capture's first
                with record_function("bench.window"):   # few records
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
        got = [getattr(fused_forward, f"tile_rows_{r}") - c
               for r, c in zip(tiles, before)]
        assert got == [10 if r == rows else 0 for r in tiles], cell
        tl = timeline.Timeline.from_capture(cap.events)
        value = read(types.SimpleNamespace(cell=cell, timeline=tl))
        assert value == pytest.approx(mb, rel=0.01), cell


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_cuda_failures_are_deterministic_on_the_card(dev):
    """Out of memory and a CUDA error reproduce on retry: neither is
    retried, and under a policy either stays engine-fatal (no failover).
    Last in the file: the provoked errors touch no later test."""
    from mano_hand_tpu_torch.runtime import supervise
    from mano_hand_tpu_torch.serving import ServingError

    caught = []
    with pytest.raises(torch.cuda.OutOfMemoryError) as oom:
        torch.empty(1 << 46, dtype=torch.uint8, device=dev)   # 64 TiB
    caught.append(oom.value)
    with pytest.raises(RuntimeError) as bad:   # no such card
        torch.zeros(1, device=torch.device("cuda", 100))
    caught.append(bad.value)
    for exc in caught:
        assert "CUDA" in str(exc), exc
        assert supervise.classify_failure(exc) == supervise.DETERMINISTIC
        calls = []

        def boom(exc=exc):
            calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            supervise.supervised_call(boom, retries=3, backoff_s=0.0)
        assert calls == [1]
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    policy, _ = _supervised("", lambda: True)
    eng = ServingEngine(params, max_bucket=4, policy=policy)

    def oom_primary(pose, shape):
        raise caught[0]

    eng._primary_full = oom_primary
    with eng:
        fut = eng.submit(np.zeros((2, 16, 3), np.float32))
        with pytest.raises(torch.cuda.OutOfMemoryError):
            fut.result(timeout=120)
        eng._thread.join(timeout=120)
        with pytest.raises(RuntimeError, match="dispatcher died"):
            eng.submit(np.zeros((2, 16, 3), np.float32))
    assert eng.counters.failovers == 0 and not eng._cpu_exes
    assert not isinstance(caught[0], ServingError)
    torch.cuda.synchronize()   # the context is healthy after both


# ------------------------------------------ the engine's program cache
def _engine_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(b, 16, 3)).astype(np.float32),
            rng.normal(size=(b, 10)).astype(np.float32))


def _direct_k2(params, betas, pose, bucket, compute_dtype=None):
    """K2 eagerly on a one-row table of a freshly specialized subject, at
    the engine's padded bucket: what a graph must serve for that
    subject."""
    from mano_hand_tpu_torch.serving import buckets

    dev = params.device
    with torch.no_grad():
        table = core.stack_shaped([core.specialize(
            params, torch.from_numpy(betas).to(dev))])
        padded = torch.from_numpy(buckets.pad_rows(pose, bucket)).to(dev)
        out = core.forward_posed_gather_fused(
            table, torch.zeros(bucket, dtype=torch.int32, device=dev),
            padded, compute_dtype=compute_dtype)
    return out[:len(pose)].cpu().numpy()


def test_engine_graphs_equal_eager_and_count_their_launches(dev):
    """Every family's graph replay gives the eager call's bits, the
    warm-up captures every program once (``compiles``), steady traffic
    captures nothing, and every replay adds the kernel launches it
    captured: K2 and K2-bf16 launches equal the gathered dispatches of
    each precision."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = ServingEngine(params, max_bucket=8, posed_kernel="fused",
                        precision_policy=PrecisionPolicy())
    betas = np.random.default_rng(3).normal(size=(3, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    assert eng.warmup() == {1: "jit", 2: "jit", 4: "jit", 8: "jit"}
    assert eng.warmup_posed() == {1: "jit", 2: "jit", 4: "jit", 8: "jit"}
    assert eng.counters.compiles == 12      # 4 full, 4 K2, 4 K2-bf16
    table = eng.table
    for b in eng.buckets:
        pose, shape = _engine_inputs(b, b)
        idx = np.arange(b, dtype=np.int32) % 3
        with torch.no_grad():
            want = core.forward_batched(
                params, torch.from_numpy(pose).to(dev),
                torch.from_numpy(shape).to(dev)).verts.cpu().numpy()
            for dt in (None, torch.bfloat16):
                got = eng._run_posed(table, idx, pose, dt)
                ref = core.forward_posed_gather_fused(
                    table, torch.from_numpy(idx).to(dev),
                    torch.from_numpy(pose).to(dev),
                    compute_dtype=dt).cpu().numpy()
                np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(eng._run_full(pose, shape), want)
    fused_posed.launches = fused_posed.bf16_launches = 0
    with eng:
        futs = [eng.submit(_engine_inputs(n, 20 + i)[0], subject=keys[i % 3],
                           priority=i % 2)
                for i, n in enumerate((1, 3, 8, 2, 5, 7))]
        futs.append(eng.submit(*_engine_inputs(6, 30)))
        for f in futs:
            f.result(timeout=120)
    snap = eng.counters.snapshot()
    assert snap["compiles"] == 12
    bf16 = snap["dispatches_bf16"]
    assert fused_posed.bf16_launches == bf16 >= 1
    assert fused_posed.launches == snap["dispatches"] - bf16 - 1 >= 1


def test_graph_never_serves_a_stale_table(dev):
    """K2 reads the table through pointers. Installs and evictions between
    the capture and the replays replace the engine's table snapshot every
    time: each replay must serve its batch's snapshot, never the one
    captured (or copied) before."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = ServingEngine(params, max_bucket=4, max_subjects=4,
                        posed_kernel="fused")
    betas = np.random.default_rng(5).normal(size=(7, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas[:4]]
    eng.warmup_posed([4])
    captured = eng.counters.compiles
    pose = _engine_inputs(3, 1)[0]
    with eng:
        for step, i in enumerate((0, 4, 1, 5, 2, 6, 4, 0)):
            if i >= len(keys):
                keys.append(eng.specialize(betas[i]))   # evicts the LRU
            got = eng.forward(pose, subject=keys[i])
            want = _direct_k2(params, betas[i], pose, 4)
            assert _err(got, want) <= TOL, (step, i)
            other = _direct_k2(params, betas[(i + 1) % 7], pose, 4)
            assert _err(got, other) > 1e-3        # a wrong row would show
    assert eng.counters.specializations_evicted >= 3
    assert eng.counters.compiles == captured    # replays only, no capture


def test_woken_attempt_never_touches_a_later_batchs_buffers(dev):
    """An attempt killed at its deadline that wakes later (a latency fault
    longer than the deadline, then the primary) must not copy its input
    into the static buffers while the NEXT batch sits between its copy-in
    and its replay. The engine holds the device lock across copy-in,
    replay and readback, and an abandoned attempt touches nothing."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    # Batch 1's attempt 0 sleeps 0.65 s past its 0.5 s deadline and is
    # killed; the retry serves batch 1 at ~0.5 s; batch 2 then sits 0.3 s
    # (inside its own deadline) between its copy-in and its replay, and
    # attempt 0 wakes inside that window and calls the primary.
    policy, plan = _supervised("latency:0.65@0", lambda: True,
                               deadline_s=0.5)
    eng = ServingEngine(params, max_bucket=4, posed_kernel="fused",
                        policy=policy, max_delay_s=0.0)
    bare = ServingEngine(params, max_bucket=4, posed_kernel="fused")
    betas = np.random.default_rng(9).normal(size=(2, 10)).astype(np.float32)
    k = [eng.specialize(b) for b in betas]
    kb = [bare.specialize(b) for b in betas]
    eng.warmup_posed([4])
    prog = eng._gather_exes[4][1]

    class SlowReplay:
        """Holds a batch between its copy-in and its replay."""

        def __init__(self, graph):
            self.graph, self.hold = graph, 0.0

        def replay(self):
            time.sleep(self.hold)
            self.graph.replay()

    prog._graph = slow = SlowReplay(prog._graph)
    p1, p2 = _engine_inputs(4, 41)[0], _engine_inputs(4, 42)[0]
    with eng:
        t0 = time.perf_counter()
        first = eng.forward(p1, subject=k[0])     # the retry serves it
        fused_posed.launches = 0
        slow.hold = 0.3                           # the woken attempt's window
        t1 = time.perf_counter() - t0
        second = eng.forward(p2, subject=k[1])
        elapsed = time.perf_counter() - t0
    assert eng.counters.deadline_kills == 1 and eng.counters.retries == 1
    assert t1 < 0.65 < elapsed - 0.05             # it woke inside the window
    time.sleep(0.3)
    assert fused_posed.launches == 1              # the woken attempt: none
    with bare:
        np.testing.assert_array_equal(first, bare.forward(p1, subject=kb[0]))
        np.testing.assert_array_equal(second,
                                      bare.forward(p2, subject=kb[1]))


def test_graphs_and_lattice_ignore_the_callers_tf32_switch(dev, tmp_path):
    """Programs captured, and lattice programs loaded, under the caller's
    ``set_float32_matmul_precision("high")`` give the bits of programs
    built under "highest": each capture runs inside ``ieee_fp32()``, which
    an exported program does not carry on its own."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    betas = np.random.default_rng(13).normal(size=(2, 10)).astype(np.float32)
    base = ServingEngine(params, max_bucket=8, max_subjects=8,
                         aot_dir=tmp_path)
    keys = [base.specialize(b) for b in betas]
    base.warmup([8])
    base.warmup_posed([8])
    base.bake_lattice(capacities=[8])
    pose, shape = _engine_inputs(8, 2)
    idx = np.arange(8, dtype=np.int32) % 2
    want_full = base._run_full(pose, shape)
    want_posed = base._run_posed(base.table, idx, pose)
    torch.set_float32_matmul_precision("high")
    try:
        live = ServingEngine(params, max_bucket=8, max_subjects=8)
        loaded = ServingEngine(params, max_bucket=8, max_subjects=8,
                               aot_dir=tmp_path)
        for eng in (live, loaded):
            for b in betas:
                eng.specialize(b)
        assert live.warmup([8]) == {8: "jit"}
        assert loaded.warmup([8]) == {8: "aot"}
        assert loaded.warmup_posed([8]) == {8: "aot"}
        live.warmup_posed([8])
        for eng in (live, loaded):
            np.testing.assert_array_equal(eng._run_full(pose, shape),
                                          want_full)
            np.testing.assert_array_equal(
                eng._run_posed(eng.table, idx, pose), want_posed)
        assert torch.get_float32_matmul_precision() == "high"
        # The same lattice program run outside the pin: TF32, other bits.
        from mano_hand_tpu_torch.io.export_aot import params_leaves

        call = loaded._get_lattice().get("full", 8, platform="cuda")
        with torch.no_grad():
            unpinned = call(params_leaves(loaded._params),
                            torch.from_numpy(pose).to(dev),
                            torch.from_numpy(shape).to(dev))
        assert _err(unpinned, want_full) > 0.0
    finally:
        torch.set_float32_matmul_precision("highest")
    assert loaded.counters.aot_loads == 2 and loaded.counters.compiles == 0
    assert keys


def test_cpu_baked_lattice_degrades_on_the_card(dev, tmp_path):
    """An entry exported for the CPU and booted on the card is a counted
    platform degrade (a live capture), not a device-mismatch crash."""
    import warnings

    from mano_hand_tpu_torch.io import export_aot

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    export_aot.bake_lattice(params.to("cpu"), tmp_path, buckets=[2],
                            capacities=[], cpu_fallback=False)
    eng = ServingEngine(params, max_bucket=2, aot_dir=tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert eng.warmup([2]) == {2: "jit"}
    assert eng.counters.aot_load_failures == 1
    assert eng.counters.compiles == 1
    assert any("not the running device type 'cuda'" in str(w.message)
               for w in caught)
    with pytest.raises(ValueError, match="no CPU tier"):
        eng.bake_lattice(include_cpu_fallback=True)


def test_capture_failure_raises_and_is_a_servingerror_supervised(dev):
    """A program whose capture fails raises: unsupervised it stops the
    dispatcher (no silent eager mode), supervised the batch resolves to a
    ServingError; the card stays healthy."""
    from mano_hand_tpu_torch.serving import ServingError

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)

    def refuse_capture(pose, shape):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return core.forward_batched(params, pose, shape).verts

    pose = np.zeros((2, 16, 3), np.float32)
    bare = ServingEngine(params, max_bucket=2)
    bare._live_full = refuse_capture
    with pytest.raises(RuntimeError, match="capture refused"):
        bare.warmup([2])
    assert bare.counters.compiles == 0 and not bare._exes
    policy, _ = _supervised("", lambda: True)
    sup = ServingEngine(params, max_bucket=2, policy=policy)
    sup._live_full = refuse_capture
    with sup:
        with pytest.raises(ServingError, match="failed to build"):
            sup.forward(pose)
        del sup._live_full                     # the engine's own again
        assert sup.forward(pose).shape == (2, 778, 3)
    torch.cuda.synchronize()


def _traced_engine(dev, tracer, policy=None, **kw):
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    kw.setdefault("max_bucket", 8)
    eng = ServingEngine(params, posed_kernel="fused", tracer=tracer,
                        precision_policy=PrecisionPolicy(), policy=policy,
                        **kw)
    betas = np.random.default_rng(5).normal(size=(3, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    eng.warmup()
    eng.warmup_posed()
    return params, eng, keys


def test_traced_fused_engine_spans_and_events(dev):
    """A traced supervised engine on the card: one ``compile`` event a
    capture, every span closed once with JAX's event sequence (the graph
    replay's enqueue stamping ``dispatched``), K2 launches equal to the
    gathered dispatches, and a retried error on the timeline."""
    from mano_hand_tpu_torch.obs import Tracer
    from mano_hand_tpu_torch.runtime import ChaosPlan, DispatchPolicy

    tr = Tracer()
    plan = ChaosPlan()
    pol = DispatchPolicy(deadline_s=10.0, retries=1, backoff_s=0.0,
                         jitter=0.0, chaos=plan, cpu_fallback=False)
    _, eng, keys = _traced_engine(dev, tr, pol)
    names = [e[2] for e in tr.snapshot()["events"] if e[1] == 0]
    assert names.count("compile") == eng.counters.compiles == 12
    fused_posed.launches = fused_posed.bf16_launches = 0
    with eng:
        futs = [eng.submit(_engine_inputs(n, 40 + i)[0], subject=keys[i % 3],
                           priority=i % 2)
                for i, n in enumerate((1, 3, 8, 2))]
        futs.append(eng.submit(*_engine_inputs(5, 50)))
        for f in futs:
            f.result(timeout=120)
        plan.schedule("error@0")
        eng.forward(*_engine_inputs(2, 51))
    snap = eng.counters.snapshot()
    bf16 = snap["dispatches_bf16"]
    assert fused_posed.bf16_launches == bf16 >= 1
    assert fused_posed.launches == snap["dispatches"] - bf16 - 2 >= 1
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"] == 6
    assert acc["spans_open"] == acc["spans_double_closed"] == 0
    assert acc["closed_by_kind"] == {"ok": 6}
    for span in tr.spans():
        # Pipelined (the default depth 2): "staged" between the launch
        # boundary and the replay's enqueue.
        assert [e[1] for e in span["events"]][-5:] == [
            "launch", "staged", "dispatched", "readback", "resolve"]
    names = [e[2] for e in tr.snapshot()["events"] if e[1] == 0]
    assert names.count("chaos_fault") == names.count("retry") == 1
    assert names.count("pipeline") == 1
    assert names.count("compile") == 12        # none in steady traffic
    stages = tr.stage_breakdown()
    assert stages["complete_spans"] == 6
    for cell in stages["by_bucket_tier"].values():
        assert cell["device_p50_ms"] > 0


def test_sentinel_over_graph_programs(dev):
    """The sentinel probes the captured programs: full and K2 equal their
    eager references (0.0), K2-bf16 inside the envelope and nonzero; the
    probe captures nothing and launches K2 and K2-bf16 once each for the
    replay and once for the reference; a ``wrong`` fault drifts exactly
    the three wrapped families and clears."""
    from mano_hand_tpu_torch.obs import FlightRecorder, NumericsSentinel, Tracer
    from mano_hand_tpu_torch.runtime import ChaosPlan, DispatchPolicy

    tr = Tracer()
    rec = FlightRecorder(tr)
    plan = ChaosPlan()
    pol = DispatchPolicy(deadline_s=10.0, retries=0, chaos=plan,
                         cpu_fallback=False)
    _, eng, _ = _traced_engine(dev, tr, pol)
    s = NumericsSentinel(eng, tracer=tr)
    compiles = eng.counters.compiles
    fused_posed.launches = fused_posed.bf16_launches = 0
    res = s.probe()
    assert (fused_posed.launches, fused_posed.bf16_launches) == (2, 2)
    fam = res["families"]
    assert set(fam) == {"full", "gather", "gather_bf16"}
    assert not res["drift"]
    assert fam["full"]["max_abs_err"] == fam["gather"]["max_abs_err"] == 0.0
    assert 1e-6 < fam["gather_bf16"]["max_abs_err"] <= DEFAULT_ENVELOPE_M
    plan.schedule("wrong:1.0@0-")
    det = s.probe()
    plan.clear()
    assert det["drifted_families"] == ["full", "gather", "gather_bf16"]
    assert not s.probe()["drift"]
    assert eng.counters.compiles == compiles
    assert [c["reason"] for c in rec.captures] == ["numerics_drift"]
    acc = tr.accounting()
    assert acc["closed_by_kind"] == {"probe": 2, "drift": 1}


def test_background_probe_races_threaded_traffic(dev):
    """A background sentinel at a short interval probes while four threads
    dispatch on an engine of one bucket: no probe error, and afterwards
    every served result equals a direct eager call at that bucket (0.0):
    no probe touched a program's static buffers outside its lock. Each
    request fills the bucket, so each batch holds the rows of the direct
    call (a row of the plain full forward can round one ulp differently
    beside other rows; K2's rows do not)."""
    import threading

    from mano_hand_tpu_torch.obs import NumericsSentinel, Tracer
    from mano_hand_tpu_torch.serving import buckets

    tr = Tracer()
    params, eng, keys = _traced_engine(dev, tr, min_bucket=16,
                                       max_bucket=16)
    s = NumericsSentinel(eng, tracer=tr, interval_s=0.01)
    served, errors = [], []

    def client(t):
        try:
            for i in range(12):
                pose, shape = _engine_inputs(16, 100 * t + i)
                kind = (t + i) % 3
                out = (eng.forward(pose, shape) if kind == 2 else
                       eng.forward(pose, subject=keys[i % 3], priority=kind))
                served.append((pose, shape, i % 3, kind, out))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    with eng, s:
        ths = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        deadline = time.monotonic() + 10
        while s.status()["probes"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert not errors and not any(th.is_alive() for th in ths)
    st = s.status()
    assert st["probes"] >= 2 and st["probe_errors"] == st["drifts"] == 0
    table = eng.table
    with torch.no_grad():
        for pose, shape, k, kind, out in served:
            p16 = torch.from_numpy(buckets.pad_rows(pose, 16)).to(dev)
            if kind == 2:
                want = core.forward_batched(params, p16, torch.from_numpy(
                    buckets.pad_rows(shape, 16)).to(dev)).verts
            else:
                idx = torch.full((16,), eng._subject_slots[keys[k]],
                                 dtype=torch.int32, device=dev)
                want = core.forward_posed_gather_fused(
                    table, idx, p16,
                    compute_dtype=torch.bfloat16 if kind == 0 else None)
            np.testing.assert_array_equal(out, want[:len(pose)].cpu().numpy())
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]


def test_probe_thread_pins_the_engines_card(dev, monkeypatch):
    """A probe runs on the engine's card whatever the calling thread's
    current device: with two cards the engine sits on the second while
    the caller stays on the first; with one, the probe is seen entering
    its engine's card."""
    from mano_hand_tpu_torch.obs import NumericsSentinel
    from mano_hand_tpu_torch.obs import sentinel as sentinel_mod

    n = torch.cuda.device_count()
    card = torch.device("cuda", n - 1)
    torch.cuda.set_device(0)
    _, eng, _ = _traced_engine(card, None)
    seen = []
    entered = sentinel_mod._on_card

    def spy(device):
        seen.append(device)
        return entered(device)

    monkeypatch.setattr(sentinel_mod, "_on_card", spy)
    s = NumericsSentinel(eng, interval_s=0.01)
    probe_family = s._probe_families

    def record(t):
        seen.append(("current", torch.cuda.current_device()))
        return probe_family(t)

    s._probe_families = record
    with s:
        deadline = time.monotonic() + 10
        while s.status()["probes"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert torch.cuda.current_device() == 0
    assert s.status()["probe_errors"] == 0 and s.status()["probes"] >= 1
    assert seen[0] == card and seen[1] == ("current", card.index)


def test_k2_rows_ignore_their_batchmates(dev):
    """K2's and K2-bf16's rows give the same bits wherever a request sits
    in its batch and whatever rows sit beside it (0.0), so a coalesced
    gathered batch serves each request as a lone direct call of the
    same bucket would."""
    from mano_hand_tpu_torch.serving import buckets

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        table = core.stack_shaped([core.specialize(params, torch.from_numpy(
            rng.normal(size=10).astype(np.float32)).to(dev))
            for _ in range(3)])
    for dt in (None, torch.bfloat16):
        for n in (1, 3, 5):
            pose, _ = _engine_inputs(n, 10 + n)
            slot = n % 3
            with torch.no_grad():
                alone = core.forward_posed_gather_fused(
                    table, torch.full((16,), slot, dtype=torch.int32,
                                      device=dev),
                    torch.from_numpy(buckets.pad_rows(pose, 16)).to(dev),
                    compute_dtype=dt)[:n]
                for off in range(16 - n + 1):
                    batch, _ = _engine_inputs(16, 100 + off)
                    batch[off:off + n] = pose
                    idx = rng.integers(0, 3, size=16).astype(np.int32)
                    idx[off:off + n] = slot
                    got = core.forward_posed_gather_fused(
                        table, torch.from_numpy(idx).to(dev),
                        torch.from_numpy(batch).to(dev), compute_dtype=dt)
                    assert torch.equal(got[off:off + n], alone), (dt, n, off)


def _stall_cycles(seconds):
    """``torch.cuda._sleep`` cycles for at least ``seconds`` on a card
    clocked at or below 2 GHz."""
    return int(seconds * 2e9)


def test_pipelined_batches_keep_stream_order(dev):
    """Depth 2: two completion workers launch and read back concurrently
    from one static output, while another thread with a side stream
    current calls the same program directly. Every copy and replay goes
    to the device's default stream, so each batch's readback completes
    before the next replay overwrites the output: every result equals its
    direct call. Alternating subjects make a result read from the wrong
    batch show (the subjects differ by centimetres)."""
    import threading

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = ServingEngine(params, min_bucket=64, max_bucket=64,
                        posed_kernel="fused", max_delay_s=0.0,
                        inflight_depth=2)
    betas = np.random.default_rng(17).normal(size=(2, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    eng.warmup_posed([64])
    poses = [_engine_inputs(64, 300 + i)[0] for i in range(24)]
    table = eng.table
    side_out = []

    def side_caller():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for i in range(24):
                idx = np.full(64, eng._subject_slots[keys[i % 2]],
                              dtype=np.int32)
                side_out.append((i, eng._run_posed(table, idx, poses[i])))

    th = threading.Thread(target=side_caller)
    with eng:
        th.start()
        futs = [eng.submit(p, subject=keys[i % 2])
                for i, p in enumerate(poses)]
        got = [f.result(timeout=120) for f in futs]
        th.join(120)
    assert eng.counters.pipeline_completions == 24
    assert eng.counters.pipeline_inflight_peak == 2
    for i, out in enumerate(got):
        want = _direct_k2(params, betas[i % 2], poses[i], 64)
        np.testing.assert_array_equal(out, want)
        assert _err(out, _direct_k2(params, betas[(i + 1) % 2],
                                    poses[i], 64)) > 1e-3
    for i, out in side_out:
        np.testing.assert_array_equal(
            out, _direct_k2(params, betas[i % 2], poses[i], 64))


def test_abandoned_attempt_keeps_its_output_slab(dev):
    """An attempt abandoned after its launch (the card stalled behind it
    past the deadline) still has its readback in flight into its pinned
    output slab: the retry reads back into another slab (the abandoned
    one is still held, and the pinned cache would not hand it out before
    its copy lands anyway), and every later batch, from two threads at
    depth 2, serves its own bits."""
    import threading

    from mano_hand_tpu_torch.serving import buckets

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    policy, plan = _supervised("", lambda: True, deadline_s=0.3)
    eng = ServingEngine(params, max_bucket=8, posed_kernel="fused",
                        policy=policy, max_delay_s=0.0, inflight_depth=2)
    betas = np.random.default_rng(23).normal(size=(2, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    eng.warmup_posed([8])
    prog = eng._gather_exes[8][1]
    slabs = []
    launch = prog.launch

    def recording_launch(*a, **kw):
        h = launch(*a, **kw)
        slabs.append(h._slab.data_ptr())
        return h

    class StalledReplay:
        """The first replay runs behind a device stall past the
        deadline."""

        def __init__(self, graph):
            self.graph, self.stall = graph, _stall_cycles(0.45)

        def replay(self):
            if self.stall:
                torch.cuda._sleep(self.stall)
                self.stall = 0
            self.graph.replay()

    prog.launch = recording_launch
    prog._graph = StalledReplay(prog._graph)
    p1 = _engine_inputs(8, 51)[0]
    with eng:
        first = eng.forward(p1, subject=keys[0])
        assert eng.counters.deadline_kills == 1
        assert len(slabs) == 2 and slabs[1] != slabs[0]
        more = []

        def client(t):
            for i in range(8):
                p = _engine_inputs(8, 400 + 10 * t + i)[0]
                more.append((t, i, p, eng.forward(p, subject=keys[t])))

        ths = [threading.Thread(target=client, args=(t,)) for t in (0, 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
    torch.cuda.synchronize(dev)
    np.testing.assert_array_equal(
        first, _direct_k2(params, betas[0], p1, 8))
    assert len(more) == 16
    for t, i, p, out in more:
        np.testing.assert_array_equal(out, _direct_k2(
            params, betas[t], p, buckets.bucket_for(8, eng.buckets)))


def test_prefetched_promotion_waits_for_its_copy(dev):
    """A warm row prefetched on the store's side stream, with that stream
    stalled behind the copy: the install's stream waits on the copy's
    event before the table write reads the rows, so the promoted subject
    serves the fresh bake's bits. A demoted row's copy to the host is on
    the host before its slot is reused."""
    from mano_hand_tpu_torch.serving.subject_store import (
        ROW_KEYS, SubjectStore,
    )

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    store = SubjectStore(warm_capacity=8)
    eng = ServingEngine(params, max_bucket=4, max_subjects=2,
                        posed_kernel="fused", subject_store=store,
                        max_delay_s=0.0)
    betas = np.random.default_rng(29).normal(size=(3, 10)).astype(np.float32)
    keys = eng.register_subjects(betas)
    pose = _engine_inputs(4, 61)[0]
    with eng:
        first = [eng.forward(pose, subject=k) for k in keys]  # k0 demotes
        assert keys[0] in store.warm_digests()
        for k in ROW_KEYS:
            assert store._warm[keys[0]][k].is_pinned()
        store._side = torch.cuda.Stream(dev)
        with torch.cuda.stream(store._side):
            torch.cuda._sleep(_stall_cycles(0.2))
        assert store.prefetch(keys[0])
        again = eng.forward(pose, subject=keys[0])
    c = eng.counters.snapshot()
    assert c["subject_store_warm_hits"] == 1
    assert c["subject_store_prefetches"] >= 1
    assert c["subject_store_promotion_ms"]["p99_ms"] > 50.0   # it waited
    want = _direct_k2(params, betas[0], pose, 4)
    np.testing.assert_array_equal(first[0], want)
    np.testing.assert_array_equal(again, want)


def test_landed_prefetch_installs_without_a_wait(dev, monkeypatch):
    """A warm row whose prefetched copy has landed settles without a host
    wait on its event, and its rows equal the warm row's bits; a
    promotion consumed on another stream than the one it was marked for
    serves the same bits."""
    from mano_hand_tpu_torch.serving.subject_store import (
        ROW_KEYS, SubjectStore, subject_digest,
    )
    from mano_hand_tpu_torch.utils.profiling import ServingCounters

    rng = np.random.default_rng(31)
    store = SubjectStore(warm_capacity=4)
    store.bind(ServingCounters(), device=dev)
    digests = []
    for _ in range(2):
        row = {"v_shaped": rng.normal(size=(778, 3)).astype(np.float32),
               "joints": rng.normal(size=(16, 3)).astype(np.float32),
               "shape": rng.normal(size=(10,)).astype(np.float32)}
        digests.append(subject_digest(row["shape"]))
        store.demote(digests[-1], row)
    assert store.prefetch(digests[0]) and store.prefetch(digests[1])
    torch.cuda.synchronize(dev)

    def no_wait(self):
        raise AssertionError("a landed copy was waited for")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda.Event, "synchronize", no_wait)
        rows, tier = store.fetch_row(digests[0])
    other = torch.cuda.Stream(dev)
    with torch.cuda.stream(other):
        rows_other, tier_other = store.fetch_row(digests[1])
        got_other = {k: v.cpu() for k, v in rows_other.items()}
    assert tier == tier_other == "warm"
    for d, got in ((digests[0], rows), (digests[1], got_other)):
        for k in ROW_KEYS:
            np.testing.assert_array_equal(
                got[k].cpu().numpy(), store._warm[d][k].numpy())


def test_loaded_artifact_graph_keeps_its_module(dev, tmp_path):
    """A program loaded from a legacy artifact is captured into a graph
    that reads the loaded module's constants (FK's index tensors) in
    place: the program keeps the module, so after a collection and
    device-memory churn its replays still serve the live bits."""
    import gc

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    live = ServingEngine(params, max_bucket=4, aot_dir=tmp_path)
    assert live.warmup([4]) == {4: "jit"}          # writes the artifact
    loaded = ServingEngine(params, max_bucket=4, aot_dir=tmp_path)
    assert loaded.warmup([4]) == {4: "aot"}
    prog = loaded._exes[4]
    assert prog._keep is not None
    pose, shape = _engine_inputs(4, 71)
    want = live._run_full(pose, shape)
    gc.collect()
    junk = [torch.full((n,), 10 ** 9, dtype=torch.long, device=dev)
            for n in (1, 2, 3, 4, 8, 16, 64) for _ in range(64)]
    del junk
    junk = [torch.full((n,), 10 ** 9, dtype=torch.long, device=dev)
            for n in (1, 2, 3, 4, 8, 16, 64) for _ in range(64)]
    for _ in range(3):
        np.testing.assert_array_equal(loaded._run_full(pose, shape), want)
    del junk
    torch.cuda.synchronize(dev)


def _lane_engine(params, lanes, **kw):
    kw.setdefault("posed_kernel", "fused")
    kw.setdefault("max_delay_s", 0.0)
    return ServingEngine(params, lanes=lanes, **kw)


def test_two_lanes_replay_concurrently_with_single_lane_bits(dev):
    """Two lanes, each on its own stream with its own graph pool, replay
    concurrently for 200 batches from four client threads: every result
    is the single-context engine's bits (a shared pool would let one
    lane's replay overwrite the other's intermediates), and K2 launches
    equal the lanes' gathered dispatches."""
    import threading

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = _lane_engine(params, 2, min_bucket=16, max_bucket=16)
    betas = np.random.default_rng(71).normal(size=(4, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    eng.warmup_posed([16])
    lanes = eng._get_lanes().lanes
    assert lanes[0].ctx.pool is not None
    assert lanes[0].ctx.pool != lanes[1].ctx.pool
    assert lanes[0].ctx.stream != lanes[1].ctx.stream
    poses = [_engine_inputs(16, 700 + i)[0] for i in range(200)]
    got = [None] * len(poses)

    def client(t):
        for i in range(t, len(poses), 4):
            got[i] = eng.forward(poses[i], subject=keys[i % 4])

    fused_posed.launches = 0
    with eng:
        ths = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(300)
            assert not th.is_alive()
        snap = eng.load()["lanes"]
    assert fused_posed.launches == eng.counters.dispatches == 200
    assert all(p["dispatched"] >= 50 for p in snap["per_lane"])
    for i, out in enumerate(got):
        np.testing.assert_array_equal(
            out, _direct_k2(params, betas[i % 4], poses[i], 16))


def test_row_installed_on_the_engine_stream_reaches_every_lane(dev):
    """A subject installed while the engine's stream is stalled: the row
    is written there behind the stall, and every lane's next batch of
    that subject waits for it (the lanes' streams do not wait for the
    default stream on their own) and serves the fresh bake's bits."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = _lane_engine(params, 4, max_bucket=4)
    betas = np.random.default_rng(73).normal(size=(2, 10)).astype(np.float32)
    k0 = eng.specialize(betas[0])
    eng.warmup_posed([4])
    pose = _engine_inputs(4, 81)[0]
    with eng:
        for _ in range(4):
            eng.forward(pose, subject=k0)     # every lane holds the table
        with eng._on_device():
            torch.cuda._sleep(_stall_cycles(0.3))
        k1 = eng.specialize(betas[1])         # written behind the stall
        got = [eng.forward(pose, subject=k1) for _ in range(8)]
        per = eng.load()["lanes"]["per_lane"]
    assert all(p["assigned"] >= 3 for p in per)
    want = _direct_k2(params, betas[1], pose, 4)
    for out in got:
        np.testing.assert_array_equal(out, want)


def test_staging_slab_waits_for_its_lanes_copy_in(dev):
    """A batch whose attempt on lane 0 was abandoned behind a stalled lane
    stream and served by lane 1: its pinned staging slab still has lane
    0's copy-in queued, so it is fenced on lane 0's stream and not handed
    out again until that stream has passed the copy."""
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    policy, plan = _supervised("", lambda: True, deadline_s=0.3)
    policy.breaker.failure_threshold = 100    # lane 0 stays placeable
    eng = _lane_engine(params, 2, min_bucket=8, max_bucket=8,
                       policy=policy, lane_probe=lambda i: True)
    beta = np.random.default_rng(79).normal(size=(10,)).astype(np.float32)
    key = eng.specialize(beta)
    eng.warmup_posed([8])
    ls = eng._get_lanes()
    pose = _engine_inputs(8, 83)[0]
    with eng:
        eng.forward(pose, subject=key)
        with ls._lock:
            ls._rr = 0                        # the next batch: lane 0
        with torch.cuda.stream(ls.lanes[0].ctx.stream):
            torch.cuda._sleep(_stall_cycles(1.0))
        got = eng.forward(pose, subject=key)   # lane 0 twice, then lane 1
        assert eng.counters.deadline_kills == 2
        per = eng.load()["lanes"]["per_lane"]
        assert per[0]["failovers_out"] == 1 and per[1]["failovers_in"] == 1
        assert len(eng._slab_fenced) == 1
        events, fenced = eng._slab_fenced[0]
        assert not all(e.query() for e in events)   # lane 0 still stalled
        st = eng._staging_acquire(True)
        assert st is not fenced
        torch.cuda.synchronize(dev)
        eng._staging_release(st)
        st2 = eng._staging_acquire(True)
        assert not eng._slab_fenced
        eng._staging_release(st2)
    np.testing.assert_array_equal(got, _direct_k2(params, beta, pose, 8))


def test_capture_on_one_lane_while_another_serves(dev):
    """Captures of new buckets on every lane (and the engine) while four
    client threads keep the lanes serving: the captures succeed, the
    traffic serves its bits throughout, and the new programs serve
    theirs."""
    import threading

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = _lane_engine(params, 2, max_bucket=32)
    betas = np.random.default_rng(89).normal(size=(2, 10)).astype(np.float32)
    keys = [eng.specialize(b) for b in betas]
    eng.warmup_posed([8])
    stop = threading.Event()
    served = []

    def client(t):
        i = 0
        while not stop.is_set():
            p = _engine_inputs(8, 900 + 100 * t + i)[0]
            served.append((t, p, eng.forward(p, subject=keys[t % 2])))
            i += 1

    with eng:
        ths = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in ths:
            th.start()
        before = len(served)
        eng.warmup_posed([16, 32])            # captures while serving
        during = len(served) - before
        stop.set()
        for th in ths:
            th.join(120)
            assert not th.is_alive()
        p16 = _engine_inputs(16, 991)[0]
        got16 = eng.forward(p16, subject=keys[0])
    assert during >= 1
    for t, p, out in served:
        np.testing.assert_array_equal(
            out, _direct_k2(params, betas[t % 2], p, 8))
    np.testing.assert_array_equal(got16,
                                  _direct_k2(params, betas[0], p16, 16))


def test_card_lane_engine_with_every_lane_down_is_a_servingerror(dev):
    """A card engine has no CPU tier: with every lane down the ladder ends
    at the siblings and the batch resolves to its ServingError, nothing
    fails over to the CPU."""
    from mano_hand_tpu_torch.serving import ServingError

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    policy, plan = _supervised("error@0-", lambda: False)
    eng = _lane_engine(params, 2, max_bucket=4, policy=policy,
                       lane_probe=lambda i: False)
    key = eng.specialize(np.zeros(10, np.float32))
    eng.warmup_posed([4])
    pose = _engine_inputs(4, 97)[0]
    try:
        with eng:
            for _ in range(2):
                with pytest.raises(ServingError) as e:
                    eng.forward(pose, subject=key)
                assert e.value.kind == "error"
                assert "cpu_fallback is disabled" in str(e.value)
            snap = eng.load()["lanes"]
    finally:
        plan.release.set()
    assert eng.counters.failovers == 0
    assert all(p["cpu_failovers"] == 0 for p in snap["per_lane"])
    assert sum(p["errors"] for p in snap["per_lane"]) == 2


def test_wire_forward_through_a_fused_engine_equals_submit(dev):
    """A request that crossed the edge's socket is served by K2 on the
    card: bit for bit the same engine's in-process submit, one K2 launch
    a gathered dispatch (the graph replays count theirs)."""
    from mano_hand_tpu_torch.edge import EdgeClient, EdgeServer
    from mano_hand_tpu_torch.obs import Tracer

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    eng = ServingEngine(params, device=dev, max_bucket=8,
                        posed_kernel="fused", tracer=Tracer())
    rng = np.random.default_rng(160)
    key = eng.specialize(rng.normal(size=10).astype(np.float32))
    eng.warmup_posed()
    srv = EdgeServer(eng, port=0).start()
    try:
        before = eng.counters.snapshot()
        fused_posed.launches = 0
        with EdgeClient("127.0.0.1", srv.port, timeout_s=60.0) as cli:
            for n in (1, 2, 3, 4, 8):
                pose = rng.normal(scale=0.4, size=(n, 16, 3)).astype(
                    np.float32)
                wire = cli.forward(pose, subject=key)
                local = eng.submit(pose, subject=key).result(timeout=60)
                np.testing.assert_array_equal(wire, local)
        after = eng.counters.snapshot()
        assert fused_posed.launches == (after["dispatches"]
                                        - before["dispatches"]) == 10
        assert after["compiles"] == before["compiles"]
    finally:
        assert srv.drain(timeout_s=10.0)["drained"]


def test_serve_subprocess_on_the_card(dev, tmp_path):
    """``serve --posed-kernel fused`` on the card: the ready line (the
    shared ``server`` device lock taken), requests within 1e-5 of an
    in-process K2 call, and the SIGTERM drain's exit line, whose K2
    launches equal its gathered dispatches plus one eager warm call a
    gathered program captured after the ready line."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import threading
    from pathlib import Path

    from mano_hand_tpu_torch.edge import EdgeClient

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, MANO_DEVICE_LOCK_DIR=str(tmp_path),
               PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mano_hand_tpu_torch", "serve",
         "--posed-kernel", "fused", "--port", "0", "--max-bucket", "8",
         "--drain-timeout-s", "10"],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        box = []
        t = threading.Thread(target=lambda: box.append(
            proc.stdout.readline()), daemon=True)
        t.start()
        t.join(300)
        ready = json.loads(box[0])["edge"]
        assert ready["device_lock"] == "server"
        params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(161)
        betas = rng.normal(size=10).astype(np.float32)
        table = core.stack_shaped([core.specialize(
            params, torch.from_numpy(betas).to(dev))])
        with EdgeClient("127.0.0.1", ready["port"], timeout_s=120.0) as cli:
            ready_compiles = _metric(cli.metrics_text(),
                                     "mano_serving_compiles")
            key = cli.specialize(betas)
            for n in (1, 2, 4, 3):
                pose = rng.normal(scale=0.4, size=(n, 16, 3)).astype(
                    np.float32)
                got = cli.forward(pose, subject=key)
                want = core.forward_posed_gather_fused(
                    table, torch.zeros(n, dtype=torch.int32, device=dev),
                    torch.from_numpy(pose).to(dev))
                assert _err(got, want) <= TOL
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        exit_line = json.loads(out.strip().splitlines()[-1])["edge_exit"]
        assert exit_line["drained"] and exit_line["within_timeout"]
        assert exit_line["accounting"]["spans_open"] == 0
        ln = exit_line["launches"]
        captures = exit_line["counters"]["compiles"] - ready_compiles
        assert ln["dispatches_gathered"] == ln["dispatches"] == 4
        assert captures >= 1
        assert ln["K2"] == ln["dispatches_gathered"] + captures
        assert ln["K2_bf16"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def _metric(text, name):
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return int(float(ln.split()[1]))
    raise AssertionError(f"no {name} in the /metrics text")


def test_selfheal_drill_on_the_card(dev, tmp_path, monkeypatch):
    """``selfheal_drill_run`` at plumbing size with ``serve`` workers on
    the card (each its own CUDA context under the shared device lock):
    every death healed by its channel, the proxy pair's takeover, the
    storm degrading without a flap, the shard rebalance and the damaged
    page on a card engine, every frame terminal with continuous
    numbering, verts within 1e-6 of the in-process reference. (It runs
    over 40 s on the CPU, where its plumbing test is slow-marked.)"""
    from mano_hand_tpu_torch.serving import selfheal_drill_run

    monkeypatch.setenv("MANO_DEVICE_LOCK_DIR", str(tmp_path))
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    sd = selfheal_drill_run(
        params, device=dev, workers=3, lanes=2, streams=4,
        frames_per_stream=6, stream_workers=4, unique_tracks=2,
        max_bucket=4, max_subjects=8, store_warm_capacity=4,
        work_dir=str(tmp_path / "work"), ready_timeout_s=420.0)
    assert sd["reference_platform"] == "cuda"
    assert sd["lattice_boot_ok"] and sd["campaign_done"]
    assert sd["terminal_fraction"] == 1.0 and not sd["close_errors"]
    assert sd["outcomes"]["exception"] == 0 and sd["closes_ok"] == 4
    assert sd["frames_compared"] == sd["frame_numbering_ok"] > 0
    assert sd["verts_max_abs_err"] <= 1e-6
    assert sd["all_deaths_auto_healed"]
    assert sd["supervisor_restarts"] == sd["expected_heals"] == 2
    assert sorted(h["reason"] for h in sd["supervisor"]["heals"]) == [
        "exit", "probe"]
    assert sd["proxy_health"] == {"proxy_role": "active", "takeovers": 1}
    assert sd["steady_recompiles_total"] == 0
    assert sd["spans_closed_exactly_once"]
    st = sd["storm"]
    assert st["degraded_without_flap"] and st["degraded_frames_ok"] >= 1
    rb, dm = sd["rebalance"], sd["damage"]
    assert rb["shard_rebalances"] == 1 and rb["steady_recompiles"] == 0
    assert rb["max_abs_err"] == 0.0 and rb["pre_loss_max_abs_err"] == 0.0
    assert dm["damage_counted"] >= 1 and dm["request_max_abs_err"] == 0.0


def test_posed_kernel_bench_run_parity_on_the_card(dev):
    """The engine-level K2 protocol on the card: K2 within 1e-5 of the
    per-subject posed program, the plain gathered program 0.0 at matched
    padded size (its rows in a coalesced batch round by that batch's
    size), no steady capture on either side, and the artifact says K2
    ran."""
    from mano_hand_tpu_torch.serving import posed_kernel_bench_run

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    out = posed_kernel_bench_run(params, device=dev, subjects=4,
                                 requests=24, max_bucket=16, trials=1,
                                 lm_batch=0)
    assert out["platform"] == "cuda" and out["interpret"] is False
    assert out["gather_fused_active"] is True
    assert out["fused_vs_gather_max_abs_err"] <= TOL
    assert out["xla_vs_gather_matched_max_abs_err"] == 0.0
    assert out["xla_vs_gather_max_abs_err"] <= 1e-6
    assert out["steady_recompiles_fused"] == 0
    assert out["steady_recompiles_xla"] == 0


def _zero_counts():
    fused_posed.launches = 0
    fused_posed.bf16_launches = 0


def _counts():
    return {"K2": fused_posed.launches, "K2_bf16": fused_posed.bf16_launches}


def test_ladder_bias_over_k2_and_k2_bf16_on_the_card(dev):
    """``chip_smoke.ct_ladder`` at a 16-bucket engine under
    ``PrecisionPolicy()``: every bias's f32 rows within 1e-5 of the plain
    gathered program and its bf16 rows of the plain bf16 version (inside
    the envelope against f32), every bias within 1e-5 of bias 0, no
    capture after warm-up, K2 / K2-bf16 launches equal to the f32 / bf16
    gathered dispatches, rows_padded rising with the bias; then a
    Controller raising the bias to the top and restoring it under two
    threads (the function raises on any miss)."""
    import chip_smoke

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    line = chip_smoke.ct_ladder(dev, params, _counts, _zero_counts,
                                bucket=16, subjects=4, requests=24,
                                trials=1, threads=2)
    assert set(line["by_bias"]) == {"0", "1", "2", "3", "4"}
    assert line["bias_passes"]["launches"]["K2"] > 0
    assert line["bias_passes"]["launches"]["K2_bf16"] > 0
    assert line["controller"]["trajectory"][-1] == 0
    assert 4 in line["controller"]["trajectory"]


def test_serve_control_process_on_the_card(dev, monkeypatch, tmp_path):
    """``chip_smoke.ct_serve``: ``serve --control --posed-kernel fused``
    at bucket 8 under a short flash crowd from two client processes —
    the control block attached and running in ``status --server``,
    ``load_control_*`` on /metrics, wire rows within 1e-5 of the plain
    gathered program, every 429's Retry-After one the controller held,
    the exit line's K2 launches == gathered dispatches + warm calls, the
    SIGTERM drain in time (the function raises on any miss)."""
    import chip_smoke

    monkeypatch.setenv("MANO_DEVICE_LOCK_DIR", str(tmp_path))
    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    line = chip_smoke.ct_serve(dev, params, bucket=8, subjects=2,
                               clients=2, threads=6, requests=32,
                               max_queued=8, tier1_quota=2,
                               trace_kw=dict(duration_s=1.5))
    ln = line["exit_launches"]
    assert ln["K2"] == ln["expected_K2"] and ln["dispatches_gathered"] > 0
    assert line["status_after"]["control"]["running"]


def test_control_drill_on_the_card(dev):
    """``control_drill_run`` at JAX's plumbing size over card engines: every
    request terminal, no steady capture, actuations evented, the crash
    leg reverted."""
    from mano_hand_tpu_torch.serving import control_drill_run

    params = synthetic_params(seed=0, dtype=torch.float32, device=dev)
    out = control_drill_run(
        params, device=dev, trace_duration_s=0.7, workers=8, pairs=1,
        max_bucket=4, max_queued=8, tier1_quota=2, sat_latency_s=0.01,
        cadence_s=0.03, seed=5)
    assert out["unresolved_total"] == 0
    assert out["steady_recompiles_total"] == 0
    assert out["actuations_total"] > 0 and out["actuations_evented"]
    assert out["spans_closed_exactly_once"]
    assert out["crash_leg"]["reverted_to_static"]


# ------------------------------------------------------------ parallel
@pytest.fixture(scope="module")
def card_mesh(dev):
    """A 1x1 mesh on the card: the single-rank NCCL group ``make_mesh``
    starts in this process, torn down with the module."""
    import torch.distributed as dist

    from mano_hand_tpu_torch import parallel
    from mano_hand_tpu_torch.parallel import mesh as mesh_mod

    mesh = parallel.make_mesh(1, 1, devices=[dev])
    assert dist.get_backend() == "nccl"
    try:
        yield mesh
    finally:
        dist.destroy_process_group()
        mesh_mod._group_device.clear()


def _comms(fn):
    from torch.distributed.tensor.debug import CommDebugMode

    mode = CommDebugMode()
    with mode:
        out = fn()
    torch.cuda.synchronize()
    # A collective's key prints as "c10d.allreduce_" or, in newer torch,
    # as "<OpOverloadPacket(op='c10d.allreduce_')>".
    return out, {str(k).split("'")[1] if "'" in str(k) else str(k): v
                 for k, v in mode.get_comm_counts().items()}


@pytest.mark.parametrize("b", [1, 1000, 4096])
def test_pallas_forward_dp_launches_k1_and_k4_on_the_card(dev, card_mesh,
                                                          b):
    from mano_hand_tpu_torch.parallel import sharding as shd

    params = _params(dev)
    rng = np.random.default_rng(b)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(b, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(b, 10)).astype(
        np.float32)).to(dev)
    plain = fused_forward.forward_verts_plain(
        fused_forward.fused_operands(params), pose, shape)
    for full, counter in ((True, "launches"), (False, "blend_skin_launches")):
        fwd = shd.pallas_forward_dp(params, card_mesh, full=full)
        before = (fused_forward.launches, fused_forward.blend_skin_launches)
        with torch.no_grad():
            out = fwd(pose, shape)
        torch.cuda.synchronize()
        after = (fused_forward.launches, fused_forward.blend_skin_launches)
        want = (1, 0) if full else (0, 1)
        assert tuple(a - c for a, c in zip(after, before)) == want
        assert out.to_local().device == dev and tuple(out.shape) == (
            b, 778, 3)
        assert _err(out.to_local(), plain) <= TOL


def test_sharded_forwards_on_the_card_with_one_all_reduce(dev, card_mesh):
    from mano_hand_tpu_torch.parallel import sharding as shd

    params = _params(dev)
    rng = np.random.default_rng(3)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(256, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(256, 10)).astype(
        np.float32)).to(dev)
    want = core.forward_batched(params, pose, shape).verts
    sp = shd.shard_params(params, card_mesh)
    with torch.no_grad():
        out, comms = _comms(lambda: shd.shard_map_forward(sp, card_mesh)(
            pose, shape))
        assert comms == {"c10d.allreduce_": 1}
        assert _err(out.full_tensor(), want) <= TOL
        got = shd.gspmd_forward(sp, card_mesh)(pose, shape).full_tensor()
    assert got.device == dev and _err(got, want) <= TOL


def test_sharded_fit_step_on_the_card_tracks_the_unsharded_step(dev,
                                                                card_mesh):
    from mano_hand_tpu_torch import ops, parallel
    from mano_hand_tpu_torch.fitting import objectives, solvers

    params = _params(dev)
    rng = np.random.default_rng(5)
    pose = torch.from_numpy(rng.normal(scale=0.5, size=(64, 16, 3)).astype(
        np.float32)).to(dev)
    shape = torch.from_numpy(rng.normal(size=(64, 10)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        targets = core.forward_batched(params, pose, shape).verts
    opt = solvers.adam(0.05)
    step = parallel.make_fit_step(params, card_mesh, opt)
    state = parallel.init_state(params, 64, opt, mesh=card_mesh)
    p = torch.zeros((64, 16, 3), device=dev, requires_grad=True)
    s = torch.zeros((64, 10), device=dev, requires_grad=True)
    plain_opt = opt([p, s])
    for _ in range(5):
        state, loss = step(state, targets)
        plain_opt.zero_grad()
        want = objectives.vertex_l2(core.forward_rotmats(
            params, ops.rotation_matrix(p), s).verts, targets)
        want.backward()
        plain_opt.step()
        assert loss.device == dev
        want = float(want.detach())
        assert abs(float(loss) - want) <= 1e-4 * want
    assert _err(state.pose, p) <= 1e-5


def test_prefetch_lands_batches_on_the_card_in_order(dev, card_mesh):
    from mano_hand_tpu_torch.utils import batches, prefetch_to_device

    rng = np.random.default_rng(7)
    arrs = {"pose": rng.normal(size=(64, 16, 3)).astype(np.float32),
            "beta": rng.normal(size=(64, 10)).astype(np.float32)}
    got = list(prefetch_to_device(batches(arrs, 8), size=3, device=dev))
    assert len(got) == 8
    for b, h in zip(got, batches(arrs, 8)):
        assert b["pose"].device == dev and b["beta"].device == dev
        assert torch.equal(b["pose"].cpu(), torch.from_numpy(h["pose"]))
    sharded = list(prefetch_to_device(batches(arrs, 16), mesh=card_mesh))
    assert len(sharded) == 4
    for b, h in zip(sharded, batches(arrs, 16)):
        local = b["beta"].to_local()
        assert local.device == dev
        assert torch.equal(local.cpu(), torch.from_numpy(h["beta"]))


# ------------------------------------------------- sharded fits (examples)
def _sharded_fit_ranks(tmp_path, world, device):
    """``tests/torch_sharded_fits.py`` in ``world`` gloo rank processes on
    ``device``; each rank's arrays."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"log{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_sharded_fits.py"),
         str(r), str(world), str(tmp_path / "store"), str(tmp_path),
         device], env=env, cwd=tmp_path, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{r}.txt").read_text()[
            -3000:]
    return [dict(np.load(tmp_path / f"sharded_fits_rank{r}.npz"))
            for r in range(world)]


def test_sharded_fits_over_two_gloo_ranks_on_the_card(dev, tmp_path):
    """JAX's two sharded fits (the mask batch and the clip's frames over
    'data') on two gloo ranks sharing cuda:0: each rank's rows and the
    replicated leaves within 1e-5 of the unsharded fit on the card."""
    ranks = _sharded_fit_ranks(tmp_path, 2, "cuda:0")
    for case, leaves, sharded in (
            ("mask", ("pose", "shape", "trans", "loss_history"), "all"),
            ("seq", ("pose", "loss_history", "shape"), ("pose",)),
            ("seq6d", ("pose", "trans", "shape"), ("pose", "trans"))):
        for leaf in leaves:
            want = ranks[0][f"{case}_{leaf}_local"]
            if sharded == "all" or leaf in sharded:
                got = np.concatenate([r[f"{case}_{leaf}"] for r in ranks])
            else:
                got = ranks[1][f"{case}_{leaf}"]
                np.testing.assert_array_equal(got, ranks[0][f"{case}_{leaf}"])
            assert got.shape == want.shape, (case, leaf)
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                       err_msg=f"{case} {leaf}")
    for fit in ("fit", "fit_sequence"):
        said = {str(r[f"uneven_{fit}_error"]) for r in ranks}
        assert len(said) == 1 and "chunk rule" in said.pop(), fit


# ----------------------------------------------- launch counts (ops/common)
def test_captured_launches_count_on_every_replay(dev):
    """K1, K5, K4 and K3 count through ``common.count_launch``: a launch
    captured into a CUDA graph counts nothing while captured and one on
    each replay (``add_launches``), as K2's always did."""
    from mano_hand_tpu_torch.ops.common import add_launches, \
        captured_launches

    params = _params(dev)
    ops = fused_forward.fused_operands(params)
    stacked = core.stack_params(mirror_params(params), params)
    pose = 0.3 * torch.randn(16, 16, 3, device=dev)
    shape = torch.randn(16, 10, device=dev)
    coef, rot, t = (x.contiguous() for x in
                    fused_forward._packed_pre_stage(ops, pose, shape))
    w = params.lbs_weights.contiguous()
    v_posed = torch.randn(16, params.n_verts, 3, device=dev)

    def step():
        return (fused_forward.forward_verts_fused_full(params, pose, shape),
                core.forward_hands_pallas_fused_full(
                    stacked, torch.stack([pose, pose]),
                    torch.stack([shape, shape])),
                fused_forward.blend_skin_fused(ops, coef, rot, t),
                fused_skin.skin_batched(w, rot, t, v_posed))

    names = ((fused_forward, "launches"), (fused_forward, "hands_launches"),
             (fused_forward, "blend_skin_launches"), (fused_skin, "launches"))
    # K1 and K5 at B = 16 both take the 8-row tile, each counted there.
    tile = (fused_forward, "tile_rows_8")
    with torch.no_grad():
        eager = step()
        torch.cuda.synchronize()
        before = [getattr(m, n) for m, n in names + (tile,)]
        graph = torch.cuda.CUDAGraph()
        with captured_launches() as log, torch.cuda.graph(graph):
            outs = step()
        assert [getattr(m, n) for m, n in names + (tile,)] == before
        assert sorted(log, key=str) == sorted(names + (tile, tile), key=str)
        for k in (1, 2):
            graph.replay()
            add_launches(log)
            assert [getattr(m, n) for m, n in names + (tile,)] == [
                c + k for c in before[:-1]] + [before[-1] + 2 * k]
        torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert _err(got, want) == 0.0
