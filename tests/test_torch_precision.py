"""The bf16 serving tier and the f32 pin on the CPU, against the JAX
package.

``compute_dtype=torch.bfloat16`` rounds the pose blend's and the
skinning's contraction operands to bf16 and accumulates in f32. It is
held against JAX's XLA family (``core.forward_posed_gather(compute_dtype=
jnp.bfloat16)``), never against JAX's interpret-mode K2 in bf16: the
Pallas interpreter runs that kernel's dots in f32.

Tolerances: port bf16 vs JAX XLA bf16 <= 1e-5 (the roundings happen at
the same points; what remains is f32 summation order, unless an input
sits within that order's reach of a bf16 rounding boundary — the seeded
inputs of the fixed-seed tests here do not; the index test runs 16 pose
seeds, some of which do, and holds the envelope and the median); K2-bf16's plain version vs the port's XLA-form bf16
<= 1e-6 (the same arithmetic); bf16 vs f32 above 1e-6 (the tier is
really running) and within the 2e-3 m envelope; the engine's tier-1
results vs direct f32 calls <= 1e-6 (batch-size rounding only).
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.serving import precision as jprecision
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import common, fused_posed
from mano_hand_tpu_torch.serving import PrecisionPolicy, ServingEngine
from mano_hand_tpu_torch.serving import precision

BF16 = torch.bfloat16
ENVELOPE = precision.DEFAULT_ENVELOPE_M


def _err(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.fixture(scope="module")
def assets():
    jp = jax_synthetic(seed=0).astype(np.float32)
    tp = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    return jp, tp


@pytest.fixture(scope="module")
def tables(assets):
    jp, tp = assets
    betas = np.random.default_rng(21).normal(size=(4, 10)).astype(np.float32)
    jtab = jcore.stack_shaped([jcore.specialize(jp, jnp.asarray(b))
                               for b in betas])
    ttab = core.stack_shaped([core.specialize(tp, torch.from_numpy(b))
                              for b in betas])
    return jtab, ttab, betas


def _pose_idx(b, seed):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(b, 16, 3)).astype(np.float32)
    return pose, rng.integers(0, 4, size=b).astype(np.int32)


def test_policy_validation_and_defaults_match_jax():
    for pol in (PrecisionPolicy(), jprecision.PrecisionPolicy()):
        assert pol.dtype_for_tier(0) == "bf16"
        assert pol.dtype_for_tier(1) == "f32"
        assert pol.dtype_for_tier(7) == "f32"
        assert pol.tiers_snapshot() == {"0": "bf16", "1": "f32"}
        assert pol.tiers_snapshot((0, 1, 3)) == {
            "0": "bf16", "1": "f32", "3": "f32"}
    assert precision.DEFAULT_ENVELOPE_M == jprecision.DEFAULT_ENVELOPE_M
    assert (precision.F32, precision.BF16) == (jprecision.F32,
                                               jprecision.BF16)
    assert PrecisionPolicy().max_vertex_err_m == 2e-3
    assert PrecisionPolicy(bf16_tiers=[1, 2]).bf16_tiers == frozenset({1, 2})
    for kw in ({"bf16_tiers": frozenset({-1})}, {"accumulate": "bf16"},
               {"max_vertex_err_m": 0.0}):
        with pytest.raises(ValueError):
            PrecisionPolicy(**kw)
        with pytest.raises(ValueError):
            jprecision.PrecisionPolicy(**kw)


def test_compute_dtype_refuses_f16_and_f64(assets, tables):
    _, tp = assets
    _, ttab, _ = tables
    pose, idx = _pose_idx(2, 0)
    pose_t, idx_t = torch.from_numpy(pose), torch.from_numpy(idx)
    shaped = core.specialize(tp)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="compute_dtype"):
            core.forward_posed_gather(ttab, idx_t, pose_t, compute_dtype=bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            core.forward_posed_gather_fused(ttab, idx_t, pose_t,
                                            compute_dtype=bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            core.forward_posed(shaped, pose_t[0], compute_dtype=bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            core.forward_posed_batched(shaped, pose_t, compute_dtype=bad)


@pytest.mark.parametrize("b,seed", [(6, 1), (16, 2)])
def test_bf16_gather_matches_jax_xla_bf16(tables, b, seed):
    jtab, ttab, _ = tables
    pose, idx = _pose_idx(b, seed)
    want = jcore.forward_posed_gather(jtab, jnp.asarray(idx),
                                      jnp.asarray(pose),
                                      compute_dtype=jnp.bfloat16)
    pose_t, idx_t = torch.from_numpy(pose), torch.from_numpy(idx)
    got = core.forward_posed_gather(ttab, idx_t, pose_t, compute_dtype=BF16)
    assert got.verts.dtype == torch.float32
    for name in ("verts", "rest_verts", "posed_joints"):
        assert _err(getattr(got, name), getattr(want, name)) <= 1e-5, name
    plain = core.forward_posed_gather_fused(ttab, idx_t, pose_t,
                                            compute_dtype=BF16)
    assert _err(plain, want.verts) <= 1e-5
    assert _err(plain, got.verts) <= 1e-6
    f32 = core.forward_posed_gather(ttab, idx_t, pose_t).verts
    assert 1e-6 < _err(got.verts, f32) <= ENVELOPE
    assert fused_posed.bf16_launches == 0 and fused_posed.launches == 0


def test_bf16_posed_forms_agree(assets, tables):
    """``forward_posed`` / ``_batched`` under bf16 equal the gathered
    bf16 row for that subject, and JAX's ``forward_posed``."""
    jp, tp = assets
    _, ttab, betas = tables
    pose, _ = _pose_idx(5, 3)
    shaped = core.specialize(tp, torch.from_numpy(betas[2]))
    got = core.forward_posed_batched(shaped, torch.from_numpy(pose),
                                     compute_dtype=BF16).verts
    rows = core.forward_posed_gather(
        ttab, torch.full((5,), 2, dtype=torch.int32), torch.from_numpy(pose),
        compute_dtype=BF16).verts
    assert _err(got, rows) <= 1e-6
    one = core.forward_posed(shaped, torch.from_numpy(pose[0]),
                             compute_dtype=BF16).verts
    jshaped = jcore.specialize(jp, jnp.asarray(betas[2]))
    want = jcore.forward_posed(jshaped, jnp.asarray(pose[0]),
                               compute_dtype=jnp.bfloat16).verts
    assert _err(one, want) <= 1e-5


def test_k2_bf16_operands_are_bf16_and_repack(tables):
    """The bf16 pack: the f32 pack's values rounded to bf16, in the bf16
    kernel's layouts (P padded to 144, the weights vertex-major); cached,
    and rebuilt after an in-place update of the pose basis."""
    _, ttab, _ = tables
    ops = fused_posed.posed_operands(ttab, BF16)
    assert ops.basis_tiles.dtype == ops.wt_tiles.dtype == BF16
    assert ops.basis_tiles.shape == (7, 144, 3, 128)
    assert ops.wt_tiles.shape == (7, 128, 16)
    assert ops.basis.shape == (136, 3, 778) and ops.wt.shape == (16, 778)
    assert fused_posed.posed_operands(ttab, BF16) is ops
    ops32 = fused_posed.posed_operands(ttab)
    assert torch.equal(ops.basis.float(), common.round_bf16(ops32.basis))
    assert torch.equal(ops.wt.float(), common.round_bf16(ops32.wt))
    own = dataclasses.replace(ttab, pose_basis=ttab.pose_basis.clone())
    first = fused_posed.posed_operands(own, BF16)
    with torch.no_grad():
        own.pose_basis.mul_(2.0)
    again = fused_posed.posed_operands(own, BF16)
    assert again is not first
    assert torch.equal(again.basis.float(), 2.0 * first.basis.float())


def test_bf16_gather_wraps_negative_indices_like_jax(tables):
    """The bf16 family maps indices as JAX's XLA gather does: a negative
    index i selects row i + C, then all are clamped to [0, C - 1] — in
    the port's gather and in K2-bf16's plain version. The mapping is held
    bit for bit on both sides (each framework's result on the indices
    equals its result on the mapped rows), on the pose seeds 0-15 alike.
    Across the frameworks the rows agree to f32 summation order except
    where an operand sits on a bf16 rounding boundary that the two
    summation orders round apart (1 row in 64 here: seed 9 reads 1.3e-5,
    seed 12 2.0e-4). One such flip moves one skinning entry by one bf16
    ulp, at most 2^-7 of it, so a vertex by about 2^-7 of its distance
    from the joint (at most 1.5e-3 m on assets 0.2 m across): inside the
    tier's envelope, at which every row is held; the median row is held
    at 1e-6."""
    jtab, ttab, _ = tables
    c = ttab.capacity
    idx = np.array([-c - 3, -c, -3, -1, 0, c - 1, c, c + 7], np.int32)
    rows = np.array([0, 0, c - 3, c - 1, 0, c - 1, c - 1, c - 1], np.int32)
    row_errs = []
    for seed in range(16):
        pose, _ = _pose_idx(len(idx), seed)
        want = jcore.forward_posed_gather(jtab, jnp.asarray(idx),
                                          jnp.asarray(pose),
                                          compute_dtype=jnp.bfloat16).verts
        want_rows = jcore.forward_posed_gather(
            jtab, jnp.asarray(rows), jnp.asarray(pose),
            compute_dtype=jnp.bfloat16).verts
        assert np.array_equal(np.asarray(want), np.asarray(want_rows))
        pose_t = torch.from_numpy(pose)
        for fn in (lambda i: core.forward_posed_gather(
                       ttab, i, pose_t, compute_dtype=BF16).verts,
                   lambda i: core.forward_posed_gather_fused(
                       ttab, i, pose_t, compute_dtype=BF16)):
            got = fn(torch.from_numpy(idx))
            assert torch.equal(got, fn(torch.from_numpy(rows)))
            assert _err(got, want) <= ENVELOPE, seed
            row_errs += [_err(got[r], np.asarray(want)[r])
                         for r in range(len(idx))]
    assert float(np.median(row_errs)) <= 1e-6
    assert fused_posed.bf16_launches == 0


def _engine(tp, policy=None, posed_kernel="xla", **kw):
    return ServingEngine(tp, device="cpu", max_bucket=16, max_delay_s=0.05,
                         posed_kernel=posed_kernel, precision_policy=policy,
                         **kw)


def _direct(tp, beta, pose, compute_dtype=None):
    shaped = core.specialize(tp, torch.from_numpy(beta))
    return core.forward_posed_batched(shaped, torch.from_numpy(pose),
                                      compute_dtype=compute_dtype).verts


@pytest.mark.parametrize("posed_kernel", ["xla", "fused"])
def test_engine_tiers_route_by_precision(assets, tables, posed_kernel):
    """Interleaved tier-0 and tier-1 pose-only requests: tier 0 serves the
    bf16 family (nonzero, inside the envelope), tier 1 the f32 family
    (equal to the direct f32 call); no batch mixes the two."""
    _, tp = assets
    _, _, betas = tables
    rng = np.random.default_rng(30)
    eng = _engine(tp, PrecisionPolicy(), posed_kernel)
    poses = [rng.normal(scale=0.5, size=(int(rng.integers(1, 5)), 16, 3))
             .astype(np.float32) for _ in range(8)]
    with eng:
        keys = [eng.specialize(b) for b in betas]
        assert sorted(eng.warmup_posed([4, 16])) == [4, 16]
        futs = [eng.submit(p, subject=keys[i % 4], priority=i % 2)
                for i, p in enumerate(poses)]
        outs = [f.result(timeout=60) for f in futs]
    for i, (p, o) in enumerate(zip(poses, outs)):
        f32 = _direct(tp, betas[i % 4], p)
        if i % 2:
            assert _err(o, f32) <= 1e-6, i
        else:
            assert 1e-6 < _err(o, f32) <= ENVELOPE, i
            assert _err(o, _direct(tp, betas[i % 4], p, BF16)) <= 1e-6, i
    snap = eng.counters.snapshot()
    assert snap["requests_dispatched"] == 8
    assert 1 <= snap["dispatches_bf16"] < snap["dispatches"]
    assert eng.precision_policy == PrecisionPolicy()


def test_engine_never_mixes_families_in_one_batch(assets, tables):
    _, tp = assets
    eng = _engine(tp, PrecisionPolicy())
    from mano_hand_tpu_torch.serving.engine import _Request

    pose = np.zeros((1, 16, 3), np.float32)
    t0 = _Request(pose, None, 1, False, "a", tier=0)
    t1 = _Request(pose, None, 1, False, "a", tier=1)
    full = _Request(pose, np.zeros((1, 10), np.float32), 1, False, None,
                    tier=0)
    assert eng._req_prec(t0) == "bf16" and eng._req_prec(t1) == "f32"
    assert eng._req_prec(full) == "f32"       # full requests stay f32
    assert eng._admit(t1, True, {"a"}, 1, "bf16") == "precision"
    assert eng._admit(t0, True, {"a"}, 1, "f32") == "precision"
    assert eng._admit(t0, True, {"a"}, 1, "bf16") is None
    plain = _engine(tp)
    assert plain._req_prec(t0) == "f32"
    assert plain._admit(t1, True, {"a"}, 1, "f32") is None


def test_policy_less_engine_is_unchanged(assets, tables):
    _, tp = assets
    _, _, betas = tables
    rng = np.random.default_rng(31)
    poses = [rng.normal(scale=0.5, size=(3, 16, 3)).astype(np.float32)
             for _ in range(4)]
    eng = _engine(tp)
    with eng:
        key = eng.specialize(betas[1])
        outs = [eng.forward(p, subject=key, priority=i % 2)
                for i, p in enumerate(poses)]
    for p, o in zip(poses, outs):
        assert _err(o, _direct(tp, betas[1], p)) <= 1e-6
    assert eng.counters.dispatches_bf16 == 0
    assert eng.precision_policy is None
    with pytest.raises(TypeError, match="PrecisionPolicy"):
        _engine(tp, "bf16")
    with pytest.raises(ValueError, match="priority"):
        eng.submit(poses[0], subject=key, priority=-1)


def test_ieee_guard_pins_and_restores_the_callers_setting():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with common.ieee_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
            with common.ieee_fp32():                 # reentrant
                assert torch.get_float32_matmul_precision() == "highest"
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        # Two threads in overlapping guards: IEEE until the last one out.
        inside, release = threading.Event(), threading.Event()

        def hold():
            with common.ieee_fp32():
                inside.set()
                release.wait(10)

        t = threading.Thread(target=hold)
        t.start()
        inside.wait(10)
        with common.ieee_fp32():
            pass
        assert torch.get_float32_matmul_precision() == "highest"
        release.set()
        t.join(10)
        assert torch.get_float32_matmul_precision() == "high"
        # A caller that changes the setting inside keeps theirs.
        with common.ieee_fp32():
            torch.set_float32_matmul_precision("medium")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


# Every contraction equation the port runs through ``common.einsum``.
EINSUM_EQUATIONS = (
    "bk,bvc->kcv", "bk,kcv->bvc", "bva,bja->vj", "bvac,bjac->vj",
    "bvc,kcv->bk", "jab,jb->ja", "jcs,...s->...jc", "jcs,bs->bjc",
    "jv,...vc->...jc", "jv,vc->jc", "jv,vcs->jcs", "rk,...k->...r",
    "vab,vb->va", "vcp,...p->...vc", "vcs,...s->...vc", "vj,...jc->...vc",
    "vj,...jr->...vr", "vj,bva->bja", "vj,bvac->bjac", "vj,jab->vab",
)


@pytest.mark.parametrize("equation", EINSUM_EQUATIONS)
def test_einsum_gradients_are_torch_einsums_bit_for_bit(equation):
    """The pinned ``einsum`` changes only the matmul setting its backward
    runs under: on the CPU its gradients are ``torch.einsum``'s, bit for
    bit, for every equation the port uses (``...`` as one batch axis)."""
    sizes = dict(zip("abcjkprsv", (3, 2, 3, 5, 7, 4, 6, 9, 11)))
    rng = np.random.default_rng(len(equation))
    lhs = equation.split("->")[0].split(",")
    arrays = [rng.normal(size=[2 if ch == "." else sizes[ch] for ch in
                               term.replace("...", ".")]).astype(np.float32)
              for term in lhs]

    def grads(fn):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = fn(equation, *xs)
        out.backward(torch.from_numpy(rng_out.normal(size=out.shape).astype(
            np.float32)))
        return out.detach(), [x.grad for x in xs]

    rng_out = np.random.default_rng(1)
    want_out, want = grads(torch.einsum)
    rng_out = np.random.default_rng(1)
    got_out, got = grads(common.einsum)
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
