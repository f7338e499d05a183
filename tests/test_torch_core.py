"""The port's MANO forward core against the JAX core and the f64 oracle.

Full MANO width (V=778, J=16, S=10) on the synthetic asset, small batch.
Tolerances:

* port vs JAX, both f32: <= 1e-5 (JAX's HIGH policy is f32 on the CPU;
  the two differ only in summation order);
* port vs the float64 oracle: <= 1e-4, the repo's vertex gate
  (``BASELINE.json``);
* pose-only and gathered paths vs the full forward over the same
  subject: <= 1e-5 (the same arithmetic regrouped).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.models import oracle as joracle
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS as FIELDS
from mano_hand_tpu_torch.models import core, oracle

TOL = 1e-5
ORACLE_TOL = 1e-4


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def assets():
    """(JAX f32 params, port f32 params, port f64 params) on the CPU."""
    jp = jax_synthetic(seed=0).astype(np.float32)
    tp64 = synthetic_params(seed=0, device="cpu")
    return jp, tp64.astype(torch.float32), tp64


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(b, 10)).astype(np.float32)
    return pose, beta


@pytest.mark.parametrize("fused", [True, False])
def test_forward_batched_matches_jax_and_oracle(assets, fused):
    jp, tp, tp64 = assets
    pose, beta = _inputs(4)
    want = jcore.forward_batched(jp, jnp.asarray(pose), jnp.asarray(beta),
                                 fused=fused)
    got = core.forward_batched(tp, torch.from_numpy(pose),
                               torch.from_numpy(beta), fused=fused)
    for name in ("verts", "joints", "rest_verts", "rot_mats",
                 "posed_joints"):
        assert _err(getattr(got, name), getattr(want, name)) <= TOL, name
    ref = oracle.forward_batch_verts(tp64, pose, beta)
    assert _err(got.verts, ref) <= ORACLE_TOL


def test_forward_batched_takes_flat_pose(assets):
    _, tp, _ = assets
    pose, beta = _inputs(3, seed=1)
    a = core.forward_batched(tp, torch.from_numpy(pose),
                             torch.from_numpy(beta)).verts
    b = core.forward_batched(tp, torch.from_numpy(pose.reshape(3, 48)),
                             torch.from_numpy(beta)).verts
    assert torch.equal(a, b)


def test_single_forward_matches_jax_and_oracle(assets):
    jp, tp, tp64 = assets
    pose, beta = _inputs(1, seed=2)
    want = jcore.forward(jp, jnp.asarray(pose[0]), jnp.asarray(beta[0]))
    for fwd in (core.forward, core.forward_fused):
        got = fwd(tp, torch.from_numpy(pose[0]), torch.from_numpy(beta[0]))
        assert got.verts.shape == (778, 3)
        assert _err(got.verts, want.verts) <= TOL
        assert _err(got.posed_joints, want.posed_joints) <= TOL
    ref = oracle.forward(tp64, pose[0], beta[0])
    assert _err(core.forward(tp64, torch.from_numpy(pose[0]).double(),
                             torch.from_numpy(beta[0]).double()).verts,
                ref.verts) <= 1e-12
    # Defaults: zero pose and shape give the template's skinning at rest.
    rest = core.forward(tp)
    assert _err(rest.verts, oracle.forward(tp64).verts) <= ORACLE_TOL


def test_port_oracle_equals_jax_oracle(assets):
    jp64 = jax_synthetic(seed=0)
    _, _, tp64 = assets
    pose, beta = _inputs(1, seed=3)
    want = joracle.forward(jp64, pose[0], beta[0])
    got = oracle.forward(tp64, pose[0], beta[0])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)


def test_forward_posed_equals_full_forward(assets):
    _, tp, _ = assets
    pose, beta = _inputs(3, seed=4)
    shaped = core.specialize(tp, torch.from_numpy(beta[0]))
    for r in range(3):
        full = core.forward(tp, torch.from_numpy(pose[r]),
                            torch.from_numpy(beta[0]))
        posed = core.forward_posed(shaped, torch.from_numpy(pose[r]))
        assert _err(posed.verts, full.verts) <= TOL
        assert _err(posed.posed_joints, full.posed_joints) <= TOL
    batched = core.forward_posed_batched(shaped, torch.from_numpy(pose))
    direct = core.forward_batched(
        tp, torch.from_numpy(pose),
        torch.from_numpy(np.repeat(beta[:1], 3, 0))).verts
    assert _err(batched.verts, direct) <= TOL


def _tables(jp, tp, beta):
    jtab = jcore.stack_shaped([jcore.specialize(jp, jnp.asarray(b))
                               for b in beta])
    ttab = core.stack_shaped([core.specialize(tp, torch.from_numpy(b))
                              for b in beta])
    return jtab, ttab


def test_forward_posed_gather_matches_rows_and_jax(assets):
    jp, tp, _ = assets
    pose, beta = _inputs(6, seed=5)
    jtab, ttab = _tables(jp, tp, beta[:3])
    idx = np.array([2, 0, 1, 1, 2, 0], np.int32)
    got = core.forward_posed_gather(ttab, torch.from_numpy(idx),
                                    torch.from_numpy(pose))
    want = jcore.forward_posed_gather(jtab, jnp.asarray(idx),
                                      jnp.asarray(pose))
    assert _err(got.verts, want.verts) <= TOL
    assert _err(got.posed_joints, want.posed_joints) <= TOL
    for r, s in enumerate(idx):
        row = core.forward_posed(core.table_row(ttab, int(s)),
                                 torch.from_numpy(pose[r]))
        assert _err(got.verts[r], row.verts) <= TOL


def test_forward_posed_gather_clamps_out_of_range(assets):
    """Indices map to rows as JAX's gather maps them: a negative index i
    selects row i + C, then every index is clamped to [0, C - 1] (so
    -C - 3 and -C give row 0, C and C + 7 row C - 1)."""
    jp, tp, _ = assets
    c = 3
    wild = np.array([-c - 3, -c, -3, -1, 0, c - 1, c, c + 7], np.int32)
    pose, beta = _inputs(len(wild), seed=6)
    jtab, ttab = _tables(jp, tp, beta[:c])
    got = core.forward_posed_gather(ttab, torch.from_numpy(wild),
                                    torch.from_numpy(pose)).verts
    want = jcore.forward_posed_gather(jtab, jnp.asarray(wild),
                                      jnp.asarray(pose)).verts
    assert _err(got, want) <= TOL
    rows = np.array([0, 0, 0, 2, 0, 2, 2, 2], np.int32)
    direct = core.forward_posed_gather(ttab, torch.from_numpy(rows),
                                       torch.from_numpy(pose)).verts
    assert torch.equal(got, direct)


def test_subject_table_ops_are_functional(assets):
    _, tp, _ = assets
    _, beta = _inputs(3, seed=7)
    shaped = [core.specialize(tp, torch.from_numpy(b)) for b in beta]
    table = core.subject_table(tp, 2)
    assert table.capacity == 2 and float(table.v_shaped.abs().max()) == 0.0
    t1 = core.table_set_row(table, 1, shaped[0])
    assert float(table.v_shaped.abs().max()) == 0.0      # input untouched
    assert torch.equal(t1.v_shaped[1], shaped[0].v_shaped)
    t2 = core.table_grow(t1, 4)
    assert t2.capacity == 4 and torch.equal(t2.v_shaped[:2], t1.v_shaped)
    assert core.table_grow(t2, 4) is t2
    with pytest.raises(ValueError, match="shrink"):
        core.table_grow(t2, 3)
    back = core.table_row(t2, 1)
    assert torch.equal(back.joints, shaped[0].joints)
    assert torch.equal(back.shape, shaped[0].shape)
    assert back.pose_basis is tp.pose_basis               # shared, not copied
    stacked = core.stack_shaped(shaped)
    assert stacked.capacity == 3
    with pytest.raises(ValueError):
        core.subject_table(tp, 0)
    with pytest.raises(ValueError):
        core.stack_shaped([])


def test_parameter_sgd_steps_through_forward_batched(assets):
    """Training the five parameter tensors through the default (fused)
    ``forward_batched``: every step runs (the fused bases are never
    cached with autograd history, so a second backward does not reach a
    freed graph) and every step's vertices equal the unfused path's on
    the parameters as they are then (no stale cached bases); <= 1e-5."""
    _, tp, _ = assets
    leaves = {f: getattr(tp, f).clone().requires_grad_(True) for f in FIELDS}
    prm = dataclasses.replace(tp, **leaves)
    pose, beta = _inputs(4, seed=8)
    pose, beta = torch.from_numpy(pose), torch.from_numpy(beta)
    target = torch.from_numpy(_inputs(4, seed=9)[0])
    target = core.forward_batched(tp, target, beta).verts
    opt = torch.optim.SGD(list(leaves.values()), lr=1e-3)
    first = leaves["v_template"].detach().clone()
    for _ in range(3):
        verts = core.forward_batched(prm, pose, beta).verts
        with torch.no_grad():
            unfused = core.forward_batched(prm, pose, beta,
                                           fused=False).verts
        assert _err(verts.detach(), unfused) <= TOL
        opt.zero_grad()
        ((verts - target) ** 2).sum().backward()
        opt.step()
    assert float((leaves["v_template"].detach() - first).abs().max()) > 0
    # Under no_grad the same (updated) params take the cached bases.
    with torch.no_grad():
        cached = core.forward_batched(prm, pose, beta).verts
        again = core.forward_batched(prm, pose, beta).verts
        unfused = core.forward_batched(prm, pose, beta, fused=False).verts
        assert core.fused_blend_bases(prm)[0].grad_fn is None
    assert torch.equal(cached, again) and _err(cached, unfused) <= TOL


def test_fused_bases_cache_follows_in_place_updates(assets):
    _, tp, _ = assets
    prm = dataclasses.replace(
        tp, **{f: getattr(tp, f).clone() for f in FIELDS})
    first = core.fused_blend_bases(prm)
    assert core.fused_blend_bases(prm)[0] is first[0]
    with torch.no_grad():
        prm.shape_basis.mul_(1.5)
    again = core.fused_blend_bases(prm)
    assert again[0] is not first[0]
    assert torch.allclose(again[0][:, :10], 1.5 * first[0][:, :10])
