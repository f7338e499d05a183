"""Gradients through the port's kernel routes, against ``jax.grad`` of the
JAX package's routes, on the CPU.

The JAX kernels run as the JAX package's own tests run them
(``tests/test_pallas_lbs.py``, ``tests/test_pallas_forward.py``): in the
Pallas interpreter, at ``Precision.HIGHEST``, under ``jax.jit``. The
port's routes run their kernels' plain versions on CPU tensors, inside
the port's own autograd Functions, so these tests hold the hand-written
backward (``ops/fused_skin.py``, ``ops/fused_forward.py``), not torch's
autograd of a plain forward. Full MANO width (the synthetic asset), B = 3.

Tolerances:

* gradients: the JAX tests' relative bar,
  ``max|a - b| / max(1, max|b|) < 1e-4`` (gradients scale with the vertex
  count);
* forward values: port vs JAX <= 1e-5 (f32 on both sides, summation order
  only), port vs the float64 oracle <= 1e-4 (the repo's vertex gate).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.ops import pallas_forward, pallas_lbs
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS as FIELDS
from mano_hand_tpu_torch.models import core, oracle
from mano_hand_tpu_torch.ops import fused_forward, fused_skin

TOL = 1e-5
ORACLE_TOL = 1e-4
GRAD_REL = 1e-4
HI = jax.lax.Precision.HIGHEST
GRAD_NAMES = ("pose", "shape") + FIELDS

# Each route: (the port's function, the JAX route at HIGHEST in the
# interpreter). "plain" is the unfused reference path on both sides.
ROUTES = {
    "pallas": (
        core.forward_batched_pallas,
        lambda prm, p, s: jcore.forward_batched_pallas(
            prm, p, s, HI, 8, 896, True)),
    "fused": (
        core.forward_batched_pallas_fused,
        lambda prm, p, s: jcore.forward_batched_pallas_fused(
            prm, p, s, HI, 4, True)),
    "fused_full": (
        core.forward_batched_pallas_fused_full,
        lambda prm, p, s: jcore.forward_batched_pallas_fused_full(
            prm, p, s, HI, 4, True)),
    # chunks of 2 over B = 3: the last chunk is short.
    "chunked_fused_full": (
        lambda prm, p, s: core.forward_chunked(
            prm, p, s, chunk_size=2, use_pallas_fused_full=True),
        lambda prm, p, s: jcore.forward_chunked(
            prm, p, s, chunk_size=2, precision=HI, interpret=True,
            use_pallas_fused_full=True)),
    "plain": (
        lambda prm, p, s: core.forward_batched(prm, p, s).verts,
        lambda prm, p, s: jcore.forward_batched(prm, p, s, HI).verts),
}
KERNEL_ROUTES = ("pallas", "fused", "fused_full", "chunked_fused_full")
FUNCTIONS = {"pallas": fused_skin.SkinBatched,
             "fused": fused_forward.FusedVerts,
             "fused_full": fused_forward.FusedVertsFull,
             "chunked_fused_full": fused_forward.FusedVertsFullChunked}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _t(x):
    return torch.from_numpy(np.array(x))     # a writable copy


@pytest.fixture(scope="module")
def assets():
    jp = jax_synthetic(seed=0).astype(np.float32)
    tp64 = synthetic_params(seed=0, device="cpu")
    return jp, tp64.astype(torch.float32), tp64


@pytest.fixture(autouse=True)
def _zero_counts():
    fused_forward.launches = 0
    fused_forward.blend_skin_launches = 0
    fused_skin.launches = 0


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(b, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(b, 10)).astype(np.float32)
    return pose, beta


POSE, BETA = _inputs(3, seed=21)
TARGET_POSE, TARGET_BETA = _inputs(3, seed=22)


def _port_grads(tp, route, pose, beta, target):
    """(grads by name, verts) of sum((verts - target)^2) through ``route``."""
    leaves = {f: getattr(tp, f).clone().requires_grad_(True) for f in FIELDS}
    prm = dataclasses.replace(tp, **leaves)
    p = _t(pose).requires_grad_(True)
    s = _t(beta).requires_grad_(True)
    out = ROUTES[route][0](prm, p, s)
    ((out - _t(target)) ** 2).sum().backward()
    grads = {"pose": p.grad, "shape": s.grad,
             **{f: leaves[f].grad for f in FIELDS}}
    return grads, out


@pytest.fixture(scope="module")
def grad_pairs(assets):
    """Per route, lazily: (the port's grads, jax.grad of the JAX route)."""
    jp, tp, _ = assets
    target = np.asarray(jcore.forward_batched(
        jp, jnp.asarray(TARGET_POSE), jnp.asarray(TARGET_BETA)).verts)

    @functools.lru_cache(maxsize=None)
    def pair(route):
        jfn = ROUTES[route][1]

        def loss(prm, p, s):
            return ((jfn(prm, p, s) - target) ** 2).sum()

        # allow_int: the faces leaf is integer-valued (float0 tangents).
        grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2), allow_int=True))
        gp, gpose, gshape = grad(jp, jnp.asarray(POSE), jnp.asarray(BETA))
        want = {"pose": gpose, "shape": gshape,
                **{f: getattr(gp, f) for f in FIELDS}}
        got, _ = _port_grads(tp, route, POSE, BETA, target)
        return got, want

    return pair


@pytest.mark.parametrize("name", GRAD_NAMES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_grads_match_jax(grad_pairs, route, name):
    """Pose, shape and each of the five parameter fields, against
    ``jax.grad`` of the same route (``test_param_grads_match_xla``'s
    setup); relative bar 1e-4, and the reference is not trivially 0."""
    got, want = grad_pairs(route)
    assert got[name] is not None, name
    assert tuple(got[name].shape) == tuple(np.shape(want[name]))
    assert _rel(got[name], want[name]) < GRAD_REL, name
    assert np.abs(np.asarray(want[name])).max() > 0, name
    assert (fused_forward.launches, fused_forward.blend_skin_launches,
            fused_skin.launches) == (0, 0, 0)     # CPU tensors: no kernel


@pytest.mark.parametrize("route", KERNEL_ROUTES)
def test_route_output_comes_from_the_ports_function(assets, route):
    """The route's output is made by the port's autograd Function (its
    hand-written backward), not by an autograd chain of the plain
    version; the kernel counts stay 0 on the CPU."""
    _, tp, _ = assets
    pose = _t(POSE).requires_grad_(True)
    out = ROUTES[route][0](tp, pose, _t(BETA))
    assert out.grad_fn._forward_cls is FUNCTIONS[route]
    assert out.dtype == torch.float32 and out.shape == (3, 778, 3)
    out.sum().backward()
    assert (fused_forward.launches, fused_forward.blend_skin_launches,
            fused_skin.launches) == (0, 0, 0)


@pytest.mark.parametrize("route", KERNEL_ROUTES)
def test_route_grads_finite_at_zero_pose(assets, route):
    """theta = 0 is the fitting init: the Taylor-guarded Rodrigues keeps
    the hand-written backward finite there, as it does in JAX."""
    _, tp, _ = assets
    zeros = np.zeros((2, 16, 3), np.float32)
    got, _ = _port_grads(tp, route, zeros, np.zeros((2, 10), np.float32),
                         np.zeros((2, 778, 3), np.float32))
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()), name
    assert float(got["pose"].abs().max()) > 0


def _skin_inputs(seed, b, v=778, j=16):
    # tests/test_pallas_lbs.py:rand_skin_inputs
    rng = np.random.default_rng(seed)
    weights = rng.random((v, j)).astype(np.float32)
    weights /= weights.sum(axis=1, keepdims=True)
    rot = rng.normal(size=(b, j, 3, 3)).astype(np.float32)
    t = rng.normal(size=(b, j, 3)).astype(np.float32)
    vp = rng.normal(scale=0.1, size=(b, v, 3)).astype(np.float32)
    return weights, rot, t, vp


def test_k3_matches_jax_interpret_kernel():
    args = _skin_inputs(0, b=5)    # block_b=4 leaves a ragged second tile
    want = pallas_lbs.skin_batched(*map(jnp.asarray, args), block_b=4,
                                   interpret=True, precision=HI)
    got = fused_skin.skin_batched(*map(_t, args))
    assert got.shape == (5, 778, 3)
    assert _err(got, want) <= TOL
    assert fused_skin.launches == 0


@pytest.fixture(scope="module")
def k3_grad_pair():
    args = _skin_inputs(11, b=3)

    def loss(*a):
        return (pallas_lbs.skin_batched_ad(*a, 32, 128, True, HI) ** 2).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    (fused_skin.skin_batched_ad(*leaves) ** 2).sum().backward()
    return [x.grad for x in leaves], want


@pytest.mark.parametrize("i,name", enumerate(("weights", "rot", "t",
                                              "v_posed")))
def test_k3_ad_grads_match_jax(k3_grad_pair, i, name):
    """``skin_batched_ad`` in each of its four arguments against
    ``jax.grad`` of ``pallas_lbs.skin_batched_ad``; relative bar 1e-4."""
    got, want = k3_grad_pair
    assert _rel(got[i], want[i]) < GRAD_REL, name
    assert np.abs(np.asarray(want[i])).max() > 0, name


def test_k4_matches_jax_interpret_kernel_and_oracle(assets):
    jp, tp, tp64 = assets
    pose, beta = _inputs(5, seed=23)
    want = pallas_forward.forward_verts_fused(
        jp, jnp.asarray(pose), jnp.asarray(beta), HI, 4, True)
    got = fused_forward.forward_verts_fused(tp, _t(pose), _t(beta))
    assert got.shape == (5, 778, 3) and got.dtype == torch.float32
    assert _err(got, want) <= TOL
    assert _err(got, oracle.forward_batch_verts(tp64, pose, beta)) \
        <= ORACLE_TOL
    assert fused_forward.blend_skin_launches == 0


CHUNK_FLAGS = {
    "default": {},
    "pallas": {"use_pallas": True},
    "fused": {"use_pallas_fused": True},
    "fused_full": {"use_pallas_fused_full": True},
}


@pytest.mark.parametrize("route", list(CHUNK_FLAGS))
def test_forward_chunked_matches_jax(assets, route):
    """B = 37 in chunks of 16 (a ragged trailing chunk), each route and
    the default, against JAX ``core.forward_chunked`` on the same route
    (its kernels in the interpreter); <= 1e-5."""
    jp, tp, _ = assets
    pose, beta = _inputs(37, seed=24)
    flags = CHUNK_FLAGS[route]
    want = jax.jit(lambda p, s: jcore.forward_chunked(
        jp, p, s, chunk_size=16, precision=HI, block_b=8, interpret=True,
        **flags))(jnp.asarray(pose), jnp.asarray(beta))
    got = core.forward_chunked(tp, _t(pose), _t(beta), chunk_size=16,
                               **flags)
    assert got.shape == (37, 778, 3)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("route", list(CHUNK_FLAGS))
def test_forward_chunked_empty_batch_and_grads(assets, route):
    _, tp, _ = assets
    flags = CHUNK_FLAGS[route]
    empty = core.forward_chunked(tp, torch.zeros(0, 16, 3),
                                 torch.zeros(0, 10), **flags)
    assert empty.shape == (0, 778, 3)
    # Chunked gradients equal the unchunked route's (plain autograd glue).
    pose = _t(POSE).requires_grad_(True)
    core.forward_chunked(tp, pose, _t(BETA), chunk_size=2,
                         **flags).square().sum().backward()
    whole = _t(POSE).requires_grad_(True)
    core.forward_batched(tp, whole, _t(BETA)).verts.square().sum().backward()
    assert _rel(pose.grad, whole.grad) < GRAD_REL


def _k1_chunks_concatenated(prm, pose, shape, chunk_size):
    """The K1 route of ``forward_chunked`` built as separate chunks: each
    through ``FusedVertsFull`` (the last zero-padded to a whole chunk),
    concatenated, the padding sliced off."""
    b = pose.shape[0]
    if b == 0:
        return core.forward_batched_pallas_fused_full(prm, pose, shape)
    pose_c, shape_c, _ = core._pad_and_chunk(pose, shape, chunk_size)
    return torch.cat([core.forward_batched_pallas_fused_full(prm, p, s)
                      for p, s in zip(pose_c, shape_c)])[:b]


@pytest.mark.parametrize("b", [0, 1, 19, 20, 41, 60])
def test_forward_chunked_k1_writes_chunks_in_place(assets, b):
    """``forward_chunked``'s K1 route, chunks of 20 written into one
    output, against the same chunks concatenated: vertices bit for bit on
    whole chunks and within 1e-6 m on a short last one (its launch has
    fewer rows); the gradients of ``(out * w).sum()`` in pose, shape and
    the five parameter tensors to a relative 1e-5 of their largest
    entry; one count of ``chunks_in_place`` a chunk."""
    _, tp, _ = assets
    chunk = 20
    pose, beta = _inputs(b, seed=25)
    w = _t(np.random.default_rng(26).normal(size=(b, 778, 3))
           .astype(np.float32))

    def run(fn):
        leaves = {f: getattr(tp, f).clone().requires_grad_(True)
                  for f in FIELDS}
        prm = dataclasses.replace(tp, **leaves)
        p = _t(pose).requires_grad_(True)
        s = _t(beta).requires_grad_(True)
        out = fn(prm, p, s, chunk)
        (out * w).sum().backward()
        return out.detach(), [p.grad, s.grad] + [leaves[f].grad
                                                 for f in FIELDS]

    fused_forward.chunks_in_place = 0
    got, got_grads = run(functools.partial(core.forward_chunked,
                                           use_pallas_fused_full=True))
    assert fused_forward.chunks_in_place == -(-b // chunk)
    want, want_grads = run(_k1_chunks_concatenated)
    assert fused_forward.chunks_in_place == -(-b // chunk)
    assert got.shape == want.shape == (b, 778, 3)
    whole = b // chunk * chunk
    assert torch.equal(got[:whole], want[:whole])
    if whole < b:
        assert _err(got[whole:], want[whole:]) <= 1e-6
    for name, g, h in zip(GRAD_NAMES, got_grads, want_grads):
        g, h = g.double().numpy(), h.double().numpy()
        assert g.shape == h.shape, name
        assert np.abs(g - h).max(initial=0) <= 1e-5 * np.abs(h).max(
            initial=0), name
