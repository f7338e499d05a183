"""The port's examples against the JAX functions, part 2: 11's network
started from carried weights (its first loss, its gradients and the first
``OptaxAdam`` update against JAX's ``PoseNet`` under ``optax.adam``, 1e-5
relative) and
19's body family (the forward against JAX's and the float64 oracle,
1e-5; the LM-recovered vertices within 1e-4 of the target on both
sides)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mano_hand_tpu.assets import load_model as j_load_model
from mano_hand_tpu.fitting import fit_lm as j_fit_lm
from mano_hand_tpu.interop.flax_bridge import ManoLayer
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.models import oracle as j_oracle
from mano_hand_tpu_torch.assets import load_model, params_from_numpy
from mano_hand_tpu_torch.fitting import fit_lm
from mano_hand_tpu_torch.fitting.solvers import OptaxAdam
from mano_hand_tpu_torch.models import core
from torch_examples_run import load_example, run_example, torch_threads

REL = 1e-5
BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_posenet(params):
    """The JAX example's ``PoseNet`` (``examples/11``), verbatim."""

    class PoseNet(nn.Module):
        @nn.compact
        def __call__(self, kp):
            x = kp.reshape(kp.shape[0], -1)
            for width in (128, 128):
                x = nn.relu(nn.Dense(width)(x))
            pose6d = nn.Dense(16 * 6)(x).reshape(-1, 16, 6)
            pose6d = pose6d + jnp.asarray(
                [1.0, 0, 0, 0, 1.0, 0], jnp.float32
            )
            shape = nn.Dense(params.shape_basis.shape[-1])(x)
            out = ManoLayer(params, pose_format="6d").forward_full(
                pose6d, shape
            )
            return out, shape

    return PoseNet()


def test_pose_regression_first_loss_and_update_match_optax(params):
    jp = params.astype(np.float32)
    tp = params_from_numpy(jp, device="cpu")
    ex = load_example("11_neural_pose_regression")
    rng = np.random.default_rng(11)
    widths = ((63, 128), (128, 128), (128, 96), (128, 10))
    dense = {f"Dense_{i}": {
        "kernel": (rng.normal(size=w) / np.sqrt(w[0])).astype(np.float32),
        "bias": rng.normal(scale=0.01, size=w[1]).astype(np.float32)}
        for i, w in enumerate(widths)}
    # One batch, the example's sampling with numpy draws, from JAX.
    kp_pose = (rng.normal(size=(BATCH, 16, 3)) * 0.25).astype(np.float32)
    out = jcore.forward_batched(jp, jnp.asarray(kp_pose),
                                jnp.zeros((BATCH, 10), jnp.float32))
    kp_gt = np.asarray(jcore.keypoints(out, "smplx"))
    kp_in = (kp_gt + rng.normal(scale=0.002, size=kp_gt.shape)).astype(
        np.float32)
    verts_gt = np.asarray(out.verts)

    jnet = _jax_posenet(jp)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, dense)}

    def loss_fn(v):
        o, shape = jnet.apply(v, kp_in)
        kp_pred = jcore.keypoints(o, "smplx")
        return (jnp.mean(jnp.sum((o.verts - verts_gt) ** 2, axis=-1))
                + jnp.mean(jnp.sum((kp_pred - kp_gt) ** 2, axis=-1))
                + 1e-4 * jnp.mean(shape ** 2))

    jloss, grads = jax.value_and_grad(loss_fn)(variables)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(variables), variables)

    net = ex.PoseNet(tp)
    ex.load_jax_weights(net, dense)
    tips = core.resolve_tip_ids("smplx", tp.n_verts)
    loss = ex.loss_fn(net, torch.from_numpy(kp_in),
                      torch.from_numpy(verts_gt), torch.from_numpy(kp_gt),
                      tips)
    loss.backward()
    assert _rel(loss.item(), float(jloss)) <= REL
    jgrads = [grads["params"][f"Dense_{i}"] for i in range(4)]
    for i, (lyr, jg) in enumerate(zip(net.layers, jgrads)):
        assert _rel(lyr.weight.grad.numpy().T, jg["kernel"]) <= REL, i
        assert _rel(lyr.bias.grad.numpy(), jg["bias"]) <= REL, i
    # The first update from the same gradients: OptaxAdam against
    # optax.adam, read exactly off parameters set to zero (end to end, each
    # from its own gradients, the elements within a few eps of zero magnify
    # the gradients' ~2e-7 relative difference through g / (|g| + eps):
    # CHANGES.md).
    with torch.no_grad():
        for lyr, jg in zip(net.layers, jgrads):
            lyr.weight.zero_()
            lyr.bias.zero_()
            lyr.weight.grad = torch.from_numpy(
                np.ascontiguousarray(np.asarray(jg["kernel"]).T))
            lyr.bias.grad = torch.from_numpy(np.asarray(jg["bias"]))
    OptaxAdam(net.parameters(), lr=1e-3).step()
    for i, lyr in enumerate(net.layers):
        want = updates["params"][f"Dense_{i}"]
        assert _rel(lyr.weight.detach().numpy().T, want["kernel"]) <= REL, i
        assert _rel(lyr.bias.detach().numpy(), want["bias"]) <= REL, i


def test_body_family_matches_jax_and_the_oracle(tmp_path):
    run_example("19_smpl_body_family", tmp_path)
    pkl = tmp_path / "SMPL_NEUTRAL.pkl"
    jbody64 = j_load_model(str(pkl))
    body64 = load_model(pkl, device="cpu")
    assert (body64.n_verts, body64.n_joints, body64.n_shape) == (437, 24, 16)
    assert body64.side == jbody64.side
    jbody, body = jbody64.astype(np.float32), body64.astype(torch.float32)
    rng = np.random.default_rng(0)
    pose = rng.normal(scale=0.25, size=(4, 24, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(4, 16)).astype(np.float32)
    got = core.forward_batched(body, torch.from_numpy(pose),
                               torch.from_numpy(beta)).verts.numpy()
    want = np.asarray(jcore.forward_batched(jbody, jnp.asarray(pose),
                                            jnp.asarray(beta)).verts)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ref = np.stack([j_oracle.forward(jbody64, pose=p.astype(np.float64),
                                     shape=s.astype(np.float64)).verts
                    for p, s in zip(pose, beta)])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # LM pose recovery on 24 joints, both sides, the example's settings.
    res = fit_lm(body, torch.from_numpy(got[:1]), n_steps=15)
    fitted = core.forward_batched(body, res.pose, res.shape).verts.numpy()
    assert np.abs(fitted - got[:1]).max() < 1e-4
    jres = j_fit_lm(jbody, jnp.asarray(want[:1]), n_steps=15)
    jfitted = jcore.forward_batched(jbody, jres.pose, jres.shape).verts
    assert float(jnp.abs(jfitted - want[:1]).max()) < 1e-4
