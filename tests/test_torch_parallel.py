"""The port's ``parallel`` package against the JAX package's.

The port side runs in four gloo ranks spawned once for the module
(``tests/torch_parallel_ranks.py``; they import no JAX), on CPU tensors,
where ``pallas_forward_dp``'s kernel wrappers run their plain versions.
The JAX side runs here, on the virtual 8-device CPU mesh of
``tests/conftest.py``, as ``tests/test_parallel.py`` runs it: GSPMD and
shard_map forwards, the Pallas kernels in interpret mode, the sharded
fit step with ``optax.adam``. Both sides take the same numpy-seeded
inputs.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
import torch_sharded_fits as fits
from mano_hand_tpu import fitting as jfitting
from mano_hand_tpu import parallel as jpar
from mano_hand_tpu import viz as jviz
from mano_hand_tpu.assets import synthetic_params as jsyn
from mano_hand_tpu.viz import silhouette as jsil
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu.parallel import sharding as jshd
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.parallel import sharding as shd

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RANK_TIMEOUT_S = 120.0
TOL = 1e-5

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def rand_batch(seed, batch):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(batch, 16, 3)).astype(np.float32)
    beta = rng.normal(size=(batch, 10)).astype(np.float32)
    return pose, beta


INPUTS = {}
for _name, _seed, _batch in (("a", 0, 8), ("b", 2, 8), ("c", 3, 8),
                             ("d", 1, 8), ("e", 4, 8), ("fit", 3, 8)):
    INPUTS[f"pose_{_name}"], INPUTS[f"beta_{_name}"] = rand_batch(
        _seed, _batch)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start the four ranks; kill every one of them at the module's end."""
    d = tmp_path_factory.mktemp("torch_ranks")
    np.savez(d / "inputs.npz", **INPUTS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [open(d / f"log{r}.txt", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
         str(r), str(WORLD), str(d / "store"), str(d / "inputs.npz"),
         str(d)], env=env, cwd=d, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        yield d, procs, time.monotonic() + RANK_TIMEOUT_S
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()


@pytest.fixture(scope="module")
def jparams(params):
    return params.astype(np.float32)


def _jmesh(data, model):
    return jpar.make_mesh(data=data, model=model,
                          devices=jax.devices()[:data * model])


@pytest.fixture(scope="module")
def jax_refs(spawned, jparams):
    """The JAX package's outputs on the same inputs, computed here while
    the ranks run."""
    refs = {}
    for mesh_shape, suffix, a, b, d in (((2, 2), "2x2", "a", "b", "c"),
                                        ((1, 4), "1x4", "d", "d", "e")):
        mesh = _jmesh(*mesh_shape)
        sp = jshd.shard_params(jparams, mesh)
        refs["gspmd_" + suffix] = jshd.gspmd_forward(sp, mesh, n_verts=778)(
            INPUTS[f"pose_{a}"], INPUTS[f"beta_{a}"])
        refs["smap_" + suffix] = jshd.shard_map_forward(
            sp, mesh, n_verts=778)(INPUTS[f"pose_{b}"], INPUTS[f"beta_{b}"])
        prm = sp if mesh_shape[1] == 4 else jparams
        for full in (False, True):
            name = ("dp_full_" if full else "dp_") + suffix
            refs[name] = jshd.pallas_forward_dp(
                prm, mesh, block_b=2, interpret=True, full=full)(
                INPUTS[f"pose_{d}"], INPUTS[f"beta_{d}"])
    mesh = _jmesh(2, 2)
    targets = jcore.forward_batched(jparams, INPUTS["pose_fit"],
                                    INPUTS["beta_fit"]).verts
    targets = jax.device_put(targets, jpar.batch_sharding(mesh))
    opt = optax.adam(0.05)
    step = jpar.make_fit_step(jshd.shard_params(jparams, mesh), mesh, opt,
                              n_verts=778)
    state = jpar.init_state(jparams, batch=8, optimizer=opt)
    losses = []
    for _ in range(50):
        state, loss = step(state, targets)
        losses.append(float(loss))
    refs["fit_2x2"] = losses
    # JAX's two sharded-fit tests, unsharded, on the same inputs.
    small = jsyn(seed=3, n_verts=48, n_faces=64, dtype=np.float32)
    cam = jviz.WeakPerspectiveCamera(rot=jnp.eye(3, dtype=jnp.float32),
                                     scale=3.0)
    masks = (jsil.soft_silhouette(
        jcore.forward(small).verts[None] + fits.mask_inputs(), small.faces,
        cam, height=16, width=16, sigma=1.0) > 0.5).astype(jnp.float32)
    res = jfitting.fit(small, masks, camera=cam, **fits.MASK_KW)
    refs.update(mask_target=masks, mask_loss_history=res.loss_history)
    targets = jcore.forward_batched(
        jparams, jnp.asarray(fits.sequence_poses()),
        jnp.zeros((fits.SEQ_FRAMES, 10), jnp.float32)).verts
    for case, kw in (("seq", fits.SEQ_KW),
                     ("seq6d", dict(fits.SEQ_KW, fit_trans=True,
                                    pose_space="6d"))):
        res = jfitting.fit_sequence(jparams, targets, **kw)
        refs[case + "_loss_history"] = res.loss_history
        refs[case + "_pose"] = res.pose
    return {k: np.asarray(v) for k, v in refs.items()}


@pytest.fixture(scope="module")
def ranks(spawned, jax_refs):
    """Wait for the ranks (all are killed on a timeout or a failure) and
    return (arrays of rank 0, facts of every rank)."""
    d, procs, deadline = spawned
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for r, p in enumerate(procs):
        assert p.returncode == 0, (d / f"log{r}.txt").read_text()[-3000:]
    arrays = dict(np.load(d / "arrays.npz"))
    facts = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return arrays, facts


def test_ranks_import_no_jax(ranks):
    _, facts = ranks
    assert [f["jax_loaded"] for f in facts] == [[]] * WORLD


def test_make_mesh_shapes_and_errors(ranks):
    _, facts = ranks
    for r, f in enumerate(facts):
        assert f["mesh"] == {"data": 2, "model": 2}
        assert f["mesh_all_data"] == [WORLD, 1]
        assert f["mesh_coords"] == [r // 2, r % 2]   # ranks row-major
        assert "divisible" in f["mesh_error_model3"]
        assert f["mesh_error_3x2"] == "mesh 3x2 needs 6 devices, have 4"
    # JAX raises the same.
    with pytest.raises(ValueError, match="divisible"):
        jpar.make_mesh(model=3)


def test_shard_params_layout(ranks):
    _, facts = ranks
    for f in facts:
        assert f["layout"] == {
            "n_verts": 778, "v_template": [778, 3],
            "local_v_template": [389, 3], "local_j_regressor": [16, 389],
            "placements_match": True}
        assert f["layout4"] == {"n_verts": 778, "v_template": [780, 3],
                                "local_v_template": [195, 3]}


def test_pad_verts_inert(jparams):
    """Zero rows pad V to 780 and change nothing, as JAX's."""
    p = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    padded, v = shd.pad_verts(p, 4)
    assert v == 778 and padded.v_template.shape[0] == 780
    out, base = core.forward(padded), core.forward(p)
    torch.testing.assert_close(out.verts[:778], base.verts, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(out.joints, base.joints, atol=1e-6, rtol=0)
    jpadded, _ = jshd.pad_verts(jparams, 4)
    np.testing.assert_allclose(padded.j_regressor.numpy(),
                               np.asarray(jpadded.j_regressor), atol=0)
    assert shd.pad_verts(p, 2) == (p, 778)


@pytest.mark.parametrize("name,mesh_shape", [
    ("gspmd_2x2", (2, 2)), ("gspmd_1x4", (1, 4))])
def test_gspmd_forward_matches_jax(ranks, jax_refs, name, mesh_shape):
    arrays, facts = ranks
    want = jax_refs[name]
    assert arrays[name].shape == want.shape == (8, 778, 3)
    np.testing.assert_allclose(arrays[name], want, atol=TOL, rtol=0)
    # Vertex-sharded where 778 divides the model dim, else over data only.
    expect = (["Shard(dim=0)", "Shard(dim=1)"] if mesh_shape[1] == 2
              else ["Shard(dim=0)", "Replicate()"])
    assert facts[0][name + "_placements"] == expect


@pytest.mark.parametrize("name", ["smap_2x2", "smap_1x4"])
def test_shard_map_forward_matches_jax_with_one_all_reduce(
        ranks, jax_refs, name):
    arrays, facts = ranks
    want = jax_refs[name]
    np.testing.assert_allclose(arrays[name], want, atol=TOL, rtol=0)
    for f in facts:
        # The joints' all-reduce, exactly once a call, and nothing else.
        assert f[name + "_comms"] == {"c10d.allreduce_": 1}
        assert f[name + "_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    # Padded V: three ranks keep 195 rows, the last 193 (778 in all).
    assert [f["smap_1x4_local"] for f in facts] == [
        [8, 195, 3]] * 3 + [[8, 193, 3]]


@pytest.mark.parametrize("name,mesh_shape", [
    ("dp_2x2", (2, 2)), ("dp_full_2x2", (2, 2)),
    ("dp_1x4", (1, 4)), ("dp_full_1x4", (1, 4))])
def test_pallas_forward_dp_matches_jax_interpreted(
        ranks, jax_refs, name, mesh_shape):
    arrays, facts = ranks
    want = jax_refs[name]
    assert arrays[name].shape == want.shape == (8, 778, 3)
    np.testing.assert_allclose(arrays[name], want, atol=TOL, rtol=0)
    assert facts[0][name + "_placements"] == ["Shard(dim=0)",
                                              "Shard(dim=0)"]
    if mesh_shape == (2, 2):
        # Batch over both dims, no collective: 2 rows on each of 4 ranks.
        for f in facts:
            assert f[name + "_comms"] == {}
            assert f[name + "_local_rows"] == 2


def test_sharded_fit_step_matches_jax(ranks, jax_refs):
    arrays, facts = ranks
    want = jax_refs["fit_2x2"]
    got = arrays["fit_2x2"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0] / 50 and np.isfinite(got).all()   # JAX's bar
    # The padded layout's step with its default n_verts runs too.
    assert all(np.isfinite(f["fit_1x4_loss"]) for f in facts)
    assert len({f["fit_1x4_loss"] for f in facts}) == 1


def test_multihost_helpers_in_four_ranks(ranks):
    _, facts = ranks
    for r, f in enumerate(facts):
        assert f["initialize"] is True
        assert f["global_mesh"] == {"data": 2, "model": 2}
        assert f["slice"] == [4 * r, 4 * r + 4]
        assert "not divisible" in f["slice_error"]
        assert "must divide" in f["global_mesh_error_model3"]
        assert "devices" in f["global_mesh_error_3x2"]
        assert f["global_batch_shape"] == [16, 16, 3]
        assert f["global_batch_total"] == pytest.approx(
            f["global_batch_expect"], rel=1e-6)
        assert f["global_batch_forward_err"] <= TOL


# ------------------------------------------- JAX's two sharded fits
#: The leaves each fit returns and which of them are per row (sharded).
FIT_CASES = {"mask": (("pose", "shape", "trans", "loss_history"), "all"),
             "seq": (("pose", "shape", "loss_history", "final_loss"),
                     ("pose",)),
             "seq6d": (("pose", "shape", "trans", "loss_history"),
                       ("pose", "trans"))}


@pytest.mark.parametrize("mesh_shape", ["4x1", "2x2"])
@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_sharded_fit_matches_the_unsharded_fit(ranks, case, mesh_shape):
    """JAX's ``test_mask_fit_batch_shards_over_data_axis`` (the batch of
    mask fits over 'data') and ``test_fit_sequence_frames_shard_over_
    data_axis`` (the clip's frames over 'data', the smoothness crossing
    each shard boundary), at JAX's sizes, seeds and atol=1e-5: the
    gathered sharded result against the unsharded fit, placements as
    JAX's shardings."""
    arrays, facts = ranks
    leaves, per_row = FIT_CASES[case]
    tag = f"fits_{mesh_shape}_{case}_"
    for leaf in leaves:
        got, want = arrays[tag + leaf + "_full"], arrays[tag + leaf + "_local"]
        assert got.shape == want.shape, leaf
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=f"{case} {leaf}")
        sharded = per_row == "all" or leaf in per_row
        for f in facts:
            placements = f[f"fits_{mesh_shape}_placements"][f"{case}_{leaf}"]
            assert placements == (["Shard(dim=0)", "Replicate()"] if sharded
                                  else ["Replicate()", "Replicate()"]), leaf


@pytest.mark.parametrize("mesh_shape", ["4x1", "2x2"])
@pytest.mark.parametrize("fit", ["fit", "fit_sequence"])
def test_sharded_fit_refuses_a_split_other_than_the_chunk_rule(ranks, fit,
                                                               mesh_shape):
    """A target built with ``DTensor.from_local`` split otherwise than by
    DTensor's chunk rule (the first rank one row more, the last one
    less) raises the same ValueError on every rank, none left waiting in
    a collective."""
    _, facts = ranks
    said = [f[f"fits_{mesh_shape}_errors"][fit] for f in facts]
    assert len(set(said)) == 1, said
    assert "chunk rule" in said[0], said


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_unsharded_fit_matches_jax(ranks, jax_refs, case):
    """The port's unsharded fits against JAX's on the same inputs, at the
    port's mask-fit and tracking tolerances: the loss history within 1e-4
    relative; the clip's poses within 1e-3."""
    arrays, _ = ranks
    tag = f"fits_4x1_{case}_"
    if case == "mask":
        np.testing.assert_array_equal(arrays["fits_4x1_mask_target"],
                                      jax_refs["mask_target"])
    got = arrays[tag + "loss_history_local"]
    want = jax_refs[case + "_loss_history"]
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    if case != "mask":
        assert np.abs(arrays[tag + "pose_local"]
                      - jax_refs[case + "_pose"]).max() <= 1e-3
