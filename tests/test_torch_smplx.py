"""SMPL-X on the port's normal path: the official-file loader and
``forward_chunked``, on the CPU at a small size.

The rig has SMPL-X's 55-joint tree, 10 betas and 10 expression
coefficients (S = 20), a 486-wide pose basis and V = 300, with seeded
random weights (``synthetic_arrays``). It is written in SMPL-X's own
layouts, ``.npz`` and chumpy-era ``.pkl``, with 400 shape columns (v1.1:
expression from column 300) and with 20 (v1.0: from column 10); no
asset is downloaded. What loads goes unchanged into
``core.forward_chunked``, held against ``benchmark/reference/smplx.py``
(betas and expression as separate inputs against the file's own
columns) and against the JAX package's plain forward on the same arrays.

Tolerances:

* the default route in float64 vs the float64 reference: 1e-12 m, the
  same equations in another summation order (rounding ~1e-17 m on a
  ~10 cm mesh);
* K1's route (its CPU path, fp32 by construction) vs the float64
  reference: 1e-6 m, fp32 rounding of a 507-term blend and an 11-level
  chain (~1e-7 m here); ten times MANO's card readings (~3e-7 m);
* K1's route vs JAX's plain forward, both fp32 on the CPU: 1e-5 m, the
  repo's kernel-vs-plain bar (summation order only).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import smplx as reference
from mano_hand_tpu import assets as jassets
from mano_hand_tpu.assets.schema import ManoParams as JaxParams
from mano_hand_tpu.models import core as jcore
from mano_hand_tpu_torch import assets
from mano_hand_tpu_torch.assets.synthetic import synthetic_arrays
from mano_hand_tpu_torch.constants import SMPLX_PARENTS
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import fused_forward

V, J, P = 300, 55, 486
BIG = np.uint32(4294967295)   # the root's uint32 sentinel in kintree_table

EXACT = 1e-12
F32_VS_F64 = 1e-6
F32_VS_JAX = 1e-5


@pytest.fixture(scope="module")
def rig():
    """A SMPL-X-shaped asset's arrays, float64, 400 shape columns."""
    a = synthetic_arrays(seed=26, n_verts=V, n_joints=J, n_shape=400,
                         n_faces=500)
    return dict(a, parents=SMPLX_PARENTS)


def official(rig, cols: int, sparse: bool) -> dict:
    """The rig in SMPL-X's own names: ``cols`` shape columns, betas from
    column 0 and expression from 300 (400 columns) or 10 (20)."""
    import scipy.sparse as sp

    dirs = rig["shape_basis"]
    if cols == 20:
        dirs = np.concatenate([dirs[..., :10], dirs[..., 300:310]], axis=-1)
    rng = np.random.default_rng(cols)
    j_reg = rig["j_regressor"]
    return {
        "v_template": rig["v_template"],
        "shapedirs": dirs,
        "posedirs": rig["pose_basis"],
        "J_regressor": sp.csc_matrix(j_reg) if sparse else j_reg,
        "weights": rig["lbs_weights"],
        "kintree_table": np.stack([
            np.asarray([BIG] + list(SMPLX_PARENTS[1:]), np.uint32),
            np.arange(J, dtype=np.uint32)]),
        "f": np.asarray(rig["faces"], np.uint32),
        "hands_componentsl": rng.normal(size=(45, 45)),
        "hands_componentsr": rng.normal(size=(45, 45)),
        "hands_meanl": rng.normal(size=45),
        "hands_meanr": rng.normal(size=45),
        "lmk_faces_idx": np.arange(51, dtype=np.int64),
        "lmk_bary_coords": np.full((51, 3), 1 / 3),
    }


def write(raw: dict, path):
    if path.suffix == ".npz":
        # An object array, as the official file's joint2num: never read.
        np.savez(path, joint2num=np.array({"pelvis": 0}, dtype=object),
                 **raw)
    else:
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
    return path


CASES = [("npz", 400, False), ("npz", 20, False), ("pkl", 400, True),
         ("pkl", 20, False)]


@pytest.mark.parametrize("suffix,cols,sparse", CASES,
                         ids=[f"{s}-{c}-{'sparse' if sp else 'dense'}"
                              for s, c, sp in CASES])
def test_load_model_reads_official_smplx(rig, tmp_path, suffix, cols,
                                         sparse):
    """``load_model`` sniffs either official layout and hands it to
    ``load_smplx``: V, J, S = 10 + 10, P as published, betas then the
    expression columns, the identity hand-pose space, unsided."""
    path = write(official(rig, cols, sparse),
                 tmp_path / f"SMPLX_NEUTRAL.{suffix}")
    got = assets.load_model(path, device="cpu")
    want = assets.load_smplx(path, device="cpu")
    assert (got.n_verts, got.n_joints, got.n_shape,
            got.pose_basis.shape[-1]) == (V, J, 20, P)
    assert got.parents == SMPLX_PARENTS and got.side == "neutral"
    basis = np.concatenate([rig["shape_basis"][..., :10],
                            rig["shape_basis"][..., 300:310]], axis=-1)
    np.testing.assert_array_equal(got.shape_basis.numpy(), basis)
    np.testing.assert_array_equal(got.j_regressor.numpy(), rig["j_regressor"])
    np.testing.assert_array_equal(got.pca_basis.numpy(), np.eye(3 * (J - 1)))
    assert not got.pca_mean.any()
    for f in assets.ARRAY_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_load_smplx_takes_the_counts_the_file_holds(rig, tmp_path):
    """A v1.1 file gives up to 300 betas and 100 expression columns, a
    v1.0 file 10 and 10; a count past them is refused, not clamped."""
    full = write(official(rig, 400, False), tmp_path / "SMPLX_MALE.npz")
    short = write(official(rig, 20, True), tmp_path / "SMPLX_FEMALE.pkl")
    wide = assets.load_smplx(full, num_betas=300, num_expression=100,
                             device="cpu")
    np.testing.assert_array_equal(wide.shape_basis.numpy(),
                                  rig["shape_basis"])
    few = assets.load_smplx(short, num_betas=4, num_expression=2,
                            device="cpu", dtype=torch.float32)
    assert few.n_shape == 6 and few.v_template.dtype == torch.float32
    np.testing.assert_array_equal(
        few.shape_basis.double().numpy(),
        np.concatenate([rig["shape_basis"][..., :4],
                        rig["shape_basis"][..., 300:302]], axis=-1
                       ).astype(np.float32))
    for path, kw in ((short, dict(num_betas=11)),
                     (short, dict(num_expression=11)),
                     (full, dict(num_betas=301)),
                     (full, dict(num_expression=101)),
                     (full, dict(num_betas=-1))):
        with pytest.raises(ValueError, match="shape columns"):
            assets.load_smplx(path, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["smpl", "smplh"])
def test_smpl_and_smplh_pickles_load_as_before(tmp_path, kind):
    """A 24-joint SMPL pickle and a 52-joint SMPL-H one (which carries
    ``hands_componentsl`` too) still load as PCA-less bodies with every
    shape column, equal to the JAX package's ``load_model``."""
    j, s = (24, 10) if kind == "smpl" else (52, 16)
    a = synthetic_arrays(seed=j, n_verts=120, n_joints=j, n_shape=s,
                         n_faces=80)
    raw = {"v_template": a["v_template"], "shapedirs": a["shape_basis"],
           "posedirs": a["pose_basis"], "J_regressor": a["j_regressor"],
           "weights": a["lbs_weights"],
           "f": np.asarray(a["faces"], np.uint32),
           "kintree_table": np.stack([
               np.asarray([BIG] + list(a["parents"][1:]), np.uint32),
               np.arange(j, dtype=np.uint32)])}
    if kind == "smplh":
        raw.update(hands_componentsl=np.eye(45), hands_componentsr=np.eye(45),
                   hands_meanl=np.zeros(45), hands_meanr=np.zeros(45))
    path = write(raw, tmp_path / f"{kind.upper()}_NEUTRAL.pkl")
    got = assets.load_model(path, device="cpu")
    want = jassets.load_model(path)
    assert got.n_joints == j and got.n_shape == s and got.side == "neutral"
    for f in assets.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.parents == tuple(int(p) for p in want.parents)


def test_an_official_smplx_pickle_is_read_once_a_format(rig, tmp_path,
                                                        monkeypatch):
    """``load_model`` unpickles an official SMPL-X ``.pkl`` twice: once as
    the reference's dumped pickle (``encoding='bytes'``, which fails),
    once as a chumpy-era file, whose dict it sniffs and loads.
    ``load_smplx`` unpickles it once. A v1.1 file is hundreds of MB."""
    from mano_hand_tpu_torch.assets import loader

    path = write(official(rig, 400, sparse=True),
                 tmp_path / "SMPLX_NEUTRAL.pkl")
    calls = []
    real = loader._tolerant_load
    monkeypatch.setattr(loader, "_tolerant_load",
                        lambda f, encoding: calls.append(encoding)
                        or real(f, encoding))
    assert assets.load_model(path, device="cpu").n_joints == J
    assert calls == ["bytes", "latin1"]
    calls.clear()
    assert assets.load_smplx(path, device="cpu").n_shape == 20
    assert calls == ["latin1"]


def test_smplx_parents_are_the_benchmark_configurations():
    """The port's ``constants.SMPLX_PARENTS`` is the tree the benchmark's
    ``smplx_neutral`` configuration states: 55 joints, each after its
    parent."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                      / "configs" / "smplx_neutral.json").read_text())
    assert SMPLX_PARENTS == tuple(cfg["parents"])
    assert len(SMPLX_PARENTS) == J
    assert all(p < i for i, p in enumerate(SMPLX_PARENTS))


def inputs(b: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    pose = 0.4 * torch.randn(b, J, 3, generator=g, dtype=torch.float64)
    pose[:, 0] *= 2.5
    pose[0] = 0.0        # the zero rotation: every small-angle branch
    shape = torch.randn(b, 20, generator=g, dtype=torch.float64)
    return pose, shape


def reference_verts(raw: dict, pose, shape, precision="float64"):
    """The reference over the official file's own arrays: betas against
    columns 0-9, expression against columns 300-309."""
    t = {k: torch.from_numpy(np.asarray(
        raw[k].toarray() if hasattr(raw[k], "toarray") else raw[k],
        np.float64)) for k in ("v_template", "posedirs", "J_regressor",
                               "weights")}
    dirs = torch.from_numpy(raw["shapedirs"])
    model = dict(t, shapedirs=dirs[..., :10], exprdirs=dirs[..., 300:310],
                 parents=SMPLX_PARENTS)
    return reference.forward(model, pose, shape[:, :10], shape[:, 10:],
                             precision)


def test_forward_chunked_runs_the_loaded_file(rig, tmp_path):
    """The loaded ``ManoParams`` go unchanged into ``forward_chunked``:
    its default route (float64) and its K1 route (K1's CPU path, each
    chunk written into its rows, the last one short) against the
    reference and against the JAX package's plain forward."""
    raw = official(rig, 400, True)
    params = assets.load_model(write(raw, tmp_path / "SMPLX_NEUTRAL.pkl"),
                               device="cpu")
    pose, shape = inputs(11)
    want = reference_verts(raw, pose, shape)

    plain = core.forward_chunked(params, pose, shape, chunk_size=4)
    assert plain.dtype == torch.float64
    assert float((plain - want).abs().max()) < EXACT

    in_place = fused_forward.chunks_in_place
    with torch.no_grad():
        k1 = core.forward_chunked(params, pose, shape, chunk_size=4,
                                  use_pallas_fused_full=True)
    assert fused_forward.chunks_in_place - in_place == 3
    assert k1.shape == (11, V, 3) and k1.dtype == torch.float32
    assert float((k1.double() - want).abs().max()) < F32_VS_F64

    jp = JaxParams(**{f: np.asarray(getattr(params, f).numpy(),
                                    np.int32 if f == "faces" else np.float32)
                      for f in assets.ARRAY_FIELDS},
                   parents=params.parents, side=params.side)
    jax_verts = jcore.forward_batched(jp, jnp.asarray(pose.float().numpy()),
                                      jnp.asarray(shape.float().numpy()),
                                      fused=False).verts
    assert float(np.abs(k1.numpy() - np.asarray(jax_verts)).max()) \
        < F32_VS_JAX


def test_reference_in_tf32_is_float32_off_the_card(rig):
    """The control's precision runs the reference in float32 (TF32 acts
    only on the card): within fp32 rounding of the float64 forward."""
    raw = official(rig, 400, False)
    pose, shape = inputs(3, seed=1)
    got = reference_verts(raw, pose, shape, "tf32")
    assert got.dtype == torch.float32
    assert float((got.double() - reference_verts(raw, pose, shape)
                  ).abs().max()) < F32_VS_F64
