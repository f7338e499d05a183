"""The port's asset loaders, scan poses and asset audit against the JAX
package's.

Every format is forged in ``tmp_path`` (as ``tests/test_assets.py`` forges
them: no asset download): the canonical ``.npz``, the reference's dumped
pickle (str and py2-era bytes keys), the official chumpy-era MANO pickle
(chumpy absent, sparse J_regressor, uint32 root sentinel) and an SMPL
body pickle (24 joints, no hand PCA). Both packages must load each file
to EQUAL float64 arrays (exact, not close), the same parents and the
same side, and fail alike on a broken file. The audit's gates and its
sha256 digests must be equal letter for letter.
"""

import dataclasses
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from mano_hand_tpu import assets as jassets
from mano_hand_tpu.assets import verify as jverify
from mano_hand_tpu.assets.synthetic import synthetic_params as jax_synthetic
from mano_hand_tpu_torch import assets
from mano_hand_tpu_torch.assets import ARRAY_FIELDS, verify

BIG = np.uint32(4294967295)   # SMPL's and MANO's uint32 root sentinel


def _assert_same(port, jax, dtype=torch.float64):
    for f in ARRAY_FIELDS:
        got = getattr(port, f)
        assert got.device == torch.device("cpu")
        assert got.dtype == (torch.int32 if f == "faces" else dtype), f
        want = np.asarray(getattr(jax, f))
        np.testing.assert_array_equal(got.numpy(), want.astype(
            got.numpy().dtype), err_msg=f)
    assert port.parents == tuple(int(p) for p in jax.parents)
    assert port.side == jax.side


def _official_raw(p, ch):
    import scipy.sparse as sp

    return {
        "v_template": ch(p.v_template),
        "shapedirs": ch(p.shape_basis),
        "posedirs": np.asarray(p.pose_basis),
        "J_regressor": sp.csc_matrix(np.asarray(p.j_regressor)),
        "weights": ch(p.lbs_weights),
        "hands_components": np.asarray(p.pca_basis),
        "hands_mean": np.asarray(p.pca_mean),
        "hands_coeffs": np.random.default_rng(5).normal(size=(6, 45)),
        "f": np.asarray(p.faces, np.uint32),
        "kintree_table": np.stack([
            np.asarray([BIG] + list(p.parents[1:]), np.uint32),
            np.arange(p.n_joints, dtype=np.uint32)]),
    }


def _pickle_with_fake_chumpy(raw_fn, path):
    """Pickle ``raw_fn(Ch)`` with a forged ``chumpy.Ch`` class, removed
    again before anything loads it: unpickling must take the stub path."""
    fake = types.ModuleType("chumpy")

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)
            self.dterms = ("x",)  # extra non-array state, like real chumpy

    Ch.__module__ = "chumpy"
    Ch.__qualname__ = "Ch"
    fake.Ch = Ch
    assert "chumpy" not in sys.modules
    sys.modules["chumpy"] = fake
    try:
        with open(path, "wb") as f:
            pickle.dump(raw_fn(Ch), f, protocol=2)
    finally:
        del sys.modules["chumpy"]
    return path


def _forge(kind, tmp_path):
    """One asset file of ``kind``; returns its path."""
    hand = jax_synthetic(seed=3)
    if kind == "npz":
        path = tmp_path / "hand_left.npz"
        jassets.save_npz(hand, path)
    elif kind == "dumped":
        path = tmp_path / "dump_mano_right.pkl"
        jassets.save_dumped_pickle(hand, path)
    elif kind == "dumped_bytes_keys":
        path = tmp_path / "dump_mano_left.pkl"
        jassets.save_dumped_pickle(hand, path)
        with open(path, "rb") as f:
            raw = pickle.load(f)
        with open(path, "wb") as f:
            pickle.dump({k.encode(): v for k, v in raw.items()}, f)
    elif kind == "official":
        path = _pickle_with_fake_chumpy(
            lambda ch: _official_raw(hand, ch), tmp_path / "MANO_LEFT.pkl")
    elif kind == "smpl":
        import scipy.sparse as sp

        body = jax_synthetic(seed=11, n_verts=437, n_joints=24,
                             n_shape=16, n_faces=870)
        raw = {
            "v_template": np.asarray(body.v_template),
            "shapedirs": np.asarray(body.shape_basis),
            "posedirs": np.asarray(body.pose_basis),
            "J_regressor": sp.csc_matrix(np.asarray(body.j_regressor)),
            "weights": np.asarray(body.lbs_weights),
            "f": np.asarray(body.faces, np.uint32),
            "kintree_table": np.stack([
                np.asarray([BIG] + list(body.parents[1:]), np.uint32),
                np.arange(24, dtype=np.uint32)]),
        }
        path = tmp_path / "SMPL_NEUTRAL.pkl"
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
    else:
        raise AssertionError(kind)
    return path


FORMATS = ["npz", "dumped", "dumped_bytes_keys", "official", "smpl"]


@pytest.mark.parametrize("kind", FORMATS)
def test_load_model_equals_jax(kind, tmp_path):
    path = _forge(kind, tmp_path)
    want = jassets.load_model(path)
    got = assets.load_model(path, device="cpu")
    _assert_same(got, want)
    # An explicit side wins over the file name in both packages.
    _assert_same(assets.load_model(path, side="neutral", device="cpu"),
                 jassets.load_model(path, side="neutral"))


@pytest.mark.parametrize("kind,loader", [
    ("npz", "load_npz"),
    ("dumped", "load_dumped_pickle"),
    ("official", "load_official_pickle"),
    ("smpl", "load_smpl_pickle"),
])
def test_each_loader_equals_jax(kind, loader, tmp_path):
    path = _forge(kind, tmp_path)
    got = getattr(assets, loader)(path, device="cpu")
    _assert_same(got, getattr(jassets, loader)(path))
    # The device copy in another dtype carries the same values.
    p32 = getattr(assets, loader)(path, device="cpu", dtype=torch.float32)
    _assert_same(p32, getattr(jassets, loader)(path).astype(np.float32),
                 dtype=torch.float32)


def test_smpl_body_keeps_its_topology(tmp_path):
    """The 24-joint body loads with its own tree, a pass-through PCA
    space, and runs through the port's generic core."""
    from mano_hand_tpu_torch.models import core

    body = assets.load_model(_forge("smpl", tmp_path), device="cpu")
    assert body.n_joints == 24 and body.n_shape == 16
    assert body.parents[0] == -1 and body.side == "neutral"
    np.testing.assert_array_equal(body.pca_basis.numpy(), np.eye(69))
    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.normal(scale=0.2, size=(3, 24, 3)))
    out = core.forward_batched(body, pose, torch.zeros(3, 16,
                                                      dtype=torch.float64))
    assert out.verts.shape == (3, 437, 3)
    assert torch.isfinite(out.verts).all()
    # decode(c) == c through the identity basis.
    c = torch.from_numpy(rng.normal(size=(69,)))
    np.testing.assert_array_equal(core.decode_pca(body, c)[1:].numpy(),
                                  c.reshape(23, 3).numpy())


@pytest.mark.parametrize("name,want", [
    ("neutral_pose_left.pkl", "left"),
    ("neutral_pose_right.pkl", "right"),
    ("body_neutral.pkl", "neutral"),
    ("dump_mano_left.pkl", "left"),
    ("hand.pkl", "right"),
])
def test_side_inference_equals_jax(name, want, tmp_path):
    path = tmp_path / name
    jassets.save_dumped_pickle(jax_synthetic(seed=0), path)
    got = assets.load_dumped_pickle(path, device="cpu")
    assert got.side == want == jassets.load_dumped_pickle(path).side


@pytest.mark.parametrize("writer", ["save_npz", "save_dumped_pickle"])
def test_port_writers_load_in_both_packages(writer, tmp_path):
    p = assets.synthetic_params(seed=2, side="left", device="cpu")
    path = tmp_path / ("left_hand.npz" if writer == "save_npz"
                       else "dump_left.pkl")
    getattr(assets, writer)(p, path)
    want = jassets.load_model(path)
    _assert_same(assets.load_model(path, device="cpu"), want)
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(p, f).numpy(), err_msg=f)
    if writer == "save_dumped_pickle":
        with open(path, "rb") as fh:
            assert pickle.load(fh)["parents"][0] is None


def test_corrupt_mano_pickle_fails_alike(tmp_path):
    """A 16-joint pickle without the hand-PCA keys is a corrupt MANO file
    in both packages, not a fabricated body; junk fails loudly."""
    hand = jax_synthetic(seed=3)

    def raw_fn(ch):
        raw = _official_raw(hand, ch)
        del raw["hands_components"], raw["hands_mean"]
        return raw

    broken = _pickle_with_fake_chumpy(raw_fn, tmp_path / "MANO_RIGHT_b.pkl")
    for load in (jassets.load_model,
                 lambda p: assets.load_model(p, device="cpu")):
        with pytest.raises(KeyError, match="corrupt MANO"):
            load(broken)
    junk = tmp_path / "junk.pkl"
    junk.write_bytes(b"\x00\x01garbage")
    with pytest.raises(Exception):
        assets.load_model(junk, device="cpu")


def test_loader_failure_paths_are_named(tmp_path):
    p = assets.synthetic_params(seed=0, device="cpu")
    good = tmp_path / "good.npz"
    assets.save_npz(p, good)
    trunc = tmp_path / "trunc.npz"
    trunc.write_bytes(good.read_bytes()[:200])
    with pytest.raises(Exception):
        assets.load_npz(trunc, device="cpu")
    arrs = dict(np.load(good, allow_pickle=False))
    arrs.pop("lbs_weights")
    np.savez(tmp_path / "partial.npz", **arrs)
    with pytest.raises((KeyError, ValueError)):
        assets.load_npz(tmp_path / "partial.npz", device="cpu")
    arrs = dict(np.load(good, allow_pickle=False))
    arrs["lbs_weights"] = arrs["lbs_weights"][:, :8]
    np.savez(tmp_path / "bad.npz", **arrs)
    with pytest.raises(ValueError, match="lbs_weights"):
        assets.load_npz(tmp_path / "bad.npz", device="cpu")


def test_loaders_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = _forge("npz", tmp_path)
    for fn in (assets.load_model, assets.load_npz):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(path)


# ------------------------------------------------------------- scan poses
def test_scan_poses_equal_jax(tmp_path):
    """decode/extract/save of the scan-pose bank. The official pickles
    are forged with plain arrays here, since the JAX package's
    ``decode_scan_poses`` reads them with ``pickle.load``; the port's
    tolerant unpickler also reads a chumpy-wrapped one."""
    from mano_hand_tpu.assets import scans as jscans

    hand = jax_synthetic(seed=4)
    paths = []
    for name in ("MANO_LEFT.pkl", "MANO_RIGHT.pkl"):
        raw = _official_raw(hand, np.asarray)
        path = tmp_path / name
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
        paths.append(path)
    got = assets.decode_scan_poses(paths[0])
    np.testing.assert_array_equal(got, jscans.decode_scan_poses(paths[0]))
    assert got.shape == (6, 15, 3) and got.dtype == np.float64
    both = assets.extract_scan_poses(*paths)
    np.testing.assert_array_equal(both, jscans.extract_scan_poses(*paths))
    np.testing.assert_array_equal(both[6:], got * [1.0, -1.0, -1.0])
    out = assets.save_scan_poses(*paths, out_path=tmp_path / "ax.npy")
    np.testing.assert_array_equal(np.load(out), both)
    chumpy_wrapped = _pickle_with_fake_chumpy(
        lambda ch: _official_raw(hand, ch), tmp_path / "MANO_RIGHT_ch.pkl")
    np.testing.assert_array_equal(assets.decode_scan_poses(chumpy_wrapped),
                                  got)


# -------------------------------------------------------------- the audit
def _findings(report):
    return [dataclasses.asdict(f) for f in report.findings]


@pytest.mark.parametrize("case", ["synthetic", "corrupt_lbs", "nonfinite",
                                  "official", "smpl"])
def test_verify_report_equals_jax(case, tmp_path):
    """Gates, checks and every digest equal the JAX package's for the
    same file (a digest pinned with ``expect`` holds in both)."""
    if case in ("official", "smpl"):
        path = _forge(case, tmp_path)
    else:
        p = jax_synthetic(seed=0)
        if case == "corrupt_lbs":
            p = dataclasses.replace(p, lbs_weights=np.asarray(
                p.lbs_weights) * 1.5)
        elif case == "nonfinite":
            vt = np.asarray(p.v_template).copy()
            vt[3, 1] = np.nan
            p = dataclasses.replace(p, v_template=vt)
        path = tmp_path / "hand_right.npz"
        jassets.save_npz(p, path)
    want = jverify.verify_asset(path)
    got = verify.verify_asset(path, device="cpu")
    assert _findings(got) == _findings(want)
    assert got.digests == want.digests
    assert got.side == want.side and got.gates_ok == want.gates_ok
    digest = want.digests["combined"]
    assert verify.format_report(got, path, expect=digest) == \
        jverify.format_report(want, path, expect=digest)
    assert verify.report_json(got, expect="0" * 64) == \
        jverify.report_json(want, expect="0" * 64)
    if case == "synthetic":
        assert got.gates_ok
    elif case in ("corrupt_lbs", "nonfinite"):
        assert not got.gates_ok


def test_verify_golden_and_digest_shape_tag(tmp_path):
    p = assets.synthetic_params(seed=0, device="cpu")
    a, b = tmp_path / "a.npz", tmp_path / "b.pkl"
    assets.save_npz(p, a)
    assets.save_dumped_pickle(p, b)
    rep = verify.verify_asset(a, golden=b, device="cpu")
    gate = [f for f in rep.findings if f.name == "matches_golden"][0]
    assert gate.ok
    other = tmp_path / "c.npz"
    assets.save_npz(assets.synthetic_params(seed=1, device="cpu"), other)
    rep2 = verify.verify_asset(a, golden=other, device="cpu")
    assert not [f for f in rep2.findings if f.name == "matches_golden"][0].ok
    assert _findings(rep2) == _findings(
        jverify.verify_asset(a, golden=other))
    # Digests of a tensor and of the array it holds agree, and a transposed
    # array of the same bytes does not collide.
    x = np.arange(6.0).reshape(2, 3)
    assert verify._digest(torch.from_numpy(x)) == jverify._digest(x)
    assert verify._digest(x) != verify._digest(x.T.copy().reshape(3, 2))
    assert verify.compute_digests(p) == jverify.compute_digests(
        jax_synthetic(seed=0))
