"""The port's ``fit`` subcommand against the JAX package's ``cli.py``:
LM with the PNG and GLB error heatmaps, and the silhouette (``.npy`` and
``.png`` masks) and depth terms through ``python -m mano_hand_tpu_torch
fit``. The harness of ``test_torch_cli.py``: both ``main``s on the same
input files, the port's with ``--device cpu``; checkpoints held by their
loss history (1e-4 relative) and pose, heatmaps by their decoded colours.
"""

import numpy as np
import pytest

from test_torch_cli import (  # noqa: F401 (fixtures)
    REL_TOL, _glb_err, _one_thread, _run, files,
)


def _fit_checkpoints(tmp_path, name):
    return [dict(np.load(tmp_path / side / name)) for side in ("jax", "port")]


def test_fit_lm_with_heatmaps_as_jax(files, capsys, tmp_path):
    # Two LM steps leave millimetre errors, so the heatmap's colours are a
    # function of the fit, not of its rounding noise.
    for heat in ("err.png", "err.glb"):
        (jrc, jout, jerr), (rc, out, err) = _run(
            capsys, ["fit", str(files / "t.npy"), "--solver", "lm",
                     "--steps", "2", "--out", "{out}/f.npz", "--heatmap",
                     "{out}/" + heat], tmp_path)
        assert rc == jrc == 0 and err == jerr
        # The printed losses and error are f32 numbers of two libraries.
        assert out.split("(worst")[0] == jout.split("(worst")[0]
        want, got = _fit_checkpoints(tmp_path, "f.npz")
        assert sorted(got) == sorted(want)
        assert np.abs(got["pose"] - want["pose"]).max() <= 1e-4
    assert _glb_err(tmp_path / "jax" / "err.glb",
                    tmp_path / "port" / "err.glb") <= 1e-4
    from PIL import Image

    a, b = (np.asarray(Image.open(tmp_path / s / "err.png"), np.int16)
            for s in ("jax", "port"))
    assert a.shape == b.shape == (256, 256, 3)
    assert np.abs(a - b).max() <= 1      # 8-bit colours of f32 renders


@pytest.mark.parametrize("term", ["silhouette", "depth", "png_mask"])
def test_fit_image_terms_as_jax(files, capsys, tmp_path, term):
    if term == "png_mask":
        from PIL import Image

        mask = (np.load(files / "sil.npy") * 255).astype(np.uint8)
        Image.fromarray(mask, "L").save(tmp_path / "sil.png")
        target, term = str(tmp_path / "sil.png"), "silhouette"
    else:
        target = str(files / ("sil.npy" if term == "silhouette"
                              else "depth.npy"))
    (jrc, jout, jerr), (rc, out, err) = _run(
        capsys, ["fit", target, "--data-term", term, "--steps", "10",
                 "--out", "{out}/f.npz"], tmp_path)
    assert rc == jrc == 0 and err == jerr
    assert out.split("(worst")[0] == jout.split("(worst")[0]
    want, got = _fit_checkpoints(tmp_path, "f.npz")
    assert sorted(got) == sorted(want) and "trans" in got
    h_got, h_want = got["loss_history"], want["loss_history"]
    assert (np.abs(h_got - h_want) / np.abs(h_want)).max() <= REL_TOL
