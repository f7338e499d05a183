"""The port's examples on the CPU, part 2: 11 and 16-21 in process at
``tests/test_examples.py``'s reduced flags, each holding its own asserts
(JAX's thresholds), and the files they write read back."""

import numpy as np
import pytest

from torch_examples_run import NAMES, run_example, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize(
    "name", [n for n in NAMES if n[:2] == "11" or n[:2] >= "16"])
def test_example_runs(name, tmp_path):
    run_example(name, tmp_path)


def test_detector_glb_is_skinned_and_drivable_as_jax_s(tmp_path):
    """17's GLB keeps the structure of JAX's: one skinned mesh over the
    16-joint hierarchy, and the rest -> fit clip as rotation channels."""
    from mano_hand_tpu_torch.io.gltf import read_glb

    run_example("17_detector_to_glb", tmp_path)
    glb = read_glb(tmp_path / "detector_fit.glb")
    gltf = glb["gltf"]
    assert len(gltf["skins"]) == 1 and len(gltf["skins"][0]["joints"]) == 16
    assert len(gltf["meshes"]) == 1
    channels = gltf["animations"][0]["channels"]
    assert {c["target"]["path"] for c in channels} == {"rotation"}
    assert len(channels) == 16


def test_bulk_registration_fits_every_frame(tmp_path):
    out = run_example("20_bulk_registration", tmp_path)
    assert "fit 64 frames" in out


def test_uncentered_scan_writes_its_registration(tmp_path):
    run_example("18_uncentered_scan_lm", tmp_path)
    saved = np.load(tmp_path / "uncentered_registration.npz")
    assert {"pose", "shape", "trans"} <= set(saved.files)
