"""The port's examples against the JAX functions their JAX counterparts
call, on the same seeds and sizes, JAX computed here on the CPU: 01's
OBJ pair, 06's three K4 routes (JAX's K4 in interpret mode), 09's loaded
artifact at two batch sizes. Tolerance 1e-5 (the OBJ text carries six
decimals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mano_hand_tpu.models import core as jcore
from mano_hand_tpu_torch.io import read_obj
from mano_hand_tpu_torch.io.export_aot import load_forward
from torch_examples_run import run_example, torch_threads

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def jp(params):
    return params.astype(np.float32)


def test_quickstart_obj_pair_matches_jax(jp, tmp_path):
    run_example("01_quickstart", tmp_path)
    rng = np.random.default_rng(0)
    pose = jnp.asarray(rng.normal(scale=0.3, size=(16, 3)), jnp.float32)
    shape = jnp.asarray(rng.normal(size=10), jnp.float32)
    want = jcore.forward(jp, pose, shape)
    posed = read_obj(tmp_path / "quickstart_hand.obj")
    rest = read_obj(tmp_path / "quickstart_hand_restpose.obj")
    np.testing.assert_allclose(posed.verts, np.asarray(want.verts),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(rest.verts, np.asarray(want.rest_verts),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(posed.faces, np.asarray(jp.faces))


def test_fast_inference_routes_match_jax_k4_interpreted(jp, tmp_path):
    import torch.distributed as dist

    got = {}
    run_example("06_fast_inference", tmp_path, outputs=got)
    assert not dist.is_initialized()     # the example ended its group
    assert got["pose"].shape == (64, 16, 3)
    fwd = jax.jit(lambda prm, p, s: jcore.forward_batched_pallas_fused(
        prm, p, s, interpret=True))
    want = np.asarray(fwd(jp, got["pose"].numpy(), got["beta"].numpy()))
    for route in ("fused", "chunked", "sharded"):
        assert tuple(got[route].shape) == want.shape, route
        np.testing.assert_allclose(got[route].numpy(), want, atol=TOL,
                                   rtol=0, err_msg=route)


def test_aot_artifact_matches_jax_forward_at_two_batch_sizes(jp, tmp_path):
    run_example("09_aot_serving", tmp_path)
    fwd = load_forward(tmp_path / "mano_fwd.torchexp")
    assert fwd.platforms == ("cpu",) and fwd.n_keypoints == 21
    rng = np.random.default_rng(0)
    for batch in (1, 16):
        pose = rng.normal(scale=0.3, size=(batch, 16, 3)).astype(np.float32)
        shape = rng.normal(size=(batch, 10)).astype(np.float32)
        out = fwd(torch.from_numpy(pose), torch.from_numpy(shape))
        want = jcore.forward_batched(jp, jnp.asarray(pose),
                                     jnp.asarray(shape))
        np.testing.assert_allclose(out["verts"].numpy(),
                                   np.asarray(want.verts), atol=TOL, rtol=0)
        kp = jcore.keypoints(want, "smplx", order="openpose")
        np.testing.assert_allclose(out["keypoints"].numpy(), np.asarray(kp),
                                   atol=TOL, rtol=0)


def test_examples_import_no_jax():
    """Loading an example pulls nothing of JAX in (checked in a fresh
    interpreter: this one has JAX loaded)."""
    import json
    import subprocess
    import sys

    from torch_examples_run import EXAMPLES, NAMES, ROOT

    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for n in {NAMES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(n, "
        f"{str(EXAMPLES)!r} + '/' + n + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import mano_hand_tpu_torch.fitting, mano_hand_tpu_torch.viz\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'flax', 'optax', 'mano_hand_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
