"""The port's ``utils`` (``ManoConfig``, ``batches``,
``prefetch_to_device``, ``Timer``) and the ``__all__`` of its ``utils``
and ``parallel`` packages, against the JAX package's."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mano_hand_tpu.parallel as jpar
import mano_hand_tpu.utils as jutils
from mano_hand_tpu.utils import ManoConfig as JaxConfig
from mano_hand_tpu.utils.data import batches as jax_batches
from mano_hand_tpu_torch import parallel, utils
from mano_hand_tpu_torch.models.layer import MANOModel
from mano_hand_tpu_torch.parallel import mesh as mesh_mod
from mano_hand_tpu_torch.utils import (
    ManoConfig, Timer, batches, prefetch_to_device,
)


def test_all_names_follow_jax():
    assert sorted(utils.__all__) == sorted(
        (set(jutils.__all__) - {"xla_trace", "time_jax_fn"})
        | {"torch_trace"})
    assert sorted(parallel.__all__) == sorted(
        set(jpar.__all__) | {"lane_devices"})


# ------------------------------------------------------------- ManoConfig
def test_config_json_round_trip_and_errors(tmp_path):
    cfg = ManoConfig(side="left", mesh_data=2, chunk_size=1024, seed=3,
                     precision="highest")
    path = tmp_path / "cfg.json"
    cfg.to_json(path)
    assert ManoConfig.from_json(path) == cfg
    assert ManoConfig.from_json(cfg.to_json()) == cfg   # from text too
    # The same keys, in the same order, as the JAX package's files.
    assert list(json.loads(cfg.to_json())) == list(
        json.loads(JaxConfig().to_json()))
    with pytest.raises(ValueError, match="unknown config keys"):
        ManoConfig.from_json('{"asset": "synthetic", "bogus": 1}')
    with pytest.raises(ValueError, match="precision"):
        ManoConfig(precision="bf16")


def test_a_jax_written_file_loads_in_the_port(tmp_path):
    path = tmp_path / "jax.json"
    JaxConfig(side="left", dtype="float32", precision="default",
              mesh_model=2, seed=7).to_json(path)
    cfg = ManoConfig.from_json(path)
    assert cfg.backend == "torch"                 # "jax" reads as "torch"
    want = json.loads(path.read_text())
    want["backend"] = "torch"
    assert json.loads(cfg.to_json()) == want
    assert ManoConfig(backend="np").backend == "np"


@pytest.mark.parametrize("backend", ["torch", "np"])
def test_config_builds_the_model(backend):
    cfg = ManoConfig(backend=backend, seed=2, side="left")
    params = cfg.load_params(device="cpu")
    jp = JaxConfig(backend="jax" if backend == "torch" else "np", seed=2,
                   side="left").load_params()
    assert params.side == jp.side == "left"
    for f in ("v_template", "shape_basis", "j_regressor"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jp, f)))
        assert str(getattr(params, f).dtype).endswith(
            str(np.asarray(getattr(jp, f)).dtype))
    model = cfg.build_model(device="cpu")
    assert isinstance(model, MANOModel) and model.backend == backend


def test_config_builds_the_mesh():
    assert not dist.is_initialized()
    try:
        mesh = ManoConfig().build_mesh(devices=["cpu"])
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {
            "data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            ManoConfig(mesh_data=2).build_mesh(devices=["cpu"])
    finally:
        dist.destroy_process_group()
        mesh_mod._group_device.clear()


# ---------------------------------------------------------------- batches
def _arrays(n=20):
    rng = np.random.default_rng(0)
    return {"pose": rng.normal(size=(n, 16, 3)).astype(np.float32),
            "beta": rng.normal(size=(n, 10)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=8), dict(batch_size=8, shuffle=True, seed=1, epochs=2),
    dict(batch_size=6, shuffle=True, seed=5, epochs=3),
    dict(batch_size=8, drop_remainder=False),
    dict(batch_size=7, shuffle=True, seed=2, drop_remainder=False)])
def test_batches_byte_for_byte_as_jax(kw):
    arrs = _arrays(20)
    got, want = list(batches(arrs, **kw)), list(jax_batches(arrs, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].tobytes() == w[k].tobytes()


def test_batches_validate_at_the_call():
    with pytest.raises(ValueError, match="leading dims disagree"):
        batches({"a": np.zeros(3), "b": np.zeros(4)}, 2)
    with pytest.raises(ValueError, match="exceeds dataset size"):
        batches(_arrays(4), 8)
    with pytest.raises(ValueError, match="batch_size must be"):
        batches(_arrays(4), 0)
    with pytest.raises(ValueError, match="at least one array"):
        batches({}, 2)


# ----------------------------------------------------- prefetch_to_device
def test_prefetch_lands_batches_in_order_and_drains():
    arrs = _arrays(16)
    got = list(prefetch_to_device(batches(arrs, 4), size=2, device="cpu"))
    assert len(got) == 4
    for b, p in zip(got, batches(arrs, 4)):
        assert isinstance(b["pose"], torch.Tensor)
        np.testing.assert_array_equal(b["pose"].numpy(), p["pose"])
        # A copy, not a view of the host batch.
        assert b["pose"].numpy().ctypes.data != p["pose"].ctypes.data
    # More in flight than the iterator has: every batch still comes out.
    assert len(list(prefetch_to_device(batches(_arrays(8), 4), size=8,
                                       device="cpu"))) == 2
    # Tuples and lists keep their structure.
    out = next(prefetch_to_device(iter([(np.ones(3), [np.zeros(2)])]),
                                  device="cpu"))
    assert isinstance(out, tuple) and isinstance(out[1], list)
    with pytest.raises(ValueError, match="size must be"):
        prefetch_to_device(iter([]), size=0, device="cpu")


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(iter([]))


def test_prefetch_with_a_mesh_lands_dtensors():
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh(1, 1, devices=["cpu"])
        arrs = _arrays(16)
        got = list(prefetch_to_device(batches(arrs, 8), mesh=mesh))
        assert len(got) == 2
        for b, p in zip(got, batches(arrs, 8)):
            assert tuple(b["pose"].placements) == parallel.batch_sharding(
                mesh)
            assert tuple(b["pose"].shape) == (8, 16, 3)
            np.testing.assert_array_equal(b["pose"].full_tensor().numpy(),
                                          p["pose"])
    finally:
        dist.destroy_process_group()
        mesh_mod._group_device.clear()


# ------------------------------------------------------------------ Timer
def test_timer_accumulates():
    t = Timer()
    assert t.mean == 0.0 and t.count == 0
    for _ in range(3):
        with t:
            sum(range(1000))
    assert t.count == 3 and t.total > 0
    assert t.mean == pytest.approx(t.total / 3)
