"""The port's multi-process helpers (``parallel/multihost.py``) in one
process and in a real two-process gloo group over a local TCP
coordinator, held to the values JAX's ``tests/test_multihost_2proc.py``
and ``tests/test_parallel.py::test_multihost_helpers_single_process``
assert. The worker processes import no JAX."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mano_hand_tpu_torch.parallel import make_mesh, mesh as mesh_mod
from mano_hand_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parent.parent

_WORKER = """
import json, sys
root, port, pid, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
torch.set_num_threads(1)
from mano_hand_tpu_torch.parallel import multihost

is_multi = multihost.initialize(f"localhost:{port}", 2, pid, device="cpu")
mesh = multihost.global_mesh()  # all-data-parallel over both processes
gb = 8
sl = multihost.process_local_slice(gb, mesh)
full = np.arange(gb * 3, dtype=np.float32).reshape(gb, 3)
arr = multihost.global_batch_array(full[sl], mesh)
# A global reduction over the batch-sharded array: DTensor's partial sum
# all-reduces across the processes, so the value only comes out right if
# assembly AND the collective both work.
total = float(arr.sum().full_tensor())
import torch.distributed as dist
json.dump({"is_multi": is_multi, "process_count": dist.get_world_size(),
           "pid": dist.get_rank(), "mesh_data": mesh["data"].size(),
           "slice": [sl.start, sl.stop], "total": total,
           "expect": float(full.sum()),
           "shape": list(arr.shape),
           "shard_rows": [arr.to_local().shape[0]],
           "jax": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "mano_hand_tpu"))},
          open(out, "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_group_end_to_end(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    err_files = [open(tmp_path / f"err{pid}.log", "w") for pid in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(ROOT), str(port), str(pid),
         str(tmp_path / f"out{pid}.json")],
        env=env, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=err_files[pid]) for pid in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=90)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in err_files:
            f.close()
    for pid, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"err{pid}.log").read_text()
    outs = [json.loads((tmp_path / f"out{i}.json").read_text())
            for i in (0, 1)]
    for pid, o in enumerate(outs):
        assert o["is_multi"] is True
        assert o["process_count"] == 2
        assert o["pid"] == pid
        assert o["mesh_data"] == 2
        # Row-major process slicing: proc 0 loads [0,4), proc 1 [4,8).
        assert o["slice"] == [pid * 4, pid * 4 + 4]
        assert o["shape"] == [8, 3]
        # One device a process: its one shard holds its 4 rows.
        assert o["shard_rows"] == [4]
        # The cross-process all-reduce saw every row exactly once.
        assert o["total"] == o["expect"] == 276.0
        assert o["jax"] == []


@pytest.fixture
def one_rank_group():
    """The single-rank group a one-process mesh starts, torn down after."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_mod._group_device.clear()


def test_helpers_in_one_process(one_rank_group):
    """No group configured: ``initialize`` is a no-op, and a mesh of one
    rank starts its own group (gloo on the CPU, no address or port) — the
    same code path a cluster runs."""
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        # The port's default device is the card: without one, say so.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1, 1)
    with pytest.raises(ValueError, match="multihost.initialize"):
        make_mesh(2, 1, devices=["cpu"])
    mesh = multihost.global_mesh(devices=["cpu"])
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                         "model": 1}
    assert multihost.initialize() is False       # the group stays
    sl = multihost.process_local_slice(16, mesh)
    assert (sl.start, sl.stop) == (0, 16)
    with pytest.raises(ValueError, match="must divide"):
        multihost.global_mesh(model=3)
    rng = np.random.default_rng(0)
    local = rng.normal(size=(8, 16, 3)).astype(np.float32)
    arr = multihost.global_batch_array(local, mesh)
    assert tuple(arr.shape) == (8, 16, 3)
    np.testing.assert_array_equal(arr.full_tensor().numpy(), local)
    # The assembled array feeds the sharded forward directly.
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.parallel import sharding as shd

    params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    verts = shd.gspmd_forward(shd.shard_params(params, mesh), mesh,
                              n_verts=778)(arr, torch.zeros((8, 10)))
    want = core.forward_batched(params, torch.from_numpy(local),
                                torch.zeros((8, 10))).verts
    torch.testing.assert_close(verts.full_tensor(), want, atol=1e-5,
                               rtol=0)
