"""Multi-process execution helpers over ``torch.distributed``.

The port of the JAX package's ``parallel/multihost.py``. There,
``jax.distributed`` bootstraps the process group and a mesh spans every
process's devices; here ``torch.distributed.init_process_group`` does,
one rank a process and one device a rank (NCCL between cards, gloo on
the CPU or where NCCL cannot go, such as two ranks on one card). Nothing
tells a program of a cluster: pass the coordinator's address, the
process count and this process's id, or run under a launcher that sets
``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``.

Everything here degrades to single-process semantics when no group is
configured: the same code runs in one process and in many.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.parallel.mesh import (
    DATA_AXIS, backend_for, make_mesh, set_group_device,
)
from mano_hand_tpu_torch.parallel.sharding import _dtensor

_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Start this process's rank of the process group; True if the group
    has more than one process.

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store; pass
    it with ``num_processes`` and ``process_id``. With none of them, a
    launcher's environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``)
    starts the group; without that either, nothing happens and False
    comes back (one process). ``device`` is this rank's device (default
    ``cuda``); ``backend`` defaults to the device's, NCCL for a card and
    gloo for the CPU (gloo over a card's tensors where NCCL refuses, as
    for several ranks on one card). Safe to call again: a started group
    is kept.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not explicit and not all(k in os.environ for k in _LAUNCHER_ENV):
        return False    # one process: nothing configured, nothing to join
    if explicit and (coordinator_address is None or num_processes is None
                     or process_id is None):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together")
    dev = set_group_device(resolve_device(device))
    backend = backend or backend_for(dev)
    if explicit:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size() > 1


def global_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of every process.

    Defaults to all-data-parallel over the world size. The 'model'
    (tensor-parallel) axis should stay within one host's NVLink domain:
    keep ``model`` a divisor of the ranks a host runs, so the joints'
    all-reduce never leaves the host. ``devices`` as ``make_mesh``'s.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if n % model:
            raise ValueError(f"model={model} must divide device count {n}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return make_mesh(data, model, devices)


def process_local_slice(global_batch: int, mesh: DeviceMesh) -> slice:
    """The [start, stop) rows of a global batch this process should load.

    Row-major over the ranks: each process feeds its own shard — the
    host-side analogue of a distributed sampler.
    """
    n_proc = dist.get_world_size()
    n_data = mesh[DATA_AXIS].size()
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} not divisible by the mesh's "
            f"data axis ({n_data})")
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{n_proc} processes")
    per = global_batch // n_proc
    pid = dist.get_rank()
    return slice(pid * per, (pid + 1) * per)


def global_batch_array(local_rows, mesh: DeviceMesh) -> DTensor:
    """Assemble a batch-sharded global DTensor from per-process rows.

    ``local_rows`` (an array or tensor) is this process's slice (see
    ``process_local_slice``); the result has the global shape (rows x
    processes, ...) and lies row-major over the ranks, on this rank's
    device, usable directly by the sharded forward and fit programs.
    Single-process: the rows themselves, placed on the one-rank mesh.
    """
    local = torch.as_tensor(np.ascontiguousarray(local_rows)) \
        if not torch.is_tensor(local_rows) else local_rows.contiguous()
    local = local.to(mesh.device_type)
    shape = (local.shape[0] * dist.get_world_size(), *local.shape[1:])
    return _dtensor(local, mesh, (Shard(0), Shard(0)), shape)

