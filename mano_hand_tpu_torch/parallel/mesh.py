"""Device meshes over the ranks of a ``torch.distributed`` group, and the
devices of the serving engine's dispatch lanes.

The port of the JAX package's ``parallel/mesh.py``. A JAX mesh lays out
the devices one process sees; here each rank of the process group is one
device (its own ``cuda`` card, or the CPU), and a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ``("data",
"model")`` lays out the ranks. Batch ("data") and vertex ("model") axes
map onto it as in JAX. One process is the common case: ``make_mesh(1,
1)`` with no group yet starts a single-rank one (NCCL on a card, gloo on
the CPU, over an in-process store: no address, no free port, no
environment variable), as a JAX mesh of one device needs no
``jax.distributed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from mano_hand_tpu_torch.ops.common import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: The device each rank of this process's group computes on, recorded by
#: whoever started the group here (``multihost.initialize`` or
#: ``make_mesh``'s single-rank group).
_group_device: list = []


def backend_for(device: torch.device) -> str:
    """The process-group backend of ``device``: NCCL for a card, gloo for
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def set_group_device(device) -> torch.device:
    """Record ``device`` as this process's rank device (and make a card
    current, so NCCL and the mesh use it)."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    _group_device[:] = [device]
    return device


def group_device() -> torch.device:
    """This rank's device: the one recorded when the group started, else
    the group's backend's (a card for NCCL, the CPU for gloo)."""
    if _group_device:
        return _group_device[0]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def destroy_group() -> None:
    """End this process's group, if any, and forget its rank device: the
    teardown of a group ``make_mesh`` or ``multihost.initialize``
    started, so a caller that runs one in process keeps none after."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _group_device.clear()


def _single_rank_group(device: torch.device) -> None:
    device = set_group_device(device)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build a ('data', 'model') mesh over the ranks of the process group.

    ``data=-1`` absorbs all remaining ranks. Ranks lie row-major: rank
    ``d * model + m`` sits at ``(d, m)``. ``devices`` gives each rank's
    device (one entry a rank, all of one type; on one card two ranks may
    share ``cuda:0``); None takes the group's. With no group yet, a mesh
    of one rank starts one on ``devices[0]``, by default ``cuda`` (pass
    ``devices=["cpu"]`` for the CPU); a larger one needs the group first
    (``multihost.initialize``).
    """
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"mesh devices must share one type, got "
                             f"{[str(d) for d in devices]}")
    if not dist.is_initialized():
        want = data * model if data != -1 else model
        if want != 1 or (devices is not None and len(devices) != 1):
            raise ValueError(
                "no process group: a mesh over more than one rank needs "
                "multihost.initialize(...) in every process first")
        _single_rank_group(devices[0] if devices else resolve_device(None))
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for {n} ranks")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {n}")
    device = (devices[dist.get_rank()] if devices is not None
              else group_device())
    if devices is not None:
        set_group_device(device)
    return DeviceMesh(device.type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def lane_devices(n: Optional[int] = None, platform: Optional[str] = None,
                 devices: Optional[Sequence] = None) -> list:
    """Devices to pin the serving engine's dispatch lanes to
    (``serving/lanes.py``).

    ``platform`` is a device type (``"cuda"`` or ``"cpu"``; None: the
    port's default, ``cuda``, which raises where CUDA is absent).
    ``n=None`` returns every device of that type (one lane per card; the
    CPU is one device). An explicit ``n`` returns exactly ``n`` devices,
    round-robin when fewer exist: on one H100, four lanes are four
    ``cuda:0`` handles, each lane with a CUDA stream of its own.
    ``devices`` names the devices instead of the platform's."""
    if devices is None:
        kind = resolve_device(platform).type
        if kind == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(kind)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no devices to build serving lanes on")
    if n is None:
        return devices
    if n < 1:
        raise ValueError(f"lane count must be >= 1, got {n}")
    return [devices[i % len(devices)] for i in range(int(n))]


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Leading-axis batch sharding over the data axis (the DTensor
    placements of JAX's ``P('data')``)."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    """Every rank holds the whole tensor (JAX's ``P()``)."""
    return (Replicate(), Replicate())
