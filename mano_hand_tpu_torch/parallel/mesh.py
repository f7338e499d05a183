"""Devices for the serving engine's dispatch lanes.

The port of ``lane_devices`` from the JAX package's ``parallel/mesh.py``;
the meshes and sharded forwards there are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mano_hand_tpu_torch.ops.common import resolve_device


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
