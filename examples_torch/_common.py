"""What the port's examples share: the ``--device`` flag, and the dense
layers of the two training examples (11, 13) in flax's layout.

``--device`` replaces the JAX examples' ``--platform``: ``cuda`` (the
default) or ``cpu``. An example never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; 'cpu' "
                         "runs on the CPU)")


def example_device(name: str) -> torch.device:
    """The device ``--device`` names. Raises when it names CUDA and there
    is none: pass ``--device cpu`` to run on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available, and the examples run on the GPU "
            "by default: pass --device cpu to run on the CPU")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (before reading a clock)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_dense_(layer: torch.nn.Linear, gen: torch.Generator) -> None:
    """flax ``nn.Dense``'s default initialisation, drawn from ``gen``: a
    LeCun-normal kernel (variance 1 / fan_in, truncated at two standard
    deviations and rescaled as ``jax.nn.initializers.lecun_normal``) and
    a zero bias."""
    fan_in = layer.weight.shape[1]
    # The standard deviation of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w = torch.nn.init.trunc_normal_(
            torch.empty(layer.weight.shape), std=std, a=-2 * std, b=2 * std,
            generator=gen)
        layer.weight.copy_(w)
        layer.bias.zero_()


def load_dense_(layers, dense: dict) -> None:
    """Copy JAX-layout Dense weights into ``layers`` (``torch.nn.Linear``,
    in flax's creation order): ``dense["Dense_i"]`` holds numpy
    ``kernel`` [in, out] (``weight`` [out, in] here) and ``bias`` [out]."""
    with torch.no_grad():
        for i, layer in enumerate(layers):
            d = dense[f"Dense_{i}"]
            layer.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(np.asarray(d["kernel"], np.float32).T)))
            layer.bias.copy_(torch.from_numpy(
                np.asarray(d["bias"], np.float32)))
