"""Shared compute policy for the port's ops and kernels.

Precision on Hopper: everything on a parity path computes in IEEE fp32.
The hand-written kernels (``csrc/``) use plain fp32 FFMA, are built
without ``--use_fast_math`` (so ``sinf``/``cosf``/division stay
accurate) and never touch the tensor cores. The plain PyTorch versions
are run with ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: a TF32 product keeps about
three decimal digits, far outside the 1e-4 vertex gate. (The JAX
package's TPU policy — a 3-pass bf16 split, its ``Precision.HIGH`` — has
no counterpart here: fp32 FFMA is exact to f32 rounding already.)
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Tuple

import torch


def _versions(tensors) -> tuple:
    # Inference tensors keep no version counter (they cannot be updated
    # in place outside inference mode).
    return tuple(-1 if t.is_inference() else t._version for t in tensors)


class IdentityCache:
    """Values derived from an object, cached while that object lives and
    the tensors they were built from are unchanged.

    Keyed by identity (tensors and ``ManoParams`` compare elementwise or
    by identity, so a ``WeakKeyDictionary`` cannot hold tensors); an
    entry is dropped when its key object is collected. Each entry also
    records the ``_version`` counters of ``sources(obj)`` (by default the
    key itself, a tensor): an in-place update of any of them — an
    optimizer step on a parameter — rebuilds the value instead of serving
    a stale one. For per-asset packing that must not be redone per call.
    ``build`` must not return tensors that carry autograd history.
    """

    def __init__(self, sources=lambda obj: (obj,)):
        self._sources = sources
        self._entries: dict = {}
        self._lock = threading.Lock()

    def get(self, obj, build):
        key = id(obj)
        versions = _versions(self._sources(obj))
        with self._lock:
            hit = self._entries.get(key)
        if hit is not None and hit[0]() is obj and hit[1] == versions:
            return hit[2]
        value = build(obj)
        entries = self._entries

        def drop(_ref, key=key):
            entries.pop(key, None)

        with self._lock:
            self._entries[key] = (weakref.ref(obj, drop), versions, value)
        return value


@functools.lru_cache(maxsize=None)
def parents_tensor(parents: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """The kinematic tree as an int32 ``[J]`` tensor on ``device`` (one
    host copy per tree and device, ever)."""
    return torch.tensor(parents, dtype=torch.int32, device=device)


#: The largest kinematic tree the kernels' shared-memory tiles hold
#: (``kMaxJoints`` in ``csrc/mano_common.cuh``).
MAX_JOINTS = 64


def refuse_grad(what: str, instead: str, *tensors) -> None:
    """Raise if a raw kernel call would silently drop a gradient: under
    grad mode, none of ``tensors`` may require grad (the differentiable
    form is ``instead``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{what} is the inference only kernel call and records no "
            f"gradient; use {instead} for gradients")


def check_operands(want: dict, device: torch.device) -> None:
    """Raise unless every ``name: (tensor, shape)`` of ``want`` has that
    shape and is float32, contiguous and on ``device`` (the layout the
    kernels index)."""
    for name, (x, shape) in want.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name} must be {list(shape)}, got {list(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")


def cdiv(a: int, b: int) -> int:
    """Ceiling division (grid arithmetic of the kernel wrappers)."""
    return -(-a // b)


# Division guard for normalizations (normals, axis vectors). Safe for both
# f32 and f64 inputs: comfortably above denormals, far below any real
# geometric magnitude in meters.
EPS = 1e-12


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is requested (explicitly or by
    default) and absent — the port never falls back to the CPU on its
    own; pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; the port runs on the "
            "GPU by default — pass device='cpu' explicitly to run on the "
            "CPU")
    return dev
