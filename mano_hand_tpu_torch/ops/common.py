"""Shared compute policy for the port's ops and kernels.

Precision on Hopper: everything on a parity path computes in IEEE fp32.
The hand-written kernels (``csrc/``) are built without
``--use_fast_math`` (so ``sinf``/``cosf``/division stay accurate) and
run their f32 forms in plain fp32 FFMA, never on the tensor cores (only
the bf16 tier's contractions use them, below). The port's own float32
contractions go through ``einsum`` below, which pins IEEE fp32 for the
call (``ieee_fp32``) whatever the caller chose with
``torch.set_float32_matmul_precision``: a TF32 product keeps about three
decimal digits, far outside the 1e-4 vertex gate. The guard holds in
the backward too: ``einsum``'s own gradients (the plain path's
``loss.backward()``) and the kernel routes' backward functions run
under it. (The JAX
package pins this with an explicit ``precision=`` on every contraction;
its TPU policy — a 3-pass bf16 split — has no counterpart here: fp32
FFMA is exact to f32 rounding already.)

The one reduced-precision form is the bf16 serving tier
(``compute_dtype=torch.bfloat16``): contraction operands rounded to bf16
(``round_bf16``) and products accumulated in f32. A product of two bf16
values is exact in f32, so "round, cast back, contract in f32" is that
form exactly, on either device; K2's bf16 kernel runs those contractions
on bf16 tensor cores with f32 accumulation.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Tuple

import torch

from mano_hand_tpu_torch.obs import spans


# ------------------------------------------------------------ IEEE fp32 pin
# The float32 matmul setting is process-global (cuBLAS reads it when an op
# is enqueued), so the guard is reference-counted across threads: the
# first thread in sets IEEE and the last one out restores the caller's
# setting, and a guard never lowers another thread's precision (a caller's
# concurrent matmuls run IEEE while one is open: slower, never less
# exact). The setting is read and restored through the API it was set
# with: mixing torch's legacy and per-backend APIs makes later reads raise.
_ieee_lock = threading.Lock()
_ieee_depth = 0
_ieee_saved = None   # (api, caller's value, value set) while a guard is open


def _matmul_precision() -> tuple:
    """(api, value) of the caller's float32 matmul setting."""
    try:
        return "legacy", torch.get_float32_matmul_precision()
    except RuntimeError:   # set through torch.backends.cuda.matmul
        return "backend", torch.backends.cuda.matmul.fp32_precision


def _set_matmul_precision(api: str, value: str) -> None:
    if api == "legacy":
        torch.set_float32_matmul_precision(value)
    else:
        torch.backends.cuda.matmul.fp32_precision = value


@contextlib.contextmanager
def ieee_fp32():
    """Pin IEEE fp32 for float32 matmuls inside the block (no TF32, no
    bf16 passes), whatever ``torch.set_float32_matmul_precision`` the
    caller chose; restored on exit. Reentrant and thread-safe."""
    global _ieee_depth, _ieee_saved
    with _ieee_lock:
        if _ieee_depth == 0:
            api, value = _matmul_precision()
            target = "highest" if api == "legacy" else "ieee"
            if value != target:
                _set_matmul_precision(api, target)
                _ieee_saved = (api, value, target)
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0 and _ieee_saved is not None:
                api, value, target = _ieee_saved
                _ieee_saved = None
                # A caller that changed the setting meanwhile keeps theirs.
                if _matmul_precision() == (api, target):
                    _set_matmul_precision(api, value)


class _IeeeEinsum(torch.autograd.Function):
    """``torch.einsum`` with its forward and its backward under
    ``ieee_fp32``. The backward re-runs the forward under autograd and
    asks it for the operand gradients, so they are the very operations
    (and, on the CPU, the very bits) of ``torch.einsum``'s own backward;
    only the matmul setting they run under is pinned. Under
    ``create_graph`` the gradients carry torch's own graph, whose second
    backward is not pinned."""

    @staticmethod
    def forward(ctx, equation, *operands):
        ctx.equation = equation
        ctx.save_for_backward(*operands)
        with ieee_fp32():
            return torch.einsum(equation, *operands)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        create = torch.is_grad_enabled()
        with torch.enable_grad(), ieee_fp32():
            leaves = [o if create else o.detach().requires_grad_(n)
                      for o, n in zip(ctx.saved_tensors, needs)]
            wanted = [x for x, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad(
                torch.einsum(ctx.equation, *leaves), wanted, grad,
                create_graph=create, allow_unused=True))
        return (None, *(next(got) if n else None for n in needs))


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` under ``ieee_fp32``, forward and backward: the
    port's contractions."""
    if torch.is_grad_enabled() and any(o.requires_grad for o in operands):
        return _IeeeEinsum.apply(equation, *operands)
    with ieee_fp32():
        return torch.einsum(equation, *operands)


def check_compute_dtype(compute_dtype) -> None:
    """Raise unless ``compute_dtype`` is None (fp32) or ``torch.bfloat16``
    (the bf16 serving tier) — the only two forms with a stated error."""
    if compute_dtype is not None and compute_dtype != torch.bfloat16:
        raise ValueError(
            f"compute_dtype must be torch.bfloat16 (the serving bf16 tier) "
            f"or None, got {compute_dtype}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even), as float32: a contraction
    operand of the bf16 tier."""
    return x.to(torch.bfloat16).to(torch.float32)


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
    ``build`` must not return tensors that carry autograd history. A
    tuple key (a pair of assets) is keyed on every object in it and
    dropped when any of them is collected.
    """

    def __init__(self, sources=lambda obj: (obj,)):
        self._sources = sources
        self._entries: dict = {}
        self._lock = threading.Lock()

    def get(self, obj, build):
        objs = obj if isinstance(obj, tuple) else (obj,)
        key = tuple(map(id, objs))
        versions = _versions(self._sources(obj))
        with self._lock:
            hit = self._entries.get(key)
        if (hit is not None and hit[1] == versions
                and all(ref() is o for ref, o in zip(hit[0], objs))):
            return hit[2]
        with spans.span(spans.PACK):
            value = build(obj)
        if tracing():
            return value
        entries = self._entries

        def drop(_ref, key=key):
            entries.pop(key, None)

        refs = tuple(weakref.ref(o, drop) for o in objs)
        with self._lock:
            entries[key] = (refs, versions, value)
        return value


def tracing() -> bool:
    """True while this thread traces under fake tensors (``torch.export``,
    ``torch.compile``) or its stream captures a CUDA graph. A tensor made
    then is a fake, or memory that only the graph's replays write: no
    cache may keep it (an eager call would read it later). Both tests are
    of this thread only (``torch.compiler.is_compiling`` is
    process-wide)."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class _CaptureLog(threading.local):
    log = None


_capture_log = _CaptureLog()
_launch_lock = threading.Lock()


@contextlib.contextmanager
def captured_launches():
    """Collect, as a list of (module, counter name), the kernel launches
    this thread's wrappers enqueue into a CUDA graph it captures in the
    block. A capture runs no kernel: the wrappers note each launch there
    instead of counting it (``count_launch``), and whoever replays the
    graph adds them per replay (``add_launches``)."""
    prev, _capture_log.log = _capture_log.log, []
    try:
        yield _capture_log.log
    finally:
        _capture_log.log = prev


def count_launch(module, name: str) -> None:
    """Add one to the launch counter ``module.name`` — unless this
    thread is capturing under ``captured_launches``, which notes it. Every
    kernel wrapper counts here, beside the ``mano.launch.*`` span it
    opens around the launch (``obs/spans.py``)."""
    log = _capture_log.log
    if log is not None and tracing():
        log.append((module, name))
        return
    with _launch_lock:
        setattr(module, name, getattr(module, name) + 1)


def add_launches(log) -> None:
    """Count the launches one replay of a captured graph made."""
    with _launch_lock:
        for module, name in log:
            setattr(module, name, getattr(module, name) + 1)


_constants: dict = {}
_constants_lock = threading.Lock()


def _constant(key, make) -> torch.Tensor:
    """``make()``, kept under ``key`` unless it was made while tracing
    or capturing (``tracing``), or is not a plain tensor."""
    with _constants_lock:
        t = _constants.get(key)
    if t is not None:
        return t
    t = make()
    if type(t) is not torch.Tensor or tracing():
        return t
    with _constants_lock:
        return _constants.setdefault(key, t)


def parents_tensor(parents: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """The kinematic tree as an int32 ``[J]`` tensor on ``device`` (one
    host copy per tree and device, ever)."""
    parents = tuple(parents)
    return _constant(("parents", parents, torch.device(device)),
                     lambda: torch.tensor(parents, dtype=torch.int32,
                                          device=device))


def index_tensor(ids: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A static index list as an int64 tensor on ``device``, made once per
    list and device: a per-call host-to-device copy would make every call
    wait for the device."""
    ids = tuple(ids)
    return _constant(("index", ids, torch.device(device)),
                     lambda: torch.tensor(ids, dtype=torch.long,
                                          device=device))


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


def operand(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` converted to ``dtype`` (None: its own) and made contiguous,
    as a kernel reads it: ``x`` itself where nothing has to change, else
    one copy a step, each a device operation under a ``mano.copy`` span."""
    if dtype is not None and x.dtype != dtype:
        with spans.span(spans.COPY):
            x = x.to(dtype)
    if not x.is_contiguous():
        with spans.span(spans.COPY):
            x = x.contiguous()
    return x


def subject_rows(subject_idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """Table rows of subject indices: ``i + capacity`` for a negative
    ``i`` (Python-style), then clamped to ``[0, capacity - 1]`` — the
    JAX package's XLA gather (``core.forward_posed_gather``). int64."""
    rows = subject_idx.long()
    return torch.where(rows < 0, rows + capacity, rows).clamp(0, capacity - 1)


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
