"""K3: batched linear blend skinning in one CUDA launch, and its VJP.

Replaces the TPU kernel ``mano_hand_tpu/ops/pallas_lbs.py:skin_batched``
(``pallas_call`` at line 107) and its custom VJP ``skin_batched_ad``
(lines 124-181). Per row ``b`` and vertex ``v``:

    out[b, v] = (sum_j W[v, j] R[b, j]) @ v_posed[b, v] + sum_j W[v, j] t[b, j]

without materialising the blended ``[B, V, 3, 3]`` matrices. The kernel
(``csrc/skin.cu``) stages a tile of rows' ``(R, t)`` and a tile of
vertices' weights in shared memory; each thread owns 4 adjacent vertices
of a row, and each warp reads and writes its row's run of 128 vertices as
coalesced wide accesses through a shared-memory slot.

What bounds it on an H100: bytes. Per row it reads ``v_posed`` and
writes the vertices (18.7 KB at MANO width) against about 0.31 MFLOP, so
some 16 FLOP a byte, just below the card's fp32 ridge (about 20).

Two options serve the backward: ``transpose_r=True`` skins with each
``R_j^T`` and ``t=None`` drops the translation term. The kernel reads the
rotations as they are, so neither builds a copy.

``skin_batched_ad`` is the differentiable form. Its backward follows
``pallas_lbs._skin_bwd``: LBS is linear in ``v_posed`` with the blended
matrix M, so ``dL/dv_posed = M^T g`` is the same kernel run with
``transpose_r=True`` and ``t=None``; the ``R``, ``t`` and ``W``
cotangents are plain einsums (XLA einsums outside the kernel in JAX too).
The backward of the fused routes (``ops/fused_forward.py``) takes its
vertex cotangent from this kernel as well.

``skin_batched_plain`` is ``ops/lbs.skin`` over the same operands: the
CPU path and the kernel's reference on the card.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from mano_hand_tpu_torch.ops import _build, lbs
from mano_hand_tpu_torch.ops.common import (
    MAX_JOINTS, check_operands, einsum, refuse_grad,
)

#: Kernel launches so far (the main-path evidence; reset it to 0 freely).
launches = 0
_count_lock = threading.Lock()


def skin_batched_plain(weights: torch.Tensor, rot: torch.Tensor,
                       t: Optional[torch.Tensor], v_posed: torch.Tensor, *,
                       transpose_r: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [B, V, 3]. With
    ``transpose_r`` it skins with ``rot.transpose(-1, -2)``; ``t=None``
    stands for zero translations."""
    if transpose_r:
        rot = rot.transpose(-1, -2)
    if t is None:
        t = rot.new_zeros(rot.shape[:-1])
    return lbs.skin(weights, rot, t, v_posed)


def _check(weights, rot, t, v_posed):
    refuse_grad("skin_batched", "skin_batched_ad", weights, rot, v_posed,
                *(() if t is None else (t,)))
    if weights.ndim != 2:
        raise ValueError(f"weights must be [V, J], got {tuple(weights.shape)}")
    (v, j), b = weights.shape, v_posed.shape[0]
    if j > MAX_JOINTS:
        raise ValueError(f"the kernel takes at most {MAX_JOINTS} joints, "
                         f"got {j}")
    operands = {"weights": (weights, (v, j)), "rot": (rot, (b, j, 3, 3)),
                "v_posed": (v_posed, (b, v, 3))}
    if t is not None:
        operands["t"] = (t, (b, j, 3))
    check_operands(operands, v_posed.device)


def skin_batched(weights: torch.Tensor, rot: torch.Tensor,
                 t: Optional[torch.Tensor], v_posed: torch.Tensor, *,
                 transpose_r: bool = False) -> torch.Tensor:
    """Batched LBS [B, V, 3]: ``weights`` [V, J], ``rot`` [B, J, 3, 3],
    ``t`` [B, J, 3] or None (no translation term), ``v_posed`` [B, V, 3],
    float32 and contiguous on one device; ``transpose_r`` skins with each
    ``R_j^T`` (read in place: no copy). A CPU tensor runs
    ``skin_batched_plain``; a CUDA tensor launches the kernel (or raises).
    Records no gradient: see ``skin_batched_ad``."""
    _check(weights, rot, t, v_posed)
    dev = v_posed.device
    if dev.type == "cpu":
        return skin_batched_plain(weights, rot, t, v_posed,
                                  transpose_r=transpose_r)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, v = v_posed.shape[:2]
    out = torch.empty((b, v, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mano_skin(weights.data_ptr(), rot.data_ptr(),
                           None if t is None else t.data_ptr(),
                           v_posed.data_ptr(), out.data_ptr(), b, v,
                           weights.shape[1], int(transpose_r), stream)
    _build.check(lib, rc, "skin")
    global launches
    with _count_lock:
        launches += 1
    return out


def skin_vjp(weights, rot, t, v_posed, g, needs):
    """Cotangents ``(weights, rot, t, v_posed)`` of ``skin_batched`` for
    the output cotangent ``g`` [B, V, 3], each None unless ``needs`` asks
    for it (``pallas_lbs._skin_bwd``): the vertex cotangent through the
    kernel with ``R^T`` and no translation (``rot`` read in place, so it
    must be contiguous), the rest as einsums. The largest
    intermediate is ``g ⊗ v_posed`` [B, V, 3, 3], built only for the
    ``rot`` or ``weights`` cotangent."""
    need_w, need_rot, need_t, need_vp = needs
    g = g.contiguous()
    grad_vp = grad_rot = grad_t = grad_w = None
    if need_vp:
        grad_vp = skin_batched(weights, rot, None, g, transpose_r=True)
    if need_rot or need_w:
        outer = g[..., :, None] * v_posed[..., None, :]
        if need_rot:
            grad_rot = einsum("vj,bvac->bjac", weights, outer)
        if need_w:
            grad_w = (einsum("bvac,bjac->vj", outer, rot)
                      + einsum("bva,bja->vj", g, t))
    if need_t:
        grad_t = einsum("vj,bva->bja", weights, g)
    return grad_w, grad_rot, grad_t, grad_vp


class SkinBatched(torch.autograd.Function):
    """``skin_batched`` with its VJP (``pallas_lbs.skin_batched_ad``)."""

    @staticmethod
    def forward(ctx, weights, rot, t, v_posed):
        ctx.save_for_backward(weights, rot, t, v_posed)
        return skin_batched(weights, rot, t, v_posed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return skin_vjp(*ctx.saved_tensors, g, needs=ctx.needs_input_grad)


def skin_batched_ad(weights: torch.Tensor, rot: torch.Tensor,
                    t: torch.Tensor, v_posed: torch.Tensor) -> torch.Tensor:
    """Differentiable ``skin_batched``: the kernel forward, and a backward
    whose vertex cotangent is the kernel again (once differentiable)."""
    return SkinBatched.apply(weights, rot, t, v_posed)
