"""K1, K5 and K4: the batched MANO forward in one CUDA launch, for one
hand or for both at once, and the shared backward of the two fused routes.

K1 replaces the TPU kernel ``mano_hand_tpu/ops/pallas_forward.py:
forward_verts_fused_full`` (``pallas_call`` at line 723). The kernel
(``csrc/fused_forward.cu``) computes, per block of a row tile and a span
of vertex tiles: Rodrigues, the shaped rest joints ``[beta | 1] . jb``,
FK along ``parents`` and the inverse bind once, then for each vertex
tile the blend ``[beta | 1 | (R - I)] . basis`` as a register-tiled
product over basis chunks streamed into shared memory, with linear blend
skinning as its epilogue, writing ``[B, V, 3]`` fp32. It reads the basis
and weights in a vertex-tiled layout (``basis_tiles``, ``wt_tiles``),
built by ``_pack``.

K5 replaces ``pallas_forward.py:forward_verts_fused_full_hands``
(``pallas_call`` at line 830): K1 for several hands of a
``StackedParams`` in one launch, ``[H, B, V, 3]``. It is the same kernel
with a hand grid axis over per-hand operands (``forward_verts_fused_
full_hands``); K1 is its one-hand launch. Inference only.

K4 replaces ``pallas_forward.py:blend_skin_fused`` (``pallas_call`` at
lines 228 and 239): the blend and the skinning in one launch, fed the
per-row coefficients and skinning transforms by the small PyTorch
``pre_stage`` (Rodrigues, shaped joints, FK, inverse bind;
``pallas_forward.py:_pre_stage``). It is K1's kernel with a loader of
those rows in place of the prelude (``csrc/fused_forward.cu``: both
inline one phase D), reading the same tiled operands.

What bounds all three on an H100: fp32 operations (about 1 MFLOP a row
against 9.3 KB written — see the source notes in the ``.cu`` files).
They keep v_posed on chip and use plain fp32 FFMA, register tiles and a
shared-memory basis ring.

Gradients: ``forward_verts_fused_ad`` (K4 forward) and
``forward_verts_fused_full_ad`` (K1 forward) are autograd Functions with
one backward, ``pallas_forward.py:_bwd``: the pre-stage re-runs under
autograd, the vertex cotangent comes from the skinning kernel K3
(``ops/fused_skin.py``) with ``R^T`` and no translation, the coefficient
cotangent from one product with the packed basis, and the parameter
cotangents (``v_template``, ``shape_basis``, ``pose_basis``,
``j_regressor``, ``lbs_weights``) only where autograd asks for them.
``forward_verts_fused_full_chunked_ad`` is K1 over a huge batch a chunk
a launch, each chunk written into its rows of one output, with the same
backward run a chunk at a time.

Operand prep is cached per ``ManoParams`` object and rebuilt on the
params' device when one of its tensors changes in place: the packed
basis (rows: shape basis, template, pose basis in the reference's
row-major (R - I) order, zero padding to a multiple of 4) and the weights
in the kernels' vertex-tiled layout (``basis_tiles``, ``wt_tiles``), and
the joint basis ``[J, 3, S + 1]`` (last column the template joints). A
repack never goes through the host: at MANO width the tiled basis is
1.59 MB, and zeroing its buffer, copying the parts in and cutting it
into tiles moves about 8 MB on the card. The untiled ``basis`` [Kpad,
3, V] and ``wt`` [J, V] that the plain versions and the backward read
are built from the tiles on first use.

``forward_verts_plain`` and ``blend_skin_plain`` are the same arithmetic
in plain PyTorch over the same operands: the CPU path and the kernels'
references on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from mano_hand_tpu_torch.assets.schema import FORWARD_FIELDS, ManoParams
from mano_hand_tpu_torch.obs import spans
from mano_hand_tpu_torch.ops import _build, fk, fused_skin, lbs
from mano_hand_tpu_torch.ops.common import (
    MAX_JOINTS, IdentityCache, cdiv, check_operands, count_launch, einsum,
    ieee_fp32, operand, parents_tensor, refuse_grad, tracing,
)
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix

#: K1 launches so far (the main-path evidence; reset it to 0 freely).
launches = 0
#: K4 launches so far.
blend_skin_launches = 0
#: K5 (several hands in one launch) launches so far.
hands_launches = 0
#: Chunks ``forward_verts_fused_full_chunked_ad`` wrote straight into
#: their rows of its one output.
chunks_in_place = 0
#: K1 and K5 launches by the row tile the kernel took (64, 32, 16 or 8
#: rows: ``csrc/tiled_phase_d.cuh:with_row_tile``, as the launch reports
#: it): large batches of MANO take 64, SMPL-X's widths 16 at most.
tile_rows_64 = tile_rows_32 = tile_rows_16 = tile_rows_8 = 0

#: (launch counter, span) of the one kernel's two launches: one hand (K1)
#: and several (K5).
_K1 = ("launches", spans.LAUNCH_K1)
_K5 = ("hands_launches", spans.LAUNCH_K5)


#: Vertices of one tile of the kernels' operands (``kVertTile`` in
#: ``csrc/fused_forward.cu``).
VERT_TILE = 128


@dataclasses.dataclass(frozen=True, eq=False)
class FusedOperands:
    """The packed operands of one hand, or of several (K5) with a leading
    hand axis on ``basis_tiles``, ``wt_tiles`` and ``jb``.

    The basis and the weights are kept once, in the kernels' vertex-tiled
    layout (V zero-padded to whole tiles of ``VERT_TILE``, one contiguous
    block per tile). ``basis`` [(H,) Kpad, 3, V] and ``wt`` [(H,) J, V],
    which the plain versions and the backward's products read, are built
    from the tiles on first use and kept with them."""

    jb: torch.Tensor            # [(H,) J, 3, S + 1] f32
    parents: torch.Tensor       # [J] int32 (shared by the hands)
    parents_tuple: Tuple[int, ...]
    n_coef: int                 # K = S + 1 + 9 (J - 1), before padding
    n_verts: int
    basis_tiles: torch.Tensor   # [(H,) nsub, Kpad, 3, VERT_TILE] f32
    wt_tiles: torch.Tensor      # [(H,) nsub, J, VERT_TILE] f32
    _untiled: dict = dataclasses.field(init=False, default_factory=dict,
                                       repr=False)

    def _untile(self, name: str) -> torch.Tensor:
        return memo(self._untiled, name, lambda: untile_verts(
            getattr(self, name + "_tiles"), self.n_verts, self.jb.ndim - 3))

    @property
    def basis(self) -> torch.Tensor:
        """[(H,) Kpad, 3, V]: rows shape basis, template, pose basis in the
        reference's row-major (R - I) order, zero padding."""
        return self._untile("basis")

    @property
    def wt(self) -> torch.Tensor:
        """[(H,) J, V]: the skinning weights, transposed."""
        return self._untile("wt")

    @property
    def n_joints(self) -> int:
        return self.wt_tiles.shape[-2]

    @property
    def n_shape(self) -> int:
        return self.jb.shape[-1] - 1

    @property
    def kpad(self) -> int:
        return self.basis_tiles.shape[-3]

    def hand(self, h: int) -> "FusedOperands":
        """Hand ``h`` of stacked operands (views)."""
        return dataclasses.replace(
            self, jb=self.jb[h], basis_tiles=self.basis_tiles[h],
            wt_tiles=self.wt_tiles[h])


def memo(cache: dict, name: str, build) -> torch.Tensor:
    """``cache[name]``, built by ``build()`` on first use (the untiled
    forms kept beside a pack's tiles)."""
    got = cache.get(name)
    if got is None:   # a race builds it twice, equal: harmless
        got = build()
        if not tracing():
            cache[name] = got
    return got


def vert_buffer(lead, n_verts: int, dtype, device) -> torch.Tensor:
    """A zeroed [*lead, nsub VERT_TILE] buffer: V padded to whole tiles,
    for an operand's parts to be copied into before ``tile_verts``."""
    return torch.zeros((*lead, cdiv(n_verts, VERT_TILE) * VERT_TILE),
                       dtype=dtype, device=device)


def tile_verts(flat: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """[..., nsub VERT_TILE, ...] (the vertex axis ``dim``, V zero-padded
    to whole tiles) into the kernels' vertex-tiled layout [nsub, ...,
    VERT_TILE, ...]: one contiguous block per tile. ``untile_verts``
    inverts it for ``dim = -1``."""
    dim %= flat.ndim
    return flat.unflatten(dim, (-1, VERT_TILE)).movedim(dim, 0).contiguous()


def untile_verts(tiles: torch.Tensor, n_verts: int,
                 lead: int = 0) -> torch.Tensor:
    """The kernels' vertex-tiled layout [*lead, nsub, ..., VERT_TILE]
    (``lead`` leading axes, the hands; V zero-padded to whole tiles) back
    to [*lead, ..., V], contiguous."""
    x = tiles.movedim(lead, -2).flatten(-2)
    return x[..., :n_verts].contiguous()


def _pack(params) -> FusedOperands:
    # Packed on the params' device straight into the tiled layout: one
    # zeroed buffer [Kpad, 3, nsub VERT_TILE] whose parts are copied in
    # (converted to float32 by the copy), then cut into tiles.
    # The joint products are taken in float64 so the packing adds no
    # rounding of its own. No library contraction of the kernels' own work
    # runs here: these are per-asset constants.
    shape_basis = params.shape_basis.detach()           # [V, 3, S]
    pose_basis = params.pose_basis.detach()             # [V, 3, P]
    v, _, s = shape_basis.shape
    k = s + 1 + pose_basis.shape[-1]
    kpad = cdiv(k, 4) * 4
    f32, dev = torch.float32, params.device
    flat = vert_buffer((kpad, 3), v, f32, dev)
    flat[:s, :, :v] = shape_basis.permute(2, 1, 0)
    flat[s, :, :v] = params.v_template.detach().T
    flat[s + 1:k, :, :v] = pose_basis.permute(2, 1, 0)
    wflat = vert_buffer((params.n_joints,), v, f32, dev)
    wflat[:, :v] = params.lbs_weights.detach().T
    j_reg = params.j_regressor.detach().to(torch.float64)   # [J, V]
    jt = j_reg @ params.v_template.detach().to(torch.float64)   # [J, 3]
    jsb = einsum("jv,vcs->jcs", j_reg, shape_basis.to(torch.float64))
    jb = torch.cat([jsb, jt[..., None]], dim=-1)
    return FusedOperands(
        jb=jb.float().contiguous(),
        parents=parents_tensor(tuple(params.parents), dev),
        parents_tuple=tuple(params.parents),
        n_coef=k,
        n_verts=v,
        basis_tiles=tile_verts(flat),
        wt_tiles=tile_verts(wflat),
    )


_operands = IdentityCache(sources=ManoParams.forward_tensors)


def fused_operands(params) -> FusedOperands:
    """The packed, batch-invariant operands of ``params`` (cached while
    its tensors are unchanged)."""
    return _operands.get(params, _pack)


def _pack_hands(stacked) -> FusedOperands:
    per = [_pack(hand) for hand in stacked.hands]
    return dataclasses.replace(per[0], **{
        f: torch.stack([getattr(o, f) for o in per])
        for f in ("jb", "basis_tiles", "wt_tiles")})


# Keyed on the stacked tensors' versions: the hands are views of them, so
# an in-place update of either hand repacks.
_hand_operands = IdentityCache(sources=lambda s: s.forward_tensors())


def fused_operands_hands(stacked) -> FusedOperands:
    """The packed operands of every hand of a ``StackedParams``, each
    hand packed as ``fused_operands`` packs it, stacked on a leading hand
    axis (cached while the stacked tensors are unchanged)."""
    return _hand_operands.get(stacked, _pack_hands)


def coefficients(rot: torch.Tensor, shape: torch.Tensor,
                 kpad: int) -> torch.Tensor:
    """The per-row blend coefficients ``[beta | 1 | (R - I) | 0]``
    [B, kpad] in the packed basis' row order."""
    b = rot.shape[0]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    feat = (rot[:, 1:] - eye).flatten(1)
    pad = kpad - shape.shape[1] - 1 - feat.shape[1]
    return torch.cat([shape, shape.new_ones(b, 1), feat,
                      shape.new_zeros(b, pad)], dim=1)


def pre_stage(parents: Tuple[int, ...], jt: torch.Tensor, jsb: torch.Tensor,
              pose: torch.Tensor, shape: torch.Tensor, kpad: int):
    """The small per-row stage before K4 (``pallas_forward._pre_stage``):
    Rodrigues, the shaped rest joints ``jt + jsb . beta``, FK and the
    inverse bind. Returns (coefficients [B, kpad], skinning rotations
    [B, J, 3, 3], skinning translations [B, J, 3]); differentiable."""
    rot = rotation_matrix(pose)                           # [B, J, 3, 3]
    joints = jt + einsum("jcs,bs->bjc", jsb, shape)
    world_rot, world_t = fk.forward_kinematics(parents, rot, joints)
    skin_rot, skin_t = fk.skinning_transforms(world_rot, world_t, joints)
    return coefficients(rot, shape, kpad), skin_rot, skin_t


def _packed_pre_stage(ops: FusedOperands, pose, shape):
    s = ops.n_shape
    return pre_stage(ops.parents_tuple, ops.jb[..., s], ops.jb[..., :s],
                     pose, shape, ops.kpad)


def blend_skin_plain(ops: FusedOperands, coef: torch.Tensor,
                     skin_rot: torch.Tensor,
                     skin_t: torch.Tensor) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch: [B, V, 3]."""
    v_posed = einsum("bk,kcv->bvc", coef, ops.basis)
    return lbs.skin(ops.wt.T, skin_rot, skin_t, v_posed)


def forward_verts_plain(ops: FusedOperands, pose: torch.Tensor,
                        shape: torch.Tensor) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch: [B, V, 3]."""
    return blend_skin_plain(ops, *_packed_pre_stage(ops, pose, shape))


def forward_verts_hands_plain(ops: FusedOperands, pose: torch.Tensor,
                              shape: torch.Tensor) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch over stacked operands: pose
    [H, B, J, 3], shape [H, B, S] -> [H, B, V, 3]."""
    return torch.stack([forward_verts_plain(ops.hand(h), pose[h], shape[h])
                        for h in range(pose.shape[0])])


def _check(ops: FusedOperands, pose: torch.Tensor, shape: torch.Tensor):
    b, j, s = pose.shape[0], ops.n_joints, ops.n_shape
    if tuple(pose.shape) != (b, j, 3):
        raise ValueError(f"pose must be [B, {j}, 3], got {tuple(pose.shape)}")
    if tuple(shape.shape) != (b, s):
        raise ValueError(f"shape must be [{b}, {s}], got {tuple(shape.shape)}")
    for name, t in (("pose", pose), ("shape", shape)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != ops.basis_tiles.device:
            raise ValueError(
                f"{name} is on {t.device} but the params are on "
                f"{ops.basis_tiles.device}")
    check_tree(ops.parents_tuple)


def check_tree(parents: Tuple[int, ...]) -> None:
    """Raise unless the kernels' FK loop can walk ``parents``: at most
    ``MAX_JOINTS`` joints, root first, every parent before its child."""
    if len(parents) > MAX_JOINTS:
        raise ValueError(f"the kernel takes at most {MAX_JOINTS} joints, "
                         f"got {len(parents)}")
    if parents[0] != -1 or any(not 0 <= p < j
                               for j, p in enumerate(parents) if j):
        raise ValueError(
            f"the kernel needs a topologically ordered tree (root -1 "
            f"first, parents[j] < j), got {parents}")


def forward_verts_fused_full(params, pose: torch.Tensor,
                             shape: torch.Tensor) -> torch.Tensor:
    """Batched vertices [B, V, 3] with the whole forward in one launch
    (K1).

    ``pose`` [B, J, 3] and ``shape`` [B, S], float32, on the params'
    device. A CPU tensor runs ``forward_verts_plain``; a CUDA tensor
    launches the kernel (or raises). Records no gradient: see
    ``forward_verts_fused_full_ad``.
    """
    refuse_grad("forward_verts_fused_full", "forward_verts_fused_full_ad",
                pose, shape, *params.forward_tensors())
    ops = fused_operands(params)
    _check(ops, pose, shape)
    if pose.device.type == "cpu":
        return forward_verts_plain(ops, pose, shape)
    if pose.shape[0] == 0:
        return pose.new_empty((0, ops.n_verts, 3))
    return _launch_forward(ops, pose[None], shape[None])[0]


def _launch_forward(ops: FusedOperands, pose: torch.Tensor,
                    shape: torch.Tensor, split: int = 0,
                    kernel=_K1, out=None) -> torch.Tensor:
    """One launch of the K1/K5 kernel over H hands: pose [H, B, J, 3],
    shape [H, B, S] -> [H, B, V, 3] with B >= 1; ``ops`` is one hand's
    (H = 1) or stacked. ``split``: vertex spans per row tile (0: the
    kernel's choice from B). ``kernel``: ``_K1`` or ``_K5``, the counter
    and span of the launch. ``out``: where the kernel writes, [H, B, V,
    3] float32 and contiguous on the operands' device (a row slice of a
    larger output is one); None allocates it. Raises on a non-CUDA
    device or a failed launch."""
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    pose, shape = operand(pose), operand(shape)
    h, b, v = pose.shape[0], pose.shape[1], ops.n_verts
    if out is None:
        out = torch.empty((h, b, v, 3), dtype=torch.float32, device=dev)
    else:
        check_operands({"out": (out, (h, b, v, 3))}, ops.basis_tiles.device)
    lib = _build.load()
    counter, name = kernel
    rows = ctypes.c_int(0)
    with torch.cuda.device(dev), spans.span(name):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mano_fused_forward(
            pose.data_ptr(), shape.data_ptr(), ops.basis_tiles.data_ptr(),
            ops.wt_tiles.data_ptr(), ops.jb.data_ptr(),
            ops.parents.data_ptr(), out.data_ptr(), h, b, v, ops.n_joints,
            ops.n_shape, ops.kpad, split, stream, ctypes.byref(rows))
    _build.check(lib, rc, "fused_forward")
    module = sys.modules[__name__]
    count_launch(module, counter)
    count_launch(module, f"tile_rows_{rows.value}")
    return out


def forward_verts_fused_full_hands(stacked, pose: torch.Tensor,
                                   shape: torch.Tensor) -> torch.Tensor:
    """Every hand's vertices [H, B, V, 3] in one launch (K5).

    ``stacked`` is a ``StackedParams`` (``core.stack_params``); ``pose``
    [H, B, J, 3] (or flat [H, B, J * 3]) and ``shape`` [H, B, S],
    float32, on its device. A CPU tensor runs
    ``forward_verts_hands_plain``; a CUDA tensor launches the kernel (or
    raises). Inference only: refuses grad-requiring inputs.
    """
    refuse_grad("forward_verts_fused_full_hands", "core.forward_hands",
                pose, shape, *stacked.forward_tensors())
    ops = fused_operands_hands(stacked)
    h, j, s = stacked.n_hands, ops.n_joints, ops.n_shape
    if pose.ndim == 3 and pose.shape[-1] == 3 * j:
        pose = pose.reshape(pose.shape[0], pose.shape[1], j, 3)
    if pose.ndim != 4 or pose.shape[0] != h:
        raise ValueError(
            f"pose must be [{h}, B, {j}, 3] (or flat [{h}, B, {3 * j}]), "
            f"got {tuple(pose.shape)}")
    b = pose.shape[1]
    if tuple(shape.shape) != (h, b, s):
        raise ValueError(f"shape must be [{h}, {b}, {s}], got "
                         f"{tuple(shape.shape)}")
    _check(ops, pose.flatten(0, 1), shape.flatten(0, 1))
    if pose.device.type == "cpu":
        return forward_verts_hands_plain(ops, pose, shape)
    if b == 0:
        return pose.new_empty((h, 0, ops.n_verts, 3))
    return _launch_forward(ops, pose, shape, kernel=_K5)


def blend_skin_fused(ops: FusedOperands, coef: torch.Tensor,
                     skin_rot: torch.Tensor,
                     skin_t: torch.Tensor) -> torch.Tensor:
    """Blend + skin in one launch (K4): [B, V, 3] from the coefficients
    ``coef`` [B, Kpad] (``coefficients`` order; 16-byte aligned on the
    card, as a fresh tensor is) and the skinning transforms ``skin_rot``
    [B, J, 3, 3], ``skin_t`` [B, J, 3], float32 and contiguous on the
    operands' device. A CPU tensor runs ``blend_skin_plain``; a CUDA
    tensor launches the kernel (or raises). Records no gradient."""
    refuse_grad("blend_skin_fused", "forward_verts_fused_ad", coef,
                skin_rot, skin_t)
    b, j = coef.shape[0], ops.n_joints
    check_operands({"coef": (coef, (b, ops.kpad)),
                    "skin_rot": (skin_rot, (b, j, 3, 3)),
                    "skin_t": (skin_t, (b, j, 3))}, ops.basis_tiles.device)
    dev = coef.device
    if dev.type == "cpu":
        return blend_skin_plain(ops, coef, skin_rot, skin_t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if coef.data_ptr() % 16:
        raise ValueError("coef must be 16-byte aligned (the kernel reads "
                         "its rows as float4)")
    out = torch.empty((b, ops.n_verts, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev), spans.span(spans.LAUNCH_K4):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mano_blend_skin(
            coef.data_ptr(), skin_rot.data_ptr(), skin_t.data_ptr(),
            ops.basis_tiles.data_ptr(), ops.wt_tiles.data_ptr(),
            out.data_ptr(), b, ops.n_verts, j, ops.kpad, stream)
    _build.check(lib, rc, "blend_skin")
    count_launch(sys.modules[__name__], "blend_skin_launches")
    return out


def forward_verts_fused(params, pose: torch.Tensor,
                        shape: torch.Tensor) -> torch.Tensor:
    """Batched vertices [B, V, 3]: the PyTorch ``pre_stage``, then blend
    and skin in one launch (K4). Same contract as
    ``forward_verts_fused_full``; records no gradient (see
    ``forward_verts_fused_ad``)."""
    refuse_grad("forward_verts_fused", "forward_verts_fused_ad", pose,
                shape, *params.forward_tensors())
    ops = fused_operands(params)
    _check(ops, pose, shape)
    coef, skin_rot, skin_t = _packed_pre_stage(ops, pose, shape)
    return blend_skin_fused(ops, coef.contiguous(), skin_rot.contiguous(),
                            skin_t.contiguous())


# ------------------------------------------------------------- the backward
def _fused_backward(params, need, saved, g):
    """``pallas_forward.py:_bwd``: cotangents (pose, shape, *the five
    parameter tensors*) for the vertex cotangent ``g`` [B, V, 3], where
    ``saved`` holds those seven inputs and ``need`` whether each wants
    its cotangent, in that order."""
    names = ("pose", "shape") + FORWARD_FIELDS
    need = dict(zip(names, need))
    saved = dict(zip(names, saved))
    ops = fused_operands(params)
    s = ops.n_shape
    g = g.float().contiguous()
    f32 = torch.float32

    # The pre-stage re-runs under autograd on detached leaves (the
    # counterpart of jax.vjp(pre_p, ...)); its joint operands come from
    # the parameters themselves so their cotangents flow.
    pre_names = ("pose", "shape", "v_template", "shape_basis", "j_regressor")
    with torch.enable_grad():
        leaf = {n: saved[n].detach().requires_grad_(need[n])
                for n in pre_names}
        j_reg = leaf["j_regressor"].to(f32)
        jt = einsum("jv,vc->jc", j_reg, leaf["v_template"].to(f32))
        jsb = einsum("jv,vcs->jcs", j_reg,
                           leaf["shape_basis"].to(f32))
        coef, skin_rot, skin_t = pre_stage(ops.parents_tuple, jt, jsb,
                                           leaf["pose"], leaf["shape"],
                                           ops.kpad)
    coef_d = coef.detach()
    rot_d, t_d = skin_rot.detach(), skin_t.detach()
    w = saved["lbs_weights"].detach().to(f32).contiguous()
    need_basis = any(need[n] for n in ("v_template", "shape_basis",
                                       "pose_basis"))

    # Vertex cotangent dL/dv_posed from K3 (R^T, no t); then the
    # coefficient cotangent through the packed basis. v_posed is rebuilt
    # (one product) only for the rotation and weight cotangents.
    needs = (need["lbs_weights"], skin_rot.requires_grad,
             skin_t.requires_grad, coef.requires_grad or need_basis)
    v_posed = (einsum("bk,kcv->bvc", coef_d, ops.basis)
               if needs[0] or needs[1] else None)
    grad_w, grad_rot, grad_t, grad_vp = fused_skin.skin_vjp(
        w, rot_d.contiguous(), t_d, v_posed, g, needs=needs)
    pairs = [(skin_rot, grad_rot), (skin_t, grad_t)]
    if coef.requires_grad:
        pairs.append((coef, einsum("bvc,kcv->bk", grad_vp, ops.basis)))
    wanted = [n for n in pre_names if need[n]]
    pairs = [(o, c) for o, c in pairs if o.requires_grad]
    grads = dict.fromkeys(names)
    if pairs and wanted:
        outs, cots = zip(*pairs)
        got = torch.autograd.grad(outs, [leaf[n] for n in wanted], cots,
                                  allow_unused=True)
        grads.update(zip(wanted, got))

    # Direct vertex-path parameter cotangents, added on top: the weights
    # (skin_vjp) and the packed basis, unpacked through the port's
    # [shape | template | pose | pad] row order.
    grads["lbs_weights"] = grad_w
    if need_basis:
        grad_basis = einsum("bk,bvc->kcv", coef_d, grad_vp)
        p = ops.n_coef - s - 1
        direct = {"shape_basis": grad_basis[:s].permute(2, 1, 0),
                  "v_template": grad_basis[s].T,
                  "pose_basis": grad_basis[s + 1:s + 1 + p].permute(2, 1, 0)}
        for n, d in direct.items():
            if need[n]:
                grads[n] = d if grads[n] is None else grads[n] + d
    return tuple(None if grads[n] is None else grads[n].to(saved[n].dtype)
                 for n in names)


class FusedVerts(torch.autograd.Function):
    """``forward_verts_fused`` (K4) with the hybrid backward
    (``pallas_forward.forward_verts_fused_ad``). Inputs: the params
    object (not differentiated), pose, shape, then the ``FORWARD_FIELDS``
    tensors so autograd routes their cotangents."""

    @staticmethod
    def forward(ctx, params, pose, shape, *param_tensors):
        ctx.params = params
        ctx.save_for_backward(pose, shape, *param_tensors)
        return forward_verts_fused(params, pose, shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with ieee_fp32():    # covers the pre-stage's autograd.grad too
            return (None, *_fused_backward(ctx.params,
                                           ctx.needs_input_grad[1:],
                                           ctx.saved_tensors, g))


class FusedVertsFull(FusedVerts):
    """``forward_verts_fused_full`` (K1) with the same backward
    (``pallas_forward.forward_verts_fused_full_ad``)."""

    @staticmethod
    def forward(ctx, params, pose, shape, *param_tensors):
        ctx.params = params
        ctx.save_for_backward(pose, shape, *param_tensors)
        return forward_verts_fused_full(params, pose, shape)


def _chunks(b: int, chunk_size: int):
    """The row ranges ``(i, j)`` of ``b`` rows ``chunk_size`` at a time
    (at least 1), the last one short where ``chunk_size`` does not divide
    ``b``."""
    step = max(1, chunk_size)
    return [(i, min(i + step, b)) for i in range(0, b, step)]


class FusedVertsFullChunked(torch.autograd.Function):
    """K1 over a huge batch, ``chunk_size`` rows a launch, each chunk
    written straight into its rows of one output [B, V, 3]: no chunk
    tensor, padding or concatenation. The last chunk launches with the
    rows that are left. Inputs: the params object and ``chunk_size`` (not
    differentiated), pose [B, J, 3], shape [B, S], then the
    ``FORWARD_FIELDS`` tensors. The backward runs ``_fused_backward``
    a chunk at a time, so its memory stays bounded by one chunk."""

    @staticmethod
    def forward(ctx, params, chunk_size, pose, shape, *param_tensors):
        ctx.params, ctx.chunk_size = params, chunk_size
        ctx.save_for_backward(pose, shape, *param_tensors)
        ops = fused_operands(params)
        _check(ops, pose, shape)
        b = pose.shape[0]
        out = pose.new_empty((b, ops.n_verts, 3))
        for i, j in _chunks(b, chunk_size):
            if pose.device.type == "cpu":
                out[i:j] = forward_verts_plain(ops, pose[i:j], shape[i:j])
            else:
                _launch_forward(ops, pose[None, i:j], shape[None, i:j],
                                out=out[None, i:j])
            count_launch(sys.modules[__name__], "chunks_in_place")
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pose, shape, *tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        grads = [torch.zeros_like(x) if n else None
                 for x, n in zip(ctx.saved_tensors, need)]
        with ieee_fp32():    # covers the pre-stage's autograd.grad too
            for i, j in _chunks(pose.shape[0], ctx.chunk_size):
                got = _fused_backward(ctx.params, need,
                                      (pose[i:j], shape[i:j], *tensors),
                                      g[i:j])
                for k, x in enumerate(got):
                    if x is None:
                        continue
                    if k < 2:       # pose and shape: the chunk's rows
                        grads[k][i:j] = x
                    else:           # the parameters: summed over chunks
                        grads[k] += x
        return (None, None, *grads)


def forward_verts_fused_ad(params, pose: torch.Tensor,
                           shape: torch.Tensor) -> torch.Tensor:
    """Differentiable ``forward_verts_fused``: gradients reach pose, shape
    and the five parameter tensors (once differentiable)."""
    return FusedVerts.apply(params, pose, shape, *params.forward_tensors())


def forward_verts_fused_full_ad(params, pose: torch.Tensor,
                                shape: torch.Tensor) -> torch.Tensor:
    """Differentiable ``forward_verts_fused_full``: gradients reach pose,
    shape and the five parameter tensors (once differentiable)."""
    return FusedVertsFull.apply(params, pose, shape,
                                *params.forward_tensors())


def forward_verts_fused_full_chunked_ad(params, pose: torch.Tensor,
                                        shape: torch.Tensor,
                                        chunk_size: int) -> torch.Tensor:
    """Differentiable K1 over a huge batch, ``chunk_size`` rows a launch
    into one output (``FusedVertsFullChunked``): the same rows as
    ``forward_verts_fused_full_ad`` chunk by chunk, with no copy."""
    return FusedVertsFullChunked.apply(params, chunk_size, pose, shape,
                                       *params.forward_tensors())
