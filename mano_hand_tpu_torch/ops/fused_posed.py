"""K2: the gathered pose-only serving forward in one CUDA launch, in f32
and in the bf16 serving tier.

Replaces the TPU kernel ``mano_hand_tpu/ops/pallas_posed.py:
forward_posed_gather_fused`` (``pallas_call`` at line 382). Row ``r`` runs
the pose stage over subject ``idx[r]`` of a ``SubjectTable``: the kernel
(``csrc/fused_posed.cu``) gathers ``joints[idx[r]]`` and runs Rodrigues,
FK and the inverse bind once per row tile, then the pose blend
``v_shaped[idx[r]] + (R - I) . pose_basis`` and skinning over 128-vertex
sub-tiles, writing ``[B, V, 3]`` fp32. The f32 kernel is the tiled phase
D that K1 and K4 run (``csrc/tiled_phase_d.cuh``: a register-tiled FFMA
GEMM with the skin as its epilogue), started at the gathered template
rows.

``compute_dtype=torch.bfloat16`` launches the bf16 kernel (the TPU
kernel's ``compute_dtype`` mode, ``pallas_posed.py:297-305``): the pose
basis and the weights are packed as bf16, the ``(R - I)`` coefficients
are rounded to bf16 after Rodrigues and the 12 skinning entries of each
(row, joint) after FK and the inverse bind, and both contractions — the
pose blend and the skinning weights' blend of the transforms — run on the
tensor cores (bf16 ``mma.sync``, f32 accumulation, the template rows as
the blend's start); the per-vertex 3 x 3 apply stays f32. The FK inputs
(local rotations, rest joints) are never rounded: a rounding there would
compound along the chain (``pallas_posed.py:211-223``).
``forward_posed_gather_plain`` applies the same roundings at the same
points.

What bounds it on an H100: operations in f32 (about 0.95 MFLOP a row
against 9.3 KB gathered and 9.3 KB written), bytes in bf16 (the
contractions take microseconds on the tensor cores). Any table capacity
serves: the TPU kernel's 512-row VMEM gate has no counterpart here.

Subject indices map to rows as ``core.forward_posed_gather`` maps them
(``common.subject_rows``): a negative index ``i`` selects ``i + C``, then
every index is clamped to ``[0, C - 1]`` — in the kernels, in
``forward_posed_gather_plain`` and in the JAX package's XLA gather alike.
(The TPU kernel gathers zeros out of range, ``pallas_posed.py:205-207``;
the port follows the XLA path.)

Operand prep: the pose basis, in the reference's row-major (R - I) order,
and the weights, packed once in the kernels' vertex-tiled layouts
(``PosedOperands``), f32 or bf16, cached per (pose basis, weights) pair
so every functional table update reuses them; an in-place update of
either tensor repacks, on its device. The untiled forms the plain version
reads are built from the tiles on first use.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from mano_hand_tpu_torch.obs import spans
from mano_hand_tpu_torch.ops import _build, fk, lbs
from mano_hand_tpu_torch.ops.common import (
    IdentityCache, cdiv, check_compute_dtype, count_launch, einsum,
    operand, parents_tensor, round_bf16, subject_rows,
)
from mano_hand_tpu_torch.ops.fused_forward import (
    check_tree, memo, tile_verts, untile_verts, vert_buffer,
)
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix

#: f32 kernel launches so far (the main-path evidence; reset it freely).
launches = 0
#: bf16-tier kernel launches so far.
bf16_launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class PosedOperands:
    """The packed asset operands of K2, in f32 or in bf16, in the
    kernels' vertex-tiled layouts (V zero-padded to whole tiles of
    ``VERT_TILE``, one contiguous block per tile):

    * ``basis_tiles`` [nsub, Ppad, 3, VERT_TILE]: the pose basis, P =
      9 (J - 1) rows zero-padded to Ppad (a multiple of 4 in f32, of 16 —
      one mma step — in bf16);
    * ``wt_tiles``: f32 [nsub, J, VERT_TILE] (K1's layout), bf16
      [nsub, VERT_TILE, Jpad] (vertex-major, J zero-padded to a multiple
      of 16: the skin mma's A operand).

    ``basis`` and ``wt``, which the plain version reads, are built from
    the tiles on first use and kept with them."""

    basis_tiles: torch.Tensor
    wt_tiles: torch.Tensor
    n_verts: int
    n_joints: int
    _untiled: dict = dataclasses.field(init=False, default_factory=dict,
                                       repr=False)

    @property
    def kpad(self) -> int:
        return self.basis_tiles.shape[1]

    @property
    def basis(self) -> torch.Tensor:
        """[cdiv(P, 4) 4, 3, V], the storage dtype: the rows the plain
        version contracts (the bf16 pack's extra zero rows dropped)."""
        k = cdiv(9 * (self.n_joints - 1), 4) * 4
        return memo(self._untiled, "basis", lambda: untile_verts(
            self.basis_tiles[:, :k], self.n_verts))

    @property
    def wt(self) -> torch.Tensor:
        """[J, V], the storage dtype: the skinning weights, transposed."""
        tiles = self.wt_tiles
        if tiles.dtype == torch.bfloat16:   # vertex-major
            tiles = tiles.transpose(-1, -2)
        return memo(self._untiled, "wt", lambda: untile_verts(
            tiles, self.n_verts)[:self.n_joints])


def _pack(assets, bf16: bool) -> PosedOperands:
    # Packed on the assets' device straight into the tiled layouts: zeroed
    # buffers whose parts are copied in (rounded to the storage dtype by
    # the copy, from f32), then cut into tiles.
    pose_basis, lbs_weights = (x.detach().float() for x in assets)
    v, _, p = pose_basis.shape
    j = lbs_weights.shape[1]
    dtype = torch.bfloat16 if bf16 else torch.float32
    dev = pose_basis.device
    step = 16 if bf16 else 4
    flat = vert_buffer((cdiv(p, step) * step, 3), v, dtype, dev)
    flat[:p, :, :v] = pose_basis.permute(2, 1, 0)
    if bf16:   # vertex-major, J padded to one mma step
        wflat = vert_buffer((cdiv(j, 16) * 16,), v, dtype, dev)
        wflat[:j, :v] = lbs_weights.T
        wt_tiles = tile_verts(wflat.T, dim=0)
    else:
        wflat = vert_buffer((j,), v, dtype, dev)
        wflat[:, :v] = lbs_weights.T
        wt_tiles = tile_verts(wflat)
    return PosedOperands(basis_tiles=tile_verts(flat), wt_tiles=wt_tiles,
                         n_verts=v, n_joints=j)


# Keyed on the (pose_basis, lbs_weights) pair and both tensors' versions.
_packs = {dt: IdentityCache(sources=lambda assets: assets)
          for dt in (None, torch.bfloat16)}


def posed_operands(table, compute_dtype=None) -> PosedOperands:
    """The packed operands of a table's shared asset tensors: f32, or
    bf16 for the bf16 tier (cached per tensor pair while unchanged)."""
    check_compute_dtype(compute_dtype)
    return _packs[compute_dtype].get(
        (table.pose_basis, table.lbs_weights),
        lambda assets: _pack(assets, compute_dtype is not None))


def forward_posed_gather_plain(v_shaped, joints, idx, pose,
                               ops: PosedOperands,
                               parents) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [B, V, 3]. bf16
    operands (``posed_operands(table, torch.bfloat16)``) select the bf16
    tier's roundings: the coefficients, then the skinning entries."""
    bf16 = ops.basis_tiles.dtype == torch.bfloat16
    basis = ops.basis
    b = pose.shape[0]
    rows = subject_rows(idx, v_shaped.shape[0])
    rot = rotation_matrix(pose)                           # [B, J, 3, 3]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    coef = (rot[:, 1:] - eye).flatten(1)
    coef = torch.cat(
        [coef, coef.new_zeros(b, basis.shape[0] - coef.shape[1])], 1)
    if bf16:
        coef = round_bf16(coef)
    v_posed = v_shaped[rows] + einsum("bk,kcv->bvc", coef, basis.float())
    j_rows = joints[rows]
    world_rot, world_t = fk.forward_kinematics(parents, rot, j_rows)
    _, skin_t = fk.skinning_transforms(world_rot, world_t, j_rows)
    if bf16:
        world_rot, skin_t = round_bf16(world_rot), round_bf16(skin_t)
    return lbs.skin(ops.wt.T.float(), world_rot, skin_t, v_posed)


def _check(table, idx: torch.Tensor, pose: torch.Tensor):
    b, j = pose.shape[0], table.n_joints
    if tuple(pose.shape) != (b, j, 3):
        raise ValueError(f"pose must be [B, {j}, 3], got {tuple(pose.shape)}")
    if tuple(idx.shape) != (b,):
        raise ValueError(f"subject_idx must be [{b}], got {tuple(idx.shape)}")
    if pose.dtype != torch.float32:
        raise ValueError(f"pose must be float32, got {pose.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"subject_idx must be int32, got {idx.dtype}")
    for name, t in (("v_shaped", table.v_shaped), ("joints", table.joints)):
        if t.dtype != torch.float32:
            raise ValueError(f"table.{name} must be float32, got {t.dtype}")
    if table.v_shaped.shape[0] < 1:
        raise ValueError("the subject table has no rows")
    for name, t in (("pose", pose), ("subject_idx", idx),
                    ("table.joints", table.joints)):
        if t.device != table.v_shaped.device:
            raise ValueError(
                f"{name} is on {t.device} but the table is on "
                f"{table.v_shaped.device}")
    check_tree(tuple(table.parents))


def forward_posed_gather_fused(table, subject_idx: torch.Tensor,
                               pose: torch.Tensor,
                               compute_dtype=None) -> torch.Tensor:
    """Mixed-subject pose-only vertices [B, V, 3] in one launch.

    ``subject_idx`` [B] int32 and ``pose`` [B, J, 3] float32 on the
    table's device. A CPU tensor runs ``forward_posed_gather_plain``; a
    CUDA tensor launches the kernel (or raises). ``compute_dtype``:
    None (f32) or ``torch.bfloat16``, the bf16 serving tier (its own
    kernel and launch counter, ``bf16_launches``).
    """
    check_compute_dtype(compute_dtype)
    if pose.requires_grad:
        raise ValueError("the gathered kernel is inference only")
    _check(table, subject_idx, pose)
    ops = posed_operands(table, compute_dtype)
    dev = pose.device
    parents = parents_tensor(tuple(table.parents), dev)
    if dev.type == "cpu":
        return forward_posed_gather_plain(
            table.v_shaped, table.joints, subject_idx, pose, ops,
            tuple(table.parents))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # A table's joints come from a batched regression as a strided view
    # (``core.specialize`` of many shapes): its copy is one more device
    # operation a call.
    v_shaped, joints = operand(table.v_shaped), operand(table.joints)
    idx, pose = operand(subject_idx), operand(pose)
    b, c, v = pose.shape[0], v_shaped.shape[0], v_shaped.shape[1]
    out = torch.empty((b, v, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.load()
    bf16 = compute_dtype is not None
    with torch.cuda.device(dev), spans.span(
            spans.LAUNCH_K2_BF16 if bf16 else spans.LAUNCH_K2):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mano_fused_posed(
            v_shaped.data_ptr(), joints.data_ptr(), idx.data_ptr(),
            pose.data_ptr(), ops.basis_tiles.data_ptr(),
            ops.wt_tiles.data_ptr(), parents.data_ptr(), out.data_ptr(), b,
            c, v, table.n_joints, ops.kpad, int(bf16), stream)
    _build.check(lib, rc, "fused_posed")
    count_launch(sys.modules[__name__],
                 "bf16_launches" if bf16 else "launches")
    return out
