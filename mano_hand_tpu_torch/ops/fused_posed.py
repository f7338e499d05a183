"""K2: the gathered pose-only serving forward in one CUDA launch, in f32
and in the bf16 serving tier.

Replaces the TPU kernel ``mano_hand_tpu/ops/pallas_posed.py:
forward_posed_gather_fused`` (``pallas_call`` at line 382). Row ``r`` runs
the pose stage over subject ``idx[r]`` of a ``SubjectTable``: the kernel
(``csrc/fused_posed.cu``, the device functions of
``csrc/mano_common.cuh`` shared with K1) loads ``v_shaped[idx[r]]`` and
``joints[idx[r]]`` directly, then runs Rodrigues, FK, the inverse bind,
the pose blend ``(R - I) . pose_basis`` and skinning, writing
``[B, V, 3]`` fp32.

``compute_dtype=torch.bfloat16`` launches the bf16 variant of the same
kernel (a template parameter; the TPU kernel's ``compute_dtype`` mode,
``pallas_posed.py:297-305``): the pose basis and the weights are packed
as bf16 (half the bytes), the ``(R - I)`` coefficients are rounded to
bf16 after phase A and the 12 skinning entries of each (row, joint)
after phases B and C; every product accumulates in f32 and the gathered
``v_shaped`` base stays f32. The FK inputs (local rotations, rest
joints) are never rounded: a rounding there would compound along the
chain (``pallas_posed.py:211-223``). ``forward_posed_gather_plain``
applies the same roundings at the same points.

What bounds it on an H100: operations (about 0.95 MFLOP a row against
9.3 KB gathered and 9.3 KB written). Both forms use FFMA; the bf16 one
does not use the tensor cores yet. Any table capacity serves: the TPU
kernel's 512-row VMEM gate has no counterpart here.

Out-of-range indices are CLAMPED to ``[0, C - 1]`` — by the kernel, by
``forward_posed_gather_plain`` and by ``core.forward_posed_gather`` alike
(the TPU kernel gathered zeros there; its XLA path clamped).

Operand prep (the pose basis packed ``[Ppad, 3, V]`` in the reference's
row-major (R - I) order, the weights ``[J, V]``, each in f32 and in bf16)
is cached per asset tensor, so every functional table update reuses it;
an in-place update of ``pose_basis`` or ``lbs_weights`` repacks it.
"""

from __future__ import annotations

import threading

import torch

from mano_hand_tpu_torch.ops import _build, fk, lbs
from mano_hand_tpu_torch.ops.common import (
    IdentityCache, cdiv, check_compute_dtype, einsum, parents_tensor,
    round_bf16,
)
from mano_hand_tpu_torch.ops.fused_forward import check_tree
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix

#: f32 kernel launches so far (the main-path evidence; reset it freely).
launches = 0
#: bf16-tier kernel launches so far.
bf16_launches = 0
_count_lock = threading.Lock()


def _pack_pose_basis(pose_basis: torch.Tensor) -> torch.Tensor:
    pose_basis = pose_basis.detach()
    v, _, p = pose_basis.shape
    ppad = cdiv(p, 4) * 4
    return torch.cat([
        pose_basis.permute(2, 1, 0).float(),
        pose_basis.new_zeros(ppad - p, 3, v, dtype=torch.float32),
    ]).contiguous()


def _pack_weights(lbs_weights: torch.Tensor) -> torch.Tensor:
    return lbs_weights.detach().T.float().contiguous()


def _bf16(pack):
    return lambda t: pack(t).to(torch.bfloat16)


_bases = IdentityCache()
_weights = IdentityCache()
_bases_bf16 = IdentityCache()
_weights_bf16 = IdentityCache()


def posed_operands(table, compute_dtype=None):
    """``(pose_basis2 [Ppad, 3, V], wt [J, V], parents [J] int32)`` of a
    table's shared asset tensors: f32, or bf16 for the bf16 tier (cached
    per tensor while unchanged)."""
    if compute_dtype is None:
        bases, weights = (_bases.get(table.pose_basis, _pack_pose_basis),
                          _weights.get(table.lbs_weights, _pack_weights))
    else:
        bases = _bases_bf16.get(table.pose_basis, _bf16(_pack_pose_basis))
        weights = _weights_bf16.get(table.lbs_weights, _bf16(_pack_weights))
    return (bases, weights,
            parents_tensor(tuple(table.parents), table.v_shaped.device))


def forward_posed_gather_plain(v_shaped, joints, idx, pose, pose_basis2,
                               wt, parents) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [B, V, 3]. bf16
    operands (``posed_operands(table, torch.bfloat16)``) select the bf16
    tier's roundings: the coefficients, then the skinning entries."""
    bf16 = pose_basis2.dtype == torch.bfloat16
    b = pose.shape[0]
    rows = idx.long().clamp(0, v_shaped.shape[0] - 1)
    rot = rotation_matrix(pose)                           # [B, J, 3, 3]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    coef = (rot[:, 1:] - eye).flatten(1)
    coef = torch.cat(
        [coef, coef.new_zeros(b, pose_basis2.shape[0] - coef.shape[1])], 1)
    if bf16:
        coef = round_bf16(coef)
    v_posed = v_shaped[rows] + einsum("bk,kcv->bvc", coef,
                                      pose_basis2.float())
    j_rows = joints[rows]
    world_rot, world_t = fk.forward_kinematics(parents, rot, j_rows)
    _, skin_t = fk.skinning_transforms(world_rot, world_t, j_rows)
    if bf16:
        world_rot, skin_t = round_bf16(world_rot), round_bf16(skin_t)
    return lbs.skin(wt.T.float(), world_rot, skin_t, v_posed)


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
    kernel variant and launch counter, ``bf16_launches``).
    """
    check_compute_dtype(compute_dtype)
    if pose.requires_grad:
        raise ValueError("the gathered kernel is inference only")
    _check(table, subject_idx, pose)
    pose_basis2, wt, parents = posed_operands(table, compute_dtype)
    dev = pose.device
    if dev.type == "cpu":
        return forward_posed_gather_plain(
            table.v_shaped, table.joints, subject_idx, pose, pose_basis2, wt,
            tuple(table.parents))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    v_shaped = table.v_shaped.contiguous()
    joints = table.joints.contiguous()
    idx, pose = subject_idx.contiguous(), pose.contiguous()
    b, c, v = pose.shape[0], v_shaped.shape[0], v_shaped.shape[1]
    out = torch.empty((b, v, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mano_fused_posed(
            v_shaped.data_ptr(), joints.data_ptr(), idx.data_ptr(),
            pose.data_ptr(), pose_basis2.data_ptr(), wt.data_ptr(),
            parents.data_ptr(), out.data_ptr(), b, c, v, table.n_joints,
            pose_basis2.shape[0], int(compute_dtype is not None), stream)
    _build.check(lib, rc, "fused_posed")
    global launches, bf16_launches
    with _count_lock:
        if compute_dtype is None:
            launches += 1
        else:
            bf16_launches += 1
    return out
