"""The MANO forward core in PyTorch.

Plain functions over a frozen ``ManoParams``:

    shape_blend -> regress_joints -> rotation_matrix -> pose_blend
    -> forward_kinematics (level-parallel) -> skin (fused LBS)

Batching is a leading dimension written out (every op broadcasts over
it). Names follow the JAX package's ``models/core.py`` so each function's
counterpart is easy to find. The kernel routes keep their names and run
the hand-written CUDA kernels: ``forward_batched_pallas`` K3
(``ops/fused_skin.py``), ``forward_batched_pallas_fused`` K4 and
``forward_batched_pallas_fused_full`` K1 (``ops/fused_forward.py``), all
three differentiable, ``forward_hands_pallas_fused_full`` K5 (both hands
of a ``stack_params`` pair in one launch, inference only) and
``forward_posed_gather_fused`` K2 (``ops/fused_posed.py``, inference
only, f32 or the bf16 serving tier). ``forward_chunked`` is the
huge-batch entry point over K1 (each chunk written in place), K3 and K4.
The pose-only functions take ``compute_dtype`` (None, or
``torch.bfloat16`` for the bf16 serving tier: the pose blend and the
skinning contractions take bf16 operands and accumulate in f32, while
Rodrigues, FK, the residual adds and the output stay f32).
The subject-table functions are functional: each returns a new table and
leaves its input untouched, so a table captured by an in-flight batch
stays valid while the serving engine installs subjects.
Beside the forward: the pose PCA (``decode_pca``, ``forward_pca``,
``sample_poses``), the rotation-matrix entry (``forward_batched_rotmats``)
and the 21-keypoint set (``keypoints``, ``keypoints_chunked``), all plain
PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mano_hand_tpu_torch import constants, ops
from mano_hand_tpu_torch.assets.schema import (
    ARRAY_FIELDS, STACKED, ManoParams, StackedParams,
)
from mano_hand_tpu_torch.obs import spans
from mano_hand_tpu_torch.ops import fused_forward, fused_posed, fused_skin
from mano_hand_tpu_torch.ops.common import (
    IdentityCache, check_compute_dtype, einsum, index_tensor, operand,
    subject_rows,
)


class ManoOutput(NamedTuple):
    """Forward-pass outputs."""

    verts: torch.Tensor         # [..., V, 3] skinned mesh
    joints: torch.Tensor        # [..., J, 3] rest-pose joints
    rest_verts: torch.Tensor    # [..., V, 3] blendshaped mesh pre-skinning
    rot_mats: torch.Tensor      # [..., J, 3, 3] per-joint rotations
    posed_joints: torch.Tensor  # [..., J, 3] world joints after FK


def _pose_rotmats(pose: torch.Tensor, n_joints: int, dtype, lead=()):
    return ops.rotation_matrix(pose.reshape(*lead, n_joints, 3).to(dtype))


def _zeros_shape(params: ManoParams, lead=()) -> torch.Tensor:
    return torch.zeros((*lead, params.n_shape), dtype=params.dtype,
                       device=params.device)


def forward(params: ManoParams, pose: Optional[torch.Tensor] = None,
            shape: Optional[torch.Tensor] = None) -> ManoOutput:
    """Single-hand forward: pose [J, 3] (row 0 global), shape [S]."""
    if pose is None:
        pose = torch.zeros((params.n_joints, 3), dtype=params.dtype,
                           device=params.device)
    return forward_rotmats(
        params, _pose_rotmats(pose, params.n_joints, params.dtype), shape)


def forward_rotmats(params: ManoParams, rot_mats: torch.Tensor,
                    shape: Optional[torch.Tensor] = None) -> ManoOutput:
    """Forward from per-joint rotation MATRICES [..., J, 3, 3] (no
    Rodrigues), shape [..., S]; matrices are used as given."""
    if shape is None:
        shape = _zeros_shape(params, rot_mats.shape[:-3])
    rot_mats = rot_mats.to(params.dtype)
    shape = shape.to(params.dtype)
    v_shaped = ops.shape_blend(params.v_template, params.shape_basis, shape)
    joints = ops.regress_joints(params.j_regressor, v_shaped)
    v_posed = ops.pose_blend(v_shaped, params.pose_basis, rot_mats)
    world_rot, world_t = ops.forward_kinematics(params.parents, rot_mats,
                                                joints)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, joints)
    verts = ops.skin(params.lbs_weights, skin_rot, skin_t, v_posed)
    return ManoOutput(verts, joints, v_posed, rot_mats, world_t)


def _blend_bases(params: ManoParams):
    v, _, s = params.shape_basis.shape
    pdim = params.pose_basis.shape[-1]
    vertex_basis = torch.cat([
        params.shape_basis.reshape(v * 3, s),
        params.pose_basis.reshape(v * 3, pdim),
    ], dim=1)
    joint_template = einsum("jv,vc->jc", params.j_regressor,
                            params.v_template)
    joint_shape_basis = einsum("jv,vcs->jcs", params.j_regressor,
                                     params.shape_basis)
    return vertex_basis, joint_template, joint_shape_basis


_bases = IdentityCache(sources=ManoParams.forward_tensors)


def fused_blend_bases(params: ManoParams):
    """Per-asset derived tensors of the fused-basis path:
    (vertex_basis [V*3, S+P], joint_template [J, 3],
    joint_shape_basis [J, 3, S]). Joints are an affine map of the shaped
    template, so the regressor precomposes with the shape basis, and the
    shape + pose blendshapes concatenate into one matrix.

    Cached per asset while its tensors are unchanged (an in-place update
    rebuilds them). When a parameter requires grad under grad mode the
    tensors are built per call, so each forward differentiates to the
    parameters as they are now; a cached tensor never carries autograd
    history."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in params.forward_tensors()):
        return _blend_bases(params)
    return _bases.get(params, _blend_bases)


def forward_fused(params: ManoParams, pose: Optional[torch.Tensor] = None,
                  shape: Optional[torch.Tensor] = None) -> ManoOutput:
    """Single-hand forward with the fused blend contractions."""
    if pose is None:
        pose = torch.zeros((params.n_joints, 3), dtype=params.dtype,
                           device=params.device)
    return forward_fused_rotmats(
        params, _pose_rotmats(pose, params.n_joints, params.dtype), shape)


def forward_fused_rotmats(params: ManoParams, rot_mats: torch.Tensor,
                          shape: Optional[torch.Tensor] = None,
                          ) -> ManoOutput:
    """Fused-basis forward from rotation matrices [..., J, 3, 3]: one
    [S+P]-coefficient contraction drives all vertex displacement."""
    if shape is None:
        shape = _zeros_shape(params, rot_mats.shape[:-3])
    rot_mats = rot_mats.to(params.dtype)
    shape = shape.to(params.dtype)
    vertex_basis, joint_template, joint_shape_basis = fused_blend_bases(params)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    coeff = torch.cat(
        [shape, (rot_mats[..., 1:, :, :] - eye).flatten(-3)], dim=-1)
    v_posed = (params.v_template.reshape(-1)
               + einsum("rk,...k->...r", vertex_basis, coeff)
               ).unflatten(-1, (params.n_verts, 3))
    joints = joint_template + einsum("jcs,...s->...jc",
                                           joint_shape_basis, shape)
    world_rot, world_t = ops.forward_kinematics(params.parents, rot_mats,
                                                joints)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, joints)
    verts = ops.skin(params.lbs_weights, skin_rot, skin_t, v_posed)
    return ManoOutput(verts, joints, v_posed, rot_mats, world_t)


def forward_batched(params: ManoParams, pose: torch.Tensor,
                    shape: torch.Tensor, fused: bool = True) -> ManoOutput:
    """Batched forward: pose [B, J, 3] or [B, J*3], shape [B, S]. The
    fused-basis path is the default; ``fused=False`` runs the
    reference-structured staging."""
    rot = _pose_rotmats(pose, params.n_joints, params.dtype,
                        lead=(pose.shape[0],))
    fwd = forward_fused_rotmats if fused else forward_rotmats
    return fwd(params, rot, shape)


def forward_batched_rotmats(params: ManoParams, rot_mats: torch.Tensor,
                            shape: torch.Tensor,
                            fused: bool = True) -> ManoOutput:
    """Batched forward from rotation matrices [B, J, 3, 3] (no Rodrigues),
    shape [B, S]; like ``forward_batched``, the fused-basis path is the
    default."""
    fwd = forward_fused_rotmats if fused else forward_rotmats
    return fwd(params, rot_mats, shape)


# ----------------------------------------------------------------- pose PCA
def decode_pca(params: ManoParams, pca_coeffs: torch.Tensor,
               global_rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PCA pose coefficients [..., n <= (J-1)*3] -> full pose [..., J, 3].

    Reference semantics: the truncated basis rows, plus the mean pose,
    with the global-rotation row prepended (zeros when ``global_rot`` is
    None; a single [3] rotation broadcasts over any coefficient batch).
    The articulated joint count comes from the asset (15 for MANO, 23
    for an SMPL body, whose identity basis makes this a pass-through).
    """
    dtype, dev = params.dtype, params.device
    pca_coeffs = torch.as_tensor(pca_coeffs, device=dev).to(dtype)
    n = pca_coeffs.shape[-1]
    flat = einsum("...n,nf->...f", pca_coeffs,
                  params.pca_basis[:n]) + params.pca_mean
    n_arti = params.pca_mean.shape[-1] // 3
    lead = pca_coeffs.shape[:-1]
    fingers = flat.reshape(*lead, n_arti, 3)
    if global_rot is None:
        root = fingers.new_zeros((*lead, 1, 3))
    else:
        root = torch.as_tensor(global_rot, device=dev).to(dtype)
        if root.dim() <= 1:
            root = root.reshape(3).expand(*lead, 1, 3)
        else:
            root = root.reshape(*lead, 1, 3)
    return torch.cat([root, fingers], dim=-2)


def forward_pca(params: ManoParams, pca_coeffs: torch.Tensor,
                global_rot: Optional[torch.Tensor] = None,
                shape: Optional[torch.Tensor] = None) -> ManoOutput:
    """Single-hand forward from PCA pose coefficients (the reference's
    default input)."""
    return forward(params, decode_pca(params, pca_coeffs, global_rot), shape)


def sample_poses(params: ManoParams, generator: torch.Generator, n: int,
                 pca_scale: float = 1.0, global_rot_scale: float = 0.0,
                 component_vars=None) -> torch.Tensor:
    """Draw ``n`` anatomically plausible random poses [n, J, 3].

    PCA coefficients ``z ~ N(0, pca_scale^2 I)`` (optionally scaled per
    component by ``component_vars``) decode through the asset's basis and
    mean pose: samples bend joints along directions real hands use.
    ``global_rot_scale > 0`` adds a random axis-angle global rotation
    row. The draws come from ``generator`` on the generator's own device
    (the JAX package takes a PRNG key), so a CPU generator gives the same
    poses whatever device ``params`` live on.
    """
    n_pca = params.pca_mean.shape[-1]
    dtype, gdev = params.dtype, generator.device
    z = torch.randn((n, n_pca), generator=generator, dtype=dtype,
                    device=gdev) * pca_scale
    if component_vars is not None:
        z = z * torch.sqrt(torch.as_tensor(component_vars, dtype=dtype,
                                           device=gdev))
    global_rot = None
    if global_rot_scale:
        global_rot = torch.randn((n, 3), generator=generator, dtype=dtype,
                                 device=gdev) * global_rot_scale
    return decode_pca(params, z.to(params.device), global_rot)


# ---------------------------------------------------------------- keypoints
def resolve_tip_ids(tip_vertex_ids, n_verts: int):
    """Normalise a fingertip-vertex spec to a tuple of valid vertex ids.

    ``tip_vertex_ids`` is None (no tips: the bare skeleton joints), a
    convention name from ``constants.TIP_VERTEX_IDS`` (``"smplx"`` |
    ``"manopth"``, vertex ids on the official 778-vertex mesh), or an
    explicit sequence of vertex indices (any length).
    """
    if tip_vertex_ids is None:
        return None
    if isinstance(tip_vertex_ids, str):
        try:
            tip_vertex_ids = constants.TIP_VERTEX_IDS[tip_vertex_ids]
        except KeyError:
            raise ValueError(
                f"unknown tip convention {tip_vertex_ids!r}; known: "
                f"{sorted(constants.TIP_VERTEX_IDS)} (or pass explicit "
                "vertex ids)"
            ) from None
    ids = tuple(int(i) for i in tip_vertex_ids)
    if not ids:
        return None  # () means the same as None: the bare skeleton
    bad = [i for i in ids if not 0 <= i < n_verts]
    if bad:
        raise ValueError(
            f"tip vertex ids {bad} out of range for a {n_verts}-vertex mesh"
        )
    return ids


def select_keypoints(verts: torch.Tensor, posed_joints: torch.Tensor,
                     tips=None, order: str = "mano",
                     axis: int = -2) -> torch.Tensor:
    """THE keypoint selection: append the tip rows (``tips`` pre-resolved
    by ``resolve_tip_ids``, or None) to the posed joints along ``axis``,
    then apply the dataset ordering."""
    if order not in ("mano", "openpose"):
        raise ValueError(f"order must be 'mano' or 'openpose', got {order!r}")
    kp = posed_joints
    if tips is not None:
        idx = index_tensor(tuple(tips), verts.device)
        kp = torch.cat([kp, torch.index_select(verts, axis, idx)], dim=axis)
    if order == "openpose":
        n = kp.shape[axis]
        if n != len(constants.MANO21_TO_OPENPOSE):
            raise ValueError(
                "order='openpose' needs the 21-keypoint set (16 joints + "
                f"5 tips), got {n} keypoints"
            )
        perm = index_tensor(tuple(constants.MANO21_TO_OPENPOSE), kp.device)
        kp = torch.index_select(kp, axis, perm)
    return kp


def keypoints(out: ManoOutput, tip_vertex_ids=None,
              order: str = "mano") -> torch.Tensor:
    """Keypoints [..., 16(+T), 3]: the posed joints plus fingertip vertex
    picks. With the standard 5 tips, ``order="openpose"`` re-orders into
    the OpenPose/FreiHAND convention (``constants.MANO21_TO_OPENPOSE``);
    ``order="mano"`` keeps [16 joints | tips as given]. Leading axes
    broadcast."""
    tips = resolve_tip_ids(tip_vertex_ids, out.verts.shape[-2])
    return select_keypoints(out.verts, out.posed_joints, tips, order)


# ------------------------------------------------------ shape specialization
@dataclasses.dataclass(frozen=True, eq=False)
class ShapedHand:
    """A subject's shape stage, baked once by ``specialize``: the shaped
    template and rest joints (functions of beta only) plus the shared
    pose-stage asset tensors (referenced, not copied)."""

    v_shaped: torch.Tensor      # [V, 3]
    joints: torch.Tensor        # [J, 3]
    shape: torch.Tensor         # [S] the baked betas
    pose_basis: torch.Tensor    # [V, 3, P] (shared)
    lbs_weights: torch.Tensor   # [V, J] (shared)
    parents: Tuple[int, ...] = constants.MANO_PARENTS

    @property
    def n_joints(self) -> int:
        return self.joints.shape[-2]

    @property
    def n_verts(self) -> int:
        return self.v_shaped.shape[-2]


def specialize(params: ManoParams,
               shape: Optional[torch.Tensor] = None) -> ShapedHand:
    """Bake one subject's betas: exactly the shape stage of
    ``forward_rotmats``."""
    if shape is None:
        shape = _zeros_shape(params)
    shape = torch.as_tensor(shape, device=params.device).to(params.dtype)
    v_shaped = ops.shape_blend(params.v_template, params.shape_basis, shape)
    joints = ops.regress_joints(params.j_regressor, v_shaped)
    return ShapedHand(v_shaped, joints, shape, params.pose_basis,
                      params.lbs_weights, tuple(params.parents))


def forward_posed(shaped: ShapedHand, pose: Optional[torch.Tensor] = None,
                  compute_dtype=None) -> ManoOutput:
    """Pose-only forward over a baked shape stage: pose [J, 3]."""
    dtype = shaped.v_shaped.dtype
    if pose is None:
        pose = torch.zeros((shaped.n_joints, 3), dtype=dtype,
                           device=shaped.v_shaped.device)
    return forward_posed_rotmats(
        shaped, _pose_rotmats(pose, shaped.n_joints, dtype), compute_dtype)


def forward_posed_rotmats(shaped: ShapedHand, rot_mats: torch.Tensor,
                          compute_dtype=None) -> ManoOutput:
    """Pose-only forward from rotation matrices [..., J, 3, 3]: pose
    blend -> FK -> LBS over the baked constants."""
    check_compute_dtype(compute_dtype)
    rot_mats = rot_mats.to(shaped.v_shaped.dtype)
    v_posed = ops.pose_blend(shaped.v_shaped, shaped.pose_basis, rot_mats,
                             compute_dtype)
    world_rot, world_t = ops.forward_kinematics(shaped.parents, rot_mats,
                                                shaped.joints)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t,
                                               shaped.joints)
    verts = ops.skin(shaped.lbs_weights, skin_rot, skin_t, v_posed,
                     compute_dtype)
    joints = shaped.joints.expand(*rot_mats.shape[:-3], *shaped.joints.shape)
    return ManoOutput(verts, joints, v_posed, rot_mats, world_t)


def forward_posed_batched(shaped: ShapedHand, pose: torch.Tensor,
                          compute_dtype=None) -> ManoOutput:
    """One subject, many poses: pose [B, J, 3] (or [B, J*3])."""
    return forward_posed_rotmats(
        shaped, _pose_rotmats(pose, shaped.n_joints, shaped.v_shaped.dtype,
                              lead=(pose.shape[0],)), compute_dtype)


# ------------------------------------------------------------ subject table
@dataclasses.dataclass(frozen=True, eq=False)
class SubjectTable:
    """A device-resident stack of baked shape stages: one row per subject
    of the per-subject tensors, the shared asset tensors stored once.
    ``capacity`` is rows allocated, not rows in use."""

    v_shaped: torch.Tensor      # [C, V, 3]
    joints: torch.Tensor        # [C, J, 3]
    shape: torch.Tensor         # [C, S]
    pose_basis: torch.Tensor    # [V, 3, P] (shared)
    lbs_weights: torch.Tensor   # [V, J] (shared)
    parents: Tuple[int, ...] = constants.MANO_PARENTS

    @property
    def capacity(self) -> int:
        return self.v_shaped.shape[0]

    @property
    def n_joints(self) -> int:
        return self.joints.shape[-2]

    @property
    def n_verts(self) -> int:
        return self.v_shaped.shape[-2]


def subject_table(params: ManoParams, capacity: int = 1) -> SubjectTable:
    """An empty (zero-filled) table of ``capacity`` rows over ``params``."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    kw = dict(dtype=params.dtype, device=params.device)
    return SubjectTable(
        v_shaped=torch.zeros((capacity, params.n_verts, 3), **kw),
        joints=torch.zeros((capacity, params.n_joints, 3), **kw),
        shape=torch.zeros((capacity, params.n_shape), **kw),
        pose_basis=params.pose_basis,
        lbs_weights=params.lbs_weights,
        parents=tuple(params.parents),
    )


def stack_shaped(shaped: Sequence[ShapedHand]) -> SubjectTable:
    """Stack baked hands of one asset into a table (capacity = count)."""
    if not shaped:
        raise ValueError("need at least one ShapedHand to stack")
    first = shaped[0]
    for s in shaped[1:]:
        if tuple(s.parents) != tuple(first.parents):
            raise ValueError(
                "cannot stack ShapedHands with different kinematic trees")
    return SubjectTable(
        v_shaped=torch.stack([s.v_shaped for s in shaped]),
        joints=torch.stack([s.joints for s in shaped]),
        shape=torch.stack([s.shape for s in shaped]),
        pose_basis=first.pose_basis,
        lbs_weights=first.lbs_weights,
        parents=tuple(first.parents),
    )


def table_set_row(table: SubjectTable, slot: int,
                  shaped: ShapedHand) -> SubjectTable:
    """A new table with row ``slot`` replaced by ``shaped``'s constants
    (the input table is untouched)."""
    def put(leaf, row):
        new = leaf.clone()
        new[slot] = row
        return new

    return dataclasses.replace(
        table,
        v_shaped=put(table.v_shaped, shaped.v_shaped),
        joints=put(table.joints, shaped.joints),
        shape=put(table.shape, shaped.shape),
    )


def table_grow(table: SubjectTable, capacity: int) -> SubjectTable:
    """A new table grown to ``capacity`` rows (zero-filled tail);
    shrinking is refused."""
    pad = capacity - table.capacity
    if pad < 0:
        raise ValueError(
            f"cannot shrink a subject table from {table.capacity} "
            f"to {capacity} rows")
    if pad == 0:
        return table

    def grow(leaf):
        return torch.cat([leaf, leaf.new_zeros((pad, *leaf.shape[1:]))])

    return dataclasses.replace(
        table,
        v_shaped=grow(table.v_shaped),
        joints=grow(table.joints),
        shape=grow(table.shape),
    )


def table_row(table: SubjectTable, slot: int) -> ShapedHand:
    """Read one subject back out (the inverse of ``table_set_row``)."""
    return ShapedHand(table.v_shaped[slot], table.joints[slot],
                      table.shape[slot], table.pose_basis,
                      table.lbs_weights, tuple(table.parents))


def forward_posed_gather(table: SubjectTable, subject_idx: torch.Tensor,
                         pose: torch.Tensor,
                         compute_dtype=None) -> ManoOutput:
    """Mixed-subject pose-only forward: row ``r`` runs the pose stage over
    subject ``subject_idx[r]``'s baked constants. A negative index ``i``
    selects row ``i + C``, then every index is clamped to ``[0, C - 1]``:
    the JAX package's gather (``table.v_shaped[idx]`` under XLA). The
    gather itself is f32 data movement under either compute dtype."""
    check_compute_dtype(compute_dtype)
    dtype = table.v_shaped.dtype
    rows = subject_rows(torch.as_tensor(
        subject_idx, device=table.v_shaped.device), table.capacity)
    rot = _pose_rotmats(pose, table.n_joints, dtype, lead=(pose.shape[0],))
    v_rows, j_rows = table.v_shaped[rows], table.joints[rows]
    v_posed = ops.pose_blend(v_rows, table.pose_basis, rot, compute_dtype)
    world_rot, world_t = ops.forward_kinematics(table.parents, rot, j_rows)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, j_rows)
    verts = ops.skin(table.lbs_weights, skin_rot, skin_t, v_posed,
                     compute_dtype)
    return ManoOutput(verts, j_rows, v_posed, rot, world_t)


# ------------------------------------------------------- the CUDA kernel routes
def _f32_inputs(params: ManoParams, pose: torch.Tensor, shape: torch.Tensor):
    b = pose.shape[0]
    return (operand(pose.reshape(b, params.n_joints, 3), torch.float32),
            operand(shape.reshape(b, params.n_shape), torch.float32))


def forward_batched_pallas(params: ManoParams, pose: torch.Tensor,
                           shape: torch.Tensor) -> torch.Tensor:
    """Batched vertices [B, V, 3] float32 with skinning in one kernel
    launch (K3, ``ops/fused_skin.py``) after the plain PyTorch pre-skinning
    stages (blendshapes, joint regression, Rodrigues, FK). Differentiable:
    autograd runs through the pre-stages, and the skinning's backward
    takes its vertex cotangent from K3 again. The name keeps the JAX
    counterpart's; on a CPU tensor the kernel's plain version runs."""
    if pose.shape[0] == 0:
        return torch.zeros((0, params.n_verts, 3), dtype=torch.float32,
                           device=params.device)
    pose, shape = _f32_inputs(params, pose, shape)
    f32 = torch.float32
    v_shaped = ops.shape_blend(params.v_template.to(f32),
                               params.shape_basis.to(f32), shape)
    joints = ops.regress_joints(params.j_regressor.to(f32), v_shaped)
    rot = ops.rotation_matrix(pose)
    v_posed = ops.pose_blend(v_shaped, params.pose_basis.to(f32), rot)
    world_rot, world_t = ops.forward_kinematics(params.parents, rot, joints)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, joints)
    return fused_skin.skin_batched_ad(
        params.lbs_weights.to(f32).contiguous(), skin_rot.contiguous(),
        skin_t.contiguous(), v_posed.contiguous())


def forward_batched_pallas_fused(params: ManoParams, pose: torch.Tensor,
                                 shape: torch.Tensor) -> torch.Tensor:
    """Batched vertices [B, V, 3] float32: the PyTorch pre-stage, then
    blend and skin in one kernel launch (K4, ``ops/fused_forward.py``),
    so v_posed never reaches device memory. Differentiable to pose, shape
    and the five parameter tensors through the shared hybrid backward."""
    pose, shape = _f32_inputs(params, pose, shape)
    return fused_forward.forward_verts_fused_ad(params, pose, shape)


def forward_batched_pallas_fused_full(params: ManoParams, pose: torch.Tensor,
                                      shape: torch.Tensor) -> torch.Tensor:
    """Batched vertices [B, V, 3] float32 with the WHOLE forward in one
    kernel launch (K1, ``ops/fused_forward.py``). Differentiable to pose,
    shape and the five parameter tensors through the shared hybrid
    backward (its vertex cotangent from K3). The name keeps the JAX
    counterpart's; on a CPU tensor the kernel's plain version runs."""
    pose, shape = _f32_inputs(params, pose, shape)
    return fused_forward.forward_verts_fused_full_ad(params, pose, shape)


def forward_chunked(params: ManoParams, pose: torch.Tensor,
                    shape: torch.Tensor, chunk_size: int = 8192,
                    use_pallas: bool = False, use_pallas_fused: bool = False,
                    use_pallas_fused_full: bool = False) -> torch.Tensor:
    """Huge-batch vertices [B, V, 3], ``chunk_size`` rows at a time.

    Bounds each chunk's intermediates (the plain path's [chunk, V, 3, 3]
    blend) while every launch stays large. Any batch size works.
    ``use_pallas_fused_full`` runs each chunk through K1, written straight
    into its rows of one output (a trailing partial chunk launches with
    the rows left); ``use_pallas_fused`` through K4, ``use_pallas``
    through K3 (first flag set wins, in that order); the default is
    ``forward_batched(...).verts``. These three zero-pad a trailing
    partial chunk, concatenate the chunks and slice the padding off.
    Differentiable through every route. Spans (``obs/spans.py``): the
    entry, each chunk's launch, and on all but the K1 route the padding
    and the concatenation.
    """
    if use_pallas_fused_full:
        with spans.span(spans.ENTRY_CHUNKED):
            pose, shape = _f32_inputs(params, pose, shape)
            return fused_forward.forward_verts_fused_full_chunked_ad(
                params, pose, shape, chunk_size)
    if use_pallas_fused:
        chunk_fn = forward_batched_pallas_fused
    elif use_pallas:
        chunk_fn = forward_batched_pallas
    else:
        def chunk_fn(prm, p, s):
            return forward_batched(prm, p, s).verts
    b = pose.shape[0]
    with spans.span(spans.ENTRY_CHUNKED):
        if b == 0:
            return chunk_fn(params, pose, shape)
        pose_c, shape_c, _ = _pad_and_chunk(pose, shape, chunk_size)
        parts = [chunk_fn(params, p, s) for p, s in zip(pose_c, shape_c)]
        with spans.span(spans.CONCAT):
            verts = torch.cat(parts)
        return verts[:b]


def _pad_and_chunk(pose: torch.Tensor, shape: torch.Tensor, chunk_size: int):
    """Zero-pad the batch to a chunk multiple and reshape to
    [n_chunks, chunk, ...]; returns (pose, shape, chunk_size)."""
    b = pose.shape[0]
    chunk_size = max(1, min(chunk_size, b))   # max(1, ..) keeps B = 0 legal
    pad = (-b) % chunk_size
    if pad:
        with spans.span(spans.PAD):
            pose = torch.cat([pose, pose.new_zeros((pad, *pose.shape[1:]))])
            shape = torch.cat([shape,
                               shape.new_zeros((pad, *shape.shape[1:]))])
    n_chunks = (b + pad) // chunk_size
    return (pose.reshape(n_chunks, chunk_size, *pose.shape[1:]),
            shape.reshape(n_chunks, chunk_size, *shape.shape[1:]),
            chunk_size)


def keypoints_chunked(params: ManoParams, pose: torch.Tensor,
                      shape: torch.Tensor, tip_vertex_ids=None,
                      order: str = "mano",
                      chunk_size: int = 8192) -> torch.Tensor:
    """Huge-batch keypoints [B, 16(+T), 3] without a [B, V, 3] vertex slab:
    each chunk runs ``forward_batched`` and reduces to its keypoints, so
    full-mesh vertices never accumulate across the batch (the
    synthetic-label path: 21 keypoints for millions of poses)."""
    b = pose.shape[0]
    tips = resolve_tip_ids(tip_vertex_ids, params.n_verts)

    def chunk_fn(p, s):
        out = forward_batched(params, p, s)
        return select_keypoints(out.verts, out.posed_joints, tips, order)

    if b == 0:
        return chunk_fn(pose, shape)
    pose_c, shape_c, _ = _pad_and_chunk(pose, shape, chunk_size)
    return torch.cat([chunk_fn(p, s) for p, s in zip(pose_c, shape_c)])[:b]


def forward_posed_gather_fused(table: SubjectTable,
                               subject_idx: torch.Tensor,
                               pose: torch.Tensor,
                               compute_dtype=None) -> torch.Tensor:
    """Mixed-subject pose-only vertices [B, V, 3] float32 in one kernel
    launch (K2, ``ops/fused_posed.py``); inference only, indices mapped
    to rows as ``forward_posed_gather`` maps them (negative ones wrap
    once, then clamped). ``compute_dtype=torch.bfloat16`` launches K2's
    bf16 variant (the serving bf16 tier, the same roundings as
    ``forward_posed_gather(compute_dtype=...)``)."""
    b = pose.shape[0]
    with spans.span(spans.ENTRY_POSED_GATHER):
        pose = operand(pose.reshape(b, table.n_joints, 3), torch.float32)
        with spans.span(spans.COPY):
            idx = torch.as_tensor(subject_idx, device=table.v_shaped.device)
        return fused_posed.forward_posed_gather_fused(
            table, operand(idx, torch.int32), pose,
            compute_dtype=compute_dtype)


# ------------------------------------------------------------------ two hands
def stack_params(left: ManoParams, right: ManoParams) -> StackedParams:
    """Stack a (left, right) asset pair on a leading hand axis: one
    ``StackedParams`` with ``[2, ...]`` tensors (copies), ``side``
    "stacked" (never ``validate``d). The kinematic trees must match."""
    if tuple(left.parents) != tuple(right.parents):
        raise ValueError("cannot stack params with different kinematic trees")
    fields = {f: torch.stack([getattr(left, f), getattr(right, f)])
              for f in ARRAY_FIELDS}
    return StackedParams(**fields, parents=tuple(left.parents),
                         sides=(left.side, right.side), side=STACKED)


def forward_hands(stacked: StackedParams, pose: torch.Tensor,
                  shape: torch.Tensor) -> ManoOutput:
    """Multi-hand batched forward: pose [H, B, J, 3] (or [H, B, J*3]),
    shape [H, B, S] -> a ``ManoOutput`` of hand-major ``[H, B, ...]``
    tensors, each hand through ``forward_batched`` under its own params.
    Plain PyTorch, differentiable."""
    outs = [forward_batched(hand, pose[h], shape[h])
            for h, hand in enumerate(stacked.hands)]
    return ManoOutput(*(torch.stack(leaf) for leaf in zip(*outs)))


def forward_hands_pallas_fused_full(stacked: StackedParams,
                                    pose: torch.Tensor,
                                    shape: torch.Tensor) -> torch.Tensor:
    """Both hands' vertices [2, B, V, 3] float32 with the whole forward in
    ONE kernel launch (K5, ``ops/fused_forward.py``): the single-launch
    counterpart of ``forward_hands``. Inference only; pose [2, B, J, 3]
    (or flat [2, B, J*3]), shape [2, B, S]. On a CPU tensor the kernel's
    plain version runs."""
    with spans.span(spans.ENTRY_HANDS):
        return fused_forward.forward_verts_fused_full_hands(
            stacked, operand(pose, torch.float32),
            operand(shape, torch.float32))
