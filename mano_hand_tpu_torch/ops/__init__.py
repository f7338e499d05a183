"""The port's ops: plain PyTorch building blocks of the MANO forward
(and the rotation forms and normals beside it), and
the hand-written CUDA kernels (``fused_forward`` K1, K5 and K4,
``fused_posed`` K2 with its bf16 variant, ``fused_skin`` K3) with their
plain versions.
Importing builds nothing: the kernels compile at their first launch
(``ops/_build.py``)."""

from mano_hand_tpu_torch.ops.blend import pose_blend, regress_joints, shape_blend
from mano_hand_tpu_torch.ops.fk import (
    forward_kinematics, skinning_transforms, tree_levels,
)
from mano_hand_tpu_torch.ops.lbs import skin
from mano_hand_tpu_torch.ops.normals import (
    batched_vertex_normals, face_normals, vertex_normals,
)
from mano_hand_tpu_torch.ops.rodrigues import (
    axis_angle_from_matrix, matrix_from_6d, matrix_from_quaternion,
    matrix_to_6d, rotation_matrix, skew,
)

__all__ = [
    "axis_angle_from_matrix", "batched_vertex_normals", "face_normals",
    "forward_kinematics", "matrix_from_6d", "matrix_from_quaternion",
    "matrix_to_6d", "pose_blend", "regress_joints", "rotation_matrix",
    "shape_blend", "skew", "skin", "skinning_transforms", "tree_levels",
    "vertex_normals",
]
