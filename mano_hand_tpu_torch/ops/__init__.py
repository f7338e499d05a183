"""The port's ops: plain PyTorch building blocks of the MANO forward, and
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
from mano_hand_tpu_torch.ops.rodrigues import rotation_matrix, skew

__all__ = [
    "forward_kinematics", "pose_blend", "regress_joints", "rotation_matrix",
    "shape_blend", "skew", "skin", "skinning_transforms", "tree_levels",
]
