"""The MANO forward core (``core``), clip evaluation (``anim``), the
stateful reference-style wrapper (``layer.MANOModel``) and the float64
NumPy oracle (``oracle``)."""

from mano_hand_tpu_torch.models.core import (
    ManoOutput,
    ShapedHand,
    SubjectTable,
    decode_pca,
    forward,
    forward_batched,
    forward_batched_pallas,
    forward_batched_pallas_fused,
    forward_batched_pallas_fused_full,
    forward_batched_rotmats,
    forward_chunked,
    forward_fused,
    fused_blend_bases,
    forward_hands,
    forward_hands_pallas_fused_full,
    forward_pca,
    forward_posed,
    forward_posed_batched,
    forward_posed_gather,
    forward_posed_rotmats,
    forward_rotmats,
    keypoints,
    keypoints_chunked,
    resolve_tip_ids,
    sample_poses,
    select_keypoints,
    specialize,
    stack_params,
    stack_shaped,
    subject_table,
    table_grow,
    table_row,
    table_set_row,
)
from mano_hand_tpu_torch.models import oracle
from mano_hand_tpu_torch.models.layer import MANOModel

__all__ = [
    "MANOModel", "ManoOutput", "ShapedHand", "SubjectTable", "decode_pca",
    "forward", "forward_batched", "forward_batched_pallas",
    "forward_batched_pallas_fused", "forward_batched_pallas_fused_full",
    "forward_batched_rotmats", "forward_chunked", "forward_fused",
    "forward_hands", "forward_hands_pallas_fused_full", "forward_pca",
    "forward_posed", "forward_posed_batched", "forward_posed_gather",
    "forward_posed_rotmats", "forward_rotmats", "fused_blend_bases",
    "keypoints",
    "keypoints_chunked", "oracle", "resolve_tip_ids", "sample_poses",
    "select_keypoints", "specialize", "stack_params", "stack_shaped",
    "subject_table", "table_grow", "table_row", "table_set_row",
]
