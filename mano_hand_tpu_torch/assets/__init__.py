"""MANO assets: the parameter schema, synthetic assets, weight conversion,
left/right mirroring."""

from mano_hand_tpu_torch.assets.convert import params_from_numpy
from mano_hand_tpu_torch.assets.mirror import mirror_params
from mano_hand_tpu_torch.assets.scans import mirror_pose, mirror_verts
from mano_hand_tpu_torch.assets.schema import (
    ARRAY_FIELDS, ManoParams, StackedParams, validate,
)
from mano_hand_tpu_torch.assets.synthetic import synthetic_arrays, synthetic_params

__all__ = [
    "ARRAY_FIELDS", "ManoParams", "StackedParams", "mirror_params",
    "mirror_pose", "mirror_verts", "params_from_numpy", "synthetic_arrays",
    "synthetic_params", "validate",
]
