"""MANO assets: the parameter schema, loaders for every asset format,
synthetic assets, weight conversion, scan poses, left/right mirroring
and the asset audit (``verify``)."""

from mano_hand_tpu_torch.assets.convert import params_from_numpy
from mano_hand_tpu_torch.assets.loader import (
    load_dumped_pickle, load_model, load_npz, load_official_pickle,
    load_smpl_pickle, save_dumped_pickle, save_npz,
)
from mano_hand_tpu_torch.assets.mirror import mirror_params
from mano_hand_tpu_torch.assets.scans import (
    decode_scan_poses, extract_scan_poses, mirror_pose, mirror_verts,
    save_scan_poses,
)
from mano_hand_tpu_torch.assets.schema import (
    ARRAY_FIELDS, ManoParams, StackedParams, validate,
)
from mano_hand_tpu_torch.assets.synthetic import (
    synthetic_arrays, synthetic_pair, synthetic_params,
)

__all__ = [
    "ARRAY_FIELDS", "ManoParams", "StackedParams", "decode_scan_poses",
    "extract_scan_poses", "load_dumped_pickle", "load_model", "load_npz",
    "load_official_pickle", "load_smpl_pickle", "mirror_params",
    "mirror_pose", "mirror_verts", "params_from_numpy",
    "save_dumped_pickle", "save_npz", "save_scan_poses", "synthetic_arrays",
    "synthetic_pair", "synthetic_params", "validate",
]
