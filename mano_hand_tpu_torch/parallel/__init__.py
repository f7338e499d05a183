"""Multi-device execution over ``torch.distributed``: meshes of ranks, the
vertex-sharded parameter layout, the sharded forwards (one of them K1 or
K4 on every rank), the sharded fit step and the multi-process bootstrap;
and ``lane_devices``, the devices the serving engine's dispatch lanes run
on."""

from mano_hand_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    lane_devices,
    make_mesh,
    replicated,
)
from mano_hand_tpu_torch.parallel.sharding import (
    PARAM_SPECS,
    ShardedParams,
    gspmd_forward,
    pad_verts,
    pallas_forward_dp,
    shard_map_forward,
    shard_params,
)
from mano_hand_tpu_torch.parallel.fit import FitState, init_state, make_fit_step
from mano_hand_tpu_torch.parallel import multihost

__all__ = [
    "multihost",
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "PARAM_SPECS",
    "ShardedParams",
    "shard_params",
    "pad_verts",
    "gspmd_forward",
    "pallas_forward_dp",
    "shard_map_forward",
    "FitState",
    "init_state",
    "make_fit_step",
    "lane_devices",
]
