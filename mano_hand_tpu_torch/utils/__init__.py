"""Utilities: the runtime config, the input pipeline, timing and traces,
serving counters and the cooperative device lock."""

from mano_hand_tpu_torch.utils.config import ManoConfig
from mano_hand_tpu_torch.utils.data import batches, prefetch_to_device
from mano_hand_tpu_torch.utils.profiling import Timer, torch_trace

__all__ = ["ManoConfig", "Timer", "batches", "prefetch_to_device",
           "torch_trace"]
