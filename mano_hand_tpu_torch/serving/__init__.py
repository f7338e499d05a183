"""Serving: the bucket policy, the precision policy, the micro-batching
engine with its resilience and admission layer, and the engine's
drills."""

from mano_hand_tpu_torch.serving.buckets import (
    bucket_for, bucket_sizes, pad_rows, pad_tree_rows, subject_index_rows,
)
from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError
from mano_hand_tpu_torch.serving.measure import (
    overload_drill_run, recovery_drill_run,
)
from mano_hand_tpu_torch.serving.precision import PrecisionPolicy

__all__ = ["PrecisionPolicy", "ServingEngine", "ServingError", "bucket_for",
           "bucket_sizes", "overload_drill_run", "pad_rows", "pad_tree_rows",
           "recovery_drill_run", "subject_index_rows"]
