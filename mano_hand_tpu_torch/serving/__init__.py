"""Serving: the bucket policy, the precision policy and the micro-batching
engine."""

from mano_hand_tpu_torch.serving.buckets import (
    bucket_for, bucket_sizes, pad_rows, subject_index_rows,
)
from mano_hand_tpu_torch.serving.engine import ServingEngine
from mano_hand_tpu_torch.serving.precision import PrecisionPolicy

__all__ = ["PrecisionPolicy", "ServingEngine", "bucket_for", "bucket_sizes",
           "pad_rows", "subject_index_rows"]
