"""Serving: the bucket policy, the precision policy, the micro-batching
engine with its resilience and admission layer, its program cache and
persistence, its pipelined dispatch, streaming sessions and tiered
subject store, and the engine's drills and observability protocols."""

from mano_hand_tpu_torch.serving.buckets import (
    bucket_for, bucket_sizes, pad_rows, pad_tree_rows, subject_index_rows,
)
from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError
from mano_hand_tpu_torch.serving.measure import (
    cold_start_drill_run, dispatch_pipeline_drill_run, metrics_overhead_run,
    overload_drill_run, recovery_drill_run, stream_drill_run,
    tracing_overhead_run,
)
from mano_hand_tpu_torch.serving.precision import PrecisionPolicy
from mano_hand_tpu_torch.serving.streams import (
    FrameResult, StreamManager, StreamSession,
)

__all__ = ["FrameResult", "PrecisionPolicy", "ServingEngine",
           "ServingError", "StreamManager", "StreamSession", "bucket_for",
           "bucket_sizes", "cold_start_drill_run",
           "dispatch_pipeline_drill_run", "metrics_overhead_run",
           "overload_drill_run", "pad_rows", "pad_tree_rows",
           "recovery_drill_run", "stream_drill_run", "subject_index_rows",
           "tracing_overhead_run"]
