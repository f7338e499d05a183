"""Serving: the bucket policy, the precision policy, the micro-batching
engine with its resilience and admission layer, its program cache and
persistence, its pipelined dispatch, streaming sessions, tiered subject
store and dispatch lanes, the closed-loop controller and its traffic
traces, and the engine's drills, benchmark protocols and observability
protocols."""

from mano_hand_tpu_torch.serving.buckets import (
    bucket_for, bucket_sizes, pad_rows, pad_tree_rows, subject_index_rows,
)
from mano_hand_tpu_torch.serving.control import ControlConfig, Controller
from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError
from mano_hand_tpu_torch.serving.lanes import Lane, LaneSet
from mano_hand_tpu_torch.serving.measure import (
    coalesce_bench_run, cold_start_drill_run, control_drill_run,
    dispatch_pipeline_drill_run,
    edge_drill_run, fleet_drill_run, lane_drill_run, measure_overhead,
    metrics_overhead_run, overload_drill_run, posed_kernel_bench_run,
    precision_bench_run, recovery_drill_run, selfheal_drill_run,
    serve_bench_run, stream_drill_run, subject_store_drill_run,
    tracing_overhead_run,
)
from mano_hand_tpu_torch.serving.precision import PrecisionPolicy
from mano_hand_tpu_torch.serving.streams import (
    FrameResult, StreamManager, StreamSession,
)

__all__ = ["ControlConfig", "Controller", "FrameResult", "Lane", "LaneSet",
           "PrecisionPolicy",
           "ServingEngine", "ServingError", "StreamManager",
           "StreamSession", "bucket_for", "bucket_sizes",
           "coalesce_bench_run", "cold_start_drill_run",
           "control_drill_run",
           "dispatch_pipeline_drill_run", "edge_drill_run",
           "fleet_drill_run", "lane_drill_run", "measure_overhead", "metrics_overhead_run",
           "overload_drill_run", "pad_rows", "pad_tree_rows",
           "posed_kernel_bench_run", "precision_bench_run",
           "recovery_drill_run", "selfheal_drill_run", "serve_bench_run",
           "stream_drill_run",
           "subject_index_rows", "subject_store_drill_run",
           "tracing_overhead_run"]
