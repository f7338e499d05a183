"""``chip_smoke.py``'s ``pipeline_streams`` phase rehearsed on the CPU at
reduced sizes: every gate of the card run but the launch counts, the
kernel names and the bit identities that rest on K2's rows ignoring
their batchmates, which need the card."""

import warnings

import torch


def test_chip_smoke_pipeline_streams_phase_rehearsed_on_the_cpu():
    import chip_smoke

    # Torch's own thread count: the phase's references run on this thread
    # and the engine's bakes on its dispatcher, and a count set on this
    # thread alone would split their CPU reductions differently.
    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.pipeline_streams(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            bucket=8,
            drill_kw=dict(requests_steady=24, requests_chaos=12,
                          calibrate_requests=16, trials=1, max_rows=2),
            threads=2, depth_requests=6, trace_buckets=(1, 8),
            trace_dispatches=3,
            stream_kw=dict(streams=4, frames_per_stream=3, subjects=2,
                           workers=4, warm_steps=4,
                           cold_steps_candidates=(8,), calib_probes=2,
                           fit_trials=1, min_bucket=1, max_bucket=8),
            stream_bucket=4,
            store_kw=dict(subjects=40, requests=64, max_subjects=4,
                          warm_capacity=4, bucket=4))
    assert line["phase"] == "pipeline_streams"
    assert line["drill"]["futures_resolved_fraction"] == 1.0
    assert line["drill"]["pipelined_pipeline_inflight_peak"] >= 2
    assert line["across_depths"]["max_abs_err"]["full_same_bucket"] in (
        None, 0.0)
    assert set(line["profile"]) == {"serial_b1", "serial_b8",
                                    "pipelined_b1", "pipelined_b8"}
    assert line["stream_drill"]["frames_resolved_fraction"] == 1.0
    assert line["sessions"]["f32_vs_posed_program_max_abs_err"] == 0.0
    st = line["store"]
    assert st["results_vs_fresh_bake_max_abs_err"] == 0.0
    assert st["damaged_page"]["damage_counted"] == 1
