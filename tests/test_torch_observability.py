"""The smoke's ``observability`` phase (``chip_smoke.observability``)
rehearsed on the CPU at reduced sizes: every gate of the card run but the
launch counts and the kernel names, which need the card."""

import warnings

import torch


def test_chip_smoke_observability_phase_rehearsed_on_the_cpu():
    import chip_smoke

    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    small = dict(requests=12, max_rows=4, max_bucket=8, trials=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.observability(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            bucket=8, threads=2, requests=3, race_bucket=8, timed_probes=2,
            trace_buckets=(1, 8), trace_dispatches=3, eager_calls=2,
            tracing_kw=small, metrics_kw=dict(small, reps=1))
    assert line["phase"] == "observability"
    assert line["span_accounting"]["closed_by_kind"] == {
        "ok": 10, "error": 1, "expired": 1}
    assert line["runtime_events"]["compile"] == 12          # 3 x 4 buckets
    assert line["golden"]["golden_status"] == "match"
    assert line["clean_probe"]["gather"]["max_abs_err"] == 0.0
    assert line["wrong_fault"]["drifted_families"] == [
        "full", "gather", "gather_bf16"]
    assert line["race"]["probes"] >= 2
    assert set(line["race"]["served_vs_direct_max_abs_err"].values()) == {
        0.0}
    assert line["metrics"]["serving_unexported_keys"] == 0
    assert line["drills"]["sentinel_drill"]["detected"]
    prof = line["profile"]
    assert set(prof) == {"full_b1", "full_b8", "gather_f32_b1",
                         "gather_f32_b8", "gather_bf16_b1",
                         "gather_bf16_b8", "eager_b8"}
    assert prof["full_b8"]["device_events"] == 0    # no card, no device op
    assert prof["full_b8"]["engine_export"]
    assert "b8/tier2" in line["profile_stage_breakdown"]
