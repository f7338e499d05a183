"""``chip_smoke.py``'s ``serve_edge`` phase rehearsed on the CPU at bucket 8
and reduced sizes: every gate of the card run but the launch counts, the
device lock and the card's status probe, which need the card (``serve``
runs as a ``--device cpu`` subprocess here, K2's plain version behind
it)."""

import warnings

import torch


def test_chip_smoke_serve_edge_phase_rehearsed_on_the_cpu():
    import chip_smoke

    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    small = dict(requests=8, max_bucket=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.serve_edge(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            bucket=8,
            sb_kw=dict(requests=12, max_rows=4, max_bucket=8, trials=2),
            co_kw=dict(subjects=3, trials=1, **small),
            pk_kw=dict(subjects=3, trials=1, lm_batch=2, lm_steps=(1, 2),
                       lm_iters=1, **small),
            pr_kw=dict(subjects=3, trials=1, **small),
            ed_kw=dict(saturation=3.0, bursts=6, shed_probe_requests=8,
                       workers=8, streams=1, frames_per_stream=2,
                       drain_timeout_s=5.0),
            wire_requests=8, timed=10, ready_timeout_s=120.0,
            drain_timeout_s=5.0)
    assert line["phase"] == "serve_edge"
    sb = line["serve_bench"]
    assert sb["every_result_vs_direct_max_abs_err"] <= 1e-5
    assert sb["steady_recompiles"] == 0 and len(sb["ratio_trials"]) == 2
    assert line["coalesce"]["gather_vs_posed_max_abs_err"] <= 1e-5
    pk = line["posed_kernel"]
    assert pk["interpret"] is True and pk["fused_vs_gather_max_abs_err"] \
        <= 1e-5
    pr = line["precision"]
    assert 1e-6 < pr["bf16_max_abs_err"] <= pr["bf16_err_envelope"]
    ed = line["edge_drill"]
    assert ed["stream"]["wire_vs_inprocess_max_abs_err"] == 0.0
    assert ed["spans"]["spans_open"] == 0
    sv = line["serve"]
    assert sv["rc"] == 0 and sv["device_lock"] == "off"
    assert sv["wire_vs_k2_max_abs_err"] <= 1e-5
    assert sv["status_server"]["ok"] and sv["steady_captures"] == 0
    assert set(sv["one_row_ms"]) == {"requests_each", "wire",
                                     "in_process_submit"}
    st = line["status"]
    assert st["rc"] == 0 and st["probes"]["cpu"]["ok"]
    # No card here: the cuda probe fails and the report degrades.
    assert st["degraded"] is True and not st["probes"]["cuda"]["ok"]
