"""``chip_smoke.py``'s ``lanes_store`` phase rehearsed on the CPU at reduced
sizes: every gate of the card run but the launch counts, the streams in
the profile and the bit identities that rest on K2's rows ignoring their
batchmates, which need the card."""

import warnings

import torch


def test_chip_smoke_lanes_store_phase_rehearsed_on_the_cpu():
    import chip_smoke

    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.lanes_store(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            drill_kw=dict(requests_per_pass=12, subjects=3, workers=2,
                          max_rows=2, max_bucket=4),
            lanes=(None, 2),
            buy_kw=dict(min_bucket=1, max_bucket=8, subjects=2, threads=2,
                        requests=16, most=2, trials=1, b2b=3),
            store_kw=dict(subjects=300, requests_per_leg=40, max_subjects=8,
                          warm_capacity=12, max_bucket=4),
            loss_kw=dict(subjects=4, requests=4, max_bucket=4))
    assert line["phase"] == "lanes_store"
    dr = line["lane_drill"]
    assert dr["futures_resolved_fraction"] == 1.0
    assert dr["lane_failovers"] >= 1 and dr["cpu_failovers"] == 0
    buy = line["what_lanes_buy"]
    assert set(buy["drain_req_per_sec"]) == {"lanes_None", "lanes_2"}
    assert set(buy["profile"]) == {"lanes_None", "lanes_2"}
    assert buy["vs_lane_less_max_abs_err"]["f32"] <= 1e-6
    st = line["store_drill"]
    assert st["futures_resolved_fraction"] == 1.0
    assert max(st["per_lane_device_rows_sharded"]) < min(
        st["per_lane_device_rows_replicated"])
    ll = line["lane_loss_sharded"]
    assert all(ll["stages"].values())
    assert ll["shard_rebalances"] == ll["shard_restores"] == 1
