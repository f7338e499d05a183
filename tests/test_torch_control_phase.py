"""``chip_smoke.py``'s ``control`` phase rehearsed on the CPU at reduced
sizes, one part a test: every gate of the card run but the launch counts,
which need the card (``serve --control`` runs as a ``--device cpu``
subprocess here, K2's plain version behind it)."""

import warnings

import pytest
import torch

LAUNCHES = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread here, so the ``serve`` process gets one too: the
    part stays light beside the rest of a parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _params():
    from mano_hand_tpu_torch.assets import synthetic_params

    return synthetic_params(seed=0, dtype=torch.float32, device="cpu")


def test_chip_smoke_control_drill_part_rehearsed_on_the_cpu():
    import chip_smoke

    line = chip_smoke.ct_drill(
        torch.device("cpu"), _params(), lambda: dict(LAUNCHES), lambda: None,
        kw=dict(trace_duration_s=0.7, workers=8, pairs=1, max_bucket=4,
                max_queued=8, tier1_quota=2, sat_latency_s=0.01,
                cadence_s=0.03), comparative=False)
    # The legs' comparison belongs to the full-size run; the rest holds.
    crit = dict(line["criteria"])
    assert {crit.pop("tier0_goodput_held"),
            crit.pop("tier1_served_strictly_more")} <= {True, False}
    assert all(crit.values()), crit
    assert len(line["legs"]) == 3 and line["legs"][-1]["crash_injected"]
    assert len(line["trace"]["sha256"]) == 64
    assert line["launches"] == LAUNCHES


def test_chip_smoke_control_ladder_part_rehearsed_on_the_cpu():
    import chip_smoke

    line = chip_smoke.ct_ladder(
        torch.device("cpu"), _params(), lambda: dict(LAUNCHES), lambda: None,
        bucket=8, subjects=3, requests=12, trials=2, threads=2)
    assert set(line["by_bias"]) == {"0", "1", "2", "3"}
    padded = [line["by_bias"][str(b)]["rows_padded"] for b in range(4)]
    assert padded == sorted(padded) and padded[-1] > padded[0]
    assert all(len(v["ms_trials"]) == 2 for v in line["by_bias"].values())
    assert line["by_bias"]["3"]["max_abs_err_vs_bias0"] <= 1e-5
    ct = line["controller"]
    assert 3 in ct["trajectory"] and ct["trajectory"][-1] == 0
    assert ct["steady_captures"] == 0


def test_chip_smoke_control_serve_part_rehearsed_on_the_cpu():
    import chip_smoke

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.ct_serve(
            torch.device("cpu"), _params(), bucket=8, subjects=2,
            clients=2, threads=6, requests=24, max_queued=8, tier1_quota=2,
            trace_kw=dict(duration_s=1.5), ready_timeout_s=120.0,
            drain_timeout_s=5.0)
    assert line["status_before"]["control"]["attached"]
    assert line["status_after"]["control"]["running"]
    assert "mano_load_control_attached" in line["load_control_gauges"]
    assert line["crowd"]["max_abs_err"] <= 1e-5
    assert line["crowd"]["requests"] == line["trace"]["stats"]["arrivals"]
    assert line["steady_captures"] == 0
    ex = line["exit_launches"]
    assert ex["dispatches_gathered"] > 0 and ex["K2"] == 0   # no card
