"""``chip_smoke.py``'s ``fleet`` phase rehearsed on the CPU at reduced
sizes, one leg a test (the capacity leg's is in
``tests/test_torch_fleet_capacity.py``): every gate of the card run but
the launch counts, the device lock and ``nvidia-smi``, which need the
card (the workers run as ``--device cpu`` subprocesses here, K2's plain
version behind them).
The self-heal leg boots a replacement worker per death and runs over
40 s alone, so its rehearsal is slow-marked (the drill's own plumbing
test runs on the card in ``tests/test_torch_cuda.py``)."""

import warnings

import pytest
import torch

LAUNCHES = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread here, so every worker process gets one too (the
    drills pass the caller's count on): the fleets stay light beside the
    rest of a parallel test run, and the workers' fits round as the
    in-process references do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _params():
    from mano_hand_tpu_torch.assets import synthetic_params

    return synthetic_params(seed=0, dtype=torch.float32, device="cpu")


def test_chip_smoke_fleet_drill_leg_rehearsed_on_the_cpu():
    import chip_smoke

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.fl_fleet_drill(
            torch.device("cpu"), _params(), lambda: dict(LAUNCHES),
            lambda: None, dict(chip_smoke.FL_DRILL, streams=3,
                               frames_per_stream=3, stream_workers=3,
                               unique_tracks=2, max_bucket=2))
    assert line["reference_platform"] == "cpu"
    assert line["cold_boot_zero_compiles"] and line["drain"]["clean"]
    assert line["launches_in_process"] == LAUNCHES


@pytest.mark.slow
def test_chip_smoke_fleet_selfheal_leg_rehearsed_on_the_cpu():
    import chip_smoke

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.fl_selfheal_drill(
            torch.device("cpu"), _params(), lambda: dict(LAUNCHES),
            lambda: None, dict(streams=3, frames_per_stream=6,
                               stream_workers=3, unique_tracks=2,
                               max_bucket=4, max_subjects=8,
                               store_warm_capacity=4))
    assert set(line["mttr_ms_by_channel"]) == {"exit", "probe"}
    assert len(line["mttr_ms_by_channel"]["probe"]) == 1
