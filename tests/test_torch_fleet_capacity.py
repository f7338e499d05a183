"""``chip_smoke.py``'s ``fleet`` phase, its capacity leg rehearsed on the
CPU at reduced sizes: 2 ``--device cpu`` worker processes, a ``proxy``
process over 1 and 2 of them, client processes through it and straight
at the workers, every result against an in-process call of K2's plain
version, every gate of the card run but the launch counts, the device
lock and ``nvidia-smi``, which need the card."""

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


def test_chip_smoke_fleet_capacity_leg_rehearsed_on_the_cpu():
    import chip_smoke

    from mano_hand_tpu_torch.assets import synthetic_params

    params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    cap = chip_smoke.fl_capacity(
        torch.device("cpu"), params, lambda: dict(LAUNCHES),
        lambda: None, workers=2, bucket=8, subjects=3, clients=2,
        threads=2, requests=12, proxy_turns=(1, 2), direct_turns=(2,),
        ready_timeout_s=120.0)
    assert [(t["mode"], t["workers"]) for t in cap["trials"]] == [
        ("proxy", 1), ("proxy", 2), ("direct", 2)]
    for t in cap["trials"]:
        assert t["requests"] == 24 and t["req_per_s"] > 0
        assert t["max_abs_err"] <= 1e-5 and t["util_pct"] is None
    assert set(cap["req_per_s"]) == {"proxy_1", "proxy_2", "direct_2"}
    assert cap["device_lock"] == {"w0": "off", "w1": "off"}
    assert cap["status_server"]["backends"] == ["w0", "w1"]
    assert all(r["drain"]["drained"] for r in cap["proxy_exit"].values())
    # No card: the plain version ran, K2 launched nowhere, and every
    # worker still reports its gathered dispatches.
    for ln in cap["exit_launches"].values():
        assert ln["K2"] == ln["K2_bf16"] == 0
        assert ln["dispatches_gathered"] == ln["dispatches"] > 0
        assert ln["gathered_captures"] > 0
    assert isinstance(cap["affinity"], list) and cap["cpu_count"] >= 1
