"""``chip_smoke.py``'s ``parallel`` phase rehearsed on the CPU at reduced
sizes: part (a)'s rank process and part (b)'s two, gloo on CPU tensors
here (NCCL and the launch counts need the card), every other gate of the
card run."""

import torch


def test_chip_smoke_parallel_phase_rehearsed_on_the_cpu(monkeypatch):
    import chip_smoke

    # One thread a rank process: the three stay light beside the rest of
    # a parallel test run.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = chip_smoke.parallel(torch.device("cpu"), "cpu", dp_batch=16,
                               smap_batch=8, fit_batch=8)
    a, b = line["a"], line["b"]
    assert a["backend"] == "gloo" and a["mesh"] == [1, 1]
    for name in ("dp_full", "dp_k4", "shard_map", "gspmd"):
        assert a[name]["max_abs_err_single"] <= chip_smoke.KERNEL_TOL
        assert a[name]["max_abs_err_oracle"] <= chip_smoke.ORACLE_TOL
    # The plain versions run on CPU tensors: no kernel launch here.
    assert a["dp_full"]["launches"] == a["dp_k4"]["launches"] == {
        "K1": 0, "K4": 0}
    assert a["shard_map"]["comms"] == {"c10d.allreduce_": 1}
    assert a["fit"]["fall"] > chip_smoke.PL_FIT_FALL
    assert a["fit"]["max_rel_vs_unsharded"] <= chip_smoke.PL_FIT_REL_TOL
    assert [r["dp_full"]["slice"] for r in b["ranks"]] == [[0, 8], [8, 16]]
    assert all(r["backend"] == "gloo" and r["shard_map"]["comms"] == {
        "c10d.allreduce_": 1} for r in b["ranks"])
    assert [r["shard_map"]["local"] for r in b["ranks"]] == [[8, 389, 3]] * 2
    assert b["dp_full_max_abs_err_vs_a"] <= chip_smoke.KERNEL_TOL
    assert b["shard_map_max_abs_err_vs_a"] <= chip_smoke.KERNEL_TOL
    assert b["fit_max_rel_vs_a"] <= chip_smoke.PL_FIT_REL_TOL
    assert line["launches"] == {"K1": 0, "K4": 0}
