"""The smoke's ``program_cache`` phase (``chip_smoke.program_cache``)
rehearsed on the CPU: the engine's programs against their eager
functions, steady traffic with no build, the lattice baked and booted
(under the caller's "high"), and cold boots in fresh processes."""

import warnings

import torch


def test_chip_smoke_program_cache_phase_rehearsed_on_the_cpu():
    """The smoke's ``program_cache`` phase end to end on the CPU at reduced
    sizes (every gate of the card run but the launch counts and the GPU
    memory, which need the card; the drill is rehearsed on its own in
    ``tests/test_torch_drills.py``), cold boots in fresh processes
    included."""
    import chip_smoke

    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.program_cache(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            bucket=2, timed_buckets=(1, 2), timed=2, threads=2, requests=3,
            drill=None)
    assert line["phase"] == "program_cache" and line["captures"] == 6
    assert set(line["graph_vs_eager_max_abs_err"].values()) == {0.0}
    assert line["traffic"]["steady_captures"] == 0
    lat = line["lattice"]
    assert lat["aot_loads"] == 4 and lat["compiles"] == 0
    assert lat["fused_boot"] == {"aot_loads": 2, "compiles": 4}
    assert lat["lattice_vs_live_max_abs_err"] == 0.0
    assert line["cold_boot"]["lattice"]["sources"] == ["aot"]
    assert line["ms_per_dispatch"]["gather_bf16"]["2"]["graph"]["n"] == 2
