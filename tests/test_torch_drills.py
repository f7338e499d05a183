"""The port's engine drills (``serving/measure.py``: recovery, overload
and cold start, and the tracing-overhead protocol) on the CPU, at small
sizes: their done-criteria hold, and they return all of the JAX drills'
keys, the tracer's ``flight_record`` included, with every span closed
exactly once."""

import ast
import pathlib
import warnings

import pytest
import torch

from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.runtime import health
from mano_hand_tpu_torch.serving import (
    cold_start_drill_run, overload_drill_run, recovery_drill_run,
    tracing_overhead_run,
)

JAX_MEASURE = (pathlib.Path(__file__).resolve().parent.parent
               / "mano_hand_tpu" / "serving" / "measure.py")


def _balanced(flight: dict, reason: str) -> dict:
    """A drill's flight record: its reason, and every span it opened
    closed exactly once."""
    assert flight["schema"] == 1 and flight["reason"] == reason
    acc = flight["accounting"]
    assert acc["spans_started"] == acc["spans_closed"] > 0, acc
    assert acc["spans_open"] == 0 and acc["spans_double_closed"] == 0, acc
    return acc


def _dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_keys(fn_name):
    """(returned keys, {assigned name: dict keys}) of a JAX drill, read
    from its source (running the JAX drills here would cost their
    compiles for nothing but a key list)."""
    tree = ast.parse(JAX_MEASURE.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    returns = [n.value for n in ast.walk(fn)
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assigned = {n.targets[0].id: _dict_keys(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and isinstance(n.targets[0], ast.Name)}
    # A drill that builds ``out`` and returns it: the keys of ``out``.
    return (_dict_keys(returns[-1]) if returns else assigned["out"]), assigned


@pytest.fixture(scope="module")
def params():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


@pytest.mark.parametrize("posed_kernel", ["xla", "fused"])
def test_recovery_drill_meets_its_criteria(params, posed_kernel):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = recovery_drill_run(params, requests_per_class=6, max_rows=4,
                                 max_bucket=4, deadline_s=0.5, seed=2,
                                 device="cpu", posed_kernel=posed_kernel)
    keys, _ = _jax_keys("recovery_drill_run")
    assert set(out) == keys
    acc = _balanced(out["flight_record"], "recovery_drill_complete")
    assert acc["incidents"] >= 1         # deadline kills, failovers
    assert set(out["classes"]) == {"transient", "latency", "hang",
                                   "persistent"}
    for name, cls in out["classes"].items():
        assert cls["unresolved"] == 0, (name, cls)
        assert cls["resolved_ok"] + cls["resolved_error"] == \
            cls["submitted"], (name, cls)
    assert out["futures_resolved_fraction"] == 1.0
    assert out["failover_vs_cpu_direct_max_abs_err"] == 0.0
    assert out["failover_posed_vs_cpu_direct_max_abs_err"] == 0.0
    assert out["post_recovery_steady_recompiles"] == 0
    assert out["post_recovery_ok"] == 6
    assert out["classes"]["hang"]["deadline_kills"] >= 1
    assert out["classes"]["transient"]["retries"] >= 2
    failovers = out["classes"]["persistent"]["failovers"]
    assert failovers >= 6
    assert sum("failed over" in str(w.message) for w in caught) == failovers
    assert out["breaker_opens"] >= 1
    assert out["breaker_state_final"] == health.HEALTHY
    assert out["failover_overhead_ratio"] > 0


def test_overload_drill_meets_its_criteria(params):
    out = overload_drill_run(params, bursts=10, seed=5, device="cpu")
    keys, assigned = _jax_keys("overload_drill_run")
    assert set(out) == keys
    acc = _balanced(out["flight_record"], "overload_drill_complete")
    # The probe's sheds and the drill's submits, all span-accounted.
    assert acc["spans_started"] >= out["submitted"] + \
        out["shed_probe"]["sheds"]
    assert acc["closed_by_kind"]["shed"] >= out["shed_probe"]["sheds"]
    assert set(out["shed_probe"]) == assigned["shed_probe"]
    assert out["resolved_within_budget_fraction"] == 1.0
    assert out["outcomes"]["unresolved"] == 0
    assert out["outcomes"]["error"] == 0
    probe = out["shed_probe"]
    assert probe["sheds"] > 0 and probe["dispatches"] == 0
    assert not probe["engine_started"]
    assert out["steady_recompiles"] == 0
    assert out["backlog_peak"] <= out["max_queued"]
    assert out["saturation_achieved"] > 1.0
    assert out["outcomes"]["shed"] > 0
    assert out["tier0_goodput"] >= 0.95
    # load() with the drill's tracer: its latency quantiles and backlog age
    assert set(out["load_mid_drill"]) == {
        "outstanding", "queued", "max_queued", "admission", "backlog_peak",
        "latency_by_tier", "backlog_age_s", "streams"}


def test_overload_drill_small_max_queued_calibrates(params):
    out = overload_drill_run(params, max_queued=4, tier1_quota=2, bursts=2,
                             seed=3, device="cpu")
    assert out["outcomes"]["unresolved"] == 0
    assert out["backlog_peak"] <= 4
    with pytest.raises(ValueError):
        overload_drill_run(params, max_queued=0, bursts=1, device="cpu")


def test_chip_smoke_resilience_phase_rehearsed_on_the_cpu():
    """The smoke's ``resilience`` phase end to end on the CPU at reduced
    sizes (every gate of the card run but the launch counts and the
    device stall, which need the card)."""
    import chip_smoke

    launches = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K2_bf16"), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line = chip_smoke.resilience(
            torch.device("cpu"), lambda: dict(launches), lambda: None,
            bucket=8, drill_rows=4, drill_deadline_s=0.5, threads=2,
            requests=3, timed=2, bursts=10)
    assert line["phase"] == "resilience"
    assert line["recovery"]["futures_resolved_fraction"] == 1.0
    assert line["failover"]["cpu_tier_vs_cpu_direct_max_abs_err"] == 0.0
    assert line["overload"]["tier0_goodput"] >= 0.95
    assert line["healthy"]["replay_vs_unsupervised_max_abs_err"] == 0.0
    assert line["healthy"]["ms_per_dispatch"]["supervised"]["median"] > 0
    assert line["probe"]["ok"] and "stall" not in line


def test_cold_start_drill_meets_its_criteria(params):
    """The drill's criteria at a tiny size. max_bucket=3 is NOT a power of
    two: the ladder rounds up, and the damage legs key off the real
    ladder."""
    tracer = Tracer()
    out = cold_start_drill_run(params, subjects=3, requests=8,
                               max_bucket=3, max_subjects=8, p99_waves=2,
                               hang_deadline_s=1.0, seed=21, device="cpu",
                               tracer=tracer)
    keys, assigned = _jax_keys("cold_start_drill_run")
    assert set(out) == keys
    _balanced(out["flight_record"], "coldstart_drill_complete")
    # Every restart phase on one timeline: the live builds, the lattice
    # loads of the cold boots and the truncated entry's failed load.
    names = [e[2] for e in tracer.snapshot()["events"] if e[1] == 0]
    for name in ("compile", "lattice_load", "lattice_load_failed",
                 "incident:deadline_kill"):
        assert name in names, name
    assert names.count("lattice_load_failed") == 1
    assert set(out["hang_leg"]) == assigned["hang_leg"]
    assert out["buckets"] == [1, 2, 4]
    assert out["compiles_after_restore"] == 0
    assert out["aot_loads"] == out["expected_programs"] == 6
    assert out["restored_vs_fresh_max_abs_err"] == 0.0
    assert out["restored_vs_warm_max_abs_err"] == 0.0
    assert out["killed_futures_resolved_fraction"] == 1.0
    assert out["phase_a"]["unresolved"] == 0
    assert set(out["injections"]) == {
        "truncated_entry", "schema_bump", "digest_mismatch",
        "damaged_checkpoint"}
    for name, leg in out["injections"].items():
        assert leg["futures_resolved_fraction"] == 1.0, name
        assert (leg["aot_load_failures"] >= 1
                or "error" in leg["restore"]), name
    assert out["injections"]["truncated_entry"]["recompiles"] >= 1
    hang = out["hang_leg"]
    assert hang["futures_resolved_fraction"] == 1.0
    assert hang["deadline_kills"] >= 1
    assert hang["compiles_after_restore"] == 0
    assert hang["aot_loads"] == hang["expected_programs"] == 9
    assert out["t_first_result_s"] > 0


def test_tracing_overhead_run_accounts_every_span(params, tmp_path):
    """The tracing-overhead protocol small: JAX's keys, every request's
    span closed once ((trials + 1) passes of the stream), no build in the
    steady passes, the stage table and the exported timeline."""
    out = tracing_overhead_run(params, requests=12, max_rows=4,
                               max_bucket=8, trials=3, device="cpu",
                               trace_dir=tmp_path / "tr")
    keys, _ = _jax_keys("tracing_overhead_run")
    assert set(out) == keys | {"trace_export"}
    acc = out["span_accounting"]
    assert acc["spans_started"] == acc["spans_closed"] == 12 * (3 + 1)
    assert acc["spans_open"] == 0
    assert out["steady_recompiles"] == 0
    assert out["tracing_overhead_ratio"] > 0
    assert out["stage_breakdown"]["complete_spans"] > 0
    _balanced(out["flight_record"], "tracing_overhead_complete")
    assert (tmp_path / "tr" / "engine.trace.json").exists()
