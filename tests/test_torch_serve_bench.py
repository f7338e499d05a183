"""The port's benchmark protocols (``serving/measure.py``) against the
JAX package's.

The five protocols run small on both sides and return JAX's key sets
(where the port's engine counters differ from JAX's, the difference is
named here), with the parity numbers each one reports; ``edge_drill_run``
runs small on the port and returns the keys JAX's source builds, meeting
JAX's criteria. The full edge drill is ``slow``, as JAX's is. The command
lines are in ``tests/test_torch_serve_cli.py``.
"""

import ast
import inspect
import textwrap
import time
import warnings

import numpy as np
import pytest

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.serving import measure as j_measure
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.serving import measure

#: Counter-snapshot keys the port's ``ServingCounters`` does not keep:
#: none (the closed-loop controller's three are the port's too).
JAX_ONLY_COUNTERS = set()
#: ... and keeps beside JAX's: bf16-family batches.
PORT_ONLY_COUNTERS = {"dispatches_bf16", "dispatches_gathered"}

SMALL = dict(subjects=2, requests=8, max_bucket=4, trials=1)


@pytest.fixture(scope="module")
def params():
    return synthetic_params(seed=0, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax_synthetic(seed=0).astype(np.float32)


def test_serve_bench_run_keys_and_parity(params, jparams):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = measure.serve_bench_run(params, device="cpu", requests=8,
                                       max_rows=2, max_bucket=4, trials=1)
        theirs = j_measure.serve_bench_run(jparams, requests=8, max_rows=2,
                                           max_bucket=4, trials=1)
    assert set(ours) == (set(theirs) - JAX_ONLY_COUNTERS) | \
        PORT_ONLY_COUNTERS
    assert ours["engine_vs_direct_max_abs_err"] <= 1e-6
    assert ours["steady_recompiles"] == 0
    assert set(ours["latency_by_bucket"]) <= set(ours["buckets"])
    assert 0.0 <= ours["padding_waste"] < 1.0
    assert ours["padding_waste"] == round(
        ours["rows_padded"] / (ours["rows_live"] + ours["rows_padded"]), 4)


def test_coalesce_bench_run_keys_and_parity(params, jparams):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = measure.coalesce_bench_run(params, device="cpu", **SMALL)
        fused = measure.coalesce_bench_run(params, device="cpu",
                                           posed_kernel="fused", **SMALL)
        theirs = j_measure.coalesce_bench_run(jparams, **SMALL)
    assert set(ours) == set(fused) == set(theirs)
    assert set(ours["flight_record"]) == set(theirs["flight_record"])
    assert ours["gather_vs_posed_max_abs_err"] == 0.0
    assert fused["gather_vs_posed_max_abs_err"] <= 1e-5
    assert ours["steady_recompiles"] == fused["steady_recompiles"] == 0
    assert ours["dispatches"] > 0


def test_posed_kernel_bench_run_keys_and_parity(params, jparams):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = measure.posed_kernel_bench_run(
            params, device="cpu", lm_batch=2, lm_steps=(1, 2), lm_iters=1,
            **SMALL)
        theirs = j_measure.posed_kernel_bench_run(
            jparams, lm_batch=0, interpret=True, **SMALL)
    lm_keys = {"lm_e2e_steps_per_sec", "lm_e2e_batch", "lm_e2e_steps",
               "lm_e2e_jacobian", "lm_e2e_normal_eq"}
    assert set(ours) == set(theirs) | lm_keys | {
        "ratio_trials", "xla_vs_gather_matched_max_abs_err"}
    # On the CPU both sides run plain PyTorch: keys and parity only.
    assert ours["interpret"] is True and ours["platform"] == "cpu"
    assert ours["gather_fused_active"] is True
    assert ours["fused_vs_gather_max_abs_err"] <= 1e-5
    assert ours["xla_vs_gather_matched_max_abs_err"] == 0.0
    assert ours["xla_vs_gather_max_abs_err"] <= 1e-6
    assert ours["steady_recompiles_fused"] == 0
    assert ours["steady_recompiles_xla"] == 0
    assert len(ours["ratio_trials"]) == SMALL["trials"]
    assert ours["lm_e2e_batch"] == 2


def test_precision_bench_run_keys_and_parity(params, jparams):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = measure.precision_bench_run(params, device="cpu",
                                           posed_kernel="fused", **SMALL)
        theirs = j_measure.precision_bench_run(jparams, **SMALL)
    assert set(ours) == set(theirs)
    assert set(ours["sentinel_drill"]) == set(theirs["sentinel_drill"])
    assert 1e-6 < ours["bf16_max_abs_err"] <= ours["bf16_err_envelope"]
    assert ours["f32_control_max_abs_err"] <= 1e-5
    assert ours["steady_recompiles_bf16"] == 0
    assert ours["steady_recompiles_f32"] == 0
    dr = ours["sentinel_drill"]
    assert dr["bf16_family_detected"] and dr["recovered"]
    assert dr["futures_resolved_fraction"] == 1.0
    assert not dr["clean_probe_drift"]


def _returned_keys(fn) -> dict:
    """The string keys of every dict literal a function assigns to a name
    or returns: {name or "return": keys}."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = {}
    for node in ast.walk(tree):
        value, name = None, None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value, name = node.value, node.targets[0].id
        elif isinstance(node, ast.Return):
            value, name = node.value, "return"
        if isinstance(value, ast.Dict):
            out[name] = {k.value for k in value.keys
                         if isinstance(k, ast.Constant)}
    return out


def test_small_edge_drill_gives_jax_s_keys_and_criteria(params):
    want = _returned_keys(j_measure.edge_drill_run)
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = measure.edge_drill_run(
            params, device="cpu", posed_kernel="fused", saturation=3.0,
            bursts=6, shed_probe_requests=8, workers=8, streams=1,
            frames_per_stream=2, drain_timeout_s=5.0)
    assert time.monotonic() - t0 < 20.0
    assert set(out) == want["return"]
    for block, name in (("shed_probe", "shed_probe"), ("stream",
                        "stream_leg"), ("disconnect", "disconnect"),
                        ("drain", "drain_leg"), ("scrape", "scrape")):
        assert set(out[block]) == want[name], block
    sp = out["shed_probe"]
    assert sp["dispatches"] == 0 and not sp["engine_started"]
    assert sp["wire_429"] == sp["sheds"] and sp["wire_retry_after_present"]
    assert out["outcomes"]["error"] == out["outcomes"]["unresolved"] == 0
    assert out["wire_resolved_within_budget_fraction"] == 1.0
    assert out["steady_recompiles"] == 0
    st = out["stream"]
    assert st["frames_ok"] == st["frames_expected"]
    assert st["wire_vs_inprocess_max_abs_err"] == 0.0
    assert st["wire_vs_inprocess_pose_max_abs_err"] == 0.0
    d = out["disconnect"]
    assert d["oneshot_cancelled"] == 1 and d["stream_frame_aborted"]
    assert d["stream_frames_by_kind"].get("cancelled") == 1
    dr = out["drain"]
    assert dr["inflight_all_ok"] and dr["new_connection_refused"]
    assert dr["within_timeout"] and dr["engine_stopped"]
    assert dr["recorder_quiet_during_drain"]
    acc = out["span_accounting"]
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0


@pytest.mark.slow
def test_full_edge_drill_meets_jax_s_criteria(params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = measure.edge_drill_run(params, device="cpu",
                                     posed_kernel="fused")
    assert out["outcomes"]["error"] == out["outcomes"]["unresolved"] == 0
    assert out["wire_resolved_within_budget_fraction"] == 1.0
    # JAX's judge: tier-0 goodput is held where the storm achieved 3x.
    if out["saturation_achieved"] >= 3.0:
        assert out["tier0_goodput"] >= 0.95
    assert out["steady_recompiles"] == 0
    assert out["stream"]["wire_vs_inprocess_max_abs_err"] == 0.0
    assert out["drain"]["within_timeout"]
    assert out["span_accounting"]["spans_open"] == 0
