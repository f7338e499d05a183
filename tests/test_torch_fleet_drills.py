"""The port's fleet drills (``serving/measure.py:fleet_drill_run`` and
``selfheal_drill_run``) at plumbing size on the CPU: three real ``serve``
worker processes (``--device cpu``), loopback sockets, JAX's judged
invariants (``scripts/bench_report.py:judge_fleet``/``judge_selfheal``,
as JAX's own plumbing tests hold them), and the key tree JAX's source
returns.

The self-heal drill boots a replacement worker per death (~6 s each on
this CPU) and runs over 40 s alone, so it is slow-marked here and runs
on the card in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import warnings

import pytest
import torch

from mano_hand_tpu.serving import measure as j_measure
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.serving import measure


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


def _returned_tree(fn) -> dict:
    """The key tree of the dict literal ``fn`` returns: a nested dict
    literal with keys, or a name assigned one in ``fn``, is a subtree;
    any other value (a dict filled at run time included) a leaf."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    named = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Dict):
            named[node.targets[0].id] = node.value
    # The function's own final return (not a nested handler's).
    ret = tree.body[0].body[-1].value

    def walk(d):
        out = {}
        for k, v in zip(d.keys, d.values):
            if isinstance(v, ast.Name) and v.id in named:
                v = named[v.id]
            out[k.value] = (walk(v) if isinstance(v, ast.Dict) and v.keys
                            else None)
        return out

    return walk(ret)


def _tree(obj, like):
    """``obj``'s key tree, descending where ``like`` has a subtree."""
    return {k: (_tree(v, like[k]) if isinstance(like.get(k), dict)
                and isinstance(v, dict) else None)
            for k, v in obj.items()}


def test_fleet_drill_plumbing_holds_jax_s_criteria_and_keys(tmp_path):
    want = _returned_tree(j_measure.fleet_drill_run)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fd = measure.fleet_drill_run(
            synthetic_params(seed=0, device="cpu"), device="cpu",
            workers=3, lanes=2, streams=4, frames_per_stream=3,
            stream_workers=4, unique_tracks=2, max_bucket=4,
            max_subjects=16, store_warm_capacity=8, drain_budget_s=30.0,
            ready_timeout_s=420.0, work_dir=str(tmp_path))
    assert _tree(fd, want) == want
    assert fd["fleet_drill_schema"] == 1
    assert fd["reference_platform"] == "cpu"
    assert fd["cold_boot_zero_compiles"] is True
    assert fd["terminal_fraction"] == 1.0
    assert fd["outcomes"]["exception"] == 0 and not fd["close_errors"]
    assert fd["closes_ok"] == 4
    assert fd["frames_compared"] == fd["frame_numbering_ok"] > 0
    assert fd["intra_fleet_pose_max_abs_err"] == 0.0
    assert fd["wire_vs_inprocess_pose_max_abs_err"] == 0.0
    assert fd["intra_fleet_max_abs_err"] <= 1e-6
    assert fd["wire_vs_inprocess_max_abs_err"] <= 1e-6
    assert fd["steady_recompiles_total"] == 0
    assert fd["aot_load_failures_total"] == 0
    assert fd["spans_closed_exactly_once"] is True
    reported = [n for n, v in fd["spans_by_worker"].items() if v]
    assert len(reported) == fd["workers"] - 1      # the SIGKILLed one
    assert fd["kill"]["fired_mid_wave"] is True
    assert fd["drain"]["clean"] is True
    assert fd["drain"]["wall_s"] <= fd["drain"]["budget_s"]
    assert fd["drain"]["streams_migrated"] == fd["drain"][
        "streams_hosted"]


def test_drills_refuse_jax_s_bad_arguments():
    p = synthetic_params(seed=0, device="cpu")
    for fn, kw, match in (
            (measure.fleet_drill_run, {"workers": 2}, "workers must be"),
            (measure.fleet_drill_run, {"streams": 2}, "streams must be"),
            (measure.fleet_drill_run, {"frames_per_stream": 2},
             "frames_per_stream"),
            (measure.selfheal_drill_run, {"workers": 2},
             "workers must be"),
            (measure.selfheal_drill_run, {"frames_per_stream": 5},
             "frames_per_stream"),
            (measure.selfheal_drill_run, {"campaign": "damage_page@0s"},
             "not drillable"),
            (measure.selfheal_drill_run, {"restart_budget": 3},
             "cannot absorb")):
        with pytest.raises(ValueError, match=match):
            fn(p, device="cpu", **kw)
        jfn = getattr(j_measure, fn.__name__)
        with pytest.raises(ValueError, match=match):
            jfn(p, **kw)


@pytest.mark.slow
def test_selfheal_drill_plumbing_holds_jax_s_criteria_and_keys(tmp_path):
    want = _returned_tree(j_measure.selfheal_drill_run)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sd = measure.selfheal_drill_run(
            synthetic_params(seed=0, device="cpu"), device="cpu",
            workers=3, lanes=2, streams=4, frames_per_stream=6,
            stream_workers=4, unique_tracks=2, max_bucket=4,
            max_subjects=8, store_warm_capacity=4,
            work_dir=str(tmp_path), ready_timeout_s=420.0)
    assert _tree(sd, want) == want
    check_selfheal(sd, streams=4)


def check_selfheal(sd, streams):
    """JAX's plumbing bars on a ``selfheal_drill_run`` result (shared
    with the card test)."""
    assert sd["selfheal_drill_schema"] == 1
    assert sd["lattice_boot_ok"] is True
    assert sd["campaign_done"] is True
    assert sd["terminal_fraction"] == 1.0
    assert sd["outcomes"]["exception"] == 0 and not sd["close_errors"]
    assert sd["closes_ok"] == streams
    assert sd["frames_compared"] == sd["frame_numbering_ok"] > 0
    assert sd["verts_max_abs_err"] <= 1e-6
    assert sd["all_deaths_auto_healed"] is True
    assert sd["supervisor_restarts"] == sd["expected_heals"] == 2
    assert sd["supervisor"]["abandoned"] == []
    assert sd["supervisor"]["restarts_failed"] == 0
    assert sd["mttr_within_budget"] is True
    assert sd["proxy_health"] == {"proxy_role": "active", "takeovers": 1}
    assert len(sd["takeover_walls_ms"]) == 1
    assert sd["steady_recompiles_total"] == 0
    assert sd["spans_closed_exactly_once"] is True
    st = sd["storm"]
    assert st["incidents"] == 1 and st["abandoned"] == [st["victim"]]
    assert st["degraded_without_flap"] is True
    assert st["degraded_frames_ok"] >= 1
    rb = sd["rebalance"]
    assert rb["shard_rebalances"] == 1 and rb["steady_recompiles"] == 0
    assert rb["max_abs_err"] == 0.0 and rb["pre_loss_max_abs_err"] == 0.0
    dm = sd["damage"]
    assert dm["injected"] is True and dm["damage_counted"] >= 1
    assert dm["request_max_abs_err"] == 0.0
    if sd["reference_platform"] == "cpu":
        assert sd["pose_max_abs_err"] == 0.0
        assert st["degraded_pose_max_abs_err"] == 0.0
