"""The port's metrics registry and numerics sentinel
(``mano_hand_tpu_torch/obs/{metrics,sentinel}.py``) against the JAX
package's, on the CPU.

* ``prometheus_text`` and ``slo_report`` are pure functions of a
  snapshot: byte-equal / equal to JAX's on the same input.
* The counter-drift guard covers the port's ``ServingCounters`` (its
  ``dispatches_bf16`` exports as ``serving_dispatches_bf16``), and the
  registry snapshot stays atomic under concurrent submit/resolve.
* The sentinel mirrors ``tests/test_metrics.py``: a clean probe of every
  live family at 0.0, the chaos ``wrong`` fault detected on exactly the
  wrapped families and recovered from, a probe span closed once on
  error, committed goldens (match / mismatch / absent, and the committed
  ``cpu`` entry in this environment), the background loop — with the
  same verdicts as the JAX sentinel over the JAX engine.
* ``golden_inputs``/``f32_digest`` are byte-equal to JAX's; the port's
  CPU reference is within 1e-6 m of JAX's on the golden input (a
  tolerance: the bits differ across frameworks).
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from mano_hand_tpu import obs as jobs
from mano_hand_tpu import runtime as jrt
from mano_hand_tpu.obs import metrics as jmetrics
from mano_hand_tpu.obs import sentinel as jsentinel
from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu_torch import obs as pobs
from mano_hand_tpu_torch import runtime as prt
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.obs import metrics as pmetrics
from mano_hand_tpu_torch.obs import sentinel as psentinel
from mano_hand_tpu_torch.serving import PrecisionPolicy, ServingEngine
from mano_hand_tpu_torch.utils.profiling import ServingCounters


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)


# ------------------------------------------------- the export, byte for byte
def _registry(m):
    reg = m.MetricsRegistry()
    reg.counter("events", help='with "quotes" and\nnewline').inc(2)
    reg.gauge("backlog").set(7)
    q = reg.quantile("latency_ms", capacity=8)
    for v in range(100):
        q.observe(float(v))
    reg.register_collector("labeled", lambda: {
        "by_tier": m.metric("counter", samples=[
            m.sample(3, {"tier": "0"}), m.sample(1, {"tier": "1"})])})
    reg.register_collector("broken", lambda: 1 / 0)
    return reg


SNAPSHOTS = {
    "escaping": {"namespace": "mano", "metrics": {
        "evil": {"type": "counter", "help": "",
                 "samples": [[{"kind": 'a\\b"c\nd\re'}, 1.0]]}}},
    "names": {"namespace": "mano", "metrics": {
        'bad name\n{}': {"type": "gauge", "help": "",
                         "samples": [[{'bad key"': "v"}, 2.0]]}}},
    "help": {"namespace": "mano", "metrics": {
        "m": {"type": "counter", "help": "line1\r\nline2\rline3\nline4",
              "samples": [[None, 1.0]]}}},
    "specials": {"namespace": "my ns", "metrics": {
        "x": {"type": "quantile", "help": "a\\b",
              "samples": [[None, float("nan")], [{"q": "1"}, float("inf")],
                          [{"q": "2"}, float("-inf")], [None, 0.1]]},
        "y": {"type": "mystery", "samples": [[None, 3]]}}},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_prometheus_text_byte_equal_to_jax(name):
    snap = SNAPSHOTS[name]
    assert pmetrics.prometheus_text(snap) == jmetrics.prometheus_text(snap)


def test_registry_snapshot_and_text_equal_to_jax():
    """The same instruments and collectors on both registries: equal
    snapshots (less the clock stamps) and byte-equal text; a failing
    collector degrades to an ``errors`` entry on both."""
    ps, js = _registry(pmetrics).snapshot(), _registry(jmetrics).snapshot()
    for s in (ps, js):
        del s["t_monotonic"], s["wall_time_utc"]
    assert ps == js
    assert "ZeroDivisionError" in ps["errors"]["broken"]
    text = pmetrics.prometheus_text(ps)
    assert text == jmetrics.prometheus_text(js)
    assert pmetrics.prometheus_text(json.loads(json.dumps(ps))) == text
    reg = pmetrics.MetricsRegistry()
    c = reg.counter("requests")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("requests")
    with pytest.raises(ValueError):
        reg.counter("bad name!")


SLO_CASES = [
    {"tiers": {"0": {"submitted": 1000, "served": 980, "shed": 0,
                     "expired": 20},
               "1": {"submitted": 100, "served": 60, "shed": 40,
                     "expired": 0}}},
    {"tiers": {"0": {"submitted": 10, "served": 10, "shed": 0,
                     "expired": 0}}},
    {"tiers": {"0": {"submitted": 12, "served": 8, "shed": 1, "expired": 1,
                     "cancelled": 2}}},
    {},
]


@pytest.mark.parametrize("case", range(len(SLO_CASES)))
def test_slo_report_equal_to_jax(case):
    snap = SLO_CASES[case]
    rep = pmetrics.slo_report(snap)
    assert rep == jmetrics.slo_report(snap)
    assert pmetrics.slo_samples(rep) == jmetrics.slo_samples(rep)
    lat = {"0": {"p50_ms": 5.0, "p99_ms": 30.0}}
    obj = {"0": dict(pmetrics.DEFAULT_SLO_OBJECTIVES["0"],
                     p99_target_ms=20.0)}
    assert pmetrics.slo_report(snap, obj, lat) == \
        jmetrics.slo_report(snap, obj, lat)


def test_slo_burn_rates():
    rep = pmetrics.slo_report(SLO_CASES[0])
    t0 = rep["tiers"]["0"]
    assert t0["burn_rates"]["goodput"] == pytest.approx(2.0)
    assert t0["burn_rates"]["deadline_hit"] == pytest.approx(20.0)
    assert not t0["ok"] and not rep["ok"] and rep["tiers"]["1"]["ok"]


# ------------------------------------------------------ counter-drift guard
def test_counter_drift_guard_every_field_exported():
    """Every public ``ServingCounters`` field reaches ``snapshot()`` and the
    export; ``dispatches_bf16`` (a key JAX's counters lack) is a counter
    ``serving_dispatches_bf16``, and nothing is left unexported."""
    c = ServingCounters()
    c.count_dispatch(8, 3, bf16=True)
    c.count_tier_submit(0)
    snap = c.snapshot()
    folded = {"tier_submitted": "tiers", "tier_served": "tiers",
              "tier_shed": "tiers", "tier_expired": "tiers",
              "tier_cancelled": "tiers"}
    for field in (k for k in vars(c) if not k.startswith("_")):
        assert folded.get(field, field) in snap, field
    out = pmetrics.serving_samples(snap)
    renamed = {"tiers": "serving_tier_submitted",
               "subject_store_promotion_ms":
                   "serving_subject_store_promotion_p50_ms"}
    for key in snap:
        want = renamed.get(key, f"serving_{key}")
        assert want in out, key
    assert out["serving_dispatches_bf16"]["type"] == "counter"
    assert out["serving_dispatches_bf16"]["samples"] == [[None, 1.0]]
    assert out["serving_unexported_keys"]["samples"][0][1] == 0
    assert pmetrics.serving_samples(snap) == jmetrics.serving_samples(snap)


def test_counter_drift_guard_flags_unclassifiable_key():
    out = pmetrics.serving_samples({"compiles": 1, "mystery": {"n": True}})
    assert out["serving_unexported_keys"]["samples"][0][1] == 1


def test_registry_snapshot_atomic_under_concurrent_submit_resolve():
    c = ServingCounters()
    reg = pmetrics.MetricsRegistry()

    def collect():
        snap = c.snapshot()
        out = pmetrics.serving_samples(snap)
        out.update(pmetrics.slo_samples(pmetrics.slo_report(snap)))
        return out

    reg.register_collector("serving", collect)
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            c.count_dispatch(8, 3, requests=2, bf16=True)
            c.count_tier_submit(0)
            c.count_served(0)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        def val(snap, name):
            return snap["metrics"][name]["samples"][0][1]

        for _ in range(100):
            snap = reg.snapshot()
            assert not snap.get("errors")
            d = val(snap, "serving_dispatches")
            assert val(snap, "serving_dispatches_bf16") == d
            assert val(snap, "serving_requests_dispatched") == 2 * d
            assert val(snap, "serving_rows_live") == 3 * d
            assert val(snap, "serving_unexported_keys") == 0
            sub = [s[1] for s in snap["metrics"]["serving_tier_submitted"]
                   ["samples"] if s[0] == {"tier": "0"}]
            srv = [s[1] for s in snap["metrics"]["serving_tier_served"]
                   ["samples"] if s[0] == {"tier": "0"}]
            good = [s[1] for s in snap["metrics"]["slo_goodput"]["samples"]
                    if s[0] == {"tier": "0"}]
            if sub:
                assert good[0] == round(srv[0] / sub[0], 6)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)


def test_engine_registry_absorbs_counters_load_tracer(params32):
    tr = pobs.Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=8, max_queued=16,
                        tracer=tr, precision_policy=PrecisionPolicy())
    reg = pobs.engine_registry(eng, tracer=tr)
    with eng:
        eng.warmup([1, 8])
        eng.forward(_pose(2))
        snap = reg.snapshot()
        ld = eng.load()
    # The port's load() maps as JAX's mapper maps it.
    assert pmetrics.load_samples(ld) == jmetrics.load_samples(ld)
    assert "load_precision_envelope_m" in snap["metrics"]
    m = snap["metrics"]
    assert not snap.get("errors")
    assert m["serving_dispatches"]["samples"][0][1] == 1
    assert m["serving_unexported_keys"]["samples"][0][1] == 0
    assert m["load_outstanding"]["samples"][0][1] == 0
    assert m["trace_spans_started"]["samples"][0][1] == 1
    assert m["trace_spans_closed"]["samples"][0][1] == 1
    assert "slo_goodput" in m and "load_latency_p50_ms" in m
    assert "mano_serving_compiles" in pobs.prometheus_text(snap)


# ---------------------------------------------------------------- sentinel
def _drill(engine_cls, obs, rt, params, extra, tmp_path, spec):
    """One engine (supervised, chaos plan, CPU tier), one sentinel: a
    clean probe, the ``wrong`` fault, recovery. Returns what the JAX
    sentinel must agree on."""
    plan = rt.ChaosPlan()
    tr = obs.Tracer()
    rec = obs.FlightRecorder(tr)
    eng = engine_cls(params, min_bucket=8, max_bucket=8, tracer=tr,
                     policy=rt.DispatchPolicy(deadline_s=30.0, retries=0,
                                              chaos=plan), **extra)
    s = obs.NumericsSentinel(eng, tracer=tr, goldens_path=tmp_path / "g.json")
    with eng:
        eng.warmup()
        subj = eng.specialize(np.zeros(10, np.float32))
        eng.forward(_pose(2), subject=subj)
        compiles = eng.counters.compiles
        clean = s.probe()
        plan.schedule(spec)
        out = eng.submit(_pose(2)).result(timeout=30)
        det = s.probe()
        plan.clear()
        rec_probe = s.probe()
        probe_compiles = eng.counters.compiles - compiles
    return {
        "clean": (clean["drift"], sorted(clean["families"]),
                  {f: r["max_abs_err"] for f, r in clean["families"].items()}),
        "finite": bool(np.isfinite(out).all()),
        "detected": (det["drift"], det["drifted_families"],
                     {f: r["max_abs_err"] for f, r in det["families"].items()
                      if r["drift"]}),
        "recovered": rec_probe["drift"],
        "drifts": s.status()["drifts"],
        "incidents": tr.accounting()["incidents"],
        "captures": [c["reason"] for c in rec.captures],
        "closed_by_kind": {k: v for k, v in
                           tr.accounting()["closed_by_kind"].items()
                           if k in ("probe", "drift", "error")},
        "probe_compiles": probe_compiles,
    }


def test_sentinel_verdicts_equal_to_jax(params, params32, tmp_path):
    """Clean probe of full/cpu/gather at 0.0, the ``wrong`` fault flagged
    on exactly the wrapped families (the CPU tier clean), ONE
    numerics_drift incident captured, recovery — the same verdicts as the
    JAX sentinel over the JAX engine, and no build caused by a probe."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = _drill(ServingEngine, pobs, prt, params32,
                      {"device": "cpu", "inflight_depth": 1,
                       "adaptive_coalesce": False},
                      tmp_path, "wrong:1.0@0-")
        jax_ = _drill(JaxEngine, jobs, jrt, params.astype(np.float32),
                      {"inflight_depth": 1, "adaptive_coalesce": False},
                      tmp_path, "wrong:1.0@0-")
    assert port == jax_
    assert port["clean"] == (False, ["cpu", "full", "gather"],
                             {"cpu": 0.0, "full": 0.0, "gather": 0.0})
    assert port["detected"][:2] == (True, ["full", "gather"])
    assert port["detected"][2]["full"] == pytest.approx(1.0)
    assert port["recovered"] is False and port["drifts"] == 1
    assert port["captures"] == ["numerics_drift"]
    assert port["closed_by_kind"] == {"probe": 2, "drift": 1}
    assert port["probe_compiles"] == 0


def test_sentinel_probes_the_fused_and_bf16_families(params32, tmp_path):
    """K2's family (plain version on the CPU) and the bf16 tier: f32
    digest-equal, bf16 inside the envelope against the f32 truth and
    nonzero; a wrong fault drifts both."""
    plan = prt.ChaosPlan()
    tr = pobs.Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=8, tracer=tr,
                        posed_kernel="fused",
                        precision_policy=PrecisionPolicy(),
                        policy=prt.DispatchPolicy(deadline_s=30.0, retries=0,
                                                  chaos=plan))
    s = pobs.NumericsSentinel(eng, tracer=tr)
    with eng:
        subj = eng.specialize(np.zeros(10, np.float32))
        eng.warmup_posed([1, 8])
        armed = s.arm()
        res = s.probe()
        plan.schedule("wrong:0.5@0-")
        det = s.probe()
        plan.clear()
        assert not s.probe()["drift"]
        eng.forward(_pose(1), subject=subj, priority=1)
    fam = res["families"]
    assert armed["golden_status"] == "match"
    assert armed["golden_bf16_status"] == "match"
    assert set(fam) == {"gather", "gather_bf16"} and not res["drift"]
    assert fam["gather"]["family"] == "gather_fused"
    assert fam["gather"]["max_abs_err"] == 0.0
    assert fam["gather_bf16"]["family"] == "gather_fused_bf16"
    assert fam["gather_bf16"]["served_digest"] == \
        fam["gather_bf16"]["want_digest"]
    assert 1e-6 < fam["gather_bf16"]["max_abs_err"] <= 2e-3
    assert det["drifted_families"] == ["gather", "gather_bf16"]


def test_sentinel_probe_span_closes_exactly_once_on_error(params32):
    tr = pobs.Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=8, tracer=tr)
    s = pobs.NumericsSentinel(eng, tracer=tr)

    def boom():
        raise RuntimeError("probe transport died")

    eng.numerics_probe_targets = boom
    with pytest.warns(UserWarning, match="numerics probe failed"):
        res = s.probe()
    assert "probe_error" in res["families"]
    assert s.status()["probe_errors"] == 1
    acc = tr.accounting()
    assert (acc["spans_started"], acc["spans_closed"], acc["spans_open"],
            acc["spans_double_closed"]) == (1, 1, 0, 0)
    assert acc["closed_by_kind"] == {"error": 1}


def test_sentinel_golden_commit_match_mismatch_absent(params32, tmp_path):
    gpath = tmp_path / "goldens.json"
    psentinel.commit_goldens(params32, gpath)
    data = psentinel.load_goldens(gpath)
    assert list(data["entries"]) == [psentinel.golden_key(params32, "cpu")]
    tr = pobs.Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=8, tracer=tr)
    with eng:
        eng.warmup([1])
        assert pobs.NumericsSentinel(eng, tracer=tr, goldens_path=gpath
                                     ).arm()["golden_status"] == "match"
        key = next(iter(data["entries"]))
        data["entries"][key]["full"] = "deadbeefdeadbeef"
        gpath.write_text(json.dumps(data))
        with pytest.warns(UserWarning, match="do not match"):
            got = pobs.NumericsSentinel(eng, tracer=tr,
                                        goldens_path=gpath).arm()
        assert got["golden_status"] == "mismatch"
        assert pobs.NumericsSentinel(
            eng, tracer=tr, goldens_path=tmp_path / "none.json"
        ).arm()["golden_status"] == "absent"
    assert tr.accounting()["incidents"] == 1


def test_committed_goldens_match_this_environment(params32):
    """The committed ``cpu`` entries of ``obs/goldens.json`` and
    ``obs/goldens_bf16.json`` reproduce here (the cross-session numerics
    anchor; regenerate with ``python -m mano_hand_tpu_torch.obs.sentinel
    --device cpu`` and justify the diff). The derivation is
    single-threaded, so the worker's thread count does not matter."""
    eng = ServingEngine(params32, device="cpu", max_bucket=8,
                        precision_policy=PrecisionPolicy())
    threads = torch.get_num_threads()
    with eng:
        eng.warmup([1])
        got = pobs.NumericsSentinel(eng).arm()
    assert got["golden_status"] == "match", got
    assert got["golden_bf16_status"] == "match", got
    assert torch.get_num_threads() == threads


def test_sentinel_background_loop_probes_and_stops(params32):
    eng = ServingEngine(params32, device="cpu", max_bucket=8)
    s = pobs.NumericsSentinel(eng, interval_s=0.02)
    with eng:
        eng.warmup([1])
        with s:
            deadline = time.monotonic() + 10.0
            while s.status()["probes"] < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert s.status()["probes"] >= 2
        assert not s.status()["armed"]
        assert s.status()["last_probe_age_s"] is not None
    samples = s.samples()
    assert samples["sentinel_probes"]["samples"][0][1] >= 2
    assert samples["sentinel_drifts"]["samples"][0][1] == 0
    assert s.status()["probe_errors"] == 0


def test_golden_inputs_and_digest_byte_equal_to_jax():
    for rows, seed in ((4, psentinel.GOLDEN_SEED), (7, 3)):
        p1, s1 = psentinel.golden_inputs(16, 10, rows=rows, seed=seed)
        p2, s2 = jsentinel.golden_inputs(16, 10, rows=rows, seed=seed)
        assert p1.tobytes() == p2.tobytes() and s1.tobytes() == s2.tobytes()
        for a in (p1, s1, p1 + 1e-7):
            assert psentinel.f32_digest(a) == jsentinel.f32_digest(a)
            assert psentinel.f32_digest(torch.from_numpy(
                np.asarray(a))) == jsentinel.f32_digest(a)
    assert psentinel.f32_digest(p1) != psentinel.f32_digest(p1 + 1e-7)


def test_cpu_reference_within_1e6_of_jax(params, params32):
    """The port's clean full-family reference on the golden input against
    JAX's jitted ``core.forward_batched`` (a tolerance, not a digest)."""
    import jax

    from mano_hand_tpu.models import core as jcore

    pose, shape = psentinel.golden_inputs(16, 10)
    got = psentinel._full(params32, pose, shape).numpy()
    want = np.asarray(jax.jit(
        lambda q, p, s: jcore.forward_batched(q, p, s).verts)(
            params.astype(np.float32), pose, shape))
    assert float(np.abs(got - want).max()) <= 1e-6


def test_metrics_overhead_run_small_e2e(params32, tmp_path):
    from mano_hand_tpu_torch.serving import metrics_overhead_run

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = metrics_overhead_run(
            params32, requests=12, max_rows=4, max_bucket=8, trials=2,
            reps=1, metrics_dir=tmp_path / "mx", device="cpu")
    assert out["steady_recompiles"] == 0
    assert out["metrics_overhead_ratio"] > 0
    acc = out["span_accounting"]
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0
    drill = out["sentinel_drill"]
    assert drill["detected"] and not drill["clean_probe_drift"]
    assert drill["drifted_families"] == ["full"]
    assert drill["cpu_family_clean"] and drill["recovered"]
    assert drill["futures_resolved_fraction"] == 1.0
    assert "numerics_drift" in drill["flight_capture_reasons"]
    assert out["sentinel"]["golden_status"] == "match"
    assert out["sentinel_background_probes"] >= 1
    assert out["slo"]["tiers"]["0"]["burn_rates"]["goodput"] == 0.0
    assert out["registry_errors"] is None
    prom = (tmp_path / "mx" / "metrics.prom").read_text()
    assert "mano_serving_dispatches_bf16" in prom
    assert "mano_sentinel_probes" in prom
    assert json.loads((tmp_path / "mx" / "slo.json").read_text())["ok"]
