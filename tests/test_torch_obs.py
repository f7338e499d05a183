"""The port's observability (``mano_hand_tpu_torch/obs``: tracer, flight
recorder, logger; the engine's spans and runtime events; ``torch_trace``)
against the JAX package's, on the CPU.

The pure tracer and recorder run the same call sequences on both
packages under one fake clock, so their accounting, spans, stage tables
and Chrome traces must be EQUAL, not just alike. The engine scenarios
mirror ``tests/test_obs.py``: the port's CPU engine and the JAX engine
(serial dispatch, ``inflight_depth=1``, the fixed coalesce window, as the
port has them) take the same traffic under the same chaos specs, and
their per-span event names, ``closed_by_kind``, incidents and runtime
event counts must be equal.
"""

import collections
import itertools
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from mano_hand_tpu import obs as jobs
from mano_hand_tpu import runtime as jrt
from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu.serving.engine import ServingError as JaxError
from mano_hand_tpu_torch import obs as pobs
from mano_hand_tpu_torch import runtime as prt
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.serving import ServingEngine, ServingError


def _clock():
    """A deterministic clock: 1 ms a read."""
    ticks = itertools.count()
    return lambda: 1000.0 + 1e-3 * next(ticks)


def _strip_wall(fr: dict) -> dict:
    return {k: v for k, v in fr.items()
            if k not in ("t_monotonic", "wall_time_utc")}


# ------------------------------------------------------ pure tracer parity
def _ring(obs):
    tr = obs.Tracer(capacity=16, clock=_clock())
    for i in range(100):
        tr.runtime_event("tick", i=i)
    return tr, None


def _close_once(obs):
    tr = obs.Tracer(clock=_clock())
    s = tr.start("full", tier=1, rows=3)
    out = [tr.close(s, "ok"), tr.close(s, "ok"), tr.close(None, "ok")]
    return tr, out


def _shed_burst(obs):
    tr = obs.Tracer(shed_burst_threshold=3, clock=_clock())
    fired = []
    tr.on_incident(lambda reason, fields: fired.append(reason))
    for _ in range(10):
        tr.note_shed()
    tr.note_admit()
    for _ in range(3):
        tr.note_shed()
    return tr, fired


def _stages(obs):
    tr = obs.Tracer(clock=_clock())
    for tier, bucket in ((0, 4), (1, 8), (0, 4)):
        s = tr.start("full", tier=tier, rows=2)
        for name in ("coalesce", "launch", "dispatched", "readback"):
            kw = {"bucket": bucket} if name == "launch" else {}
            tr.event(s, name, **kw)
        tr.close(s, "ok", bucket=bucket)
    s = tr.start("posed", tier=0)            # incomplete: no stages
    tr.event(s, "launch", bucket=4)
    tr.close(s, "expired", phase="dispatch")
    tr.runtime_event("compile", family="full", bucket=8)
    tr.incident("deadline_kill", bucket=4)
    return tr, tr.stage_breakdown()


def _open_and_load(obs):
    tr = obs.Tracer(clock=_clock())
    for kind in ("ok", "shed", "expired", "ok", "error"):
        s = tr.start("full", tier=0)
        tr.close(s, kind)
    tr.start("posed", tier=2)                # still open: the backlog
    return tr, tr.load_snapshot()


@pytest.mark.parametrize("scenario", [_ring, _close_once, _shed_burst,
                                      _stages, _open_and_load])
def test_tracer_matches_jax_call_for_call(scenario):
    """Ring drops, close-once, shed bursts once per crossing, stage
    partitions, backlog: accounting, spans, the snapshot, the Chrome
    trace and the flight record are equal to JAX's on the same calls."""
    (pt, pout), (jt, jout) = scenario(pobs), scenario(jobs)
    assert pout == jout
    assert pt.accounting() == jt.accounting()
    assert pt.snapshot() == jt.snapshot()
    assert pt.spans() == jt.spans()
    assert pt.stage_breakdown() == jt.stage_breakdown()
    assert pt.chrome_trace() == jt.chrome_trace()
    for kw in ({}, {"max_spans": 2, "max_events": 3}):
        assert _strip_wall(pobs.flight_record(pt, reason="x", **kw)) == \
            _strip_wall(jobs.flight_record(jt, reason="x", **kw))


def test_ring_drops_and_close_once_accounting():
    tr, _ = _ring(pobs)
    acc = tr.accounting()
    assert (acc["ring_len"], acc["events_total"], acc["events_dropped"]) \
        == (16, 100, 84)
    tr, out = _close_once(pobs)
    assert out == [True, False, False]
    acc = tr.accounting()
    assert acc["spans_double_closed"] == 1 and acc["closed_by_kind"] == {
        "ok": 1}
    _, fired = _shed_burst(pobs)
    assert fired == ["shed_burst", "shed_burst"]


def test_stage_breakdown_partitions_total():
    _, st = _stages(pobs)
    assert st["complete_spans"] == 3
    for cell in st["by_bucket_tier"].values():
        parts = sum(cell[f"{k}_mean_ms"] for k in
                    ("queue", "dispatch", "device", "readback"))
        assert abs(parts - cell["total_mean_ms"]) < 1e-9


def test_chrome_trace_export_contract(tmp_path):
    tr, _ = _stages(pobs)
    ct = tr.chrome_trace()
    assert ct["manoEngineTrace"]["schema"] == 1
    names = {e["name"] for e in ct["traceEvents"] if e["ph"] == "X"}
    assert {"request/full/b4", "request/full/b8", "stage/queue",
            "stage/dispatch", "stage/device", "stage/readback"} <= names
    assert any(e["ph"] == "i" and e["name"] == "compile"
               for e in ct["traceEvents"])
    paths = pobs.write_trace_dir(tr, tmp_path)
    data = json.loads((tmp_path / "engine.trace.json").read_text())
    assert data == json.loads(json.dumps(ct))
    assert paths["flight"].endswith("flight_final.json")


def test_flight_record_is_bounded():
    fr = {}
    for name, obs in (("port", pobs), ("jax", jobs)):
        tr = obs.Tracer(clock=_clock())
        for _ in range(100):
            tr.close(tr.start("full"), "ok")
        fr[name] = obs.flight_record(tr, reason="test", max_spans=8,
                                     max_events=16)
    assert _strip_wall(fr["port"]) == _strip_wall(fr["jax"])
    assert len(fr["port"]["recent_spans"]) == 8
    assert fr["port"]["accounting"]["spans_started"] == 100
    json.dumps(fr["port"])


def test_flight_recorder_auto_capture_and_keep(tmp_path):
    got = {}
    for name, obs in (("port", pobs), ("jax", jobs)):
        tr = obs.Tracer(clock=_clock())
        out = tmp_path / name
        rec = obs.FlightRecorder(tr, out_dir=out, keep=3)
        for i in range(5):
            tr.incident("deadline_kill", bucket=i)
        got[name] = ([_strip_wall(c) for c in rec.captures],
                     sorted(p.name for p in out.glob("flight_*.json")))
    assert got["port"] == got["jax"]
    caps, files = got["port"]
    assert len(caps) == 3 and caps[-1]["seq"] == 5 and len(files) == 5


def test_logger_channels(capsys):
    lg = pobs.get_logger("port-obs-test", level="info")
    lg.info("progress line")
    out = capsys.readouterr()
    assert out.out == "" and "progress line" in out.err
    lg2 = pobs.get_logger("port-obs-test-quiet", level="warning")
    lg2.info("suppressed")
    assert capsys.readouterr().err == ""
    with pytest.warns(UserWarning,
                      match="port-obs-test-quiet: degraded") as rec:
        lg2.warning("degraded thing")
    assert rec[0].filename == __file__


def test_load_snapshot_one_hold_consistency():
    tr = pobs.Tracer()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            tr.close(tr.start("full", tier=0), "ok")

    threads = [threading.Thread(target=writer) for _ in range(3)]
    for th in threads:
        th.start()
    try:
        last_n = 0
        for _ in range(200):
            snap = tr.load_snapshot()
            assert snap["backlog_age_s"] >= 0.0
            t0 = snap["latency_by_tier"].get("0")
            if t0 is None:
                continue
            assert t0["p50_ms"] <= t0["p99_ms"] + 1e-9
            assert t0["n"] >= last_n or t0["n"] == 2048
            last_n = min(t0["n"], 2047)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)


def test_load_quantiles_count_served_only():
    _, snap = _open_and_load(pobs)
    assert snap["latency_by_tier"]["0"]["n"] == 2
    assert snap["backlog_age_s"] > 0.0


# ------------------------------------------------------ the engines, twinned
class Side:
    def __init__(self, name, params, rt, engine, error, obs, **extra):
        self.name, self.params, self.rt = name, params, rt
        self.Engine, self.Error, self.obs, self.extra = (
            engine, error, obs, extra)

    def engine(self, tracer, policy=None, **kw):
        kw.setdefault("max_bucket", 4)
        return self.Engine(self.params, policy=policy, tracer=tracer,
                           **self.extra, **kw)

    def policy(self, spec, breaker=None, fallback=False, **kw):
        plan = self.rt.ChaosPlan(spec)
        kw = dict(dict(deadline_s=5.0, retries=0, backoff_s=0.0,
                       backoff_cap_s=0.0, jitter=0.0), **kw)
        return self.rt.DispatchPolicy(breaker=breaker, chaos=plan,
                                      cpu_fallback=fallback, **kw), plan


@pytest.fixture(scope="module")
def sides(params):
    port = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    return (Side("port", port, prt, ServingEngine, ServingError, pobs,
                 device="cpu"),
            Side("jax", params.astype(np.float32), jrt, JaxEngine, JaxError,
                 jobs, inflight_depth=1, adaptive_coalesce=False))


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)


class held:
    """Hold the dispatcher off so a batch's composition is deterministic."""

    def __init__(self, eng):
        self.eng = eng

    def __enter__(self):
        self.eng.start = lambda: self.eng
        return self.eng

    def __exit__(self, *exc):
        del self.eng.start
        self.eng.start()


def _timeline(tr) -> dict:
    """What the two engines must agree on: per-span event names (in span
    order), closed_by_kind, incidents, runtime-event name counts."""
    snap = tr.snapshot()
    acc = tr.accounting()
    runtime = collections.Counter(
        name for _, sid, name, _ in snap["events"] if sid == 0)
    return {
        "spans": [[e[1] for e in s["events"]] for s in tr.spans()],
        "closed_by_kind": acc["closed_by_kind"],
        "incidents": acc["incidents"],
        "runtime": dict(runtime),
        "balanced": (acc["spans_started"] == acc["spans_closed"],
                     acc["spans_open"], acc["spans_double_closed"]),
    }


def _twin(sides, scenario) -> dict:
    """Run ``scenario(side, tracer) -> extra`` on both engines; their
    timelines and extras must be equal. Returns the port's."""
    got = {}
    for side in sides:
        tr = side.obs.Tracer()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            extra = scenario(side, tr)
        got[side.name] = (_timeline(tr), extra)
    assert got["port"] == got["jax"]
    timeline, extra = got["port"]
    assert timeline["balanced"] == (True, 0, 0), timeline
    return {**timeline, "extra": extra}


def _outcome(side, fut):
    try:
        fut.result(timeout=30)
        return "ok"
    except side.Error as e:
        return e.kind


def test_spans_ok_shed_expired(sides):
    def run(side, tr):
        eng = side.engine(tr, max_bucket=8, max_queued=1)
        with eng:
            ok = eng.forward(_pose(2)).shape
            expired = _outcome(side, eng.submit(_pose(), deadline_s=0.0))
        eng2 = side.engine(tr, max_bucket=8, max_queued=0)
        with pytest.raises(side.Error) as ei:
            eng2.submit(_pose())
        return ok, expired, ei.value.kind

    t = _twin(sides, run)
    assert t["closed_by_kind"] == {"ok": 1, "expired": 1, "shed": 1}
    assert t["extra"] == ((2, 778, 3), "expired", "shed")
    assert ["submit", "launch", "dispatched", "readback", "resolve"] in \
        t["spans"]


def test_spans_error_kind_under_persistent_fault(sides):
    def run(side, tr):
        pol, _ = side.policy("error@0-")
        eng = side.engine(tr, pol)
        with eng:
            eng.warmup([4])
            return _outcome(side, eng.submit(_pose(2)))

    t = _twin(sides, run)
    assert t["extra"] == "error" and t["closed_by_kind"] == {"error": 1}
    assert t["runtime"]["chaos_fault"] == 1


def test_spans_ok_through_failover_with_incident(sides):
    def run(side, tr):
        pol, _ = side.policy("error@0-", fallback=True)
        rec = side.obs.FlightRecorder(tr)
        eng = side.engine(tr, pol)
        with eng:
            eng.warmup([4])
            out = eng.forward(_pose(2)).shape
        return out, [c["reason"] for c in rec.captures]

    t = _twin(sides, run)
    assert t["extra"] == ((2, 778, 3), ["failover"])
    assert t["closed_by_kind"] == {"ok": 1} and t["incidents"] == 1
    assert t["runtime"]["incident:failover"] == 1
    # full and cpu at the warmed bucket 4, then at the dispatch's bucket 2
    assert t["runtime"]["compile"] == 4


def test_retries_deadline_kill_and_breaker_ride_the_timeline(sides):
    """A hang killed at its deadline and retried, then two errors that
    open a breaker: the retries, the kill (an incident) and the breaker
    transitions are on the timeline, equal between the engines."""
    def run(side, tr):
        breaker = side.rt.CircuitBreaker(
            failure_threshold=1, probe=lambda: True, probe_interval_s=0.0,
            respect_priority_claim=False)
        pol, plan = side.policy("hang@0,error@1-2", breaker=breaker,
                                fallback=True, retries=1, deadline_s=1.0)
        eng = side.engine(tr, pol)
        wired = breaker.on_transition is not None
        try:
            with eng:
                eng.warmup([4])
                outs = [_outcome(side, eng.submit(_pose(2, seed=i)))
                        for i in range(2)]
        finally:
            plan.release.set()
        trans = [f["new"] for _, sid, name, f in tr.snapshot()["events"]
                 if name == "breaker"]
        return wired, outs, trans

    t = _twin(sides, run)
    wired, outs, trans = t["extra"]
    assert wired and outs == ["ok", "ok"] and "down" in trans
    assert t["runtime"]["retry"] >= 1
    assert t["runtime"]["incident:deadline_kill"] == 1


def test_coalesce_and_park_events(sides):
    """A held dispatcher: three full requests coalesce into one batch; a
    pose-only request parks (kind) and leads the next batch."""
    def run(side, tr):
        eng = side.engine(tr)
        subj = eng.specialize(np.zeros(10, np.float32))
        with held(eng):
            futs = [eng.submit(_pose(1, seed=i)) for i in range(2)]
            futs.append(eng.submit(_pose(1, seed=3), subject=subj))
            futs.append(eng.submit(_pose(1, seed=4)))
        outs = [_outcome(side, f) for f in futs]
        eng.stop()
        return outs

    t = _twin(sides, run)
    assert t["extra"] == ["ok"] * 4
    assert ["submit", "coalesce", "launch", "dispatched", "readback",
            "resolve"] in t["spans"]
    assert any("park" in s for s in t["spans"])


def test_stop_timeout_sweep_closes_spans_as_shutdown(sides):
    def run(side, tr):
        pol, plan = side.policy("hang@0-", deadline_s=30.0)
        eng = side.engine(tr, pol)
        try:
            with eng:
                eng.warmup([4])
            with held(eng):
                futs = [eng.submit(_pose()) for _ in range(3)]
            deadline = time.monotonic() + 10.0
            while plan.calls == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            eng.stop(timeout_s=0.3)
            outs = [_outcome(side, f) for f in futs]
        finally:
            plan.release.set()
        return outs

    t = _twin(sides, run)
    assert t["extra"] == ["shutdown"] * 3
    assert t["closed_by_kind"] == {"shutdown": 3}


def test_cancel_closes_the_span_once(sides):
    def run(side, tr):
        eng = side.engine(tr)
        with held(eng):
            fut = eng.submit(_pose())
            cancelled = fut.cancel()
            keep = eng.submit(_pose(1, seed=1))
        out = _outcome(side, keep)
        eng.stop()
        return cancelled, out

    t = _twin(sides, run)
    assert t["extra"] == (True, "ok")
    assert t["closed_by_kind"] == {"cancelled": 1, "ok": 1}


def test_evict_and_compile_events(sides):
    """A table of 2 rows, 3 subjects: an eviction and the gathered
    family's builds land on the timeline."""
    def run(side, tr):
        eng = side.engine(tr, max_subjects=2)
        keys = [eng.specialize(np.full(10, 0.1 * i, np.float32))
                for i in range(3)]
        with eng:
            outs = [eng.forward(_pose(1, seed=i), subject=k).shape
                    for i, k in enumerate(keys)]
        return outs

    t = _twin(sides, run)
    assert t["runtime"]["evict"] >= 1
    assert t["runtime"]["compile"] >= 1


def test_load_gains_quantiles_and_backlog_age(sides):
    def run(side, tr):
        eng = side.engine(tr, max_bucket=8)
        with eng:
            for i in range(4):
                eng.forward(_pose(2, seed=i))
            ld = eng.load()
        return ld["latency_by_tier"]["0"]["n"], ld["backlog_age_s"]

    t = _twin(sides, run)
    assert t["extra"] == (4, 0.0)


def test_untraced_engine_unchanged(sides):
    """``tracer=None``: no span state, and the primaries are called as
    before, with no tracing argument (a two-argument stand-in serves)."""
    port, _ = sides
    eng = ServingEngine(port.params, device="cpu", max_bucket=4)
    calls = []
    run_full = eng._run_full

    def plain(pose, shape):
        calls.append(pose.shape[0])
        return run_full(pose, shape)

    eng._run_full = plain
    with eng:
        fut = eng.submit(_pose(2))
        assert fut.result(timeout=30).shape == (2, 778, 3)
    assert eng.tracer is None and calls == [2]
    assert not hasattr(fut, "span")


def test_watchdog_kill_is_an_incident():
    for obs, rt in ((pobs, prt), (jobs, jrt)):
        tr = obs.Tracer()
        rec = obs.FlightRecorder(tr)
        fired = []
        wd = rt.supervise.Watchdog(fired.append, deadline_s=0.01,
                                   poll_s=0.01, tracer=tr).start()
        wd._thread.join(timeout=10)
        assert fired and [c["reason"] for c in rec.captures] == [
            "watchdog_kill"]


def test_torch_trace_co_exports_engine_timeline(tmp_path):
    """``utils.profiling.torch_trace(tracer=)``: the engine's span timeline
    lands beside the profiler capture, one report reads both; a
    tracer-less capture writes the profiler's trace alone."""
    from mano_hand_tpu_torch.obs import trace_report
    from mano_hand_tpu_torch.utils.profiling import TORCH_TRACE, torch_trace

    tr = pobs.Tracer()
    s = tr.start("full", tier=0, rows=1)
    for name in ("launch", "dispatched", "readback"):
        tr.event(s, name, **({"bucket": 2} if name == "launch" else {}))
    with torch_trace(tmp_path / "cap", tracer=tr) as prof:
        x = torch.ones(8, 8)
        (x @ x).sum()
        tr.close(s, "ok", bucket=2)
    assert prof is not None
    data = json.loads((tmp_path / "cap" / "engine.trace.json").read_text())
    assert data["manoEngineTrace"]["accounting"]["spans_closed"] == 1
    cap = json.loads((tmp_path / "cap" / TORCH_TRACE).read_text())
    assert any(e.get("name") == "aten::mm" for e in cap["traceEvents"])
    with torch_trace(tmp_path / "bare"):
        torch.ones(2).sum()
    assert sorted(p.name for p in (tmp_path / "bare").iterdir()) == [
        TORCH_TRACE]
    assert trace_report.main([str(tmp_path / "cap"), "--json"]) == 0
