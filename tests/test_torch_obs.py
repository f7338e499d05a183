"""The port's observability (``mano_hand_tpu_torch/obs``: tracer, flight
recorder, logger; the engine's spans and runtime events; ``torch_trace``)
against the JAX package's, on the CPU.

The pure tracer and recorder run the same call sequences on both
packages under one fake clock, so their accounting, spans, stage tables
and Chrome traces must be EQUAL, not just alike. The engine scenarios
mirror ``tests/test_obs.py``: the port's CPU engine and the JAX engine,
both at serial dispatch (``inflight_depth=1``, the fixed coalesce window)
and again both at JAX's defaults (the pipelined dispatch), take the same
traffic under the same chaos specs, and their per-span event names,
``closed_by_kind``, incidents and runtime event counts must be equal.
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


SERIAL = {"inflight_depth": 1, "adaptive_coalesce": False}
JAX_DEFAULTS = {"inflight_depth": 2, "adaptive_coalesce": True}


def _sides(params, pipe):
    port = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    return (Side("port", port, prt, ServingEngine, ServingError, pobs,
                 device="cpu", **pipe),
            Side("jax", params.astype(np.float32), jrt, JaxEngine, JaxError,
                 jobs, **pipe))


@pytest.fixture(scope="module")
def sides(params):
    return _sides(params, SERIAL)


@pytest.fixture(scope="module")
def sides_pipelined(params):
    return _sides(params, JAX_DEFAULTS)


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


def _ok_shed_expired(side, tr):
    eng = side.engine(tr, max_bucket=8, max_queued=1)
    with eng:
        ok = eng.forward(_pose(2)).shape
        expired = _outcome(side, eng.submit(_pose(), deadline_s=0.0))
    eng2 = side.engine(tr, max_bucket=8, max_queued=0)
    with pytest.raises(side.Error) as ei:
        eng2.submit(_pose())
    return ok, expired, ei.value.kind


def test_spans_ok_shed_expired(sides):
    t = _twin(sides, _ok_shed_expired)
    assert t["closed_by_kind"] == {"ok": 1, "expired": 1, "shed": 1}
    assert t["extra"] == ((2, 778, 3), "expired", "shed")
    assert ["submit", "launch", "dispatched", "readback", "resolve"] in \
        t["spans"]


def _error_kind(side, tr):
    pol, _ = side.policy("error@0-")
    eng = side.engine(tr, pol)
    with eng:
        eng.warmup([4])
        return _outcome(side, eng.submit(_pose(2)))


def test_spans_error_kind_under_persistent_fault(sides):
    t = _twin(sides, _error_kind)
    assert t["extra"] == "error" and t["closed_by_kind"] == {"error": 1}
    assert t["runtime"]["chaos_fault"] == 1


def _failover_incident(side, tr):
    pol, _ = side.policy("error@0-", fallback=True)
    rec = side.obs.FlightRecorder(tr)
    eng = side.engine(tr, pol)
    with eng:
        eng.warmup([4])
        out = eng.forward(_pose(2)).shape
    return out, [c["reason"] for c in rec.captures]


def test_spans_ok_through_failover_with_incident(sides):
    t = _twin(sides, _failover_incident)
    assert t["extra"] == ((2, 778, 3), ["failover"])
    assert t["closed_by_kind"] == {"ok": 1} and t["incidents"] == 1
    assert t["runtime"]["incident:failover"] == 1
    # full and cpu at the warmed bucket 4, then at the dispatch's bucket 2
    assert t["runtime"]["compile"] == 4


def _retries_kill_breaker(side, tr):
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


def test_retries_deadline_kill_and_breaker_ride_the_timeline(sides):
    """A hang killed at its deadline and retried, then two errors that
    open a breaker: the retries, the kill (an incident) and the breaker
    transitions are on the timeline, equal between the engines."""
    t = _twin(sides, _retries_kill_breaker)
    wired, outs, trans = t["extra"]
    assert wired and outs == ["ok", "ok"] and "down" in trans
    assert t["runtime"]["retry"] >= 1
    assert t["runtime"]["incident:deadline_kill"] == 1


def _coalesce_park(side, tr):
    eng = side.engine(tr)
    subj = eng.specialize(np.zeros(10, np.float32))
    with held(eng):
        futs = [eng.submit(_pose(1, seed=i)) for i in range(2)]
        futs.append(eng.submit(_pose(1, seed=3), subject=subj))
        futs.append(eng.submit(_pose(1, seed=4)))
    outs = [_outcome(side, f) for f in futs]
    eng.stop()
    return outs


def test_coalesce_and_park_events(sides):
    """A held dispatcher: three full requests coalesce into one batch; a
    pose-only request parks (kind) and leads the next batch."""
    t = _twin(sides, _coalesce_park)
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


def _cancel_span(side, tr):
    eng = side.engine(tr)
    with held(eng):
        fut = eng.submit(_pose())
        cancelled = fut.cancel()
        keep = eng.submit(_pose(1, seed=1))
    out = _outcome(side, keep)
    eng.stop()
    return cancelled, out


def test_cancel_closes_the_span_once(sides):
    t = _twin(sides, _cancel_span)
    assert t["extra"] == (True, "ok")
    assert t["closed_by_kind"] == {"cancelled": 1, "ok": 1}


def _evict_compile(side, tr):
    eng = side.engine(tr, max_subjects=2)
    keys = [eng.specialize(np.full(10, 0.1 * i, np.float32))
            for i in range(3)]
    with eng:
        outs = [eng.forward(_pose(1, seed=i), subject=k).shape
                for i, k in enumerate(keys)]
    return outs


def test_evict_and_compile_events(sides):
    """A table of 2 rows, 3 subjects: an eviction and the gathered
    family's builds land on the timeline."""
    t = _twin(sides, _evict_compile)
    assert t["runtime"]["evict"] >= 1
    assert t["runtime"]["compile"] >= 1


def _load_quantiles(side, tr):
    eng = side.engine(tr, max_bucket=8)
    with eng:
        for i in range(4):
            eng.forward(_pose(2, seed=i))
        ld = eng.load()
    return ld["latency_by_tier"]["0"]["n"], ld["backlog_age_s"]


def test_load_gains_quantiles_and_backlog_age(sides):
    t = _twin(sides, _load_quantiles)
    assert t["extra"] == (4, 0.0)


@pytest.mark.parametrize("scenario", [
    _ok_shed_expired, _error_kind, _failover_incident,
    _retries_kill_breaker, _coalesce_park, _cancel_span, _evict_compile,
    _load_quantiles,
], ids=["ok_shed_expired", "error_kind", "failover_incident",
        "retries_kill_breaker", "coalesce_park", "cancel", "evict_compile",
        "load_quantiles"])
def test_timelines_agree_at_the_jax_defaults(sides_pipelined, scenario):
    """Both engines pipelined: the same span timelines — each batch's
    spans carry ``staged`` between ``launch`` and ``dispatched`` — the
    same runtime events (one ``pipeline`` an engine start) and
    incidents, every span closed once."""
    t = _twin(sides_pipelined, scenario)
    assert t["runtime"]["pipeline"] >= 1
    assert all("staged" in s for s in t["spans"]
               if "dispatched" in s)


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


def test_torch_trace_marks_its_body(tmp_path):
    """``torch_trace`` runs its body inside one ``TRACE_BODY`` host span,
    within the profiler's window and around the body's ops: the window a
    reader takes, without the pads of a CUDA capture."""
    from mano_hand_tpu_torch.utils.profiling import (
        TORCH_TRACE, TRACE_BODY, torch_trace,
    )

    with torch_trace(tmp_path / "cap"):
        x = torch.ones(8, 8)
        (x @ x).sum()
    events = [e for e in json.loads((tmp_path / "cap" / TORCH_TRACE)
                                    .read_text())["traceEvents"]
              if e.get("ph") == "X"]
    body = [e for e in events if e.get("name") == TRACE_BODY]
    assert [e["cat"] for e in body] == ["user_annotation"]
    b0 = float(body[0]["ts"])
    b1 = b0 + float(body[0]["dur"])
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(b0 <= float(e["ts"]) and float(e["ts"])
                      + float(e["dur"]) <= b1 for e in mm)
    for e in events:
        if e.get("cat") == "Trace":
            assert float(e["ts"]) <= b0 and b1 <= float(e["ts"]) + float(
                e["dur"])


# ------------------------------------------------ the library's own spans
def _chunked_inputs(b=47, seed=3):
    """A float32 asset and ``b`` rows: 3 chunks of 20, the last partial."""
    params = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    g = torch.Generator().manual_seed(seed)
    pose = 0.3 * torch.randn(b, params.n_joints, 3, generator=g)
    shape = torch.randn(b, params.n_shape, generator=g)
    return params, pose, shape


#: ``forward_chunked``'s K1 route, which writes each chunk in place, and
#: its K4 route, which pads the last chunk and concatenates the chunks.
CHUNKED_ROUTES = {"k1": {"use_pallas_fused_full": True},
                  "k4": {"use_pallas_fused": True}}


def _chunked(params, pose, shape, route="k1"):
    from mano_hand_tpu_torch.models import core

    with torch.no_grad():
        return core.forward_chunked(params, pose, shape, chunk_size=20,
                                    **CHUNKED_ROUTES[route])


def _profiled(fn):
    """(result, {span name: [(start_ns, end_ns), ...]}) of ``fn()`` under
    a CPU profile: the library's ranges among its events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mano."):
            ranges[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    return out, dict(ranges)


@pytest.mark.parametrize("route", list(CHUNKED_ROUTES))
def test_library_spans_record_nothing_unprofiled(route):
    """No profiler: ``span`` hands back one shared no-op context, and a
    capture started after a call holds none of its ranges; under the
    profiler each span is a range of its name: on the K1 route the entry
    alone (its chunks are written in place), on K4's the entry, the
    padding and the concatenation."""
    from mano_hand_tpu_torch.obs import spans

    params, pose, shape = _chunked_inputs()
    assert spans.span(spans.CONCAT) is spans.span(spans.ENTRY_CHUNKED)
    with spans.span(spans.PAD) as opened:
        assert opened is None
    _chunked(params, pose, shape, route)
    _, ranges = _profiled(lambda: None)
    assert ranges == {}
    _, ranges = _profiled(lambda: _chunked(params, pose, shape, route))
    want = [spans.ENTRY_CHUNKED]
    if route == "k4":
        want += [spans.PAD, spans.CONCAT]
    assert sorted(ranges) == sorted(want)
    assert spans.span(spans.CONCAT) is spans.span(spans.PAD)


@pytest.mark.parametrize("route", list(CHUNKED_ROUTES))
def test_forward_chunked_spans_under_the_profiler(route):
    """Under a CPU profile, ``forward_chunked`` over 3 chunks (one
    partial) opens one root entry range: on the K1 route holding nothing
    else, on K4's holding its padding and then its concatenation (on the
    CPU the chunks run the plain version, no launch), and its output is
    the unprofiled one."""
    from mano_hand_tpu_torch.obs import spans

    params, pose, shape = _chunked_inputs()
    want = _chunked(params, pose, shape, route)   # the operand caches built
    out, ranges = _profiled(lambda: _chunked(params, pose, shape, route))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    (r0, r1), = ranges.pop(spans.ENTRY_CHUNKED)
    assert not any(name.startswith(spans.LAUNCH) for name in ranges)
    if route == "k1":
        assert ranges == {}
        return
    (p0, p1), = ranges[spans.PAD]
    (c0, c1), = ranges[spans.CONCAT]
    assert r0 <= p0 <= p1 <= c0 <= c1 <= r1


@pytest.mark.parametrize("route", ["chunked", "hands", "gather"])
def test_each_route_opens_its_entry_span(route):
    """Each forward route, on CPU tensors under a CPU profile, opens its
    one entry range around everything else it opens."""
    from mano_hand_tpu_torch.assets import mirror_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.obs import spans

    params, pose, shape = _chunked_inputs(b=6)
    if route == "chunked":
        entry = spans.ENTRY_CHUNKED
        call = lambda: _chunked(params, pose, shape)       # noqa: E731
    elif route == "hands":
        entry = spans.ENTRY_HANDS
        stacked = core.stack_params(mirror_params(params), params)
        call = lambda: core.forward_hands_pallas_fused_full(  # noqa: E731
            stacked, torch.stack([pose, pose]), torch.stack([shape, shape]))
    else:
        entry = spans.ENTRY_POSED_GATHER
        shaped = core.specialize(params, shape[:3])
        table = core.SubjectTable(shaped.v_shaped, shaped.joints,
                                  shaped.shape, shaped.pose_basis,
                                  shaped.lbs_weights, tuple(shaped.parents))
        call = lambda: core.forward_posed_gather_fused(  # noqa: E731
            table, [0, 2, 1, 1, 0, 2], pose)
    with torch.no_grad():
        want = call()
        out, ranges = _profiled(call)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    (r0, r1), = ranges.pop(entry)
    assert set(ranges) <= set(spans.LIBRARY_OPS)
    assert all(r0 <= a <= b <= r1 for rs in ranges.values() for a, b in rs)


def test_operand_copies_only_what_a_kernel_cannot_read():
    """``operand`` returns its input where nothing changes; a conversion
    and a contiguity copy are one ``mano.copy`` range each."""
    from mano_hand_tpu_torch.obs import spans
    from mano_hand_tpu_torch.ops.common import operand

    x = torch.arange(12.0).reshape(3, 4)

    def copies():
        assert operand(x) is x and operand(x, torch.float32) is x
        return operand(x.T, torch.float64)

    y, ranges = _profiled(copies)
    assert y.is_contiguous() and y.dtype == torch.float64
    assert torch.equal(y, x.T.double())
    assert list(ranges) == [spans.COPY] and len(ranges[spans.COPY]) == 2


def test_library_spans_nest_and_close_on_a_raise():
    """A span opened inside another nests in its range; a span whose
    body raises lets the error through and still closes its range."""
    from mano_hand_tpu_torch.obs import spans

    def body():
        with spans.span(spans.ENTRY_HANDS):
            with spans.span(spans.ENTRY_POSED_GATHER):
                with spans.span(spans.COPY):
                    pass
            with pytest.raises(RuntimeError):
                with spans.span(spans.CONCAT):
                    raise RuntimeError("x")

    _, ranges = _profiled(body)
    (o0, o1), = ranges[spans.ENTRY_HANDS]
    (i0, i1), = ranges[spans.ENTRY_POSED_GATHER]
    (k0, k1), = ranges[spans.COPY]
    (c0, c1), = ranges[spans.CONCAT]
    assert o0 <= i0 <= k0 <= k1 <= i1 <= c0 <= c1 <= o1


def test_tracer_on_the_monotonic_clock_exports_jaxs_trace_moved(
        monkeypatch):
    """A tracer on ``time.monotonic`` (the default clock) exports JAX's
    Chrome trace of the same calls with every stamp moved by one offset,
    the one its block names, onto the profiler's clock: µs since the
    Unix epoch. Both tracers read the same deterministic stand-in for
    ``time.monotonic``."""
    exports = {}
    for name, obs in (("port", pobs), ("jax", jobs)):
        monkeypatch.setattr(time, "monotonic", _clock())
        tr = obs.Tracer(clock=time.monotonic)
        for tier, bucket in ((0, 4), (1, 8)):
            s = tr.start("full", tier=tier, rows=2)
            for stage in ("coalesce", "launch", "dispatched", "readback"):
                tr.event(s, stage, **({"bucket": bucket}
                                      if stage == "launch" else {}))
            tr.close(s, "ok", bucket=bucket)
        tr.runtime_event("compile", family="full", bucket=8)
        exports[name] = tr.chrome_trace()
    port, jax_ = exports["port"], exports["jax"]
    offset = port["manoEngineTrace"].pop("epoch_offset_us")
    assert port["manoEngineTrace"] == jax_["manoEngineTrace"]
    assert abs(offset - time.time_ns() / 1e3) < 3600e6
    stamped = [e for e in jax_["traceEvents"] if "ts" in e]
    assert len(stamped) == 11
    for p, j in zip(port["traceEvents"], jax_["traceEvents"]):
        if "ts" in j:
            assert abs(p.pop("ts") - offset - j["ts"]) < 1.0, j["name"]
            j = {k: v for k, v in j.items() if k != "ts"}
        assert p == j


def test_engine_span_lands_inside_the_torch_trace_body(tmp_path):
    """A request span of a tracer on the default clock, exported by
    ``Tracer.chrome_trace()`` beside a ``torch_trace`` capture, lies
    inside the capture's ``torch_trace.body`` range: both files are on
    the profiler's clock, as is the capture's own library entry range."""
    from mano_hand_tpu_torch.obs import spans, trace_report
    from mano_hand_tpu_torch.utils.profiling import (
        TORCH_TRACE, TRACE_BODY, torch_trace,
    )

    params, pose, shape = _chunked_inputs()
    _chunked(params, pose, shape)
    tr = pobs.Tracer()
    with torch_trace(tmp_path / "cap", tracer=tr):
        s = tr.start("full", tier=0, rows=1)
        for name in ("launch", "dispatched", "readback"):
            tr.event(s, name, **({"bucket": 2} if name == "launch" else {}))
        _chunked(params, pose, shape)
        tr.close(s, "ok", bucket=2)
    cap = json.loads((tmp_path / "cap" / TORCH_TRACE).read_text())
    base_us = cap["baseTimeNanoseconds"] / 1e3
    body, = [e for e in cap["traceEvents"] if e.get("name") == TRACE_BODY]
    b0 = float(body["ts"]) + base_us
    b1 = b0 + float(body["dur"])
    engine = json.loads((tmp_path / "cap" / "engine.trace.json").read_text())
    req, = [e for e in engine["traceEvents"]
            if e.get("name", "").startswith("request/")]
    assert b0 <= req["ts"] and req["ts"] + req["dur"] <= b1
    entry, = [(a, b) for n, a, b in trace_report.program_spans(cap)
              if n == spans.ENTRY_CHUNKED]
    assert b0 <= entry[0] <= entry[1] <= b1
    assert req["ts"] <= entry[0] <= entry[1] <= req["ts"] + req["dur"]
