"""The port engine's pipelined dispatch on the CPU: the mirror of the JAX
package's ``tests/test_pipeline.py`` on ``ServingEngine(device="cpu")``,
plus its parity with the JAX engine at the same pipeline settings.

* every chaos fault class landing on a batch in flight (the supervised
  envelope runs on a completion worker) resolves as on the serial path —
  an error retried, a hang killed and failed over, a wrong output passed
  through — with every span closed exactly once;
* ``stop(timeout_s=)`` sweeps batches wedged in the stage and the batch
  parked behind its backpressure;
* a batch whose every member expires while it waits for a completion
  worker is presweeped: resolved expired without a dispatch;
* the same batches give the same bits at depth 1 and depth 3, and depth 1
  has no pipeline telemetry;
* the parked queue is tier-then-EDF and the adaptive coalesce window is
  JAX's formula, value for value;
* the port engine at ``inflight_depth=2, adaptive_coalesce=True`` agrees
  with the JAX engine at the same settings on the same traffic.

A row of the plain CPU forward can round one ulp differently at another
batch size (~1e-8), so bit identity across depths is held on batches of
the same composition: a held dispatcher makes the composition
deterministic (every request queued before the first batch assembles).
"""

import time

import numpy as np
import pytest
import torch

from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu.serving.engine import _Request as JaxRequest
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.runtime import chaos
from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
from mano_hand_tpu_torch.serving.engine import (
    ServingEngine, ServingError, _Request,
)


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)


def _engine(params, **kw):
    return ServingEngine(params, device="cpu", **kw)


class _held:
    """Hold the dispatcher off so queue and stage composition is
    deterministic, then release it on exit."""

    def __init__(self, eng):
        self.eng = eng

    def __enter__(self):
        self.eng.start = lambda: self.eng
        return self.eng

    def __exit__(self, *exc):
        del self.eng.start          # the class method again
        self.eng.start()


def _supervised(plan, *, deadline_s=30.0, retries=0, cpu_fallback=False):
    return DispatchPolicy(deadline_s=deadline_s, retries=retries,
                          backoff_s=0.0, backoff_cap_s=0.0, jitter=0.0,
                          chaos=plan, cpu_fallback=cpu_fallback)


def _balanced(tr):
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0


# ----------------------------------- chaos composition through the stage
def test_error_on_inflight_batch_is_retried(params32):
    plan = chaos.ChaosPlan()
    tr = Tracer()
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0,
                  inflight_depth=2, tracer=tr,
                  policy=_supervised(plan, retries=1))
    with eng:
        eng.warmup()
        clean = eng.submit(_pose(2)).result(timeout=30)
        plan.schedule("error@0")
        out = eng.submit(_pose(2)).result(timeout=30)
    np.testing.assert_array_equal(out, clean)   # a retry, not a re-roll
    assert eng.counters.faults_injected == 1
    assert eng.counters.retries == 1
    assert eng.counters.pipeline_completions == 2
    _balanced(tr)


def test_hang_on_inflight_batch_fails_over(params32):
    plan = chaos.ChaosPlan()
    tr = Tracer()
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0,
                  inflight_depth=2, tracer=tr,
                  policy=_supervised(plan, deadline_s=0.3,
                                     cpu_fallback=True))
    try:
        with eng:
            eng.warmup()
            plan.schedule("hang@0")
            with pytest.warns(RuntimeWarning, match="failed over"):
                out = eng.submit(_pose(2)).result(timeout=30)
    finally:
        plan.release.set()        # the abandoned hang thread exits
    assert out.shape == (2, 778, 3) and np.isfinite(out).all()
    assert eng.counters.failovers == 1
    assert eng.counters.deadline_kills == 1
    _balanced(tr)


def test_wrong_output_on_inflight_batch_passes_through(params32):
    plan = chaos.ChaosPlan()
    tr = Tracer()
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0,
                  inflight_depth=2, tracer=tr, policy=_supervised(plan))
    with eng:
        eng.warmup()
        clean = eng.submit(_pose(2)).result(timeout=30)
        plan.schedule("wrong:1.0@0")
        skewed = eng.submit(_pose(2)).result(timeout=30)
    assert np.max(np.abs(skewed - clean)) == pytest.approx(1.0, rel=1e-4)
    assert eng.counters.faults_injected == 1
    _balanced(tr)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fatal_fault_on_a_worker_kills_the_dispatcher_at_once(params32):
    """An engine-fatal (deterministic) fault raised on a completion
    worker poisons its batch, wakes the dispatcher and stops it, as the
    serial cycle's dispatcher stops: the next submit is refused."""
    plan = chaos.ChaosPlan("fatal@0")
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0, inflight_depth=2,
                  policy=_supervised(plan))
    eng.start()
    fut = eng.submit(_pose(2))
    with pytest.raises(Exception) as ei:
        fut.result(timeout=30)
    assert not isinstance(ei.value, ServingError)
    eng._thread.join(timeout=10)
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="dispatcher died"):
        eng.submit(_pose(1))


def test_stop_timeout_sweeps_batches_wedged_in_stage(params32):
    plan = chaos.ChaosPlan()
    eng = _engine(params32, max_bucket=2, max_delay_s=0.0,
                  inflight_depth=2, policy=_supervised(plan, deadline_s=None))
    try:
        with _held(eng):
            plan.schedule("hang@0-")
            # Three 2-row batches at max_bucket=2: two wedge the two
            # workers, the third wedges the dispatcher in the stage's
            # backpressure.
            futs = [eng.submit(_pose(2, seed=i)) for i in range(3)]
        time.sleep(0.3)           # both workers inside the hang
        eng.stop(timeout_s=0.5)
        for f in futs:
            with pytest.raises(ServingError) as ei:
                f.result(timeout=30)
            assert ei.value.phase == "shutdown"
    finally:
        plan.release.set()


def test_stage_queue_presweep_skips_wholly_expired_batch(params32):
    plan = chaos.ChaosPlan()
    eng = _engine(params32, max_bucket=2, max_delay_s=0.0,
                  inflight_depth=2, policy=_supervised(plan, deadline_s=30.0))
    with eng:
        eng.warmup()
        plan.schedule("sat:0.5@*")
        with _held(eng):
            # Batches 1 and 2 hold both workers ~0.5 s; batch 3's 0.35 s
            # deadline lapses while it waits for a worker.
            f1 = eng.submit(_pose(2, seed=1))
            f2 = eng.submit(_pose(2, seed=2))
            f3 = eng.submit(_pose(2, seed=3), deadline_s=0.35)
        assert f1.result(timeout=30).shape == (2, 778, 3)
        assert f2.result(timeout=30).shape == (2, 778, 3)
        with pytest.raises(ServingError) as ei:
            f3.result(timeout=30)
    assert ei.value.kind == "expired"
    snap = eng.counters.snapshot()
    assert snap["pipeline_presweeps"] == 1
    assert eng.counters.expired == 1
    assert eng.counters.dispatches == 2      # the swept batch cost none


# --------------------------------------------- bit identity across depths
def test_results_bit_identical_across_depths(params32):
    """The same ragged requests, queued before the first batch assembles,
    resolve to the same bytes at depth 1 (the serial cycle, the fixed
    window) and depth 3 (the stage and the adaptive window), full and
    pose-only alike."""
    rng = np.random.default_rng(7)
    poses = [_pose(int(rng.integers(1, 4)), seed=100 + i)
             for i in range(12)]
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    outs = {}
    for depth, adaptive in ((1, False), (3, True)):
        eng = _engine(params32, max_bucket=8, max_delay_s=0.002,
                      adaptive_coalesce=adaptive, inflight_depth=depth)
        keys = [eng.specialize(b) for b in betas]
        eng.warmup()
        with _held(eng):
            futs = [eng.submit(p) if i % 2 else
                    eng.submit(p, subject=keys[i % 3])
                    for i, p in enumerate(poses)]
        outs[depth] = [f.result(timeout=30) for f in futs]
        eng.stop()
    for a, b in zip(outs[1], outs[3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------- depth-1 serial telemetry contract
def test_depth1_telemetry_has_no_pipeline_shape(params32):
    stamps = {}
    for depth in (1, 2):
        tr = Tracer()
        eng = _engine(params32, max_bucket=4, max_delay_s=0.0,
                      inflight_depth=depth, tracer=tr)
        with eng:
            eng.warmup()
            for i in range(6):
                eng.submit(_pose(2, seed=i)).result(timeout=30)
        names = {ev[1] for sp in tr.spans() for ev in sp["events"]}
        runtime = {name for _, sid, name, _ in tr.snapshot()["events"]
                   if sid == 0}
        snap = eng.counters.snapshot()
        stamps[depth] = (names, runtime, snap["pipeline_completions"],
                         snap["pipeline_inflight_peak"])
    names1, runtime1, completions1, peak1 = stamps[1]
    assert "staged" not in names1 and "pipeline" not in runtime1
    assert completions1 == 0 and peak1 == 0
    names2, runtime2, completions2, peak2 = stamps[2]
    assert "staged" in names2 and "pipeline" in runtime2
    assert completions2 == 6 and peak2 >= 1


# ------------------------------------------------- EDF parked-queue order
def test_pop_parked_is_tier_then_edf(params32):
    eng = _engine(params32, max_bucket=4)

    def req(tag, tier, deadline):
        return _Request(_pose(), None, 1, True, tag, tier=tier,
                        deadline=deadline)

    now = time.monotonic()
    eng._pending.extend([
        req("t1-late", 1, now + 9.0),
        req("t0-none-a", 0, None),
        req("t0-late", 0, now + 5.0),
        req("t1-soon", 1, now + 1.0),
        req("t0-soon", 0, now + 2.0),
        req("t0-none-b", 0, None),
    ])
    order = [eng._pop_parked().subject for _ in range(6)]
    assert order == ["t0-soon", "t0-late", "t0-none-a", "t0-none-b",
                     "t1-soon", "t1-late"]


# ------------------------------------------------ adaptive coalesce window
def test_coalesce_window_pressure_formula(params32):
    base = 0.004
    eng = _engine(params32, max_bucket=8, max_delay_s=base,
                  adaptive_coalesce=True)
    cap = eng.buckets[-1]
    assert cap == 8

    def head(age=0.0):
        r = _Request(_pose(), None, 1, True, None)
        r.t_submit = time.perf_counter() - age
        return r

    assert eng._coalesce_window(head()) == pytest.approx(base, rel=0.05)
    eng._pending.extend([object()] * 4)
    assert eng._coalesce_window(head()) == pytest.approx(
        base * (1 - 4 / cap), rel=0.05)
    eng._pending.extend([object()] * 3)
    assert eng._coalesce_window(head()) == 0.0
    eng._pending.clear()
    assert eng._coalesce_window(head(age=base)) == pytest.approx(
        base * (1 - 1 / 8), rel=0.05)
    assert eng._coalesce_window(head(age=8 * base)) == 0.0
    fixed = _engine(params32, max_bucket=8, max_delay_s=base,
                    adaptive_coalesce=False)
    fixed._pending.extend([object()] * (cap + 4))
    assert fixed._coalesce_window(head(age=8 * base)) == base


@pytest.mark.parametrize("backlog, age", [
    (0, 0.0), (1, 0.0), (3, 0.001), (6, 0.0), (7, 0.0), (0, 0.004),
    (2, 0.02), (0, 0.5), (12, 0.0)])
@pytest.mark.parametrize("adaptive", [True, False])
def test_coalesce_window_equals_jax(params, params32, monkeypatch,
                                    backlog, age, adaptive):
    """The same backlog, head age and settings give JAX's window to the
    last bit (one frozen clock for both engines)."""
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.0)
    port = _engine(params32, max_bucket=8, max_delay_s=0.004,
                   adaptive_coalesce=adaptive)
    jax_ = JaxEngine(params.astype(np.float32), max_bucket=8,
                     max_delay_s=0.004, adaptive_coalesce=adaptive)
    port._pending.extend([object()] * backlog)
    jax_._pending.extend([object()] * backlog)
    p_head = _Request(_pose(), None, 1, True, None)
    j_head = JaxRequest(_pose(), None, 1, True)
    p_head.t_submit = j_head.t_submit = 1000.0 - age
    assert port._coalesce_window(p_head) == jax_._coalesce_window(j_head)


def test_inflight_depth_and_defaults_validated(params32):
    eng = _engine(params32)
    assert eng.inflight_depth == 2 and eng.adaptive_coalesce is True
    with pytest.raises(ValueError, match="inflight_depth"):
        _engine(params32, inflight_depth=0)


# ------------------------------------------------- parity with JAX, piped
def test_pipelined_engine_agrees_with_jax(params, params32):
    """The same seeded traffic — full and pose-only, ragged rows, queued
    behind a held dispatcher — through the port engine and the JAX engine
    both at ``inflight_depth=2, adaptive_coalesce=True``: the same
    batches, results within 1e-6 m, the pipeline counters equal."""
    rng = np.random.default_rng(11)
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    traffic = [(_pose(int(n), seed=200 + i),
                rng.normal(size=(int(n), 10)).astype(np.float32), i % 3)
               for i, n in enumerate(rng.integers(1, 4, size=10))]

    def run(eng):
        keys = [eng.specialize(b) for b in betas]
        eng.warmup()
        with _held(eng):
            futs = [eng.submit(p, s) if kind == 0
                    else eng.submit(p, subject=keys[kind])
                    for p, s, kind in traffic]
        outs = [np.asarray(f.result(timeout=60)) for f in futs]
        eng.stop()
        return outs, eng.counters.snapshot()

    pipe = dict(max_bucket=8, max_delay_s=0.002, inflight_depth=2,
                adaptive_coalesce=True)
    po, ps = run(_engine(params32, **pipe))
    jo, js = run(JaxEngine(params.astype(np.float32), **pipe))
    for a, b in zip(po, jo):
        assert a.shape == b.shape
        assert float(np.abs(a.astype(np.float64) - b).max()) <= 1e-6
    for k in ("dispatches", "rows_live", "rows_padded",
              "requests_dispatched", "mixed_subject_batches",
              "pipeline_completions", "pipeline_presweeps"):
        assert ps[k] == js[k], k
    assert ps["pipeline_completions"] == ps["dispatches"] > 1
