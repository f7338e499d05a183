"""The port engine's resilience and admission layer against the JAX
engine's, on the CPU.

Each scenario runs twice — once on the port's ``ServingEngine(device=
"cpu")``, once on the JAX engine, both at serial dispatch
(``inflight_depth=1``) and the fixed coalesce window; the scenarios whose
batches do not depend on timing run again with both engines at JAX's
defaults (the pipelined dispatch, ``inflight_depth=2``, and the adaptive
window) — with the same traffic under the same ``ChaosPlan`` spec. Every future must resolve the
same way (result, or the same ``ServingError`` kind, phase and attempts),
results must agree within 1e-6 m, and the resilience and admission
counters must be equal. The port's CPU tier is also held bit for bit
against a direct CPU ``core.forward_batched`` call at the same padded
bucket.
"""

import threading
import time
import warnings
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from mano_hand_tpu import runtime as jrt
from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu.serving.engine import ServingError as JaxError
from mano_hand_tpu_torch import runtime as prt
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.serving import ServingEngine, ServingError, buckets
from mano_hand_tpu_torch.serving.engine import _Request
from mano_hand_tpu_torch.serving.streams import empty_snapshot

TOL = 1e-6
COUNTERS = ("retries", "faults_injected", "failovers", "deadline_kills",
            "shed", "expired", "cancelled", "dispatches",
            "coalesce_overflows", "backlog_peak", "tiers",
            "pipeline_completions", "pipeline_presweeps")


class Side:
    """One engine family: builds engines and policies from one spec."""

    def __init__(self, name, params, rt, engine, error, **extra):
        self.name, self.params, self.rt = name, params, rt
        self.Engine, self.Error, self.extra = engine, error, extra

    def engine(self, policy=None, **kw):
        kw.setdefault("max_bucket", 4)
        return self.Engine(self.params, policy=policy, **self.extra, **kw)

    def policy(self, spec="", probe=None, threshold=2, **kw):
        plan = self.rt.ChaosPlan(spec)
        breaker = (None if probe is None else self.rt.CircuitBreaker(
            failure_threshold=threshold, probe=probe, probe_interval_s=0.0,
            respect_priority_claim=False))
        for k, v in (("deadline_s", None), ("retries", 2),
                     ("backoff_s", 0.001), ("jitter", 0.0)):
            kw.setdefault(k, v)
        return (self.rt.DispatchPolicy(breaker=breaker, chaos=plan, **kw),
                plan, breaker)

    def outcome(self, fut, timeout=30.0):
        try:
            return ("ok", np.asarray(fut.result(timeout=timeout)))
        except CancelledError:
            return ("cancelled",)
        except self.Error as e:
            return ("ServingError", e.kind, e.phase, e.attempts,
                    None if e.cause is None else type(e.cause).__name__)
        except Exception as e:   # noqa: BLE001 — compared across engines
            return (type(e).__name__, str(e))


SERIAL = {"inflight_depth": 1, "adaptive_coalesce": False}
JAX_DEFAULTS = {"inflight_depth": 2, "adaptive_coalesce": True}


def _sides(params, pipe):
    port = synthetic_params(seed=0, device="cpu").astype(torch.float32)
    return (Side("port", port, prt, ServingEngine, ServingError,
                 device="cpu", **pipe),
            Side("jax", params.astype(np.float32), jrt, JaxEngine, JaxError,
                 **pipe))


@pytest.fixture(scope="module")
def sides(params):
    return _sides(params, SERIAL)


@pytest.fixture(scope="module")
def sides_pipelined(params):
    return _sides(params, JAX_DEFAULTS)


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)


def _shape(n=1, seed=0):
    return np.random.default_rng(100 + seed).normal(
        size=(n, 10)).astype(np.float32)


BETAS = list(np.random.default_rng(7).normal(size=(3, 10)).astype(
    np.float32))


class held:
    """Hold the dispatcher off so queue and park composition is
    deterministic; release it on exit."""

    def __init__(self, eng):
        self.eng = eng

    def __enter__(self):
        self.eng.start = lambda: self.eng
        return self.eng

    def __exit__(self, *exc):
        del self.eng.start          # the class method again
        self.eng.start()


def _twin(sides, scenario):
    """Run ``scenario(side) -> (outcomes, engine, extra)`` on both engines
    and hold them equal. Returns the port's (outcomes, engine, extra,
    failover warnings)."""
    runs = {}
    for side in sides:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs, eng, extra = scenario(side)
        warned = sum("failed over to the CPU tier" in str(w.message)
                     for w in caught)
        runs[side.name] = (outs, eng, extra, warned)
    (po, pe, px, pw), (jo, je, jx, _) = runs["port"], runs["jax"]
    assert len(po) == len(jo)
    for i, (a, b) in enumerate(zip(po, jo)):
        if not isinstance(a, tuple):
            assert a == b, i
        elif a[0] == "ok":
            assert b[0] == "ok", (i, b)
            assert a[1].shape == b[1].shape
            err = float(np.abs(a[1].astype(np.float64) - b[1]).max())
            assert err <= TOL, (i, err)
        else:
            assert a == b, i
    ps, js = pe.counters.snapshot(), je.counters.snapshot()
    assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert px == jx
    assert pw == ps["failovers"]     # every failover warned
    return po, pe, px, pw


def _cpu_direct(params, pose, shape, bucket):
    pose, shape = (torch.from_numpy(np.array(
        buckets.pad_rows(x, bucket), np.float32, order="C"))
        for x in (pose, shape))
    with torch.no_grad():
        return core.forward_batched(params, pose, shape).verts.numpy()


# ------------------------------------------------------ supervised faults
def _error_burst(side):
    pol, plan, br = side.policy("error@0,error@2-3", probe=lambda: True,
                                threshold=3)
    with side.engine(pol) as eng:
        keys = [eng.specialize(b) for b in BETAS]
        outs = [side.outcome(eng.submit(_pose(3, 1), _shape(3, 1))),
                side.outcome(eng.submit(_pose(2, 2), subject=keys[0])),
                side.outcome(eng.submit(_pose(1, 3), _shape(1, 3)))]
    return outs, eng, (br.state, br.opens, plan.calls)


def test_error_burst_is_retried(sides):
    outs, eng, _, _ = _twin(sides, _error_burst)
    assert [o[0] for o in outs] == ["ok"] * 3
    assert eng.counters.retries == 3 and eng.counters.failovers == 0


def _hang_killed(side):
    pol, plan, _ = side.policy("hang@0", deadline_s=0.5, retries=1)
    try:
        with side.engine(pol) as eng:
            eng.warmup([4])
            t0 = time.perf_counter()
            outs = [side.outcome(eng.submit(_pose(3, 4), _shape(3, 4)))]
            waited = time.perf_counter() - t0 >= 0.5
    finally:
        plan.release.set()      # free the abandoned worker
    return outs, eng, waited


def test_hang_is_deadline_killed_and_retried(sides):
    outs, eng, waited, _ = _twin(sides, _hang_killed)
    assert waited and outs[0][0] == "ok"
    assert eng.counters.deadline_kills == 1 and eng.counters.retries == 1


def _outage(side):
    device_up = [False]
    pol, plan, br = side.policy("error@0-", probe=lambda: device_up[0],
                                retries=1)
    outs = []
    with side.engine(pol, max_bucket=8) as eng:
        keys = [eng.specialize(b) for b in BETAS]
        for s in range(2):
            outs.append(side.outcome(eng.submit(_pose(3, 10 + s),
                                                _shape(3, 10 + s))))
        # ``held`` holds only a dispatcher not yet running: stop the
        # running one (nothing is pending), so the three submits below
        # queue before the restarted dispatcher reads any of them and
        # ride one batch however slowly this thread runs.
        eng.stop()
        with held(eng):
            futs = [eng.submit(_pose(n, 20 + i), subject=keys[i])
                    for i, n in enumerate((1, 2, 2))]
        outs += [side.outcome(f) for f in futs]
        states = [br.state]
        plan.clear()
        device_up[0] = True
        outs.append(side.outcome(eng.submit(_pose(2, 30), _shape(2, 30))))
        outs.append(side.outcome(eng.submit(_pose(2, 31),
                                            subject=keys[1])))
        states.append(br.state)
    return outs, eng, (states, br.opens, br.probes)


def test_persistent_outage_fails_over_then_back(sides):
    """A persistent outage opens the breaker and every batch — full, and
    a mixed-subject pose-only batch — fails over to the CPU tier; when
    the fault clears the probe closes the breaker and the primary serves
    again with no further failover."""
    outs, eng, extra, warned = _twin(sides, _outage)
    assert extra[0] == ["down", "healthy"]
    assert eng.counters.failovers == 3 and warned == 3
    assert eng.counters.mixed_subject_batches == 1
    # The CPU tier, bit for bit a direct CPU call at the same bucket.
    params = eng._params
    for s, got in zip(range(2), outs[:2]):
        want = _cpu_direct(params, _pose(3, 10 + s), _shape(3, 10 + s), 4)
        np.testing.assert_array_equal(got[1], want[:3])
    rows = [np.broadcast_to(b[None], (n, 10))
            for b, n in zip(BETAS, (1, 2, 2))]
    want = _cpu_direct(params, np.concatenate(
        [_pose(n, 20 + i) for i, n in enumerate((1, 2, 2))]),
        np.concatenate(rows), 8)
    np.testing.assert_array_equal(
        np.concatenate([o[1] for o in outs[2:5]]), want[:5])


def _wrong_output(side):
    pol, _, _ = side.policy("wrong:0.5@1", retries=0)
    with side.engine(pol) as eng:
        outs = [side.outcome(eng.submit(_pose(2, s), _shape(2, s)))
                for s in range(3)]
    return outs, eng, None


def test_wrong_output_is_served_as_is(sides):
    outs, eng, _, _ = _twin(sides, _wrong_output)
    want = _cpu_direct(eng._params, _pose(2, 1), _shape(2, 1), 2)
    np.testing.assert_allclose(outs[1][1], want + 0.5, rtol=0, atol=TOL)
    assert eng.counters.faults_injected == 1


def _no_fallback(side):
    pol, plan, _ = side.policy("error@0-", retries=1, cpu_fallback=False)
    with side.engine(pol) as eng:
        outs = [side.outcome(eng.submit(_pose(3, 5), _shape(3, 5)))]
        plan.clear()     # a failed batch is traffic: serve again
        outs.append(side.outcome(eng.submit(_pose(3, 5), _shape(3, 5))))
    return outs, eng, None


def test_no_fallback_resolves_to_serving_error(sides):
    outs, eng, _, _ = _twin(sides, _no_fallback)
    assert outs[0] == ("ServingError", "error", "dispatch", 2,
                       "InjectedFault")
    assert outs[1][0] == "ok" and eng.counters.failovers == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_deterministic_fault_stays_engine_fatal(sides):
    def run(side):
        pol, _, _ = side.policy("fatal@0")
        eng = side.engine(pol)
        eng.start()
        outs = [side.outcome(eng.submit(_pose(1, 6), _shape(1, 6)))]
        eng._thread.join(timeout=30)
        try:
            eng.submit(_pose(1, 6), _shape(1, 6))
            outs.append(("accepted",))
        except RuntimeError as e:
            outs.append(("refused", str(e)))
        return outs, eng, eng._thread.is_alive()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs, _, alive, _ = _twin(sides, run)
    assert outs[0][0] == "InjectedFault" and not alive
    assert outs[1] == ("refused", "serving engine dispatcher died")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_no_policy_never_runs_on_the_cpu_tier(sides):
    """Without a policy a failing batch stops the dispatcher: the CPU tier
    is never built, never run, and nothing is failed over."""
    port, _ = sides
    eng = port.engine()
    calls = []

    def broken(pose, shape):
        calls.append(1)
        raise RuntimeError("worker died mid-launch")

    eng._run_full = broken
    with held(eng):
        f1 = eng.submit(_pose(3, 6), _shape(3, 6))
        f2 = eng.submit(_pose(3, 7), _shape(3, 7))   # overflow -> parked
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="worker died"):
            f.result(timeout=30)
    eng._thread.join(timeout=30)
    with pytest.raises(RuntimeError, match="dispatcher died"):
        eng.submit(_pose(1, 8), _shape(1, 8))
    assert calls == [1] and not eng._cpu_exes
    assert eng.counters.failovers == 0
    assert eng.counters.coalesce_overflows == 1


def _stop_wedged(side):
    pol, plan, _ = side.policy("hang@0", retries=0, cpu_fallback=False)
    eng = side.engine(pol)
    try:
        eng.warmup([4])
        f1 = eng.submit(_pose(3, 6), _shape(3, 6))   # wedges
        time.sleep(0.2)
        f2 = eng.submit(_pose(3, 7), _shape(3, 7))   # queued behind
        t0 = time.perf_counter()
        eng.stop(timeout_s=0.5)
        bounded = time.perf_counter() - t0 < 5.0
        outs = [side.outcome(f, timeout=5.0) for f in (f1, f2)]
        try:
            eng.submit(_pose(2, 8), _shape(2, 8))
            outs.append(("accepted",))
        except RuntimeError:
            outs.append(("refused",))
    finally:
        plan.release.set()
    return outs, eng, bounded


def test_stop_resolves_every_future_when_the_dispatcher_is_wedged(sides):
    outs, _, bounded, _ = _twin(sides, _stop_wedged)
    assert bounded
    assert outs[:2] == [("ServingError", "shutdown", "shutdown", 0,
                         None)] * 2
    assert outs[2] == ("refused",)


# ------------------------------------------------------------- admission
def _shed_quotas(side):
    eng = side.engine(max_bucket=8, max_queued=4, busy_fraction=0.5)
    loads, outs = [], []
    keep = ("outstanding", "queued", "max_queued", "admission",
            "backlog_peak")

    def load():
        ld = eng.load()
        loads.append({k: ld[k] for k in keep})

    def sub(**kw):
        try:
            return eng.submit(_pose(1, len(outs)), **kw)
        except side.Error as e:
            outs.append(("ServingError", e.kind, e.phase))

    with held(eng):
        load()
        futs = [sub(priority=1), sub(priority=1)]
        load()
        sub(priority=1)                 # tier 1 at its quota: shed
        futs += [sub(priority=0), sub(priority=0)]
        load()
        sub(priority=0)                 # the queue is full: shed
    outs += [side.outcome(f) for f in futs]
    eng.stop()
    load()
    return outs, eng, loads


def test_shed_tier_quotas_and_load_states(sides):
    outs, eng, loads, _ = _twin(sides, _shed_quotas)
    assert outs[:2] == [("ServingError", "shed", "admission")] * 2
    assert [ld["admission"] for ld in loads] == [
        {"0": "ok", "1": "ok"}, {"0": "busy", "1": "shed"},
        {"0": "shed", "1": "shed"}, {"0": "ok", "1": "ok"}]
    snap = eng.counters.snapshot()
    assert snap["tiers"]["0"]["shed"] == snap["tiers"]["1"]["shed"] == 1
    assert eng.load()["backlog_peak"] == 4


def test_set_admission_and_validation(sides):
    port, _ = sides
    for kw in ({"max_queued": -1}, {"tier_quotas": {1: 4}},
               {"max_queued": 8, "tier_quotas": {1: -2}},
               {"max_queued": 8, "busy_fraction": 0.0},
               {"max_queued": 8, "busy_fraction": 1.5}):
        with pytest.raises(ValueError):
            port.engine(**kw)
    eng = port.engine(max_queued=8)
    with pytest.raises(ValueError):
        eng.submit(_pose(), priority=-1)
    got = eng.set_admission(max_queued=2, tier_quotas={1: 1})
    assert got == {"before": {"max_queued": 8, "tier_quotas": {}},
                   "after": {"max_queued": 2, "tier_quotas": {1: 1}}}
    assert eng.load()["admission"] == {"0": "ok", "1": "ok"}
    with pytest.raises(ValueError):
        port.engine().set_admission(max_queued=4)
    assert port.engine().load() == {
        "outstanding": 0, "queued": 0, "max_queued": None, "admission": {},
        "backlog_peak": 0, "streams": empty_snapshot()}


def test_pop_parked_is_tier_first_then_earliest_deadline(sides):
    port, _ = sides
    eng = port.engine()
    reqs = [_Request(_pose(), None, 1, False, None, tier=t, deadline=d)
            for t, d in ((1, None), (0, None), (1, 5.0), (0, 9.0),
                         (0, 3.0))]
    eng._pending.extend(reqs)
    assert [eng._pop_parked() for _ in reqs] == [
        reqs[4], reqs[3], reqs[1], reqs[2], reqs[0]]


# ------------------------------------------------------------- deadlines
def _deadline_expired_at_submit(side):
    eng = side.engine(max_queued=8)
    fut = eng.submit(_pose(), deadline_s=0.0)
    return ([fut.done(), side.outcome(fut)], eng,
            (eng._thread is None, eng.load()["outstanding"]))


def _deadline_queued(side):
    eng = side.engine()
    with held(eng):
        doomed = eng.submit(_pose(seed=1), deadline_s=0.02)
        alive = eng.submit(_pose(seed=2))
        time.sleep(0.06)
    outs = [side.outcome(alive), side.outcome(doomed)]
    eng.stop()
    return outs, eng, None


def _deadline_parked(side):
    pol, _, _ = side.policy("sat:0.15@0", retries=0, cpu_fallback=False)
    eng = side.engine(pol)
    eng.warmup()
    with held(eng):
        first = eng.submit(_pose(3, seed=1))
        parked = eng.submit(_pose(2, seed=2), deadline_s=0.05)
    outs = [side.outcome(first), side.outcome(parked)]
    eng.stop()
    return outs, eng, None


def _deadline_at_failover(fallback):
    def run(side):
        pol, plan, _ = side.policy("hang@0-", deadline_s=0.5, retries=0,
                                   backoff_s=0.0, cpu_fallback=fallback)
        eng = side.engine(pol, max_delay_s=0.0)
        try:
            with eng:
                eng.warmup()
                outs = [side.outcome(eng.submit(_pose(), deadline_s=0.08))]
        finally:
            plan.release.set()
        return outs, eng, None
    return run


def _deadline_readback(side):
    pol, _, _ = side.policy("sat:0.12@0", retries=0, cpu_fallback=False)
    eng = side.engine(pol, max_bucket=8)
    eng.warmup([2])
    with held(eng):
        unbounded = eng.submit(_pose(seed=1))
        doomed = eng.submit(_pose(seed=2), deadline_s=0.05)
    outs = [side.outcome(unbounded), side.outcome(doomed)]
    eng.stop()
    return outs, eng, None


@pytest.mark.parametrize("scenario, phase", [
    (_deadline_expired_at_submit, "admission"),
    (_deadline_queued, "dispatch"),
    (_deadline_parked, "dispatch"),
    (_deadline_at_failover(True), "failover"),
    (_deadline_at_failover(False), "failover"),
    (_deadline_readback, "readback"),
], ids=["submit", "queued", "parked", "failover", "failover_no_fallback",
        "readback"])
def test_deadlines_expire_at_every_boundary(sides, scenario, phase):
    outs, eng, _, _ = _twin(sides, scenario)
    expired = [o for o in outs if isinstance(o, tuple) and o[0] ==
               "ServingError"]
    assert [o[1:3] for o in expired] == [("expired", phase)]
    assert eng.counters.expired == 1 and eng.counters.failovers == 0


# ---------------------------------------------------------- cancellation
def _cancel(side):
    eng = side.engine(max_queued=2)
    outs = []
    with held(eng):
        f1 = eng.submit(_pose(), deadline_s=60.0)
        f2 = eng.submit(_pose(seed=1))
        try:
            eng.submit(_pose(seed=2))
        except side.Error as e:
            outs.append(("ServingError", e.kind))
        outs += [f1.cancel(), f1.cancel()]      # counted once
        f3 = eng.submit(_pose(seed=3))          # the freed slot
    outs += [side.outcome(f) for f in (f1, f2, f3)]
    eng.stop()
    outs.append(f2.cancel())                    # too late
    return outs, eng, eng.counters.snapshot()["requests_dispatched"]


def test_cancel_frees_the_slot_and_is_counted_once(sides):
    outs, eng, dispatched, _ = _twin(sides, _cancel)
    assert outs[:3] == [("ServingError", "shed"), True, True]
    assert outs[3] == ("cancelled",) and outs[-1] is False
    assert dispatched == 2 and eng.counters.cancelled == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("scenario", [
    _error_burst, _hang_killed, _outage, _wrong_output, _no_fallback,
    _shed_quotas, _cancel, _deadline_expired_at_submit, _deadline_queued,
    _deadline_at_failover(True), _deadline_readback,
], ids=["error_burst", "hang", "outage", "wrong_output", "no_fallback",
        "shed_quotas", "cancel", "deadline_submit", "deadline_queued",
        "deadline_failover", "deadline_readback"])
def test_scenarios_agree_at_the_jax_defaults(sides_pipelined, scenario):
    """Both engines pipelined (a completion stage of depth 2, the
    adaptive window): every future resolves the same way, results within
    1e-6 m, the resilience and admission counters equal, and no future
    strands."""
    outs, _, _, _ = _twin(sides_pipelined, scenario)
    assert outs and all(o != ("TimeoutError", "") for o in outs
                        if isinstance(o, tuple))


def test_submit_racing_stop_never_strands_a_future(sides):
    port, _ = sides
    for trial in range(4):
        eng = port.engine(max_queued=64)
        eng.start()
        barrier = threading.Barrier(2)
        futs = []

        def submitter():
            barrier.wait()
            for i in range(6):
                try:
                    futs.append(eng.submit(_pose(seed=i)))
                except (ServingError, RuntimeError):
                    pass
                if trial % 2:
                    time.sleep(0.0005)

        th = threading.Thread(target=submitter)
        th.start()
        barrier.wait()
        eng.stop(timeout_s=10.0)
        th.join(10.0)
        assert not th.is_alive()
        eng.stop(timeout_s=10.0)
        for f in futs:
            out = port.outcome(f, timeout=5.0)
            assert out[0] == "ok" or out[1] in ("shutdown", "error")


def test_card_engine_refuses_the_cpu_tier(sides, monkeypatch):
    """The CPU tier serves CPU engines only: a card engine given a policy
    with ``cpu_fallback`` is refused in the constructor, before anything
    reaches the card, so its work can never move to the host."""
    from mano_hand_tpu_torch.serving import engine as engine_mod

    port, _ = sides
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    pol, _, _ = port.policy(cpu_fallback=True)
    with pytest.raises(ValueError, match="cpu_fallback=False"):
        ServingEngine(port.params, device="cuda", policy=pol)
