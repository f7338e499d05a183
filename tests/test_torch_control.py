"""Closed-loop control in the port (``serving/control.py``, the engine's
live control surface and ladder bias) against the JAX package's.

* Every case of JAX's ``tests/test_control.py`` (bounds, hysteresis, rate
  limits, crash = static defaults, the torn-snapshot hammer, the empty
  block) runs on a ``device="cpu"`` port engine.
* Twin parity: a port engine and a JAX engine built the same way, each
  with a Controller, driven by ONE sequence of ``tick(signals=...)``
  calls, keep identical actuation histories, engine values and
  ``load()["control"]`` blocks after every tick.
* The ladder bias against JAX's engine: at bias 0-2 the port's pose-only
  rows are within 1e-5 of JAX's, with equal ``rows_padded`` and
  ``dispatches``; under lanes=2 a bias builds nothing.
* The port's counter keys and ``load()`` key tree equal JAX's plus the
  port-only keys.
* The control drill at JAX's plumbing size.
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.serving.control import ControlConfig as JControlConfig
from mano_hand_tpu.serving.control import Controller as JController
from mano_hand_tpu.serving.engine import ServingEngine as JEngine
from mano_hand_tpu.serving.subject_store import SubjectStore as JStore
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.serving import ServingEngine, ServingError, measure
from mano_hand_tpu_torch.serving.control import (
    _SNAPSHOT_KEYS,
    ControlConfig,
    Controller,
    empty_snapshot,
)
from mano_hand_tpu_torch.serving.subject_store import SubjectStore

TOL = 1e-5
#: Counter-snapshot keys the port keeps beside JAX's.
PORT_ONLY_COUNTERS = {"dispatches_bf16", "dispatches_gathered"}


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu")


@pytest.fixture(scope="module")
def jparams32():
    return jax_synthetic(seed=0).astype(np.float32)


def _engine(params32, **kw):
    return ServingEngine(params32, device="cpu", **kw)


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)


def _slo(burn0):
    return {"tiers": {"0": {"burn_rates": {"goodput": burn0}}}}


def _sig(burn0=0.0, backlog_s=0.0, counters=None):
    """A synthetic signals dict: tick(signals=...) drives the decision
    logic deterministically without a live engine under load."""
    return {"load": {"backlog_age_s": backlog_s}, "slo": _slo(burn0),
            "counters": counters or {}}


def _controller(eng, cls=Controller, cfg_cls=ControlConfig, **cfg_kw):
    """A started-then-halted controller: start() captures the static
    defaults and attaches the snapshot source, stop() joins the tick
    thread so the test owns every tick() call."""
    cfg_kw.setdefault("cadence_s", 60.0)   # the thread never self-ticks
    cfg_kw.setdefault("min_actuation_interval_s", 0.0)
    ctl = cls(eng, config=cfg_cls(**cfg_kw))
    ctl.start()
    ctl.stop()
    return ctl


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


# ------------------------------------------------------------------ config
def test_control_config_validates():
    for bad in (dict(cadence_s=0.0), dict(hysteresis=1.0),
                dict(hysteresis=0.0), dict(min_actuation_interval_s=-1),
                dict(max_step_fraction=0.0), dict(max_step_fraction=1.5),
                dict(tier0_burn_low=2.0, tier0_burn_high=1.0),
                dict(backlog_age_low_s=0.5, backlog_age_high_s=0.25),
                dict(coalesce_min_s=0.1, coalesce_max_s=0.05),
                dict(tier1_quota_min_fraction=0.9,
                     tier1_quota_max_fraction=0.5),
                dict(retry_after_max_s=0), dict(bucket_bias_max=-1),
                dict(batch_fill_low=1.5), dict(warm_grow_ticks=0)):
        with pytest.raises(ValueError) as ours:
            ControlConfig(**bad)
        with pytest.raises(ValueError) as theirs:
            JControlConfig(**bad)
        assert str(ours.value) == str(theirs.value)
    cfg = ControlConfig(hysteresis=0.4, tier0_burn_high=2.0)
    assert cfg.tier0_burn_low == pytest.approx(0.8)   # one-knob deadband
    assert vars(ControlConfig()) == vars(JControlConfig())


# ---------------------------------------------------- engine live setters
def test_live_setters_validate_and_report_before_after(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8,
                  tier_quotas={1: 2}, max_delay_s=0.004)
    d = eng.set_coalesce_base(0.002)
    assert (d["before"], d["after"]) == (0.004, 0.002)
    assert eng.max_delay_s == 0.002
    with pytest.raises(ValueError):
        eng.set_coalesce_base(-0.001)
    with pytest.raises(ValueError):
        eng.set_coalesce_base(5.0)          # > the 1 s sanity ceiling

    d = eng.set_admission(max_queued=4, tier_quotas={1: 3})
    assert d["before"]["max_queued"] == 8
    assert d["after"] == {"max_queued": 4, "tier_quotas": {1: 3}}
    with pytest.raises(ValueError):
        eng.set_admission(max_queued=-1)

    d = eng.set_bucket_bias(1)
    assert (d["before"], d["after"]) == (0, 1)
    with pytest.raises(ValueError):
        eng.set_bucket_bias(len(eng.buckets))   # off the ladder
    with pytest.raises(ValueError):
        eng.set_bucket_bias(-1)


def test_set_admission_rejected_on_unbounded_engine(params32):
    eng = _engine(params32, max_bucket=4)
    assert eng.max_queued is None
    with pytest.raises(ValueError):
        eng.set_admission(max_queued=8)


def test_live_quota_change_takes_effect_at_submit(params32):
    """The same tier-1 submit that sheds under quota 0 is admitted right
    after a grow: no restart, dispatcher never started."""
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 0})
    with pytest.raises(ServingError) as e:
        eng.submit(_pose(), priority=1)
    assert e.value.kind == "shed"
    eng.set_admission(tier_quotas={1: 8})
    fut = eng.submit(_pose(), priority=1)   # admitted live
    assert fut is not None
    assert eng.counters.dispatches == 0     # a decision, not device work
    eng.stop()


def test_coalesce_base_takes_effect_at_the_next_assembly(params32):
    """``_coalesce_window`` reads the base for each batch: a retune shows
    in the very next window, with no restart."""
    eng = _engine(params32, max_bucket=4, max_delay_s=0.004,
                  adaptive_coalesce=False)

    class _Head:
        t_submit = time.perf_counter()

    assert eng._coalesce_window(_Head) == 0.004
    eng.set_coalesce_base(0.001)
    assert eng._coalesce_window(_Head) == 0.001


# ------------------------------------------------------- decision bounds
def test_hysteresis_deadband_holds(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2})
    ctl = _controller(eng, tier0_burn_high=1.0, hysteresis=0.5)
    for _ in range(5):
        assert ctl.tick(_sig(burn0=0.75)) == []   # inside (0.5, 1.0)
    assert eng._tier_quotas == {1: 2}
    assert ctl.snapshot()["actuations"] == 0


def test_quota_grows_cold_shrinks_hot_within_bounds(params32):
    eng = _engine(params32, max_bucket=4, max_queued=16, tier_quotas={1: 4})
    ctl = _controller(eng, max_step_fraction=0.25,
                      tier1_quota_min_fraction=0.25,
                      tier1_quota_max_fraction=0.75)

    def quota_events(sig):
        return [x for x in ctl.tick(sig) if x["actuator"] == "tier1_quota"]

    assert len(quota_events(_sig(burn0=0.0))) == 1
    assert eng._tier_quotas[1] == 8         # 4 + 0.25*16
    quota_events(_sig(burn0=0.0))
    assert eng._tier_quotas[1] == 12
    assert quota_events(_sig(burn0=0.0)) == []   # saturated: no event
    quota_events(_sig(burn0=2.0))
    assert eng._tier_quotas[1] == 8
    quota_events(_sig(burn0=2.0))
    assert eng._tier_quotas[1] == 4
    assert quota_events(_sig(burn0=2.0)) == []   # floored: no event
    hist = [h for h in ctl.snapshot()["history"]
            if h["actuator"] == "tier1_quota"]
    assert len(hist) == 4
    assert all(h["before"] != h["after"] for h in hist)


def test_rate_limit_blocks_immediate_reactuation(params32):
    eng = _engine(params32, max_bucket=4, max_queued=16, tier_quotas={1: 4})
    ctl = _controller(eng, min_actuation_interval_s=30.0)
    assert len(ctl.tick(_sig(burn0=0.0))) >= 1
    q = eng._tier_quotas[1]
    for _ in range(3):                      # inside the interval:
        assert ctl.tick(_sig(burn0=0.0)) == []   # held, not re-stepped
    assert eng._tier_quotas[1] == q


def test_coalesce_shrinks_under_backlog_and_restores(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8, max_delay_s=0.004)
    ctl = _controller(eng, backlog_age_high_s=0.1, max_step_fraction=0.5)

    def coalesce_events(sig):
        return [x for x in ctl.tick(sig) if x["actuator"] == "coalesce"]

    assert len(coalesce_events(_sig(backlog_s=0.5))) == 1
    assert eng.max_delay_s == pytest.approx(0.002)
    coalesce_events(_sig(backlog_s=0.0))
    coalesce_events(_sig(backlog_s=0.0))
    assert eng.max_delay_s == pytest.approx(0.004)
    assert coalesce_events(_sig(backlog_s=0.0)) == []   # at the default


def test_retry_after_steering_and_fallback(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2})
    ctl = _controller(eng, retry_after_max_s=8)
    assert ctl.retry_after_for(1) is None   # no opinion yet: static
    ctl.tick(_sig(burn0=2.0))               # hot: back off harder
    first = ctl.retry_after_for(1)
    assert first is not None and first >= 2
    for _ in range(4):
        ctl.tick(_sig(burn0=2.0))
    assert ctl.retry_after_for(1) == 8      # capped at the max
    assert ctl.retry_after_for(0) == 1      # tier 0 never punished
    for _ in range(8):
        ctl.tick(_sig(burn0=0.0))
    assert ctl.retry_after_for(1) == 1      # cold: halved home


def test_bucket_bias_rises_hot_and_fragmented_and_restores(params32):
    eng = _engine(params32, max_bucket=8, max_queued=16, tier_quotas={1: 4})
    ctl = _controller(eng, bucket_bias_max=2, batch_fill_low=0.5)
    c = {"rows_live": 0, "dispatches": 0}

    def bias_events(burn0):
        c["rows_live"] += 2                 # 2 rows / dispatch of 8: 0.25
        c["dispatches"] += 1
        return [x for x in ctl.tick(_sig(burn0=burn0, counters=dict(c)))
                if x["actuator"] == "bucket_bias"]

    assert bias_events(2.0) == []           # first sample: baseline only
    assert len(bias_events(2.0)) == 1 and eng.bucket_bias == 1
    bias_events(2.0)
    assert eng.bucket_bias == 2
    assert bias_events(2.0) == []           # capped at bucket_bias_max
    assert len(bias_events(0.0)) == 1 and eng.bucket_bias == 0


def test_warm_capacity_steering_grows_and_shrinks(params32):
    store = SubjectStore(warm_capacity=8)
    eng = _engine(params32, max_bucket=4, max_queued=8, subject_store=store)
    ctl = _controller(eng, warm_miss_grow_per_tick=4, warm_grow_ticks=2,
                      warm_idle_shrink_ticks=3, max_step_fraction=0.5,
                      warm_capacity_max=32)

    def warm_events(misses):
        return [x for x in ctl.tick(_sig(
            burn0=0.75, counters={"subject_store_misses": misses}))
            if x["actuator"] == "warm_capacity"]

    assert warm_events(0) == []         # first sample: baseline only
    assert warm_events(10) == []        # pressure tick 1 of 2
    a = warm_events(20)                 # tick 2: grow 8 -> 13
    assert len(a) == 1
    assert store.config.warm_capacity == 13
    assert (a[0]["before"], a[0]["after"]) == (8, 13)
    for m in (30, 40, 50, 60, 70, 80):
        warm_events(m)
    assert store.config.warm_capacity == 32
    for _ in range(20):
        warm_events(90)
    assert store.config.warm_capacity == 8
    assert all(h["after"] >= 8 for h in ctl.snapshot()["history"]
               if h["actuator"] == "warm_capacity")


# ---------------------------------------------------------- crash contract
def test_crash_reverts_to_static_defaults_and_never_wedges(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2},
                  max_delay_s=0.004)
    ctl = _controller(eng)
    ctl.tick(_sig(burn0=0.0, backlog_s=0.5))    # steer off the statics
    assert (eng._tier_quotas[1], eng.max_delay_s) != (2, 0.004)
    ctl._crash(RuntimeError("injected"))
    assert eng._tier_quotas == {1: 2}
    assert eng.max_delay_s == 0.004
    assert eng.max_queued == 8
    assert eng.bucket_bias == 0
    snap = ctl.snapshot()
    assert snap["crashed"] and not snap["running"]
    assert snap["reverts"] == 1
    assert ctl.tick(_sig(burn0=0.0)) == []   # never actuates again
    assert ctl.retry_after_for(1) is None    # the wire's static formula
    try:
        assert eng.submit(_pose(), priority=0) is not None
        with pytest.raises(ServingError):   # quota 2 enforced again
            for i in range(4):
                eng.submit(_pose(seed=i), priority=1)
    finally:
        eng.stop()


def test_crash_revert_is_counted_and_evented(params32):
    tr = Tracer()
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2},
                  tracer=tr)
    ctl = _controller(eng)
    ctl.tick(_sig(burn0=0.0))
    ctl._crash(RuntimeError("injected"))
    snap = eng.counters.snapshot()
    assert snap["control_actuations"] >= 1
    assert snap["control_reverts"] == 1
    assert snap["control_ticks"] == 1
    events = tr.snapshot()["events"]
    names = [e[2] for e in events]
    assert names.count("control") == snap["control_actuations"]
    assert "control_revert" in names
    assert any(e[2].startswith("incident:control_crash") for e in events)
    rev = next(e for e in events if e[2] == "control_revert")
    assert rev[3]["reason"] == "crash" and rev[3]["restored"] >= 3


def test_crashed_run_loop_reverts_via_thread(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2})
    ctl = Controller(eng, config=ControlConfig(
        cadence_s=0.01, min_actuation_interval_s=0.0))

    def poisoned(signals=None):
        raise RuntimeError("tick poisoned")

    ctl.tick = poisoned
    ctl.start()
    t0 = time.monotonic()
    while not ctl.snapshot()["crashed"]:
        assert time.monotonic() - t0 < 10.0
        time.sleep(0.005)
    ctl.stop()
    snap = ctl.snapshot()
    assert snap["crashed"] and snap["reverts"] == 1
    assert eng._tier_quotas == {1: 2}       # statics restored


def test_crash_off_the_tick_thread_waits_for_the_tick_in_flight(params32):
    """A crash raised on another thread (the drill's injected crash) while
    the tick thread is inside an actuation: the revert lands after that
    tick ends, so every actuator is back at its static default (port
    only: the tick's actuation used to land after the revert)."""
    import threading

    eng = _engine(params32, max_bucket=4, max_queued=8, max_delay_s=0.004)
    ctl = Controller(eng, config=ControlConfig(
        cadence_s=0.01, min_actuation_interval_s=0.0,
        backlog_age_high_s=0.1, max_step_fraction=0.5))
    ctl._signals = lambda: _sig(burn0=0.0, backlog_s=0.5)
    inside, setter = threading.Event(), eng.set_coalesce_base

    def slow_setter(value):
        inside.set()
        time.sleep(0.2)            # the crash and its revert run now
        return setter(value)

    eng.set_coalesce_base = slow_setter
    try:
        ctl.start()
        assert inside.wait(10.0)
        ctl._crash(RuntimeError("injected off the tick thread"))
        ctl.stop()
        assert eng.max_delay_s == 0.004
        assert eng.max_queued == 8
        assert eng.bucket_bias == 0
        assert ctl.snapshot()["reverts"] == 1
    finally:
        eng.stop()


def test_live_tick_thread_reads_the_engine_signals(params32):
    """Without synthetic signals the thread sweeps the engine's own
    ``load()``, counters and ``slo_report`` and ticks at its cadence."""
    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2},
                  tracer=Tracer())
    ctl = Controller(eng, config=ControlConfig(cadence_s=0.01))
    ctl.start()
    t0 = time.monotonic()
    try:
        while eng.counters.snapshot()["control_ticks"] < 3:
            assert time.monotonic() - t0 < 10.0
            time.sleep(0.005)
    finally:
        ctl.stop(revert=True)
    block = eng.load()["control"]
    assert block["attached"] and not block["running"]
    assert not block["crashed"] and block["ticks"] >= 3
    assert eng._tier_quotas == {1: 2}       # the reverting stop


# ------------------------------------------------------------ torn snapshot
def test_load_control_block_is_never_torn(params32):
    eng = _engine(params32, max_bucket=4, max_queued=16, tier_quotas={1: 4})
    ctl = _controller(eng, max_step_fraction=0.1)
    keys = set(empty_snapshot())
    bad = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            c = eng.load()["control"]
            if set(c) != keys:
                bad.append(("keys", sorted(set(c) ^ keys)))
            if c["version"] != c["actuations"]:
                bad.append(("version", c["version"], c["actuations"]))
            if c["history"] and c["history"][-1]["version"] > c["version"]:
                bad.append(("history", c["history"][-1]["version"],
                            c["version"]))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for i in range(200):
        ctl.tick(_sig(burn0=0.0 if i % 2 else 2.0))
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not bad, bad[:5]
    assert ctl.snapshot()["actuations"] >= 100


def test_engine_without_controller_serves_empty_snapshot(params32):
    eng = _engine(params32, max_bucket=4, max_queued=8)
    c = eng.load()["control"]
    assert c == empty_snapshot()
    assert set(c) == set(_SNAPSHOT_KEYS)
    ctl = _controller(eng)
    assert eng.load()["control"]["attached"] is True
    assert set(ctl.snapshot()) == set(_SNAPSHOT_KEYS)
    eng.attach_control(lambda: 1 / 0)
    assert eng.load()["control"] == empty_snapshot()
    eng.detach_control()
    assert eng.load()["control"] == empty_snapshot()


# ------------------------------------------------------------- twin parity
def _twin_signals():
    """~30 ticks mixing tier-0 burn (cold, deadband, hot), backlog age,
    rows_live/dispatches (fill 0.125-1.0) and subject-store misses."""
    seq = []
    rows = disp = misses = 0
    rng = np.random.default_rng(3)
    for i in range(30):
        burn0 = (0.0, 0.2, 0.75, 1.5, 3.0)[int(rng.integers(5))]
        backlog = (0.0, 0.05, 0.2, 0.5)[int(rng.integers(4))]
        d = int(rng.integers(0, 4))
        disp += d
        rows += d * int(rng.integers(1, 9))
        misses += (0, 2, 6, 12)[int(rng.integers(4))]
        seq.append(_sig(burn0=burn0, backlog_s=backlog, counters={
            "rows_live": rows, "dispatches": disp,
            "subject_store_misses": misses}))
    return seq


def _engine_values(eng):
    return {"max_delay_s": eng.max_delay_s, "max_queued": eng.max_queued,
            "tier_quotas": dict(eng._tier_quotas),
            "bucket_bias": eng.bucket_bias,
            "warm_capacity": eng.subject_store.config.warm_capacity}


def test_twin_controllers_make_jax_s_decisions(params32, jparams32):
    kw = dict(max_bucket=8, max_queued=16, tier_quotas={1: 4},
              max_delay_s=0.004)
    eng = _engine(params32, subject_store=SubjectStore(warm_capacity=8),
                  **kw)
    jeng = JEngine(jparams32, subject_store=JStore(warm_capacity=8), **kw)
    assert list(eng.buckets) == list(jeng.buckets)
    cfg = dict(cadence_s=60.0, min_actuation_interval_s=0.0,
               max_step_fraction=0.25, bucket_bias_max=2,
               batch_fill_low=0.5, warm_miss_grow_per_tick=4,
               warm_grow_ticks=2, warm_idle_shrink_ticks=3,
               warm_capacity_max=32, coalesce_max_s=0.008)
    ctl = _controller(eng, **cfg)
    jctl = _controller(jeng, cls=JController, cfg_cls=JControlConfig, **cfg)
    moved = set()
    for i, sig in enumerate(_twin_signals()):
        ours = ctl.tick(sig)
        theirs = jctl.tick(sig)
        assert ours == theirs, i
        moved |= {a["actuator"] for a in ours}
        assert _engine_values(eng) == _engine_values(jeng), i
        a, b = eng.load()["control"], jeng.load()["control"]
        assert _key_tree(a) == _key_tree(b), i
        assert a == b, i
        assert ctl.retry_after_for(1) == jctl.retry_after_for(1)
    assert ctl.snapshot()["history"] == jctl.snapshot()["history"]
    # The sequence exercised every actuator.
    assert moved == {"tier1_quota", "retry_after", "coalesce",
                     "bucket_bias", "warm_capacity"}
    # And the crash path reverts both the same way.
    assert ctl.revert_to_defaults("crash") == \
        jctl.revert_to_defaults("crash")
    assert _engine_values(eng) == _engine_values(jeng)
    assert eng.load()["control"] == jeng.load()["control"]


def test_counter_keys_and_load_tree_equal_jax_s(params32, jparams32):
    kw = dict(max_bucket=4, max_queued=8, tier_quotas={1: 2})
    eng = _engine(params32, **kw)
    jeng = JEngine(jparams32, **kw)
    # The benchmark lines' counter keys: the port derives JAX's
    # padding_waste and latency_by_bucket beside its counters.
    ours = measure._derived_snapshot(eng, latencies={})
    assert set(ours) == set(jeng.counters.snapshot()) | PORT_ONLY_COUNTERS
    assert _key_tree(eng.load()) == _key_tree(jeng.load())
    _controller(eng)
    _controller(jeng, cls=JController, cfg_cls=JControlConfig)
    assert _key_tree(eng.load()) == _key_tree(jeng.load())


def test_load_control_gauges_and_counters_export(params32):
    from mano_hand_tpu.obs.metrics import load_samples as j_load_samples
    from mano_hand_tpu_torch.obs.metrics import (
        load_samples,
        serving_samples,
    )
    from mano_hand_tpu_torch.obs.metrics import sample as metric_sample

    eng = _engine(params32, max_bucket=4, max_queued=8, tier_quotas={1: 2})
    ctl = _controller(eng)
    ctl.tick(_sig(burn0=2.0))
    load = eng.load()
    ours = {k: v for k, v in load_samples(load).items()
            if k.startswith("load_control_")}
    theirs = {k: v for k, v in j_load_samples(load).items()
              if k.startswith("load_control_")}
    assert ours == theirs
    assert set(ours) == {
        "load_control_attached", "load_control_running",
        "load_control_crashed", "load_control_version",
        "load_control_coalesce_base_s", "load_control_max_queued",
        "load_control_bucket_bias", "load_control_retry_after_s"}
    ser = serving_samples(eng.counters.snapshot())
    assert ser["serving_unexported_keys"]["samples"] == [
        metric_sample(0)]
    for k in ("control_ticks", "control_actuations", "control_reverts"):
        assert f"serving_{k}" in ser


def test_status_server_control_block_reads_the_metrics_text(params32):
    """``status --server``'s control block: the worker's load_control_*
    gauges and control_* counters, parsed back from its /metrics text."""
    from mano_hand_tpu_torch.cli import _control_from_prometheus
    from mano_hand_tpu_torch.obs.metrics import engine_registry

    eng = _engine(params32, max_bucket=2, max_queued=8)
    reg = engine_registry(eng)
    assert _control_from_prometheus(reg.prometheus()) == {
        "attached": False, "running": False, "crashed": False,
        "version": 0, "ticks": 0, "actuations": 0, "reverts": 0}
    ctl = Controller(eng, config=ControlConfig(cadence_s=60.0))
    ctl.start()
    try:
        ctl.tick(_sig(burn0=2.0))
        got = _control_from_prometheus(reg.prometheus())
    finally:
        ctl.stop()
    assert got == {
        "attached": True, "running": True, "crashed": False,
        "version": 2, "ticks": 1, "actuations": 2, "reverts": 0,
        "coalesce_base_s": eng.max_delay_s, "max_queued": 8,
        "bucket_bias": 0, "retry_after_s": {"0": 1, "1": 4}}
    assert _control_from_prometheus("# proxy\nmano_proxy_x 1\n") == {}


# --------------------------------------------------------------- ladder bias
def _posed_requests(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.4, size=(1, 16, 3)).astype(np.float32)
            for _ in range(n)]


def test_ladder_bias_rows_and_padding_equal_jax_s(params32, jparams32):
    """One pose-only request at a time (one dispatch each) at bias 0, 1,
    2: the biased bucket pads 1 row to 1, 2, 4 rows on both engines; the
    rows stay within 1e-5 of JAX's and of bias 0's, and the port builds
    nothing after warm-up."""
    betas = np.random.default_rng(1).normal(size=10).astype(np.float32)
    poses = _posed_requests(3, seed=2)
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0,
                  posed_kernel="fused")
    jeng = JEngine(jparams32, max_bucket=4, max_delay_s=0.0)
    key, jkey = eng.specialize(betas), jeng.specialize(betas)
    eng.warmup_posed()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng.warmup_posed()
    compiles = eng.counters.compiles
    base = None
    try:
        for bias in (0, 1, 2):
            eng.set_bucket_bias(bias)
            jeng.set_bucket_bias(bias)
            ours = np.stack([eng.submit(p, subject=key).result(timeout=60)
                             for p in poses])
            theirs = np.stack([np.asarray(jeng.submit(
                p, subject=jkey).result(timeout=120)) for p in poses])
            assert np.abs(ours - theirs).max() <= TOL, bias
            if base is None:
                base = ours
            assert np.abs(ours - base).max() <= TOL, bias
            a, b = eng.counters.snapshot(), jeng.counters.snapshot()
            for k in ("rows_padded", "rows_live", "dispatches"):
                assert a[k] == b[k], (bias, k)
        assert eng.counters.snapshot()["rows_padded"] == 0 + 3 + 9
        assert eng.counters.compiles == compiles
    finally:
        eng.stop()
        jeng.stop()


def test_ladder_bias_under_lanes_builds_nothing(params32):
    betas = np.random.default_rng(1).normal(size=(2, 10)).astype(np.float32)
    eng = _engine(params32, max_bucket=4, max_delay_s=0.0, lanes=2,
                  posed_kernel="fused")
    keys = [eng.specialize(b) for b in betas]
    eng.warmup()
    eng.warmup_posed()
    compiles = eng.counters.compiles
    poses = _posed_requests(4, seed=5)
    try:
        want = [eng.submit(p, subject=keys[i % 2]).result(timeout=60)
                for i, p in enumerate(poses)]
        for bias in (1, 2):
            eng.set_bucket_bias(bias)
            got = [eng.submit(p, subject=keys[i % 2]).result(timeout=60)
                   for i, p in enumerate(poses)]
            full = eng.submit(poses[0], np.zeros((1, 10), np.float32)
                              ).result(timeout=60)
            assert full.shape == (1, 778, 3)
            for g, w in zip(got, want):
                assert np.abs(g - w).max() <= TOL
        assert eng.counters.compiles == compiles
        assert eng.counters.snapshot()["rows_padded"] > 0
    finally:
        eng.stop()


# ----------------------------------------------------------------- the drill
def test_control_drill_small_e2e(params32):
    """The drill at JAX's plumbing size: the criteria's fields populated
    and consistent (the verdict belongs to the full-size run)."""
    from mano_hand_tpu_torch.serving.measure import control_drill_run

    out = control_drill_run(
        params32, trace_duration_s=0.7, workers=8, pairs=1,
        max_bucket=4, max_queued=8, tier1_quota=2,
        sat_latency_s=0.01, cadence_s=0.03, seed=5, device="cpu")
    assert out["control_drill_schema"] == 1
    assert out["unresolved_total"] == 0
    assert out["steady_recompiles_total"] == 0
    assert out["actuations_total"] > 0
    assert out["actuations_evented"] is True
    assert out["spans_closed_exactly_once"] is True
    assert len(out["trace"]["sha256"]) == 64
    cl = out["crash_leg"]
    assert cl["crash_injected"] and cl["control"]["crashed"]
    assert cl["reverted_to_static"] is True
    assert cl["unresolved"] == 0
    assert out["static_tier1_served"] >= 0
    assert out["controlled_tier1_served"] >= 0
    json.dumps(out)
