"""The port's runtime (``runtime/{chaos,supervise,health}.py``), its device
lock (``utils/devicelock.py``) and its serving counters, held against the
JAX package's modules on the same inputs.

The chaos grammar must accept and reject exactly what JAX's does, with
the same events and the same ``ValueError`` messages; supervision, the
circuit breaker and the failover ladder must take the same decisions
under the same fake clock; the device lock runs the JAX tests' twelve
cases on the port copy.
"""

import json
import os
import random
import tempfile
import threading
import time

import pytest
import torch

from mano_hand_tpu.runtime import chaos as jchaos
from mano_hand_tpu.runtime import health as jhealth
from mano_hand_tpu.runtime import supervise as jsupervise
from mano_hand_tpu_torch.runtime import chaos, health, supervise
from mano_hand_tpu_torch.utils import devicelock
from mano_hand_tpu_torch.utils.devicelock import DeviceBusy, DeviceLock
from mano_hand_tpu_torch.utils.profiling import ServingCounters

# ----------------------------------------------------------- chaos grammar
# JAX's spec lists (tests/test_runtime.py, tests/test_overload.py) and the
# grammar's documented examples.
VALID_SPECS = [
    "", "error@1-2,latency:0.2@4,wrong@6,hang@8-,fatal@3,error@*",
    "sat:0.01@0-,latency:0.2@1-3,wrong@6,wrong:0.5@7,hang@8-,error@*",
    "error@0,latency:0.01@2,wrong:0.5@3,fatal@4", "wrong:0.5@3%2",
    "error@1-%1", "error@0%1", "sat:0.05@1.5s-2.5s%0", "error@2s-",
    "error@0.05s-0.15s", "error@0s-%1", "error@0-1", "hang@2", "error@0-",
    "latency:0.2@1-3", "sat:0.02@0-", "wrong:0.5@4", "error@2s-3s",
    "sat:0.05@1.5s-%0", " error@0 , hang@2 ,", "latency:0@1",
]
INVALID_SPECS = [
    "error", "explode@1", "latency@1", "hang:2@0", "error:1@0-", "sat@0-",
    "latency:abc@1", "sat:-0.1@0", "error@5-2", "error@x", "error@x-3",
    "error@1-y", "wrong:1.0", "error@0-%", "error@%1", "error@0%x",
    "error@0%-1", "error@2s", "error@1s-3", "error@1-3s", "error@3s-1s",
    "error@2s-2s", "error@-1s-2s", "error@xs-2s", "error@1s-ys",
    "error@-1", "wrong:x@1", "fatal:1@2",
]


def _parsed(mod, spec):
    try:
        plan = mod.parse_plan(spec)
    except ValueError as e:
        return ("ValueError", str(e))
    return [(e.kind, e.start, e.stop, e.param, e.lane, e.t_start, e.t_stop,
             repr(e)) for e in plan._events]


@pytest.mark.parametrize("spec", VALID_SPECS + INVALID_SPECS)
def test_parse_plan_matches_jax(spec):
    got, want = _parsed(chaos, spec), _parsed(jchaos, spec)
    assert got == want
    assert isinstance(got, tuple) == (spec in INVALID_SPECS)


CAMPAIGN_SPECS = [
    "kill_proxy@4s, kill_worker@2s, partition:1.5@6s, damage_page@0s",
    "kill_worker@1s,kill_worker@1s,damage_page@0.5s", "",
    "kill_worker", "kill_worker@2s-4s", "kill_worker@2", "reboot_rack@2s",
    "partition@2s", "kill_worker:1.5@2s", "partition:-1@2s",
    "kill_worker@-2s", "partition:x@1s", "kill_proxy@ys",
]


@pytest.mark.parametrize("spec", CAMPAIGN_SPECS)
def test_parse_campaign_matches_jax(spec):
    def parsed(mod):
        try:
            return [(e.kind, e.at_s, e.param, repr(e))
                    for e in mod.parse_campaign(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    assert parsed(chaos) == parsed(jchaos)


def _outcomes(mod, spec, calls, lane=None):
    plan = mod.ChaosPlan(spec)
    hits = []
    fn = plan.wrap(lambda x: x * 2.0, on_fault=lambda: hits.append(1),
                   lane=lane)
    out = []
    for x in calls:
        try:
            out.append(("ok", float(fn(x))))
        except Exception as e:   # noqa: BLE001 — the outcome is compared
            out.append((type(e).__name__, str(e),
                        getattr(e, "transient", None)))
    return out, plan.faults_injected, len(hits), plan.calls


@pytest.mark.parametrize("spec, lane", [
    ("error@0,latency:0.01@2,wrong:0.5@3,fatal@4", None),
    ("error@1-%1", 1), ("error@1-%1", 0), ("error@2", 0),
    ("wrong@0-2,error@*", None), ("sat:0.001@0-", None),
])
def test_chaos_wrap_matches_jax(spec, lane):
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert _outcomes(chaos, spec, xs, lane) == _outcomes(jchaos, spec, xs,
                                                          lane)


def test_chaos_schedule_clear_and_hang_release():
    plan = chaos.ChaosPlan("error@0")
    fn = plan.wrap(lambda: "ok")
    with pytest.raises(chaos.InjectedFault, match="UNAVAILABLE"):
        fn()
    plan.schedule("error@0")            # restarts the call index
    with pytest.raises(chaos.InjectedFault):
        fn()
    assert plan.faults_injected == 2
    plan.clear()
    assert fn() == "ok"
    plan.schedule("hang@0")
    t = threading.Timer(0.05, plan.release.set)
    t.start()
    with pytest.raises(chaos.InjectedFault, match="released"):
        fn()
    t.join(timeout=10)


def test_chaos_campaign_runs_its_schedule():
    pools = [{"w2", "w0", "w1"}, {"w0", "w1"}]
    assert ([chaos.ChaosCampaign("kill_worker@0s", seed=7).pick(p)
             for p in pools]
            == [jchaos.ChaosCampaign("kill_worker@0s", seed=7).pick(p)
                for p in pools])
    camp = chaos.ChaosCampaign("kill_worker@0s, kill_proxy@0s", seed=0)
    with pytest.raises(RuntimeError, match="no handler"):
        camp.start()
    camp.on("kill_worker", lambda ev: "w1")
    camp.on("kill_proxy", lambda ev: (_ for _ in ()).throw(
        RuntimeError("proxy already gone")))
    camp.start()
    assert camp.join(timeout_s=30.0)
    fired = camp.fired()
    assert [e["kind"] for e in fired] == ["kill_worker", "kill_proxy"]
    assert fired[0]["result"] == "w1"
    assert "proxy already gone" in fired[1]["error"]


# ------------------------------------------------------------- supervision
def test_backoff_delay_matches_jax_under_a_seeded_rng():
    for jitter in (0.0, 0.5):
        r_port, r_jax = random.Random(11), random.Random(11)
        got = [supervise.backoff_delay(a, 0.1, 1.0, jitter, rng=r_port)
               for a in range(8)]
        want = [jsupervise.backoff_delay(a, 0.1, 1.0, jitter, rng=r_jax)
                for a in range(8)]
        assert got == want
    assert [supervise.backoff_delay(a, 0.1, 1.0, 0.0) for a in range(6)] \
        == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]


@pytest.mark.parametrize("deadlines", [
    [], [None], [1.0, None], [1.0, 3.0, 2.0], [5.5]])
def test_batch_give_up_by_matches_jax(deadlines):
    assert supervise.batch_give_up_by(iter(deadlines)) == \
        jsupervise.batch_give_up_by(iter(deadlines))


def _drive(mod, fails, retries, give_up_by, transient, keep_going=9):
    """``supervised_call`` on a fake clock: each attempt takes 0.3 s and
    the first ``fails`` attempts raise. Returns everything observable."""
    now = [0.0]
    log = []
    calls = [0]

    def sleep(s):
        log.append(("sleep", round(s, 9)))
        now[0] += s

    def fn():
        calls[0] += 1
        now[0] += 0.3
        if calls[0] <= fails:
            raise jchaos.InjectedFault("UNAVAILABLE blip",
                                       transient=transient)
        return "ok"

    try:
        res = ("ok", mod.supervised_call(
            fn, retries=retries, backoff_s=0.1, backoff_cap_s=0.25,
            jitter=0.0, give_up_by=give_up_by, sleep=sleep,
            clock=lambda: now[0],
            keep_trying=lambda: calls[0] < keep_going,
            on_retry=lambda: log.append("retry"),
            on_attempt_failure=lambda: log.append("fail")))
    except Exception as e:   # noqa: BLE001 — the outcome is compared
        res = (type(e).__name__, getattr(e, "attempts", None),
               type(getattr(e, "cause", None)).__name__)
    return res, log, calls[0], round(now[0], 9)


@pytest.mark.parametrize("fails, retries, give_up_by, transient, keep", [
    (0, 2, None, True, 9), (2, 2, None, True, 9), (5, 2, None, True, 9),
    (3, 5, 1.0, True, 9), (3, 5, 0.65, True, 9), (1, 3, None, False, 9),
    (4, 6, None, True, 2), (2, 0, None, True, 9), (9, 4, 2.0, True, 9),
])
def test_supervised_call_matches_jax_on_a_fake_clock(
        fails, retries, give_up_by, transient, keep):
    assert _drive(supervise, fails, retries, give_up_by, transient, keep) \
        == _drive(jsupervise, fails, retries, give_up_by, transient, keep)


def test_supervised_call_deadline_kill_and_clip():
    gate = threading.Event()
    kills = []
    t0 = time.perf_counter()
    with pytest.raises(supervise.RetriesExhausted) as e:
        supervise.supervised_call(
            gate.wait, deadline_s=0.05, retries=1, backoff_s=0.0,
            jitter=0.0, on_deadline_kill=lambda: kills.append(1))
    assert e.value.attempts == 2 and len(kills) == 2
    assert isinstance(e.value.cause, supervise.DeadlineExceeded)
    # give_up_by clips the attempt's deadline (10 s) to the budget.
    with pytest.raises(supervise.RetriesExhausted):
        supervise.supervised_call(
            gate.wait, deadline_s=10.0, retries=3, backoff_s=0.0,
            jitter=0.0, give_up_by=time.monotonic() + 0.1)
    assert time.perf_counter() - t0 < 5.0
    gate.set()   # unwedge the abandoned threads
    assert supervise.call_with_deadline(lambda: 7, None) == 7
    assert supervise.call_with_deadline(lambda: 7, 5.0) == 7


CLASSIFY_CASES = [
    ValueError("bad shape"), TypeError("x"), KeyError("k"),
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("INVALID_ARGUMENT: bad HLO"),
    jchaos.InjectedFault("x", transient=True),
    chaos.InjectedFault("x", transient=False),
    ConnectionError("reset"), TimeoutError("t"),
    RuntimeError("who knows"), RuntimeError("INTERNAL: device lost"),
    torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("fused_posed launch failed: CUDA error 700 (an illegal "
                 "memory access was encountered)"),
]


@pytest.mark.parametrize("exc", CLASSIFY_CASES,
                         ids=lambda e: type(e).__name__)
def test_classify_failure_matches_jax(exc):
    got = supervise.classify_failure(exc)
    assert got == jsupervise.classify_failure(exc)
    if "CUDA" in str(exc):
        # Out of memory and a CUDA error reproduce on retry (a sticky
        # fault poisons the context): deterministic, engine-fatal.
        assert got == supervise.DETERMINISTIC


def test_deadline_kills_classify_transient_in_both():
    assert supervise.classify_failure(supervise.DeadlineExceeded("d")) \
        == jsupervise.classify_failure(jsupervise.DeadlineExceeded("d")) \
        == supervise.TRANSIENT


def test_watchdog_and_run_python():
    fired = []
    supervise.Watchdog(fired.append, deadline_s=0.05, poll_s=0.02,
                       name="t-wd").start()
    end = time.time() + 5.0
    while not fired and time.time() < end:
        time.sleep(0.02)
    assert fired and "emit-by deadline" in fired[0]
    quiet = []
    wd = supervise.Watchdog(quiet.append, deadline_s=0.05,
                            poll_s=0.02).start()
    wd.disarm()
    time.sleep(0.15)
    assert not quiet
    assert supervise.Watchdog(quiet.append).start()._thread is None
    with pytest.raises(ValueError, match="progress"):
        supervise.Watchdog(lambda c: None, stall_s=1.0)
    stalled = []
    supervise.Watchdog(stalled.append, stall_s=0.05, poll_s=0.02,
                       progress=lambda: 0.0, clock=lambda: 1.0).start()
    end = time.time() + 5.0
    while not stalled and time.time() < end:
        time.sleep(0.02)
    assert stalled and "no progress" in stalled[0]
    ok = supervise.run_python("print('alive')", timeout_s=30.0)
    assert ok.ok and ok.out == "alive" and ok.rc == 0
    hung = supervise.run_python("import time; time.sleep(60)",
                                timeout_s=0.5)
    assert not hung.ok and hung.killed and "killed" in hung.err


def test_device_probe_runs_torch_in_a_subprocess():
    # The two probes run side by side (each imports torch afresh).
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "card", health.device_probe("", timeout_s=120.0)))
    th.start()
    out = supervise.run_python(
        health._PROBE_CODE.format(platform="cpu", index=0), 120.0)
    th.join(timeout=150.0)
    assert out.ok and out.out == "cpu:cpu"
    assert box["card"] == torch.cuda.is_available()
    # The probe checks the card it is given, not always card 0.
    assert "torch.device('cuda', 3)" in health._PROBE_CODE.format(
        platform="", index=3)


# --------------------------------------------------------- circuit breaker
def _breaker_trace(mod, ops):
    """Drive one breaker through ``ops`` on a fake clock; record every
    observable after each step."""
    now = [0.0]
    probe_ok = [False]
    moves = []
    br = mod.CircuitBreaker(
        failure_threshold=2, probe=lambda: probe_ok[0],
        probe_interval_s=1.0, probe_backoff=2.0, probe_interval_cap_s=4.0,
        respect_priority_claim=False, clock=lambda: now[0],
        on_transition=lambda old, new: moves.append((old, new)))
    trace = []
    for op, arg in ops:
        if op == "tick":
            now[0] += arg
            res = None
        elif op == "probe_ok":
            probe_ok[0] = arg
            res = None
        else:
            res = getattr(br, op)()
        trace.append((op, res, br.state, br.probes, br.opens,
                      br.probe_wait_s(), br.consecutive_failed_probes,
                      br.probe_due()))
    return trace, moves


def test_breaker_transitions_and_probe_backoff_match_jax():
    ops = [("allow_primary", None), ("record_failure", None),
           ("allow_primary", None), ("record_failure", None),
           ("allow_primary", None), ("tick", 0.5), ("allow_primary", None),
           ("tick", 1.6), ("allow_primary", None), ("tick", 50.0),
           ("allow_primary", None), ("tick", 50.0), ("allow_primary", None),
           ("probe_ok", True), ("allow_primary", None),
           ("tick", 10.0), ("allow_primary", None),
           ("record_failure", None), ("record_success", None),
           ("record_failure", None), ("record_failure", None),
           ("reset", None), ("allow_primary", None)]
    got = _breaker_trace(health, ops)
    assert got == _breaker_trace(jhealth, ops)
    moves = got[1]
    assert moves[:2] == [("healthy", "degraded"), ("degraded", "down")]
    with pytest.raises(ValueError, match="failure_threshold"):
        health.CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError, match="probe_backoff"):
        health.CircuitBreaker(probe_backoff=0.5)
    with pytest.raises(ValueError, match="probe_interval_cap_s"):
        health.CircuitBreaker(probe_interval_s=10.0, probe_interval_cap_s=1.0)


def test_breaker_stands_down_for_priority_claim(tmp_path, monkeypatch):
    """A recovering engine never probes into an exclusive benchmark's
    window: the port's breaker reads the port's lock files."""
    monkeypatch.setattr(devicelock, "CLAIM_PATH", str(tmp_path / "c"))
    (tmp_path / "c").write_text("{}")
    probes = []
    br = health.CircuitBreaker(
        failure_threshold=1, probe=lambda: probes.append(1) or True,
        probe_interval_s=0.0, respect_priority_claim=True)
    br.record_failure()
    assert not br.probe_due()
    assert not br.allow_primary() and not probes
    (tmp_path / "c").unlink()
    assert br.probe_due()
    assert br.allow_primary() and probes


@pytest.mark.parametrize("failed, n, backlog, down", [
    (0, 4, {1: 30, 2: 0, 3: 10}, {2}), (1, 4, {}, {2}),
    (0, 3, {}, {0, 1, 2}), (2, 5, {0: 3, 1: 3, 3: 1, 4: 3}, set())])
def test_failover_ladder_matches_jax(failed, n, backlog, down):
    def allow(i):
        return i not in down

    assert health.failover_ladder(failed, n, backlog, allow) == \
        jhealth.failover_ladder(failed, n, backlog, allow)


# ------------------------------------------------------------- device lock
# JAX's tests/test_devicelock.py, case for case, on the port copy.
@pytest.fixture
def lock_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(devicelock, "LOCK_PATH", str(tmp_path / "d.lock"))
    monkeypatch.setattr(devicelock, "CLAIM_PATH", str(tmp_path / "d.claim"))


def test_lock_files_are_named_for_the_card():
    assert os.path.basename(devicelock.LOCK_PATH) == "mano_cuda_device.lock"
    assert os.path.basename(devicelock.CLAIM_PATH) == \
        "mano_cuda_device.priority"
    want_dir = os.environ.get("MANO_DEVICE_LOCK_DIR") or tempfile.gettempdir()
    assert os.path.dirname(devicelock.LOCK_PATH) == want_dir


def test_exclusive_writes_and_clears_claim(lock_paths):
    with DeviceLock("exclusive", wait_s=5.0) as lk:
        assert lk._locked and lk.acquired
        assert os.path.exists(devicelock.CLAIM_PATH)
        assert devicelock.priority_claim_active()
    assert not os.path.exists(devicelock.CLAIM_PATH)
    assert not devicelock.priority_claim_active()


def test_retrying_stands_down_on_fresh_claim(lock_paths):
    with DeviceLock("exclusive", wait_s=5.0):
        with pytest.raises(DeviceBusy, match="stands down"):
            DeviceLock("retrying").__enter__()


def test_retrying_stands_down_on_held_lock_without_claim(lock_paths):
    holder = DeviceLock("exclusive", wait_s=5.0)
    holder.__enter__()
    os.remove(devicelock.CLAIM_PATH)  # a claimless holder
    try:
        with pytest.raises(DeviceBusy, match="lock held"):
            DeviceLock("retrying").__enter__()
    finally:
        holder.__exit__()


def test_stale_claim_does_not_block_retrying(lock_paths):
    with open(devicelock.CLAIM_PATH, "w") as f:
        f.write("{}")
    old = time.time() - devicelock.CLAIM_FRESH_S - 10.0
    os.utime(devicelock.CLAIM_PATH, (old, old))
    assert not devicelock.priority_claim_active()
    with DeviceLock("retrying") as lk:
        assert lk._locked


def test_exclusive_proceeds_without_lock_after_timeout(lock_paths):
    holder = DeviceLock("exclusive", wait_s=5.0)
    holder.__enter__()
    try:
        msgs = []
        with DeviceLock("exclusive", wait_s=0.0, log=msgs.append) as lk:
            assert not lk._locked
        assert any("WITHOUT" in m for m in msgs)
    finally:
        holder.__exit__()


def test_wait_deadline_survives_wallclock_jump(lock_paths, monkeypatch):
    holder = DeviceLock("exclusive", wait_s=5.0)
    holder.__enter__()
    real_sleep = time.sleep
    monkeypatch.setattr(time, "sleep", lambda s: real_sleep(0.01))
    t_jumped = time.time() + 1e9
    monkeypatch.setattr(time, "time", lambda: t_jumped)
    try:
        msgs = []
        start = time.monotonic()
        with DeviceLock("exclusive", wait_s=0.6, log=msgs.append) as lk:
            elapsed = time.monotonic() - start
            assert not lk._locked
        assert 0.5 <= elapsed < 5.0
        assert any("WITHOUT" in m for m in msgs)
    finally:
        holder.__exit__()


def test_reacquire_after_release(lock_paths):
    with DeviceLock("exclusive", wait_s=5.0):
        pass
    with DeviceLock("retrying") as lk:
        assert lk._locked


def test_exit_preserves_foreign_claim(lock_paths):
    a = DeviceLock("exclusive", wait_s=5.0)
    a.__enter__()
    with open(devicelock.CLAIM_PATH, "w") as f:
        json.dump({"pid": 999999, "t": 0}, f)   # another benchmark's claim
    a.__exit__()
    assert os.path.exists(devicelock.CLAIM_PATH)
    os.remove(devicelock.CLAIM_PATH)


def test_server_role_shared_coexistence(lock_paths):
    with DeviceLock("server") as a:
        assert a._locked
        with DeviceLock("server") as b:
            assert b._locked
            with pytest.raises(DeviceBusy):
                DeviceLock("retrying").__enter__()


def test_server_stands_down_on_fresh_claim(lock_paths):
    with open(devicelock.CLAIM_PATH, "w") as f:
        f.write("{}")
    with pytest.raises(DeviceBusy, match="server stands down"):
        DeviceLock("server").__enter__()


def test_server_refused_while_exclusive_bench_runs(lock_paths):
    holder = DeviceLock("exclusive", wait_s=5.0)
    holder.__enter__()
    os.remove(devicelock.CLAIM_PATH)  # a claimless exclusive holder
    try:
        with pytest.raises(DeviceBusy, match="held exclusively"):
            DeviceLock("server").__enter__()
    finally:
        holder.__exit__()


def test_server_exit_releases_shared_lock(lock_paths):
    with DeviceLock("server"):
        pass
    with DeviceLock("exclusive", wait_s=5.0) as lk:
        assert lk._locked
    with pytest.raises(ValueError, match="unknown role"):
        DeviceLock("admin")


# ---------------------------------------------------------------- counters
def test_counters_snapshot_atomic_under_concurrent_writers():
    """snapshot() is ONE lock-held copy: the derived mean and the per-tier
    ledgers always agree with the raw integers beside them, while writer
    threads hammer the counters."""
    c = ServingCounters()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            c.count_dispatch(8, 3, requests=2)
            c.count_shed(0)
            c.count_shed(1)
            c.count_expired(1)
            c.count_cancelled(0)
            c.count_tier_submit(0)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(200):
            s = c.snapshot()
            d = s["dispatches"]
            assert s["requests_dispatched"] == 2 * d
            assert s["rows_live"] == 3 * d and s["rows_padded"] == 5 * d
            assert s["coalesce_width_mean"] == (2.0 if d else 0.0)
            tiers = s["tiers"]
            assert s["shed"] == (tiers.get("0", {}).get("shed", 0)
                                 + tiers.get("1", {}).get("shed", 0))
            assert s["expired"] == tiers.get("1", {}).get("expired", 0)
            assert s["cancelled"] == tiers.get("0", {}).get("cancelled", 0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    for k in ("retries", "faults_injected", "failovers", "deadline_kills",
              "shed", "expired", "cancelled", "backlog_peak",
              "coalesce_overflows", "queue_depth_peak"):
        assert k in s
