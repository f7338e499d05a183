"""The serving engine's drills: fault recovery and overload.

Port copies of the JAX package's ``serving/measure.py:recovery_drill_run``
and ``overload_drill_run`` — the same arguments, protocol and returned
keys, less the tracer's flight record. Both drive a real
``ServingEngine`` on ``device`` (default ``cuda``; the CPU tests pass
``"cpu"``) and inject their faults in-process through ``runtime.chaos``,
so no device is harmed. The recovery drill serves its pose-only half
through ``posed_kernel``; the overload drill, as JAX's, submits full
requests only.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch


def _logger(log: Optional[Callable[[str], None]]):
    return log if log is not None else (lambda msg: None)


def overload_drill_run(
    params,
    *,
    saturation: float = 4.0,
    bursts: int = 40,
    burst_interval_s: float = 0.01,
    tier0_fraction: float = 0.125,
    max_queued: int = 40,
    tier1_quota: int = 14,
    deadline_s: float = 0.4,
    sat_latency_s: float = 0.02,
    max_bucket: int = 8,
    batch_deadline_s: float = 0.5,
    shed_probe_submits: int = 256,
    seed: int = 0,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """The overload/saturation drill: a sustained arrival rate ABOVE the
    device's service rate.

    The device half is simulated with a chaos saturation plan
    (``sat:T@0-`` throttles every dispatch, capping the service rate:
    the drill measures admission and shedding against that throttle, not
    the device's own rate, and serves one-row full requests through the
    plain family at ``max_bucket``); the arrival half is a burst submitter (every ``burst_interval_s``, a burst
    sized to ``saturation`` x the service rate MEASURED in-protocol, so
    "4x" means 4x this machine today). Two priority tiers ride the
    stream: tier 0 (interactive, ``tier0_fraction`` of arrivals — under
    capacity on its own) and tier 1 (batch), against a bounded engine
    (``max_queued`` total, ``tier1_quota`` for tier 1) with a per-request
    ``deadline_s``.

    The returned criteria:

    * ``resolved_within_budget_fraction`` == 1.0 — EVERY submitted future
      resolves inside its budget (``deadline_s`` plus one supervised-batch
      window) as result, shed or expired;
    * ``tier0_goodput`` >= 0.95 at >= 4x achieved saturation — the quota
      headroom protects interactive traffic while tier 1 absorbs the
      shedding;
    * ``shed_probe.dispatches`` == 0 — a shed is admission bookkeeping:
      the probe engine (``max_queued=0``) sheds every submit without
      starting its dispatcher; the per-decision wall time is recorded in
      µs. ``params_device_put`` says whether the probe's params sit on a
      device other than the host (the port's constructor places them);
    * ``steady_recompiles`` == 0 — overload builds nothing new.
    """
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    if saturation <= 0:
        raise ValueError(f"saturation must be > 0, got {saturation}")
    if bursts < 1:
        raise ValueError(f"bursts must be >= 1, got {bursts}")
    if not 0.0 < tier0_fraction < 1.0:
        raise ValueError(
            f"tier0_fraction must be in (0, 1), got {tier0_fraction}")
    if max_queued < 1:
        raise ValueError(
            f"max_queued={max_queued} admits nothing — the drill needs "
            "at least one admitted request to calibrate (the shed-only "
            "path is the probe's job)")
    log = _logger(log)
    n_joints = params.n_joints
    rng = np.random.default_rng(seed)

    def one_pose():
        return rng.normal(
            scale=0.4, size=(1, n_joints, 3)).astype(np.float32)

    # ---- Phase A: the shed probe (no dispatcher, no dispatch) ----------
    probe = ServingEngine(params, device=device, max_bucket=max_bucket,
                          max_queued=0)
    probe_pose = one_pose()
    shed_us: List[float] = []
    for _ in range(max(1, shed_probe_submits)):
        t0 = time.perf_counter()
        try:
            probe.submit(probe_pose, deadline_s=deadline_s)
            raise RuntimeError("shed probe submit was admitted at "
                               "max_queued=0")
        except ServingError as e:
            if e.kind != "shed":
                raise
        shed_us.append((time.perf_counter() - t0) * 1e6)
    shed_probe = {
        "sheds": len(shed_us),
        "dispatches": probe.counters.dispatches,
        "engine_started": probe._thread is not None,
        "params_device_put": probe._params.device.type != "cpu",
        "decision_p50_us": float(f"{np.percentile(shed_us, 50):.4g}"),
        "decision_p99_us": float(f"{np.percentile(shed_us, 99):.4g}"),
    }
    log(f"overload: shed probe {shed_probe['sheds']} sheds, "
        f"{shed_probe['dispatches']} dispatches, p50 "
        f"{shed_probe['decision_p50_us']:.1f} µs")

    # ---- Phase B: the saturated engine --------------------------------
    plan = ChaosPlan(f"sat:{sat_latency_s}@0-")
    policy = DispatchPolicy(
        deadline_s=batch_deadline_s, retries=0, backoff_s=0.0,
        backoff_cap_s=0.0, jitter=0.0, breaker=None, chaos=plan,
        # The CPU tier would bypass the throttle and quietly raise the
        # capacity mid-drill; overload is not a fault.
        cpu_fallback=False,
    )
    eng = ServingEngine(
        params, device=device, max_bucket=max_bucket, max_delay_s=0.001,
        policy=policy, max_queued=max_queued, tier_quotas={1: tier1_quota})

    outcomes = {"ok": 0, "shed": 0, "expired": 0, "error": 0,
                "unresolved": 0}
    by_tier = {0: dict(outcomes), 1: dict(outcomes)}
    records: List[tuple] = []   # (tier, t_submit, future|None, done_box)
    load_mid = None

    with eng:
        eng.warmup()
        # Calibrate THIS machine's saturated service rate: waves under the
        # tier-0 quota (so calibration never sheds), submitted then
        # drained three times, through the throttle and the coalescing.
        wave = min(max(max_bucket, min(max_queued // 2, 3 * max_bucket)),
                   max_queued)
        served = 0
        t0 = time.perf_counter()
        for _ in range(3):
            futs = [eng.submit(one_pose()) for _ in range(wave)]
            for f in futs:
                f.result()
            served += wave
        service_rate = served / (time.perf_counter() - t0)
        compiles_warm = eng.counters.compiles
        offered_rate = saturation * service_rate
        burst_n = max(1, int(round(offered_rate * burst_interval_s)))
        budget_s = deadline_s + batch_deadline_s + 0.25
        log(f"overload: service rate {service_rate:,.0f} req/s "
            f"(sat throttle {sat_latency_s}s), offering "
            f"{offered_rate:,.0f} req/s = {burst_n}/burst x "
            f"{bursts} bursts")

        t_stream0 = time.monotonic()
        next_t = t_stream0
        for b in range(bursts):
            for _ in range(burst_n):
                tier = 0 if rng.random() < tier0_fraction else 1
                t_sub = time.monotonic()
                done_box: List[float] = []
                try:
                    fut = eng.submit(one_pose(), priority=tier,
                                     deadline_s=deadline_s)
                except ServingError as e:
                    if e.kind != "shed":
                        raise
                    records.append((tier, t_sub, None, done_box))
                    continue
                fut.add_done_callback(
                    lambda f, box=done_box: box.append(time.monotonic()))
                records.append((tier, t_sub, fut, done_box))
            if b == bursts // 2:
                load_mid = eng.load()
            next_t += burst_interval_s
            lag = next_t - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            # Behind schedule: the next burst goes at once — a slow
            # submitter compresses bursts, never lowers the offered rate.
        t_stream1 = time.monotonic()

        # Every future must be DONE within its budget; the wait has a
        # grace window past the last budget so a straggler is recorded as
        # unresolved, not crashed into.
        wait_end = t_stream1 + budget_s + 10.0
        for tier, t_sub, fut, done_box in records:
            if fut is None:
                continue
            try:
                fut.result(timeout=max(0.0, wait_end - time.monotonic()))
            except Exception:   # noqa: BLE001 — classified below
                pass
        steady_recompiles = eng.counters.compiles - compiles_warm
        snap = eng.counters.snapshot()

    # concurrent.futures wakes result() waiters BEFORE it runs the done
    # callbacks, so a future can be done() a moment before its timestamp
    # lands: a short drain keeps such a future from reading unresolved.
    drain_end = time.monotonic() + 1.0
    for _, _, fut, done_box in records:
        while (fut is not None and fut.done() and not done_box
               and time.monotonic() < drain_end):
            time.sleep(0.001)
    in_budget = 0
    resolve_lat: List[float] = []
    for tier, t_sub, fut, done_box in records:
        if fut is None:
            outcome = "shed"        # resolved AT submit: latency ~0
            in_budget += 1
        elif not fut.done() or not done_box:
            outcome = "unresolved"
        else:
            lat = done_box[0] - t_sub
            resolve_lat.append(lat)
            if lat <= budget_s:
                in_budget += 1
            exc = fut.exception()
            if exc is None:
                outcome = "ok"
            elif isinstance(exc, ServingError) and exc.kind == "expired":
                outcome = "expired"
            elif isinstance(exc, ServingError) and exc.kind == "shed":
                outcome = "shed"
            else:
                outcome = "error"
        outcomes[outcome] += 1
        by_tier[tier][outcome] += 1

    submitted = len(records)
    stream_s = max(t_stream1 - t_stream0, 1e-9)
    achieved = (submitted / stream_s) / service_rate if service_rate else 0.0
    t0_total = sum(by_tier[0].values())
    tier0_goodput = by_tier[0]["ok"] / t0_total if t0_total else None
    log(f"overload: {submitted} submitted at {achieved:.2f}x achieved "
        f"saturation -> {outcomes['ok']} ok / {outcomes['shed']} shed / "
        f"{outcomes['expired']} expired / {outcomes['unresolved']} "
        f"unresolved; tier-0 goodput {tier0_goodput}")
    return {
        "saturation_target": float(saturation),
        "saturation_achieved": float(f"{achieved:.4g}"),
        "service_rate_req_per_s": float(f"{service_rate:.5g}"),
        "offered_rate_req_per_s": float(f"{offered_rate:.5g}"),
        "bursts": int(bursts),
        "burst_requests": int(burst_n),
        "burst_interval_s": burst_interval_s,
        "deadline_s": deadline_s,
        "budget_s": float(f"{budget_s:.4g}"),
        "tier0_fraction": tier0_fraction,
        "max_queued": int(max_queued),
        "tier1_quota": int(tier1_quota),
        "sat_latency_s": sat_latency_s,
        "submitted": submitted,
        "outcomes": outcomes,
        "by_tier": {str(t): c for t, c in by_tier.items()},
        "tier0_goodput": (None if tier0_goodput is None
                          else float(f"{tier0_goodput:.6g}")),
        "resolved_within_budget_fraction": float(
            f"{in_budget / submitted if submitted else 0.0:.6g}"),
        "resolve_p99_s": (float(f"{np.percentile(resolve_lat, 99):.4g}")
                          if resolve_lat else None),
        "shed_probe": shed_probe,
        "steady_recompiles": int(steady_recompiles),
        "backlog_peak": snap["backlog_peak"],
        "shed": snap["shed"],
        "expired": snap["expired"],
        "dispatches": snap["dispatches"],
        "coalesce_width_mean": snap["coalesce_width_mean"],
        "tiers": snap["tiers"],
        "load_mid_drill": load_mid,
    }


def recovery_drill_run(
    params,
    *,
    requests_per_class: int = 12,
    max_rows: int = 5,
    max_bucket: int = 8,
    deadline_s: float = 2.0,
    latency_spike_s: float = 0.05,
    seed: int = 0,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """The fault-recovery drill.

    One supervised ``ServingEngine`` (``DispatchPolicy``: per-batch
    deadline, 1 retry, a circuit breaker with a drill-controlled probe,
    and the CPU tier where ``device`` is the CPU) is driven through every failure class by a rescheduled
    ``ChaosPlan`` — transient error, latency spike, hang, persistent
    outage — then through recovery. Half of every stream is pose-only
    requests across three subjects, so gathered mixed-subject batches are
    in flight under every fault. The criteria:

    * ``futures_resolved_fraction`` == 1.0: every submitted future
      resolved (result or structured ServingError) under every fault;
    * ``failover_vs_cpu_direct_max_abs_err`` == 0.0, and
      ``failover_posed_vs_cpu_direct_max_abs_err`` == 0.0 for a pose-only
      request: failover results are bit for bit a direct CPU
      ``core.forward_batched`` call at the same padded bucket (a pose-only
      batch fails over through the full forward with per-row betas). A
      card engine has no CPU tier: there the persistent outage resolves
      every request to its ``ServingError``, nothing fails over, and
      these keys and the failover timings read None;
    * ``post_recovery_steady_recompiles`` == 0: after the fault clears
      and the breaker re-closes, the primary path serves again and builds
      nothing.

    ``failover_overhead_ratio`` (failover vs healthy seconds per request,
    one pass each) says what degraded mode costs.
    """
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.health import CircuitBreaker
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving import buckets as bucket_mod
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    log = _logger(log)
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    subj_betas = [rng.normal(size=(n_shape,)).astype(np.float32)
                  for _ in range(3)]
    subj_keys: list = []

    def make_stream(n):
        """Half full-path, half pose-only across the baked subjects, as
        (pose, shape, subject) submit triples."""
        sizes = rng.integers(1, max_rows + 1, size=n)
        out = []
        for i, s in enumerate(sizes):
            pose = rng.normal(
                scale=0.4, size=(int(s), n_joints, 3)).astype(np.float32)
            if subj_keys and i % 2 == 1:
                out.append((pose, None, subj_keys[i % len(subj_keys)]))
            else:
                out.append((pose, rng.normal(
                    size=(int(s), n_shape)).astype(np.float32), None))
        return out

    cpu_tier = resolve_device(device).type == "cpu"
    device_ok = [True]           # the drill's hand on the simulated device
    plan = ChaosPlan()
    breaker = CircuitBreaker(
        failure_threshold=2,
        probe=lambda: device_ok[0],
        probe_interval_s=0.0,           # the drill wants instant re-probes
        respect_priority_claim=False,   # the simulated device needs no lock
    )
    policy = DispatchPolicy(
        deadline_s=deadline_s, retries=1, backoff_s=0.01,
        backoff_cap_s=0.02, jitter=0.0, breaker=breaker, chaos=plan,
        cpu_fallback=cpu_tier,
    )
    params32 = params.astype(torch.float32)
    eng = ServingEngine(params32, device=device, max_bucket=max_bucket,
                        max_delay_s=0.001, policy=policy,
                        posed_kernel=posed_kernel)
    resolve_timeout = deadline_s * (policy.retries + 2) + 30.0

    # The bit-identity reference: a direct CPU core.forward_batched call
    # at the padded bucket the engine dispatches.
    prm_cpu = params32.to("cpu")

    def cpu_direct(p, s):
        n = p.shape[0]
        b = bucket_mod.bucket_for(n, eng.buckets)
        pose, shape = (torch.from_numpy(np.array(
            bucket_mod.pad_rows(x, b), np.float32, order="C"))
            for x in (p, s))
        with torch.no_grad():
            verts = core.forward_batched(prm_cpu, pose, shape).verts
        return verts.numpy()[:n]

    def run_pass(stream):
        t0 = time.perf_counter()
        futs = [eng.submit(p, s, subject=k) for p, s, k in stream]
        ok = err = unresolved = 0
        for f in futs:
            try:
                f.result(timeout=resolve_timeout)
                ok += 1
            except ServingError:
                err += 1
            except Exception:       # noqa: BLE001 — a timeout IS the bug
                unresolved += 1
        return ok, err, unresolved, time.perf_counter() - t0

    before = {}

    def delta():
        out = {k: getattr(eng.counters, k) - before.get(k, 0)
               for k in ("retries", "faults_injected", "deadline_kills",
                         "failovers")}
        for k in out:
            before[k] = getattr(eng.counters, k)
        return out

    classes = {}
    try:
        with eng:
            eng.warmup()
            subj_keys.extend(eng.specialize(b) for b in subj_betas)
            eng.warmup_posed()
            warm_compiles = eng.counters.compiles
            # Healthy baseline for the failover-overhead ratio.
            healthy = make_stream(requests_per_class)
            ok, err, un, t_healthy = run_pass(healthy)
            delta()   # zero the counter cursor
            healthy_per_req = t_healthy / max(1, len(healthy))
            log(f"recovery drill: healthy baseline "
                f"{healthy_per_req * 1e3:.2f} ms/request")

            specs = [
                ("transient", "error@0,error@3", True),
                ("latency", f"latency:{latency_spike_s}@0-2", True),
                ("hang", "hang@0", True),
                ("persistent", "error@0-", False),
            ]
            t_failover = None
            failover_err = None
            failover_posed_err = None
            for name, spec, device_up in specs:
                breaker.reset()
                device_ok[0] = device_up
                plan.schedule(spec)
                stream = make_stream(requests_per_class)
                ok, err, un, dt = run_pass(stream)
                d = delta()
                classes[name] = {
                    "submitted": len(stream),
                    "resolved_ok": ok,
                    "resolved_error": err,
                    "unresolved": un,
                    **d,
                }
                if name == "persistent":
                    # A SECOND pass, still under the fault, times steady
                    # degraded serving (the first one opened the breaker).
                    stream2 = make_stream(requests_per_class)
                    ok2, err2, un2, dt2 = run_pass(stream2)
                    for k, v in (("submitted", len(stream2)),
                                 ("resolved_ok", ok2),
                                 ("resolved_error", err2),
                                 ("unresolved", un2)):
                        classes[name][k] += v
                if name == "persistent" and cpu_tier:
                    t_failover = dt2 / max(1, len(stream2))
                    # Failover parity probes against the direct CPU call:
                    # one full request, one POSE-ONLY request (its
                    # failover runs the full forward on per-row betas).
                    p, s, _ = make_stream(1)[0]
                    got = eng.forward(p, s)
                    failover_err = float(
                        np.abs(got - cpu_direct(p, s)).max())
                    p2 = rng.normal(scale=0.4, size=(2, n_joints, 3),
                                    ).astype(np.float32)
                    got2 = eng.forward(p2, subject=subj_keys[0])
                    failover_posed_err = float(np.abs(
                        got2 - cpu_direct(p2, np.broadcast_to(
                            subj_betas[0][None], (2, n_shape)))).max())
                if name == "persistent":
                    for k, v in delta().items():
                        classes[name][k] += v
                plan.clear()
                device_ok[0] = True
                log(f"recovery drill [{name}]: {ok} ok / {err} err / "
                    f"{un} unresolved over {len(stream)} requests ({d})")

            # Recovery: the fault cleared, the probe green. The breaker is
            # still DOWN from the persistent class — the first dispatch
            # re-probes, closes it and fails back to the primary path.
            run_pass(make_stream(requests_per_class))      # settle
            compiles_settled = eng.counters.compiles
            ok, err, un, t_rec = run_pass(make_stream(requests_per_class))
            steady = eng.counters.compiles - compiles_settled
            delta()
            snap = eng.counters.snapshot()
    finally:
        plan.release.set()   # free any abandoned hung worker threads

    # The coalesce telemetry must survive the failover/recovery cycle.
    for k in ("mixed_subject_batches", "coalesce_width_mean",
              "coalesce_overflows", "specializations_evicted",
              "requests_dispatched"):
        if k not in snap:
            raise RuntimeError(
                f"coalesce telemetry {k!r} missing from the counters "
                "snapshot after the drill")

    total_submitted = sum(c["submitted"] for c in classes.values())
    total_unresolved = sum(c["unresolved"] for c in classes.values())
    resolved_fraction = (
        1.0 - total_unresolved / total_submitted if total_submitted else 0.0)
    ratio = (t_failover / healthy_per_req
             if t_failover and healthy_per_req else None)
    return {
        "deadline_s": deadline_s,
        "requests_per_class": requests_per_class,
        "classes": classes,
        "futures_resolved_fraction": float(f"{resolved_fraction:.6g}"),
        "failover_vs_cpu_direct_max_abs_err": failover_err,
        "failover_posed_vs_cpu_direct_max_abs_err": failover_posed_err,
        "mixed_subject_batches": snap["mixed_subject_batches"],
        "coalesce_width_mean": snap["coalesce_width_mean"],
        "failover_overhead_ratio": (float(f"{ratio:.4g}")
                                    if ratio is not None else None),
        "healthy_s_per_request": float(f"{healthy_per_req:.5g}"),
        "failover_s_per_request": (float(f"{t_failover:.5g}")
                                   if t_failover is not None else None),
        "post_recovery_steady_recompiles": int(steady),
        "post_recovery_ok": ok,
        "warmup_compiles": int(warm_compiles),
        "breaker_opens": breaker.opens,
        "breaker_probes": breaker.probes,
        "breaker_state_final": breaker.state,
    }
