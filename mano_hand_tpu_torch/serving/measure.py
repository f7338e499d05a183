"""The serving engine's drills, benchmark protocols and observability
protocols.

Port copies of the JAX package's ``serving/measure.py:recovery_drill_run``,
``overload_drill_run``, ``cold_start_drill_run``, ``tracing_overhead_run``,
``metrics_overhead_run``, ``stream_drill_run``,
``dispatch_pipeline_drill_run``, ``lane_drill_run``,
``subject_store_drill_run``, the benchmark protocols ``measure_overhead``,
``serve_bench_run``, ``coalesce_bench_run``, ``posed_kernel_bench_run``
and ``precision_bench_run``, the loopback ``edge_drill_run``, and the
fleet's ``fleet_drill_run`` and ``selfheal_drill_run`` (worker and proxy
processes on ``device``, driven over loopback sockets), and the
closed-loop ``control_drill_run`` — the
same arguments, protocol and returned keys (each drill attaches its
tracer's ``flight_record``), plus ``device=`` and ``posed_kernel=``
(JAX's ``interpret=`` goes: a CPU engine runs K2's plain version, a card
engine K2). Each drives real ``ServingEngine``s on ``device`` (default
``cuda``; the CPU tests pass ``"cpu"``) and injects its faults in-process
through ``runtime.chaos``, so no device is harmed. The recovery drill
serves its pose-only half through ``posed_kernel``; the overload drill,
as JAX's, submits full requests only.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.obs import Tracer, flight_record


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
    tracer=None,
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

    One tracer (``tracer``, else a fresh one) spans both engines, so the
    ``flight_record``'s accounting covers every submit of the drill, and
    a sustained shed run fires its ``shed_burst`` incident.
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
    if tracer is None:
        tracer = Tracer()
    n_joints = params.n_joints
    rng = np.random.default_rng(seed)

    def one_pose():
        return rng.normal(
            scale=0.4, size=(1, n_joints, 3)).astype(np.float32)

    # ---- Phase A: the shed probe (no dispatcher, no dispatch) ----------
    probe = ServingEngine(params, device=device, max_bucket=max_bucket,
                          max_queued=0, tracer=tracer)
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
        policy=policy, max_queued=max_queued, tier_quotas={1: tier1_quota},
        tracer=tracer)

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
        "flight_record": flight_record(
            tracer, eng.counters, reason="overload_drill_complete"),
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
    tracer=None,
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
    one pass each) says what degraded mode costs. The ``flight_record``
    carries every fault class's spans, the breaker transitions and the
    chaos faults (``tracer``, else a fresh one).
    """
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.health import CircuitBreaker
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving import buckets as bucket_mod
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    log = _logger(log)
    if tracer is None:
        tracer = Tracer()
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
    # The serial dispatch: the fault schedules count primary attempts in
    # call order, which concurrent completion workers would interleave
    # (a transient fault could land on another batch's retry).
    eng = ServingEngine(params32, device=device, max_bucket=max_bucket,
                        max_delay_s=0.001, policy=policy,
                        posed_kernel=posed_kernel, tracer=tracer,
                        inflight_depth=1)
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
        "flight_record": flight_record(
            tracer, eng.counters, reason="recovery_drill_complete"),
    }


def cold_start_drill_run(
    params,
    *,
    subjects: int = 6,
    requests: int = 48,
    max_rows: int = 4,
    max_bucket: int = 8,
    max_subjects: int = 8,
    aot_dir=None,
    p99_waves: int = 6,
    hang_deadline_s: float = 2.0,
    seed: int = 0,
    tracer=None,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """The cold-start / restart drill: restart is a fault class with
    measured criteria. JAX's protocol (``serving/measure.py:
    cold_start_drill_run``), its arguments and returned keys, on
    ``device`` (default ``cuda``). One tracer (``tracer``, else a fresh
    one) spans every engine of the drill, so the ``flight_record`` proves
    every submit across every restart closed exactly once, and the
    lattice loads, failed loads, live builds (``compile``) and deadline
    kills land on one timeline.

    * **Phase A (the doomed process)**: a warm engine — ``subjects``
      baked, every bucket warmed — bakes its lattice, checkpoints its
      subject table, then is stopped with a burst of work in flight:
      every outstanding future must still resolve.
    * **Phase B (the cold start)**: a fresh engine on the same artifacts
      restores the checkpoint and warms every program, measuring seconds
      from its construction to the restore, the warm-up, the FIRST served
      result and a stable p99 (wave p99s within 1.5x of the settled one).
      Criteria: ``compiles_after_restore`` == 0 with ``aot_loads`` == the
      reachable program count, and a restored subject's results bit for
      bit a freshly baked one's.
    * **Phase C (damage)**: a truncated lattice entry, a schema-bumped
      manifest, a digest-mismatched manifest and a half-written
      checkpoint each boot a fresh engine that must degrade to counted
      live builds / re-specializations while resolving its whole stream.
    * **Phase D (chaos composes)**: the boot runs supervised under a
      ``hang`` fault on its first dispatch; the deadline kill must clear
      it and the retry serve. A CPU engine bakes and loads its CPU tier
      too; a card engine has none (its exhausted batch would resolve to a
      ``ServingError``, never to a CPU run).

    Restarts are simulated in-process (a fresh engine has cold program
    caches).
    """
    import json
    import shutil
    import tempfile
    import warnings
    from pathlib import Path

    from mano_hand_tpu_torch.io.export_aot import LATTICE_MANIFEST
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving import buckets as bucket_mod
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    if subjects < 1:
        raise ValueError(f"subjects must be >= 1, got {subjects}")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    log = _logger(log)
    if tracer is None:
        tracer = Tracer()
    dev = resolve_device(device)
    cpu_tier = dev.type == "cpu"
    max_rows = min(max_rows, max_bucket)
    n_joints, n_shape = params.n_joints, params.n_shape
    params32 = params.astype(torch.float32).to(dev)
    rng = np.random.default_rng(seed)
    betas = [rng.normal(size=(n_shape,)).astype(np.float32)
             for _ in range(subjects)]

    tmp_root = None
    if aot_dir is None:
        tmp_root = tempfile.mkdtemp(prefix="mano_coldstart_")
        aot_dir = Path(tmp_root)
    else:
        # The drill owns a subdirectory: a production lattice in aot_dir
        # proper never shares a manifest with drill artifacts.
        aot_dir = Path(aot_dir) / "coldstart_drill"
        aot_dir.mkdir(parents=True, exist_ok=True)
    ckpt = aot_dir / "subjects_ckpt"

    def make_stream(n, keys):
        """Half full-path, half pose-only across the baked subjects, as
        (pose, shape, subject) submit triples."""
        sizes = rng.integers(1, max_rows + 1, size=n)
        out = []
        for i, s in enumerate(sizes):
            pose = rng.normal(
                scale=0.4, size=(int(s), n_joints, 3)).astype(np.float32)
            if keys and i % 2 == 1:
                out.append((pose, None, keys[i % len(keys)]))
            else:
                out.append((pose, rng.normal(
                    size=(int(s), n_shape)).astype(np.float32), None))
        return out

    def run_stream(eng, stream, timeout_s=60.0):
        """(resolved_ok, resolved_error, unresolved, wall_s)."""
        t0 = time.perf_counter()
        futs = [eng.submit(p, s, subject=k) for p, s, k in stream]
        ok = err = un = 0
        for f in futs:
            try:
                f.result(timeout=timeout_s)
                ok += 1
            except ServingError:
                err += 1
            except Exception:   # noqa: BLE001 — a timeout IS the bug
                un += 1
        return ok, err, un, time.perf_counter() - t0

    engine_kw = dict(device=dev, max_bucket=max_bucket, max_delay_s=0.001,
                     max_subjects=max_subjects, tracer=tracer)

    # ---- Phase A: the doomed process -----------------------------------
    eng_a = ServingEngine(params32, aot_dir=aot_dir, **engine_kw)
    probe_pose = rng.normal(
        scale=0.4, size=(2, n_joints, 3)).astype(np.float32)
    with eng_a:
        keys = [eng_a.specialize(b) for b in betas]
        eng_a.warmup()
        eng_a.warmup_posed()
        manifest = eng_a.bake_lattice(include_cpu_fallback=cpu_tier)
        ok_a, err_a, un_a, _ = run_stream(eng_a, make_stream(requests, keys))
        want_posed = [np.asarray(eng_a.forward(probe_pose, subject=k))
                      for k in keys[:min(3, len(keys))]]
        eng_a.checkpoint_subjects(ckpt)
        kill_futs = [eng_a.submit(p, s, subject=k)
                     for p, s, k in make_stream(min(requests, 16), keys)]
    killed_resolved = sum(f.done() for f in kill_futs)
    baked_compiles = eng_a.counters.compiles
    log(f"cold-start A: {len(manifest['entries'])} lattice entries baked, "
        f"checkpoint written, stopped with {killed_resolved}/"
        f"{len(kill_futs)} in-flight futures resolved")

    # ---- Phase B: the cold start ----------------------------------------
    eng_b = ServingEngine(params32, aot_dir=aot_dir, **engine_kw)
    t0 = time.perf_counter()
    with eng_b:
        restore = eng_b.restore_subjects(ckpt)
        t_restore = time.perf_counter() - t0
        warm_full = eng_b.warmup()
        warm_posed = eng_b.warmup_posed()
        t_warm = time.perf_counter() - t0
        eng_b.forward(probe_pose, subject=keys[0])
        t_first = time.perf_counter() - t0
        restored_err = 0.0
        for k, want in zip(keys, want_posed):
            got = np.asarray(eng_b.forward(probe_pose, subject=k))
            restored_err = max(restored_err, float(np.abs(got - want).max()))
        # A freshly baked subject through the per-subject posed forward at
        # the same padded size: the gather contract, across a restart.
        b = bucket_mod.bucket_for(probe_pose.shape[0], eng_b.buckets)
        with torch.no_grad():
            fresh = core.specialize(params32, torch.from_numpy(betas[0]).to(dev))
            fresh_out = core.forward_posed_batched(fresh, torch.from_numpy(
                bucket_mod.pad_rows(probe_pose, b)).to(dev)).verts
        fresh_out = fresh_out.cpu().numpy()[:probe_pose.shape[0]]
        got0 = np.asarray(eng_b.forward(probe_pose, subject=keys[0]))
        restored_vs_fresh = float(np.abs(got0 - fresh_out).max())
        wave_p99, wave_t = [], []
        for _ in range(max(1, p99_waves)):
            stream = make_stream(requests, keys)
            futs = [(eng_b.submit(p, s, subject=k), time.perf_counter())
                    for p, s, k in stream]
            lats = []
            for f, t_sub in futs:
                f.result(timeout=60.0)
                lats.append(time.perf_counter() - t_sub)
            wave_p99.append(float(np.percentile(lats, 99)))
            wave_t.append(time.perf_counter() - t0)
        settled = float(np.median(wave_p99[-min(3, len(wave_p99)):]))
        t_p99 = wave_t[-1]
        for i in range(len(wave_p99)):
            if all(w <= 1.5 * settled for w in wave_p99[i:]):
                t_p99 = wave_t[i]
                break
        compiles_after_restore = eng_b.counters.compiles
        aot_loads = eng_b.counters.aot_loads
        snap_b = eng_b.counters.snapshot()
    expected_programs = 2 * len(eng_b.buckets)
    log(f"cold-start B: restore {restore}, first result at "
        f"{t_first * 1e3:.0f} ms, p99 stable at {t_p99 * 1e3:.0f} ms "
        f"({compiles_after_restore} compiles, {aot_loads}/"
        f"{expected_programs} programs from the lattice, restored-vs-fresh "
        f"err {restored_vs_fresh:.1e})")

    # ---- Phase C: damage -------------------------------------------------
    injections = {}

    def injection_leg(name: str, damage):
        """Copy the artifacts, apply ``damage(dir)``, cold-boot against
        them: the whole stream resolves, the damage degraded to counted
        live builds / re-specializations."""
        leg_dir = aot_dir.parent / f"{aot_dir.name}_{name}"
        if leg_dir.exists():
            shutil.rmtree(leg_dir)
        shutil.copytree(aot_dir, leg_dir)
        damage(leg_dir)
        eng = ServingEngine(params32, aot_dir=leg_dir, **engine_kw)
        with eng, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rs = eng.restore_subjects(leg_dir / "subjects_ckpt")
            eng.warmup()
            leg_keys = [eng.specialize(b) for b in betas]
            eng.warmup_posed()
            ok, err, un, _ = run_stream(eng, make_stream(requests, leg_keys))
        injections[name] = {
            "submitted": requests,
            "resolved_ok": ok,
            "resolved_error": err,
            "unresolved": un,
            "futures_resolved_fraction": 1.0 - un / requests,
            "aot_load_failures": eng.counters.aot_load_failures,
            "recompiles": eng.counters.compiles,
            "aot_loads": eng.counters.aot_loads,
            "subjects_restored": eng.counters.subjects_restored,
            "restore": rs,
        }
        shutil.rmtree(leg_dir, ignore_errors=True)
        i = injections[name]
        log(f"cold-start C [{name}]: {i['aot_load_failures']} load failures "
            f"-> {i['recompiles']} recompiles, {i['resolved_ok']}/"
            f"{i['submitted']} ok, {i['unresolved']} unresolved")

    def truncate_entry(d):
        # Keyed off the engine's REAL bucket ladder (a non-power-of-two
        # max_bucket rounds up). The legacy artifacts go too: this leg
        # pins the whole chain (lattice -> legacy -> live build).
        ent = manifest["entries"][f"full/b{eng_b.buckets[-1]}"]
        f = d / ent["file"]
        f.write_bytes(f.read_bytes()[:64])
        for legacy in d.glob("serve_*.torchexp"):
            legacy.unlink()

    def bump_schema(d):
        man = json.loads((d / LATTICE_MANIFEST).read_text())
        man["schema"] = man["schema"] + 1
        (d / LATTICE_MANIFEST).write_text(json.dumps(man))

    def mismatch_digest(d):
        man = json.loads((d / LATTICE_MANIFEST).read_text())
        man["params_digest"] = "0" * len(man["params_digest"])
        (d / LATTICE_MANIFEST).write_text(json.dumps(man))

    def damage_ckpt(d):
        # Killed mid-checkpoint: the meta lands last, so cut it in half.
        meta = d / "subjects_ckpt" / "state_meta.json"
        meta.write_text(meta.read_text()[: max(1, meta.stat().st_size // 2)])

    injection_leg("truncated_entry", truncate_entry)
    injection_leg("schema_bump", bump_schema)
    injection_leg("digest_mismatch", mismatch_digest)
    injection_leg("damaged_checkpoint", damage_ckpt)

    # ---- Phase D: restore under a hang fault ----------------------------
    plan = ChaosPlan("hang@0")
    policy = DispatchPolicy(
        deadline_s=hang_deadline_s, retries=1, backoff_s=0.01,
        backoff_cap_s=0.02, jitter=0.0, breaker=None, chaos=plan,
        cpu_fallback=cpu_tier)
    eng_d = ServingEngine(params32, aot_dir=aot_dir, policy=policy,
                          **engine_kw)
    try:
        with eng_d:
            rs_d = eng_d.restore_subjects(ckpt)
            eng_d.warmup()          # the primary (and a CPU engine's tier)
            eng_d.warmup_posed()    # the gathered family (restored capacity)
            hang_stream = make_stream(min(requests, 12), keys)
            ok_d, err_d, un_d, _ = run_stream(
                eng_d, hang_stream, timeout_s=hang_deadline_s * 4 + 30.0)
    finally:
        plan.release.set()   # free the abandoned hung worker thread
    hang_leg = {
        "submitted": len(hang_stream),
        "resolved_ok": ok_d,
        "resolved_error": err_d,
        "unresolved": un_d,
        "futures_resolved_fraction": 1.0 - un_d / len(hang_stream),
        "deadline_kills": eng_d.counters.deadline_kills,
        "compiles_after_restore": eng_d.counters.compiles,
        "aot_loads": eng_d.counters.aot_loads,
        "expected_programs": (3 if cpu_tier else 2) * len(eng_d.buckets),
        "subjects_restored": eng_d.counters.subjects_restored,
        "restore": rs_d,
    }
    log(f"cold-start D [hang]: {hang_leg['deadline_kills']} deadline "
        f"kill(s), {ok_d}/{len(hang_stream)} ok, {hang_leg['aot_loads']}/"
        f"{hang_leg['expected_programs']} programs from the lattice, "
        f"{hang_leg['compiles_after_restore']} compiles")

    if tmp_root is not None:
        shutil.rmtree(tmp_root, ignore_errors=True)

    return {
        "subjects": int(subjects),
        "requests": int(requests),
        "max_subjects": int(max_subjects),
        "buckets": list(eng_b.buckets),
        "lattice_entries": len(manifest["entries"]),
        "baked_compiles": int(baked_compiles),
        "killed_inflight": len(kill_futs),
        "killed_futures_resolved_fraction": float(
            f"{killed_resolved / len(kill_futs):.6g}"),
        "restore": restore,
        "warmup_sources": {str(b): s for b, s in warm_full.items()},
        "warmup_posed_sources": {str(b): s for b, s in warm_posed.items()},
        "compiles_after_restore": int(compiles_after_restore),
        "aot_loads": int(aot_loads),
        "aot_load_failures": int(snap_b["aot_load_failures"]),
        "expected_programs": int(expected_programs),
        "subjects_restored": int(snap_b["subjects_restored"]),
        "restored_vs_warm_max_abs_err": float(restored_err),
        "restored_vs_fresh_max_abs_err": float(restored_vs_fresh),
        "t_restore_s": float(f"{t_restore:.5g}"),
        "t_warm_s": float(f"{t_warm:.5g}"),
        "t_first_result_s": float(f"{t_first:.5g}"),
        "t_p99_stable_s": float(f"{t_p99:.5g}"),
        "wave_p99_ms": [float(f"{w * 1e3:.4g}") for w in wave_p99],
        "injections": injections,
        "hang_leg": hang_leg,
        "phase_a": {"submitted": requests, "resolved_ok": ok_a,
                    "resolved_error": err_a, "unresolved": un_a},
        "flight_record": flight_record(
            tracer, eng_b.counters, reason="coldstart_drill_complete"),
    }


def _ragged_stream(params, requests, min_rows, max_rows, rng):
    sizes = rng.integers(min_rows, max_rows + 1, size=requests)
    stream = [
        (rng.normal(scale=0.4, size=(n, params.n_joints, 3)).astype(
            np.float32),
         rng.normal(size=(n, params.n_shape)).astype(np.float32))
        for n in (int(s) for s in sizes)
    ]
    return sizes, stream


def tracing_overhead_run(
    params,
    *,
    requests: int = 160,
    min_rows: int = 1,
    max_rows: int = 16,
    max_bucket: int = 32,
    max_delay_s: float = 0.002,
    seed: int = 0,
    trials: int = 9,
    trace_dir=None,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """The tracing-overhead protocol (JAX's ``tracing_overhead_run``).

    Two engines on ``device`` serve the SAME ragged request stream — one
    with a live ``obs.Tracer`` spanning every request, one untraced —
    interleaved per trial with alternating order. The headline
    ``tracing_overhead_ratio`` is the MEDIAN of the per-trial paired
    ratios (each trial's quotient cancels the load drift common to its
    pair; the median rejects spike trials); the min-time rates ride
    along as the throughput record.

    Criteria: ``tracing_overhead_ratio`` <= 1.03 (judged at >= 64
    requests; a smaller run's ratio is noise and is recorded only);
    ``steady_recompiles`` == 0 on the traced engine; ``span_accounting``
    with every span closed exactly once. ``trace_dir`` also exports the
    traced engine's Chrome-trace timeline and final flight record there
    (``obs.write_trace_dir``).
    """
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    log = _logger(log)
    max_rows = min(max_rows, max_bucket)
    min_rows = max(1, min(min_rows, max_rows))
    rng = np.random.default_rng(seed)
    sizes, stream = _ragged_stream(params, requests, min_rows, max_rows, rng)
    rows_total = int(sizes.sum())

    tracer = Tracer()
    eng_off = ServingEngine(params, device=device, max_bucket=max_bucket,
                            max_delay_s=max_delay_s)
    eng_on = ServingEngine(params, device=device, max_bucket=max_bucket,
                           max_delay_s=max_delay_s, tracer=tracer)

    def run(eng):
        t0 = time.perf_counter()
        futs = [eng.submit(p, s) for p, s in stream]
        for f in futs:
            f.result()
        return time.perf_counter() - t0

    ratios: List[float] = []
    dt_on_best = dt_off_best = float("inf")
    with eng_off, eng_on:
        eng_off.warmup()
        eng_on.warmup()
        run(eng_off)                 # settle both engines
        run(eng_on)
        compiles_warm = eng_on.counters.compiles
        for t in range(max(1, trials)):
            # Alternate which engine goes first: a monotone load drift
            # would otherwise land on the same side every trial.
            if t % 2 == 0:
                dt_on, dt_off = run(eng_on), run(eng_off)
            else:
                dt_off, dt_on = run(eng_off), run(eng_on)
            ratios.append(dt_on / dt_off)
            dt_on_best = min(dt_on_best, dt_on)
            dt_off_best = min(dt_off_best, dt_off)
        steady_recompiles = eng_on.counters.compiles - compiles_warm
    # Both engines are STOPPED here: anything still open is a leak.
    accounting = tracer.accounting()
    stages = tracer.stage_breakdown()
    ratio = float(np.median(ratios))
    log(f"tracing: traced {rows_total / dt_on_best:,.0f} vs untraced "
        f"{rows_total / dt_off_best:,.0f} evals/s (median paired ratio "
        f"{ratio:.3f}), {steady_recompiles} steady recompiles, spans "
        f"{accounting['spans_closed']}/{accounting['spans_started']} "
        f"closed")
    out = {
        "requests": int(requests),
        "trials": int(max(1, trials)),
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng_on.buckets),
        "traced_evals_per_sec": float(f"{rows_total / dt_on_best:.5g}"),
        "untraced_evals_per_sec": float(
            f"{rows_total / dt_off_best:.5g}"),
        "tracing_overhead_ratio": float(f"{ratio:.4g}"),
        "ratio_best_window": float(f"{dt_on_best / dt_off_best:.4g}"),
        "ratio_trials": [float(f"{r:.3g}") for r in ratios],
        "steady_recompiles": int(steady_recompiles),
        "span_accounting": accounting,
        "stage_breakdown": stages,
        "flight_record": flight_record(
            tracer, eng_on.counters, reason="tracing_overhead_complete"),
    }
    if trace_dir is not None:
        from mano_hand_tpu_torch.obs import write_trace_dir

        out["trace_export"] = write_trace_dir(
            tracer, trace_dir, counters=eng_on.counters,
            reason="tracing_overhead_complete")
    return out


def metrics_overhead_run(
    params,
    *,
    requests: int = 160,
    min_rows: int = 1,
    max_rows: int = 16,
    max_bucket: int = 32,
    max_delay_s: float = 0.002,
    seed: int = 0,
    trials: int = 13,
    reps: int = 3,
    metrics_dir=None,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """The metrics + sentinel protocol (JAX's ``metrics_overhead_run``).

    (1) **What does the health surface cost?** An OBSERVED engine
    (tracer + metrics registry + numerics sentinel) serves the same
    ragged stream as a bare engine, interleaved per trial with
    alternating order; the headline is the MEDIAN paired ratio. Each
    timed pass is ``reps`` stream repetitions ending in ONE registry
    scrape (snapshot + Prometheus render) and ONE sentinel probe, all
    inside the window. (2) **Does the sentinel catch silent
    corruption?** The chaos ``wrong``-output fault is composed into a
    live supervised engine: traffic keeps resolving with corrupt floats,
    and the sentinel's next probe MUST flag the primary family drifted
    (a CPU engine's un-wrapped CPU tier probing clean), then recover once
    the fault clears.

    Criteria: ``metrics_overhead_ratio`` <= 1.03 at >= 64 requests;
    ``steady_recompiles`` == 0 on the observed engine; ``sentinel_drill``
    detected, recovered, every future resolved, probe spans closed
    exactly once; ``slo`` burn rates from the same counters snapshot the
    export serves. On a card the drill's engine has no CPU tier
    (``cpu_family_clean`` reads None). ``metrics_dir`` persists the final
    registry snapshot as ``metrics.json`` + ``metrics.prom`` (+
    ``slo.json``).
    """
    import concurrent.futures as cf

    from mano_hand_tpu_torch.obs.metrics import (
        engine_registry, prometheus_text, slo_report,
    )
    from mano_hand_tpu_torch.obs.recorder import FlightRecorder
    from mano_hand_tpu_torch.obs.sentinel import NumericsSentinel
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    log = _logger(log)
    cpu_tier = resolve_device(device).type == "cpu"
    max_rows = min(max_rows, max_bucket)
    min_rows = max(1, min(min_rows, max_rows))
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    sizes, stream = _ragged_stream(params, requests, min_rows, max_rows, rng)
    rows_total = int(sizes.sum())

    tracer = Tracer()
    eng_bare = ServingEngine(params, device=device, max_bucket=max_bucket,
                             max_delay_s=max_delay_s)
    eng_obs = ServingEngine(params, device=device, max_bucket=max_bucket,
                            max_delay_s=max_delay_s, tracer=tracer)
    sentinel = NumericsSentinel(eng_obs, tracer=tracer, interval_s=3600.0)
    reg = engine_registry(eng_obs, tracer=tracer, sentinel=sentinel)
    reps = max(1, int(reps))

    def run_bare():
        t0 = time.perf_counter()
        for _ in range(reps):
            futs = [eng_bare.submit(p, s) for p, s in stream]
            for f in futs:
                f.result()
        return time.perf_counter() - t0

    def run_obs():
        # The full health surface: the traced engine serves the stream,
        # then ONE scrape and ONE probe land inside the window, at the
        # pass boundary (never inside the submit loop).
        t0 = time.perf_counter()
        for _ in range(reps):
            futs = [eng_obs.submit(p, s) for p, s in stream]
            for f in futs:
                f.result()
        prometheus_text(reg.snapshot())
        sentinel.probe()
        return time.perf_counter() - t0

    ratios: List[float] = []
    dt_obs_best = dt_bare_best = float("inf")
    with eng_bare, eng_obs:
        eng_bare.warmup()
        eng_obs.warmup()
        golden = sentinel.arm()     # goldens check
        sentinel.probe()            # the references' first use
        run_bare()                  # settle both engines
        run_obs()
        compiles_warm = eng_obs.counters.compiles
        for t in range(max(1, trials)):
            if t % 2 == 0:
                dt_obs, dt_bare = run_obs(), run_bare()
            else:
                dt_bare, dt_obs = run_bare(), run_obs()
            ratios.append(dt_obs / dt_bare)
            dt_obs_best = min(dt_obs_best, dt_obs)
            dt_bare_best = min(dt_bare_best, dt_bare)
        steady_recompiles = eng_obs.counters.compiles - compiles_warm
        # The background loop fires on its own (bounded wait).
        before = sentinel.status()["probes"]
        sentinel.interval_s = 0.02
        sentinel.start()
        deadline = time.monotonic() + 10.0
        while (sentinel.status()["probes"] <= before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        sentinel.stop()
        background_probes = sentinel.status()["probes"] - before
        slo = slo_report(eng_obs.counters.snapshot())
        final_snapshot = reg.snapshot()
    accounting = tracer.accounting()
    ratio = float(np.median(ratios))
    rows_total *= reps              # rows served per timed pass
    log(f"metrics: observed {rows_total / dt_obs_best:,.0f} vs bare "
        f"{rows_total / dt_bare_best:,.0f} evals/s (median paired "
        f"ratio {ratio:.3f}), {steady_recompiles} steady recompiles, "
        f"{sentinel.status()['probes']} probes "
        f"({background_probes} background), golden "
        f"{golden['golden_status']}")

    # ---- the sentinel drill: injected silent corruption MUST be seen.
    plan = ChaosPlan()
    pol = DispatchPolicy(deadline_s=20.0, retries=0, chaos=plan,
                         cpu_fallback=cpu_tier)
    tr3 = Tracer()
    eng3 = ServingEngine(params, device=device, min_bucket=8, max_bucket=8,
                         max_delay_s=max_delay_s, policy=pol, tracer=tr3)
    rec3 = FlightRecorder(tr3, eng3.counters)
    s3 = NumericsSentinel(eng3, tracer=tr3, interval_s=3600.0)
    wave = [
        (rng.normal(scale=0.4, size=(int(n), n_joints, 3)).astype(
            np.float32),
         rng.normal(size=(int(n), n_shape)).astype(np.float32))
        for n in rng.integers(1, 5, size=12)
    ]

    def submit_wave():
        # "Resolved" = a RESULT or a structured error, never a hang (the
        # wrong-output fault resolves every future with a result; that it
        # is the WRONG one is what only the sentinel can see).
        futs = [eng3.submit(p, s) for p, s in wave]
        resolved = 0
        for f in futs:
            try:
                f.result(timeout=60.0)
                resolved += 1
            except cf.TimeoutError:
                pass
            except Exception:  # noqa: BLE001 — structured error resolves
                resolved += 1
        return resolved, len(futs)

    with eng3:
        eng3.warmup()               # primary (+ a CPU engine's CPU tier)
        s3.arm()
        ok0, n0 = submit_wave()     # clean traffic
        clean = s3.probe()
        drill_compiles_warm = eng3.counters.compiles
        # Every wrapped (primary) call from here returns verts + 1.0 — no
        # exception, so supervision never fires and every future still
        # resolves "ok". Only the sentinel can see this.
        plan.schedule("wrong:1.0@0-")
        ok1, n1 = submit_wave()
        detected = s3.probe()
        plan.clear()                # the fault clears
        recovered = s3.probe()
        drill_recompiles = eng3.counters.compiles - drill_compiles_warm
    drill_acc = tr3.accounting()
    fam = detected["families"]
    drill = {
        "submitted": n0 + n1,
        "futures_resolved_fraction": (ok0 + ok1) / (n0 + n1),
        "clean_probe_drift": bool(clean["drift"]),
        "detected": bool(detected["drift"]),
        "drifted_families": detected["drifted_families"],
        "drift_max_abs_err": max(
            (fam[f]["max_abs_err"] for f in
             detected["drifted_families"]), default=None),
        "cpu_family_clean": (("cpu" in fam and not fam["cpu"]["drift"])
                             if cpu_tier else None),
        "recovered": not recovered["drift"],
        "incidents": drill_acc["incidents"],
        "flight_capture_reasons": [c.get("reason")
                                   for c in rec3.captures],
        "faults_injected": int(eng3.counters.faults_injected),
        "steady_recompiles": int(drill_recompiles),
        "span_accounting": drill_acc,
    }
    log(f"sentinel drill: detected={drill['detected']} "
        f"(families {drill['drifted_families']}, max err "
        f"{drill['drift_max_abs_err']}), cpu clean "
        f"{drill['cpu_family_clean']}, recovered "
        f"{drill['recovered']}, {drill['futures_resolved_fraction']:.0%}"
        f" of {drill['submitted']} futures resolved, "
        f"{drill['incidents']} incident(s)")

    out = {
        "requests": int(requests),
        "trials": int(max(1, trials)),
        "reps_per_pass": int(reps),
        "scrapes_per_pass": 1,
        "probes_per_pass": 1,
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng_obs.buckets),
        "observed_evals_per_sec": float(
            f"{rows_total / dt_obs_best:.5g}"),
        "bare_evals_per_sec": float(
            f"{rows_total / dt_bare_best:.5g}"),
        "metrics_overhead_ratio": float(f"{ratio:.4g}"),
        "ratio_best_window": float(
            f"{dt_obs_best / dt_bare_best:.4g}"),
        "ratio_trials": [float(f"{r:.3g}") for r in ratios],
        "steady_recompiles": int(steady_recompiles),
        "span_accounting": accounting,
        "registry_metrics": len(final_snapshot.get("metrics", {})),
        "registry_errors": final_snapshot.get("errors"),
        "sentinel": {k: v for k, v in sentinel.status().items()
                     if k != "last"},
        "sentinel_background_probes": int(background_probes),
        "golden": golden,
        "slo": slo,
        "sentinel_drill": drill,
        "flight_record": flight_record(
            tracer, eng_obs.counters,
            reason="metrics_overhead_complete"),
    }
    if metrics_dir is not None:
        from mano_hand_tpu_torch.obs.metrics import export_metrics_dir

        out["metrics_export"] = export_metrics_dir(
            final_snapshot, metrics_dir, slo=slo)
    return out


def stream_drill_run(
    params,
    *,
    streams: int = 208,
    frames_per_stream: int = 4,
    subjects: Optional[int] = None,
    workers: int = 16,
    warm_steps: int = 4,
    cold_steps_candidates: Sequence[int] = (8, 16, 32),
    target_loss: float = 1e-9,
    frame_deadline_s: float = 5.0,
    batch_deadline_s: float = 10.0,
    min_bucket: int = 8,
    max_bucket: int = 64,
    max_delay_s: float = 0.002,
    chaos_spec: str = "error@0-",
    calib_probes: int = 12,
    fit_trials: int = 5,
    seed: int = 0,
    tracer=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """The streaming-session drill: many per-user tracking sessions, each
    a stream of correlated frames.

    Every stream gets a synthetic subject (``subjects`` distinct betas,
    shared round-robin) and a smooth pose track
    (``models/anim.py:resample_poses`` over seeded keyframes); each frame
    runs the whole session step — a frozen-shape LM fit warm-started
    from the last converged pose, then the posed verts through the
    gathered dispatch at tier 0 with a per-frame deadline — from a
    ``workers``-wide pool, so frames coalesce into mixed-subject batches.

    Phases: bake every subject, warm every program (and, on a CPU engine,
    the CPU tier the chaos round needs), open every stream, a settle
    round (un-deadlined), TIMED steady rounds, the warm-vs-cold fit
    calibration (``_stream_fit_calibration``), then a CHAOS round under
    ``chaos_spec``, then close. A card engine has no CPU tier: there the
    chaos round's faults are retried on the card (one retry a batch) and
    a frame whose retries are exhausted resolves to its ``ServingError``
    — pass a spec the retries absorb to keep every frame ``ok``.

    Returned criteria (JAX's keys):

    * ``frames_resolved_fraction`` == 1.0 with ``outcomes.stranded`` == 0:
      every frame of every stream, chaos round included, resolves;
    * ``failover_vs_cpu_direct_max_abs_err`` == 0.0 on a CPU engine: the
      probe stream's chaos-round frame, served by the CPU tier, is a
      direct CPU ``core.forward_batched`` call of its pose and betas, bit
      for bit, at one of the engine's buckets (a frame does not see its
      batch's bucket; a row of the plain CPU forward rounds by the batch
      size). None on a card engine;
    * ``warm_start_after_failover_consistent``: the probe session's warm
      start after the chaos round is the fit's own pose — the frame's
      pose when it resolved, else the same fit re-run from the state
      before the round: a serving fault never touches the solver;
    * ``steady_recompiles`` == 0: the sessions share one program family;
    * ``slo.tiers["0"]`` carries the frame-latency p99 burn rate
      (``p99_target_ms`` = the frame deadline);
    * ``stream_spans``: every opened session reaches exactly one terminal
      (``closed`` for the explicit closes, ``shutdown`` for the two
      ``stop()`` sweeps), and the flight record's accounting balances.

    ``frame_p50_ms``/``frame_p99_ms`` are end-to-end frame latencies (fit
    and dispatch); ``fit_p50_ms``/``dispatch_p50_ms`` split them (port
    keys beside JAX's).
    """
    import concurrent.futures as cf

    from mano_hand_tpu_torch.fitting import lm as lm_mod
    from mano_hand_tpu_torch.models import anim, core
    from mano_hand_tpu_torch.obs.metrics import (
        DEFAULT_SLO_OBJECTIVES, slo_report,
    )
    from mano_hand_tpu_torch.ops.common import ieee_fp32, resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving import buckets as bucket_mod
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    min_frames = 3 if chaos_spec else 2
    if frames_per_stream < min_frames:
        # With a chaos spec the LAST round is the chaos round: settle, at
        # least one timed steady round, chaos.
        raise ValueError(
            f"frames_per_stream must be >= {min_frames} (a settle "
            f"round, at least one timed steady round"
            f"{', and the chaos round' if chaos_spec else ''}), got "
            f"{frames_per_stream}")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    log = _logger(log)
    if tracer is None:
        tracer = Tracer()
    dev = resolve_device(device)
    cpu_tier = dev.type == "cpu"
    subjects = streams if subjects is None else max(1, int(subjects))
    calib_probes = max(1, min(calib_probes, streams))
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    prm32 = params.astype(torch.float32).to(dev)

    # ---- Synthetic per-user tracks (the correlated-frames premise) ----
    betas = [rng.normal(size=(n_shape,)).astype(np.float32)
             for _ in range(subjects)]
    subj_of = [s % subjects for s in range(streams)]
    keys = np.zeros((streams, 3, n_joints, 3), np.float32)
    keys[:, 1] = rng.normal(scale=0.2, size=(streams, n_joints, 3))
    keys[:, 2] = keys[:, 1] + rng.normal(
        scale=0.1, size=(streams, n_joints, 3))
    tracks = np.stack([
        anim.resample_poses(keys[s], frames_per_stream)
        for s in range(streams)]).astype(np.float32)   # [S, T, J, 3]
    flat_pose = tracks.reshape(streams * frames_per_stream, n_joints, 3)
    flat_beta = np.stack([betas[subj_of[s]]
                          for s in range(streams)
                          for _ in range(frames_per_stream)])
    with torch.no_grad(), ieee_fp32():
        gt = core.forward_batched(prm32, torch.from_numpy(flat_pose).to(dev),
                                  torch.from_numpy(flat_beta).to(dev))
    targets = gt.posed_joints.cpu().numpy().reshape(
        streams, frames_per_stream, n_joints, 3)

    # ---- Engine: supervised and chaos-wrappable; the CPU tier on a CPU
    #      engine only ---------------------------------------------------
    plan = ChaosPlan()
    policy = DispatchPolicy(
        deadline_s=batch_deadline_s, retries=1, backoff_s=0.01,
        backoff_cap_s=0.02, jitter=0.0, breaker=None, chaos=plan,
        cpu_fallback=cpu_tier,
    )
    eng = ServingEngine(prm32, device=dev, min_bucket=min_bucket,
                        max_bucket=max_bucket, max_delay_s=max_delay_s,
                        policy=policy, posed_kernel=posed_kernel,
                        tracer=tracer)
    prm_cpu = prm32.to("cpu")

    def cpu_direct(pose, beta):
        """The failover reference: a direct CPU call of the row, padded
        (repeating it) to each of the engine's buckets."""
        out = []
        with torch.no_grad(), ieee_fp32():
            for b in eng.buckets:
                p = torch.from_numpy(np.array(bucket_mod.pad_rows(
                    pose[None], b), np.float32, order="C"))
                s = torch.from_numpy(np.array(bucket_mod.pad_rows(
                    beta[None], b), np.float32, order="C"))
                out.append(core.forward_batched(prm_cpu, p, s).verts[0]
                           .numpy())
        return out

    outcomes = {"ok": 0, "shed": 0, "expired": 0, "error": 0,
                "stranded": 0}
    chaos_outcomes = dict(outcomes)
    frame_lat: List[float] = []
    fit_lat: List[float] = []
    round_times: List[float] = []
    failover_err = None

    pool = cf.ThreadPoolExecutor(max_workers=workers,
                                 thread_name_prefix="stream-drill")
    try:
        with eng:
            keys_subj = [eng.specialize(b) for b in betas]
            growths = eng.counters.table_growths
            log(f"streams: {subjects} subjects baked ({growths} table "
                f"growths), warming buckets {eng.buckets}")
            eng.warmup()          # the full family (and a CPU tier)
            eng.warmup_posed()    # the gathered family at final capacity
            sessions = [
                eng.open_stream(keys_subj[subj_of[s]],
                                n_steps=warm_steps, data_term="joints",
                                frame_deadline_s=frame_deadline_s)
                for s in range(streams)]

            resolve_timeout = (frame_deadline_s
                               + batch_deadline_s * (policy.retries + 2)
                               + 30.0)

            def tally_frame(ff, tally):
                """THE classification of one frame future; returns the
                FrameResult on ``ok``, else None."""
                try:
                    res = ff.result(timeout=resolve_timeout)
                    tally["ok"] += 1
                    return res
                except ServingError as e:
                    tally[e.kind if e.kind in tally else "error"] += 1
                except Exception:  # noqa: BLE001 — a timeout IS the bug
                    tally["stranded"] += 1
                return None

            def run_round(r, tally, deadline=True):
                """Frame r of every stream from the pool; every future
                waited for and tallied. Returns (seconds, results)."""
                t0 = time.perf_counter()
                outer = [pool.submit(
                    sessions[s].submit_frame, targets[s, r],
                    deadline_s=frame_deadline_s if deadline else None)
                         for s in range(streams)]
                inner = []
                for of in outer:
                    try:
                        inner.append(of.result(timeout=120.0))
                    except Exception:  # noqa: BLE001 — a refused frame
                        inner.append(None)   # counts as stranded below
                results_r = []
                for ff in inner:
                    if ff is None:
                        tally["stranded"] += 1
                        results_r.append(None)
                        continue
                    results_r.append(tally_frame(ff, tally))
                return time.perf_counter() - t0, results_r

            def run_round_timed(r, tally):
                """A steady round, each frame's latency stamped by its own
                submit/resolve pair (fit and dispatch), the fit's share by
                the submit's return."""
                t0 = time.perf_counter()
                boxes = []

                def one(s):
                    t_sub = time.perf_counter()
                    ff = sessions[s].submit_frame(targets[s, r])
                    fit_lat.append(time.perf_counter() - t_sub)
                    box = []
                    ff.add_done_callback(
                        lambda f, b=box, t=t_sub:
                            b.append(time.perf_counter() - t))
                    return ff, box

                outer = [pool.submit(one, s) for s in range(streams)]
                pairs = [of.result(timeout=120.0) for of in outer]
                for ff, box in pairs:
                    tally_frame(ff, tally)
                    boxes.append(box)
                dt = time.perf_counter() - t0
                frame_lat.extend(b[0] for b in boxes if b)
                return dt

            # Round 0: settle, un-deadlined (first-use work and every
            # stream's frame-0 seed land here, outside timing).
            dt0, _ = run_round(0, outcomes, deadline=False)
            compiles_settled = eng.counters.compiles
            log(f"streams: settle round {dt0:.2f}s "
                f"({eng.counters.compiles} warm-up builds); "
                f"{streams} streams x {frames_per_stream} frames")
            chaos_round = frames_per_stream - 1 if chaos_spec else None
            steady = [r for r in range(1, frames_per_stream)
                      if r != chaos_round]
            for r in steady:
                round_times.append(run_round_timed(r, outcomes))

            # ---- Warm-vs-cold calibration (slope-timed) --------------
            calib = _stream_fit_calibration(
                prm32, sessions[:calib_probes],
                [betas[subj_of[s]] for s in range(calib_probes)],
                [targets[s, chaos_round if chaos_round is not None
                         else frames_per_stream - 1]
                 for s in range(calib_probes)],
                lm_mod, warm_steps=warm_steps,
                cold_steps_candidates=tuple(cold_steps_candidates),
                target_loss=target_loss, trials=fit_trials, log=log)

            # ---- Chaos round -----------------------------------------
            failovers_before = eng.counters.failovers
            warm_start_consistent = None
            if chaos_round is not None:
                probe_s = 0
                probe = sessions[probe_s]
                state_before = probe._state
                plan.schedule(chaos_spec)
                try:
                    _, results_c = run_round(chaos_round, chaos_outcomes)
                finally:
                    plan.clear()
                res = results_c[probe_s]
                if res is not None:
                    # The frame's verts against direct CPU calls of the
                    # same (pose, betas) (a CPU engine's failover); the
                    # warm start is the fit's own pose.
                    if cpu_tier and eng.counters.failovers > \
                            failovers_before:
                        failover_err = min(
                            float(np.abs(res.verts - want).max())
                            for want in cpu_direct(
                                res.pose, betas[subj_of[probe_s]]))
                    warm_start_consistent = bool(np.array_equal(
                        probe.pose, res.pose))
                else:
                    # The frame failed in serving: the warm start is still
                    # what the fit made of the same target.
                    _, refit = probe._step(state_before,
                                           targets[probe_s, chaos_round])
                    warm_start_consistent = bool(np.array_equal(
                        probe.pose, refit.pose.detach().cpu().numpy()))
                for k, v in chaos_outcomes.items():
                    outcomes[k] += v
            failovers = eng.counters.failovers - failovers_before

            steady_recompiles = (eng.counters.compiles
                                 - compiles_settled)
            # Close all but two sessions; stop() sweeps the stragglers
            # to the ``shutdown`` terminal.
            for sess in sessions[:-2]:
                sess.close()
            load_final = eng.load()
            snap = eng.counters.snapshot()
    finally:
        pool.shutdown(wait=False)
        plan.release.set()

    # After stop(): the sweep moved the stragglers to ``shutdown``.
    streams_snap = eng.load()["streams"]
    submitted = sum(outcomes.values())
    resolved_fraction = (1.0 - outcomes["stranded"] / submitted
                         if submitted else 0.0)

    def pct(xs, q):
        return (float(np.percentile(np.asarray(xs) * 1e3, q))
                if xs else None)

    p50, p99 = pct(frame_lat, 50), pct(frame_lat, 99)
    fit50, fit99 = pct(fit_lat, 50), pct(fit_lat, 99)
    disp = [f - g for f, g in zip(frame_lat, fit_lat)] \
        if len(frame_lat) == len(fit_lat) else []
    fps = (max(streams / t for t in round_times)
           if round_times else None)
    objectives = {
        "0": {**DEFAULT_SLO_OBJECTIVES["0"],
              "p99_target_ms": frame_deadline_s * 1e3},
        "default": DEFAULT_SLO_OBJECTIVES["default"],
    }
    slo = slo_report(
        snap, objectives,
        latency_by_tier={"0": {"p50_ms": p50, "p99_ms": p99,
                               "n": len(frame_lat)}}
        if frame_lat else None)
    log(f"streams: {submitted} frames -> {outcomes['ok']} ok / "
        f"{outcomes['shed']} shed / {outcomes['expired']} expired / "
        f"{outcomes['error']} error / {outcomes['stranded']} "
        f"stranded; {fps and f'{fps:,.0f}'} frames/s steady, p99 "
        f"{p99 and f'{p99:.1f}'} ms, {failovers} failover(s), "
        f"{steady_recompiles} steady recompiles")
    g4 = lambda x: None if x is None else float(f"{x:.4g}")  # noqa: E731
    return {
        "streams": int(streams),
        "frames_per_stream": int(frames_per_stream),
        "subjects": int(subjects),
        "workers": int(workers),
        "buckets": list(eng.buckets),
        "frame_deadline_s": frame_deadline_s,
        "frames_submitted": int(submitted),
        "frames_resolved_fraction": float(f"{resolved_fraction:.6g}"),
        "outcomes": outcomes,
        "chaos_spec": chaos_spec or None,
        "chaos_outcomes": chaos_outcomes if chaos_spec else None,
        "failovers": int(failovers),
        "failover_vs_cpu_direct_max_abs_err": failover_err,
        "warm_start_after_failover_consistent": warm_start_consistent,
        "frames_per_sec": (None if fps is None
                           else float(f"{fps:.5g}")),
        "frame_p50_ms": g4(p50),
        "frame_p99_ms": g4(p99),
        "fit_p50_ms": g4(fit50),
        "fit_p99_ms": g4(fit99),
        "dispatch_p50_ms": g4(pct(disp, 50)),
        "dispatch_p99_ms": g4(pct(disp, 99)),
        **calib,
        "steady_recompiles": int(steady_recompiles),
        "table_growths": snap["table_growths"],
        "mixed_subject_batches": snap["mixed_subject_batches"],
        "coalesce_width_mean": snap["coalesce_width_mean"],
        "dispatches": snap["dispatches"],
        "stream_spans": {
            "opened": streams_snap["opened"],
            "closed_by_kind": streams_snap["closed_by_kind"],
            "active_after_stop": streams_snap["active"],
        },
        "slo": slo,
        "load_final": {k: load_final[k]
                       for k in ("outstanding", "queued", "streams",
                                 "backlog_age_s")
                       if k in load_final},
        "flight_record": flight_record(
            tracer, eng.counters, reason="stream_drill_complete"),
    }


def _stream_fit_calibration(prm32, sessions, betas, next_targets,
                            lm_mod, *, warm_steps, cold_steps_candidates,
                            target_loss, trials, log) -> dict:
    """The warm-start measurement of ``stream_drill_run``: warm-started
    frozen-shape fits at ``warm_steps`` against the cheapest COLD fit
    (rest-pose start) reaching the same bar, both slope-timed.

    Loss parity first: the warm side must sit under ``target_loss``
    (``warm_loss_matched``) and the cold side's step count is the
    smallest candidate whose median loss does too. Then the slope: the
    per-fit marginal cost over two in-pass repeat counts (m and 2m fits),
    warm and cold interleaved per trial, the minimum over trials per
    point. Each fit's device work is waited for before the clock reads.
    """
    def settle(x):
        if torch.is_tensor(x) and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x

    probes = []
    for sess, beta, target in zip(sessions, betas, next_targets):
        probes.append((sess.pose, beta, target))

    def warm_fit(i, n_steps=warm_steps):
        pose, beta, target = probes[i % len(probes)]
        return lm_mod.fit_lm(prm32, target, n_steps=n_steps,
                             data_term="joints", init={"pose": pose},
                             frozen_shape=beta)

    def cold_fit(i, n_steps):
        _, beta, target = probes[i % len(probes)]
        return lm_mod.fit_lm(prm32, target, n_steps=n_steps,
                             data_term="joints", frozen_shape=beta)

    warm_losses = [float(settle(warm_fit(i).final_loss))
                   for i in range(len(probes))]
    warm_median = float(np.median(warm_losses))
    warm_ok = warm_median <= target_loss

    cold_steps = None
    cold_median = None
    for k in sorted(cold_steps_candidates):
        losses = [float(settle(cold_fit(i, k).final_loss))
                  for i in range(len(probes))]
        med = float(np.median(losses))
        cold_steps, cold_median = int(k), med   # the best so far
        if med <= target_loss:
            break
    matched = bool(warm_ok and cold_median is not None
                   and cold_median <= target_loss)

    m1 = len(probes)
    m2 = 2 * m1

    def run_m(fit, m, n_steps):
        t0 = time.perf_counter()
        last = None
        for i in range(m):
            last = fit(i, n_steps)
        settle(last.pose)
        return time.perf_counter() - t0

    thunks = {
        "w1": lambda: run_m(warm_fit, m1, warm_steps),
        "w2": lambda: run_m(warm_fit, m2, warm_steps),
        "c1": lambda: run_m(cold_fit, m1, cold_steps),
        "c2": lambda: run_m(cold_fit, m2, cold_steps),
    }
    for k in thunks:
        thunks[k]()     # settle: every path warm before timing
    best = {k: float("inf") for k in thunks}
    for t in range(max(1, trials)):
        order = sorted(thunks) if t % 2 == 0 \
            else sorted(thunks, reverse=True)
        for k in order:
            best[k] = min(best[k], thunks[k]())
    s_warm = (best["w2"] - best["w1"]) / (m2 - m1)
    s_cold = (best["c2"] - best["c1"]) / (m2 - m1)
    ratio = s_cold / s_warm if s_warm > 0 and s_cold > 0 else None
    log(f"streams calib: warm {warm_steps} steps (median loss "
        f"{warm_median:.2e}) vs cold {cold_steps} steps (median "
        f"{cold_median:.2e}, bar {target_loss:.0e}, matched="
        f"{matched}); slope {s_warm * 1e3:.2f} vs "
        f"{s_cold * 1e3:.2f} ms/fit -> ratio "
        f"{ratio and f'{ratio:.2f}'}x")
    return {
        "warm_fit_steps": int(warm_steps),
        "cold_fit_steps": cold_steps,
        "fit_target_loss": target_loss,
        "warm_fit_loss_median": float(f"{warm_median:.5g}"),
        "cold_fit_loss_median": (None if cold_median is None
                                 else float(f"{cold_median:.5g}")),
        "warm_loss_matched": matched,
        "warm_fit_ms_per_frame": float(f"{s_warm * 1e3:.5g}"),
        "cold_fit_ms_per_frame": float(f"{s_cold * 1e3:.5g}"),
        "warm_fit_frames_per_sec": (
            None if s_warm <= 0 else float(f"{1.0 / s_warm:.5g}")),
        "cold_fit_frames_per_sec": (
            None if s_cold <= 0 else float(f"{1.0 / s_cold:.5g}")),
        "warm_vs_cold_fit_ratio": (
            None if ratio is None else float(f"{ratio:.4g}")),
    }


def dispatch_pipeline_drill_run(
    params,
    *,
    requests_steady: int = 240,
    requests_chaos: int = 48,
    calibrate_requests: int = 128,
    trials: int = 5,
    subjects: int = 6,
    max_rows: int = 2,
    max_bucket: int = 16,
    deadline_s: float = 6.0,
    inflight_depth: int = 2,
    device_rtt_s: float = 0.0015,
    max_delay_s: float = 0.002,
    pace_factor: float = 0.9,
    seed: int = 0,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """The paired pipelined-vs-serial dispatch drill.

    Two supervised engines on ``device`` over the same params, subjects
    and deterministic request streams (pose-only, 1-``max_rows`` rows,
    ``subjects`` subjects), differing only in the dispatch pipeline:
    ``serial`` (``inflight_depth=1``, the fixed coalesce window) and
    ``pipelined`` (``inflight_depth``, the adaptive window). The timed
    legs run ``trials`` times, interleaved per trial in alternating side
    order on the same stream; rates come from each side's fastest trial,
    queue waits pool every trial's spans:

    * **drain** — ``calibrate_requests`` submitted at once (a saturated
      backlog): each side's capacity;
    * **steady** — ``requests_steady`` arriving open-loop at
      ``pace_factor`` x the pipelined capacity, with a mid-leg
      ``future.cancel()`` probe at the same index on both sides; queue
      p50/p99 from each side's spans;
    * **chaos** — transient ``error@`` faults on launched batches (on the
      pipelined side the supervised envelope runs on the completion
      worker), absorbed by the retry.

    Every leg's results are compared with a plain reference engine's
    one-request dispatches of the same family (``posed_kernel``) and
    across the two sides (``cross_engine_bit_identical``): pipelining
    reorders work, never results where a row's result is independent of
    its batchmates (K2's on a card; on the CPU a row of the plain gather
    can round one ulp differently at another batch size, and the errors
    read ~1e-8). ``device_rtt_s`` > 0 adds the chaos module's
    ``sat:{device_rtt_s}@*`` throttle to every dispatch of both sides (a
    slow-device model); 0 measures the device as it is. A card engine
    has no CPU tier: its policy has ``cpu_fallback=False``, and the chaos
    leg's faults are retried on the card.
    """
    import concurrent.futures as cf

    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    log = _logger(log)
    dev = resolve_device(device)
    n_joints, n_shape = params.n_joints, params.n_shape
    prm32 = params.astype(torch.float32).to(dev)
    rng = np.random.default_rng(seed)
    subj_betas = [rng.normal(size=(n_shape,)).astype(np.float32)
                  for _ in range(subjects)]

    def make_stream(n, pass_seed):
        r = np.random.default_rng(pass_seed)
        sizes = r.integers(1, max_rows + 1, size=n)
        return [(r.normal(scale=0.4,
                          size=(int(s), n_joints, 3)).astype(np.float32),
                 int(r.integers(0, subjects)))
                for s in sizes]

    streams = {
        "drain": make_stream(calibrate_requests, seed + 300),
        "steady": make_stream(requests_steady, seed + 301),
        "chaos": make_stream(requests_chaos, seed + 302),
    }

    # The reference: a plain engine of the same family, one request a
    # dispatch.
    ref_eng = ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                            max_delay_s=0.001, posed_kernel=posed_kernel)
    reference = {}
    with ref_eng:
        ref_keys = [ref_eng.specialize(b) for b in subj_betas]
        for name, stream in streams.items():
            reference[name] = [
                ref_eng.forward(p, subject=ref_keys[si])
                for p, si in stream]

    sat_spec = (f"sat:{device_rtt_s}@*" if device_rtt_s > 0 else "")

    def build(depth, adaptive):
        plan = ChaosPlan()
        policy = DispatchPolicy(
            deadline_s=deadline_s, retries=1, backoff_s=0.005,
            backoff_cap_s=0.01, jitter=0.0, chaos=plan,
            cpu_fallback=dev.type == "cpu")
        tracer = Tracer(capacity=65536)
        eng = ServingEngine(
            prm32, device=dev, max_bucket=max_bucket,
            max_delay_s=max_delay_s, adaptive_coalesce=adaptive,
            inflight_depth=depth, policy=policy, tracer=tracer,
            posed_kernel=posed_kernel)
        return {"eng": eng, "plan": plan, "tracer": tracer}

    sides = {"serial": build(1, False),
             "pipelined": build(int(inflight_depth), True)}
    resolve_timeout = deadline_s * 3 + 60.0

    def queue_seconds(side, n0):
        tr = side["tracer"]
        spans = tr.spans()[n0:]
        out = []
        for sp in spans:
            st = tr._span_stages(sp)
            if st is not None:
                out.append(st["queue_s"])
        return out, spans

    def run_leg(side, stream, keys, *, rate=None, cancel_idx=-1):
        """Submit one leg (open-loop at ``rate``/s, or all at once when
        None), resolve everything, classify the outcomes."""
        eng = sides[side]["eng"]
        outcomes = {"ok": 0, "error": 0, "expired": 0, "stranded": 0,
                    "cancelled": 0}
        results = [None] * len(stream)
        futs = [None] * len(stream)
        t0 = time.perf_counter()
        for i, (p, si) in enumerate(stream):
            if rate is not None:
                wait = t0 + i / rate - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            futs[i] = eng.submit(p, subject=keys[si])
            if i == cancel_idx:
                futs[i].cancel()
        for i, f in enumerate(futs):
            try:
                results[i] = f.result(timeout=resolve_timeout)
                k = "ok"
            except cf.CancelledError:
                k = "cancelled"
            except ServingError as e:
                k = "expired" if e.kind == "expired" else "error"
            except Exception:   # noqa: BLE001 — a timeout IS the bug
                k = "stranded"
            outcomes[k] += 1
        return outcomes, results, time.perf_counter() - t0

    def max_err(results, refs, skip=()):
        worst = 0.0
        for i, (got, want) in enumerate(zip(results, refs)):
            if got is None:
                if i in skip:
                    continue
                return None              # an unresolved result: no bar
            worst = max(worst, float(np.abs(got - want).max()))
        return worst

    pct = lambda xs, q: float(   # noqa: E731
        f"{np.percentile(np.asarray(xs), q) * 1e3:.4g}") if xs else None
    g4 = lambda x: float(f"{x:.4g}")     # noqa: E731

    legs = {"serial": {}, "pipelined": {}}
    cancel_idx = len(streams["steady"]) // 2
    try:
        for name, side in sides.items():
            eng = side["eng"]
            eng.__enter__()
            side["keys"] = [eng.specialize(b) for b in subj_betas]
            buckets = [b for b in eng.buckets if b <= max_bucket]
            eng.warmup(buckets)
            eng.warmup_posed(buckets)
            side["warm_compiles"] = eng.counters.compiles
            if sat_spec:
                side["plan"].schedule(sat_spec)

        def order(t):
            return (("serial", "pipelined") if t % 2 == 0
                    else ("pipelined", "serial"))

        def werr(a, b):
            return None if a is None or b is None else max(a, b)

        def merge(leg, name, oc, err, res, dt):
            st = legs[name].setdefault(leg, {
                "outcomes": {k: 0 for k in oc}, "dts": [], "err": 0.0})
            for k, v in oc.items():
                st["outcomes"][k] += v
            st["dts"].append(dt)
            st["err"] = werr(st["err"], err)
            st["results"] = res

        # -- leg 1: drain (saturated-backlog capacity) ----------------
        for t in range(trials):
            for name in order(t):
                oc, res, dt = run_leg(name, streams["drain"],
                                      sides[name]["keys"])
                merge("drain", name, oc,
                      max_err(res, reference["drain"]), res, dt)
        serial_rate = calibrate_requests / min(
            legs["serial"]["drain"]["dts"])
        pipelined_rate = calibrate_requests / min(
            legs["pipelined"]["drain"]["dts"])
        # The steady pace: pace_factor of the PIPELINED capacity, above
        # the serial plateau when the pipeline buys headroom.
        paced_rate = pace_factor * pipelined_rate
        log(f"dispatch pipeline drill: capacities serial "
            f"{serial_rate:.1f} / pipelined {pipelined_rate:.1f} "
            f"req/s, pacing steady leg at {paced_rate:.1f} req/s")

        # -- leg 2: steady (matched saturated open-loop load) ---------
        for name, side in sides.items():
            side["steady_n0"] = len(side["tracer"].spans())
            side["compiles_before_steady"] = side["eng"].counters.compiles
        for t in range(trials):
            for name in order(t):
                oc, res, dt = run_leg(
                    name, streams["steady"], sides[name]["keys"],
                    rate=paced_rate, cancel_idx=cancel_idx)
                merge("steady", name, oc,
                      max_err(res, reference["steady"],
                              skip={cancel_idx}), res, dt)
        for name, side in sides.items():
            qs, spans = queue_seconds(side, side["steady_n0"])
            legs[name]["steady"].update({
                "queue_s": qs,
                "stage_table": side["tracer"].stage_breakdown(spans),
                "recompiles": (side["eng"].counters.compiles
                               - side["compiles_before_steady"]),
            })

        # -- leg 3: chaos (transient faults on launched batches) ------
        for name, side in sides.items():
            c0 = {k: getattr(side["eng"].counters, k)
                  for k in ("retries", "faults_injected", "failovers")}
            side["plan"].schedule(
                "error@1,error@4" + ("," + sat_spec if sat_spec else ""))
            oc, res, dt = run_leg(name, streams["chaos"], side["keys"])
            side["plan"].clear()
            merge("chaos", name, oc,
                  max_err(res, reference["chaos"]), res, dt)
            legs[name]["chaos"].update(
                {k: getattr(side["eng"].counters, k) - c0[k]
                 for k in c0})
    finally:
        for side in sides.values():
            side["plan"].release.set()
            side["eng"].__exit__(None, None, None)

    # Cross-engine bit identity, leg by leg (the cancel probe's index is
    # skipped on steady: both sides cancelled the same request).
    cross = True
    for leg_name in ("drain", "steady", "chaos"):
        for i, (a, b) in enumerate(zip(
                legs["serial"][leg_name]["results"],
                legs["pipelined"][leg_name]["results"])):
            if leg_name == "steady" and i == cancel_idx:
                continue
            if a is None or b is None or not np.array_equal(a, b):
                cross = False

    n_legs_total = (trials * (calibrate_requests + requests_steady)
                    + requests_chaos)
    out = {
        "requests_steady": requests_steady,
        "requests_chaos": requests_chaos,
        "calibrate_requests": calibrate_requests,
        "trials": trials,
        "subjects": subjects,
        "max_bucket": max_bucket,
        "pipeline_depth": int(inflight_depth),
        "device_rtt_s": device_rtt_s,
        "pace_factor": pace_factor,
        "serial_capacity_per_sec": g4(serial_rate),
        "pipelined_capacity_per_sec": g4(pipelined_rate),
        "paced_rate_per_sec": g4(paced_rate),
    }
    for name in ("serial", "pipelined"):
        side, lg = sides[name], legs[name]
        qs = lg["steady"]["queue_s"]
        acc = side["tracer"].accounting()
        resolved = n_legs_total - sum(
            lg[leg]["outcomes"]["stranded"]
            for leg in ("drain", "steady", "chaos"))
        outcomes = {k: sum(lg[leg]["outcomes"][k]
                           for leg in ("drain", "steady", "chaos"))
                    for k in lg["steady"]["outcomes"]}
        csnap = side["eng"].counters.snapshot()
        out[f"{name}_queue_p50_ms"] = pct(qs, 50)
        out[f"{name}_queue_p99_ms"] = pct(qs, 99)
        out.update({
            f"{name}_throughput_per_sec": g4(
                calibrate_requests / min(lg["drain"]["dts"])),
            f"{name}_drain_leg_seconds": [
                g4(dt) for dt in lg["drain"]["dts"]],
            f"{name}_paced_throughput_per_sec": g4(
                requests_steady / min(lg["steady"]["dts"])),
            f"{name}_steady_recompiles": int(lg["steady"]["recompiles"]),
            f"{name}_warmup_compiles": int(side["warm_compiles"]),
            f"{name}_futures_resolved_fraction": float(
                f"{resolved / n_legs_total:.6g}"),
            f"{name}_outcomes": outcomes,
            f"{name}_drain_vs_reference_max_abs_err":
                lg["drain"]["err"],
            f"{name}_steady_vs_reference_max_abs_err":
                lg["steady"]["err"],
            f"{name}_chaos_vs_reference_max_abs_err":
                lg["chaos"]["err"],
            f"{name}_chaos_retries": int(lg["chaos"]["retries"]),
            f"{name}_chaos_faults_injected": int(
                lg["chaos"]["faults_injected"]),
            f"{name}_stage_table": lg["steady"]["stage_table"],
            f"{name}_spans": {
                "started": acc["spans_started"],
                "closed": acc["spans_closed"],
                "open": acc["spans_open"],
                "closed_by_kind": acc["closed_by_kind"],
            },
            f"{name}_pipeline_inflight_peak": int(
                csnap["pipeline_inflight_peak"]),
            f"{name}_pipeline_completions": int(
                csnap["pipeline_completions"]),
        })
    out["queue_p50_speedup"] = (
        g4(out["serial_queue_p50_ms"] / out["pipelined_queue_p50_ms"])
        if out["serial_queue_p50_ms"] and out["pipelined_queue_p50_ms"]
        else None)
    out["throughput_speedup"] = g4(
        out["pipelined_throughput_per_sec"]
        / out["serial_throughput_per_sec"])
    out["cross_engine_bit_identical"] = bool(cross)
    frac = (out["serial_futures_resolved_fraction"]
            + out["pipelined_futures_resolved_fraction"]) / 2
    out["futures_resolved_fraction"] = float(f"{frac:.6g}")

    # The depth-1 contract, observed: a serial span never carries the
    # "staged" stage, a pipelined one does.
    def _has_pipeline_stage(table):
        return any("pipeline_p50_ms" in cell
                   for cell in table["by_bucket_tier"].values())
    out["serial_telemetry_serial_shape"] = (
        not _has_pipeline_stage(out["serial_stage_table"]))
    out["pipelined_overlap_observed"] = _has_pipeline_stage(
        out["pipelined_stage_table"])
    out["serial_flight_record"] = flight_record(
        sides["serial"]["tracer"], sides["serial"]["eng"].counters,
        reason="dispatch_pipeline_serial_leg")
    out["flight_record"] = flight_record(
        sides["pipelined"]["tracer"], sides["pipelined"]["eng"].counters,
        reason="dispatch_pipeline_drill_complete")
    return out


def lane_drill_run(
    params,
    *,
    lanes: int = 4,
    requests_per_pass: int = 96,
    subjects: int = 6,
    workers: int = 8,
    max_rows: int = 4,
    max_bucket: int = 16,
    deadline_s: float = 5.0,
    kill_lane: int = 1,
    lane_failover_budget: float = 0.05,
    seed: int = 0,
    tracer=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """The lane-loss chaos drill.

    One ``ServingEngine(lanes=N)`` on ``device`` (on one card the lanes
    are N streams of it: ``distinct_devices`` says so) is driven by
    ``workers`` concurrent submitters of pose-only requests through
    three passes: a healthy pass, a LOSS pass during which a
    ``%LANE``-tagged chaos plan kills ``kill_lane`` (a persistent error
    on that lane's own call index, and its breaker probe forced false)
    while requests are in flight, and a pass after the fault clears and
    the lane fails back. JAX's criteria (``scripts/bench_report.py:
    judge_lanes``) read the returned numbers:

    * ``futures_resolved_fraction`` == 1.0 with no ``error`` or
      ``stranded`` outcomes: losing a lane cost capacity, not service;
    * ``loss_vs_reference_max_abs_err`` == 0.0: the lanes' results are
      the single-context engine's (same program families; on a card the
      rows of K2 ignore their batchmates, on the CPU the plain forward's
      rows round by batch size, so there a drill holds 0.0 only with
      batches of one request, ``workers=1``);
    * ``cpu_failovers`` == 0: the siblings absorbed the loss (the CPU
      tier is armed on a CPU engine only: a card engine has none);
    * ``steady_recompiles_pre`` == ``steady_recompiles_post`` == 0;
    * every request span closed exactly once (``spans``);
    * the killed lane's re-probe wait grew while it was down
      (``breaker_probe_backoff_grew``).

    Throughput per pass and ``survivor_balance_ratio`` (max/min batches
    placed among the surviving lanes during the loss) are recorded. A
    ``future.cancel()`` probe rides the loss pass. The ``flight_record``
    carries the spans, the breaker transitions and the ladder hops.
    """
    import concurrent.futures as cf
    import threading

    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.health import CircuitBreaker
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    log = _logger(log)
    if tracer is None:
        tracer = Tracer(capacity=65536)
    if kill_lane >= lanes:
        raise ValueError(
            f"kill_lane {kill_lane} out of range for {lanes} lanes")
    dev = resolve_device(device)
    n_joints, n_shape = params.n_joints, params.n_shape
    prm32 = params.astype(torch.float32).to(dev)
    rng = np.random.default_rng(seed)
    subj_betas = [rng.normal(size=(n_shape,)).astype(np.float32)
                  for _ in range(subjects)]

    # One request universe per pass, shared with the reference engine so
    # results compare request for request.
    def make_stream(n, pass_seed):
        r = np.random.default_rng(pass_seed)
        sizes = r.integers(1, max_rows + 1, size=n)
        return [(r.normal(scale=0.4,
                          size=(int(s), n_joints, 3)).astype(np.float32),
                 int(r.integers(0, subjects)))
                for s in sizes]

    streams = {name: make_stream(requests_per_pass, seed + 100 + i)
               for i, name in enumerate(("pre", "loss", "post"))}

    # Reference: the single-context engine (no lanes, no policy) over the
    # same subjects, one request at a time.
    ref_eng = ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                            max_delay_s=0.001, posed_kernel=posed_kernel)
    reference = {}
    with ref_eng:
        ref_keys = [ref_eng.specialize(b) for b in subj_betas]
        for name, stream in streams.items():
            reference[name] = [ref_eng.forward(p, subject=ref_keys[si])
                               for p, si in stream]

    lane_ok = [True] * lanes
    plan = ChaosPlan()
    breaker_proto = CircuitBreaker(
        failure_threshold=2,
        # Tiny but nonzero: re-probes stay fast and the exponential
        # backoff shows in probe_wait_s.
        probe_interval_s=0.001,
        respect_priority_claim=False)
    policy = DispatchPolicy(
        deadline_s=deadline_s, retries=1, backoff_s=0.005,
        backoff_cap_s=0.01, jitter=0.0, breaker=breaker_proto,
        chaos=plan, cpu_fallback=dev.type == "cpu")
    eng = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, max_delay_s=0.002,
        policy=policy, tracer=tracer, lanes=lanes,
        posed_kernel=posed_kernel, lane_probe=lambda i: lane_ok[i])
    resolve_timeout = deadline_s * (policy.retries + 2) * (lanes + 1) + 60.0

    def run_pass(stream, keys, cancel_probe=False):
        """Submit from a worker pool, resolve everything, classify the
        outcomes."""
        outcomes = {"ok": 0, "error": 0, "expired": 0, "stranded": 0,
                    "cancelled": 0}
        results = [None] * len(stream)
        t0 = time.perf_counter()
        lock = threading.Lock()
        cancelled_idx = len(stream) // 2 if cancel_probe else -1

        def submit_one(i):
            p, si = stream[i]
            fut = eng.submit(p, subject=keys[si])
            if i == cancelled_idx:
                fut.cancel()
            try:
                results[i] = fut.result(timeout=resolve_timeout)
                k = "ok"
            except cf.CancelledError:
                k = "cancelled"
            except ServingError as e:
                k = "expired" if e.kind == "expired" else "error"
            except Exception:   # noqa: BLE001 — a timeout IS the bug
                k = "stranded"
            with lock:
                outcomes[k] += 1

        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(submit_one, range(len(stream))))
        return outcomes, results, time.perf_counter() - t0

    def max_err(results, refs, skip=()):
        worst = 0.0
        for i, (got, want) in enumerate(zip(results, refs)):
            if got is None:
                if i in skip:
                    continue
                return None              # an unresolved result: no bar
            worst = max(worst, float(np.abs(got - want).max()))
        return worst

    def lane_block():
        return eng.load()["lanes"]

    try:
        with eng:
            keys = [eng.specialize(b) for b in subj_betas]
            buckets = [b for b in eng.buckets if b <= max_bucket]
            eng.warmup(buckets)
            eng.warmup_posed(buckets)
            warm_compiles = eng.counters.compiles
            log(f"lane drill: {lanes} lanes over "
                f"{eng._get_lanes().n_devices} device(s), "
                f"{warm_compiles} warm-up builds")

            # -- pass 1: healthy steady state ---------------------------
            oc_pre, res_pre, dt_pre = run_pass(streams["pre"], keys)
            recompiles_pre = eng.counters.compiles - warm_compiles
            err_pre = max_err(res_pre, reference["pre"])
            assigned_before_loss = {
                p["lane"]: p["assigned"] for p in lane_block()["per_lane"]}

            # -- pass 2: kill one lane mid-stream ------------------------
            lane_ok[kill_lane] = False
            plan.schedule(f"error@0-%{kill_lane}")
            killed = eng._get_lanes().lanes[kill_lane]
            oc_loss, res_loss, dt_loss = run_pass(
                streams["loss"], keys, cancel_probe=True)
            probes_down = killed.breaker.probes
            backoff_grew = killed.breaker.consecutive_failed_probes >= 1
            probe_wait_down_s = killed.breaker.probe_wait_s()
            snap_loss = lane_block()
            cancelled_i = len(streams["loss"]) // 2
            err_loss = max_err(res_loss, reference["loss"],
                               skip={cancelled_i})

            # -- pass 3: failback ---------------------------------------
            plan.clear()
            lane_ok[kill_lane] = True
            # Settle: the next placements kick the killed lane's re-probe,
            # its breaker closes, traffic returns to it.
            oc_settle, _, _ = run_pass(streams["pre"], keys)
            compiles_settled = eng.counters.compiles
            killed_assigned_settled = lane_block()[
                "per_lane"][kill_lane]["assigned"]
            oc_post, res_post, dt_post = run_pass(streams["post"], keys)
            recompiles_post = eng.counters.compiles - compiles_settled
            err_post = max_err(res_post, reference["post"])
            snap_final = lane_block()
            failback_served = (snap_final["per_lane"][kill_lane]
                               ["assigned"] > killed_assigned_settled)
            counters_snap = eng.counters.snapshot()
    finally:
        plan.release.set()

    per_loss = {p["lane"]: p for p in snap_loss["per_lane"]}
    survivors = [i for i in range(lanes) if i != kill_lane]
    surv_assigned = [per_loss[i]["assigned"] - assigned_before_loss.get(i, 0)
                     for i in survivors]
    balance = (max(surv_assigned) / max(1, min(surv_assigned))
               if surv_assigned else None)
    lane_failovers = sum(p["failovers_out"] for p in snap_final["per_lane"])
    cpu_failovers = sum(p["cpu_failovers"] for p in snap_final["per_lane"])
    # Per-lane availability burn: the share of a lane's batches it could
    # not serve itself, over the failover budget.
    lane_slo = {}
    for p in snap_final["per_lane"]:
        assigned = p["assigned"]
        frac = p["failovers_out"] / assigned if assigned else 0.0
        lane_slo[str(p["lane"])] = {
            "assigned": assigned,
            "failover_fraction": round(frac, 6),
            "burn": round(frac / lane_failover_budget, 4),
            "ok": frac <= lane_failover_budget,
        }

    n_total = 4 * requests_per_pass          # pre + loss + settle + post
    outcomes = {k: oc_pre[k] + oc_loss[k] + oc_settle[k] + oc_post[k]
                for k in oc_pre}
    resolved = n_total - outcomes["stranded"]
    acc = tracer.accounting()

    def rate(oc, dt):
        return float(f"{(requests_per_pass - oc.get('stranded', 0)) / dt:.5g}")

    return {
        "lanes": lanes,
        "distinct_devices": snap_final["n_devices"],
        "device": str(dev),
        "posed_kernel": posed_kernel,
        "kill_lane": kill_lane,
        "requests_per_pass": requests_per_pass,
        "workers": workers,
        "subjects": subjects,
        "futures_resolved_fraction": float(f"{resolved / n_total:.6g}"),
        "outcomes": outcomes,
        "pre_vs_reference_max_abs_err": err_pre,
        "loss_vs_reference_max_abs_err": err_loss,
        "post_vs_reference_max_abs_err": err_post,
        "steady_recompiles_pre": int(recompiles_pre),
        "steady_recompiles_post": int(recompiles_post),
        "warmup_compiles": int(warm_compiles),
        "lane_failovers": int(lane_failovers),
        "cpu_failovers": int(cpu_failovers),
        "killed_lane_assigned_during_loss": int(
            per_loss[kill_lane]["assigned"]
            - assigned_before_loss.get(kill_lane, 0)),
        "survivor_balance_ratio": (float(f"{balance:.4g}")
                                   if balance is not None else None),
        "throughput_pre_per_sec": rate(oc_pre, dt_pre),
        "throughput_loss_per_sec": rate(oc_loss, dt_loss),
        "throughput_post_per_sec": rate(oc_post, dt_post),
        "surviving_throughput_ratio": (float(f"{dt_pre / dt_loss:.4g}")
                                       if dt_loss else None),
        "breaker_probes_while_down": int(probes_down),
        "breaker_probe_backoff_grew": bool(backoff_grew),
        "breaker_probe_wait_down_s": float(f"{probe_wait_down_s:.4g}"),
        "failback_served": bool(failback_served),
        "cancelled": int(counters_snap["cancelled"]),
        "lane_slo": lane_slo,
        "lanes_detail": snap_final,
        "spans": {
            "started": acc["spans_started"],
            "closed": acc["spans_closed"],
            "open": acc["spans_open"],
            "closed_by_kind": acc["closed_by_kind"],
        },
        "flight_record": flight_record(
            tracer, eng.counters, reason="lane_drill_complete"),
    }


_STORE_DELTAS = ("subject_store_hot_hits", "subject_store_warm_hits",
                 "subject_store_cold_hits", "subject_store_misses",
                 "subject_store_prefetches", "subject_store_demotions_warm",
                 "subject_store_demotions_cold")


def subject_store_drill_run(
    params,
    *,
    subjects: int = 100_000,
    requests_per_leg: int = 120,
    lanes: int = 2,
    max_subjects: int = 32,
    warm_capacity: int = 64,
    max_rows: int = 2,
    max_bucket: int = 8,
    zipf_a: float = 1.2,
    max_delay_s: float = 0.003,
    workers: int = 8,
    pair_slice: int = 20,
    seed: int = 0,
    cold_dir: Optional[str] = None,
    backend: Optional[str] = None,
    tracer=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """The tiered subject store's capacity drill, sharded against
    replicated.

    ``subjects`` identities (100k by default) are REGISTERED (betas only,
    never bulk-baked) on two lane engines on ``device`` and driven
    through the capacity ladder under Zipf traffic: **hot_only** (the
    working set fits the device table, pre-filled to capacity before the
    warm-up, so nothing builds or promotes in traffic), **warm_spill**
    (evictions demote rows to pinned host memory and later dispatches
    promote them back, prefetched at coalesce admit) and **cold_spill**
    (Zipf over the whole universe: warm overflow pages rows to disk and
    deep-tail requests page them back, or re-bake on a miss, counted).
    Each leg's stream is cut into slices run in turns on the SHARDED
    engine (N lanes holding N disjoint shard tables through the store)
    and a REPLICATED twin (the same lanes, no store), so the throughput
    ratio and the per-lane device rows are paired. A cold-revisit leg
    pulls evicted-everywhere subjects back through the cold tier, and a
    DAMAGE PROBE rewrites one cold page as a self-consistent page of the
    wrong subject: its load must degrade to a counted re-bake
    (``subject_store_cold_damage``) with a correct result.

    JAX's criteria (``scripts/bench_report.py:judge_subject_store``) read
    the returned numbers: every leg equal to a single-context reference
    (0.0) on both engines — on the CPU with batches of one request
    (``workers=1``), since the plain forward's rows round by batch size
    there —, every future resolved, the hot tier's hit rate, the
    promotion stall inside the coalesce window, zero steady builds on
    either engine, the damaged page counted and re-baked, per-lane device
    rows strictly below the replicated twin's, every span closed once.
    """
    import concurrent.futures as cf
    import tempfile
    import threading

    from mano_hand_tpu_torch.io import state_ckpt
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError
    from mano_hand_tpu_torch.serving.subject_store import (
        SubjectStore, SubjectStoreConfig,
    )

    log = _logger(log)
    if tracer is None:
        tracer = Tracer(capacity=65536)
    dev = resolve_device(device)
    n_joints, n_shape = params.n_joints, params.n_shape
    prm32 = params.astype(torch.float32).to(dev)
    rng = np.random.default_rng(seed)
    universe = rng.normal(size=(subjects, n_shape)).astype(np.float32)

    tmp = None
    if cold_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="mano_subject_store_")
        cold_dir = tmp.name

    # The ladder's working sets (universe index ranges).
    hot_n = max_subjects
    warm_n = min(subjects, max_subjects + max(8, warm_capacity // 2))

    def make_stream(n, leg_universe, pass_seed):
        r = np.random.default_rng(pass_seed)
        idx = (r.zipf(zipf_a, size=n).astype(np.int64) - 1) % leg_universe
        sizes = r.integers(1, max_rows + 1, size=n)
        return [(r.normal(scale=0.4,
                          size=(int(s), n_joints, 3)).astype(np.float32),
                 int(i))
                for s, i in zip(sizes, idx)]

    legs = ("hot_only", "warm_spill", "cold_spill")
    streams = {
        "hot_only": make_stream(requests_per_leg, hot_n, seed + 101),
        "warm_spill": make_stream(requests_per_leg, warm_n, seed + 102),
        "cold_spill": make_stream(requests_per_leg, subjects, seed + 103),
    }

    # Reference first: the single-context engine, subjects baked on
    # demand.
    reference = {}
    ref_eng = ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                            max_delay_s=0.001, posed_kernel=posed_kernel)
    with ref_eng:
        ref_keys = {}

        def ref_forward(pose, si):
            if si not in ref_keys:
                ref_keys[si] = ref_eng.specialize(universe[si])
            return ref_eng.forward(pose, subject=ref_keys[si])

        for name in legs:
            reference[name] = [ref_forward(p, si)
                               for p, si in streams[name]]

    store = SubjectStore(SubjectStoreConfig(
        warm_capacity=warm_capacity, cold_dir=cold_dir,
        sharded=True, backend=backend))
    eng_s = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, max_subjects=max_subjects,
        max_delay_s=max_delay_s, lanes=lanes, tracer=tracer,
        posed_kernel=posed_kernel, subject_store=store)
    eng_r = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, max_subjects=max_subjects,
        max_delay_s=max_delay_s, lanes=lanes, posed_kernel=posed_kernel)
    resolve_timeout = 120.0

    def run_slice(eng, keys, stream, outcomes, results, base):
        lock = threading.Lock()

        def submit_one(j):
            p, si = stream[j]
            fut = eng.submit(p, subject=keys[si])
            try:
                results[base + j] = fut.result(timeout=resolve_timeout)
                k = "ok"
            except ServingError as e:
                k = "expired" if e.kind == "expired" else "error"
            except Exception:   # noqa: BLE001 — a timeout IS the bug
                k = "stranded"
            with lock:
                outcomes[k] += 1

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(submit_one, range(len(stream))))
        return time.perf_counter() - t0

    def max_err(results, refs):
        worst = 0.0
        for got, want in zip(results, refs):
            if got is None:
                return None          # an unresolved result: no bar
            worst = max(worst, float(np.abs(got - want).max()))
        return worst

    leg_out = {}
    damage = {}
    revisit = []
    try:
        with eng_s, eng_r:
            t_reg = time.perf_counter()
            keys_s = eng_s.register_subjects(universe)
            keys_r = eng_r.register_subjects(universe)
            register_s = time.perf_counter() - t_reg
            if keys_s != keys_r:
                raise RuntimeError("content-addressed keys differ")
            # Fill the hot tier to capacity, then warm: every table (and
            # every shard table) has its final shape before any program
            # is built, so the ladder runs with zero steady builds.
            for i in range(hot_n):
                eng_s.specialize(universe[i])
                eng_r.specialize(universe[i])
            buckets = [b for b in eng_s.buckets if b <= max_bucket]
            for e in (eng_s, eng_r):
                e.warmup(buckets)
                e.warmup_posed(buckets)
            warm_compiles_s = eng_s.counters.compiles
            warm_compiles_r = eng_r.counters.compiles
            log(f"subject-store drill: {subjects} registered subjects, "
                f"hot={max_subjects} warm={warm_capacity} lanes={lanes} "
                f"sharded vs replicated, {warm_compiles_s} warm-up builds "
                "(sharded)")

            dt_s_total = dt_r_total = 0.0
            oc_s = {"ok": 0, "error": 0, "expired": 0, "stranded": 0}
            oc_r = dict(oc_s)
            paired0 = [e.counters.snapshot() for e in (eng_s, eng_r)]
            for name in legs:
                stream = streams[name]
                res_s = [None] * len(stream)
                res_r = [None] * len(stream)
                dt_s = dt_r = 0.0
                before = eng_s.counters.snapshot()
                for base in range(0, len(stream), pair_slice):
                    sl = stream[base:base + pair_slice]
                    dt_s += run_slice(eng_s, keys_s, sl, oc_s, res_s, base)
                    dt_r += run_slice(eng_r, keys_r, sl, oc_r, res_r, base)
                dt_s_total += dt_s
                dt_r_total += dt_r
                after = eng_s.counters.snapshot()
                leg_out[name] = {
                    "requests": len(stream),
                    "distinct_subjects": len({si for _, si in stream}),
                    "sharded_vs_reference_max_abs_err": max_err(
                        res_s, reference[name]),
                    "replicated_vs_reference_max_abs_err": max_err(
                        res_r, reference[name]),
                    "throughput_sharded_per_sec": (
                        float(f"{len(stream) / dt_s:.5g}") if dt_s
                        else None),
                    "throughput_replicated_per_sec": (
                        float(f"{len(stream) / dt_r:.5g}") if dt_r
                        else None),
                    "store_deltas": {k: after[k] - before[k]
                                     for k in _STORE_DELTAS},
                }
                log(f"  leg {name}: {leg_out[name]['distinct_subjects']} "
                    f"subjects, err_s="
                    f"{leg_out[name]['sharded_vs_reference_max_abs_err']}")

            # What the paired legs cost each engine in dispatches: a
            # sharded engine splits coalesced windows by owner lane.
            paired = {
                side: {k: e.counters.snapshot()[k] - before[k]
                       for k in ("dispatches", "requests_dispatched")}
                for side, e, before in zip(("sharded", "replicated"),
                                           (eng_s, eng_r), paired0)}
            for side in paired.values():
                side["coalesce_width_mean"] = round(
                    side["requests_dispatched"] / max(1, side["dispatches"]),
                    3)

            # -- cold revisit: organic cold hits --------------------------
            # The inclusive tiers can serve every paired leg out of hot
            # and warm; pull a few evicted-everywhere digests back through
            # the live engine so the cold tier serves real requests.
            with eng_s._lock:
                hot_now = set(eng_s._subject_slots)
            warm_now = set(store.warm_digests())
            cold_only = [d for d in store.cold_digests()
                         if d not in hot_now and d not in warm_now]
            revisit = cold_only[:max(1, requests_per_leg // 4)]
            ref2 = ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                                 max_delay_s=0.001,
                                 posed_kernel=posed_kernel)
            with ref2:
                if revisit:
                    rv_before = eng_s.counters.snapshot()
                    pose_rv = rng.normal(
                        scale=0.4, size=(1, n_joints, 3)).astype(np.float32)
                    rv_err = 0.0
                    t0_rv = time.perf_counter()
                    for d in revisit:
                        got = eng_s.submit(
                            pose_rv, subject=d).result(
                                timeout=resolve_timeout)
                        oc_s["ok"] += 1
                        want = ref2.forward(pose_rv, subject=ref2.specialize(
                            universe[keys_s.index(d)]))
                        rv_err = max(rv_err, float(
                            np.abs(np.asarray(got) - want).max()))
                    dt_rv = time.perf_counter() - t0_rv
                    rv_after = eng_s.counters.snapshot()
                    leg_out["cold_revisit"] = {
                        "requests": len(revisit),
                        "distinct_subjects": len(revisit),
                        "sharded_vs_reference_max_abs_err": rv_err,
                        "throughput_sharded_per_sec": (
                            float(f"{len(revisit) / dt_rv:.5g}") if dt_rv
                            else None),
                        "store_deltas": {k: rv_after[k] - rv_before[k]
                                         for k in _STORE_DELTAS},
                    }

                # -- damage probe: one cold page rewritten in place --------
                # From the cold remainder not revisited (a revisited digest
                # is served again without its page).
                with eng_s._lock:
                    hot_now = set(eng_s._subject_slots)
                warm_now = set(store.warm_digests())
                rv_set = set(revisit)
                victims = [d for d in store.cold_digests()
                           if d not in hot_now and d not in warm_now
                           and d not in rv_set]
                if victims:
                    vd = victims[0]
                    vi = keys_s.index(vd)
                    _, arrays = state_ckpt.load_row_page(vd, cold_dir)
                    # A self-consistent page of the WRONG subject: its row
                    # hashes verify, its digest preimage does not.
                    arrays["shape"] = np.asarray(arrays["shape"]) + 1.0
                    state_ckpt.save_row_page(vd, arrays, cold_dir)
                    dmg_before = eng_s.counters.snapshot()[
                        "subject_store_cold_damage"]
                    pose = rng.normal(
                        scale=0.4, size=(1, n_joints, 3)).astype(np.float32)
                    want = ref2.forward(
                        pose, subject=ref2.specialize(universe[vi]))
                    got = eng_s.submit(pose, subject=vd).result(
                        timeout=resolve_timeout)
                    oc_s["ok"] += 1
                    dmg_after = eng_s.counters.snapshot()[
                        "subject_store_cold_damage"]
                    damage = {
                        "injected": True,
                        "damage_counted": int(dmg_after - dmg_before),
                        "request_max_abs_err": float(
                            np.abs(np.asarray(got) - want).max()),
                    }
                else:
                    damage = {"injected": False}

            steady_recompiles_s = eng_s.counters.compiles - warm_compiles_s
            steady_recompiles_r = eng_r.counters.compiles - warm_compiles_r
            counters_snap = eng_s.counters.snapshot()
            load_s = eng_s.load()
            load_r = eng_r.load()
    finally:
        if tmp is not None:
            tmp.cleanup()

    lookups = sum(counters_snap[k] for k in (
        "subject_store_hot_hits", "subject_store_warm_hits",
        "subject_store_cold_hits", "subject_store_misses"))
    hot_rate = (counters_snap["subject_store_hot_hits"] / lookups
                if lookups else None)
    prom = counters_snap["subject_store_promotion_ms"]
    rows_s = [p["table_capacity"] for p in load_s["lanes"]["per_lane"]]
    rows_r = [p["table_capacity"] for p in load_r["lanes"]["per_lane"]]
    n_paired = len(legs) * requests_per_leg
    n_total = n_paired + len(revisit) + (1 if damage.get("injected") else 0)
    resolved = n_total - oc_s["stranded"]
    acc = tracer.accounting()
    return {
        "subjects_registered": int(subjects),
        "register_seconds": register_s,
        "lanes": int(lanes),
        "device": str(dev),
        "posed_kernel": posed_kernel,
        "workers": int(workers),
        "hot_capacity": int(max_subjects),
        "warm_capacity": int(warm_capacity),
        "zipf_a": float(zipf_a),
        "coalesce_window_ms": float(max_delay_s * 1e3),
        "requests_total": int(n_total),
        "futures_resolved_fraction": float(f"{resolved / n_total:.6g}"),
        "outcomes": oc_s,
        "outcomes_replicated": oc_r,
        "legs": leg_out,
        "damage_probe": damage,
        "hot_tier_hit_rate": (None if hot_rate is None
                              else float(f"{hot_rate:.6g}")),
        "store_counters": {
            k: counters_snap[k] for k in (
                "subject_store_hot_hits", "subject_store_warm_hits",
                "subject_store_cold_hits", "subject_store_misses",
                "subject_store_prefetches", "subject_store_promotions",
                "subject_store_demotions_warm",
                "subject_store_demotions_cold",
                "subject_store_cold_damage")},
        "promotion_stall_ms": prom,
        "promotion_p99_within_window": bool(
            prom["n"] == 0 or prom["p99_ms"] <= max_delay_s * 1e3),
        "steady_recompiles": int(steady_recompiles_s),
        "steady_recompiles_replicated": int(steady_recompiles_r),
        "per_lane_device_rows_sharded": rows_s,
        "per_lane_device_rows_replicated": rows_r,
        "device_rows_ratio": (float(f"{max(rows_s) / max(rows_r):.4g}")
                              if rows_r and max(rows_r) else None),
        "throughput_sharded_per_sec": (
            float(f"{n_paired / dt_s_total:.5g}") if dt_s_total else None),
        "throughput_replicated_per_sec": (
            float(f"{n_paired / dt_r_total:.5g}") if dt_r_total else None),
        "paired_throughput_ratio": (
            float(f"{dt_r_total / dt_s_total:.4g}")
            if dt_s_total and dt_r_total else None),
        "paired_dispatches": paired,
        "subject_store": load_s["subject_store"],
        "lanes_sharded": bool(load_s["lanes"].get("sharded")),
        "platform": dev.type,
        "spans": {
            "started": acc["spans_started"],
            "closed": acc["spans_closed"],
            "open": acc["spans_open"],
            "closed_by_kind": acc["closed_by_kind"],
        },
        "flight_record": flight_record(
            tracer, eng_s.counters, reason="subject_store_drill_complete"),
    }


# ------------------------------------------------- the benchmark protocols
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _derived_snapshot(eng, latencies: Optional[dict] = None) -> dict:
    """The engine counters' snapshot with JAX's derived serving keys the
    port's counters do not keep: ``padding_waste`` (JAX's formula,
    rows_padded / (rows_live + rows_padded), from the same snapshot) and,
    given ``latencies`` ({bucket: [seconds]}), ``latency_by_bucket`` as
    JAX's {bucket: {p50_ms, p99_ms, n}} — read here per request, keyed by
    the bucket its own rows pad to (the port's counters keep no
    per-bucket reservoir)."""
    snap = eng.counters.snapshot()
    live, padded = snap["rows_live"], snap["rows_padded"]
    snap["padding_waste"] = round(
        padded / (live + padded) if live + padded else 0.0, 4)
    if latencies is not None:
        snap["latency_by_bucket"] = {
            b: {"p50_ms": float(np.percentile(s, 50) * 1e3),
                "p99_ms": float(np.percentile(s, 99) * 1e3),
                "n": len(s)}
            for b, s in sorted(latencies.items()) if s}
    return snap


def _bench_inputs(params, subjects: int, requests: int, min_rows: int,
                  max_rows: int, max_bucket: int, seed: int):
    """The mixed-subject pose-only stream of the coalesce, posed-kernel
    and precision protocols: JAX's draws from ``default_rng(seed)`` in
    JAX's order. Returns (rng, betas, sizes, stream)."""
    max_rows = min(max_rows, max_bucket)
    min_rows = max(1, min(min_rows, max_rows))
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    betas = [rng.normal(size=(n_shape,)).astype(np.float32)
             for _ in range(subjects)]
    sizes = rng.integers(min_rows, max_rows + 1, size=requests)
    subj_of = rng.integers(0, subjects, size=requests)
    stream = [
        (rng.normal(scale=0.4,
                    size=(int(n), n_joints, 3)).astype(np.float32), int(s))
        for n, s in zip(sizes, subj_of)
    ]
    return rng, betas, sizes, stream


def _posed_reference(prm_dev, betas, buckets):
    """The per-subject posed program at each request's padded bucket
    (``core.specialize`` + ``core.forward_posed_batched``, plain PyTorch
    on the params' device): the split baseline and the parity reference
    of the gathered protocols. Returns ``ref_one(pose, si)`` -> host verts
    of the request's live rows."""
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import ieee_fp32
    from mano_hand_tpu_torch.serving import buckets as bucket_mod

    dev = prm_dev.device
    with torch.no_grad(), ieee_fp32():
        shaped = [core.specialize(prm_dev, torch.from_numpy(b).to(dev))
                  for b in betas]

    def ref_one(pose, si):
        b = bucket_mod.bucket_for(pose.shape[0], buckets)
        with torch.no_grad(), ieee_fp32():
            out = core.forward_posed_batched(shaped[si], torch.from_numpy(
                np.ascontiguousarray(bucket_mod.pad_rows(pose, b))).to(dev))
            return out.verts.cpu().numpy()[:pose.shape[0]]

    return ref_one


def measure_overhead(
    engine,
    direct: Callable[[np.ndarray, np.ndarray], None],
    fixed: Sequence,
    trials: int = 7,
) -> dict:
    """Interleaved engine-vs-direct timing over fixed-size batches.

    ``fixed`` is a list of (pose, shape) request pairs, every one at the
    SAME batch size (the warm bucket); ``direct`` runs one pair through
    the direct path and blocks until done. Returns engine/direct rates
    (evals/s, fastest trial), the headline ratio from those SAME fastest
    trials (min-time is the stable estimator on a drifting machine, and
    the headline ratio must be the quotient of the two rates printed
    next to it), plus the per-trial ratios and their median for the
    noise record. Which side goes first alternates per trial: a monotone
    drift otherwise lands on the same side every trial.
    """
    rows = sum(p.shape[0] for p, _ in fixed)
    ratios: List[float] = []
    dt_e_best = dt_d_best = float("inf")

    def run_engine():
        t0 = time.perf_counter()
        futs = [engine.submit(p, s) for p, s in fixed]
        for f in futs:
            f.result()
        return time.perf_counter() - t0

    def run_direct():
        t0 = time.perf_counter()
        for p, s in fixed:
            direct(p, s)
        return time.perf_counter() - t0

    for t in range(max(1, trials)):
        if t % 2 == 0:
            dt_e, dt_d = run_engine(), run_direct()
        else:
            dt_d, dt_e = run_direct(), run_engine()
        ratios.append(dt_d / dt_e)
        dt_e_best = min(dt_e_best, dt_e)
        dt_d_best = min(dt_d_best, dt_d)
    return {
        "engine_fixed_evals_per_sec": float(f"{rows / dt_e_best:.5g}"),
        "direct_evals_per_sec": float(f"{rows / dt_d_best:.5g}"),
        "engine_vs_direct_ratio": float(f"{dt_d_best / dt_e_best:.4g}"),
        "ratio_median": float(f"{float(np.median(ratios)):.4g}"),
        "ratio_trials": [float(f"{r:.3g}") for r in ratios],
    }


def serve_bench_run(
    params,
    *,
    requests: int = 192,
    min_rows: int = 1,
    max_rows: int = 32,
    max_bucket: int = 64,
    max_delay_s: float = 0.002,
    aot_dir=None,
    seed: int = 0,
    trials: int = 7,
    policy=None,
    tracer=None,
    metrics=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """THE serving benchmark protocol of ``serve-bench``: a ragged stream
    of full requests through one engine on ``device``.

    Phases: warm every bucket; probe the engine against the direct call
    (``core.forward_batched`` on the same device — the plain forward the
    engine's full family serves); settle the pipeline with one ragged
    pass; time a second ragged pass (``engine_evals_per_sec``) and count
    steady builds; then the fixed-warm-bucket overhead bound via
    ``measure_overhead``. The fixed requests are exactly the LARGEST
    bucket — coalescing cannot merge two of them, so each dispatch is
    one request at one batch size, directly comparable to a direct call
    at that size. ``policy`` runs the protocol under supervised dispatch
    (``serve-bench --chaos PLAN``); ``metrics`` (an
    ``obs.MetricsRegistry``) gets the engine's collectors, the caller
    owning scrape and export. Returns JAX's keys (the counters' snapshot
    of the ragged stream among them). Raises on engine failure.
    """
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import ieee_fp32, resolve_device
    from mano_hand_tpu_torch.serving import buckets as bucket_mod
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    max_rows = min(max_rows, max_bucket)
    min_rows = max(1, min(min_rows, max_rows))
    dev = resolve_device(device)
    # The asset's own joint/shape dims: SMPL-family body assets serve
    # through the same engine.
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    sizes = rng.integers(min_rows, max_rows + 1, size=requests)
    stream = [
        (rng.normal(scale=0.4, size=(n, n_joints, 3)).astype(np.float32),
         rng.normal(size=(n, n_shape)).astype(np.float32))
        for n in (int(s) for s in sizes)
    ]
    log = _logger(log)
    eng = ServingEngine(params, device=dev, max_bucket=max_bucket,
                        max_delay_s=max_delay_s, aot_dir=aot_dir,
                        policy=policy, tracer=tracer,
                        posed_kernel=posed_kernel)
    if metrics is not None:
        from mano_hand_tpu_torch.obs.metrics import (
            register_engine_collectors,
        )

        register_engine_collectors(metrics, eng, tracer=tracer)

    latencies: dict = {}

    def run_stream(record=False):
        futs = []
        for p, s in stream:
            t_sub = time.perf_counter()
            f = eng.submit(p, s)
            if record:
                b = bucket_mod.bucket_for(p.shape[0], eng.buckets)
                f.add_done_callback(
                    lambda _f, b=b, t_sub=t_sub: latencies.setdefault(
                        b, []).append(time.perf_counter() - t_sub))
            futs.append(f)
        for f in futs:
            f.result()

    prm_dev = params.astype(torch.float32).to(dev)

    def direct_out(p, s):
        with torch.no_grad(), ieee_fp32():
            return core.forward_batched(prm_dev, torch.from_numpy(p).to(dev),
                                        torch.from_numpy(s).to(dev)).verts

    def direct(p, s):
        direct_out(p, s)
        _sync(dev)

    with eng:
        log(f"serving: warming buckets {eng.buckets}")
        eng.warmup()
        # Numerics probe in the same process and device as the timed
        # path: the engine's programs against the direct call.
        probe_p, probe_s = stream[0]
        got = eng.forward(probe_p, probe_s)
        want = direct_out(probe_p, probe_s).cpu().numpy()
        numerics_err = float(np.abs(got - want).max())
        run_stream()                       # settle the pipeline
        compiles_warm = eng.counters.compiles
        t0 = time.perf_counter()
        run_stream(record=True)            # the measured steady pass
        dt = time.perf_counter() - t0
        steady_recompiles = eng.counters.compiles - compiles_warm
        # Snapshot HERE: the counters describe the RAGGED stream, not the
        # fixed-bucket burst below.
        snapshot = _derived_snapshot(eng, latencies)

        warm_bucket = eng.buckets[-1]
        fixed = [
            (rng.normal(scale=0.4,
                        size=(warm_bucket, n_joints, 3)).astype(np.float32),
             rng.normal(size=(warm_bucket, n_shape)).astype(np.float32))
            for _ in range(max(24, requests // 4))
        ]
        eng.forward(*fixed[0])             # settle
        direct(*fixed[0])
        overhead = measure_overhead(eng, direct, fixed, trials=trials)

    out = {
        "engine_evals_per_sec": float(f"{float(sizes.sum()) / dt:.5g}"),
        **overhead,
        "engine_vs_direct_max_abs_err": numerics_err,
        "warm_bucket": warm_bucket,
        "steady_recompiles": int(steady_recompiles),
        "requests": int(requests),
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng.buckets),
        **snapshot,
    }
    if tracer is not None:
        out["flight_record"] = flight_record(
            tracer, eng.counters, reason="serve_bench_complete")
    return out


def coalesce_bench_run(
    params,
    *,
    subjects: int = 8,
    requests: int = 96,
    min_rows: int = 1,
    max_rows: int = 4,
    max_bucket: int = 64,
    max_delay_s: float = 0.002,
    seed: int = 0,
    trials: int = 7,
    max_subjects=None,
    policy=None,
    tracer=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """THE mixed-subject coalescing protocol of ``serve-bench
    --subjects``.

    ``subjects`` users, each with their own baked betas, submit small
    pose-only requests in one interleaved stream. The ENGINE side
    coalesces them into gathered mixed-subject dispatches (the plain
    gathered program, or K2 under ``posed_kernel="fused"``); the SPLIT
    side is one per-subject posed dispatch per request
    (``core.specialize`` + ``core.forward_posed_batched`` padded to its
    bucket, blocking). Both sides run warm and are timed interleaved,
    min over trials.

    Returned criteria (JAX's keys):

    * ``engine_vs_split_ratio`` (JAX's bar: >= 1.3 on >= 8 subjects);
    * ``gather_vs_posed_max_abs_err``: the gathered engine path against
      the per-subject posed program at the same padded size, probed
      through the live engine — 0.0 for the plain family, within 1e-5
      for K2;
    * ``steady_recompiles`` == 0 after warm-up and table growth.
    """
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if subjects < 1:
        raise ValueError(f"subjects must be >= 1, got {subjects}")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    dev = resolve_device(device)
    _, betas, sizes, stream = _bench_inputs(
        params, subjects, requests, min_rows, max_rows, max_bucket, seed)
    log = _logger(log)
    if tracer is None:
        tracer = Tracer()
    kw = {} if max_subjects is None else {"max_subjects": max_subjects}
    eng = ServingEngine(params, device=dev, max_bucket=max_bucket,
                        max_delay_s=max_delay_s, policy=policy,
                        tracer=tracer, posed_kernel=posed_kernel, **kw)
    ref_one = _posed_reference(params.astype(torch.float32).to(dev), betas,
                               eng.buckets)

    ratios: List[float] = []
    dt_e_best = dt_s_best = float("inf")
    with eng:
        keys = [eng.specialize(b) for b in betas]
        log(f"coalesce: {subjects} subjects baked "
            f"({eng.counters.table_growths} table growths), "
            f"warming buckets {eng.buckets}")
        eng.warmup_posed()
        for b in eng.buckets:   # warm the split side's buckets too
            ref_one(np.zeros((b, params.n_joints, 3), np.float32), 0)
        gerr = 0.0
        for pose, si in stream[:min(8, len(stream))]:
            got = eng.forward(pose, subject=keys[si])
            gerr = max(gerr, float(np.abs(got - ref_one(pose, si)).max()))

        def run_engine():
            t0 = time.perf_counter()
            futs = [eng.submit(p, subject=keys[si]) for p, si in stream]
            for f in futs:
                f.result()
            return time.perf_counter() - t0

        def run_split():
            t0 = time.perf_counter()
            for p, si in stream:
                ref_one(p, si)
            return time.perf_counter() - t0

        run_engine()
        run_split()             # settle both sides outside the timing
        compiles_warm = eng.counters.compiles
        for t in range(max(1, trials)):
            if t % 2 == 0:
                dt_e, dt_s = run_engine(), run_split()
            else:
                dt_s, dt_e = run_split(), run_engine()
            ratios.append(dt_s / dt_e)
            dt_e_best = min(dt_e_best, dt_e)
            dt_s_best = min(dt_s_best, dt_s)
        steady_recompiles = eng.counters.compiles - compiles_warm
        snapshot = _derived_snapshot(eng)

    rows_total = int(sizes.sum())
    log(f"coalesce: engine {rows_total / dt_e_best:,.0f} vs split "
        f"{rows_total / dt_s_best:,.0f} evals/s "
        f"({dt_s_best / dt_e_best:.2f}x), width "
        f"{snapshot['coalesce_width_mean']}, gather err {gerr:.1e}")
    return {
        "subjects": int(subjects),
        "requests": int(requests),
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng.buckets),
        "engine_evals_per_sec": float(f"{rows_total / dt_e_best:.5g}"),
        "split_evals_per_sec": float(f"{rows_total / dt_s_best:.5g}"),
        "engine_vs_split_ratio": float(f"{dt_s_best / dt_e_best:.4g}"),
        "ratio_median": float(f"{float(np.median(ratios)):.4g}"),
        "ratio_trials": [float(f"{r:.3g}") for r in ratios],
        "gather_vs_posed_max_abs_err": gerr,
        "steady_recompiles": int(steady_recompiles),
        "table_growths": snapshot["table_growths"],
        "specializations_evicted": snapshot["specializations_evicted"],
        "coalesce_overflows": snapshot["coalesce_overflows"],
        "mixed_subject_batches": snapshot["mixed_subject_batches"],
        "coalesce_width_mean": snapshot["coalesce_width_mean"],
        "padding_waste": snapshot["padding_waste"],
        "dispatches": snapshot["dispatches"],
        "flight_record": flight_record(
            tracer, eng.counters, reason="coalesce_drill_complete"),
    }


def _slope_best(thunks: dict, trials: int) -> tuple:
    """Run the four slope points interleaved, alternating order per
    trial; returns (min per point, the per-trial points)."""
    best = {k: float("inf") for k in thunks}
    per_trial = []
    for t in range(max(1, trials)):
        order = sorted(thunks) if t % 2 == 0 \
            else sorted(thunks, reverse=True)
        got = {}
        for k in order:
            got[k] = thunks[k]()
            best[k] = min(best[k], got[k])
        per_trial.append(got)
    return best, per_trial


def posed_kernel_bench_run(
    params,
    *,
    subjects: int = 8,
    requests: int = 96,
    min_rows: int = 1,
    max_rows: int = 4,
    max_bucket: int = 64,
    max_delay_s: float = 0.002,
    seed: int = 0,
    trials: int = 5,
    lm_batch: int = 32,
    lm_steps: Sequence[int] = (4, 10),
    lm_iters: int = 3,
    trace_dir=None,
    device=None,
    posed_kernel: str = "fused",
    log: Callable[[str], None] = None,
) -> dict:
    """THE gathered-kernel-vs-plain benchmark protocol, measured where it
    serves: the SAME mixed-subject pose-only stream drives TWO engines on
    ``device`` — one on ``posed_kernel`` (default ``"fused"``: K2 on a
    card, K2's plain version on the CPU), the control on the plain
    gathered program (``"xla"``) — SLOPE-TIMED through the engines
    (t(all requests) minus t(half), so the fixed submit/coalesce/
    dispatcher cost both sides share cancels), the four timing points
    interleaved per trial with alternating order and min over trials per
    point.

    Returned criteria (JAX's keys, plus ``ratio_trials``: each trial's
    own slope ratio, and ``xla_vs_gather_matched_max_abs_err``):

    * ``fused_vs_gather_max_abs_err`` <= 1e-5 — the kernel side's rows
      against the per-subject posed program at the request's padded
      size, through the live engine, sequential requests and a coalesced
      mixed-subject burst;
    * ``xla_vs_gather_matched_max_abs_err`` == 0.0 — the control side on
      the sequential requests alone, each served at the reference's own
      bucket (JAX's bit-identity contract, at matched padded size);
      ``xla_vs_gather_max_abs_err`` adds the burst, whose coalesced
      batches ride larger buckets than the reference's: the plain
      gathered program's rows round by the batch they ride in (~1e-8,
      on the card as on the CPU), where JAX's XLA rows read 0.0;
    * ``steady_recompiles_fused`` == ``steady_recompiles_xla`` == 0;
    * ``fused_vs_xla_ratio`` — the headline speed number, meaningful on
      a card only: on the CPU both sides run plain PyTorch, and
      ``interpret`` says so (True on a CPU engine, where K2's plain
      version ran; False on a card, where K2 ran).

    The ``lm_e2e_*`` sub-leg rides along: end-to-end ``fit_lm`` steps/s
    on ``lm_batch`` problems, slope-timed over ``lm_steps``
    (``lm_batch=0`` skips it). ``trace_dir`` exports the kernel engine's
    timeline and flight record into ``<trace_dir>/posed_kernel/``.
    """
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import ieee_fp32, resolve_device
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if subjects < 1:
        raise ValueError(f"subjects must be >= 1, got {subjects}")
    if requests < 2:
        raise ValueError(f"requests must be >= 2, got {requests}")
    log = _logger(log)
    dev = resolve_device(device)
    n_joints, n_shape = params.n_joints, params.n_shape
    rng, betas, sizes, stream = _bench_inputs(
        params, subjects, requests, min_rows, max_rows, max_bucket, seed)
    # The two slope points: the full stream and its first half (the same
    # request mix over the shared prefix).
    m1 = max(1, requests // 2)
    m2 = requests
    rows_m1 = int(sizes[:m1].sum())
    rows_m2 = int(sizes.sum())
    d_rows = rows_m2 - rows_m1

    tracer_f, tracer_x = Tracer(), Tracer()
    eng_f = ServingEngine(params, device=dev, max_bucket=max_bucket,
                          max_delay_s=max_delay_s, tracer=tracer_f,
                          posed_kernel=posed_kernel)
    eng_x = ServingEngine(params, device=dev, max_bucket=max_bucket,
                          max_delay_s=max_delay_s, tracer=tracer_x,
                          posed_kernel="xla")
    prm_dev = params.astype(torch.float32).to(dev)
    ref_one = _posed_reference(prm_dev, betas, eng_f.buckets)

    def run_stream(eng, keys, m):
        t0 = time.perf_counter()
        futs = [eng.submit(p, subject=keys[si]) for p, si in stream[:m]]
        for f in futs:
            f.result()
        return time.perf_counter() - t0

    results = {}
    with eng_f, eng_x:
        keys_f = [eng_f.specialize(b) for b in betas]
        keys_x = [eng_x.specialize(b) for b in betas]
        log(f"posed-kernel: {subjects} subjects baked on both engines, "
            f"warming buckets {eng_f.buckets}")
        src_f = eng_f.warmup_posed()
        eng_x.warmup_posed()
        for b in eng_f.buckets:   # warm the parity reference's buckets
            ref_one(np.zeros((b, n_joints, 3), np.float32), 0)

        err_f = err_x = 0.0
        probe = stream[:min(8, len(stream))]
        for pose, si in probe:
            err_f = max(err_f, float(np.abs(
                eng_f.forward(pose, subject=keys_f[si])
                - ref_one(pose, si)).max()))
            err_x = max(err_x, float(np.abs(
                eng_x.forward(pose, subject=keys_x[si])
                - ref_one(pose, si)).max()))
        # One request a batch: the engine's bucket is the reference's.
        err_x_matched = err_x
        futs_f = [eng_f.submit(p, subject=keys_f[si]) for p, si in probe]
        futs_x = [eng_x.submit(p, subject=keys_x[si]) for p, si in probe]
        for (pose, si), ff, fx in zip(probe, futs_f, futs_x):
            want = ref_one(pose, si)
            err_f = max(err_f, float(np.abs(ff.result() - want).max()))
            err_x = max(err_x, float(np.abs(fx.result() - want).max()))

        run_stream(eng_f, keys_f, m2)
        run_stream(eng_x, keys_x, m2)   # settle both sides untimed
        compiles_f = eng_f.counters.compiles
        compiles_x = eng_x.counters.compiles
        best, per_trial = _slope_best({
            "f1": lambda: run_stream(eng_f, keys_f, m1),
            "f2": lambda: run_stream(eng_f, keys_f, m2),
            "x1": lambda: run_stream(eng_x, keys_x, m1),
            "x2": lambda: run_stream(eng_x, keys_x, m2),
        }, trials)
        steady_f = eng_f.counters.compiles - compiles_f
        steady_x = eng_x.counters.compiles - compiles_x
        snap_f = eng_f.counters.snapshot()
        cap = eng_f.numerics_probe_targets()
        results.update({
            "capacity": cap["table"].capacity,
            "gather_fused_active": bool(cap["gather_fused"]),
            # True where K2's plain version ran (a CPU engine), False
            # where K2 ran (a card engine).
            "interpret": bool(cap["gather_fused"]
                              and cap["device"].type == "cpu"),
        })

    d_f = best["f2"] - best["f1"]
    d_x = best["x2"] - best["x1"]
    fused_rate = d_rows / d_f if d_f > 0 else float("nan")
    xla_rate = d_rows / d_x if d_x > 0 else float("nan")
    ratio = d_x / d_f if d_f > 0 and d_x > 0 else float("nan")
    trial_ratios = []
    for got in per_trial:
        tf, tx = got["f2"] - got["f1"], got["x2"] - got["x1"]
        trial_ratios.append(float(f"{tx / tf:.3g}") if tf > 0 and tx > 0
                            else float("nan"))
    platform = dev.type
    log(f"posed-kernel: fused {fused_rate:,.0f} vs xla {xla_rate:,.0f} "
        f"evals/s (slope ratio {ratio:.2f}x, platform {platform}, "
        f"interpret={results.get('interpret')}), parity fused "
        f"{err_f:.2e} / xla {err_x:.2e}, steady recompiles "
        f"{steady_f}/{steady_x}")

    lm = {}
    if lm_batch > 0:
        from mano_hand_tpu_torch.fitting import fit_lm

        lm_pose = rng.normal(
            scale=0.3, size=(lm_batch, n_joints, 3)).astype(np.float32)
        lm_beta = rng.normal(size=(n_shape,)).astype(np.float32)
        with torch.no_grad(), ieee_fp32():
            targets = core.forward_batched(
                prm_dev, torch.from_numpy(lm_pose).to(dev),
                torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
                    lm_beta, (lm_batch, n_shape)))).to(dev)).verts

        def run_lm(steps):
            return float(fit_lm(prm_dev, targets,
                                n_steps=steps).final_loss.sum())

        run_lm(lm_steps[0])   # settle both step counts
        run_lm(lm_steps[1])
        best_lm = {s: float("inf") for s in lm_steps}
        for t in range(max(1, lm_iters)):
            order = lm_steps if t % 2 == 0 else lm_steps[::-1]
            for s in order:
                t0 = time.perf_counter()
                run_lm(s)
                best_lm[s] = min(best_lm[s], time.perf_counter() - t0)
        d_lm = best_lm[lm_steps[1]] - best_lm[lm_steps[0]]
        lm_rate = ((lm_steps[1] - lm_steps[0]) / d_lm
                   if d_lm > 0 else float("nan"))
        log(f"posed-kernel lm_e2e b={lm_batch}: {lm_rate:,.1f} steps/s")
        lm = {
            "lm_e2e_steps_per_sec": float(f"{lm_rate:.5g}"),
            "lm_e2e_batch": int(lm_batch),
            "lm_e2e_steps": list(lm_steps),
            "lm_e2e_jacobian": "analytic",
            "lm_e2e_normal_eq": "high",
        }

    results.update({
        "subjects": int(subjects),
        "requests": int(requests),
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng_f.buckets),
        "platform": platform,
        "warmup_posed_sources": src_f,
        "slope_points": {"m1": m1, "m2": m2,
                         "rows_m1": rows_m1, "rows_m2": rows_m2},
        "fused_evals_per_sec": float(f"{fused_rate:.5g}"),
        "xla_evals_per_sec": float(f"{xla_rate:.5g}"),
        "fused_vs_xla_ratio": float(f"{ratio:.4g}"),
        "ratio_trials": trial_ratios,
        "fused_vs_gather_max_abs_err": err_f,
        "xla_vs_gather_max_abs_err": err_x,
        "xla_vs_gather_matched_max_abs_err": err_x_matched,
        "steady_recompiles_fused": int(steady_f),
        "steady_recompiles_xla": int(steady_x),
        "mixed_subject_batches": snap_f["mixed_subject_batches"],
        "coalesce_width_mean": snap_f["coalesce_width_mean"],
        "dispatches": snap_f["dispatches"],
        **lm,
        "flight_record": flight_record(
            tracer_f, eng_f.counters, reason="posed_kernel_complete"),
    })
    if trace_dir is not None:
        import os

        from mano_hand_tpu_torch.obs import write_trace_dir

        results["trace_export"] = write_trace_dir(
            tracer_f, os.path.join(str(trace_dir), "posed_kernel"),
            counters=eng_f.counters, reason="posed_kernel_complete")
    return results


def precision_bench_run(
    params,
    *,
    subjects: int = 8,
    requests: int = 96,
    min_rows: int = 1,
    max_rows: int = 4,
    max_bucket: int = 32,
    max_delay_s: float = 0.002,
    seed: int = 0,
    trials: int = 5,
    envelope_m: float = 2e-3,
    posed_kernel: str = "xla",
    drill: bool = True,
    trace_dir=None,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """THE precision-tier benchmark protocol: the same mixed-subject
    tier-0 pose-only stream drives TWO live engines on ``device`` — one
    under a ``PrecisionPolicy`` (tier 0 -> the bf16-compute/f32-
    accumulate gathered family: K2-bf16 under ``posed_kernel="fused"``
    on a card), one the f32 control (K2 under ``"fused"``) — slope-timed
    through the engines as ``posed_kernel_bench_run`` times them.

    Returned criteria (JAX's keys):

    * ``bf16_max_abs_err`` <= ``bf16_err_envelope`` (and above 1e-6: the
      tier runs) — the bf16 tier against the f32 per-subject posed
      program, through the live engine (sequential requests and a
      coalesced burst);
    * ``f32_control_max_abs_err`` — 0.0 for the plain family, within
      1e-5 under ``"fused"`` (K2 against the plain posed program); a
      tier-1 request on the POLICY engine is held here too (it must
      serve f32);
    * ``steady_recompiles_bf16`` == ``steady_recompiles_f32`` == 0;
    * ``sentinel_drill`` — a third, supervised engine (the CPU tier on a
      CPU engine only) composes the chaos ``wrong``-output fault into
      its bf16 family: the sentinel MUST flag ``gather_bf16`` drifted,
      every future still resolves, and the probe recovers once the fault
      clears (``drill=False`` skips it and says so);
    * ``bf16_vs_f32_ratio`` — the speed number, meaningful on a card.

    ``trace_dir`` exports the policy engine's timeline into
    ``<trace_dir>/precision/``.
    """
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.serving.engine import ServingEngine
    from mano_hand_tpu_torch.serving.precision import PrecisionPolicy

    if subjects < 1:
        raise ValueError(f"subjects must be >= 1, got {subjects}")
    if requests < 2:
        raise ValueError(f"requests must be >= 2, got {requests}")
    log = _logger(log)
    dev = resolve_device(device)
    n_joints = params.n_joints
    rng, betas, sizes, stream = _bench_inputs(
        params, subjects, requests, min_rows, max_rows, max_bucket, seed)
    m1 = max(1, requests // 2)
    m2 = requests
    rows_m1 = int(sizes[:m1].sum())
    rows_m2 = int(sizes.sum())
    d_rows = rows_m2 - rows_m1

    policy = PrecisionPolicy(bf16_tiers=frozenset({0}),
                             max_vertex_err_m=envelope_m)
    tracer_b, tracer_c = Tracer(), Tracer()
    eng_b = ServingEngine(params, device=dev, max_bucket=max_bucket,
                          max_delay_s=max_delay_s, tracer=tracer_b,
                          posed_kernel=posed_kernel,
                          precision_policy=policy)
    eng_c = ServingEngine(params, device=dev, max_bucket=max_bucket,
                          max_delay_s=max_delay_s, tracer=tracer_c,
                          posed_kernel=posed_kernel)
    ref_one = _posed_reference(params.astype(torch.float32).to(dev), betas,
                               eng_b.buckets)

    def run_stream(eng, keys, m):
        t0 = time.perf_counter()
        futs = [eng.submit(p, subject=keys[si], priority=0)
                for p, si in stream[:m]]
        for f in futs:
            f.result()
        return time.perf_counter() - t0

    results = {}
    with eng_b, eng_c:
        keys_b = [eng_b.specialize(b) for b in betas]
        keys_c = [eng_c.specialize(b) for b in betas]
        log(f"precision: {subjects} subjects baked on both engines, "
            f"warming buckets {eng_b.buckets}")
        eng_b.warmup_posed()
        eng_c.warmup_posed()
        for b in eng_b.buckets:   # warm the reference's buckets
            ref_one(np.zeros((b, n_joints, 3), np.float32), 0)

        err_b = err_c = 0.0
        probe = stream[:min(8, len(stream))]
        for pose, si in probe:
            err_b = max(err_b, float(np.abs(
                eng_b.forward(pose, subject=keys_b[si], priority=0)
                - ref_one(pose, si)).max()))
            err_c = max(err_c, float(np.abs(
                eng_c.forward(pose, subject=keys_c[si], priority=0)
                - ref_one(pose, si)).max()))
        futs_b = [eng_b.submit(p, subject=keys_b[si], priority=0)
                  for p, si in probe]
        futs_c = [eng_c.submit(p, subject=keys_c[si], priority=0)
                  for p, si in probe]
        for (pose, si), fb, fc in zip(probe, futs_b, futs_c):
            want = ref_one(pose, si)
            err_b = max(err_b, float(np.abs(fb.result() - want).max()))
            err_c = max(err_c, float(np.abs(fc.result() - want).max()))
        # A tier-1 request on the POLICY engine must serve f32.
        t1_pose, t1_si = stream[0]
        err_c = max(err_c, float(np.abs(
            eng_b.forward(t1_pose, subject=keys_b[t1_si], priority=1)
            - ref_one(t1_pose, t1_si)).max()))

        run_stream(eng_b, keys_b, m2)
        run_stream(eng_c, keys_c, m2)   # settle both sides untimed
        compiles_b = eng_b.counters.compiles
        compiles_c = eng_c.counters.compiles
        best, _ = _slope_best({
            "b1": lambda: run_stream(eng_b, keys_b, m1),
            "b2": lambda: run_stream(eng_b, keys_b, m2),
            "c1": lambda: run_stream(eng_c, keys_c, m1),
            "c2": lambda: run_stream(eng_c, keys_c, m2),
        }, trials)
        steady_b = eng_b.counters.compiles - compiles_b
        steady_c = eng_c.counters.compiles - compiles_c
        snap_b = eng_b.counters.snapshot()
        targets = eng_b.numerics_probe_targets()
        results.update({
            "capacity": targets["table"].capacity,
            "gather_fused_active": bool(targets["gather_fused"]),
            "precision_tiers": eng_b.load()["precision"]["tiers"],
        })

    d_b = best["b2"] - best["b1"]
    d_c = best["c2"] - best["c1"]
    bf16_rate = d_rows / d_b if d_b > 0 else float("nan")
    f32_rate = d_rows / d_c if d_c > 0 else float("nan")
    ratio = d_c / d_b if d_b > 0 and d_c > 0 else float("nan")
    platform = dev.type
    log(f"precision: bf16 {bf16_rate:,.0f} vs f32 {f32_rate:,.0f} "
        f"evals/s (slope ratio {ratio:.2f}x, platform {platform}), "
        f"bf16 err {err_b:.2e} vs envelope {envelope_m:.1e}, f32 "
        f"control err {err_c:.2e}, steady recompiles "
        f"{steady_b}/{steady_c}")

    drill_out = None
    if drill:
        drill_out = _precision_sentinel_drill(
            params, dev, betas, rng, policy, posed_kernel, max_delay_s,
            subjects, log)

    results.update({
        "subjects": int(subjects),
        "requests": int(requests),
        "rows": [int(sizes.min()), int(sizes.max())],
        "buckets": list(eng_b.buckets),
        "platform": platform,
        "posed_kernel": posed_kernel,
        "slope_points": {"m1": m1, "m2": m2,
                         "rows_m1": rows_m1, "rows_m2": rows_m2},
        "bf16_evals_per_sec": float(f"{bf16_rate:.5g}"),
        "f32_evals_per_sec": float(f"{f32_rate:.5g}"),
        "bf16_vs_f32_ratio": float(f"{ratio:.4g}"),
        "bf16_max_abs_err": err_b,
        "bf16_err_envelope": float(envelope_m),
        "f32_control_max_abs_err": err_c,
        "steady_recompiles_bf16": int(steady_b),
        "steady_recompiles_f32": int(steady_c),
        "mixed_subject_batches": snap_b["mixed_subject_batches"],
        "coalesce_width_mean": snap_b["coalesce_width_mean"],
        "dispatches": snap_b["dispatches"],
        "flight_record": flight_record(
            tracer_b, eng_b.counters, reason="precision_complete"),
    })
    if drill_out is not None:
        results["sentinel_drill"] = drill_out
    else:
        # A deliberate skip says so: an absent block is not a pass.
        results["sentinel_drill_skipped"] = True
    if trace_dir is not None:
        import os

        from mano_hand_tpu_torch.obs import write_trace_dir

        results["trace_export"] = write_trace_dir(
            tracer_b, os.path.join(str(trace_dir), "precision"),
            counters=eng_b.counters, reason="precision_complete")
    return results


def _precision_sentinel_drill(params, dev, betas, rng, policy, posed_kernel,
                              max_delay_s, subjects, log) -> dict:
    """``precision_bench_run``'s sentinel drill: injected silent corruption
    on the bf16 TIER must be seen by the envelope judgment. The drill
    engine serves the SAME family the timed engines serve."""
    import concurrent.futures as cf

    from mano_hand_tpu_torch.obs.recorder import FlightRecorder
    from mano_hand_tpu_torch.obs.sentinel import NumericsSentinel
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    n_joints = params.n_joints
    plan = ChaosPlan()
    pol = DispatchPolicy(deadline_s=20.0, retries=0, chaos=plan,
                         cpu_fallback=dev.type == "cpu")
    tr3 = Tracer()
    eng3 = ServingEngine(params, device=dev, min_bucket=8, max_bucket=8,
                         max_delay_s=max_delay_s, policy=pol, tracer=tr3,
                         precision_policy=policy, posed_kernel=posed_kernel)
    rec3 = FlightRecorder(tr3, eng3.counters)
    s3 = NumericsSentinel(eng3, tracer=tr3, interval_s=3600.0)
    dkeys = [eng3.specialize(b) for b in betas[:min(3, subjects)]]
    wave = [
        (rng.normal(scale=0.4,
                    size=(int(n), n_joints, 3)).astype(np.float32), int(s))
        for n, s in zip(rng.integers(1, 5, size=12),
                        rng.integers(0, len(dkeys), size=12))
    ]

    def submit_wave():
        futs = [eng3.submit(p, subject=dkeys[si], priority=0)
                for p, si in wave]
        resolved = 0
        for f in futs:
            try:
                f.result(timeout=60.0)
                resolved += 1
            except cf.TimeoutError:
                pass
            except Exception:  # noqa: BLE001 — structured resolves
                resolved += 1
        return resolved, len(futs)

    with eng3:
        eng3.warmup_posed()
        golden = s3.arm()
        ok0, n0 = submit_wave()     # clean bf16 tier-0 traffic
        clean = s3.probe()
        drill_compiles_warm = eng3.counters.compiles
        # Silent corruption: every chaos-wrapped primary — the bf16
        # gathered family included — returns verts + 1.0 from here,
        # resolving every future "ok". Only the sentinel can see it.
        plan.schedule("wrong:1.0@0-")
        ok1, n1 = submit_wave()
        detected = s3.probe()
        plan.clear()                # the fault clears
        recovered = s3.probe()
        drill_recompiles = eng3.counters.compiles - drill_compiles_warm
    drill_acc = tr3.accounting()
    bf16_rec = detected["families"].get("gather_bf16") or {}
    out = {
        "submitted": n0 + n1,
        "futures_resolved_fraction": (ok0 + ok1) / (n0 + n1),
        "clean_probe_drift": bool(clean["drift"]),
        "detected": bool(detected["drift"]),
        "bf16_family_detected": bool(bf16_rec.get("drift")),
        "drifted_families": detected["drifted_families"],
        "drift_max_abs_err": bf16_rec.get("max_abs_err"),
        "envelope": bf16_rec.get("envelope"),
        "golden_bf16_status": golden.get("golden_bf16_status"),
        "recovered": not recovered["drift"],
        "incidents": drill_acc["incidents"],
        "flight_capture_reasons": [c.get("reason") for c in rec3.captures],
        "faults_injected": int(eng3.counters.faults_injected),
        "steady_recompiles": int(drill_recompiles),
        "span_accounting": drill_acc,
    }
    log(f"precision sentinel drill: bf16 detected="
        f"{out['bf16_family_detected']} (err {out['drift_max_abs_err']} "
        f"vs envelope {out['envelope']}), recovered={out['recovered']}, "
        f"{out['futures_resolved_fraction']:.0%} of {out['submitted']} "
        f"futures resolved, golden_bf16 {out['golden_bf16_status']}")
    return out


def edge_drill_run(
    params,
    *,
    # 5x offered (vs the overload drill's 4x): the wire's blocking
    # clients compress bursts when the pool saturates, so the ACHIEVED
    # multiple lands under the target — the headroom keeps the >= 3x
    # judging floor honest through scheduler noise.
    saturation: float = 5.0,
    bursts: int = 24,
    burst_interval_s: float = 0.02,
    tier0_fraction: float = 0.125,
    # Sized against the WORKER pool: the wire client blocks one worker
    # per admitted request, so overload only materializes when workers >
    # max_queued.
    max_queued: int = 16,
    tier1_quota: int = 6,
    deadline_s: float = 0.5,
    sat_latency_s: float = 0.02,
    max_bucket: int = 8,
    batch_deadline_s: float = 0.5,
    shed_probe_requests: int = 64,
    workers: int = 24,
    streams: int = 3,
    frames_per_stream: int = 3,
    drain_timeout_s: float = 10.0,
    seed: int = 0,
    tracer=None,
    device=None,
    posed_kernel: str = "xla",
    log: Callable[[str], None] = None,
) -> dict:
    """THE loopback edge drill: the overload acceptance numbers reproduced
    THROUGH the socket, plus the wire protocol's own failure story, over
    live ``edge.EdgeServer``s in this process (the serialization
    boundary is real) in front of engines on ``device`` (their gathered
    family ``posed_kernel``: K2 on a card under ``"fused"``).

    Five legs:

    1. **Shed probe**: the engine-side decision stays O(µs) (the
       ``max_queued=0`` probe engine — zero dispatches, dispatcher never
       started), and the WIRE maps every one of those sheds to 429 +
       per-tier Retry-After.
    2. **Saturation storm**: a worker pool with persistent connections
       offers ``saturation`` x the socket-calibrated service rate in
       paced bursts, tiers and TTLs riding the QoS headers. Criteria:
       every request gets an HTTP terminal (200/429/504 — never a hang,
       never a 5xx) within the budget, tier-0 goodput >= 95% at >= 3x
       achieved saturation, and the storm builds nothing.
    3. **Stream parity**: sessions through the upgrade protocol, frames
       BIT-identical (verts AND warm-start pose) to in-process
       ``submit_frame`` on the same engine.
    4. **Disconnect**: an abrupt client vanish mid-request and mid-frame
       lands the cancellation path — terminal kind ``cancelled``,
       session closed — on a dedicated slow engine so the in-flight
       window is deterministic.
    5. **Drain**: the SIGTERM path with requests in flight — in-flight
       requests resolve, new connections are refused, the engine's
       stop() sweep runs, all inside ``drain_timeout_s`` with the flight
       recorder QUIET.

    One tracer spans every engine, so the final closed-exactly-once
    accounting covers every request, frame and session that crossed the
    wire. Saturation and faults are injected in-process. Returns JAX's
    keys.
    """
    import queue as queue_mod
    import socket as socket_mod
    import threading

    from mano_hand_tpu_torch.edge import EdgeClient, EdgeError, EdgeServer
    from mano_hand_tpu_torch.edge import protocol as eproto
    from mano_hand_tpu_torch.models import anim, core
    from mano_hand_tpu_torch.obs.recorder import FlightRecorder
    from mano_hand_tpu_torch.ops.common import ieee_fp32, resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError

    if saturation <= 0:
        raise ValueError(f"saturation must be > 0, got {saturation}")
    if bursts < 1:
        raise ValueError(f"bursts must be >= 1, got {bursts}")
    if workers < 2:
        raise ValueError(f"workers must be >= 2, got {workers}")
    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    if frames_per_stream < 2:
        raise ValueError(
            f"frames_per_stream must be >= 2 (settle + parity), got "
            f"{frames_per_stream}")
    log = _logger(log)
    if tracer is None:
        tracer = Tracer()
    dev = resolve_device(device)
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    prm32 = params.astype(torch.float32).to(dev)
    host = "127.0.0.1"
    pose1 = rng.normal(scale=0.4, size=(1, n_joints, 3)).astype(np.float32)
    # The black box rides the WHOLE drill; the drain criterion judges its
    # silence across the drain window only.
    recorder = FlightRecorder(tracer)

    # ---- Leg 1: the shed probe, engine-side then through the wire -----
    probe = ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                          max_queued=0, tracer=tracer,
                          posed_kernel=posed_kernel)
    shed_us: List[float] = []
    for _ in range(max(1, shed_probe_requests)):
        t0 = time.perf_counter()
        try:
            probe.submit(pose1, deadline_s=deadline_s)
            raise RuntimeError("shed probe submit was admitted at "
                               "max_queued=0")
        except ServingError as e:
            if e.kind != "shed":
                raise
        shed_us.append((time.perf_counter() - t0) * 1e6)
    srv_probe = EdgeServer(probe, host=host, port=0).start()
    wire_429 = 0
    wire_retry_after: List[int] = []
    wire_shed_ms: List[float] = []
    cli_probe = EdgeClient(host, srv_probe.port, timeout_s=30.0)
    for i in range(max(1, shed_probe_requests)):
        t0 = time.perf_counter()
        try:
            cli_probe.forward(pose1, priority=i % 2,
                              deadline_s=deadline_s)
            raise RuntimeError("wire shed probe got a 200 at "
                               "max_queued=0")
        except EdgeError as e:
            if e.status != 429 or e.kind != "shed":
                raise
            wire_429 += 1
            if e.retry_after_s is not None:
                wire_retry_after.append(e.retry_after_s)
        wire_shed_ms.append((time.perf_counter() - t0) * 1e3)
    cli_probe.close()
    shed_probe = {
        "sheds": len(shed_us),
        "dispatches": probe.counters.dispatches,
        "engine_started": probe._thread is not None,
        # Whether the probe's params sit on a device other than the host
        # (the port's constructor places them).
        "params_device_put": probe._params.device.type != "cpu",
        "decision_p50_us": float(f"{np.percentile(shed_us, 50):.4g}"),
        "decision_p99_us": float(f"{np.percentile(shed_us, 99):.4g}"),
        "wire_429": wire_429,
        "wire_retry_after_present": len(wire_retry_after) == wire_429,
        "wire_shed_p50_ms": float(
            f"{np.percentile(wire_shed_ms, 50):.4g}"),
        "wire_shed_p99_ms": float(
            f"{np.percentile(wire_shed_ms, 99):.4g}"),
    }
    srv_probe.drain(timeout_s=5.0)
    log(f"edge: shed probe {shed_probe['sheds']} sheds "
        f"({shed_probe['dispatches']} dispatches, decision p50 "
        f"{shed_probe['decision_p50_us']:.1f} µs), wire {wire_429} x "
        f"429 (p50 {shed_probe['wire_shed_p50_ms']:.2f} ms)")

    # ---- The saturated engine + its edge -----------------------------
    plan = ChaosPlan(f"sat:{sat_latency_s}@0-")
    policy = DispatchPolicy(
        deadline_s=batch_deadline_s, retries=0, backoff_s=0.0,
        backoff_cap_s=0.0, jitter=0.0, breaker=None, chaos=plan,
        # Overload is not a fault; a fallback tier would quietly raise
        # capacity mid-drill.
        cpu_fallback=False,
    )
    eng = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, max_delay_s=0.001,
        policy=policy, max_queued=max_queued, tier_quotas={1: tier1_quota},
        tracer=tracer, posed_kernel=posed_kernel)
    recorder.counters = eng.counters    # captures now carry the
    eng.start()                         # saturated engine's ledger
    eng.warmup()
    srv = EdgeServer(eng, host=host, port=0,
                     drain_timeout_s=drain_timeout_s).start()

    # Worker pool: one persistent connection each; phases tag records.
    tasks: queue_mod.Queue = queue_mod.Queue()
    records: dict = {"calib": [], "storm": []}
    rec_lock = threading.Lock()
    _STOP = object()

    def worker():
        cli = EdgeClient(host, srv.port, timeout_s=30.0)
        while True:
            item = tasks.get()
            if item is _STOP:
                cli.close()
                return
            phase, tier, ttl = item
            t0 = time.monotonic()
            try:
                cli.forward(pose1, priority=tier, deadline_s=ttl)
                out = "ok"
            except EdgeError as e:
                out = {429: "shed", 504: "expired"}.get(
                    e.status, "error")
            except Exception:  # noqa: BLE001 — a timeout IS the bug
                out = "unresolved"
            t1 = time.monotonic()
            with rec_lock:
                records[phase].append((tier, t0, t1, out))

    pool = [threading.Thread(target=worker, daemon=True)
            for _ in range(workers)]
    for t in pool:
        t.start()

    def run_phase(phase: str, n: int, timeout_s: float) -> bool:
        dl = time.monotonic() + timeout_s
        while time.monotonic() < dl:
            with rec_lock:
                if len(records[phase]) >= n:
                    return True
            time.sleep(0.002)
        return False

    # Calibrate THIS machine's wire service rate through the socket:
    # waves under the quota, drained, three times.
    wave = min(max(max_bucket, min(max_queued // 2, 3 * max_bucket)),
               max_queued, workers)
    t0 = time.perf_counter()
    served = 0
    for _ in range(3):
        base = served
        for _ in range(wave):
            tasks.put(("calib", 0, None))
        if not run_phase("calib", base + wave, 60.0):
            raise RuntimeError("edge calibration wave did not drain")
        served += wave
    service_rate = served / (time.perf_counter() - t0)
    compiles_warm = eng.counters.compiles
    offered_rate = saturation * service_rate
    burst_n = max(1, int(round(offered_rate * burst_interval_s)))
    # Budget: the engine's own resolution window + one wire grace.
    budget_s = deadline_s + batch_deadline_s + 0.5
    log(f"edge: wire service rate {service_rate:,.0f} req/s (sat "
        f"throttle {sat_latency_s}s), offering {offered_rate:,.0f} "
        f"req/s = {burst_n}/burst x {bursts} bursts over {workers} "
        f"workers")

    # ---- Leg 2: the saturation storm ---------------------------------
    submitted = 0
    next_t = time.monotonic()
    healthz_mid = None
    load_mid = None
    for b in range(bursts):
        for _ in range(burst_n):
            tier = 0 if rng.random() < tier0_fraction else 1
            tasks.put(("storm", tier, deadline_s))
            submitted += 1
        if b == bursts // 2:
            load_mid = eng.load()
            try:
                with EdgeClient(host, srv.port, timeout_s=5.0) as hc:
                    healthz_mid = hc.healthz()
            except Exception:  # noqa: BLE001 — mid-storm info only
                healthz_mid = None
        next_t += burst_interval_s
        lag = next_t - time.monotonic()
        if lag > 0:
            time.sleep(lag)
    drained = run_phase("storm", submitted, budget_s * 2 + 30.0)
    steady_recompiles = eng.counters.compiles - compiles_warm
    snap = eng.counters.snapshot()

    outcomes = {"ok": 0, "shed": 0, "expired": 0, "error": 0,
                "unresolved": 0}
    by_tier = {0: dict(outcomes), 1: dict(outcomes)}
    in_budget = 0
    sends: List[float] = []
    wire_lat: List[float] = []
    with rec_lock:
        storm = list(records["storm"])
    for tier, t0, t1, out in storm:
        lat = t1 - t0
        sends.append(t0)
        wire_lat.append(lat)
        if out != "unresolved" and lat <= budget_s:
            in_budget += 1
        outcomes[out] += 1
        by_tier[tier][out] += 1
    missing = submitted - len(storm)
    outcomes["unresolved"] += missing
    stream_s = (max(sends) - min(sends)) if len(sends) > 1 else 1e-9
    achieved = ((len(storm) / max(stream_s, 1e-9)) / service_rate
                if service_rate else 0.0)
    t0_total = sum(by_tier[0].values())
    tier0_goodput = (by_tier[0]["ok"] / t0_total if t0_total else None)
    resolved_frac = in_budget / submitted if submitted else 0.0
    log(f"edge: {submitted} submitted at {achieved:.2f}x achieved "
        f"saturation -> {outcomes['ok']} ok / {outcomes['shed']} shed "
        f"/ {outcomes['expired']} expired / {outcomes['unresolved']} "
        f"unresolved (drained={drained}); tier-0 goodput "
        f"{tier0_goodput}, {steady_recompiles} steady recompiles")

    # ---- Scrape through the socket -----------------------------------
    scrape_cli = EdgeClient(host, srv.port, timeout_s=10.0)
    healthz = scrape_cli.healthz()
    metrics_text = scrape_cli.metrics_text()
    scrape_cli.close()
    scrape = {
        "healthz_ok": bool(healthz.get("ok")),
        "healthz_status": healthz.get("status"),
        "metrics_lines": len(metrics_text.splitlines()),
        "metrics_has_serving": "mano_serving_dispatches" in metrics_text,
        "metrics_has_slo": "mano_slo_burn_rate" in metrics_text,
    }

    # ---- Leg 3: stream parity (wire vs in-process, bit-identical) ----
    betas = [rng.normal(size=(n_shape,)).astype(np.float32)
             for _ in range(streams)]
    keys = np.zeros((streams, 3, n_joints, 3), np.float32)
    keys[:, 1] = rng.normal(scale=0.2, size=(streams, n_joints, 3))
    keys[:, 2] = keys[:, 1] + rng.normal(
        scale=0.1, size=(streams, n_joints, 3))
    tracks = np.stack([
        anim.resample_poses(keys[s], frames_per_stream)
        for s in range(streams)]).astype(np.float32)
    flat_pose = tracks.reshape(streams * frames_per_stream, n_joints, 3)
    flat_beta = np.stack([betas[s]
                          for s in range(streams)
                          for _ in range(frames_per_stream)])
    with torch.no_grad(), ieee_fp32():
        gt = core.forward_batched(prm32, torch.from_numpy(flat_pose).to(dev),
                                  torch.from_numpy(flat_beta).to(dev))
    targets = gt.posed_joints.cpu().numpy().reshape(
        streams, frames_per_stream, n_joints, 3)

    stream_cli = EdgeClient(host, srv.port, timeout_s=120.0)
    frames_ok = 0
    verts_err = 0.0
    pose_err = 0.0
    for s in range(streams):
        wire_frames = []
        with stream_cli.open_stream(betas=betas[s]) as ws:
            for f in range(frames_per_stream):
                wire_frames.append(ws.frame(targets[s, f]))
        sess = eng.open_stream(betas[s])
        for f in range(frames_per_stream):
            ref = sess.step(targets[s, f])
            wf = wire_frames[f]
            verts_err = max(verts_err, float(
                np.max(np.abs(wf.verts - ref.verts))))
            pose_err = max(pose_err, float(
                np.max(np.abs(wf.pose - ref.pose))))
            if wf.frame == ref.frame:
                frames_ok += 1
        sess.close()
    stream_cli.close()
    stream_leg = {
        "streams": streams,
        "frames_per_stream": frames_per_stream,
        "frames_ok": frames_ok,
        "frames_expected": streams * frames_per_stream,
        "wire_vs_inprocess_max_abs_err": verts_err,
        "wire_vs_inprocess_pose_max_abs_err": pose_err,
    }
    log(f"edge: stream parity {frames_ok}/"
        f"{streams * frames_per_stream} frames, verts err {verts_err} "
        f"pose err {pose_err} (bit-identity bar: 0.0)")

    # ---- Leg 4: disconnect -> cancel (deterministic slow engine) -----
    slow_plan = ChaosPlan("sat:0.35@0-")
    slow_policy = DispatchPolicy(
        deadline_s=2.0, retries=0, backoff_s=0.0, backoff_cap_s=0.0,
        jitter=0.0, breaker=None, chaos=slow_plan, cpu_fallback=False)
    eng_d = ServingEngine(prm32, device=dev, max_bucket=2,
                          max_delay_s=0.001, policy=slow_policy,
                          tracer=tracer, posed_kernel=posed_kernel)
    eng_d.start()
    eng_d.warmup([1, 2])
    srv_d = EdgeServer(eng_d, host=host, port=0).start()
    cancelled_base = eng_d.counters.cancelled
    # One-shot: a raw POST whose socket dies while the request is in
    # the 0.35 s dispatch window.
    body = eproto.dumps({"pose": eproto.encode_array(pose1)})
    conn = socket_mod.create_connection((host, srv_d.port), timeout=10.0)
    conn.sendall((f"POST /v1/forward HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n"
                  ).encode("latin-1") + body)
    time.sleep(0.08)
    conn.close()
    dl = time.monotonic() + 5.0
    while (eng_d.counters.cancelled <= cancelled_base
           and time.monotonic() < dl):
        time.sleep(0.01)
    oneshot_cancelled = eng_d.counters.cancelled - cancelled_base
    # Stream: open over the wire, settle one frame, vanish mid-frame.
    d_cli = EdgeClient(host, srv_d.port, timeout_s=60.0)
    ds = d_cli.open_stream(betas=betas[0])
    ds.frame(targets[0, 0])            # settle (tracker state warm)
    aborter = threading.Timer(0.1, ds.abort)
    aborter.start()
    stream_frame_cancelled = False
    try:
        ds.frame(targets[0, 1])
    except (EdgeError, OSError, ValueError):
        stream_frame_cancelled = True
    aborter.join()
    dl = time.monotonic() + 5.0
    while (eng_d.counters.cancelled <= cancelled_base + oneshot_cancelled
           and time.monotonic() < dl):
        time.sleep(0.01)
    d_load = eng_d.load()
    disconnect = {
        "oneshot_cancelled": int(oneshot_cancelled),
        "stream_frame_aborted": stream_frame_cancelled,
        "cancelled_total": int(eng_d.counters.cancelled
                               - cancelled_base),
        "stream_closed_by_kind": d_load["streams"]["closed_by_kind"],
        "stream_frames_by_kind": d_load["streams"]["frames_by_kind"],
    }
    d_cli.close()
    srv_d.drain(timeout_s=5.0)
    log(f"edge: disconnect leg cancelled "
        f"{disconnect['cancelled_total']} (one-shot "
        f"{disconnect['oneshot_cancelled']}, stream frames by kind "
        f"{disconnect['stream_frames_by_kind']})")

    # ---- Leg 5: drain with requests in flight ------------------------
    inflight_results: List[str] = []
    inflight_lock = threading.Lock()
    inflight_n = min(6, workers)
    # Every client establishes its persistent connection (healthz) BEFORE
    # any forward is sent, so the drain races the REQUESTS, never the TCP
    # connects.
    inflight_ready = threading.Barrier(inflight_n + 1)

    def inflight_request():
        cli = EdgeClient(host, srv.port, timeout_s=30.0)
        try:
            cli.healthz()
            inflight_ready.wait(timeout=10.0)
            cli.forward(pose1, priority=0, deadline_s=5.0)
            out = "ok"
        except EdgeError as e:
            out = f"http_{e.status}"
        except Exception as e:  # noqa: BLE001
            out = f"exc_{type(e).__name__}"
        finally:
            cli.close()
        with inflight_lock:
            inflight_results.append(out)

    inflight_threads = [threading.Thread(target=inflight_request,
                                         daemon=True)
                        for _ in range(inflight_n)]
    for t in inflight_threads:
        t.start()
    inflight_ready.wait(timeout=10.0)
    # Drain once the server holds every request (or the fast ones have
    # already resolved — both are fine: none may be refused or stranded).
    spin_dl = time.monotonic() + 1.0
    while (srv._active_requests < inflight_n
           and time.monotonic() < spin_dl):
        time.sleep(0.0005)
    captures_before_drain = len(recorder.captures)
    t_drain0 = time.monotonic()
    drain_report = srv.drain(timeout_s=drain_timeout_s)
    drain_wall = time.monotonic() - t_drain0
    for t in inflight_threads:
        t.join(timeout=10.0)
    refused = False
    try:
        probe_conn = socket_mod.create_connection((host, srv.port),
                                                  timeout=2.0)
        probe_conn.close()
    except OSError:
        refused = True
    recorder_quiet = len(recorder.captures) == captures_before_drain
    with inflight_lock:
        inflight_ok = (len(inflight_results) == inflight_n
                       and all(r == "ok" for r in inflight_results))
    drain_leg = {
        "inflight_requests": inflight_n,
        "inflight_all_ok": inflight_ok,
        "inflight_results": sorted(inflight_results),
        "new_connection_refused": refused,
        "drain_wall_s": float(f"{drain_wall:.4g}"),
        "within_timeout": bool(drain_report.get("within_timeout"))
        and drain_wall <= drain_timeout_s,
        "engine_stopped": eng._thread is None,
        "recorder_quiet_during_drain": recorder_quiet,
        "report": {k: v for k, v in drain_report.items()
                   if k != "inflight_resolved"},
    }
    log(f"edge: drain {drain_wall:.2f}s (timeout {drain_timeout_s}s), "
        f"in-flight {inflight_results}, new conn refused={refused}, "
        f"recorder quiet={recorder_quiet}")

    # Workers down (their engine is stopped).
    for _ in pool:
        tasks.put(_STOP)
    for t in pool:
        t.join(timeout=5.0)

    acc = tracer.accounting()
    return {
        "edge_drill_schema": 1,
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
        "workers": int(workers),
        "submitted": int(submitted),
        "outcomes": outcomes,
        "by_tier": {str(t): c for t, c in by_tier.items()},
        "tier0_goodput": (None if tier0_goodput is None
                          else float(f"{tier0_goodput:.6g}")),
        "wire_resolved_within_budget_fraction": float(
            f"{resolved_frac:.6g}"),
        "wire_p50_ms": (float(f"{np.percentile(wire_lat, 50) * 1e3:.4g}")
                        if wire_lat else None),
        "wire_p99_ms": (float(f"{np.percentile(wire_lat, 99) * 1e3:.4g}")
                        if wire_lat else None),
        "shed_probe": shed_probe,
        "steady_recompiles": int(steady_recompiles),
        "backlog_peak": snap["backlog_peak"],
        "shed": snap["shed"],
        "expired": snap["expired"],
        "dispatches": snap["dispatches"],
        "coalesce_width_mean": snap["coalesce_width_mean"],
        "load_mid_drill": load_mid,
        "healthz_mid_drill": healthz_mid,
        "scrape": scrape,
        "stream": stream_leg,
        "disconnect": disconnect,
        "drain": drain_leg,
        "incident_captures": len(recorder.captures),
        "incident_captures_pre_drain": captures_before_drain,
        "span_accounting": acc,
        "flight_record": flight_record(
            tracer, eng.counters, reason="edge_drill_complete"),
    }


def _prom_value(text: str, name: str):
    """First value of a plain (label-free) Prometheus sample, or None."""
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            try:
                return float(ln.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return None


def _worker_env() -> dict:
    """The fleet-wide environment of worker and proxy processes: the
    directory that holds this package on ``PYTHONPATH`` (they start as
    ``python -m mano_hand_tpu_torch.cli``, whatever the caller's working
    directory) and this process's torch thread count (a CPU fit rounds
    by it, and the drills hold the workers' poses against fits in this
    process bit for bit); nothing of XLA — the port has no compile
    cache."""
    import os

    import mano_hand_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mano_hand_tpu_torch.__file__)))
    path = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": root + (os.pathsep + path if path else ""),
            "OMP_NUM_THREADS": str(torch.get_num_threads())}


def _stream_tracks(params, dev, rng, tracks: int, frames: int, max_bucket,
                   max_subjects):
    """Seeded per-track betas and fit targets (the drills' reference
    tracks), and each track's frames through an in-process engine on
    ``dev`` — the reference every wire frame is held against."""
    from mano_hand_tpu_torch.models import anim, core
    from mano_hand_tpu_torch.ops.common import ieee_fp32
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    n_joints, n_shape = params.n_joints, params.n_shape
    betas = [rng.normal(size=(n_shape,)).astype(np.float32)
             for _ in range(tracks)]
    keys = np.zeros((tracks, 3, n_joints, 3), np.float32)
    keys[:, 1] = rng.normal(scale=0.2, size=(tracks, n_joints, 3))
    keys[:, 2] = keys[:, 1] + rng.normal(
        scale=0.1, size=(tracks, n_joints, 3))
    track_poses = np.stack([
        anim.resample_poses(keys[t], frames)
        for t in range(tracks)]).astype(np.float32)
    flat_pose = track_poses.reshape(tracks * frames, n_joints, 3)
    flat_beta = np.stack([betas[t] for t in range(tracks)
                          for _ in range(frames)])
    with torch.no_grad(), ieee_fp32():
        gt = core.forward_batched(params,
                                  torch.from_numpy(flat_pose).to(dev),
                                  torch.from_numpy(flat_beta).to(dev))
    targets = gt.posed_joints.cpu().numpy().reshape(
        tracks, frames, n_joints, 3)
    ref_eng = ServingEngine(params, device=dev, max_bucket=max_bucket,
                            max_delay_s=0.001, max_subjects=max_subjects)
    ref_eng.start()
    ref_frames = []
    try:
        for t in range(tracks):
            sess = ref_eng.open_stream(betas[t])
            ref_frames.append([sess.step(targets[t, f])
                               for f in range(frames)])
            sess.close()
    finally:
        ref_eng.stop()
    return betas, targets, ref_frames


def _exit_spans(reports: dict) -> tuple:
    """Per-worker exit-line span accounting (None for a worker that
    printed no exit line) and whether every reporting worker closed
    each span exactly once."""
    spans = {}
    for name, rep in reports.items():
        if rep is None:
            spans[name] = None
            continue
        acc = rep.get("accounting") or {}
        spans[name] = {
            "started": acc.get("spans_started"),
            "closed": acc.get("spans_closed"),
            "open": acc.get("spans_open"),
            "double_closed": acc.get("spans_double_closed"),
        }
    balanced = all(
        v is None or (v["started"] == v["closed"] and v["open"] == 0
                      and not v["double_closed"])
        for v in spans.values())
    return spans, balanced


def fleet_drill_run(
    params,
    *,
    workers: int = 3,
    lanes: int = 2,
    streams: int = 208,
    frames_per_stream: int = 4,
    stream_workers: int = 16,
    unique_tracks: int = 8,
    max_bucket: int = 8,
    max_subjects: int = 32,
    store_warm_capacity: int = 16,
    drain_budget_s: float = 10.0,
    ready_timeout_s: float = 420.0,
    frame_deadline_s: float = 120.0,
    client_timeout_s: float = 180.0,
    work_dir=None,
    seed: int = 0,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """THE fleet chaos drill: a rolling deploy that never drops a frame,
    measured end to end across real process boundaries (JAX's
    ``fleet_drill_run``, its arguments, protocol and keys, plus
    ``device=``).

    The substrate is the fleet front tier at full depth: N ``serve``
    worker PROCESSES (``edge.fleet``) on ``device`` (each its own
    interpreter; on a card each its own CUDA context under the shared
    ``server`` device lock) cold-booting from a per-lane program lattice
    baked in THIS process for ``device``, fronted by one
    ``edge.EdgeProxy`` doing health-aware routing and live stream
    migration. Phases:

    1. **Bake + boot**: bake the lattice (the shard capacity included),
       boot every worker with ``--lanes`` + ``--aot-dir``, and scrape
       each worker's /metrics: the cold-boot criterion is compiles == 0
       AND aot_loads > 0 PER WORKER at lanes=N.
    2. **Warm + baseline**: one direct stream per worker warms the
       fit stage, then the drill's stream fleet opens through the proxy
       and settles one frame wave; per-worker build baselines are
       scraped HERE — everything after is steady state.
    3. **Chaos**: SIGKILL one worker while the next frame wave is in
       flight (relays fail over mid-frame: siblings re-derive identical
       frames from the last confirmed pose), then DRAIN a second worker
       under the remaining live streams (polite migration: close on the
       old worker, warm re-open on a sibling) against
       ``drain_budget_s``.
    4. **Judgment inputs**: every frame of every stream must reach an
       HTTP terminal; every stream's POSE chain must be bit-equal to its
       track's in-process reference and to every fleet sibling on the
       same track, migrated streams included (verts get the f32 anchor
       tolerance: which bucket serves a coalesced batch varies); steady
       builds must be 0 fleet-wide (exit-line counters minus the
       baselines; the SIGKILLed worker is excluded by construction —
       its counters died with it); spans must close exactly once on
       every worker that reported.

    Each worker's environment carries nothing of XLA (no
    ``XLA_FLAGS``, no compile-cache dir: the port has neither). The
    sockets are loopback.
    """
    import os
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from mano_hand_tpu_torch.edge import (
        EdgeClient,
        EdgeError,
        Fleet,
        WorkerSpec,
    )
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.serving.engine import ServingEngine
    from mano_hand_tpu_torch.serving.subject_store import (
        SubjectStore,
        SubjectStoreConfig,
    )

    if workers < 3:
        raise ValueError(f"workers must be >= 3 (kill one, drain one, "
                         f"serve on the rest), got {workers}")
    if streams < workers:
        raise ValueError(f"streams must be >= workers, got {streams}")
    if frames_per_stream < 3:
        raise ValueError(f"frames_per_stream must be >= 3 (settle + "
                         f"kill + drain waves), got {frames_per_stream}")
    log = _logger(log)
    dev = resolve_device(device)
    host = "127.0.0.1"
    rng = np.random.default_rng(seed)
    prm32 = params.astype(torch.float32).to(dev)
    tracks = min(max(1, unique_tracks), streams)

    own_work_dir = work_dir is None
    if own_work_dir:
        work_dir = tempfile.mkdtemp(prefix="mano_fleet_drill_")
    aot_dir = os.path.join(work_dir, "aot")
    log_dir = os.path.join(work_dir, "logs")
    os.makedirs(aot_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)

    # ---- Phase 1: bake the per-lane lattice, boot the fleet ----------
    t_bake0 = time.monotonic()
    bake_eng = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, aot_dir=aot_dir,
        lanes=lanes, max_subjects=max_subjects,
        subject_store=SubjectStore(SubjectStoreConfig(
            warm_capacity=store_warm_capacity, sharded=True)))
    manifest = bake_eng.bake_lattice(include_cpu_fallback=False)
    bake_wall = time.monotonic() - t_bake0
    log(f"fleet: baked {len(manifest['entries'])} lattice entries in "
        f"{bake_wall:.1f}s")

    specs = [WorkerSpec(device=dev.type, lanes=lanes,
                        max_bucket=max_bucket,
                        max_delay_ms=1.0, max_subjects=max_subjects,
                        aot_dir=aot_dir,
                        store_warm_capacity=store_warm_capacity,
                        drain_timeout_s=max(15.0, drain_budget_s))
             for _ in range(workers)]
    fleet = Fleet(specs, env=_worker_env(), stderr_dir=log_dir,
                  proxy_kwargs=dict(connect_timeout_s=5.0,
                                    probe_timeout_s=2.0,
                                    upstream_timeout_s=client_timeout_s),
                  log=lambda m: log(f"fleet: {m}"))
    t_boot0 = time.monotonic()
    fleet.start(ready_timeout_s=ready_timeout_s)
    boot_wall = time.monotonic() - t_boot0
    ports = {name: w.port for name, w in fleet.workers.items()}
    log(f"fleet: {workers} workers up in {boot_wall:.1f}s "
        f"(lanes={lanes} each), proxy on :{fleet.proxy.port}")

    def scrape(name: str) -> dict:
        cli = EdgeClient(host, ports[name], timeout_s=30.0)
        try:
            text = cli.metrics_text()
        finally:
            cli.close()
        return {k: int(_prom_value(text, f"mano_serving_{k}") or 0)
                for k in ("compiles", "aot_loads", "aot_load_failures")}

    try:
        # Cold-boot criterion: per-worker lattice boot, zero builds.
        cold_boot = {name: scrape(name) for name in fleet.workers}
        log(f"fleet: cold boot counters {cold_boot}")

        # ---- Reference tracks + targets (deterministic fits) ---------
        betas, targets, ref_frames = _stream_tracks(
            prm32, dev, rng, tracks, frames_per_stream, max_bucket,
            max_subjects)

        # ---- Phase 2: warm the fit stage on EVERY worker -------------
        for name in fleet.workers:
            wcli = EdgeClient(host, ports[name], timeout_s=60.0)
            with wcli.open_stream(betas=betas[0],
                                  frame_deadline_s=frame_deadline_s) as ws:
                ws.frame(targets[0, 0])
            wcli.close()

        # The drill's stream fleet, all through the proxy.
        clients = []
        stream_clis = []
        for s in range(streams):
            cli = EdgeClient(host, fleet.proxy.port,
                             timeout_s=client_timeout_s)
            st = cli.open_stream(betas=betas[s % tracks],
                                 frame_deadline_s=frame_deadline_s)
            clients.append(cli)
            stream_clis.append(st)
        log(f"fleet: {streams} live streams open through the proxy "
            f"({tracks} distinct tracks)")

        outcomes = {"ok": 0, "http_error": 0, "exception": 0}
        got = [[None] * frames_per_stream for _ in range(streams)]
        rec_lock = threading.Lock()

        def step(s: int, f: int):
            try:
                fr = stream_clis[s].frame(targets[s % tracks, f])
                with rec_lock:
                    outcomes["ok"] += 1
                    got[s][f] = fr
            except EdgeError as e:
                with rec_lock:
                    outcomes["http_error"] += 1
                    got[s][f] = ("http", e.status, e.kind)
            except Exception as e:  # noqa: BLE001 — NOT a terminal
                with rec_lock:
                    outcomes["exception"] += 1
                    got[s][f] = ("exc", type(e).__name__, str(e)[:120])

        pool = ThreadPoolExecutor(max_workers=stream_workers)

        def wave(f: int):
            list(pool.map(lambda s: step(s, f), range(streams)))

        # Settle wave 0, then everything after is steady state.
        t_w0 = time.monotonic()
        wave(0)
        wave0_wall = time.monotonic() - t_w0
        baseline = {name: scrape(name) for name in fleet.workers}

        # ---- Phase 3: chaos. SIGKILL mid-wave, then drain. -----------
        load = {be.name: len(be.streams)
                for be in fleet.proxy.backends().values()}
        kill_victim = max(load, key=lambda n: load[n])
        t_w1 = time.monotonic()
        killer_fired = threading.Event()

        def killer():
            # Mid-wave: frames are on the wire when the SIGKILL lands.
            time.sleep(min(0.05, wave0_wall / 4))
            fleet.kill_worker(kill_victim)
            killer_fired.set()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        wave(1)
        kt.join(timeout=30.0)
        kill_wave_wall = time.monotonic() - t_w1
        log(f"fleet: killed {kill_victim} (hosted "
            f"{load[kill_victim]} streams) mid-wave; wave 1 resolved "
            f"in {kill_wave_wall:.1f}s, migrations so far "
            f"{fleet.proxy.migrations}")

        load2 = {be.name: len(be.streams)
                 for be in fleet.proxy.backends().values()
                 if be.name != kill_victim}
        drain_victim = max(load2, key=lambda n: load2[n])
        t_dr = time.monotonic()
        drain_report = fleet.drain_worker(
            drain_victim, migrate_timeout_s=drain_budget_s,
            term_timeout_s=max(30.0, drain_budget_s * 3))
        drain_wall = time.monotonic() - t_dr
        log(f"fleet: drained {drain_victim} (hosted "
            f"{load2[drain_victim]} streams): migrated "
            f"{drain_report.get('streams_migrated')} in "
            f"{drain_report.get('wall_s')}s (budget {drain_budget_s}s, "
            f"clean={drain_report.get('clean')})")

        for f in range(2, frames_per_stream):
            wave(f)
        pool.shutdown(wait=True)

        closes_ok = 0
        close_errors = []
        for s in range(streams):
            try:
                stream_clis[s].close()
                closes_ok += 1
            except Exception as e:  # noqa: BLE001
                close_errors.append(f"{type(e).__name__}: {e}"[:120])
            clients[s].close()

        proxy_counters = {
            "migrations": fleet.proxy.migrations,
            "migrated_frames": fleet.proxy.migrated_frames,
            "frames_relayed": fleet.proxy.frames_relayed,
            "reroutes": fleet.proxy.reroutes,
            "upstream_failures": fleet.proxy.upstream_failures,
            "streams_opened": fleet.proxy.streams_opened,
        }

        # ---- Phase 4: teardown + cross-process aggregation -----------
        reports = fleet.stop(timeout_s=max(30.0, drain_budget_s * 3))
    finally:
        try:
            fleet.stop(timeout_s=30.0)
        except Exception:  # noqa: BLE001 — teardown must finish
            pass

    # Parity, two tiers. (1) POSE bit-equality — intra-fleet AND
    # against the in-process reference: the pose chain IS the fit state
    # the migration handoff transfers (resume_pose), the fits are
    # deterministic and run per-stream, so a migrated stream's poses
    # must be IDENTICAL to an unmigrated sibling's and to the reference.
    # (2) VERTS at f32 tolerance: verts ride the coalesced batch, and
    # WHICH bucket serves a batch varies run to run (a row rounds by
    # batch size), with no chaos at all.
    frames_expected = streams * frames_per_stream
    parity_err = 0.0
    pose_err = 0.0
    intra_err = 0.0
    intra_pose_err = 0.0
    numbering_ok = 0
    compared = 0
    canon = {}
    for s in range(streams):
        for f in range(frames_per_stream):
            fr = got[s][f]
            if not hasattr(fr, "verts"):
                continue
            compared += 1
            ref = ref_frames[s % tracks][f]
            parity_err = max(parity_err, float(
                np.max(np.abs(fr.verts - ref.verts))))
            pose_err = max(pose_err, float(
                np.max(np.abs(fr.pose - ref.pose))))
            first = canon.setdefault((s % tracks, f), fr)
            if first is not fr:
                intra_err = max(intra_err, float(
                    np.max(np.abs(fr.verts - first.verts))))
                intra_pose_err = max(intra_pose_err, float(
                    np.max(np.abs(fr.pose - first.pose))))
            if fr.frame == f:
                numbering_ok += 1

    # Steady builds: exit-line counters minus the post-warm baselines.
    # The SIGKILLed worker is excluded by construction (no exit line —
    # its counters and spans died with it).
    steady_by_worker = {}
    aot_failures = 0
    for name, rep in reports.items():
        if rep is None:
            steady_by_worker[name] = None
            continue
        cnt = rep.get("counters") or {}
        steady_by_worker[name] = (
            int(cnt.get("compiles", 0))
            - baseline.get(name, {}).get("compiles", 0))
        aot_failures += int(cnt.get("aot_load_failures", 0))
    spans_by_worker, spans_balanced = _exit_spans(reports)
    steady_total = sum(v for v in steady_by_worker.values()
                       if v is not None)

    if own_work_dir:
        shutil.rmtree(work_dir, ignore_errors=True)

    terminals = outcomes["ok"] + outcomes["http_error"]
    return {
        "fleet_drill_schema": 1,
        # The workers and the in-process reference both run on this
        # device type; JAX's judge applies the exact-zero in-process
        # pose anchor only when it is "cpu" (intra-fleet bit-equality
        # is judged always).
        "reference_platform": dev.type,
        "workers": int(workers),
        "lanes": int(lanes),
        "streams": int(streams),
        "frames_per_stream": int(frames_per_stream),
        "unique_tracks": int(tracks),
        "max_bucket": int(max_bucket),
        "max_subjects": int(max_subjects),
        "store_warm_capacity": int(store_warm_capacity),
        "lattice_entries": len(manifest["entries"]),
        "bake_wall_s": float(f"{bake_wall:.4g}"),
        "boot_wall_s": float(f"{boot_wall:.4g}"),
        "cold_boot": cold_boot,
        "cold_boot_zero_compiles": all(
            c["compiles"] == 0 and c["aot_loads"] > 0
            and c["aot_load_failures"] == 0
            for c in cold_boot.values()),
        "frames_expected": int(frames_expected),
        "outcomes": outcomes,
        "terminal_fraction": float(
            f"{terminals / frames_expected:.6g}") if frames_expected
            else None,
        "closes_ok": int(closes_ok),
        "close_errors": close_errors[:5],
        "frames_compared": int(compared),
        "frame_numbering_ok": int(numbering_ok),
        "intra_fleet_max_abs_err": intra_err,
        "intra_fleet_pose_max_abs_err": intra_pose_err,
        "wire_vs_inprocess_max_abs_err": parity_err,
        "wire_vs_inprocess_pose_max_abs_err": pose_err,
        "kill": {
            "victim": kill_victim,
            "streams_hosted": int(load[kill_victim]),
            "fired_mid_wave": bool(killer_fired.is_set()),
            "wave_wall_s": float(f"{kill_wave_wall:.4g}"),
        },
        "drain": {
            "victim": drain_victim,
            "streams_hosted": int(load2[drain_victim]),
            "budget_s": float(drain_budget_s),
            "wall_s": drain_report.get("wall_s"),
            "clean": bool(drain_report.get("clean")),
            "streams_migrated": drain_report.get("streams_migrated"),
            "total_wall_s": float(f"{drain_wall:.4g}"),
        },
        "proxy": proxy_counters,
        "steady_recompiles_by_worker": steady_by_worker,
        "steady_recompiles_total": int(steady_total),
        "aot_load_failures_total": int(aot_failures),
        "spans_by_worker": spans_by_worker,
        "spans_closed_exactly_once": bool(spans_balanced),
        "worker_exit_reports": {
            name: (None if rep is None else {
                k: rep.get(k) for k in
                ("drained", "incident_captures")})
            for name, rep in reports.items()},
    }


def _free_ports(host: str, n: int) -> list:
    """``n`` distinct free ports: bound all at once (so the kernel makes
    them distinct), then released for the fixed-port heal contract."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def selfheal_drill_run(
    params,
    *,
    workers: int = 3,
    lanes: int = 2,
    streams: int = 12,
    frames_per_stream: int = 7,
    stream_workers: int = 8,
    unique_tracks: int = 4,
    max_bucket: int = 8,
    max_subjects: int = 32,
    store_warm_capacity: int = 16,
    campaign: str = "kill_worker@0.2s, kill_proxy@1.5s, partition:25@3s",
    store_campaign: str = "damage_page@0s",
    mttr_budget_ms: float = 300000.0,
    restart_budget: int = 6,
    budget_window_s: float = 900.0,
    probe_interval_s: float = 0.25,
    probe_timeout_s: float = 2.0,
    failure_threshold: int = 3,
    heal_timeout_s: float = 300.0,
    ready_timeout_s: float = 420.0,
    frame_deadline_s: float = 120.0,
    client_timeout_s: float = 60.0,
    storm_leg: bool = True,
    work_dir=None,
    seed: int = 0,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """THE self-healing chaos campaign: every recovery tier drilled end
    to end, with ZERO human invocations — detection and repair belong
    to the supervisor/standby/overlay, the drill only schedules faults
    and measures (JAX's ``selfheal_drill_run``, its arguments, protocol
    and keys, plus ``device=``).

    **Leg A — process campaign.** ``workers`` fixed-port ``serve``
    processes on ``device`` (``--warm-streams``, the per-lane lattice)
    supervised by a ``FleetSupervisor``; an active/standby ``proxy``
    :class:`~mano_hand_tpu_torch.edge.fleet.ProxyPair` behind one
    flock-arbitered service port; ``streams``
    :class:`~mano_hand_tpu_torch.edge.client.ResilientStream` clients. A
    seeded :class:`~mano_hand_tpu_torch.runtime.chaos.ChaosCampaign`
    (``KIND[:PARAM]@Ts`` grammar) then fires ``kill_worker`` (SIGKILL a
    worker — the supervisor's exit-line channel), ``kill_proxy``
    (SIGKILL the ACTIVE proxy — flock takeover, clients
    reconnect-and-resume), and ``partition`` (SIGSTOP a worker: the
    process lives, ``/healthz`` stops — the supervisor's breaker
    channel; a SIGCONT backstop fires at ``:PARAM`` seconds in case the
    supervisor is the thing that broke). Judgment inputs: every frame
    reaches an HTTP terminal with CONTINUOUS numbering, pose chains
    stay bit-equal to the in-process reference, heals == scheduled
    deaths with the post-heal steady wave building NOTHING, per-heal
    MTTR within ``mttr_budget_ms``, spans closed exactly once on every
    worker that reported an exit line.

    **Leg C — restart storm** (rides the same fleet, after the steady
    check): a fresh supervisor with ``restart_budget=1`` takes one kill
    (heals) and then a second (budget exhausted) — the drill passes
    only if the second death DEGRADES (worker abandoned, incident
    recorded, surviving workers still serve a fresh stream) instead of
    flapping.

    **Leg B — in-process store/lane tier.** A sharded ``lanes``-lane
    engine on ``device`` over a warm+cold ``SubjectStore``: force one
    lane's breaker DOWN — the next dead-shard placement AUTO-kicks the
    shard rebalance, after which the dead lane's subjects serve
    bit-identical with 0 builds. Then a second seeded campaign fires
    ``damage_page`` against one COLD row page (``io/state_ckpt.py``'s
    row pages): the next access is a COUNTED re-bake (never an error)
    and the result stays bit-identical. The policy's CPU tier is on for
    a CPU engine only (a card engine has none).

    Each worker's environment carries nothing of XLA. The sockets are
    loopback.
    """
    import os
    import shutil
    import signal as signal_mod
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from mano_hand_tpu_torch.edge import (
        EdgeClient,
        EdgeError,
        Fleet,
        FleetSupervisor,
        ProxyPair,
        ProxySpec,
        ResilientStream,
        WorkerSpec,
    )
    from mano_hand_tpu_torch.io import state_ckpt
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime import health as health_mod
    from mano_hand_tpu_torch.runtime.chaos import ChaosCampaign
    from mano_hand_tpu_torch.runtime.health import CircuitBreaker
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving.engine import ServingEngine
    from mano_hand_tpu_torch.serving.subject_store import (
        SubjectStore,
        SubjectStoreConfig,
    )

    if workers < 3:
        raise ValueError(f"workers must be >= 3 (kill one, partition "
                         f"one, serve on the rest), got {workers}")
    if frames_per_stream < 6:
        raise ValueError(
            f"frames_per_stream must be >= 6 (settle + >=2 chaos + "
            f"post-heal settle + steady waves), got {frames_per_stream}")
    # Parse up front: a bad campaign spec must fail before any process
    # boots. The process leg takes exactly the three process kinds.
    proc_campaign = ChaosCampaign(campaign, seed=seed)
    bad = sorted({e.kind for e in proc_campaign.events}
                 - {"kill_worker", "kill_proxy", "partition"})
    if bad:
        raise ValueError(f"process campaign kinds {bad} not drillable "
                         "here (damage_page is the store campaign's)")
    expected_heals = sum(1 for e in proc_campaign.events
                         if e.kind in ("kill_worker", "partition"))
    expected_takeovers = sum(1 for e in proc_campaign.events
                             if e.kind == "kill_proxy")
    if restart_budget < expected_heals + 2:
        raise ValueError(
            f"restart_budget {restart_budget} cannot absorb "
            f"{expected_heals} scheduled deaths plus boot-failure "
            "retries")
    log = _logger(log)
    dev = resolve_device(device)
    host = "127.0.0.1"
    n_joints, n_shape = params.n_joints, params.n_shape
    rng = np.random.default_rng(seed)
    prm32 = params.astype(torch.float32).to(dev)
    tracks = min(max(1, unique_tracks), streams)

    own_work_dir = work_dir is None
    if own_work_dir:
        work_dir = tempfile.mkdtemp(prefix="mano_selfheal_drill_")
    aot_dir = os.path.join(work_dir, "aot")
    log_dir = os.path.join(work_dir, "logs")
    os.makedirs(aot_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)

    ports = _free_ports(host, workers + 1)
    service_port = ports[-1]
    worker_ports = {f"w{i}": ports[i] for i in range(workers)}

    # ---- Phase 1: bake the per-lane lattice ---------------------------
    t_bake0 = time.monotonic()
    bake_eng = ServingEngine(
        prm32, device=dev, max_bucket=max_bucket, aot_dir=aot_dir,
        lanes=lanes, max_subjects=max_subjects,
        subject_store=SubjectStore(SubjectStoreConfig(
            warm_capacity=store_warm_capacity, sharded=True)))
    manifest = bake_eng.bake_lattice(include_cpu_fallback=False)
    bake_wall = time.monotonic() - t_bake0
    log(f"selfheal: baked {len(manifest['entries'])} lattice entries "
        f"in {bake_wall:.1f}s")

    # FIXED ports + --warm-streams: the replacement a heal boots binds
    # the dead worker's own port after a full warm pass (fit-stage
    # programs are not in the lattice), so it re-enters the standby
    # pair's STATIC routing with zero wiring calls and zero steady
    # builds.
    env = _worker_env()
    specs = [WorkerSpec(device=dev.type, lanes=lanes,
                        max_bucket=max_bucket,
                        max_delay_ms=1.0, max_subjects=max_subjects,
                        aot_dir=aot_dir,
                        store_warm_capacity=store_warm_capacity,
                        warm_streams=True,
                        drain_timeout_s=15.0,
                        port=worker_ports[f"w{i}"])
             for i in range(workers)]
    fleet = Fleet(specs, env=env, stderr_dir=log_dir, external_proxy=True,
                  log=lambda m: log(f"selfheal: {m}"))
    pair = ProxyPair(
        ProxySpec(port=service_port,
                  lock_path=os.path.join(work_dir, "proxy.lock"),
                  backends=[(n, host, p)
                            for n, p in worker_ports.items()],
                  drain_timeout_s=10.0,
                  upstream_timeout_s=client_timeout_s * 4),
        env=env, stderr_dir=log_dir, log=lambda m: log(f"selfheal: {m}"))
    sup = FleetSupervisor(
        fleet, poll_interval_s=0.05,
        probe_interval_s=probe_interval_s,
        probe_timeout_s=probe_timeout_s,
        failure_threshold=failure_threshold,
        restart_budget=restart_budget,
        budget_window_s=budget_window_s,
        ready_timeout_s=ready_timeout_s,
        log=lambda m: log(f"selfheal: {m}"))
    sup2 = None

    def scrape(name: str):
        cli = EdgeClient(host, worker_ports[name], timeout_s=30.0)
        try:
            text = cli.metrics_text()
        except Exception:  # noqa: BLE001 — a dead worker scrapes None
            return None
        finally:
            cli.close()
        return {k: int(_prom_value(text, f"mano_serving_{k}") or 0)
                for k in ("compiles", "aot_loads", "aot_load_failures")}

    t_boot0 = time.monotonic()
    fleet.start(ready_timeout_s=ready_timeout_s)
    try:
        pair.start(timeout_s=60.0)
        boot_wall = time.monotonic() - t_boot0
        log(f"selfheal: {workers} fixed-port workers + proxy pair up "
            f"in {boot_wall:.1f}s (service :{service_port})")

        boot_counters = {name: scrape(name) for name in fleet.workers}
        lattice_boot_ok = all(
            c is not None and c["aot_loads"] > 0
            and c["aot_load_failures"] == 0
            for c in boot_counters.values())

        # ---- Reference tracks (deterministic fits) -------------------
        betas, targets, ref_frames = _stream_tracks(
            prm32, dev, rng, tracks, frames_per_stream, max_bucket,
            max_subjects)

        # ---- Streams: reconnect-and-resume clients -------------------
        stream_clis = [
            ResilientStream(host, service_port,
                            timeout_s=client_timeout_s,
                            betas=betas[s % tracks],
                            max_reconnects=12,
                            reconnect_backoff_s=0.1,
                            reconnect_timeout_s=60.0,
                            frame_deadline_s=frame_deadline_s)
            for s in range(streams)]
        log(f"selfheal: {streams} resilient streams open through the "
            f"pair ({tracks} distinct tracks)")

        outcomes = {"ok": 0, "http_error": 0, "exception": 0}
        got = [[None] * frames_per_stream for _ in range(streams)]
        rec_lock = threading.Lock()

        def step(s: int, f: int):
            try:
                fr = stream_clis[s].frame(targets[s % tracks, f])
                with rec_lock:
                    outcomes["ok"] += 1
                    got[s][f] = fr
            except EdgeError as e:
                with rec_lock:
                    outcomes["http_error"] += 1
                    got[s][f] = ("http", e.status, e.kind)
            except Exception as e:  # noqa: BLE001 — NOT a terminal
                with rec_lock:
                    outcomes["exception"] += 1
                    got[s][f] = ("exc", type(e).__name__, str(e)[:120])

        pool = ThreadPoolExecutor(max_workers=stream_workers)

        def wave(f: int):
            list(pool.map(lambda s: step(s, f), range(streams)))

        wave(0)                                         # settle
        sup.start()

        # ---- Leg A: the campaign fires under live waves --------------
        takeover_walls = []

        def on_kill_worker(ev):
            alive = [n for n, w in fleet.workers.items() if w.alive()]
            victim = proc_campaign.pick(alive)
            if victim is None:
                raise RuntimeError("no live worker to kill")
            fleet.kill_worker(victim)
            return victim

        def on_kill_proxy(ev):
            t0 = time.monotonic()
            victim = pair.kill_active()
            pair.wait_active(timeout_s=60.0)
            dt_ms = (time.monotonic() - t0) * 1e3
            takeover_walls.append(round(dt_ms, 1))
            return {"victim": victim,
                    "takeover_ms": round(dt_ms, 1)}

        def on_partition(ev):
            alive = [n for n, w in fleet.workers.items() if w.alive()]
            victim = proc_campaign.pick(alive)
            if victim is None:
                raise RuntimeError("no live worker to partition")
            pid = fleet.workers[victim].pid
            os.kill(pid, signal_mod.SIGSTOP)

            def backstop():
                # Only matters if the supervisor ITSELF failed: its heal
                # SIGKILLs the stopped remains long before this.
                try:
                    os.kill(pid, signal_mod.SIGCONT)
                except OSError:
                    pass

            t = threading.Timer(ev.param, backstop)
            t.daemon = True
            t.start()
            return {"victim": victim, "stopped_pid": pid,
                    "sigcont_backstop_s": ev.param}

        proc_campaign.on("kill_worker", on_kill_worker)
        proc_campaign.on("kill_proxy", on_kill_proxy)
        proc_campaign.on("partition", on_partition)
        proc_campaign.start()

        t_chaos0 = time.monotonic()
        for f in range(1, frames_per_stream - 2):        # chaos waves
            wave(f)
        last_event_s = (proc_campaign.events[-1].at_s
                        if proc_campaign.events else 0.0)
        campaign_done = proc_campaign.join(
            timeout_s=last_event_s + 120.0)

        # Wait until the supervisor healed every scheduled death
        # (bounded — a heal that never lands is the drill's failure,
        # not its hang).
        t_heal0 = time.monotonic()
        heal_deadline = t_heal0 + heal_timeout_s
        while time.monotonic() < heal_deadline:
            if sup.load()["fleet"]["restarts"] >= expected_heals:
                break
            time.sleep(0.1)
        heal_wait_wall = time.monotonic() - t_heal0
        chaos_wall = time.monotonic() - t_chaos0

        wave(frames_per_stream - 2)                      # post-heal settle
        baseline2 = {name: scrape(name) for name in fleet.workers}
        wave(frames_per_stream - 1)                      # steady
        final_counters = {name: scrape(name) for name in fleet.workers}
        pool.shutdown(wait=True)

        # Post-heal steady builds: scraped live over the fixed ports
        # (exit lines would miss the healed workers' baselines).
        steady_by_worker = {}
        for name in fleet.workers:
            b2, fc = baseline2.get(name), final_counters.get(name)
            steady_by_worker[name] = (
                None if b2 is None or fc is None
                else fc["compiles"] - b2["compiles"])
        steady_total = sum(v for v in steady_by_worker.values()
                           if v is not None)

        closes_ok = 0
        close_errors = []
        reconnects_total = 0
        for s in range(streams):
            reconnects_total += stream_clis[s].reconnects
            try:
                stream_clis[s].close()
                closes_ok += 1
            except Exception as e:  # noqa: BLE001
                close_errors.append(f"{type(e).__name__}: {e}"[:120])

        sup_ledger = sup.load()["fleet"]
        sup.stop()

        # ---- Leg C: restart storm -> degraded + incident -------------
        storm = None
        if storm_leg:
            sup2 = FleetSupervisor(
                fleet, poll_interval_s=0.05,
                probe_interval_s=probe_interval_s,
                probe_timeout_s=probe_timeout_s,
                failure_threshold=failure_threshold,
                restart_budget=1, budget_window_s=3600.0,
                ready_timeout_s=ready_timeout_s,
                log=lambda m: log(f"selfheal-storm: {m}"))
            sup2.start()
            victim = sorted(n for n, w in fleet.workers.items()
                            if w.alive())[0]
            fleet.kill_worker(victim)
            d1 = time.monotonic() + heal_timeout_s
            while (time.monotonic() < d1
                   and sup2.load()["fleet"]["restarts"] < 1):
                time.sleep(0.1)
            fleet.kill_worker(victim)            # budget now exhausted
            d2 = time.monotonic() + 60.0
            while time.monotonic() < d2:
                led = sup2.load()["fleet"]
                if led["incidents"] >= 1 and victim in led["abandoned"]:
                    break
                time.sleep(0.1)
            storm_ledger = sup2.load()["fleet"]
            sup2.stop()
            sup2 = None
            # Degraded-but-serving: a FRESH stream through the pair must
            # still produce bit-exact frames off the survivors.
            deg_err = None
            deg_frames = 0
            try:
                rs = ResilientStream(host, service_port,
                                     timeout_s=client_timeout_s,
                                     betas=betas[0], max_reconnects=12,
                                     reconnect_timeout_s=60.0,
                                     frame_deadline_s=frame_deadline_s)
                try:
                    deg_err = 0.0
                    for f in range(2):
                        fr = rs.frame(targets[0, f])
                        deg_err = max(deg_err, float(np.max(np.abs(
                            fr.pose - ref_frames[0][f].pose))))
                        deg_frames += 1
                finally:
                    rs.abort()
            except Exception as e:  # noqa: BLE001 — recorded, judged
                close_errors.append(
                    f"storm-degraded: {type(e).__name__}: {e}"[:120])
            storm = {
                "victim": victim,
                "restarts": storm_ledger["restarts"],
                "deaths_detected": storm_ledger["deaths_detected"],
                "incidents": storm_ledger["incidents"],
                "incident_log": storm_ledger["incident_log"],
                "abandoned": storm_ledger["abandoned"],
                "budget_left": storm_ledger["budget"]["left"],
                "degraded_frames_ok": deg_frames,
                "degraded_pose_max_abs_err": deg_err,
                "degraded_without_flap": bool(
                    storm_ledger["restarts"] == 1
                    and storm_ledger["incidents"] == 1
                    and victim in storm_ledger["abandoned"]),
            }
            log(f"selfheal: storm leg — {storm['restarts']} heal, "
                f"{storm['incidents']} incident, abandoned "
                f"{storm['abandoned']}, degraded serve err={deg_err}")

        # Takeover facts from the surviving active proxy itself.
        proxy_health = None
        try:
            hcli = EdgeClient(host, service_port, timeout_s=10.0)
            h = hcli.healthz()
            hcli.close()
            proxy_health = {"proxy_role": h.get("proxy_role"),
                            "takeovers": h.get("takeovers")}
        except Exception as e:  # noqa: BLE001 — recorded, judged
            close_errors.append(
                f"proxy-healthz: {type(e).__name__}: {e}"[:120])

        proxy_reports = pair.stop(timeout_s=30.0)
        reports = fleet.stop(timeout_s=60.0)
    finally:
        try:
            if sup2 is not None:
                sup2.stop()
            sup.stop()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        try:
            proc_campaign.stop()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        try:
            pair.stop(timeout_s=10.0)
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        try:
            fleet.stop(timeout_s=30.0)
        except Exception:  # noqa: BLE001 — teardown must finish
            pass

    # ---- Leg A parity + spans (same bars as the fleet drill) ---------
    frames_expected = streams * frames_per_stream
    pose_err = 0.0
    verts_err = 0.0
    numbering_ok = 0
    compared = 0
    for s in range(streams):
        for f in range(frames_per_stream):
            fr = got[s][f]
            if not hasattr(fr, "verts"):
                continue
            compared += 1
            ref = ref_frames[s % tracks][f]
            pose_err = max(pose_err, float(
                np.max(np.abs(fr.pose - ref.pose))))
            verts_err = max(verts_err, float(
                np.max(np.abs(fr.verts - ref.verts))))
            if fr.frame == f:
                numbering_ok += 1
    spans_by_worker, spans_balanced = _exit_spans(reports)

    mttr_ms = list(sup_ledger["mttr_ms"])
    mttr_p99 = (float(np.percentile(mttr_ms, 99)) if mttr_ms else None)

    # ---- Leg B: shard rebalance + cold-page damage (in-process) ------
    log("selfheal: leg B — in-process shard rebalance + damage_page")
    n_b = 6
    betas_b = [rng.normal(size=(n_shape,)).astype(np.float32)
               for _ in range(n_b)]
    poses_b = [rng.normal(scale=0.4,
                          size=(2, n_joints, 3)).astype(np.float32)
               for _ in range(n_b)]
    with ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                       max_delay_s=0.001) as ref_b:
        keys_r = [ref_b.specialize(b) for b in betas_b]
        want_b = [ref_b.forward(poses_b[i], subject=keys_r[i])
                  for i in range(n_b)]

    cold_dir = os.path.join(work_dir, "cold")
    store_b = SubjectStore(SubjectStoreConfig(
        warm_capacity=2, cold_dir=cold_dir, sharded=True,
        backend="pickle"))
    lane_ok = [True] * lanes
    policy_b = DispatchPolicy(
        deadline_s=30.0, retries=1, backoff_s=0.005,
        backoff_cap_s=0.01, jitter=0.0,
        breaker=CircuitBreaker(failure_threshold=2,
                               probe_interval_s=0.001,
                               respect_priority_claim=False),
        cpu_fallback=dev.type == "cpu")
    rebalance = {}
    damage = {}
    store_campaign_fired = []
    with ServingEngine(prm32, device=dev, max_bucket=max_bucket,
                       max_delay_s=0.002, policy=policy_b, lanes=lanes,
                       lane_probe=lambda i: lane_ok[i],
                       max_subjects=4,
                       subject_store=store_b) as eng_b:
        keys_b = [eng_b.specialize(b) for b in betas_b]
        pre_err = 0.0
        for i in range(n_b):                     # warm every program
            got_b = eng_b.forward(poses_b[i], subject=keys_b[i])
            pre_err = max(pre_err, float(
                np.abs(got_b - want_b[i]).max()))
        shards_pop = sorted({store_b.shard_for(k) for k in keys_b})
        dead = store_b.shard_for(keys_b[0])
        owned = [i for i in range(n_b)
                 if store_b.shard_for(keys_b[i]) == dead]
        base_b = eng_b.counters.snapshot()
        # Lane loss: probe pinned false + breaker driven DOWN through
        # its public API (never a raw state poke).
        lane_ok[dead] = False
        lane_set = eng_b._get_lanes()
        br = lane_set.lanes[dead].breaker
        for _ in range(64):
            if br is None or br.record_failure() == health_mod.DOWN:
                break
        # The next dead-shard placement AUTO-kicks the rebalance; the
        # drill never calls it (0 human invocations).
        trigger = eng_b.forward(poses_b[owned[0]],
                                subject=keys_b[owned[0]])
        reb_deadline = time.monotonic() + 60.0
        while (eng_b.counters.snapshot()["shard_rebalances"] < 1
               and time.monotonic() < reb_deadline):
            time.sleep(0.02)
        reb_err = float(np.abs(trigger - want_b[owned[0]]).max())
        for i in owned:                          # adopted-shard serving
            got_b = eng_b.forward(poses_b[i], subject=keys_b[i])
            reb_err = max(reb_err, float(
                np.abs(got_b - want_b[i]).max()))
        after_b = eng_b.counters.snapshot()
        rebalance = {
            "dead_shard": int(dead),
            "shards_populated": shards_pop,
            "owned_subjects": len(owned),
            "pre_loss_max_abs_err": pre_err,
            "shard_rebalances": int(after_b["shard_rebalances"]),
            "rebalance_rows": int(after_b["shard_rebalance_rows"]),
            "steady_recompiles": int(after_b["compiles"]
                                     - base_b["compiles"]),
            "max_abs_err": reb_err,
            "reassigned": store_b.snapshot().get("reassigned_shards"),
        }
        log(f"selfheal: rebalanced shard {dead} "
            f"({rebalance['shard_rebalances']} rebalance, "
            f"{rebalance['rebalance_rows']} rows adopted, "
            f"{rebalance['steady_recompiles']} recompiles, "
            f"err={reb_err})")

        # -- damage_page: seeded store campaign vs the cold tier ------
        camp2 = ChaosCampaign(store_campaign, seed=seed + 1,
                              log=lambda m: log(f"selfheal: {m}"))
        dmg_digest = {}

        def on_damage(ev):
            victim_d = camp2.pick(store_b.cold_digests())
            if victim_d is None:
                raise RuntimeError("no cold page to damage")
            # A page whose per-array hashes verify but whose digest
            # preimage does not — self-consistent, for the WRONG
            # subject.
            _meta, arrays = state_ckpt.load_row_page(victim_d, cold_dir)
            arrays["shape"] = np.asarray(arrays["shape"]) + 1.0
            state_ckpt.save_row_page(victim_d, arrays, cold_dir)
            dmg_digest["digest"] = victim_d
            return victim_d

        camp2.on("damage_page", on_damage).start()
        camp2.join(timeout_s=30.0)
        store_campaign_fired = list(camp2.events_fired)
        dig = dmg_digest.get("digest")
        req_err = None
        dmg_counted = 0
        if dig is not None and dig in keys_b:
            # Push the damaged digest out of the hot table AND the
            # 2-row warm tier so the verification request must read the
            # (damaged) cold page.
            for i in range(n_b):
                if keys_b[i] != dig:
                    eng_b.forward(poses_b[i], subject=keys_b[i])
            dmg_base = eng_b.counters.snapshot()[
                "subject_store_cold_damage"]
            i = keys_b.index(dig)
            got_b = eng_b.forward(poses_b[i], subject=keys_b[i])
            req_err = float(np.abs(got_b - want_b[i]).max())
            dmg_counted = (eng_b.counters.snapshot()[
                "subject_store_cold_damage"] - dmg_base)
        damage = {
            "injected": dig is not None,
            "digest": (dig or "")[:12],
            "damage_counted": int(dmg_counted),
            "request_max_abs_err": req_err,
        }
        log(f"selfheal: damage_page — counted {dmg_counted} re-bake, "
            f"err={req_err}")

    if own_work_dir:
        shutil.rmtree(work_dir, ignore_errors=True)

    terminals = outcomes["ok"] + outcomes["http_error"]
    return {
        "selfheal_drill_schema": 1,
        # The workers and the in-process references both run on this
        # device type; JAX's judge applies the exact-zero pose anchors
        # only when it is "cpu".
        "reference_platform": dev.type,
        "workers": int(workers),
        "lanes": int(lanes),
        "streams": int(streams),
        "frames_per_stream": int(frames_per_stream),
        "unique_tracks": int(tracks),
        "max_bucket": int(max_bucket),
        "max_subjects": int(max_subjects),
        "campaign": campaign,
        "store_campaign": store_campaign,
        "campaign_done": bool(campaign_done),
        "campaign_fired": proc_campaign.events_fired,
        "store_campaign_fired": store_campaign_fired,
        "lattice_entries": len(manifest["entries"]),
        "bake_wall_s": float(f"{bake_wall:.4g}"),
        "boot_wall_s": float(f"{boot_wall:.4g}"),
        "boot_counters": boot_counters,
        "lattice_boot_ok": bool(lattice_boot_ok),
        "chaos_wall_s": float(f"{chaos_wall:.4g}"),
        "frames_expected": int(frames_expected),
        "outcomes": outcomes,
        "terminal_fraction": float(
            f"{terminals / frames_expected:.6g}") if frames_expected
            else None,
        "frames_compared": int(compared),
        "frame_numbering_ok": int(numbering_ok),
        "pose_max_abs_err": pose_err,
        "verts_max_abs_err": verts_err,
        "closes_ok": int(closes_ok),
        "close_errors": close_errors[:8],
        "reconnects_total": int(reconnects_total),
        "takeovers_expected": int(expected_takeovers),
        "takeover_walls_ms": takeover_walls,
        "proxy_health": proxy_health,
        "proxy_exit_reports": {
            name: (None if rep is None else
                   {k: rep.get(k) for k in ("role", "takeovers")})
            for name, rep in proxy_reports.items()},
        "expected_heals": int(expected_heals),
        "heal_wait_wall_s": float(f"{heal_wait_wall:.4g}"),
        "supervisor": sup_ledger,
        "supervisor_restarts": int(sup_ledger["restarts"]),
        "all_deaths_auto_healed": bool(
            sup_ledger["restarts"] >= expected_heals
            and not sup_ledger["abandoned"]),
        "heal_mttr_ms": mttr_ms,
        "heal_p99_mttr_ms": (None if mttr_p99 is None
                             else float(f"{mttr_p99:.5g}")),
        "heal_max_mttr_ms": (max(mttr_ms) if mttr_ms else None),
        "mttr_budget_ms": float(mttr_budget_ms),
        "mttr_within_budget": bool(
            mttr_ms and max(mttr_ms) <= mttr_budget_ms),
        "steady_recompiles_by_worker": steady_by_worker,
        "steady_recompiles_total": int(steady_total),
        "spans_by_worker": spans_by_worker,
        "spans_closed_exactly_once": bool(spans_balanced),
        "storm": storm,
        "storm_restarts": (None if storm is None
                           else int(storm["restarts"])),
        "rebalance": rebalance,
        "damage": damage,
        "worker_exit_reports": {
            name: (None if rep is None else {
                k: rep.get(k) for k in
                ("drained", "incident_captures")})
            for name, rep in reports.items()},
    }


def control_drill_run(
    params,
    *,
    # Trace shape: a flash crowd whose peak offers peak_multiple x the
    # socket-calibrated service rate while the pre-crowd base leaves
    # slack — the controller's cold window. Tier 0 is deliberately a
    # MINORITY share so its offered load stays under capacity even at
    # peak (priority scheduling then keeps its goodput ~flat in both
    # legs and tier-1 served becomes the discriminator).
    trace_kind: str = "flash_crowd",
    trace_seed: int = 7,
    trace_duration_s: float = 2.5,
    base_fraction: float = 0.5,
    peak_multiple: float = 4.0,
    tier0_fraction: float = 0.15,
    crowd_at_fraction: float = 0.35,
    pairs: int = 2,
    # Engine envelope (the edge-drill shape: pool > queue or overload
    # never materializes through blocking clients).
    max_queued: int = 16,
    tier1_quota: int = 4,
    deadline_s: float = 0.6,
    sat_latency_s: float = 0.02,
    max_bucket: int = 8,
    batch_deadline_s: float = 0.5,
    coalesce_base_s: float = 0.004,
    workers: int = 24,
    # Controller cadence for a seconds-long trace: ticks must land
    # INSIDE the pre-crowd window or the grow leg never happens.
    cadence_s: float = 0.05,
    crash_at_fraction: float = 0.5,
    drain_timeout_s: float = 10.0,
    seed: int = 0,
    device=None,
    log: Callable[[str], None] = None,
) -> dict:
    """THE closed-loop control drill: the adaptive controller versus its
    own static defaults on the SAME seeded flash crowd, through the real
    socket, over engines on ``device`` (JAX's protocol, defaults and
    returned keys).

    Protocol:

    1. **Calibrate**: measure this machine's wire service rate (waves
       under quota, through the socket) and scale ONE seeded
       ``traffic.make_trace`` flash crowd off it. The trace is made once;
       its ``serialize()`` sha256 rides the artifact as the determinism
       receipt. Every leg replays the same arrivals.
    2. **Paired legs, interleaved**: ``pairs`` x (static, controlled),
       alternating, each on a FRESH engine + EdgeServer with its own
       tracer (the closed-once accounting is judged per leg). The static
       leg keeps a fixed ``tier1_quota`` of ``max_queued``; the
       controlled leg starts from the SAME statics and lets
       ``serving.control.Controller`` steer quotas, coalesce, bucket bias
       and per-tier Retry-After off live burn rates. Interleaving makes
       machine-load drift cost both arms.
    3. **Crash leg**: one controlled replay whose control thread is
       killed ``crash_at_fraction`` into the trace. The controller must
       revert every actuator to the static defaults, the engine keep
       serving, and every request still reach an HTTP terminal.

    Judgment inputs (the verdict belongs to the caller): controlled
    tier-0 goodput >= static on the pooled pairs AND controlled tier-1
    served STRICTLY greater; no steady builds in any leg; every actuation
    evented (runtime-event count == the counter ledger, per controlled
    leg); spans closed exactly once per leg; the crash leg reverted and
    fully terminal. Burn rates come from ``slo_report`` on each leg's
    exit counters. Saturation is a chaos throttle and the sockets are
    loopback; the traffic is the full family (the plain core on a card).
    """
    import hashlib
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from mano_hand_tpu_torch.edge import EdgeClient, EdgeError, EdgeServer
    from mano_hand_tpu_torch.obs.metrics import slo_report
    from mano_hand_tpu_torch.ops.common import resolve_device
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy
    from mano_hand_tpu_torch.serving import traffic
    from mano_hand_tpu_torch.serving.control import ControlConfig, Controller
    from mano_hand_tpu_torch.serving.engine import ServingEngine

    if pairs < 1:
        raise ValueError(f"pairs must be >= 1, got {pairs}")
    if workers < 2:
        raise ValueError(f"workers must be >= 2, got {workers}")
    if trace_duration_s <= 0:
        raise ValueError(
            f"trace_duration_s must be > 0, got {trace_duration_s}")
    if not 0.0 < crash_at_fraction < 1.0:
        raise ValueError(
            f"crash_at_fraction must be in (0, 1), got "
            f"{crash_at_fraction}")
    log = _logger(log)
    dev = resolve_device(device)
    n_joints = params.n_joints
    rng = np.random.default_rng(seed)
    prm32 = params.astype(torch.float32).to(dev)
    host = "127.0.0.1"
    pose1 = rng.normal(scale=0.4, size=(1, n_joints, 3)).astype(
        np.float32)
    plan_spec = f"sat:{sat_latency_s}@0-"
    static_quotas = {1: int(tier1_quota)}

    def fresh_engine(tracer):
        policy = DispatchPolicy(
            deadline_s=batch_deadline_s, retries=0, backoff_s=0.0,
            backoff_cap_s=0.0, jitter=0.0, breaker=None,
            chaos=ChaosPlan(plan_spec),
            # Overload is not a fault; a fallback tier would quietly
            # raise capacity mid-leg.
            cpu_fallback=False,
        )
        eng = ServingEngine(
            prm32, device=dev, max_bucket=max_bucket,
            max_delay_s=coalesce_base_s,
            policy=policy, max_queued=max_queued,
            tier_quotas=dict(static_quotas), tracer=tracer)
        eng.start()
        eng.warmup()
        return eng

    # ---- Calibrate the wire service rate (edge-drill definition) -----
    cal_tracer = Tracer(capacity=32768)
    cal_eng = fresh_engine(cal_tracer)
    cal_srv = EdgeServer(cal_eng, host=host, port=0,
                         drain_timeout_s=drain_timeout_s).start()
    wave = min(max_bucket, max_queued)

    def _cal_one():
        # One client per request: EdgeClient owns one socket and is
        # not safe to share across the wave's threads.
        cli = EdgeClient(host, cal_srv.port, timeout_s=30.0)
        try:
            cli.forward(pose1, priority=0)
        finally:
            cli.close()

    t0 = time.perf_counter()
    served = 0
    for _ in range(3):
        with ThreadPoolExecutor(min(wave, workers)) as px:
            futs = [px.submit(_cal_one) for _ in range(wave)]
            for f in futs:
                f.result(timeout=60.0)
        served += wave
    service_rate = served / (time.perf_counter() - t0)
    cal_srv.drain(timeout_s=drain_timeout_s)

    base_hz = base_fraction * service_rate
    peak_hz = peak_multiple * service_rate
    trace = traffic.make_trace(
        trace_kind, seed=trace_seed, duration_s=trace_duration_s,
        base_hz=base_hz, peak_hz=peak_hz,
        tier0_fraction=tier0_fraction,
        crowd_at_fraction=crowd_at_fraction)
    trace_bytes = traffic.serialize(trace)
    stats = traffic.trace_stats(trace)
    log(f"control: wire service rate {service_rate:,.0f} req/s, trace "
        f"{trace_kind} seed={trace_seed} -> {stats['arrivals']} "
        f"arrivals ({stats['tier0']} tier-0), peak "
        f"{stats['peak_rate_hz']:,.0f} req/s over {trace_duration_s}s")

    # Budget: the engine's resolution window + one wire grace.
    budget_s = deadline_s + batch_deadline_s + 0.5

    def leg_run(name: str, controlled: bool,
                crash_at_s: Optional[float] = None) -> dict:
        tr = Tracer(capacity=32768)
        eng = fresh_engine(tr)
        ctl = None
        if controlled:
            ctl = Controller(eng, config=ControlConfig(
                cadence_s=cadence_s,
                min_actuation_interval_s=2.0 * cadence_s,
                coalesce_max_s=max(coalesce_base_s, 0.004),
                tier1_quota_max_fraction=0.75,
            ), log=log)
            ctl.start()
        srv = EdgeServer(
            eng, host=host, port=0, drain_timeout_s=drain_timeout_s,
            retry_after_source=(None if ctl is None
                                else ctl.retry_after_for)).start()
        compiles_warm = eng.counters.compiles

        tasks: queue_mod.Queue = queue_mod.Queue()
        records: list = []
        rec_lock = threading.Lock()
        _STOP = object()

        def worker():
            cli = EdgeClient(host, srv.port, timeout_s=30.0)
            while True:
                item = tasks.get()
                if item is _STOP:
                    cli.close()
                    return
                tier = item
                t0 = time.monotonic()
                retry_after = None
                try:
                    cli.forward(pose1, priority=tier,
                                deadline_s=deadline_s)
                    out = "ok"
                except EdgeError as e:
                    out = {429: "shed", 504: "expired"}.get(
                        e.status, "error")
                    retry_after = e.retry_after_s
                except Exception:  # noqa: BLE001 — a timeout IS the bug
                    out = "unresolved"
                t1 = time.monotonic()
                with rec_lock:
                    records.append((tier, t0, t1, out, retry_after))

        pool = [threading.Thread(target=worker, daemon=True)
                for _ in range(workers)]
        for t in pool:
            t.start()

        crash_timer = None
        crash_fired = threading.Event()
        if crash_at_s is not None:
            def _inject():
                crash_fired.set()
                # The drill reaches into the controller on purpose:
                # _crash IS the crash path every BaseException in the
                # control loop takes — injecting here exercises the
                # revert contract without faking an exception class.
                ctl._crash(RuntimeError(
                    "control_drill: injected controller crash"))
            crash_timer = threading.Timer(crash_at_s, _inject)
            crash_timer.daemon = True
            crash_timer.start()

        # ---- Replay the ONE trace, paced to its offsets --------------
        t_start = time.monotonic()
        for (t_off, tier) in trace:
            lag = (t_start + t_off) - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            tasks.put(tier)
        submitted = len(trace)
        dl = time.monotonic() + trace_duration_s + 2 * budget_s + 30.0
        drained = False
        while time.monotonic() < dl:
            with rec_lock:
                if len(records) >= submitted:
                    drained = True
                    break
            time.sleep(0.005)
        wall = time.monotonic() - t_start
        if crash_timer is not None:
            crash_timer.cancel()
        # The controller stops (its tick in flight ends) before the
        # reads below, so its counts and its events are of the same
        # ticks; the actuators stay where it left them.
        if ctl is not None:
            ctl.stop()

        # Exit-line bookkeeping BEFORE teardown: the control block and
        # slo_report ride the same load() the controller steered by.
        load_end = eng.load()
        snapc = eng.counters.snapshot()
        slo = slo_report(snapc, None, load_end["latency_by_tier"])
        ctl_block = load_end["control"]
        # The crash contract: every live actuator back at its static
        # default (read the engine, not the controller's claim).
        reverted = (
            eng.max_delay_s == coalesce_base_s
            and eng.max_queued == max_queued
            and eng._tier_quotas == static_quotas
            and eng.bucket_bias == 0)
        for _ in pool:
            tasks.put(_STOP)
        for t in pool:
            t.join(timeout=10.0)
        srv.drain(timeout_s=drain_timeout_s)

        events = tr.snapshot()["events"]
        n_ctl_events = sum(1 for e in events if e[2] == "control")
        n_revert_events = sum(
            1 for e in events if e[2] == "control_revert")
        acc = tr.accounting()

        by_tier = {0: {}, 1: {}}
        retry_after_seen = {0: set(), 1: set()}
        with rec_lock:
            for (tier, _, _, out, ra) in records:
                k = 0 if tier <= 0 else 1
                by_tier[k][out] = by_tier[k].get(out, 0) + 1
                if ra is not None:
                    retry_after_seen[k].add(int(ra))
        t0_total = sum(by_tier[0].values())
        t0_ok = by_tier[0].get("ok", 0)
        unresolved = sum(t.get("unresolved", 0)
                         for t in by_tier.values())
        leg = {
            "name": name,
            "controlled": bool(controlled),
            "submitted": int(submitted),
            "resolved": int(len(records)),
            "drained": bool(drained),
            "unresolved": int(unresolved),
            "by_tier": {str(k): dict(sorted(v.items()))
                        for k, v in by_tier.items()},
            "tier0_goodput": float(
                f"{(t0_ok / t0_total) if t0_total else 1.0:.4g}"),
            "tier0_ok": int(t0_ok),
            "tier0_total": int(t0_total),
            "tier1_ok": int(by_tier[1].get("ok", 0)),
            "tier1_total": int(sum(by_tier[1].values())),
            "retry_after_seen": {
                str(k): sorted(v) for k, v in
                retry_after_seen.items()},
            "steady_recompiles": int(
                eng.counters.compiles - compiles_warm),
            "wall_s": float(f"{wall:.4g}"),
            "control": {
                "ticks": int(ctl_block["ticks"]),
                "actuations": int(ctl_block["actuations"]),
                "reverts": int(ctl_block["reverts"]),
                "crashed": bool(ctl_block["crashed"]),
            },
            "control_events": int(n_ctl_events),
            "control_revert_events": int(n_revert_events),
            "actuations_evented": bool(
                n_ctl_events == ctl_block["actuations"]),
            "reverted_to_static": bool(reverted),
            "slo_burn_rates": {
                t: rep.get("burn_rates", {})
                for t, rep in slo.get("tiers", {}).items()},
            "span_accounting": acc,
            "spans_closed_exactly_once": bool(
                acc["spans_started"] == acc["spans_closed"]
                and acc["spans_open"] == 0),
        }
        if crash_at_s is not None:
            leg["crash_injected"] = bool(crash_fired.is_set())
        log(f"control: leg {name}: tier0 goodput "
            f"{leg['tier0_goodput']:.3f} ({t0_ok}/{t0_total}), tier1 "
            f"served {leg['tier1_ok']}/{leg['tier1_total']}, "
            f"{ctl_block['actuations']} actuations "
            f"({n_ctl_events} evented), steady recompiles "
            f"{leg['steady_recompiles']}, unresolved {unresolved}")
        return leg

    # ---- Paired legs, interleaved ------------------------------------
    legs = []
    for p in range(pairs):
        legs.append(leg_run(f"static_{p}", controlled=False))
        legs.append(leg_run(f"controlled_{p}", controlled=True))
    crash_leg = leg_run(
        "crash", controlled=True,
        crash_at_s=crash_at_fraction * trace_duration_s)

    stat = [l for l in legs if not l["controlled"]]
    ctrl = [l for l in legs if l["controlled"]]

    def pooled_goodput(ls):
        ok = sum(l["tier0_ok"] for l in ls)
        total = sum(l["tier0_total"] for l in ls)
        return float(f"{(ok / total) if total else 1.0:.4g}")

    out = {
        "control_drill_schema": 1,
        "trace": {
            "kind": trace_kind,
            "seed": int(trace_seed),
            "duration_s": float(trace_duration_s),
            "base_hz": float(f"{base_hz:.4g}"),
            "peak_hz": float(f"{peak_hz:.4g}"),
            "tier0_fraction": float(tier0_fraction),
            "sha256": hashlib.sha256(trace_bytes).hexdigest(),
            "stats": stats,
        },
        "service_rate_per_sec": float(f"{service_rate:.4g}"),
        "pairs": int(pairs),
        "legs": legs,
        "crash_leg": crash_leg,
        "static_tier0_goodput": pooled_goodput(stat),
        "controlled_tier0_goodput": pooled_goodput(ctrl),
        "static_tier1_served": int(sum(l["tier1_ok"] for l in stat)),
        "controlled_tier1_served": int(
            sum(l["tier1_ok"] for l in ctrl)),
        "static_tier1_served_per_sec": float(f"""{(
            sum(l["tier1_ok"] for l in stat)
            / max(1e-9, sum(l["wall_s"] for l in stat))):.4g}"""),
        "controlled_tier1_served_per_sec": float(f"""{(
            sum(l["tier1_ok"] for l in ctrl)
            / max(1e-9, sum(l["wall_s"] for l in ctrl))):.4g}"""),
        "steady_recompiles_total": int(
            sum(l["steady_recompiles"] for l in legs + [crash_leg])),
        "unresolved_total": int(
            sum(l["unresolved"] for l in legs + [crash_leg])),
        "actuations_total": int(
            sum(l["control"]["actuations"] for l in ctrl)),
        "actuations_evented": bool(
            all(l["actuations_evented"] for l in ctrl + [crash_leg])),
        "spans_closed_exactly_once": bool(
            all(l["spans_closed_exactly_once"]
                for l in legs + [crash_leg])),
    }
    return out
