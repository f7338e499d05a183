"""The serving engine's drills and the observability protocols.

Port copies of the JAX package's ``serving/measure.py:recovery_drill_run``,
``overload_drill_run``, ``cold_start_drill_run``, ``tracing_overhead_run``,
``metrics_overhead_run``, ``stream_drill_run``,
``dispatch_pipeline_drill_run``, ``lane_drill_run`` and
``subject_store_drill_run`` — the same arguments, protocol and
returned keys (each drill attaches its tracer's ``flight_record``), plus
``device=``. Each drives real ``ServingEngine``s on ``device`` (default
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
