"""The serving engine's drills and the observability protocols.

Port copies of the JAX package's ``serving/measure.py:recovery_drill_run``,
``overload_drill_run``, ``cold_start_drill_run``, ``tracing_overhead_run``
and ``metrics_overhead_run`` — the same arguments, protocol and returned
keys (each drill attaches its tracer's ``flight_record``), plus
``device=``. Each drives real ``ServingEngine``s on ``device`` (default
``cuda``; the CPU tests pass ``"cpu"``) and injects its faults in-process
through ``runtime.chaos``, so no device is harmed. The recovery drill
serves its pose-only half through ``posed_kernel``; the overload drill,
as JAX's, submits full requests only.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

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
    eng = ServingEngine(params32, device=device, max_bucket=max_bucket,
                        max_delay_s=0.001, policy=policy,
                        posed_kernel=posed_kernel, tracer=tracer)
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
