"""Serving counters (what the engine did, as numbers), ``torch_trace``
(a ``torch.profiler`` capture with the engine's span timeline beside it)
and ``Timer`` (accumulated wall-clock time).

A thread-safe subset of the JAX package's ``ServingCounters``: batch
dispatches and the rows in them, the coalescing of requests (and of
subjects) into batches, the subject table's bakes, hits, growths and
evictions, the program cache and its persistence, and the resilience
and admission layer: supervised retries, injected faults, CPU failovers,
deadline kills, sheds, expiries and cancellations, per priority tier;
the pipelined dispatch's completion stage, and the tiered subject
store's hits, misses, movements and promotion stalls. The dispatcher
thread, completion workers, supervision workers and submitters all
write here.

``compiles`` counts the programs built live in this process, the events
JAX counts as a trace and compile: on a card engine each CUDA-graph
capture of an engine program; on a CPU engine each per-(family, bucket[,
capacity][, precision]) callable the engine builds (and
``MANOModel.forward_bucketed``'s per-bucket callables). ``aot_loads``
counts programs served from a baked lattice or artifact instead
(``io/export_aot.py``; on a card, captured after the load),
``aot_load_failures`` each damaged, mismatched or refused one (degraded
to a counted live build, never a crash), and ``subjects_restored`` each
subject-table row revived from a checkpoint without a shape-stage bake.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

#: File name of ``torch_trace``'s capture (``*.trace.json``: what
#: ``obs/trace_report.py`` globs).
TORCH_TRACE = "torch.trace.json"

#: Name of the host span ``torch_trace`` puts around its body: a reader
#: takes the body's window from it, without the pads below.
TRACE_BODY = "torch_trace.body"

#: Seconds the host idles, the card synchronized, inside each end of a
#: CUDA capture. The profiler keeps only the device events that fall
#: inside its window on the host's clock, and a kernel's time, mapped
#: onto that clock, can land milliseconds before the host call that
#: launched it (``chip_smoke.py`` prints the largest such lead of each
#: capture as ``device_lead_us``). Without the pad, a kernel launched
#: just after the capture starts can fall out of it.
CUDA_WINDOW_PAD_S = 0.05

#: Samples kept in a bounded reservoir (the promotion stalls): a ring
#: past this many, as JAX's latency reservoirs.
_LATENCY_RESERVOIR = 8192


class Timer:
    """Accumulating wall-clock timer (the JAX package's ``Timer``). Time
    work on a card only when it ends in a synchronize inside the block:
    CUDA launches return before the work is done.

    >>> t = Timer()
    >>> with t:
    ...     work()
    >>> t.total, t.count, t.mean
    """

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


@contextlib.contextmanager
def torch_trace(log_dir, tracer=None):
    """Capture a ``torch.profiler`` trace of the body: CPU activity, and
    CUDA activity where a card is present. Its Chrome trace lands in
    ``<log_dir>/torch.trace.json``; yields the profiler (``key_averages``
    and friends).

    ``tracer`` (an ``obs.Tracer``) additionally drops the engine's
    host-span timeline as ``<log_dir>/engine.trace.json`` when the capture
    closes, so ``python -m mano_hand_tpu_torch trace-report <log_dir>``
    reads the host and device halves of the SAME window as one report —
    the counterpart of the JAX package's ``utils/profiling.py:xla_trace``.

    The body runs inside a ``TRACE_BODY`` host span. Where a card is
    present, the card is synchronized and the host idles
    ``CUDA_WINDOW_PAD_S`` inside each end of the capture, so that every
    kernel the body launched stays in it.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)

    def pad():
        if cuda:
            torch.cuda.synchronize()
            time.sleep(CUDA_WINDOW_PAD_S)

    prof = profile(activities=activities)
    prof.start()
    try:
        pad()
        with record_function(TRACE_BODY):
            yield prof
    finally:
        try:
            pad()
        finally:
            prof.stop()
        prof.export_chrome_trace(str(out / TORCH_TRACE))
        if tracer is not None:
            # Best-effort inside a finally: a raise here would mask an
            # exception of the body, and a failed co-export must not cost
            # the capture that already landed.
            try:
                (out / "engine.trace.json").write_text(
                    json.dumps(tracer.chrome_trace()))
            except Exception as e:  # noqa: BLE001 — degrade, not crash
                warnings.warn(
                    f"engine-trace co-export into {log_dir} failed "
                    f"({type(e).__name__}: {e}); the profiler capture is "
                    "unaffected")


class ServingCounters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dispatches = 0              # batches sent to the device
        self.dispatches_bf16 = 0         # of them, bf16-family batches
        # Of them, batches of the gathered pose-only family, any kernel
        # or precision (bf16-tier batches, the plain program under
        # posed_kernel="xla" and CPU-tier failovers included); port-only
        # like dispatches_bf16. ``serve``'s exit line carries it beside
        # the worker process's K2 launches.
        self.dispatches_gathered = 0
        # Closed-loop control (serving/control.py): decision sweeps run,
        # knobs actually moved (each also a traced ``control`` runtime
        # event with before/after), and restorations to the static
        # defaults (a crashed or reverting-stopped controller).
        self.control_ticks = 0
        self.control_actuations = 0
        self.control_reverts = 0
        self.rows_live = 0               # real request rows dispatched
        self.rows_padded = 0             # pad rows dispatched alongside them
        self.requests_dispatched = 0     # requests merged across dispatches
        self.mixed_subject_batches = 0   # dispatches mixing >= 2 subjects
        self.specializations = 0         # shape-stage bakes (cache misses)
        self.shaped_hits = 0             # subject-cache hits (bake reused)
        self.table_growths = 0           # subject-table capacity doublings
        self.specializations_evicted = 0  # LRU table-row evictions
        self.compiles = 0                # programs built live (see above)
        self.aot_loads = 0               # programs served from the lattice
        self.aot_load_failures = 0       # lattice entries degraded
        self.subjects_restored = 0       # rows revived from a checkpoint
        self.coalesce_overflows = 0      # requests parked: bucket overflow
        self.queue_depth_peak = 0        # max queued + parked at a dispatch
        # Resilience: the recovery drill's done-criteria read these.
        self.retries = 0             # supervised dispatch retry attempts
        self.faults_injected = 0     # chaos-plan faults fired
        self.failovers = 0           # dispatches served by the CPU tier
        self.deadline_kills = 0      # supervised calls abandoned at deadline
        # Admission: sheds and expiries are work NOT done (by design);
        # cancellations are work the caller withdrew.
        self.shed = 0                # submits refused at admission
        self.expired = 0             # requests expired before/at delivery
        self.cancelled = 0           # futures the caller cancelled
        self.backlog_peak = 0        # max outstanding requests at submit
        self.tier_submitted: Dict[int, int] = {}   # tier -> offered
        self.tier_served: Dict[int, int] = {}      # tier -> results
        self.tier_shed: Dict[int, int] = {}        # tier -> sheds
        self.tier_expired: Dict[int, int] = {}     # tier -> expiries
        self.tier_cancelled: Dict[int, int] = {}   # tier -> cancellations
        # The pipelined dispatch: batches the completion stage resolved
        # (0 at inflight_depth=1), its in-flight high-water, and batches
        # its deadline re-check expired whole without a dispatch.
        self.pipeline_completions = 0
        self.pipeline_inflight_peak = 0
        self.pipeline_presweeps = 0
        # The tiered subject store: per-tier resolutions (hot: already in
        # the table; warm: a host row promoted; cold: a disk page
        # promoted; miss: the shape stage re-ran), the movements, and a
        # damaged cold page degraded to a counted re-bake.
        self.subject_store_hot_hits = 0
        self.subject_store_warm_hits = 0
        self.subject_store_cold_hits = 0
        self.subject_store_misses = 0
        self.subject_store_prefetches = 0
        self.subject_store_promotions = 0
        self.subject_store_demotions_warm = 0
        self.subject_store_demotions_cold = 0
        self.subject_store_cold_damage = 0
        self.subject_store_resize_evictions = 0
        # Shard rebalance on a lane's loss: one per dead shard the
        # surviving lanes adopted, and the hot rows they took over then.
        self.shard_rebalances = 0
        self.shard_rebalance_rows = 0
        self._promotion_stalls: list = []   # seconds; bounded ring
        self._promotion_writes = 0

    def count_dispatch(self, bucket: int, live_rows: int, requests: int = 1,
                       subjects: int = 1, bf16: bool = False,
                       gathered: bool = False) -> None:
        """One batch sent to the device: ``requests`` submits coalesced,
        ``subjects`` distinct subjects in it (>= 2 is a mixed batch),
        served from the bf16 family when ``bf16``, from the gathered
        pose-only family when ``gathered``."""
        with self._lock:
            self.dispatches += 1
            self.dispatches_bf16 += int(bf16)
            self.dispatches_gathered += int(gathered)
            self.rows_live += live_rows
            self.rows_padded += bucket - live_rows
            self.requests_dispatched += requests
            if subjects > 1:
                self.mixed_subject_batches += 1

    def count_specialize(self, hit: bool) -> None:
        """One subject lookup: a miss ran the shape-stage bake."""
        with self._lock:
            if hit:
                self.shaped_hits += 1
            else:
                self.specializations += 1

    def count_table_growth(self, n: int = 1) -> None:
        with self._lock:
            self.table_growths += n

    def count_evict(self, n: int = 1) -> None:
        with self._lock:
            self.specializations_evicted += n

    def count_compile(self, n: int = 1) -> None:
        """One program built live (a capture on a card, a callable on the
        CPU)."""
        with self._lock:
            self.compiles += n

    def count_aot_load(self, n: int = 1) -> None:
        """One program served from a baked lattice entry or artifact."""
        with self._lock:
            self.aot_loads += n

    def count_aot_load_failure(self, n: int = 1) -> None:
        """One lattice entry, manifest or artifact that could NOT be
        served (truncated, corrupted, checksum, schema, digest or platform
        mismatch) and degraded to a live build."""
        with self._lock:
            self.aot_load_failures += n

    def count_restore(self, n: int = 1) -> None:
        """One subject revived from a checkpoint (its row written from
        persisted bytes; no shape-stage bake ran)."""
        with self._lock:
            self.subjects_restored += n

    def count_overflow(self, n: int = 1) -> None:
        """A request parked because admitting it would overflow the
        largest bucket (the other park reasons are not capacity
        events)."""
        with self._lock:
            self.coalesce_overflows += n

    def count_retry(self, n: int = 1) -> None:
        with self._lock:
            self.retries += n

    def count_fault(self, n: int = 1) -> None:
        with self._lock:
            self.faults_injected += n

    def count_failover(self, n: int = 1) -> None:
        with self._lock:
            self.failovers += n

    def count_deadline_kill(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_kills += n

    @staticmethod
    def _bump(ledger: Dict[int, int], tier: int) -> None:
        ledger[tier] = ledger.get(tier, 0) + 1

    def count_tier_submit(self, tier: int = 0) -> None:
        """One submit() OFFERED in this priority tier — counted before
        admission, so shed + expired + cancelled + served + in flight sum
        back to it."""
        with self._lock:
            self._bump(self.tier_submitted, tier)

    def count_served(self, tier: int = 0) -> None:
        """One request resolved with a RESULT (the goodput numerator)."""
        with self._lock:
            self._bump(self.tier_served, tier)

    def count_shed(self, tier: int = 0) -> None:
        """One submit refused at admission (bounded queue / tier quota):
        host bookkeeping only, no device dispatch."""
        with self._lock:
            self.shed += 1
            self._bump(self.tier_shed, tier)

    def count_expired(self, tier: int = 0) -> None:
        """One request whose deadline passed before a result could be
        delivered — swept before dispatch, or expired at readback."""
        with self._lock:
            self.expired += 1
            self._bump(self.tier_expired, tier)

    def count_cancelled(self, tier: int = 0) -> None:
        """One request whose caller called ``future.cancel()`` before a
        result landed."""
        with self._lock:
            self.cancelled += 1
            self._bump(self.tier_cancelled, tier)

    def observe_backlog(self, outstanding: int) -> None:
        with self._lock:
            if outstanding > self.backlog_peak:
                self.backlog_peak = outstanding

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self.queue_depth_peak:
                self.queue_depth_peak = depth

    # -- pipelined dispatch ----------------------------------------------
    def count_pipeline_completion(self, n: int = 1) -> None:
        """One batch resolved by the completion stage (a pipelined
        dispatch)."""
        with self._lock:
            self.pipeline_completions += n

    def observe_pipeline_inflight(self, inflight: int) -> None:
        """The completion stage's in-flight count after a submit
        (launched, not yet resolved batches)."""
        with self._lock:
            if inflight > self.pipeline_inflight_peak:
                self.pipeline_inflight_peak = inflight

    def count_pipeline_presweep(self, n: int = 1) -> None:
        """One batch the stage's deadline re-check expired whole, before
        any dispatch."""
        with self._lock:
            self.pipeline_presweeps += n

    # -- tiered subject store --------------------------------------------
    def count_store_hot(self, n: int = 1) -> None:
        """N batch subjects resolved straight from the device table."""
        with self._lock:
            self.subject_store_hot_hits += n

    def count_store_warm(self, n: int = 1) -> None:
        """One install served from a host warm row (no re-bake)."""
        with self._lock:
            self.subject_store_warm_hits += n

    def count_store_cold(self, n: int = 1) -> None:
        """One install served from a verified cold page (no re-bake)."""
        with self._lock:
            self.subject_store_cold_hits += n

    def count_store_miss(self, n: int = 1) -> None:
        """One install no tier could serve: the shape stage re-ran."""
        with self._lock:
            self.subject_store_misses += n

    def count_store_prefetch(self, n: int = 1) -> None:
        """One asynchronous host-to-device promotion started ahead of
        its dispatch (coalesce admit, ``open_stream``)."""
        with self._lock:
            self.subject_store_prefetches += n

    def count_store_promotion(self, n: int = 1) -> None:
        """One row made device-resident from a lower tier."""
        with self._lock:
            self.subject_store_promotions += n

    def count_store_demotion_warm(self, n: int = 1) -> None:
        """One evicted row captured into the warm tier."""
        with self._lock:
            self.subject_store_demotions_warm += n

    def count_store_demotion_cold(self, n: int = 1) -> None:
        """One warm-LRU victim paged to the cold tier."""
        with self._lock:
            self.subject_store_demotions_cold += n

    def count_store_cold_damage(self, n: int = 1) -> None:
        """One cold page that failed verification (missing, unreadable,
        or a content or digest mismatch), degraded to a counted
        re-bake."""
        with self._lock:
            self.subject_store_cold_damage += n

    def count_store_resize_eviction(self, n: int = 1) -> None:
        """One warm row evicted, oldest first, by a runtime shrink of
        the warm capacity (``SubjectStore.resize_warm``)."""
        with self._lock:
            self.subject_store_resize_evictions += n

    def count_control_tick(self, n: int = 1) -> None:
        """One controller decision sweep, whether or not anything moved."""
        with self._lock:
            self.control_ticks += n

    def count_control_actuation(self, n: int = 1) -> None:
        """One knob the controller moved (quota, coalesce base, bucket
        bias, Retry-After, warm capacity)."""
        with self._lock:
            self.control_actuations += n

    def count_control_revert(self, n: int = 1) -> None:
        """One restoration to the static defaults (a controller crash or
        a reverting stop)."""
        with self._lock:
            self.control_reverts += n

    def count_shard_rebalance(self, rows: int = 0) -> None:
        """One dead shard's subjects adopted by the surviving lanes;
        ``rows`` is how many engine-hot rows the adopters took over at
        once (the rest re-enter through the warm tier on first use)."""
        with self._lock:
            self.shard_rebalances += 1
            self.shard_rebalance_rows += int(rows)

    def record_promotion_stall(self, seconds: float) -> None:
        """What one install waited on a warm promotion (the residual
        after any prefetch overlap), into a bounded ring."""
        with self._lock:
            if len(self._promotion_stalls) >= _LATENCY_RESERVOIR:
                self._promotion_stalls[
                    self._promotion_writes % _LATENCY_RESERVOIR] = seconds
            else:
                self._promotion_stalls.append(seconds)
            self._promotion_writes += 1

    @staticmethod
    def _width_mean(requests_dispatched: int, dispatches: int) -> float:
        return requests_dispatched / dispatches if dispatches else 0.0

    @property
    def coalesce_width_mean(self) -> float:
        """Mean submit() requests merged per dispatch."""
        with self._lock:
            return self._width_mean(self.requests_dispatched,
                                    self.dispatches)

    def snapshot(self) -> dict:
        """Every counter, the derived mean and the per-tier ledgers, read
        under ONE lock hold: a snapshot taken mid-overload is internally
        consistent, never a torn mix of earlier and later writes."""
        with self._lock:
            out = {
                "dispatches": self.dispatches,
                "dispatches_bf16": self.dispatches_bf16,
                "dispatches_gathered": self.dispatches_gathered,
                "control_ticks": self.control_ticks,
                "control_actuations": self.control_actuations,
                "control_reverts": self.control_reverts,
                "rows_live": self.rows_live,
                "rows_padded": self.rows_padded,
                "requests_dispatched": self.requests_dispatched,
                "mixed_subject_batches": self.mixed_subject_batches,
                "specializations": self.specializations,
                "shaped_hits": self.shaped_hits,
                "table_growths": self.table_growths,
                "specializations_evicted": self.specializations_evicted,
                "compiles": self.compiles,
                "aot_loads": self.aot_loads,
                "aot_load_failures": self.aot_load_failures,
                "subjects_restored": self.subjects_restored,
                "coalesce_overflows": self.coalesce_overflows,
                "queue_depth_peak": self.queue_depth_peak,
                "retries": self.retries,
                "faults_injected": self.faults_injected,
                "failovers": self.failovers,
                "deadline_kills": self.deadline_kills,
                "shed": self.shed,
                "expired": self.expired,
                "cancelled": self.cancelled,
                "backlog_peak": self.backlog_peak,
                "pipeline_completions": self.pipeline_completions,
                "pipeline_inflight_peak": self.pipeline_inflight_peak,
                "pipeline_presweeps": self.pipeline_presweeps,
                "subject_store_hot_hits": self.subject_store_hot_hits,
                "subject_store_warm_hits": self.subject_store_warm_hits,
                "subject_store_cold_hits": self.subject_store_cold_hits,
                "subject_store_misses": self.subject_store_misses,
                "subject_store_prefetches": self.subject_store_prefetches,
                "subject_store_promotions": self.subject_store_promotions,
                "subject_store_demotions_warm":
                    self.subject_store_demotions_warm,
                "subject_store_demotions_cold":
                    self.subject_store_demotions_cold,
                "subject_store_cold_damage": self.subject_store_cold_damage,
                "subject_store_resize_evictions":
                    self.subject_store_resize_evictions,
                "shard_rebalances": self.shard_rebalances,
                "shard_rebalance_rows": self.shard_rebalance_rows,
            }
            out["coalesce_width_mean"] = round(
                self._width_mean(self.requests_dispatched, self.dispatches),
                3)
            tiers = sorted(set(self.tier_submitted) | set(self.tier_served)
                           | set(self.tier_shed) | set(self.tier_expired)
                           | set(self.tier_cancelled))
            out["tiers"] = {
                str(t): {
                    "submitted": self.tier_submitted.get(t, 0),
                    "served": self.tier_served.get(t, 0),
                    "shed": self.tier_shed.get(t, 0),
                    "expired": self.tier_expired.get(t, 0),
                    "cancelled": self.tier_cancelled.get(t, 0),
                }
                for t in tiers
            }
            stalls = list(self._promotion_stalls)
        # Percentiles outside the lock (reads of the copied samples).
        out["subject_store_promotion_ms"] = _quantiles(stalls)
        return out


def _quantiles(seconds: list) -> dict:
    """JAX's ``{"p50_ms", "p99_ms", "n"}`` summary of a sample list
    (zeros when empty)."""
    if not seconds:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "n": 0}
    arr = np.asarray(seconds)
    return {"p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "n": int(arr.size)}
