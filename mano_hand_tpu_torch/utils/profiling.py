"""Serving counters: what the engine did, as numbers.

A thread-safe subset of the JAX package's ``ServingCounters``: batch
dispatches and the rows in them, the coalescing of requests (and of
subjects) into batches, the subject table's bakes, hits, growths and
evictions, the per-bucket callables built (``compiles``, counted by
``MANOModel.forward_bucketed``), and the resilience and admission layer:
supervised retries, injected faults, CPU failovers, deadline kills,
sheds, expiries and cancellations, per priority tier. The dispatcher
thread, supervision workers and submitters all write here.
"""

from __future__ import annotations

import threading
from typing import Dict


class ServingCounters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dispatches = 0              # batches sent to the device
        self.dispatches_bf16 = 0         # of them, bf16-family batches
        self.rows_live = 0               # real request rows dispatched
        self.rows_padded = 0             # pad rows dispatched alongside them
        self.requests_dispatched = 0     # requests merged across dispatches
        self.mixed_subject_batches = 0   # dispatches mixing >= 2 subjects
        self.specializations = 0         # shape-stage bakes (cache misses)
        self.shaped_hits = 0             # subject-cache hits (bake reused)
        self.table_growths = 0           # subject-table capacity doublings
        self.specializations_evicted = 0  # LRU table-row evictions
        self.compiles = 0                # per-bucket callables built
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

    def count_dispatch(self, bucket: int, live_rows: int, requests: int = 1,
                       subjects: int = 1, bf16: bool = False) -> None:
        """One batch sent to the device: ``requests`` submits coalesced,
        ``subjects`` distinct subjects in it (>= 2 is a mixed batch),
        served from the bf16 family when ``bf16``."""
        with self._lock:
            self.dispatches += 1
            self.dispatches_bf16 += int(bf16)
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
        """One bucket's callable built (a cache miss of its bucket)."""
        with self._lock:
            self.compiles += n

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
                "rows_live": self.rows_live,
                "rows_padded": self.rows_padded,
                "requests_dispatched": self.requests_dispatched,
                "mixed_subject_batches": self.mixed_subject_batches,
                "specializations": self.specializations,
                "shaped_hits": self.shaped_hits,
                "table_growths": self.table_growths,
                "specializations_evicted": self.specializations_evicted,
                "compiles": self.compiles,
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
        return out
