"""Serving counters: what the engine did, as numbers.

A thread-safe subset of the JAX package's ``ServingCounters``: batch
dispatches and the rows in them, the coalescing of requests (and of
subjects) into batches, the subject table's bakes, hits, growths and
evictions, and the per-bucket callables built (``compiles``, counted by
``MANOModel.forward_bucketed``). The dispatcher thread and submitters
both write here.
"""

from __future__ import annotations

import threading


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
        """Every counter and the derived mean, read under one lock hold."""
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
            }
            out["coalesce_width_mean"] = round(
                self._width_mean(self.requests_dispatched, self.dispatches),
                3)
        return out
