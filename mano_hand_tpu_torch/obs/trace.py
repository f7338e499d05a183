"""Request-lifecycle tracing for the serving stack: a copy of the JAX
package's ``obs/trace.py`` (the port imports nothing of that package).

``ServingCounters`` are aggregates: when a drill misses a criterion or a
dispatch is slower than its kernels there is no way to see WHERE one
request's time went or what the engine was doing at the moment of an
incident. The ``Tracer`` answers both with one bounded structure:

* **Per-request spans.** ``ServingEngine.submit`` opens a span; the
  engine stamps an event at every boundary it already sweeps deadlines
  at — submit -> coalesce/park -> launch -> dispatched -> readback ->
  resolve(kind) — and closes the span exactly once at the future's
  terminal resolution (ok / shed / expired / error / shutdown, the
  ``ServingError.kind`` vocabulary). The accounting
  (``spans_started`` / ``spans_closed`` / ``spans_open``) turns "every
  future resolves" into "every span closes", a number the drills and
  ``chip_smoke.py`` judge.
* **Runtime events on the same timeline.** Chaos injections, breaker
  transitions, deadline kills, failovers, evictions, lattice loads,
  compiles, watchdog fires — span-less events interleaved with the
  request timeline, so an incident reads in context.
* **A bounded, lock-light ring.** Events are small tuples appended to a
  ``deque(maxlen=capacity)`` under one private lock that is never held
  across device work and never nested inside engine locks (the tracer
  calls nothing back). A long-lived server cannot grow memory with
  traffic; overwritten history is counted (``events_dropped``), never
  silently absent. The disabled path is ``tracer is None`` in the
  engine — zero calls, zero cost; the enabled path is judged at
  <= 3% end-to-end (``serving.measure.tracing_overhead_run``'s paired
  interleaved criterion).

Clock discipline: every stamp is
``time.monotonic()`` — the same domain as the engine's deadlines, so
span timings and deadline sweeps compare directly and an NTP step
cannot tear a timeline. Wall-clock appears only in flight-recorder
artifacts as a human-readable label (obs/recorder.py).

Export: ``chrome_trace()`` renders spans as Chrome-trace complete
events (one slice per request plus per-stage sub-slices, one thread
per priority tier) so ``obs/trace_report.py`` can merge the engine
host timeline with a ``torch.profiler`` device capture
(``utils/profiling.py:torch_trace``) into one report;
``stage_breakdown()`` answers "queue wait vs device vs readback" per
(bucket, tier).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

#: Terminal span kinds — the engine's future-resolution vocabulary
#: (serving/engine.py:ServingError.kind plus "ok"), with JAX's
#: stream-session kind: "closed" is a client-initiated clean close of a
#: session span (the JAX package's streams; the port's engine has none
#: yet). "cancelled" is the caller withdrawing a request via
#: ``future.cancel()`` — the admission slot frees and the span closes
#: before the deadline sweep would have fired.
TERMINAL_KINDS = ("ok", "shed", "expired", "error", "shutdown",
                  "closed", "cancelled")

#: Default ring capacity: ~6 events/request keeps the last ~1300
#: requests of history — plenty for an incident dump, bounded forever.
DEFAULT_CAPACITY = 8192

#: Per-tier latency reservoir bound (the ServingCounters
#: _LATENCY_RESERVOIR reasoning at backpressure-snapshot scale).
_TIER_RESERVOIR = 2048

#: Accounting keys inside a ``Tracer.snapshot()`` (everything but the
#: raw ``events``/``open_spans`` payloads).
ACCOUNTING_KEYS = (
    "spans_started", "spans_closed", "spans_open", "spans_double_closed",
    "closed_by_kind", "events_total", "events_dropped", "ring_len",
    "ring_capacity", "incidents")


def spans_from_events(events, open_ids) -> List[dict]:
    """Group one consistent ``snapshot()["events"]`` copy per span —
    the shared derivation for ``Tracer.spans``, the chrome export, and
    the flight recorder, so every view of one capture describes the
    SAME instant instead of re-reading the live ring."""
    grouped: Dict[int, dict] = {}
    for ts, sid, name, fields in events:
        if sid == 0:
            continue
        g = grouped.setdefault(
            sid, {"id": sid, "events": [], "closed_kind": None})
        g["events"].append([ts, name, fields])
        if name == "resolve" and fields:
            g["closed_kind"] = fields.get("kind")
    for g in grouped.values():
        g["open"] = g["id"] in open_ids
    return [grouped[k] for k in sorted(grouped)]


class Tracer:
    """Bounded request-span + runtime-event recorder (module docstring).

    Thread-safe: submitters, the dispatcher, supervision worker
    threads, and watchdogs all write here. One private lock guards the
    span table and counters; it is never held while calling out
    (incident hooks run OUTSIDE the lock so a hook may snapshot the
    tracer) and the engine never calls tracer methods while holding a
    lock the tracer could want — the tracer wants none of the
    engine's.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic,
                 shed_burst_threshold: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        # Ring entries: (ts, span_id, name, fields|None); span_id 0 =
        # runtime (span-less) event.
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._next_id = 1
        self._open: Dict[int, dict] = {}   # span_id -> start record
        self.spans_started = 0
        self.spans_closed = 0
        self.spans_double_closed = 0       # close() on an already-closed
        #   span: forensics for the documented resolve-vs-sweep race
        #   window, NOT part of the closed-exactly-once criterion (the
        #   pop guard means spans_closed never double-counts).
        self.closed_by_kind: Dict[str, int] = {}
        self.events_total = 0
        self.incidents = 0
        self.shed_burst_threshold = int(shed_burst_threshold)
        self._shed_streak = 0
        self._incident_hooks: List[Callable[[str, dict], None]] = []
        # Per-tier closed-span latency reservoirs for the backpressure
        # snapshot (ServingEngine.load()).
        self._tier_lat: Dict[int, list] = {}
        self._tier_writes: Dict[int, int] = {}

    # ------------------------------------------------------------- writers
    def start(self, kind: str, tier: int = 0, rows: int = 1) -> int:
        """Open one request span; returns its id. ``kind`` is the
        request path ("full" / "posed"), not the terminal kind."""
        ts = self._clock()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._open[sid] = {"t0": ts, "kind": kind, "tier": int(tier),
                               "rows": int(rows)}
            self.spans_started += 1
            self._append(ts, sid, "submit",
                         {"kind": kind, "tier": int(tier),
                          "rows": int(rows)})
            return sid

    def event(self, span_id: Optional[int], name: str, **fields) -> None:
        """Stamp one boundary event onto a span (or the runtime
        timeline when ``span_id`` is None/0)."""
        ts = self._clock()
        with self._lock:
            self._append(ts, span_id or 0, name, fields or None)

    def close(self, span_id: Optional[int], kind: str, **fields) -> bool:
        """Terminal resolution of one span — exactly once: the first
        close wins (pops the open record, counts ``spans_closed``);
        a repeat only bumps ``spans_double_closed``."""
        if span_id is None:
            return False
        ts = self._clock()
        with self._lock:
            rec = self._open.pop(span_id, None)
            if rec is None:
                self.spans_double_closed += 1
                return False
            self.spans_closed += 1
            self.closed_by_kind[kind] = self.closed_by_kind.get(kind, 0) + 1
            f = {"kind": kind, **fields} if fields else {"kind": kind}
            self._append(ts, span_id, "resolve", f)
            if kind == "ok":
                # Only SERVED requests feed the backpressure quantiles:
                # a shed resolves in O(µs), so counting it would make
                # load()'s latency signal read FASTER exactly when the
                # engine is drowning — the inverse of backpressure.
                tier = rec["tier"]
                lat = ts - rec["t0"]
                samples = self._tier_lat.setdefault(tier, [])
                if len(samples) >= _TIER_RESERVOIR:
                    cursor = self._tier_writes.get(tier, 0)
                    samples[cursor % _TIER_RESERVOIR] = lat
                else:
                    samples.append(lat)
                self._tier_writes[tier] = \
                    self._tier_writes.get(tier, 0) + 1
            return True

    def runtime_event(self, name: str, **fields) -> None:
        """A span-less engine/runtime event on the shared timeline."""
        ts = self._clock()
        with self._lock:
            self._append(ts, 0, name, fields or None)

    def incident(self, reason: str, **fields) -> None:
        """A runtime event that ALSO notifies incident hooks (the
        flight recorder's trigger). Hooks run outside the lock so they
        may snapshot this tracer."""
        self.runtime_event(f"incident:{reason}", **fields)
        with self._lock:
            self.incidents += 1
            hooks = list(self._incident_hooks)
        for h in hooks:
            try:
                h(reason, fields)
            except Exception:  # noqa: BLE001 — a broken hook must not
                pass           # poison the dispatch path it rides on

    def on_incident(self, hook: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._incident_hooks.append(hook)

    def note_shed(self) -> None:
        """One admission shed. Cheap streak bookkeeping; crossing
        ``shed_burst_threshold`` consecutive sheds fires ONE
        ``shed_burst`` incident per crossing (reset by any admit) —
        overload becomes a flight-recorder trigger without paying an
        incident per shed on the O(µs) admission path."""
        with self._lock:
            self._shed_streak += 1
            fire = self._shed_streak == self.shed_burst_threshold
        if fire:
            self.incident("shed_burst", streak=self.shed_burst_threshold)

    def note_admit(self) -> None:
        with self._lock:
            self._shed_streak = 0

    def _append(self, ts, span_id, name, fields) -> None:
        # Callers hold self._lock.
        self._ring.append((ts, span_id, name, fields))
        self.events_total += 1

    # ------------------------------------------------------------- readers
    def _accounting_locked(self) -> dict:
        # Caller holds self._lock.
        return {
            "spans_started": self.spans_started,
            "spans_closed": self.spans_closed,
            "spans_open": len(self._open),
            "spans_double_closed": self.spans_double_closed,
            "closed_by_kind": dict(self.closed_by_kind),
            "events_total": self.events_total,
            "events_dropped": max(
                0, self.events_total - len(self._ring)),
            "ring_len": len(self._ring),
            "ring_capacity": self.capacity,
            "incidents": self.incidents,
        }

    def accounting(self) -> dict:
        """The closed-exactly-once criterion's numbers, one lock hold."""
        with self._lock:
            return self._accounting_locked()

    def load_snapshot(self) -> dict:
        """The backpressure-signal extension (``ServingEngine.load``):
        per-tier SERVED-request latency quantiles (kind="ok" closes
        only — shed/expired resolutions are O(µs) bookkeeping and
        would read as the tier speeding up mid-overload) and the
        backlog age (oldest still-open span). Samples and open-span
        starts are copied in ONE lock hold — the same torn-telemetry
        rule as ``ServingCounters.snapshot`` — and the percentile math
        runs on the copies outside the lock."""
        now = self._clock()
        with self._lock:
            items = {t: list(s) for t, s in self._tier_lat.items()}
            # REQUEST spans only: a stream-session span stays
            # open for the session's whole lifetime by design, and
            # counting it would pin backlog_age_s to "oldest open
            # stream" — a healthy engine reading as permanently wedged.
            # The per-frame backlog signal lives in load()["streams"].
            oldest = min((r["t0"] for r in self._open.values()
                          if r.get("kind") != "stream"),
                         default=None)
        out = {}
        for t, s in sorted(items.items()):
            if not s:
                continue
            arr = np.asarray(s)
            out[str(t)] = {
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
                "n": int(arr.size),
            }
        return {
            "latency_by_tier": out,
            "backlog_age_s": (0.0 if oldest is None
                              else max(0.0, now - oldest)),
        }

    def snapshot(self) -> dict:
        """Accounting + the full event ring + the open-span table, ALL
        copied in ONE lock hold (the flight recorder's raw material —
        a capture taken mid-incident must be internally consistent,
        never accounting from one instant beside events from another).
        Events serialize as ``[ts, span_id, name, fields]``."""
        with self._lock:
            snap = self._accounting_locked()
            snap["events"] = [[ts, sid, name, fields]
                              for ts, sid, name, fields in self._ring]
            snap["open_spans"] = {sid: dict(rec)
                                  for sid, rec in self._open.items()}
        return snap

    def spans(self) -> List[dict]:
        """Events grouped per span (ring-bounded history): a list of
        ``{"id", "events": [[ts, name, fields], ...], "closed_kind"}``.
        Spans whose early events were overwritten by the ring are
        returned with what remains — partial history beats none."""
        snap = self.snapshot()
        return spans_from_events(snap["events"], set(snap["open_spans"]))

    # ----------------------------------------------------------- analysis
    @staticmethod
    def _span_stages(span: dict) -> Optional[dict]:
        """(bucket, tier, kind, queue_s, device_s, readback_s, total_s)
        for one complete span, or None when the ring lost a boundary.

        Stage semantics (honest about what the engine can see):
        ``queue`` = submit -> launch (admission + queue + coalesce
        wait); ``dispatch`` = launch -> dispatched (batch assembly,
        executable fetch — a cold compile lands HERE, which is how a
        recompile shows up on the timeline — and the dispatch call;
        on the supervised path the device round-trip too); ``device``
        = dispatched -> readback (device execution + transfer — on
        the unsupervised double-buffered path this includes pipeline
        wait); ``readback`` = readback -> resolve (host-side slice +
        future delivery). The four stages partition submit->resolve
        exactly. (The port's engine stamps ``dispatched`` when the
        batch's graph replay is enqueued: see
        ``serving/engine.py:_GraphProgram.run``.)

        Pipelined spans (JAX's ``inflight_depth > 1``) carry one
        extra OPTIONAL event, ``staged`` — the moment the dispatcher
        handed the assembled batch to the completion stage. When
        present, ``dispatch`` narrows to launch -> staged (assembly +
        executable fetch only) and a fifth stage ``pipeline`` =
        staged -> dispatched (completion-stage queue wait: how long
        the batch sat behind earlier in-flight batches) joins the
        partition. Serial spans (depth 1) never emit ``staged``, so
        their rows — and the whole report — are byte-identical to the
        pre-pipeline engine's.
        """
        at = {}
        meta = {}
        for ts, name, fields in span["events"]:
            at.setdefault(name, ts)
            if fields:
                for k, v in fields.items():
                    # First write wins: "kind" must stay the submit
                    # event's path kind (full/posed), not the resolve
                    # event's terminal kind (that one is
                    # span["closed_kind"]).
                    meta.setdefault(k, v)
        needed = ("submit", "launch", "dispatched", "readback", "resolve")
        if any(k not in at for k in needed):
            return None
        st = {
            "bucket": meta.get("bucket"),
            "tier": meta.get("tier", 0),
            "kind": meta.get("kind"),
            "queue_s": at["launch"] - at["submit"],
            "dispatch_s": at["dispatched"] - at["launch"],
            "device_s": at["readback"] - at["dispatched"],
            "readback_s": at["resolve"] - at["readback"],
            "total_s": at["resolve"] - at["submit"],
        }
        if "staged" in at:
            st["dispatch_s"] = at["staged"] - at["launch"]
            st["pipeline_s"] = at["dispatched"] - at["staged"]
            st["_staged_at"] = at["staged"]
        return st

    def stage_breakdown(self, spans: Optional[List[dict]] = None) -> dict:
        """Queue-wait vs device vs readback per (bucket, tier) over the
        ring's complete spans — the unified-timeline report's host-side
        half (obs/trace_report.py prints it next to the device
        tracks). ``spans`` lets a caller holding one consistent
        snapshot derive the table from it (chrome_trace does)."""
        rows: Dict[str, Dict[str, list]] = {}
        complete = 0
        for span in (self.spans() if spans is None else spans):
            st = self._span_stages(span)
            if st is None:
                continue
            complete += 1
            key = f"b{st['bucket']}/tier{st['tier']}"
            cell = rows.setdefault(
                key, {"queue_s": [], "dispatch_s": [], "device_s": [],
                      "readback_s": [], "total_s": []})
            for k, v in st.items():
                # "pipeline_s" rides only on pipelined spans:
                # rows that never saw one keep the four-stage shape.
                if k.endswith("_s"):
                    cell.setdefault(k, []).append(v)
        out = {}
        for key, cell in sorted(rows.items()):
            out[key] = {"n": len(cell["total_s"])}
            for k, samples in cell.items():
                arr = np.asarray(samples)
                stage = k[:-2]  # strip _s
                out[key][f"{stage}_p50_ms"] = float(
                    np.percentile(arr, 50) * 1e3)
                out[key][f"{stage}_p99_ms"] = float(
                    np.percentile(arr, 99) * 1e3)
                out[key][f"{stage}_mean_ms"] = float(arr.mean() * 1e3)
        return {"complete_spans": complete, "by_bucket_tier": out}

    # ------------------------------------------------------------- export
    #: Chrome-trace pid for the engine host timeline. Deliberately NOT
    #: a device capture's pid space — trace_report summarizes per
    #: capture file, and the metadata names the track.
    CHROME_PID = 9001

    def chrome_trace(self) -> dict:
        """The span ring as Chrome-trace JSON (``traceEvents`` with
        ``ph: X`` complete events, µs timestamps): one ``request/...``
        slice per complete span plus per-stage sub-slices, one thread
        per priority tier, runtime events as instants. Alongside rides
        ``manoEngineTrace`` — schema-versioned accounting + stage
        breakdown — which is what marks the file as an engine span
        export to ``obs/trace_report.py``. The whole export
        derives from ONE snapshot, so its traceEvents, accounting, and
        stage table all describe the same instant."""
        snap = self.snapshot()
        spans = spans_from_events(snap["events"], set(snap["open_spans"]))
        pid = self.CHROME_PID
        ev: List[dict] = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "mano-serving-engine"},
        }]
        tiers_seen = set()

        def tid_for(tier: int) -> int:
            if tier not in tiers_seen:
                tiers_seen.add(tier)
                ev.append({"ph": "M", "pid": pid, "tid": tier,
                           "name": "thread_name",
                           "args": {"name": f"tier {tier}"}})
            return tier

        for span in spans:
            st = self._span_stages(span)
            at = {name: ts for ts, name, _ in reversed(span["events"])}
            if st is None:
                continue
            tid = tid_for(st["tier"])
            t0 = at["submit"]
            label = (f"request/{st['kind'] or '?'}"
                     f"/b{st['bucket']}")
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": label,
                       "ts": t0 * 1e6, "dur": st["total_s"] * 1e6,
                       "args": {"terminal": span["closed_kind"]}})
            slices = [
                ("queue", at["submit"], st["queue_s"]),
                ("dispatch", at["launch"], st["dispatch_s"]),
                ("device", at["dispatched"], st["device_s"]),
                ("readback", at["readback"], st["readback_s"])]
            if "pipeline_s" in st:
                slices.insert(
                    2, ("pipeline", st["_staged_at"], st["pipeline_s"]))
            for stage, start, dur in slices:
                ev.append({"ph": "X", "pid": pid, "tid": tid,
                           "name": f"stage/{stage}",
                           "ts": start * 1e6, "dur": dur * 1e6})
        for ts, sid, name, fields in snap["events"]:
            if sid != 0:
                continue
            ev.append({"ph": "i", "pid": pid, "tid": tid_for(-1),
                       "name": name, "ts": ts * 1e6, "s": "p",
                       **({"args": fields} if fields else {})})
        return {
            "displayTimeUnit": "ms",
            "traceEvents": ev,
            "manoEngineTrace": {
                "schema": 1,
                "accounting": {k: snap[k] for k in ACCOUNTING_KEYS},
                "stages": self.stage_breakdown(spans),
            },
        }
