"""Deterministic fault injection for device-call sites.

Every failure mode a device call can show — a hang in a C-level call, a
transient error, a persistent error (an outage), a latency spike, silent
wrong output — becomes a schedulable event that a ``ChaosPlan`` injects
into any wrapped callable (a bucket's forward, a device transfer, a
probe). The plan is driven by a per-plan CALL INDEX, not wall clock or
randomness, so the CPU tests reproduce each pathology bit for bit, run
after run. A port copy of the JAX package's ``runtime/chaos.py``: the
same grammar, the same validation, the same messages.

Plan spec grammar (``parse_plan``) — comma-separated events::

    KIND[:PARAM]@SEL[%LANE]

    KIND   hang      block until the plan's ``release`` event is set
                     (the stand-in for a call that never returns; a
                     supervised caller deadline-kills it, an
                     unsupervised one wedges)
           error     raise InjectedFault(transient=True) whose message
                     carries "UNAVAILABLE" (the marker class
                     supervise.classify_failure treats as retryable)
           fatal     raise InjectedFault(transient=False) ("INVALID_
                     ARGUMENT" marker — the deterministic class that
                     must NOT be retried)
           latency   sleep PARAM seconds, then run the call
           sat       saturation throttle: sleep PARAM seconds, then run
                     the call — mechanically a latency event, but named
                     for its role: an OPEN-ended sat plan ("sat:T@0-")
                     models the slow-device half of an overload (every
                     dispatch pays T, so device throughput is capped and
                     a sustained arrival rate above it grows the
                     backlog). The arrival-burst half lives in the
                     CALLER (serving/measure.py:overload_drill_run's
                     burst submitter) — chaos wraps device calls, so it
                     can slow the service rate but cannot generate load
           wrong     run the call, return the result + PARAM (default
                     1.0): the silent-corruption mode
    SEL    N         exactly call index N (0-based)
           N-M       calls N..M inclusive (N <= M)
           N-        every call from N onward (a persistent outage)
           *         every call
           T1s-T2s   TIME window: every call whose arrival falls in
                     [T1, T2) seconds after ``schedule()`` (epoch = the
                     monotonic clock at schedule time; fractional
                     seconds fine). Call-index selectors describe the
                     device's own dispatch sequence; a time window
                     describes the OUTSIDE world — "the device browns
                     out 2 s into the drill, for 1 s" — so the fault
                     window lands at a trace offset however many
                     dispatches the batching happened to produce first.
                     Both ends must carry the ``s`` suffix (mixed
                     domains are a typo), T1 < T2 strictly (an instant
                     matches no interval), and ``T1s-`` is the
                     open-ended form.
    LANE   N         restrict the event to callables wrapped with
                     ``wrap(..., lane=N)`` — a per-device dispatch lane.
                     A lane-tagged event is indexed by that LANE'S OWN
                     call counter, not the plan-global one, so "kill
                     exactly lane 2 from its 3rd dispatch on" stays
                     deterministic however the other lanes interleave.
                     Untagged events keep the plan-global index and hit
                     every wrapped callable, lane or not.

    "error@0-1"            two transient faults, then clean
    "hang@2"               call 2 wedges
    "error@0-"             persistent outage (never self-clears)
    "error@0-%1"           lane 1 alone goes down, siblings stay clean
    "latency:0.2@1-3"      200 ms spikes on calls 1-3
    "sat:0.02@0-"          every dispatch throttled 20 ms (saturation)
    "wrong:0.5@4"          call 4 silently returns verts + 0.5
    "error@2s-3s"          every call arriving 2-3 s into the plan
    "sat:0.05@1.5s-%0"     lane 0 throttled from 1.5 s onward

    Specs are VALIDATED at parse time: unknown kinds, malformed or
    misplaced ``:PARAM`` (hang/error/fatal take none; latency/sat
    require a non-negative one), non-integer or negative selector
    indices, inverted ranges (``N-M`` with N > M, which can match
    no call), and malformed ``%LANE`` tags all raise ``ValueError``
    with the offending token — a typo'd plan must fail the run, not
    silently inject nothing.

``schedule(spec)`` swaps the event list and resets the call index, so
one long-lived engine can be driven through a whole fault matrix without
rebuilding anything (serving/measure.py's recovery drill does exactly
this).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised by a ChaosPlan. ``transient`` mirrors the real
    split: retryable transport blips vs deterministic failures."""

    def __init__(self, message: str, transient: bool = True):
        super().__init__(message)
        self.transient = transient


class FaultEvent:
    """One scheduled fault: ``kind`` over call indices [start, stop] —
    or, when ``t_start`` is set, over the TIME window [t_start, t_stop)
    seconds after ``schedule()``. ``lane`` restricts it to one dispatch
    lane's callables; for index-domain events it also switches the index
    domain to that lane's own call counter (a time window is already
    interleave-independent, so the lane tag is purely a filter there)."""

    __slots__ = ("kind", "start", "stop", "param", "lane",
                 "t_start", "t_stop")

    def __init__(self, kind: str, start: int, stop: Optional[int],
                 param: float = 0.0, lane: Optional[int] = None,
                 t_start: Optional[float] = None,
                 t_stop: Optional[float] = None):
        self.kind = kind
        self.start = start
        self.stop = stop            # None = open-ended (persistent)
        self.param = param
        self.lane = lane            # None = every wrapped callable
        self.t_start = t_start      # None = call-index domain
        self.t_stop = t_stop        # None = open-ended window

    def matches(self, idx: int) -> bool:
        return idx >= self.start and (self.stop is None or idx <= self.stop)

    def matches_time(self, elapsed_s: float) -> bool:
        return (self.t_start is not None and elapsed_s >= self.t_start
                and (self.t_stop is None or elapsed_s < self.t_stop))

    def __repr__(self) -> str:  # test/log readability
        if self.t_start is not None:
            stop = "" if self.t_stop is None else f"{self.t_stop}s"
            sel = f"{self.t_start}s-{stop}"
        elif self.stop == self.start:
            sel = f"{self.start}"
        else:
            sel = f"{self.start}-{'' if self.stop is None else self.stop}"
        tag = "" if self.lane is None else f"%{self.lane}"
        return f"FaultEvent({self.kind}@{sel}{tag}, param={self.param})"


_KINDS = ("hang", "error", "fatal", "latency", "sat", "wrong")
# Which kinds take a ':PARAM' — and whether they REQUIRE one. A param on
# a kind that ignores it ("hang:2@0") is a typo'd latency/sat plan that
# would otherwise silently inject the wrong fault class.
_PARAM_REQUIRED = ("latency", "sat")
_PARAM_ALLOWED = ("latency", "sat", "wrong")


def _parse_index(text: str, token: str) -> int:
    try:
        idx = int(text)
    except ValueError:
        raise ValueError(
            f"chaos event {token!r}: selector index {text!r} is not an "
            "integer (expected N, N-M, N-, or *)") from None
    if idx < 0:
        raise ValueError(
            f"chaos event {token!r}: selector index {idx} is negative "
            "(call indices are 0-based)")
    return idx


def _parse_seconds(text: str, token: str) -> float:
    try:
        t = float(text)
    except ValueError:
        raise ValueError(
            f"chaos event {token!r}: time bound {text!r}s is not a "
            "number of seconds") from None
    if t < 0:
        raise ValueError(
            f"chaos event {token!r}: time bound {t}s is negative")
    return t


def _parse_event(token: str) -> FaultEvent:
    head, _, sel = token.partition("@")
    if not sel:
        raise ValueError(f"chaos event {token!r} lacks '@SELECTOR'")
    sel, pct, lane_s = sel.partition("%")
    if pct and not lane_s:
        raise ValueError(
            f"chaos event {token!r}: '%' lane tag needs a lane index "
            "(e.g. error@0-%1)")
    lane = _parse_index(lane_s, token) if pct else None
    if pct and not sel:
        raise ValueError(
            f"chaos event {token!r}: '%LANE' must follow a selector "
            "(e.g. error@0-%1)")
    kind, colon, param_s = head.partition(":")
    if kind not in _KINDS:
        raise ValueError(f"unknown chaos kind {kind!r} (one of {_KINDS})")
    if kind in _PARAM_REQUIRED and not param_s:
        raise ValueError(
            f"{kind} events need ':SECONDS' (e.g. {kind}:0.2)")
    if colon and kind not in _PARAM_ALLOWED:
        raise ValueError(
            f"chaos event {token!r}: {kind} takes no ':PARAM' "
            f"(only {_PARAM_ALLOWED} do)")
    if param_s:
        try:
            param = float(param_s)
        except ValueError:
            raise ValueError(
                f"chaos event {token!r}: param {param_s!r} is not a "
                "number") from None
        if kind in _PARAM_REQUIRED and param < 0:
            raise ValueError(
                f"chaos event {token!r}: {kind} seconds must be >= 0")
    else:
        param = 1.0 if kind == "wrong" else 0.0
    if sel == "*":
        return FaultEvent(kind, 0, None, param, lane)
    lo, dash, hi = sel.partition("-")
    # Time-window domain: 's'-suffixed bounds. Both ends must
    # agree — "2s-5" (or "2-5s") is a typo that would otherwise parse
    # as a huge call index, silently injecting at the wrong place.
    time_lo, time_hi = lo.endswith("s"), hi.endswith("s")
    if time_lo or time_hi:
        if not dash:
            raise ValueError(
                f"chaos event {token!r}: a time selector needs a "
                "window, not an instant (T1s-T2s or T1s-; a bare "
                f"{sel!r} can match no call)")
        if not time_lo or (hi and not time_hi):
            raise ValueError(
                f"chaos event {token!r}: mixed selector domains — "
                "both window ends must carry the 's' suffix "
                "(e.g. 2s-3s), or neither (call indices)")
        t0 = _parse_seconds(lo[:-1], token)
        if not hi:
            return FaultEvent(kind, 0, None, param, lane,
                              t_start=t0, t_stop=None)
        t1 = _parse_seconds(hi[:-1], token)
        if t1 <= t0:
            raise ValueError(
                f"chaos event {token!r}: time window {t0}s-{t1}s is "
                "empty (need T1 < T2)")
        return FaultEvent(kind, 0, None, param, lane,
                          t_start=t0, t_stop=t1)
    start = _parse_index(lo, token)
    if not dash:
        return FaultEvent(kind, start, start, param, lane)
    if not hi:
        return FaultEvent(kind, start, None, param, lane)
    stop = _parse_index(hi, token)
    if stop < start:
        raise ValueError(
            f"chaos event {token!r}: range {start}-{stop} is inverted "
            "and would match no call")
    return FaultEvent(kind, start, stop, param, lane)


class ChaosPlan:
    """A deterministic, schedulable fault plan over wrapped callables.

    All callables wrapped by one plan share ONE call counter — faults
    land on the plan's dispatch timeline regardless of which bucket a
    given dispatch hits, matching how an outage hits whatever happens to
    be in flight.

    Thread-safe (the engine's dispatcher and a test's caller both touch
    it). ``release`` frees any hung calls: test teardown / drill exit
    sets it so abandoned worker threads unwind instead of sleeping
    forever in the process.
    """

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self._events: List[FaultEvent] = []
        self._calls = 0
        # Time-window epoch: 's'-suffixed selectors measure
        # elapsed seconds from the most recent schedule() (monotonic —
        # never wall clock), so a plan scheduled at a trace's t=0
        # pins its fault windows to trace offsets.
        self._epoch = time.monotonic()
        # Per-lane call counters: lane-tagged events index into
        # the tagged lane's own dispatch sequence, so one lane's fault
        # schedule is deterministic however its siblings interleave.
        self._lane_calls: dict = {}
        self.faults_injected = 0
        self.release = threading.Event()
        if spec:
            self.schedule(spec)

    # -------------------------------------------------------------- control
    def schedule(self, spec: str) -> "ChaosPlan":
        """Replace the event list and restart the call index at 0
        (``faults_injected`` keeps accumulating — it is the plan's
        lifetime audit trail, snapshotted per phase by callers)."""
        events = [_parse_event(t.strip())
                  for t in spec.split(",") if t.strip()]
        with self._lock:
            self._events = events
            self._calls = 0
            self._lane_calls = {}
            self._epoch = time.monotonic()
        return self

    def clear(self) -> None:
        """Drop every scheduled event (the fault 'clears' — recovery)."""
        with self._lock:
            self._events = []

    @property
    def calls(self) -> int:
        with self._lock:
            return self._calls

    def _next(self, lane: Optional[int] = None,
              ) -> Tuple[int, Optional[FaultEvent]]:
        with self._lock:
            idx = self._calls
            self._calls += 1
            lidx = None
            if lane is not None:
                lidx = self._lane_calls.get(lane, 0)
                self._lane_calls[lane] = lidx + 1
            elapsed = time.monotonic() - self._epoch

            def fires(e: FaultEvent) -> bool:
                if e.lane is not None and e.lane != lane:
                    return False
                if e.t_start is not None:
                    return e.matches_time(elapsed)
                return e.matches(idx if e.lane is None else lidx)

            ev = next((e for e in self._events if fires(e)), None)
            if ev is not None:
                self.faults_injected += 1
            # Report the index in the DOMAIN the event matched on: an
            # untagged event firing on a lane call matched the
            # plan-global counter, and the fault message / on_fault
            # forensics must name an index that exists in the spec.
            report = (lidx if (lane is not None and ev is not None
                              and ev.lane is not None) else idx)
            return report, ev

    # ------------------------------------------------------------- wrapping
    def wrap(self, fn: Callable, on_fault: Optional[Callable] = None,
             lane: Optional[int] = None) -> Callable:
        """Wrap ``fn`` so each invocation consults the plan first.

        ``on_fault`` (e.g. ``ServingCounters.count_fault``) fires once per
        injected fault, before the fault takes effect. A hook that accepts
        two positional arguments (a tracing hook) is called as
        ``on_fault(kind, call_index)``, so the fault lands on a request
        timeline with its identity; anything else gets the no-argument
        call. The arity is resolved ONCE at wrap time, not per dispatch.

        ``lane`` identifies this callable as dispatch lane N's:
        ``%LANE``-tagged events fire only on the matching lane, indexed by
        that lane's own call counter, while untagged events keep hitting
        every wrapped callable on the plan-global index — a plan can kill
        exactly one lane while its siblings serve clean.
        """
        notify = None
        if on_fault is not None:
            import inspect

            try:
                positional = [
                    p for p in
                    inspect.signature(on_fault).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]
                rich = len(positional) >= 2
            except (TypeError, ValueError):
                rich = False
            notify = ((lambda ev, idx: on_fault(ev.kind, idx)) if rich
                      else (lambda ev, idx: on_fault()))

        def chaotic(*args, **kwargs):
            idx, ev = self._next(lane)
            if ev is None:
                return fn(*args, **kwargs)
            if notify is not None:
                notify(ev, idx)
            if ev.kind == "hang":
                # The never-returning call's stand-in: block until
                # released.
                # A supervised caller abandons this (daemon) thread at
                # its deadline; the raise after release keeps a stale
                # result from ever surfacing.
                self.release.wait()
                raise InjectedFault(
                    f"chaos: hang at call {idx} released", transient=True)
            if ev.kind == "error":
                raise InjectedFault(
                    f"chaos: UNAVAILABLE injected transient RPC error "
                    f"at call {idx}", transient=True)
            if ev.kind == "fatal":
                raise InjectedFault(
                    f"chaos: INVALID_ARGUMENT injected deterministic "
                    f"failure at call {idx}", transient=False)
            if ev.kind in ("latency", "sat"):
                # sat is semantically a sustained throughput throttle;
                # mechanically both sleep, then run the call.
                time.sleep(ev.param)
                return fn(*args, **kwargs)
            # wrong: silent corruption — runs the call, skews the result.
            return np.asarray(fn(*args, **kwargs)) + ev.param

        return chaotic


def parse_plan(spec: str) -> ChaosPlan:
    """``spec`` (grammar above) -> a fresh ChaosPlan."""
    return ChaosPlan(spec)


# --------------------------------------------------------------------------
# Process-level campaign: the same spec-string discipline, one
# level up. A ChaosPlan wraps CALLABLES (a device dispatch dies); a
# ChaosCampaign schedules WHOLE-PROCESS events (a worker dies, the
# proxy dies, a backend partitions, a cold page is damaged) against a
# live fleet — the faults the self-healing tier exists to absorb.
# --------------------------------------------------------------------------

_CAMPAIGN_KINDS = ("kill_worker", "kill_proxy", "partition", "damage_page")
# partition REQUIRES ':SECONDS' (how long the victim stays unreachable
# before the campaign lifts it); the kill/damage kinds are instants and
# take none — same typo-hardening stance as the call-level grammar.
_CAMPAIGN_PARAM_REQUIRED = ("partition",)


class CampaignEvent:
    """One scheduled process-level fault: ``kind`` fired ``at_s``
    seconds after ``ChaosCampaign.start()``."""

    __slots__ = ("kind", "at_s", "param")

    def __init__(self, kind: str, at_s: float, param: float = 0.0):
        self.kind = kind
        self.at_s = at_s
        self.param = param

    def __repr__(self) -> str:
        p = f":{self.param}" if self.param else ""
        return f"CampaignEvent({self.kind}{p}@{self.at_s}s)"


def parse_campaign(spec: str) -> List[CampaignEvent]:
    """Campaign spec -> time-ordered events. Grammar (the call-level
    spec's shape, with the selector REQUIRED to be a time instant —
    process events live on the wall, not on a dispatch counter)::

        KIND[:PARAM]@Ts[, ...]

        kill_worker@2s              SIGKILL one seeded-picked worker
        kill_proxy@4s               SIGKILL the active proxy
        partition:1.5@6s            one backend unreachable for 1.5 s
        damage_page@8s              corrupt one cold row page

    Validated at parse time like ``parse_plan``: unknown kinds,
    call-index selectors (no ``s`` suffix), windows (``T1s-T2s`` — a
    process kill is an instant), missing/forbidden ``:PARAM``, and
    negative times all raise ValueError with the offending token.
    Ties fire in spec order (stable sort)."""
    events = []
    for token in (t.strip() for t in spec.split(",") if t.strip()):
        head, _, sel = token.partition("@")
        if not sel:
            raise ValueError(f"campaign event {token!r} lacks '@Ts'")
        if "-" in sel:
            raise ValueError(
                f"campaign event {token!r}: campaign selectors are "
                "instants (KIND@Ts), not windows")
        if not sel.endswith("s"):
            raise ValueError(
                f"campaign event {token!r}: selector {sel!r} must be "
                "a time instant with the 's' suffix (e.g. @2s) — "
                "process events live on the wall clock, not a call "
                "index")
        at_s = _parse_seconds(sel[:-1], token)
        kind, colon, param_s = head.partition(":")
        if kind not in _CAMPAIGN_KINDS:
            raise ValueError(
                f"unknown campaign kind {kind!r} (one of "
                f"{_CAMPAIGN_KINDS})")
        if kind in _CAMPAIGN_PARAM_REQUIRED and not param_s:
            raise ValueError(
                f"{kind} events need ':SECONDS' (e.g. {kind}:1.5@2s)")
        if colon and kind not in _CAMPAIGN_PARAM_REQUIRED:
            raise ValueError(
                f"campaign event {token!r}: {kind} takes no ':PARAM' "
                f"(only {_CAMPAIGN_PARAM_REQUIRED} do)")
        if param_s:
            param = _parse_seconds(param_s, token)
        else:
            param = 0.0
        events.append(CampaignEvent(kind, at_s, param))
    events.sort(key=lambda e: e.at_s)
    return events


class ChaosCampaign:
    """A deterministic seeded schedule of process-level faults driven
    against a live fleet.

    The DRILL registers one handler per kind (``on``) — the campaign
    owns WHEN and (via :meth:`pick`) WHICH, the handler owns HOW (it
    holds the fleet/proxy/store references; the campaign imports
    nothing above runtime/). Handlers run on the campaign's own
    thread, exceptions are captured into the audit trail rather than
    killing the campaign mid-drill (a chaos harness that dies on its
    own fault is useless), and every firing lands in ``events_fired``
    with its measured offset — the drill's schedule-vs-actual
    forensics.

    Determinism: victim selection draws from ONE ``numpy`` Generator
    seeded at construction, consumed in event order on the single
    thread, over the SORTED candidate list the handler passes
    to :meth:`pick` — same seed + same alive-sets = same victims,
    run after run (the ChaosPlan philosophy at process scope)."""

    def __init__(self, spec: str, seed: int = 0, log=None):
        self.events = parse_campaign(spec)
        self._rng = np.random.default_rng(seed)
        self.seed = int(seed)
        self._handlers: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log = log
        self.events_fired: List[dict] = []

    # ------------------------------------------------------------- wiring
    def on(self, kind: str, handler: Callable) -> "ChaosCampaign":
        """Register ``handler(event) -> json-able result`` for one
        kind; chainable. The result (e.g. the victim's name) lands in
        the audit trail."""
        if kind not in _CAMPAIGN_KINDS:
            raise ValueError(
                f"unknown campaign kind {kind!r} (one of "
                f"{_CAMPAIGN_KINDS})")
        self._handlers[kind] = handler
        return self

    def pick(self, candidates):
        """Seeded choice over ``sorted(candidates)`` — handlers call
        this at FIRE time so the victim set reflects who is actually
        alive (a worker healed since the last kill is back in the
        pool). None when the pool is empty."""
        cands = sorted(candidates)
        if not cands:
            return None
        return cands[int(self._rng.integers(len(cands)))]

    # ------------------------------------------------------------- driving
    def start(self) -> "ChaosCampaign":
        """Drive the schedule on a daemon thread (the drill's streams
        keep flowing while faults land). Every scheduled kind must
        have a handler — a campaign that silently skips events would
        read as 'survived' without being tested."""
        missing = sorted({e.kind for e in self.events}
                         - set(self._handlers))
        if missing:
            raise RuntimeError(
                f"campaign kinds with no handler: {missing}")
        if self._thread is not None:
            raise RuntimeError("campaign already started")
        self._thread = threading.Thread(
            target=self._drive, name="mano-chaos-campaign", daemon=True)
        self._thread.start()
        return self

    def _drive(self) -> None:
        epoch = time.monotonic()
        for ev in self.events:
            delay = ev.at_s - (time.monotonic() - epoch)
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            entry = {"kind": ev.kind, "at_s": ev.at_s,
                     "param": ev.param,
                     "fired_s": round(time.monotonic() - epoch, 3)}
            try:
                entry["result"] = self._handlers[ev.kind](ev)
            except Exception as e:  # noqa: BLE001 — audit, don't die
                entry["error"] = f"{type(e).__name__}: {e}"
            with self._lock:
                self.events_fired.append(entry)
            if self._log is not None:
                self._log(f"[campaign] {entry}")

    def join(self, timeout_s: float = 60.0) -> bool:
        """Wait for the schedule to finish; False on timeout."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout_s)
        return not t.is_alive()

    def stop(self) -> None:
        """Abandon the remaining schedule (drill teardown)."""
        self._stop.set()

    def fired(self) -> List[dict]:
        """A snapshot of the audit trail (one lock hold)."""
        with self._lock:
            return [dict(e) for e in self.events_fired]
