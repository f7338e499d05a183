"""Closed-loop control: the SLO layer drives the engine and the edge.

The port of the JAX package's ``serving/control.py``: the same control
law, bounds, events and decisions from the same signals (a twin test
drives both controllers with one signal sequence and holds their
histories identical).

Every throughput knob in the stack is otherwise static and hand-picked —
the coalesce window base, the per-tier admission quotas, the bucket
ladder's selection rung (which CUDA-graph program of the gathered kernel
serves a batch), the edge's per-tier Retry-After, the subject store's
warm capacity — while the signals to drive them are already exported:
per-tier error-budget burn rates (``obs.metrics.slo_report``), backlog
age and per-lane telemetry (``load()``). ``Controller`` closes the loop:
a thread that, at a bounded cadence, reads ONE-lock-hold snapshots of
that telemetry and actuates the engine's live setters
(``set_coalesce_base`` / ``set_admission`` / ``set_bucket_bias``,
``SubjectStore.resize_warm``) and the edge's ``retry_after_source``.

The control law: tier 0's error-budget burn rate is the protected signal.
While tier 0 burns COLD (every burn rate under ``tier0_burn_low``), the
gap between the static tier-1 quota and the queue bound is idle headroom
— the controller grows the tier-1 quota toward
``tier1_quota_max_fraction`` of ``max_queued``, so batch traffic a static
config would shed gets served. When tier 0 burns HOT (any burn rate over
``tier0_burn_high``), the tier-1 quota walks back below its static
default and tier-1's Retry-After grows. Independently, backlog age
drives the coalesce window base down (waiting buys nothing a backlog
cannot fill) and back up when the queue drains; tier 0 hot with
fragmented batches raises the ladder bias; sustained warm-tier misses
grow the subject store's warm capacity, idleness shrinks it home.

Discipline, because a controller that misbehaves is worse than none:

* **Hysteresis** — every signal has a low and a high watermark; in the
  deadband between them the controller holds.
* **Rate limits** — a per-actuator minimum re-actuation interval
  (``min_actuation_interval_s``) and a maximum relative step
  (``max_step_fraction``).
* **Bounds** — every actuator has hard floors and ceilings
  (``ControlConfig``); the engine's own setters re-validate.
* **Evented** — every actuation lands on the tracer's timeline as a
  ``runtime_event("control", actuator=..., before=..., after=...)`` with
  the decision's reason, and bumps ``ServingCounters.control_actuations``.
* **Crash = static defaults** — the tick thread's failure path reverts
  every actuator to the values captured at ``start()`` (each revert
  independently best-effort), marks the snapshot ``crashed``, and files a
  flight-recorder incident. A dead controller degrades to the hand-picked
  behavior; it never wedges admission — the engine's setters hold no lock
  across any callout, and ``retry_after_for`` falls back to the static
  protocol formula the moment the controller is crashed.

``load()["control"]`` is this module's telemetry block, built in ONE
controller-lock hold; ``empty_snapshot()`` keeps the surface shape-stable
on engines with no controller attached.

Clocks are ``time.monotonic`` throughout.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ControlConfig", "Controller", "empty_snapshot"]


#: Keys every control block carries — ``empty_snapshot`` and
#: ``Controller.snapshot`` are pinned to the same set in tests, so a
#: scrape/consumer never branches on controller presence.
_SNAPSHOT_KEYS = (
    "attached", "running", "crashed", "ticks", "actuations", "reverts",
    "version", "values", "last_reason", "history",
)

#: Bounded actuation history (forensics in the snapshot; the full
#: stream is on the tracer timeline).
_HISTORY = 32


def empty_snapshot() -> dict:
    """The shape-stable ``load()["control"]`` block of an engine with
    no controller attached (or whose controller's snapshot source
    failed) — same keys as ``Controller.snapshot``, all zeros."""
    return {
        "attached": False,
        "running": False,
        "crashed": False,
        "ticks": 0,
        "actuations": 0,
        "reverts": 0,
        "version": 0,
        "values": {},
        "last_reason": None,
        "history": [],
    }


class ControlConfig:
    """Bounds, watermarks, and pacing for one ``Controller``.

    The defaults are deliberately conservative: watermarks a healthy
    engine never crosses, steps that take several decisions to
    traverse an actuator's range.  Every field is validated — a typo'd
    config must fail construction, not silently misdrive the engine
    (the chaos-grammar precedent)."""

    def __init__(self, *,
                 cadence_s: float = 0.25,
                 hysteresis: float = 0.5,
                 min_actuation_interval_s: float = 0.5,
                 max_step_fraction: float = 0.5,
                 tier0_burn_high: float = 1.0,
                 tier0_burn_low: Optional[float] = None,
                 backlog_age_high_s: float = 0.25,
                 backlog_age_low_s: Optional[float] = None,
                 coalesce_min_s: float = 0.0,
                 coalesce_max_s: float = 0.05,
                 tier1_quota_min_fraction: float = 0.25,
                 tier1_quota_max_fraction: float = 0.95,
                 retry_after_max_s: int = 8,
                 bucket_bias_max: int = 1,
                 batch_fill_low: float = 0.25,
                 warm_miss_grow_per_tick: int = 4,
                 warm_grow_ticks: int = 2,
                 warm_idle_shrink_ticks: int = 8,
                 warm_capacity_max: int = 1 << 17):
        self.cadence_s = float(cadence_s)
        if self.cadence_s <= 0:
            raise ValueError(
                f"cadence_s must be > 0, got {cadence_s}")
        self.hysteresis = float(hysteresis)
        if not 0.0 < self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in (0, 1), got {hysteresis}")
        self.min_actuation_interval_s = float(min_actuation_interval_s)
        if self.min_actuation_interval_s < 0:
            raise ValueError(
                "min_actuation_interval_s must be >= 0, got "
                f"{min_actuation_interval_s}")
        self.max_step_fraction = float(max_step_fraction)
        if not 0.0 < self.max_step_fraction <= 1.0:
            raise ValueError(
                f"max_step_fraction must be in (0, 1], got "
                f"{max_step_fraction}")
        self.tier0_burn_high = float(tier0_burn_high)
        # The LOW watermark defaults to the hysteresis fraction of the
        # high one — one knob moves the whole deadband.
        self.tier0_burn_low = (
            self.hysteresis * self.tier0_burn_high
            if tier0_burn_low is None else float(tier0_burn_low))
        self.backlog_age_high_s = float(backlog_age_high_s)
        self.backlog_age_low_s = (
            self.hysteresis * self.backlog_age_high_s
            if backlog_age_low_s is None else float(backlog_age_low_s))
        for name, lo, hi in (
                ("tier0_burn", self.tier0_burn_low,
                 self.tier0_burn_high),
                ("backlog_age", self.backlog_age_low_s,
                 self.backlog_age_high_s)):
            if not 0.0 <= lo < hi:
                raise ValueError(
                    f"{name} watermarks must satisfy 0 <= low < high, "
                    f"got ({lo}, {hi})")
        self.coalesce_min_s = float(coalesce_min_s)
        self.coalesce_max_s = float(coalesce_max_s)
        if not 0.0 <= self.coalesce_min_s < self.coalesce_max_s:
            raise ValueError(
                "coalesce bounds must satisfy 0 <= min < max, got "
                f"({coalesce_min_s}, {coalesce_max_s})")
        self.tier1_quota_min_fraction = float(tier1_quota_min_fraction)
        self.tier1_quota_max_fraction = float(tier1_quota_max_fraction)
        if not (0.0 < self.tier1_quota_min_fraction
                < self.tier1_quota_max_fraction <= 1.0):
            raise ValueError(
                "tier1 quota fractions must satisfy 0 < min < max <= 1"
                f", got ({tier1_quota_min_fraction}, "
                f"{tier1_quota_max_fraction})")
        self.retry_after_max_s = int(retry_after_max_s)
        if self.retry_after_max_s < 1:
            raise ValueError(
                f"retry_after_max_s must be >= 1, got "
                f"{retry_after_max_s}")
        self.bucket_bias_max = int(bucket_bias_max)
        if self.bucket_bias_max < 0:
            raise ValueError(
                f"bucket_bias_max must be >= 0, got {bucket_bias_max}")
        self.batch_fill_low = float(batch_fill_low)
        if not 0.0 <= self.batch_fill_low <= 1.0:
            raise ValueError(
                f"batch_fill_low must be in [0, 1], got "
                f"{batch_fill_low}")
        self.warm_miss_grow_per_tick = int(warm_miss_grow_per_tick)
        self.warm_grow_ticks = int(warm_grow_ticks)
        self.warm_idle_shrink_ticks = int(warm_idle_shrink_ticks)
        self.warm_capacity_max = int(warm_capacity_max)
        if min(self.warm_miss_grow_per_tick, self.warm_grow_ticks,
               self.warm_idle_shrink_ticks,
               self.warm_capacity_max) < 1:
            raise ValueError("warm_* knobs must all be >= 1")


class Controller:
    """The adaptive controller over ONE ``ServingEngine`` (and,
    through ``retry_after_for``, the edge in front of it).

    ``start()`` captures the engine's current knob values as the
    static-default revert anchor, attaches the snapshot source
    (``load()["control"]``), and spawns the tick thread; ``stop()``
    halts it (``revert=True`` restores the anchor — the drill's
    paired-run hygiene).  ``tick()`` is public and takes an optional
    pre-built signals dict so tests drive the decision logic
    deterministically without a live engine under load."""

    def __init__(self, engine, *, config: Optional[ControlConfig] = None,
                 objectives: Optional[dict] = None,
                 log: Optional[Callable[[str], None]] = None):
        self._eng = engine
        self._cfg = config or ControlConfig()
        self._objectives = objectives
        self._log = log or (lambda m: None)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._running = False
        self._crashed = False
        self._crash_error: Optional[str] = None
        self._ticks = 0
        self._actuations = 0
        self._reverts = 0
        self._last_reason: Optional[str] = None
        self._history: List[dict] = []
        self._defaults: Optional[dict] = None
        # Per-actuator rate-limit ledger: actuator -> monotonic stamp.
        self._last_actuation: Dict[str, float] = {}
        # Tick-delta baselines (counters are lifetime-cumulative).
        self._last_misses: Optional[int] = None
        self._last_rows_live: Optional[int] = None
        self._last_dispatches: Optional[int] = None
        self._warm_pressure_ticks = 0
        self._warm_idle_ticks = 0
        # Actuated per-tier Retry-After (None = static protocol
        # formula; ints once the controller has an opinion).
        self._retry_after: Dict[int, int] = {}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Controller":
        if self._thread is not None:
            return self
        eng = self._eng
        store = eng.subject_store
        self._defaults = {
            "coalesce_base_s": eng.max_delay_s,
            "max_queued": eng.max_queued,
            "tier_quotas": dict(eng._tier_quotas),
            "bucket_bias": eng.bucket_bias,
            "warm_capacity": (None if store is None
                              else store.config.warm_capacity),
        }
        with self._lock:
            self._running = True
            self._crashed = False
        eng.attach_control(self.snapshot)
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="mano-control", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, revert: bool = False,
             timeout_s: float = 10.0) -> None:
        """Halt the tick thread (bounded join). ``revert=True``
        restores the static defaults afterwards — the clean-shutdown
        counterpart of the crash path's forced revert."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._thread = None
        with self._lock:
            self._running = False
        if revert and self._defaults is not None:
            self.revert_to_defaults("stop")

    def _run(self) -> None:
        try:
            while not self._stop_evt.wait(self._cfg.cadence_s):
                self.tick()
        except BaseException as e:  # noqa: BLE001 — crash = revert
            self._crash(e)

    def _crash(self, e: BaseException) -> None:
        """The never-wedge guarantee: a controller failure REVERTS
        every actuator to the static defaults and marks the snapshot,
        so a dead controller is exactly yesterday's hand-tuned engine.
        Each step is independently best-effort — one failing revert
        must not strand the others, and admission keeps running on
        whatever values land (the engine's setters never hold a lock
        across a callout)."""
        msg = f"{type(e).__name__}: {e}"
        with self._lock:
            self._crashed = True
            self._crash_error = msg
            self._running = False
        self._stop_evt.set()          # a crashed loop must not respin
        t = self._thread
        if t is not None and t is not threading.current_thread():
            # Raised off the tick thread (an injected crash): the tick in
            # flight ends first, or an actuation it makes would land
            # after the revert.
            t.join(timeout=10.0)
        self._log(f"controller crashed ({msg}); reverting to static "
                  "defaults")
        tr = self._eng.tracer
        if tr is not None:
            try:
                tr.incident(f"control_crash: {msg}"[:200])
            except Exception:  # noqa: BLE001 — forensics, not control
                pass
        self.revert_to_defaults("crash")

    def revert_to_defaults(self, reason: str) -> dict:
        """Restore every actuator to the values captured at start().
        Best-effort per actuator; returns {actuator: ok}. Counted in
        ``control_reverts`` and evented like any actuation."""
        dflt = self._defaults or {}
        eng = self._eng
        ok: Dict[str, bool] = {}

        def step(name: str, fn) -> None:
            try:
                fn()
                ok[name] = True
            except Exception as exc:  # noqa: BLE001 — best-effort
                ok[name] = False
                self._log(f"revert {name} failed: "
                          f"{type(exc).__name__}: {exc}")

        if "coalesce_base_s" in dflt:
            step("coalesce", lambda: eng.set_coalesce_base(
                dflt["coalesce_base_s"]))
        if dflt.get("max_queued") is not None:
            step("admission", lambda: eng.set_admission(
                max_queued=dflt["max_queued"],
                tier_quotas=dflt["tier_quotas"]))
        if "bucket_bias" in dflt:
            step("bucket_bias", lambda: eng.set_bucket_bias(
                dflt["bucket_bias"]))
        store = eng.subject_store
        if store is not None and dflt.get("warm_capacity"):
            step("warm_capacity", lambda: store.resize_warm(
                dflt["warm_capacity"]))
        with self._lock:
            self._retry_after = {}
            self._reverts += 1
            self._last_reason = f"revert:{reason}"
        ok["retry_after"] = True
        try:
            eng.counters.count_control_revert()
        except Exception:  # noqa: BLE001 — telemetry, not control
            pass
        tr = eng.tracer
        if tr is not None:
            try:
                tr.runtime_event("control_revert", reason=reason,
                                 restored=sum(ok.values()))
            except Exception:  # noqa: BLE001
                pass
        return ok

    # ------------------------------------------------------------ telemetry
    def snapshot(self) -> dict:
        """The ``load()["control"]`` block: controller state in ONE
        lock hold (the torn-telemetry rule). ``version`` equals
        ``actuations`` and every history entry carries the version it
        was recorded under — the invariant the torn-snapshot test
        pins (a reader can never see a history newer than the
        counters beside it)."""
        with self._lock:
            return {
                "attached": True,
                "running": self._running,
                "crashed": self._crashed,
                "ticks": self._ticks,
                "actuations": self._actuations,
                "reverts": self._reverts,
                "version": self._actuations,
                "values": {
                    "coalesce_base_s": self._eng.max_delay_s,
                    "max_queued": self._eng.max_queued,
                    "bucket_bias": self._eng.bucket_bias,
                    "retry_after_s": {str(t): v for t, v
                                      in self._retry_after.items()},
                },
                "last_reason": self._last_reason,
                "history": list(self._history),
            }

    def retry_after_for(self, tier: int, load: Optional[dict] = None,
                        ) -> Optional[int]:
        """The edge's ``retry_after_source``: the actuated per-tier
        Retry-After, or None when the controller has no opinion (no
        actuation yet, or crashed) — the caller then falls back to the
        static ``protocol.retry_after_s`` formula, so a dead
        controller degrades to today's wire behavior exactly."""
        with self._lock:
            if self._crashed or not self._retry_after:
                return None
            key = 0 if int(tier) <= 0 else 1
            return self._retry_after.get(key)

    # ------------------------------------------------------------- decision
    def _signals(self) -> dict:
        """One telemetry sweep: the engine's load() (every sub-block a
        one-lock-hold copy), the SLO report derived from ONE counters
        snapshot, and this tick's counter deltas."""
        from mano_hand_tpu_torch.obs.metrics import slo_report

        eng = self._eng
        load = eng.load()
        snap = eng.counters.snapshot()
        slo = slo_report(snap, self._objectives,
                         load.get("latency_by_tier"))
        return {"load": load, "slo": slo, "counters": snap}

    @staticmethod
    def _tier_burn(slo: dict, tier: str) -> float:
        t = (slo.get("tiers") or {}).get(tier)
        if not t:
            return 0.0
        burns = [v for v in (t.get("burn_rates") or {}).values()
                 if v == v]           # drop NaN defensively
        return max(burns) if burns else 0.0

    def _allowed(self, actuator: str, now: float) -> bool:
        last = self._last_actuation.get(actuator)
        return (last is None
                or now - last >= self._cfg.min_actuation_interval_s)

    def _actuate(self, actuator: str, before, after, reason: str,
                 now: float) -> None:
        """Record + event one applied actuation (the setter already
        ran; this is the bookkeeping half). History append, counter
        bump, and version bump share ONE lock hold with the values the
        snapshot reads beside them."""
        with self._lock:
            self._actuations += 1
            self._last_reason = reason
            self._last_actuation[actuator] = now
            self._history.append({
                "actuator": actuator, "before": before,
                "after": after, "reason": reason,
                "version": self._actuations,
            })
            del self._history[:-_HISTORY]
        try:
            self._eng.counters.count_control_actuation()
        except Exception:  # noqa: BLE001 — telemetry, not control
            pass
        tr = self._eng.tracer
        if tr is not None:
            try:
                tr.runtime_event("control", actuator=actuator,
                                 before=before, after=after,
                                 reason=reason)
            except Exception:  # noqa: BLE001
                pass

    def tick(self, signals: Optional[dict] = None) -> List[dict]:
        """One control decision: read signals, compare against the
        watermarks, actuate whatever is both out of its deadband and
        past its rate limit.  Returns the applied actuations (tests
        assert on it); every one is also evented and counted.

        A crashed controller never actuates again — the revert the
        crash path applied IS the final word until a fresh start()."""
        cfg = self._cfg
        with self._lock:
            if self._crashed:
                return []
        if signals is None:
            signals = self._signals()
        with self._lock:
            self._ticks += 1
        try:
            self._eng.counters.count_control_tick()
        except Exception:  # noqa: BLE001
            pass
        now = time.monotonic()
        eng = self._eng
        slo = signals.get("slo") or {}
        load = signals.get("load") or {}
        counters = signals.get("counters") or {}
        applied: List[dict] = []

        def apply(actuator: str, fn, reason: str) -> None:
            if not self._allowed(actuator, now):
                return
            try:
                delta = fn()
            except Exception as exc:  # noqa: BLE001 — one bad setter
                # must not kill the tick (the thread's crash path is
                # for CONTROLLER bugs; a rejected value is a no-op).
                self._log(f"actuate {actuator} rejected: "
                          f"{type(exc).__name__}: {exc}")
                return
            if delta["before"] == delta["after"]:
                return                # saturated at a bound: no event
            self._actuate(actuator, delta["before"], delta["after"],
                          reason, now)
            applied.append({"actuator": actuator, **delta,
                            "reason": reason})

        burn0 = self._tier_burn(slo, "0")
        backlog_age = float(load.get("backlog_age_s") or 0.0)
        max_queued = eng.max_queued

        # -- tier-1 quota: reallocate tier-0's idle headroom ------------
        if max_queued is not None:
            quota1 = eng._tier_quotas.get(1)
            if quota1 is None:
                quota1 = max_queued // 2
            lo = max(1, int(cfg.tier1_quota_min_fraction * max_queued))
            hi = max(lo, int(cfg.tier1_quota_max_fraction * max_queued))
            step = max(1, int(cfg.max_step_fraction * max_queued))
            if burn0 <= cfg.tier0_burn_low and quota1 < hi:
                target = min(hi, quota1 + step)
                apply("tier1_quota",
                      lambda: self._set_quota1(target),
                      f"tier0 burn {burn0:.2f} <= "
                      f"{cfg.tier0_burn_low} (cold): grow tier-1 "
                      f"quota {quota1} -> {target}")
            elif burn0 >= cfg.tier0_burn_high and quota1 > lo:
                target = max(lo, quota1 - step)
                apply("tier1_quota",
                      lambda: self._set_quota1(target),
                      f"tier0 burn {burn0:.2f} >= "
                      f"{cfg.tier0_burn_high} (hot): shed tier-1 "
                      f"sooner, quota {quota1} -> {target}")
            # Retry-After tracks the quota direction: clients get told
            # the truth about how long backing off actually helps.
            self._steer_retry_after(burn0, apply)

        # -- coalesce base: stop buying latency under a backlog ---------
        base = eng.max_delay_s
        if backlog_age >= cfg.backlog_age_high_s and \
                base > cfg.coalesce_min_s:
            target = max(cfg.coalesce_min_s,
                         base * (1.0 - cfg.max_step_fraction))
            apply("coalesce",
                  lambda: eng.set_coalesce_base(target),
                  f"backlog age {backlog_age * 1e3:.1f} ms >= "
                  f"{cfg.backlog_age_high_s * 1e3:.0f} ms: shrink "
                  "window base")
        elif backlog_age <= cfg.backlog_age_low_s:
            dflt = (self._defaults or {}).get("coalesce_base_s")
            if dflt is not None and base < dflt:
                target = min(dflt, cfg.coalesce_max_s,
                             max(base * (1.0 + cfg.max_step_fraction),
                                 dflt * cfg.max_step_fraction))
                apply("coalesce",
                      lambda: eng.set_coalesce_base(target),
                      f"backlog age {backlog_age * 1e3:.1f} ms <= "
                      f"{cfg.backlog_age_low_s * 1e3:.0f} ms: restore "
                      "window base")

        # -- bucket-ladder bias: shape uniformity under fragmentation ---
        fill = self._batch_fill(counters)
        if cfg.bucket_bias_max > 0 and fill is not None:
            if (burn0 >= cfg.tier0_burn_high
                    and fill < cfg.batch_fill_low
                    and eng.bucket_bias < cfg.bucket_bias_max):
                target = eng.bucket_bias + 1
                apply("bucket_bias",
                      lambda: eng.set_bucket_bias(target),
                      f"tier0 hot with fragmented batches "
                      f"(fill {fill:.2f}): bias ladder +1")
            elif (burn0 <= cfg.tier0_burn_low and eng.bucket_bias >
                  (self._defaults or {}).get("bucket_bias", 0)):
                target = (self._defaults or {}).get("bucket_bias", 0)
                apply("bucket_bias",
                      lambda: eng.set_bucket_bias(target),
                      "tier0 cold: restore ladder bias")

        # -- warm capacity: grow on sustained miss pressure -------------
        self._steer_warm(counters, apply)
        return applied

    # The setter thunks live apart from tick() so the decision block
    # reads as policy, not plumbing.
    def _set_quota1(self, target: int) -> dict:
        eng = self._eng
        quotas = dict(eng._tier_quotas)
        before = quotas.get(1, (eng.max_queued or 0) // 2)
        quotas[1] = int(target)
        eng.set_admission(tier_quotas=quotas)
        return {"before": before, "after": int(target)}

    def _steer_retry_after(self, burn0: float, apply) -> None:
        cfg = self._cfg
        with self._lock:
            cur = self._retry_after.get(1, 2)
        if burn0 >= cfg.tier0_burn_high:
            target = min(cfg.retry_after_max_s, max(cur * 2, 2))
        elif burn0 <= cfg.tier0_burn_low:
            target = max(1, cur // 2)
        else:
            return
        if target == cur and 1 in getattr(self, "_retry_after", {}):
            return

        def setter(t=target):
            with self._lock:
                before = self._retry_after.get(1)
                self._retry_after[1] = t
                self._retry_after.setdefault(0, 1)
            return {"before": before, "after": t}

        apply("retry_after",
              setter,
              f"tier0 burn {burn0:.2f}: tier-1 Retry-After -> "
              f"{target}s")

    def _batch_fill(self, counters: dict) -> Optional[float]:
        """Mean live-row fill of this tick's dispatches relative to
        the LARGEST bucket (the fragmentation signal the ladder bias
        keys on); None until two ticks have passed or when nothing
        dispatched."""
        rows = counters.get("rows_live")
        disp = counters.get("dispatches")
        if rows is None or disp is None:
            return None
        lr, ld = self._last_rows_live, self._last_dispatches
        self._last_rows_live, self._last_dispatches = rows, disp
        if lr is None or disp <= (ld or 0):
            return None
        cap = self._eng.buckets[-1]
        return (rows - lr) / max(1, (disp - ld)) / cap

    def _steer_warm(self, counters: dict, apply) -> None:
        cfg = self._cfg
        store = self._eng.subject_store
        if store is None:
            return
        misses = counters.get("subject_store_misses")
        if misses is None:
            return
        last = self._last_misses
        self._last_misses = misses
        if last is None:
            return
        delta = misses - last
        if delta >= cfg.warm_miss_grow_per_tick:
            self._warm_pressure_ticks += 1
            self._warm_idle_ticks = 0
        elif delta == 0:
            self._warm_idle_ticks += 1
            self._warm_pressure_ticks = 0
        else:
            self._warm_pressure_ticks = 0
            self._warm_idle_ticks = 0
        cap = store.config.warm_capacity
        dflt = (self._defaults or {}).get("warm_capacity") or cap
        if (self._warm_pressure_ticks >= cfg.warm_grow_ticks
                and cap < cfg.warm_capacity_max):
            target = min(cfg.warm_capacity_max,
                         int(cap * (1.0 + cfg.max_step_fraction)) + 1)
            apply("warm_capacity",
                  lambda: self._resize_warm(target),
                  f"warm misses +{delta}/tick x"
                  f"{self._warm_pressure_ticks} ticks: grow warm "
                  f"{cap} -> {target}")
            self._warm_pressure_ticks = 0
        elif (self._warm_idle_ticks >= cfg.warm_idle_shrink_ticks
              and cap > dflt):
            target = max(dflt,
                         int(cap * (1.0 - cfg.max_step_fraction)))
            apply("warm_capacity",
                  lambda: self._resize_warm(target),
                  f"warm idle {self._warm_idle_ticks} ticks: shrink "
                  f"warm {cap} -> {target}")
            self._warm_idle_ticks = 0

    def _resize_warm(self, target: int) -> dict:
        store = self._eng.subject_store
        r = store.resize_warm(int(target))
        return {"before": r.get("previous"),
                "after": r.get("warm_capacity")}
