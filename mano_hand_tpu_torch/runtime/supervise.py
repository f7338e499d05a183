"""Supervised execution of device calls: deadlines, retries, watchdogs.

A port copy of the JAX package's ``runtime/supervise.py``, in plain
Python. A thread blocked inside a C-level device call (a wedged kernel, a
lost card) cannot be interrupted in-process: signal handlers run only on
the main thread, between bytecodes. So the defences are:

* run the risky call on a DISPOSABLE worker thread and bound the wait
  (``call_with_deadline``): the wedged thread is abandoned (daemon), the
  caller gets ``DeadlineExceeded`` and keeps its state;
* keep a daemon WATCHDOG thread that still runs while the main thread is
  wedged, and have it escalate (``Watchdog``);
* run work that must be killable for real (a device probe that can hang
  the whole process at init) in a SUBPROCESS and kill it
  (``run_python``): SIGKILL from outside is the one signal a wedged call
  cannot block.

``supervised_call`` retries only what ``classify_failure`` deems
transient, with exponential backoff and jitter under a cap: retrying a
deterministic failure (a shape error, a sticky CUDA fault) only
reproduces it. The callers wait for the device inside the supervised
window (the serving engine reads its result back to the host there,
``MANOModel.fit`` synchronizes), since the hang being guarded against
lives in the device work, not in the Python call.
"""

from __future__ import annotations

import random
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"

# Status markers of a lost connection to the device rather than of the
# program: worth a bounded retry. INVALID_ARGUMENT et al. are absent on
# purpose — those are compile/shape errors that reproduce every time, and
# so is "CUDA error: ..." (a sticky fault poisons the context: every
# later call fails the same way).
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
    "UNKNOWN: ", "INTERNAL: ", "connection reset", "connection refused",
    "socket closed", "broken pipe", "tunnel",
)


class DeadlineExceeded(RuntimeError):
    """A supervised call outlived its deadline and was abandoned."""


class RetriesExhausted(RuntimeError):
    """Every allowed attempt of a supervised call failed transiently."""

    def __init__(self, message: str, cause: BaseException, attempts: int):
        super().__init__(message)
        self.cause = cause
        self.attempts = attempts


def classify_failure(exc: BaseException) -> str:
    """``transient`` (bounded retry is rational) or ``deterministic``
    (retrying reproduces the failure — never retry).

    Unknown exception types default to DETERMINISTIC: an optimistic
    retry loop is worse than a clean failure.
    """
    transient = getattr(exc, "transient", None)
    if transient is not None:          # injected faults declare their kind
        return TRANSIENT if transient else DETERMINISTIC
    if isinstance(exc, DeadlineExceeded):
        return TRANSIENT
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError,
                        AttributeError, NotImplementedError,
                        ZeroDivisionError, AssertionError)):
        return DETERMINISTIC
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    msg = f"{type(exc).__name__}: {exc}"
    if any(marker in msg for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


def call_with_deadline(fn: Callable, deadline_s: Optional[float],
                       name: str = "supervised-call"):
    """Run ``fn()`` with a hard wall-clock bound.

    ``deadline_s=None`` calls inline (no thread). Otherwise the call
    runs on a disposable daemon thread; if it has not finished inside
    the deadline the thread is ABANDONED (it cannot be killed — see the
    module docstring) and ``DeadlineExceeded`` raises in the caller.
    The abandoned thread's eventual result/exception is discarded.
    """
    if deadline_s is None:
        return fn()
    box: list = []

    def run() -> None:
        try:
            box.append((True, fn()))
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box.append((False, e))

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    t.join(deadline_s)
    if not box:
        # Still running (or died without reporting — impossible short of
        # interpreter teardown): the caller moves on, the thread is
        # leaked by design.
        raise DeadlineExceeded(
            f"{name} exceeded its {deadline_s:.3g}s deadline and was "
            "abandoned (a wedged device RPC cannot be interrupted "
            "in-process — only a subprocess kill -9 truly clears one)")
    ok, payload = box[0]
    if ok:
        return payload
    raise payload


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  jitter: float, rng: Optional[random.Random] = None,
                  ) -> float:
    """Exponential backoff with full-ish jitter: ``base * 2^attempt``
    capped at ``cap_s``, scaled by a uniform factor in
    ``[1 - jitter, 1 + jitter]``. ``jitter=0`` is fully deterministic
    (tests)."""
    delay = min(base_s * (2.0 ** attempt), cap_s)
    if jitter:
        r = rng if rng is not None else random
        delay *= 1.0 + jitter * (2.0 * r.random() - 1.0)
    return max(0.0, delay)


def batch_give_up_by(deadlines) -> Optional[float]:
    """The end-to-end supervision bound for one coalesced batch: the
    LATEST member deadline, or None when any member is deadline-less
    (one unbounded consumer keeps the whole batch's budget unbounded).

    The deadlines are absolute ``time.monotonic`` timestamps, so time a
    batch already spent queued is charged against the same budget:
    ``supervised_call`` clips each attempt to ``give_up_by - clock()`` at
    the attempt's start.
    """
    deadlines = list(deadlines)
    if not deadlines or any(d is None for d in deadlines):
        return None
    return max(deadlines)


def supervised_call(
    fn: Callable,
    *,
    deadline_s: Optional[float] = None,
    retries: int = 0,
    backoff_s: float = 0.05,
    backoff_cap_s: float = 2.0,
    jitter: float = 0.5,
    give_up_by: Optional[float] = None,
    classify: Callable[[BaseException], str] = classify_failure,
    keep_trying: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable] = None,
    on_deadline_kill: Optional[Callable] = None,
    on_attempt_failure: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    name: str = "supervised-call",
):
    """THE supervised dispatch primitive: ``fn()`` under a per-attempt
    deadline, with bounded classified retries.

    * deterministic failures raise IMMEDIATELY, unretried (a compile
      error rerun is the same compile error, minutes later);
    * transient failures (including deadline kills) are retried up to
      ``retries`` times with exponential backoff + jitter;
    * ``keep_trying`` (e.g. a circuit breaker's ``allow_primary``) is
      consulted before each retry so an opened breaker short-circuits
      the remaining budget;
    * ``give_up_by`` (a ``clock()``-domain timestamp — ``time.monotonic``
      by default) is an END-TO-END bound over ALL attempts: no retry
      starts past it, and each attempt's deadline is clipped to the
      remaining budget, so supervision never burns retry budget
      producing a result every caller has already given up on;
    * hooks (``on_retry``/``on_deadline_kill``/``on_attempt_failure``)
      feed counters and breakers without coupling this module to them.

    Raises the deterministic failure as-is, or ``RetriesExhausted``
    (carrying ``.cause`` and ``.attempts``) when the budget runs out —
    including when ``give_up_by`` cut it short.
    """
    last: Optional[BaseException] = None
    attempts = 0
    for attempt in range(max(0, retries) + 1):
        if attempt > 0:
            if keep_trying is not None and not keep_trying():
                break
            if give_up_by is not None and clock() >= give_up_by:
                # The whole-call budget is spent: a retry now could only
                # finish after every consumer's deadline. RetriesExhausted
                # below carries the last transient cause.
                break
            sleep(backoff_delay(attempt - 1, backoff_s, backoff_cap_s,
                                jitter))
            if give_up_by is not None and clock() >= give_up_by:
                # The backoff itself consumed the remaining budget:
                # launching the attempt now would still start fn() on a
                # disposable thread (call_with_deadline only bounds the
                # JOIN) — a real dispatch for a result nobody will read,
                # on a thread that can wedge in a C-level call. Checked
                # AFTER the sleep so no retry ever starts past give_up_by,
                # as documented.
                break
            if on_retry is not None:
                on_retry()
        attempts += 1
        eff_deadline = deadline_s
        if give_up_by is not None:
            remaining = give_up_by - clock()
            # Clip, never extend (the attempt itself starts pre-budget;
            # only its join window shrinks).
            eff_deadline = (remaining if eff_deadline is None
                            else min(eff_deadline, remaining))
        try:
            return call_with_deadline(fn, eff_deadline, name=name)
        except DeadlineExceeded as e:
            last = e
            if on_deadline_kill is not None:
                on_deadline_kill()
            if on_attempt_failure is not None:
                on_attempt_failure()
        except BaseException as e:  # noqa: BLE001 — classified below
            if classify(e) == DETERMINISTIC:
                raise
            last = e
            if on_attempt_failure is not None:
                on_attempt_failure()
    raise RetriesExhausted(
        f"{name} failed {attempts} attempt(s); last: "
        f"{type(last).__name__}: {last}", cause=last, attempts=attempts)


@dataclass
class DispatchPolicy:
    """Supervision knobs for ``ServingEngine`` dispatch
    (``serving/engine.py``).

    ``deadline_s`` bounds each device call (None = unbounded). ``breaker``
    is a ``runtime.health.CircuitBreaker`` (None = no health tracking);
    ``chaos`` a ``runtime.chaos.ChaosPlan`` injected into the PRIMARY
    callables only (the fallback stays clean, so failover is observable
    recovery, not roulette). ``cpu_fallback`` enables graceful
    degradation to the CPU tier when the primary path is exhausted or the
    breaker is open; the serving engine takes it on ``device="cpu"``
    only, and refuses it on a card.
    """

    deadline_s: Optional[float] = None
    retries: int = 2
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.5
    breaker: Optional[object] = None
    chaos: Optional[object] = None
    cpu_fallback: bool = True


class Watchdog:
    """A deadline/stall watchdog THREAD.

    A daemon thread polls two triggers and fires ``on_trigger(cause)`` at
    most once:

    * **deadline**: ``now - t0 >= deadline_s`` — the artifact must be out
      before an external killer cuts the process mid-line;
    * **stall**: no progress (a caller-updated timestamp) for ``stall_s``
      while ``armed()`` — the hung-device-call trigger, which a signal
      handler cannot cover (see the module docstring).

    ``on_trigger`` runs ON the watchdog thread and typically ends in
    ``os._exit``; it must not assume the main thread is runnable.
    """

    def __init__(
        self,
        on_trigger: Callable[[str], None],
        *,
        deadline_s: Optional[float] = None,
        stall_s: Optional[float] = None,
        t0: Optional[float] = None,
        progress: Optional[Callable[[], float]] = None,
        armed: Optional[Callable[[], bool]] = None,
        poll_s: float = 2.0,
        name: str = "watchdog",
        clock: Callable[[], float] = time.time,
    ):
        if stall_s and progress is None:
            raise ValueError("a stall trigger needs a progress() source")
        self.on_trigger = on_trigger
        self.deadline_s = deadline_s or None
        self.stall_s = stall_s or None
        self.t0 = clock() if t0 is None else t0
        self.progress = progress
        self.armed = armed
        self.poll_s = poll_s
        self.name = name
        self.clock = clock
        self._disarmed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self.deadline_s is None and self.stall_s is None:
            return self  # nothing to watch: spawn no thread at all
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True)
        self._thread.start()
        return self

    def disarm(self) -> None:
        """Permanently stand the watchdog down (the guarded phase
        finished, or the backend cannot hang)."""
        self._disarmed.set()

    def _loop(self) -> None:
        while not self._disarmed.wait(self.poll_s):
            now = self.clock()
            if self.deadline_s and now - self.t0 >= self.deadline_s:
                self.on_trigger(
                    f"{self.name}: emit-by deadline "
                    f"({self.deadline_s:.0f}s) hit")
                return
            if (self.stall_s and (self.armed is None or self.armed())
                    and now - self.progress() >= self.stall_s):
                self.on_trigger(
                    f"{self.name}: no progress for {self.stall_s:.0f}s "
                    "(hung device call?)")
                return


@dataclass
class ProbeResult:
    ok: bool
    out: str = ""
    err: str = ""
    rc: Optional[int] = None
    killed: bool = field(default=False)


def run_python(code: str, timeout_s: float) -> ProbeResult:
    """Run ``python -c code`` in a KILLABLE subprocess.

    The in-process primitives above can only abandon a wedged call; this
    is the escalation path that truly clears one — SIGKILL from outside
    the process. A hang past ``timeout_s`` is killed and reported, never
    waited out.
    """
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except OSError as e:
        return ProbeResult(ok=False, err=f"spawn failed: {e}")
    try:
        out, err = proc.communicate(timeout=timeout_s)
        return ProbeResult(ok=proc.returncode == 0, out=out.strip(),
                           err=err.strip(), rc=proc.returncode)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return ProbeResult(ok=False, out=(out or "").strip(),
                           err=f"probe hung > {timeout_s:.0f}s (killed)",
                           rc=proc.returncode, killed=True)
