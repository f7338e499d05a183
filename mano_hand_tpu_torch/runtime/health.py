"""Device health state machine / circuit breaker for the serving paths.

A lost or wedged card makes per-call retries the wrong tool past the
first seconds: every retry burns a deadline worth of wall clock against a
device that is simply gone. The breaker turns repeated failures into a
STATE — healthy -> degraded -> down — so the engine stops paying the
primary path (a CPU engine fails over to its CPU tier; a card engine,
which has none, resolves the batch to a ``ServingError``), and re-probes
the card on a bounded cadence until it comes back.

Probing is the dangerous part, with two rules built in:

* a probe must be KILLABLE: a CUDA context init on a wedged card can hang
  the calling process, so the default probe runs the query in a
  subprocess via ``supervise.run_python`` and kills it on timeout — never
  in-process;
* a probe must STAND DOWN for an exclusive benchmark's priority claim
  (``utils/devicelock.py``): a recovering engine probing the card during
  an exclusive benchmark window is the contention the device lock exists
  to prevent. While the claim is fresh the breaker stays open without
  probing.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from mano_hand_tpu_torch.runtime import supervise

HEALTHY = "healthy"
DEGRADED = "degraded"
DOWN = "down"

# The probe: name the card and move one element to it and back, in a
# fresh interpreter. ``platform`` "" (or "cuda") probes CUDA device
# ``index``, "cpu" the host. Prints ``platform:kind``.
_PROBE_CODE = (
    "import torch;"
    "plat = {platform!r} or 'cuda';"
    "dev = torch.device('cpu') if plat == 'cpu' "
    "else torch.device('cuda', {index!r});"
    "kind = 'cpu' if plat == 'cpu' else torch.cuda.get_device_name(dev);"
    "x = torch.ones(1, device=dev).cpu();"
    "assert float(x[0]) == 1.0;"
    "print(plat + ':' + kind)"
)


def device_probe(platform: str = "", timeout_s: float = 30.0,
                 index: int = 0) -> bool:
    """Probe backend liveness in a killable subprocess (True = alive):
    CUDA device ``index`` (the breaker's default probe checks card 0),
    or the host for ``platform="cpu"``."""
    return supervise.run_python(
        _PROBE_CODE.format(platform=platform, index=int(index)),
        timeout_s).ok


class CircuitBreaker:
    """healthy -> degraded -> down, with killable re-probe to close.

    * ``record_failure()``: one failed primary attempt. The state moves to
      DEGRADED immediately and to DOWN once ``failure_threshold``
      CONSECUTIVE failures accumulate.
    * ``record_success()``: a primary success resets to HEALTHY.
    * ``allow_primary()``: the dispatch-time gate. True while not DOWN.
      When DOWN it re-probes on a bounded cadence — skipping entirely
      while an exclusive benchmark's priority claim is fresh (see the
      module docstring) — and a successful probe closes the breaker
      (HEALTHY) and returns True, restoring the primary path.

    The re-probe cadence follows the outage's length: each consecutive
    FAILED probe multiplies the interval by ``probe_backoff`` up to
    ``probe_interval_cap_s`` (default ``32 * probe_interval_s``), and any
    successful probe (or primary success) resets it to
    ``probe_interval_s``. A blip recovers fast; a long outage converges
    to one cheap probe per cap window.

    Thread-safe; the probe itself runs outside the lock (it can take the
    probe's timeout — other dispatchers keep failing over meanwhile
    instead of queueing on the lock).
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        probe: Optional[Callable[[], bool]] = None,
        probe_interval_s: float = 30.0,
        probe_backoff: float = 2.0,
        probe_interval_cap_s: Optional[float] = None,
        respect_priority_claim: bool = True,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if probe_backoff < 1.0:
            raise ValueError(
                f"probe_backoff must be >= 1.0 (a shrinking re-probe "
                f"interval hammers a downed backend), got {probe_backoff}")
        self.failure_threshold = int(failure_threshold)
        self.probe = probe if probe is not None else device_probe
        self.probe_interval_s = float(probe_interval_s)
        self.probe_backoff = float(probe_backoff)
        self.probe_interval_cap_s = (
            32.0 * self.probe_interval_s if probe_interval_cap_s is None
            else float(probe_interval_cap_s))
        if self.probe_interval_cap_s < self.probe_interval_s:
            raise ValueError(
                f"probe_interval_cap_s {self.probe_interval_cap_s} < "
                f"probe_interval_s {self.probe_interval_s}")
        self.respect_priority_claim = bool(respect_priority_claim)
        self.clock = clock
        # Called as ``on_transition(old, new)`` on every state CHANGE,
        # outside the breaker lock (the hook may take its own).
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._consecutive_failures = 0
        self._last_probe_t: Optional[float] = None
        self._probing = False
        self._failed_probes = 0    # consecutive — drives the backoff
        self.probes = 0            # lifetime probe attempts (audit)
        self.opens = 0             # times the breaker tripped to DOWN

    # -------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failed_probes(self) -> int:
        """Failed re-probes since the last success — the backoff
        exponent."""
        with self._lock:
            return self._failed_probes

    def probe_due(self) -> bool:
        """Cheap, non-probing check: would ``allow_primary()`` run a
        re-probe right now?"""
        with self._lock:
            if self._state != DOWN or self._probing:
                return False
            if self.respect_priority_claim:
                from mano_hand_tpu_torch.utils import devicelock

                if devicelock.priority_claim_active():
                    return False
            return (self._last_probe_t is None
                    or self.clock() - self._last_probe_t
                    >= self._probe_wait_locked())

    def probe_wait_s(self) -> float:
        """The CURRENT re-probe interval: ``probe_interval_s`` grown
        ``probe_backoff``-fold per consecutive failed probe, capped at
        ``probe_interval_cap_s``."""
        with self._lock:
            return self._probe_wait_locked()

    def _probe_wait_locked(self) -> float:
        return min(self.probe_interval_cap_s,
                   self.probe_interval_s
                   * self.probe_backoff ** self._failed_probes)

    def _notify(self, old: str, new: str) -> None:
        """Fire ``on_transition`` for a state CHANGE — outside the lock,
        and never letting a broken hook poison the dispatch path that
        carried the state change."""
        if old != new and self.on_transition is not None:
            try:
                self.on_transition(old, new)
            except Exception:  # noqa: BLE001 — telemetry, not control
                pass

    def reset(self) -> None:
        with self._lock:
            old = self._state
            self._state = HEALTHY
            self._consecutive_failures = 0
            self._last_probe_t = None
            self._failed_probes = 0
        self._notify(old, HEALTHY)

    def record_failure(self) -> str:
        with self._lock:
            old = self._state
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                if self._state != DOWN:
                    self.opens += 1
                self._state = DOWN
            elif self._state == HEALTHY:
                self._state = DEGRADED
            new = self._state
        self._notify(old, new)
        return new

    def record_success(self) -> str:
        with self._lock:
            old = self._state
            self._consecutive_failures = 0
            self._failed_probes = 0
            self._state = HEALTHY
        self._notify(old, HEALTHY)
        return HEALTHY

    # ----------------------------------------------------------- the gate
    def allow_primary(self) -> bool:
        with self._lock:
            if self._state != DOWN:
                return True
            if self.respect_priority_claim:
                # Lazy import: CPU-only users never touch the lock
                # module's path resolution unless a breaker opens with
                # claim-awareness on.
                from mano_hand_tpu_torch.utils import devicelock

                if devicelock.priority_claim_active():
                    # An exclusive benchmark owns the card: no probes, no
                    # primary traffic, stay failed over.
                    return False
            now = self.clock()
            if (self._probing
                    or (self._last_probe_t is not None
                        and now - self._last_probe_t
                        < self._probe_wait_locked())):
                return False
            self._probing = True       # one prober at a time
            self._last_probe_t = now
            self.probes += 1
        try:
            ok = bool(self.probe())
        except Exception:  # noqa: BLE001 — a crashing probe is a failed one
            ok = False
        with self._lock:
            self._probing = False
            old = self._state
            if ok:
                self._state = HEALTHY
                self._consecutive_failures = 0
                self._failed_probes = 0
            else:
                # One more failed re-probe: the NEXT wait grows (up to
                # the cap).
                self._failed_probes += 1
        if ok:
            self._notify(old, HEALTHY)
        return ok


def failover_ladder(failed: int, n_lanes: int, backlog_rows,
                    allow: Callable[[int], bool]):
    """Sibling order for a per-lane failover ladder:
    device -> least-loaded healthy sibling lane -> CPU tier.

    Given the index of the lane whose primary dispatch just exhausted
    supervision, returns its sibling lane indices in the order to try
    them: every sibling ``allow`` admits (its breaker not DOWN),
    least-backlogged first (``backlog_rows`` maps lane index -> queued +
    in-flight rows), index as the tie-break so the order is deterministic
    under equal load. The CPU tier is NOT in the list — it is the
    ladder's implicit last rung, owned by the caller, and only where the
    caller serves from the CPU (a card engine has no CPU tier). An empty
    list means every sibling is down too.
    """
    sibs = [i for i in range(int(n_lanes)) if i != failed and allow(i)]
    sibs.sort(key=lambda i: (backlog_rows.get(i, 0), i))
    return sibs
