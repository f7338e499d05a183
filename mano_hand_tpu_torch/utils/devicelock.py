"""Cooperative single-card lock for benchmark runs and shared servers.

Two benchmark processes timing kernels on one card at once corrupt each
other's numbers, and a retrying benchmark loop polling the card can
starve the exclusive run that matters. This module makes that contention
impossible by construction:

- every benchmark takes an exclusive ``flock`` on ``LOCK_PATH`` before it
  touches the card;
- the exclusive benchmark process (role ``"exclusive"``) also writes a
  priority-claim file for its whole lifetime. Retrying benchmark loops
  (role ``"retrying"``) and serving engines recovering from an outage
  poll that file and STAND DOWN while it is fresh, so the exclusive run
  never queues behind them;
- a retrying loop never waits: if the lock is held it raises
  ``DeviceBusy`` at once (the loop retries later);
- shared servers on one card (role ``"server"``) take a SHARED flock, so
  several coexist while any exclusive benchmark still excludes them all.

The lock is advisory: an exclusive benchmark that cannot get it within
``wait_s`` proceeds anyway (logging loudly) — worst case equals running
without the lock; it must never turn a stale lockfile into a missing
result.

A claim is "fresh" when the file exists and its mtime is younger than
``CLAIM_FRESH_S`` (a stale claim from a crashed benchmark must not wedge
the retrying loops forever).

The files are named for the CUDA card, so a lock taken for another
accelerator never blocks this one. They live in ``MANO_DEVICE_LOCK_DIR``,
else the process's temporary directory (``tempfile.gettempdir()``, which
follows ``TMPDIR``).
"""

from __future__ import annotations

import errno
import fcntl
import json
import os
import tempfile
import time

# MANO_DEVICE_LOCK_DIR redirects both files (tests isolate themselves so a
# test's benchmark subprocess never queues behind a real benchmark).
_LOCK_DIR = os.environ.get("MANO_DEVICE_LOCK_DIR") or tempfile.gettempdir()
LOCK_PATH = os.path.join(_LOCK_DIR, "mano_cuda_device.lock")
CLAIM_PATH = os.path.join(_LOCK_DIR, "mano_cuda_device.priority")
CLAIM_FRESH_S = 2.0 * 3600.0


class DeviceBusy(RuntimeError):
    """A retrying- or server-role process found the card taken (stand
    down)."""


def _claim_age_s() -> float | None:
    try:
        return time.time() - os.stat(CLAIM_PATH).st_mtime
    except OSError:
        return None


def priority_claim_active() -> bool:
    """True while an exclusive benchmark holds (or recently held) its
    claim."""
    age = _claim_age_s()
    return age is not None and age < CLAIM_FRESH_S


class DeviceLock:
    """``with DeviceLock(role, ...):`` around any card-touching benchmark.

    role="exclusive": the exclusive benchmark. Writes the priority claim,
    waits up to ``wait_s`` for the EXCLUSIVE flock (refreshing the claim
    so retrying loops keep standing down), then proceeds with or without
    it.
    role="retrying": a retrying benchmark loop. Raises DeviceBusy if a
    fresh priority claim exists or the flock is held — never waits, never
    blocks the exclusive benchmark.
    role="server": a serving process sharing the card. Takes a SHARED
    flock, so N servers coexist while any benchmark's exclusive lock
    still excludes them all. Like a retrying loop it never waits and
    stands down for a fresh claim or a running exclusive benchmark;
    unlike one it does not conflict with its sibling servers. An
    exclusive benchmark arriving while servers hold shared locks rides
    its advisory wait (servers are expected to drain on the operator's
    SIGTERM well inside that window).
    """

    def __init__(self, role: str = "exclusive", wait_s: float = 1200.0,
                 log=lambda m: None):
        if role not in ("exclusive", "retrying", "server"):
            raise ValueError(f"unknown role {role!r}")
        self.role = role
        self.wait_s = wait_s
        self.log = log
        self._fd = None
        self._locked = False
        self._claimed = False

    def _write_claim(self) -> None:
        tmp = f"{CLAIM_PATH}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(), "t": time.time()}, f)
        os.replace(tmp, CLAIM_PATH)
        self._claimed = True

    def __enter__(self) -> "DeviceLock":
        os.makedirs(_LOCK_DIR, exist_ok=True)
        if self.role in ("retrying", "server") and priority_claim_active():
            raise DeviceBusy(
                f"priority claim at {CLAIM_PATH} is fresh "
                f"(age {_claim_age_s():.0f}s) — {self.role} stands down")
        if self.role == "exclusive":
            self._write_claim()
        if self.role == "server":
            # Shared mode: open append (never clobber an exclusive
            # holder's info line) and LOCK_SH so sibling servers coexist;
            # an exclusive benchmark lock refuses us.
            self._fd = open(LOCK_PATH, "a")
            try:
                fcntl.flock(self._fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
            except OSError as e:
                self._fd.close()
                self._fd = None
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
                raise DeviceBusy(
                    "device lock held exclusively by a benchmark — server "
                    "stands down") from None
            self._locked = True
            self.log("device lock acquired (server, shared)")
            return self
        self._fd = open(LOCK_PATH, "w")
        # Monotonic deadline arithmetic: a wall-clock step during the wait
        # must neither end it at once nor stretch it forever. Wall-clock
        # time.time() stays ONLY in the cross-process claim timestamps,
        # which are compared against file mtimes on the same clock.
        deadline = time.monotonic() + self.wait_s
        while True:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._locked = True
                self._fd.truncate(0)
                self._fd.write(json.dumps(
                    {"pid": os.getpid(), "role": self.role}))
                self._fd.flush()
                self.log(f"device lock acquired ({self.role})")
                return self
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
            if self.role == "retrying":
                self._fd.close()
                self._fd = None
                raise DeviceBusy("device lock held by another benchmark — "
                                 "retrying stands down")
            if time.monotonic() >= deadline:
                self.log(f"WARNING: device lock still held after "
                         f"{self.wait_s:.0f}s wait — proceeding WITHOUT "
                         "it (advisory); expect contention in timings")
                return self
            self._write_claim()  # refresh mtime: retrying loops yield
            time.sleep(10.0)

    @property
    def acquired(self) -> bool:
        """True iff the flock is actually held (an exclusive benchmark past
        its advisory wait proceeds with acquired=False; callers that need
        exclusivity check this)."""
        return self._locked

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            if self._locked:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            self._fd.close()
            self._fd = None
        if self._claimed:
            try:
                # Remove only OUR claim: a second exclusive benchmark
                # (anomalous but possible) must not clear the surviving
                # one's priority on its way out.
                with open(CLAIM_PATH) as f:
                    owner = json.load(f).get("pid")
                if owner == os.getpid():
                    os.remove(CLAIM_PATH)
            except (OSError, ValueError):
                pass
