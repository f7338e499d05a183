"""Worker-process supervision for the fleet front tier.

A port of the JAX package's ``edge/fleet.py``: the workers it spawns
run ``python -m mano_hand_tpu_torch.cli [--device D] serve ...`` and
the proxies ``... proxy ...``, each a process of its own with its own
interpreter (and, on a card, its own CUDA context).

edge/proxy.py routes over backends it is HANDED; this module is the
half that makes those backends: spawn N ``serve`` worker processes,
parse each one's stdout ready line for its port, and keep every wait
BOUNDED with a SIGKILL backstop: anything long-running needs a kill
-9-capable supervisor, never a signal handler it hopes gets delivered.
SIGTERM is the polite path (the worker's documented drain), but a
worker wedged in a C-level call (a CUDA call included) cannot run a
Python handler, so ``terminate()`` always escalates to SIGKILL at its
deadline.

The stdout contract is ``serve``'s: exactly two JSON lines — a ready
line ``{"edge": {host, port, pid, ...}}`` at bind time and an exit
line ``{"edge_exit": {...}}`` after the drain (it carries the worker's
span accounting, build counters and kernel launch counts, the
cross-process halves of the fleet drill's span-once, zero-recompile
and launch judgments). A reader thread drains the pipe continuously —
a worker must never block on a full stdout pipe — and stderr goes to
a per-worker log file (or devnull) for the same reason.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from mano_hand_tpu_torch.edge.proxy import Backend, EdgeProxy


class WorkerSpec:
    """The knobs one ``serve`` worker boots with. ``extra`` is passed
    through verbatim (flags this module need not know). ``device`` is
    the port's global ``--device`` (``cuda``/``cpu``; "" = the
    default, the card) where JAX's spec takes ``platform``."""

    def __init__(self, *, asset: str = "synthetic",
                 side: Optional[str] = None,
                 device: str = "", lanes: int = 0,
                 max_bucket: int = 64, max_delay_ms: float = 2.0,
                 max_queued: int = 256, max_subjects: int = 0,
                 aot_dir: str = "",
                 store_warm_capacity: int = 0,
                 no_warmup: bool = False,
                 warm_streams: bool = False,
                 drain_timeout_s: float = 15.0,
                 device_lock: str = "auto",
                 port: int = 0,
                 extra: Sequence[str] = (),
                 extra_env: Optional[Dict[str, str]] = None):
        self.port = int(port)
        self.asset = asset
        self.side = side
        self.device = device
        self.lanes = int(lanes)
        self.max_bucket = int(max_bucket)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queued = int(max_queued)
        self.max_subjects = int(max_subjects)
        self.aot_dir = aot_dir
        self.store_warm_capacity = int(store_warm_capacity)
        self.no_warmup = bool(no_warmup)
        self.warm_streams = bool(warm_streams)
        self.drain_timeout_s = float(drain_timeout_s)
        self.device_lock = device_lock
        self.extra = tuple(extra)
        self.extra_env = dict(extra_env or {})

    def argv(self) -> List[str]:
        cmd = [sys.executable, "-m", "mano_hand_tpu_torch.cli"]
        if self.device:
            cmd += ["--device", self.device]
        # port=0 lets the OS pick; a FIXED port is the heal contract —
        # a replacement worker binds
        # the DEAD worker's port, so a subprocess proxy's static
        # backend list (and any client that memorized the address)
        # stays valid with no re-wiring call.
        cmd += ["serve", "--host", "127.0.0.1", "--port", str(self.port),
                "--asset", self.asset,
                "--max-bucket", str(self.max_bucket),
                "--max-delay-ms", repr(self.max_delay_ms),
                "--max-queued", str(self.max_queued),
                "--drain-timeout-s", repr(self.drain_timeout_s),
                "--device-lock", self.device_lock]
        if self.side:
            cmd += ["--side", self.side]
        if self.lanes:
            cmd += ["--lanes", str(self.lanes)]
        if self.max_subjects:
            cmd += ["--max-subjects", str(self.max_subjects)]
        if self.aot_dir:
            cmd += ["--aot-dir", self.aot_dir]
        if self.store_warm_capacity:
            cmd += ["--store-warm-capacity",
                    str(self.store_warm_capacity)]
        if self.no_warmup:
            cmd += ["--no-warmup"]
        if self.warm_streams:
            cmd += ["--warm-streams"]
        cmd += list(self.extra)
        return cmd

    def with_port(self, port: int) -> "WorkerSpec":
        """A copy of this spec pinned to ``port`` — the supervisor's
        replacement-boot spec (same knobs, the dead worker's port)."""
        import copy

        spec = copy.copy(self)
        spec.extra = tuple(self.extra)
        spec.extra_env = dict(self.extra_env)
        spec.port = int(port)
        return spec


class WorkerProc:
    """One supervised ``serve`` process.

    ``start()`` spawns it; ``wait_ready()`` blocks (bounded, SIGKILL
    on timeout) until the stdout ready line names the bound port;
    ``terminate()`` is SIGTERM + bounded wait + SIGKILL backstop;
    ``kill()`` is the chaos drill's instant SIGKILL. ``exit_report``
    holds the parsed ``edge_exit`` line once the process printed one
    (a SIGKILLed worker never does — by construction)."""

    def __init__(self, name: str, spec: WorkerSpec, *,
                 env: Optional[Dict[str, str]] = None,
                 stderr_path: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.name = name
        self.spec = spec
        self._env = env
        self._stderr_path = stderr_path
        self._log = log or (lambda m: None)
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._stderr_f = None
        self._ready = threading.Event()
        self._exited = threading.Event()
        self.ready_info: Optional[dict] = None
        self.exit_report: Optional[dict] = None
        self.stdout_lines: List[str] = []
        self.returncode: Optional[int] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "WorkerProc":
        if self._proc is not None:
            return self
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        # Per-spec env wins over the fleet-wide env (a per-worker
        # setting the fleet-wide env must not clobber).
        if self.spec.extra_env:
            env.update(self.spec.extra_env)
        if self._stderr_path:
            self._stderr_f = open(self._stderr_path, "ab")
            stderr = self._stderr_f
        else:
            stderr = subprocess.DEVNULL
        self._proc = subprocess.Popen(
            self.spec.argv(), stdout=subprocess.PIPE, stderr=stderr,
            env=env, start_new_session=True)
        self._reader = threading.Thread(
            target=self._drain_stdout, name=f"stdout-{self.name}",
            daemon=True)
        self._reader.start()
        return self

    def _drain_stdout(self) -> None:
        proc = self._proc
        try:
            for raw in proc.stdout:
                line = raw.decode("utf-8", "replace").rstrip("\n")
                self.stdout_lines.append(line)
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if "edge" in d:
                    self.ready_info = d["edge"]
                    self._ready.set()
                elif "edge_exit" in d:
                    self.exit_report = d["edge_exit"]
        except (OSError, ValueError):
            pass
        finally:
            self._exited.set()
            self._ready.set()           # never strand a ready waiter

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    @property
    def port(self) -> Optional[int]:
        return (None if self.ready_info is None
                else int(self.ready_info["port"]))

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def wait_ready(self, timeout_s: float = 120.0) -> "WorkerProc":
        """Block until the ready line lands; a worker that failed (or
        wedged) before binding is SIGKILLed and reported — a boot must
        never hang the fleet."""
        if not self._ready.wait(timeout=timeout_s):
            self.kill()
            raise RuntimeError(
                f"worker {self.name} did not become ready within "
                f"{timeout_s}s")
        if self.ready_info is None:
            rc = self._proc.poll() if self._proc else None
            self.kill()
            raise RuntimeError(
                f"worker {self.name} exited (rc={rc}) before its "
                f"ready line; stdout: {self.stdout_lines[-3:]}")
        return self

    def kill(self) -> None:
        """The chaos path: SIGKILL now. The process gets no drain, no
        exit line, and its tracer dies with it (the drill's span
        accounting excludes it by construction)."""
        if self._proc is None:
            return
        try:
            self._proc.kill()
        except OSError:
            pass
        self._finish(join_timeout_s=10.0)

    def terminate(self, timeout_s: float = 30.0) -> Optional[dict]:
        """The polite path: SIGTERM (the worker drains and prints its
        exit line), bounded by ``timeout_s`` with a SIGKILL backstop —
        SIGTERM needs the worker's main thread, and a worker wedged in
        a C-level call never runs the handler. Returns the
        parsed exit report (None if the backstop fired first)."""
        if self._proc is None:
            return None
        if self._proc.poll() is None:
            try:
                self._proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        try:
            self._proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self._log(f"worker {self.name}: SIGTERM deadline hit — "
                      f"SIGKILL backstop")
            try:
                self._proc.kill()
            except OSError:
                pass
        self._finish(join_timeout_s=max(1.0,
                                        deadline - time.monotonic()))
        return self.exit_report

    def _finish(self, join_timeout_s: float) -> None:
        try:
            self._proc.wait(timeout=join_timeout_s)
        except subprocess.TimeoutExpired:
            pass
        self.returncode = self._proc.poll()
        if self._reader is not None:
            self._reader.join(timeout=join_timeout_s)
        if self._stderr_f is not None:
            try:
                self._stderr_f.close()
            except OSError:
                pass
            self._stderr_f = None


class Fleet:
    """N workers + one proxy, as a unit: the rolling-deploy substrate.

    ``start()`` boots every worker (bounded), waits for all ready
    lines, then fronts them with an ``EdgeProxy``. ``kill_worker``
    (chaos) and ``drain_worker`` (deploy: proxy-side stream migration,
    then SIGTERM) are the two removal paths the fleet drill
    exercises; ``stop()`` tears the whole thing down and returns every
    worker's exit report."""

    def __init__(self, specs: Sequence[WorkerSpec], *,
                 env: Optional[Dict[str, str]] = None,
                 stderr_dir: Optional[str] = None,
                 proxy_kwargs: Optional[dict] = None,
                 external_proxy: bool = False,
                 log: Optional[Callable[[str], None]] = None):
        self._log = log or (lambda m: None)
        self._env = env
        self._stderr_dir = stderr_dir
        # An externally-supervised proxy pair (ProxyPair) fronts
        # the workers instead of an in-process EdgeProxy; start() then
        # leaves self.proxy None, and the FleetSupervisor's heal path
        # re-enters routing by re-binding the dead worker's fixed port.
        self._external_proxy = bool(external_proxy)
        self.workers: Dict[str, WorkerProc] = {}
        for i, spec in enumerate(specs):
            name = f"w{i}"
            stderr_path = (os.path.join(stderr_dir, f"{name}.stderr")
                           if stderr_dir else None)
            self.workers[name] = WorkerProc(
                name, spec, env=env, stderr_path=stderr_path,
                log=self._log)
        self._proxy_kwargs = dict(proxy_kwargs or {})
        self.proxy: Optional[EdgeProxy] = None
        self.exit_reports: Dict[str, Optional[dict]] = {}

    def start(self, ready_timeout_s: float = 180.0) -> "Fleet":
        t0 = time.monotonic()
        for w in self.workers.values():
            w.start()
        for w in self.workers.values():
            left = max(1.0, ready_timeout_s - (time.monotonic() - t0))
            try:
                w.wait_ready(timeout_s=left)
            except RuntimeError:
                self.stop(timeout_s=10.0)
                raise
        if not self._external_proxy:
            backends = [Backend(name, "127.0.0.1", w.port)
                        for name, w in self.workers.items()]
            self.proxy = EdgeProxy(backends, log=self._log,
                                   **self._proxy_kwargs).start()
        return self

    def add_worker(self, spec: WorkerSpec, *,
                   ready_timeout_s: float = 180.0,
                   stderr_dir: Optional[str] = None,
                   env: Optional[Dict[str, str]] = None) -> str:
        """Scale-up: boot one NEW worker and route to it only once it
        is genuinely warm (no cold stream start on a scale-up worker).

        The ordering is the contract: the worker boots, runs its full
        warmup — including, with ``spec.warm_streams``, the in-process
        stream-fit warm pass (cmd_serve's ``--warm-streams``: the
        fit-stage programs are NOT in the AOT lattice, so the worker
        exercises one synthetic stream before printing its ready line)
        — and ONLY THEN is handed to ``proxy.add_backend``, which
        replays every known specialize before traffic can land. A
        fresh worker's first real frame pays zero compiles.

        Returns the new worker's name (``w<N>``, continuing the boot
        numbering)."""
        if self.proxy is None:
            raise RuntimeError("fleet is not started")
        env = self._env if env is None else env
        stderr_dir = (self._stderr_dir if stderr_dir is None
                      else stderr_dir)
        i = len(self.workers)
        while f"w{i}" in self.workers:
            i += 1
        name = f"w{i}"
        stderr_path = (os.path.join(stderr_dir, f"{name}.stderr")
                       if stderr_dir else None)
        w = WorkerProc(name, spec, env=env, stderr_path=stderr_path,
                       log=self._log)
        self.workers[name] = w
        try:
            w.start().wait_ready(timeout_s=ready_timeout_s)
        except RuntimeError:
            del self.workers[name]
            raise
        self.proxy.add_backend(Backend(name, "127.0.0.1", w.port))
        self._log(f"fleet: added worker {name} on port {w.port}")
        return name

    def kill_worker(self, name: str) -> None:
        """Chaos: SIGKILL one worker. The proxy discovers the death
        through its breaker / mid-frame failover — nothing is told in
        advance, which is the point of the drill."""
        self.workers[name].kill()
        self.exit_reports[name] = None

    def drain_worker(self, name: str, *,
                     migrate_timeout_s: float = 10.0,
                     term_timeout_s: float = 30.0) -> dict:
        """Rolling deploy: migrate the worker's proxied streams to
        siblings (bounded), then SIGTERM it so its own drain closes
        any remaining local state and prints the exit line."""
        if self.proxy is None:
            raise RuntimeError("fleet is not started")
        report = self.proxy.drain_backend(
            name, timeout_s=migrate_timeout_s)
        self.exit_reports[name] = self.workers[name].terminate(
            timeout_s=term_timeout_s)
        return report

    def stop(self, timeout_s: float = 30.0) -> Dict[str, Optional[dict]]:
        if self.proxy is not None:
            try:
                self.proxy.drain(timeout_s=min(10.0, timeout_s))
            except Exception:  # noqa: BLE001 — teardown must finish
                pass
        for name, w in self.workers.items():
            if name not in self.exit_reports or (
                    self.exit_reports[name] is None and w.alive()):
                self.exit_reports[name] = w.terminate(
                    timeout_s=timeout_s)
        return dict(self.exit_reports)


class FleetSupervisor:
    """The self-healing daemon over one :class:`Fleet`.

    Detection is two-channel, both facts the worker contract already
    emits: (1) PROCESS DEATH — ``poll()`` says the worker is gone; the
    parsed exit line (present = it drained politely, absent = it was
    killed/crashed) classifies the death in the heal ledger. (2)
    UNRESPONSIVENESS — a live process whose ``/healthz`` stops
    answering (a partitioned/wedged worker): consecutive probe
    failures run through a per-worker ``runtime.health.CircuitBreaker``
    (``failure_threshold`` consecutive to trip, the same bounded +
    classified discipline as every other breaker in the package — never
    a bare retry loop), and a tripped breaker is a death; the remains
    get SIGKILL (the only signal a C-level wedge cannot dodge) before
    the replacement boots.

    The HEAL is the existing scale-up path with the port pinned: the
    replacement boots from the dead worker's own spec
    (``WorkerSpec.with_port`` — same AOT lattice dir, same
    ``--warm-streams``), runs its FULL warmup before printing ready
    (zero builds on its first real frame),
    and only then re-enters routing — ``proxy.add_backend`` for an
    in-process proxy (specialize replay included), or simply by
    BINDING THE SAME PORT when the proxy is a separate process
    (:class:`ProxyPair`), whose breaker re-probe rediscovers the
    backend with no wiring call. MTTR (detection -> routed) is
    recorded per heal.

    RESTART-STORM SUPPRESSION: restart attempts draw on a shared
    budget of ``restart_budget`` per sliding ``budget_window_s``. A
    death arriving with the budget exhausted — or a worker whose OWN
    failed heals exhausted it — DEGRADES: the worker is abandoned
    (fleet serves with fewer workers), an incident is recorded, and it
    is never retried. Flapping is structurally impossible: every boot
    attempt consumes budget whether or not it succeeds.

    HEALS RUN ON THEIR OWN THREADS, one per worker at a time, so the
    sweep keeps watching the rest of the fleet while a replacement
    boots (JAX's supervisor heals on its sweep thread; a ``serve``
    worker on an H100 takes 17-28 s to boot, long enough for a worker
    partitioned meanwhile to come back before three probes fail). A
    worker with a heal in flight is neither polled nor probed until
    that heal returns; a failed boot leaves the dead ``WorkerProc`` in
    place and the next sweep heals it again, as before.

    Locking: ``_lock`` guards the ledger/counters/budget ONLY; all
    blocking work (probes, kills, boots) runs outside it, on the
    supervisor or a heal thread; ``_wire_lock`` serializes the heals'
    proxy rewiring and nests nothing; and ``load()`` is a single-hold
    snapshot (the torn-telemetry rule). Stop the supervisor BEFORE a
    planned drain / ``fleet.stop()`` — a polite operator-initiated exit is
    indistinguishable from a death by design (the exit line says how,
    not why)."""

    def __init__(self, fleet: Fleet, *,
                 poll_interval_s: float = 0.05,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 failure_threshold: int = 3,
                 restart_budget: int = 3,
                 budget_window_s: float = 60.0,
                 ready_timeout_s: float = 180.0,
                 spec_factory: Optional[Callable[[str, WorkerSpec],
                                                 WorkerSpec]] = None,
                 log: Optional[Callable[[str], None]] = None):
        if restart_budget < 1:
            raise ValueError(
                f"restart_budget must be >= 1, got {restart_budget}")
        self._fleet = fleet
        self._poll_interval_s = float(poll_interval_s)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._failure_threshold = int(failure_threshold)
        self._restart_budget = int(restart_budget)
        self._budget_window_s = float(budget_window_s)
        self._ready_timeout_s = float(ready_timeout_s)
        # Test/drill hook: how to build the replacement spec from the
        # dead worker's (name, spec). Default = same spec, same port.
        self._spec_factory = spec_factory
        self._log = log or (lambda m: None)
        self._lock = threading.Lock()
        self._wire_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._heal_threads: Dict[str, threading.Thread] = {}
        self._breakers: Dict[str, object] = {}
        self._last_probe: Dict[str, float] = {}
        self._abandoned: set = set()
        self._restart_times: List[float] = []   # budget window, pruned
        # -- ledger (under _lock) --
        self.heals: List[dict] = []
        self.incidents: List[dict] = []
        self.restarts = 0            # successful replacement boots
        self.restarts_failed = 0     # boot attempts that did not ready
        self.deaths_detected = 0
        self.probe_failures = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._thread = threading.Thread(
            target=self._run, name="mano-fleet-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop sweeping; wait at most ``timeout_s`` in all for the
        sweep and any heal in flight."""
        self._stop.set()
        deadline = time.monotonic() + timeout_s
        t = self._thread
        if t is not None:
            t.join(timeout_s)
        for h in list(self._heal_threads.values()):
            h.join(max(0.0, deadline - time.monotonic()))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 — the daemon survives
                self._log(f"supervisor sweep failed "
                          f"({type(e).__name__}: {e})")
            self._stop.wait(self._poll_interval_s)

    # ------------------------------------------------------------ detection
    def _breaker(self, name: str):
        from mano_hand_tpu_torch.runtime.health import CircuitBreaker

        br = self._breakers.get(name)
        if br is None:
            br = CircuitBreaker(
                failure_threshold=self._failure_threshold,
                probe_interval_s=self._probe_interval_s,
                probe_backoff=2.0,
                probe_interval_cap_s=8.0 * self._probe_interval_s,
                respect_priority_claim=False,
                probe=lambda: False)   # the sweep IS the prober
            self._breakers[name] = br
        return br

    def _healthz_ok(self, w: WorkerProc) -> bool:
        from mano_hand_tpu_torch.edge.client import EdgeClient

        port = w.port
        if port is None:
            return False
        try:
            h = EdgeClient("127.0.0.1", port,
                           timeout_s=self._probe_timeout_s).healthz()
            return bool(h.get("ok", False))
        except Exception:  # noqa: BLE001 — any failure is a failed probe
            return False

    def _sweep(self) -> None:
        now = time.monotonic()
        for name in list(self._fleet.workers):
            if self._stop.is_set():
                return
            with self._lock:
                if name in self._abandoned:
                    continue
            h = self._heal_threads.get(name)
            if h is not None and h.is_alive():
                continue
            # Read the worker only after its heal is seen to have ended:
            # a heal registers its replacement before it returns.
            w = self._fleet.workers.get(name)
            if w is None:
                continue
            if not w.alive():
                self._start_heal(name, w,
                                 reason=("clean_exit"
                                         if w.exit_report is not None
                                         else "exit"))
                continue
            if now - self._last_probe.get(name, 0.0) \
                    < self._probe_interval_s:
                continue
            self._last_probe[name] = now
            br = self._breaker(name)
            if self._healthz_ok(w):
                br.record_success()
                continue
            with self._lock:
                self.probe_failures += 1
            from mano_hand_tpu_torch.runtime import health as health_mod

            if br.record_failure() == health_mod.DOWN:
                # Consecutive-failure threshold crossed: the worker is
                # partitioned/wedged. SIGKILL the remains first — a
                # half-dead process must not hold the port the
                # replacement needs.
                self._start_heal(name, w, reason="probe")

    # ----------------------------------------------------------------- heal
    def _budget_left(self, now: float) -> int:
        """Caller holds ``_lock``. Prunes the sliding window."""
        cutoff = now - self._budget_window_s
        self._restart_times = [t for t in self._restart_times
                               if t > cutoff]
        return self._restart_budget - len(self._restart_times)

    def _start_heal(self, name: str, dead: WorkerProc,
                    reason: str) -> None:
        """Heal ``name`` on a thread of its own (sweep thread only)."""
        def run():
            try:
                self._heal(name, dead, reason)
            except Exception as e:  # noqa: BLE001 — the daemon survives
                self._log(f"supervisor heal of {name} failed "
                          f"({type(e).__name__}: {e})")

        h = threading.Thread(target=run, name=f"mano-fleet-heal-{name}",
                             daemon=True)
        self._heal_threads[name] = h
        h.start()

    def _heal(self, name: str, dead: WorkerProc, reason: str) -> None:
        fleet = self._fleet
        t0 = time.monotonic()
        with self._lock:
            self.deaths_detected += 1
            if self._budget_left(t0) <= 0:
                self._abandoned.add(name)
                inc = {"worker": name, "reason": reason,
                       "incident": "restart budget exhausted "
                                   f"({self._restart_budget} per "
                                   f"{self._budget_window_s}s window); "
                                   "degraded to fewer workers",
                       "t_mono": round(t0, 3)}
                self.incidents.append(inc)
            else:
                self._restart_times.append(t0)
                inc = None
        self._log(f"supervisor: worker {name} dead ({reason})"
                  + ("; budget exhausted — degrading" if inc else
                     "; healing"))
        port = dead.port
        # SIGKILL the remains in every path (idempotent on a reaped
        # process): a partitioned worker still holds its socket.
        dead.kill()
        if fleet.proxy is not None:
            with self._wire_lock:
                try:
                    fleet.proxy.remove_backend(name)
                except KeyError:
                    pass     # a previous heal round already removed it
        if inc is not None:
            self._log(f"supervisor: incident — {inc['incident']}")
            return
        spec = dead.spec
        if self._spec_factory is not None:
            spec = self._spec_factory(name, spec)
        elif port is not None:
            spec = spec.with_port(port)
        stderr_path = None
        if fleet._stderr_dir:
            stderr_path = os.path.join(
                fleet._stderr_dir, f"{name}.heal.stderr")
        repl = WorkerProc(name, spec, env=fleet._env,
                          stderr_path=stderr_path, log=self._log)
        try:
            repl.start().wait_ready(timeout_s=self._ready_timeout_s)
        except RuntimeError as e:
            with self._lock:
                self.restarts_failed += 1
            self._log(f"supervisor: replacement {name} failed to boot "
                      f"({e}); budget permitting, the next sweep "
                      "retries")
            # Leave the dead WorkerProc in place: the next sweep sees
            # it dead and re-enters _heal — bounded by the budget.
            return
        fleet.workers[name] = repl
        self._breakers.pop(name, None)       # fresh breaker, fresh state
        if fleet.proxy is not None:
            with self._wire_lock:
                fleet.proxy.add_backend(
                    Backend(name, "127.0.0.1", repl.port))
        # else: ProxyPair mode — the replacement bound the dead
        # worker's port, and the proxy's backend breaker re-probe
        # re-admits it with no wiring call.
        mttr_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self.restarts += 1
            self.heals.append({
                "worker": name, "reason": reason,
                "port": repl.port, "pid": repl.pid,
                "mttr_ms": round(mttr_ms, 1),
            })
        self._log(f"supervisor: healed {name} on port {repl.port} in "
                  f"{mttr_ms:.0f} ms ({reason})")

    # ------------------------------------------------------------ telemetry
    def load(self) -> dict:
        """``{"fleet": {...}}`` — every ledger field from ONE ``_lock``
        hold, so the counts always equal the lists beside them (the
        torn-read hammer in tests/test_selfheal.py spins on exactly
        these invariants)."""
        now = time.monotonic()
        with self._lock:
            return {"fleet": {
                "restarts": self.restarts,
                "restarts_failed": self.restarts_failed,
                "deaths_detected": self.deaths_detected,
                "probe_failures": self.probe_failures,
                "incidents": len(self.incidents),
                "incident_log": [dict(i) for i in self.incidents],
                "heals": [dict(h) for h in self.heals],
                "mttr_ms": [h["mttr_ms"] for h in self.heals],
                "abandoned": sorted(self._abandoned),
                "budget": {
                    "restart_budget": self._restart_budget,
                    "window_s": self._budget_window_s,
                    "left": max(0, self._budget_left(now)),
                },
            }}


# --------------------------------------------------------------------------
# Active/standby proxy pair: the EdgeProxy's own availability.
# --------------------------------------------------------------------------

class ProxySpec:
    """The knobs one ``proxy`` process boots with. ``backends`` is a
    sequence of ``(name, host, port)`` — with fixed worker ports the
    list is STATIC across worker heals, which is what lets a standby
    hold the same list the active used."""

    def __init__(self, *, port: int, lock_path: str,
                 backends: Sequence, drain_timeout_s: float = 10.0,
                 upstream_timeout_s: float = 300.0,
                 extra: Sequence[str] = ()):
        self.port = int(port)
        self.lock_path = str(lock_path)
        self.backends = [(str(n), str(h), int(p))
                         for (n, h, p) in backends]
        self.drain_timeout_s = float(drain_timeout_s)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.extra = tuple(extra)

    def argv(self) -> List[str]:
        cmd = [sys.executable, "-m", "mano_hand_tpu_torch.cli", "proxy",
               "--port", str(self.port),
               "--lock", self.lock_path,
               "--drain-timeout-s", repr(self.drain_timeout_s),
               "--upstream-timeout-s", repr(self.upstream_timeout_s)]
        for n, h, p in self.backends:
            cmd += ["--backend", f"{n}={h}:{p}"]
        cmd += list(self.extra)
        return cmd


class ProxyProc:
    """One supervised ``proxy`` process (cmd_proxy's stdout
    contract): a ``{"proxy": {...}}`` ready line at spawn (role
    ``standby``), a ``{"proxy_event": {"event": "active", ...}}`` line
    when the flock is won and the service port is bound, and a
    ``{"proxy_exit": {...}}`` line after a polite drain. Same
    SIGKILL-backstop discipline as :class:`WorkerProc`."""

    def __init__(self, name: str, spec: ProxySpec, *,
                 env: Optional[Dict[str, str]] = None,
                 stderr_path: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.name = name
        self.spec = spec
        self._env = env
        self._stderr_path = stderr_path
        self._log = log or (lambda m: None)
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._stderr_f = None
        self._ready = threading.Event()
        self._active = threading.Event()
        self.ready_info: Optional[dict] = None
        self.active_info: Optional[dict] = None
        self.exit_report: Optional[dict] = None
        self.events: List[dict] = []
        self.stdout_lines: List[str] = []
        self.returncode: Optional[int] = None

    def start(self) -> "ProxyProc":
        if self._proc is not None:
            return self
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        if self._stderr_path:
            self._stderr_f = open(self._stderr_path, "ab")
            stderr = self._stderr_f
        else:
            stderr = subprocess.DEVNULL
        self._proc = subprocess.Popen(
            self.spec.argv(), stdout=subprocess.PIPE, stderr=stderr,
            env=env, start_new_session=True)
        self._reader = threading.Thread(
            target=self._drain_stdout, name=f"stdout-{self.name}",
            daemon=True)
        self._reader.start()
        return self

    def _drain_stdout(self) -> None:
        proc = self._proc
        try:
            for raw in proc.stdout:
                line = raw.decode("utf-8", "replace").rstrip("\n")
                self.stdout_lines.append(line)
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if "proxy" in d:
                    self.ready_info = d["proxy"]
                    self._ready.set()
                elif "proxy_event" in d:
                    ev = d["proxy_event"]
                    self.events.append(ev)
                    if ev.get("event") == "active":
                        self.active_info = ev
                        self._active.set()
                elif "proxy_exit" in d:
                    self.exit_report = d["proxy_exit"]
        except (OSError, ValueError):
            pass
        finally:
            self._ready.set()
            self._active.set()      # never strand a takeover waiter

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def is_active(self) -> bool:
        return self.alive() and self.active_info is not None

    def wait_ready(self, timeout_s: float = 60.0) -> "ProxyProc":
        if not self._ready.wait(timeout=timeout_s) \
                or self.ready_info is None:
            rc = self._proc.poll() if self._proc else None
            self.kill()
            raise RuntimeError(
                f"proxy {self.name} not ready within {timeout_s}s "
                f"(rc={rc}); stdout: {self.stdout_lines[-3:]}")
        return self

    def wait_active(self, timeout_s: float = 60.0) -> "ProxyProc":
        """Block until THIS proc won the flock and bound the service
        port (its ``active`` event) — or died trying."""
        if not self._active.wait(timeout=timeout_s) \
                or self.active_info is None or not self.alive():
            raise RuntimeError(
                f"proxy {self.name} did not become active within "
                f"{timeout_s}s (alive={self.alive()}); stdout: "
                f"{self.stdout_lines[-3:]}")
        return self

    def kill(self) -> None:
        if self._proc is None:
            return
        try:
            self._proc.kill()
        except OSError:
            pass
        self._finish(join_timeout_s=10.0)

    def terminate(self, timeout_s: float = 30.0) -> Optional[dict]:
        if self._proc is None:
            return None
        if self._proc.poll() is None:
            try:
                self._proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        try:
            self._proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self._log(f"proxy {self.name}: SIGTERM deadline hit — "
                      "SIGKILL backstop")
            try:
                self._proc.kill()
            except OSError:
                pass
        self._finish(join_timeout_s=max(1.0,
                                        deadline - time.monotonic()))
        return self.exit_report

    def _finish(self, join_timeout_s: float) -> None:
        try:
            self._proc.wait(timeout=join_timeout_s)
        except subprocess.TimeoutExpired:
            pass
        self.returncode = self._proc.poll()
        if self._reader is not None:
            self._reader.join(timeout=join_timeout_s)
        if self._stderr_f is not None:
            try:
                self._stderr_f.close()
            except OSError:
                pass
            self._stderr_f = None


class ProxyPair:
    """Active/standby ``proxy`` pair behind one flock-arbitered
    service port (the ``DeviceLock`` pattern at socket level).

    Both procs boot from ONE :class:`ProxySpec` (same port, same lock
    file, same static backend list). Whoever wins ``flock(LOCK_EX)``
    binds the service port and serves; the loser parks in cmd_proxy's
    bounded-step SIGTERM-interruptible ``LOCK_NB`` poll (a C-level
    ``LOCK_EX`` wait would make the standby unkillable politely).
    When the active dies — SIGKILL included — the kernel RELEASES the
    flock with the process, the standby acquires it, increments the
    takeover generation in the lock file, binds the SAME port, and
    rebuilds routing from the workers' ``/healthz`` (cmd_proxy's
    resync). In-flight streams are NOT carried over: clients hold the
    last-confirmed-pose protocol (``edge/client.py:
    ResilientStream``), reconnect to the same address, and resume via
    ``resume_pose`` with continuous frame numbering — the takeover
    loses no stream."""

    def __init__(self, spec: ProxySpec, *,
                 env: Optional[Dict[str, str]] = None,
                 stderr_dir: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.spec = spec
        self._log = log or (lambda m: None)
        self.procs: List[ProxyProc] = []
        for i in range(2):
            name = f"p{i}"
            stderr_path = (os.path.join(stderr_dir, f"{name}.stderr")
                           if stderr_dir else None)
            self.procs.append(ProxyProc(
                name, spec, env=env, stderr_path=stderr_path,
                log=self._log))
        self.exit_reports: Dict[str, Optional[dict]] = {}

    @property
    def port(self) -> int:
        """The stable service port (survives takeover)."""
        return self.spec.port

    def start(self, timeout_s: float = 60.0) -> "ProxyPair":
        t0 = time.monotonic()
        for p in self.procs:
            p.start()
        for p in self.procs:
            left = max(1.0, timeout_s - (time.monotonic() - t0))
            p.wait_ready(timeout_s=left)
        # Exactly one wins the flock; wait until it is serving.
        self.wait_active(timeout_s=max(
            1.0, timeout_s - (time.monotonic() - t0)))
        return self

    def active(self) -> Optional[ProxyProc]:
        """The proc currently holding the flock (None mid-takeover).
        The LAST active event wins: a standby that took over has a
        newer event than the corpse it replaced."""
        live = [p for p in self.procs if p.is_active()]
        if not live:
            return None
        return max(live, key=lambda p: p.active_info.get("takeovers", 0))

    def wait_active(self, timeout_s: float = 60.0) -> ProxyProc:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            p = self.active()
            if p is not None:
                return p
            time.sleep(0.02)
        raise RuntimeError(
            f"no active proxy within {timeout_s}s "
            f"(alive={[p.alive() for p in self.procs]})")

    def kill_active(self) -> str:
        """Chaos: SIGKILL the active proxy; returns its name. The
        standby discovers the death through the kernel's flock
        release — nothing is told in advance."""
        p = self.wait_active(timeout_s=10.0)
        p.kill()
        self.exit_reports[p.name] = None
        return p.name

    def stop(self, timeout_s: float = 30.0) -> Dict[str, Optional[dict]]:
        """Polite teardown of both procs: the active drains and prints
        its exit line; the standby's ``LOCK_NB`` poll exits on SIGTERM
        (both bounded, SIGKILL backstop)."""
        for p in self.procs:
            if p.name not in self.exit_reports or (
                    self.exit_reports[p.name] is None and p.alive()):
                self.exit_reports[p.name] = p.terminate(
                    timeout_s=timeout_s)
        return dict(self.exit_reports)
