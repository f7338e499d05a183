"""Fleet front tier: a health-aware socket proxy over N edge workers.

A port of the JAX package's ``edge/proxy.py`` (it holds no JAX: the
port's copy differs in its imports, its drain and its re-probe tick).
One ``serve`` worker is reachable over the wire through
``edge/server.py``; this module makes a FLEET of them
killable, drainable, and redeployable without dropping a user. It is a
process-level layer over machinery that already exists — every
decision maps down:

* **Routing** is health-aware least-loaded: each backend owns a
  ``runtime/health.py`` CircuitBreaker whose probe is a BOUNDED
  ``/healthz`` GET (socket liveness, not card liveness — the breaker's
  priority-claim stand-down is therefore off: probing a loopback
  socket never contends for the device). A DOWN backend is routed
  around; its re-probe runs on a disposable thread kicked from the
  routing path via ``probe_due()`` — the serving/lanes.py pattern, so
  the accept loop never pays a probe.
* **Idempotent re-route**: a backend that fails AT CONNECT never saw
  the request — the proxy silently retries a sibling (mirrors
  EdgeClient's attempt-0 rule). Any failure AFTER the request hit the
  wire is terminal 502 ``upstream``: the worker may have admitted the
  work, and a blind resend would double-submit (protocol.py).
* **Backpressure passthrough**: a worker's 429 travels to the client
  verbatim, ``Retry-After`` included — the engine's admission decision
  stays the engine's.
* **Specialize broadcast**: subject keys are content-addressed
  (sha256 of the betas bytes — serving/engine.py), so the SAME betas
  yield the SAME key on every worker. ``/v1/specialize`` fans out to
  all routable backends and the key is valid fleet-wide; the payload
  is remembered and replayed to late-joining backends
  (``add_backend`` — the rolling-deploy path).
* **Stream MIGRATION**: the proxy terminates the ``mano-stream/1``
  upgrade itself and relays NDJSON ops to a backend session,
  remembering the original open msg and the last CONFIRMED pose off
  each frame reply (already wire-encoded — zero re-encode). When the
  backend dies mid-frame or is drained, the relay re-opens on a sibling
  with ``resume_pose=<last confirmed pose>`` — the warm-start handoff —
  and re-sends the in-flight frame. Deterministic pure fits make the
  continuation BIT-equal to an uninterrupted session (the fleet drill
  holds it). Re-sending is safe exactly here: the old reply never
  reached the client (one reply line per op, strictly ordered), and the
  resumed fit re-derives it from the same confirmed state.
  Client-visible frame numbers stay continuous: the sibling's session
  restarts its 0-based counter, and the relay adds the confirmed-frame
  offset to every relayed reply.
* **Span accounting across processes**: a drain migration closes the
  old worker's session with a polite ``{"op": "close"}`` (its span
  closes ``closed``, exactly once, in THAT worker's tracer) before the
  sibling opens a fresh span — no span is ever double-closed or
  leaked by the handoff. A SIGKILLed worker takes its tracer with it;
  its spans are excluded from fleet accounting by construction (the
  drill documents this).
* **Drain**: the listener closes, in-flight one-shots get the window,
  every connection task is swept, and only then is ``wait_closed()``
  awaited, bounded by 1 s — since Python 3.12 it waits for every open
  connection, so awaiting it first would hold the drain on an idle
  client for its whole window (``edge/server.py`` drains the same way).
* **Re-admission without traffic**: every ``REPROBE_TICK_S`` the loop
  kicks the due re-probe of each DOWN backend, as a pick does (JAX's
  proxy re-probes only from a pick). A worker healed in place binds
  its old port while the streams it lost live on a sibling; with no
  pick in between, the first request after that sibling dies would
  otherwise find every backend DOWN and get a 503.

The proxy holds NO device and NO engine — it is pure socket work on
one asyncio loop in a daemon thread (the EdgeServer lifecycle shape),
and runs without touching the card.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Callable, Dict, Optional

from mano_hand_tpu_torch.edge import protocol as proto
from mano_hand_tpu_torch.edge.server import (
    _LINE_LIMIT, MAX_BODY_BYTES, _Pushback, _Request, read_request,
    write_response)
from mano_hand_tpu_torch.runtime.health import DOWN, HEALTHY, CircuitBreaker

# How often the loop looks for due re-probes; each breaker's own
# backoff (0.25 s doubling to 8 s) still spaces its probes.
REPROBE_TICK_S = 0.25


class BackendConnectError(Exception):
    """Connect (or upgrade) to a backend failed with NOTHING
    dispatched — re-routing to a sibling is idempotent."""


class BackendMidstreamError(Exception):
    """The backend failed AFTER a request hit its wire — never
    re-sent; maps to 502 ``upstream``."""


class _OpenRefused(Exception):
    """The backend answered a stream open with an error LINE (shed,
    bad request): a protocol-level refusal, not a dead socket."""

    def __init__(self, reply: dict):
        self.reply = reply
        super().__init__(str(reply.get("error")))


class Backend:
    """One ``mano serve`` worker as the proxy sees it: address +
    breaker + live-load bookkeeping (loop-thread-owned counters)."""

    def __init__(self, name: str, host: str, port: int, *,
                 probe_timeout_s: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None):
        self.name = name
        self.host = host
        self.port = int(port)
        self.probe_timeout_s = float(probe_timeout_s)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=3,
            probe=self._healthz_probe,
            probe_interval_s=0.25,
            probe_backoff=2.0,
            probe_interval_cap_s=8.0,
            # A loopback socket probe never contends for the card: an
            # exclusive benchmark's priority claim is about DEVICE
            # traffic.
            respect_priority_claim=False)
        self.draining = False
        self.outstanding = 0            # one-shot requests in flight
        self.streams: set = set()       # live _StreamRelay objects
        # The worker's own /healthz ``warm_streams`` fact. Tri-state:
        # None = unknown (a worker that never said, or no probe yet)
        # stays ELIGIBLE for stream opens;
        # False = the worker said it booted cold, so NEW streams prefer
        # a warm sibling (the cold-stream-start guard).
        self.stream_warm: Optional[bool] = None
        # Proxy-assigned registration stamp: 0 for the boot-time fleet,
        # monotone-increasing for scale-up joins (``add_backend``).
        # Only consulted as a stream-open tie-break, so the boot-time
        # fleet's routing order is byte-identical to before.
        self.boot_seq = 0

    def _healthz_probe(self) -> bool:
        """Bounded liveness GET (runs on a disposable thread, never the
        loop): any parsed /healthz answer means the process is back."""
        from mano_hand_tpu_torch.edge.client import EdgeClient, EdgeError

        try:
            with EdgeClient(self.host, self.port,
                            timeout_s=self.probe_timeout_s) as cli:
                h = cli.healthz()
            if "warm_streams" in h:
                self.stream_warm = bool(h["warm_streams"])
            return h.get("status") == "serving"
        except (EdgeError, OSError, ValueError):
            return False

    def routable(self) -> bool:
        return not self.draining and self.breaker.state != DOWN

    def load(self) -> int:
        return self.outstanding + len(self.streams)


class EdgeProxy:
    """Socket-level load balancer + stream migrator over N workers.

    Same lifecycle contract as ``EdgeServer``: event loop in a daemon
    thread (``start()``), ``drain()`` callable from any thread,
    ``port=0`` binds ephemeral. ``drain_backend(name)`` is the rolling
    -deploy primitive: stop routing to one worker and hand its live
    streams to siblings mid-stream, bounded by a budget.
    """

    def __init__(self, backends, host: str = "127.0.0.1", port: int = 0,
                 *, drain_timeout_s: float = 10.0,
                 connect_timeout_s: float = 5.0,
                 probe_timeout_s: float = 2.0,
                 upstream_timeout_s: float = 300.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 role: str = "active",
                 takeovers: int = 0,
                 retry_after_source: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None):
        self._backends: Dict[str, Backend] = {}
        self._boot_seq = 0              # bumped by add_backend only
        for i, be in enumerate(backends):
            if not isinstance(be, Backend):
                host_i, port_i = be
                be = Backend(f"w{i}", host_i, port_i,
                             probe_timeout_s=probe_timeout_s)
            self._backends[be.name] = be
        # Active/standby: ``role`` is what this process IS
        # right now ("active" serves; "standby" is parked on the flock
        # in cli.cmd_proxy and never reaches start()). ``takeovers`` is
        # the lock file's takeover generation at activation — 0 for a
        # first-boot active, N for the Nth flock winner.
        self.role = str(role)
        self.takeovers = int(takeovers)
        self.host = host
        self.port = int(port)
        self.drain_timeout_s = float(drain_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        # An optional ``(tier, load) -> Optional[int]`` for PROXY-
        # originated 503s (no routable backend, draining). A worker's 429
        # keeps relaying the worker's own Retry-After verbatim — the
        # worker's controller owns that value; this source covers only
        # the responses the proxy itself makes (load is None there: the
        # proxy has no engine). None -> no header.
        self._retry_after_source = retry_after_source
        self._log = log or (lambda m: None)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._conn_tasks: set = set()
        self._active_requests = 0
        self._draining = False
        self._drained = False
        self._t0 = time.monotonic()
        # Replay registry: specialize bodies by subject key, so a
        # late-joining backend (rolling deploy) learns every subject.
        self._specialized: Dict[str, bytes] = {}
        # Counters (loop-thread-owned; exported via /metrics).
        self.requests_proxied = 0
        self.reroutes = 0               # idempotent connect-fail retries
        self.upstream_failures = 0      # 502s — failed after dispatch
        self.streams_opened = 0
        self.frames_relayed = 0
        self.migrations = 0             # sessions handed to a sibling
        self.migrated_frames = 0        # in-flight frames re-sent

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EdgeProxy":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="mano-proxy", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError("proxy failed to bind within 30s")
        if self._boot_error is not None:
            raise RuntimeError(
                f"proxy failed to start: {self._boot_error}")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            loop.run_until_complete(self._serve_main())
        except BaseException as e:  # noqa: BLE001 — surface via start()
            self._boot_error = e
            self._ready.set()
        finally:
            try:
                loop.close()
            except Exception:  # noqa: BLE001
                pass

    async def _serve_main(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=_LINE_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        self._stop_event = asyncio.Event()
        reprobe = asyncio.ensure_future(self._reprobe_loop())
        self._ready.set()
        self._log(f"proxy listening on {self.host}:{self.port} over "
                  f"{len(self._backends)} backends")
        try:
            await self._stop_event.wait()
        finally:
            reprobe.cancel()

    async def _reprobe_loop(self) -> None:
        while not self._draining:
            self._kick_due_probes()
            await asyncio.sleep(REPROBE_TICK_S)

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Stop the PROXY itself (refuse new connections, resolve
        in-flight one-shots, cancel relays — each relay's cleanup
        closes its backend socket, which is the worker's documented
        disconnect path). Idempotent, callable from any thread."""
        if timeout_s is None:
            timeout_s = self.drain_timeout_s
        if self._loop is None or self._drained:
            return {"drained": self._drained, "already": True}
        t0 = time.monotonic()
        fut = asyncio.run_coroutine_threadsafe(
            self._drain_async(float(timeout_s)), self._loop)
        try:
            report = fut.result(timeout=timeout_s + 30.0)
        except Exception as e:  # noqa: BLE001 — report, never hang
            report = {"drained": False,
                      "error": f"{type(e).__name__}: {e}"}
        self._drained = True
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        report["wall_s"] = round(time.monotonic() - t0, 4)
        return report

    async def _drain_async(self, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        self._draining = True
        srv = self._server
        if srv is not None:
            # New connections refused NOW. Not ``wait_closed()`` here:
            # since Python 3.12 it also waits for every open connection
            # to drop, and an idle client would hold the drain for its
            # whole window (edge/server.py drains the same way).
            srv.close()
        while self._active_requests > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        inflight_resolved = self._active_requests == 0
        for t in list(self._conn_tasks):
            if not t.done():
                t.cancel()
        if self._conn_tasks:
            await asyncio.wait(list(self._conn_tasks), timeout=1.0)
        if srv is not None:
            try:
                await asyncio.wait_for(srv.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass                    # a transport slow to detach
        self._stop_event.set()
        return {
            "drained": True,
            "inflight_resolved": inflight_resolved,
            "requests_proxied": self.requests_proxied,
            "within_timeout": time.monotonic() <= deadline,
        }

    # ------------------------------------------------------- fleet control
    def backends(self) -> Dict[str, Backend]:
        return dict(self._backends)

    def add_backend(self, be: Backend,
                    replay_timeout_s: float = 10.0) -> None:
        """Register a new worker (rolling deploy's scale-up half) and
        replay every known specialize so subject-keyed traffic can
        land on it immediately. Callable from any thread; the replay
        is bounded and best-effort (a failure only degrades the
        breaker — subject traffic re-routes around it)."""
        from mano_hand_tpu_torch.edge.client import EdgeClient, EdgeError

        self._boot_seq += 1
        be.boot_seq = self._boot_seq
        # Cold-stream-start guard: learn the worker's
        # ``warm_streams`` fact BEFORE it becomes routable, so a cold
        # scale-up worker cannot win a stream open purely by being the
        # idlest process in the fleet. Best-effort and bounded: an
        # unreadable fact leaves the tri-state at None (eligible).
        try:
            with EdgeClient(be.host, be.port,
                            timeout_s=be.probe_timeout_s) as cli:
                h = cli.healthz()
            if "warm_streams" in h:
                be.stream_warm = bool(h["warm_streams"])
        except (EdgeError, OSError, ValueError):
            pass
        self._backends[be.name] = be
        deadline = time.monotonic() + float(replay_timeout_s)
        for body in list(self._specialized.values()):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                with EdgeClient(be.host, be.port,
                                timeout_s=min(left, 10.0)) as cli:
                    cli._checked("POST", "/v1/specialize",
                                 json.loads(body))
            except (EdgeError, OSError, ValueError):
                be.breaker.record_failure()
                break

    def remove_backend(self, name: str) -> None:
        self._backends.pop(name, None)

    def resync_backends(self, timeout_s: float = 10.0) -> dict:
        """Rebuild per-backend routing state from the workers' own
        ``/healthz`` — the standby-takeover path: a freshly
        active proxy must not inherit an empty breaker ledger that
        routes the first post-takeover frames at a corpse. Bounded
        CONCURRENT sweep on disposable threads (no event loop needed —
        callable BEFORE ``start()``, which is exactly when cmd_proxy
        runs it). A live worker is recorded healthy (plus its
        ``warm_streams`` fact); a dead one is driven to DOWN through
        the breaker's own public failure path, so the breaker's
        re-probe ladder owns its recovery exactly as if the failures
        had been observed in traffic. Returns ``{name: ok}``."""
        results: Dict[str, bool] = {}

        def sweep(be: Backend) -> None:
            from mano_hand_tpu_torch.edge.client import EdgeClient, EdgeError

            try:
                with EdgeClient(be.host, be.port,
                                timeout_s=min(float(timeout_s),
                                              be.probe_timeout_s)) as c:
                    h = c.healthz()
                ok = h.get("status") == "serving"
            except (EdgeError, OSError, ValueError):
                ok, h = False, {}
            if ok:
                if "warm_streams" in h:
                    be.stream_warm = bool(h["warm_streams"])
                be.breaker.record_success()
            else:
                # Classified and bounded: feed consecutive failures
                # until the threshold trips — never a raw state poke,
                # so the transition callback/ledger stay truthful.
                for _ in range(64):
                    if be.breaker.record_failure() == DOWN:
                        break
            results[be.name] = ok

        threads = [threading.Thread(target=sweep, args=(be,),
                                    name=f"resync-{be.name}",
                                    daemon=True)
                   for be in list(self._backends.values())]
        for t in threads:
            t.start()
        deadline = time.monotonic() + float(timeout_s)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return results

    def drain_backend(self, name: str,
                      timeout_s: float = 10.0) -> dict:
        """The rolling-deploy primitive: stop routing to ``name`` and
        migrate its live streams to siblings (each relay hands its
        session over with a polite close + ``resume_pose`` re-open —
        no frame is dropped). Blocks (bounded) until the worker holds
        no proxied work; the WORKER process is then safe to SIGTERM.
        Callable from any thread."""
        if self._loop is None:
            raise RuntimeError("proxy is not running")
        fut = asyncio.run_coroutine_threadsafe(
            self._drain_backend_async(name, float(timeout_s)),
            self._loop)
        return fut.result(timeout=timeout_s + 30.0)

    async def _drain_backend_async(self, name: str,
                                   timeout_s: float) -> dict:
        be = self._backends.get(name)
        if be is None:
            return {"backend": name, "error": "unknown backend"}
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        be.draining = True              # routing stops NOW
        migrating = len(be.streams)
        for relay in list(be.streams):
            relay.migrate_evt.set()     # proactive: idle relays move too
        while ((be.streams or be.outstanding)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.005)
        return {
            "backend": name,
            "streams_migrated": migrating,
            "clean": not be.streams and be.outstanding == 0,
            "residual_streams": len(be.streams),
            "residual_outstanding": be.outstanding,
            "wall_s": round(time.monotonic() - t0, 4),
        }

    # -------------------------------------------------------------- routing
    def _kick_due_probes(self) -> None:
        """Start each DOWN backend's due re-probe on a disposable
        thread (the breaker lets one run at a time)."""
        for be in list(self._backends.values()):
            if be.breaker.probe_due():
                threading.Thread(target=be.breaker.allow_primary,
                                 name=f"probe-{be.name}",
                                 daemon=True).start()

    def _pick(self, exclude=()) -> Optional[Backend]:
        """Healthy-first, least-loaded, name as the deterministic
        tie-break; kicks due re-probes onto disposable threads."""
        self._kick_due_probes()
        cands = []
        for be in self._backends.values():
            if be.routable() and be.name not in exclude:
                cands.append(be)
        if not cands:
            return None
        cands.sort(key=lambda b: (
            0 if b.breaker.state == HEALTHY else 1, b.load(), b.name))
        return cands[0]

    def _pick_stream(self, exclude=()) -> Optional[Backend]:
        """Stream-open placement: like ``_pick`` but a worker that
        told us it booted COLD (``stream_warm is False``) must not win a
        new open while a warm (or unknown) sibling is routable, or the
        client's first frames pay that worker's first-use cost. Unknown
        (None) stays eligible. Among survivors the sort adds
        ``-boot_seq`` before the name tie-break: the boot-time fleet all
        carries seq 0 (order unchanged), and a WARM scale-up join is
        preferred at equal load — new capacity takes new sessions. Falls
        back to the plain pick when only cold workers remain:
        availability beats warmth."""
        self._kick_due_probes()
        cands = []
        for be in self._backends.values():
            if (be.routable() and be.name not in exclude
                    and be.stream_warm is not False):
                cands.append(be)
        if not cands:
            return self._pick(exclude)
        cands.sort(key=lambda b: (
            0 if b.breaker.state == HEALTHY else 1, b.load(),
            -b.boot_seq, b.name))
        return cands[0]

    async def _connect(self, be: Backend):
        try:
            return await asyncio.wait_for(
                asyncio.open_connection(be.host, be.port,
                                        limit=_LINE_LIMIT),
                self.connect_timeout_s)
        except (OSError, asyncio.TimeoutError) as e:
            raise BackendConnectError(
                f"{be.name} unreachable: {type(e).__name__}: {e}") from e

    # ----------------------------------------------------------- connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        rd = _Pushback(reader)
        try:
            while True:
                req = await read_request(
                    rd, writer, max_body_bytes=self.max_body_bytes,
                    draining=self._draining)
                if req is None:
                    break
                self._active_requests += 1
                try:
                    keep = await self._dispatch(req, rd, writer)
                finally:
                    self._active_requests -= 1
                    self.requests_proxied += 1
                if not keep or self._draining:
                    break
        except (asyncio.CancelledError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        except Exception as e:  # noqa: BLE001 — one bad conn != the proxy
            self._log(f"proxy connection error: {type(e).__name__}: {e}")
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    def _unavailable_headers(self, req: _Request) -> Optional[dict]:
        """Retry-After for a PROXY-originated 503, from the attached
        source. The request's priority header is the tier; the proxy has
        no engine, so load is None. A source that raises or has no
        opinion -> no header."""
        if self._retry_after_source is None:
            return None
        try:
            tier = int(req.headers.get(proto.PRIORITY_HEADER, 0))
        except (TypeError, ValueError):
            tier = 0
        try:
            retry_s = self._retry_after_source(tier, None)
        except Exception:  # noqa: BLE001 — advisory header only
            return None
        return None if retry_s is None else {
            "Retry-After": int(retry_s)}

    async def _dispatch(self, req: _Request, rd: _Pushback,
                        writer) -> bool:
        if self._draining:
            await write_response(writer, 503, proto.error_body(
                "shutdown", "proxy is draining; connection closing"),
                extra_headers=self._unavailable_headers(req),
                close=True)
            return False
        route = (req.method, req.path.split("?", 1)[0])
        try:
            if route == ("GET", "/healthz"):
                return await self._h_healthz(writer)
            if route == ("GET", "/metrics"):
                return await self._h_metrics(writer)
            if route == ("POST", "/v1/specialize"):
                return await self._h_specialize(req, writer)
            if route[1] == "/v1/stream":
                if (req.headers.get("upgrade") or "").lower() \
                        != proto.STREAM_UPGRADE:
                    await write_response(
                        writer, 400, proto.error_body(
                            "bad_request",
                            f"/v1/stream requires 'Upgrade: "
                            f"{proto.STREAM_UPGRADE}'"))
                    return True
                relay = _StreamRelay(self, rd, writer)
                return await relay.run()
            if route == ("POST", "/v1/forward"):
                return await self._h_relay(req, writer)
            await write_response(writer, 404, proto.error_body(
                "bad_request",
                f"no proxy route for {req.method} {req.path}"))
            return True
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — 500, not a crash
            await write_response(writer, 500, proto.error_body(
                "error", f"proxy: {type(e).__name__}: {e}",
                phase="proxy"))
            return True

    # ----------------------------------------------------- one-shot relays
    def _request_bytes(self, req: _Request, be: Backend) -> bytes:
        head = [f"{req.method} {req.path} HTTP/1.1",
                f"Host: {be.host}:{be.port}",
                "Connection: close",
                f"Content-Length: {len(req.body)}"]
        for h in ("content-type", proto.PRIORITY_HEADER,
                  proto.DEADLINE_HEADER):
            v = req.headers.get(h)
            if v is not None:
                head.append(f"{h}: {v}")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") \
            + req.body

    async def _backend_roundtrip(self, be: Backend, req: _Request):
        """One request against one backend over a fresh connection;
        returns (status, lower-cased headers, body bytes). Raises
        ``BackendConnectError`` before dispatch, ``Midstream`` after.
        """
        b_rd, b_w = await self._connect(be)
        try:
            try:
                b_w.write(self._request_bytes(req, be))
                await b_w.drain()
                return await asyncio.wait_for(
                    self._read_response(b_rd),
                    self.upstream_timeout_s)
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                # Conservative: once the connect succeeded, any part
                # of the request may have reached the worker — a
                # fully-received body WILL be dispatched even if our
                # read side broke, so this is never re-routed.
                raise BackendMidstreamError(
                    f"{be.name} failed mid-response: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            try:
                b_w.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _read_response(b_rd: asyncio.StreamReader):
        line = await b_rd.readline()
        if not line:
            raise ConnectionError("backend closed before the status line")
        parts = line.decode("latin-1").strip().split(" ", 2)
        status = int(parts[1])
        headers = {}
        while True:
            h = await b_rd.readline()
            if h in (b"\r\n", b"\n"):
                break
            if not h:
                raise ConnectionError("backend closed mid-headers")
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("content-length", 0))
        body = await b_rd.readexactly(n) if n else b""
        return status, headers, body

    async def _h_relay(self, req: _Request, writer) -> bool:
        tried = set()
        while True:
            be = self._pick(exclude=tried)
            if be is None:
                await write_response(writer, 503, proto.error_body(
                    "shutdown", "no routable backend in the fleet",
                    phase="proxy"),
                    extra_headers=self._unavailable_headers(req))
                return True
            tried.add(be.name)
            be.outstanding += 1
            try:
                status, hdrs, payload = await self._backend_roundtrip(
                    be, req)
            except BackendConnectError:
                be.breaker.record_failure()
                self.reroutes += 1
                continue                # idempotent: never dispatched
            except BackendMidstreamError as e:
                be.breaker.record_failure()
                self.upstream_failures += 1
                await write_response(writer, 502, proto.error_body(
                    "upstream", str(e), phase="proxy"))
                return True
            finally:
                be.outstanding -= 1
            be.breaker.record_success()
            extra = {}
            ra = hdrs.get("retry-after")
            if ra is not None:          # the engine's backpressure, verbatim
                extra["Retry-After"] = ra
            await write_response(
                writer, status, payload,
                content_type=hdrs.get("content-type",
                                      "application/json"),
                extra_headers=extra or None, close=self._draining)
            return True

    async def _h_specialize(self, req: _Request, writer) -> bool:
        """Broadcast: content-addressed keys agree across workers, so
        one 200 makes the key valid fleet-wide; failures only degrade
        the failing backend's breaker."""
        async def one(be: Backend):
            be.outstanding += 1
            try:
                return be, await self._backend_roundtrip(be, req)
            except (BackendConnectError, BackendMidstreamError) as e:
                be.breaker.record_failure()
                return be, e
            finally:
                be.outstanding -= 1

        targets = [be for be in self._backends.values()
                   if be.routable()]
        if not targets:
            await write_response(writer, 503, proto.error_body(
                "shutdown", "no routable backend in the fleet",
                phase="proxy"),
                extra_headers=self._unavailable_headers(req))
            return True
        results = await asyncio.gather(*(one(be) for be in targets))
        winner = None
        for be, res in results:
            if isinstance(res, tuple):
                be.breaker.record_success()
                status, hdrs, payload = res
                if status == 200 and winner is None:
                    winner = (status, hdrs, payload)
        if winner is None:
            # Every backend refused or failed: relay the first
            # structured answer if any backend produced one.
            for _be, res in results:
                if isinstance(res, tuple):
                    status, hdrs, payload = res
                    await write_response(
                        writer, status, payload,
                        content_type=hdrs.get("content-type",
                                              "application/json"))
                    return True
            self.upstream_failures += 1
            await write_response(writer, 502, proto.error_body(
                "upstream", "specialize failed on every backend",
                phase="proxy"))
            return True
        status, hdrs, payload = winner
        try:
            key = json.loads(payload)["subject"]
            self._specialized[key] = bytes(req.body)
        except (ValueError, KeyError, TypeError):
            pass
        await write_response(writer, status, payload,
                             content_type=hdrs.get(
                                 "content-type", "application/json"))
        return True

    # -------------------------------------------------------- health fanout
    async def _h_healthz(self, writer) -> bool:
        """Bounded CONCURRENT fan-out: one wedged worker costs its own
        timeout, not the scrape (the `mano status --server` contract).
        """
        async def probe_one(be: Backend):
            req = _Request("GET", "/healthz", {}, b"")
            try:
                _status, _hdrs, payload = await asyncio.wait_for(
                    self._backend_roundtrip(be, req),
                    self.probe_timeout_s)
                return be, json.loads(payload)
            except Exception as e:  # noqa: BLE001 — degrade per-worker
                return be, {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}

        results = await asyncio.gather(
            *(probe_one(be) for be in list(self._backends.values())))
        backends = {}
        for be, h in results:
            if "warm_streams" in h:     # refresh the warm fact
                be.stream_warm = bool(h["warm_streams"])
            backends[be.name] = {
                "ok": bool(h.get("ok", False)),
                "status": h.get("status"),
                "degraded": h.get("degraded"),
                "error": h.get("error"),
                "breaker": be.breaker.state,
                "draining_via_proxy": be.draining,
                "outstanding": be.outstanding,
                "streams": len(be.streams),
                "stream_warm": be.stream_warm,
            }
        routable = sum(1 for be, _h in results if be.routable())
        ok = not self._draining and routable > 0
        body = {
            "ok": ok,
            "role": "proxy",
            "proxy_role": self.role,
            "takeovers": self.takeovers,
            "status": "draining" if self._draining else "proxying",
            "degraded": 0 < routable < len(backends),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "backends": backends,
            "streams": {"active": sum(
                len(be.streams) for be in self._backends.values())},
            "counters": self._counter_dict(),
        }
        await write_response(writer, 200 if ok else 503, body)
        return True

    def _counter_dict(self) -> dict:
        return {
            "requests_proxied": self.requests_proxied,
            "reroutes": self.reroutes,
            "upstream_failures": self.upstream_failures,
            "streams_opened": self.streams_opened,
            "frames_relayed": self.frames_relayed,
            "migrations": self.migrations,
            "migrated_frames": self.migrated_frames,
        }

    async def _h_metrics(self, writer) -> bool:
        """The proxy's OWN counters in Prometheus text form (workers
        keep serving their full registries on their own ports)."""
        lines = []
        for k, v in self._counter_dict().items():
            lines.append(f"# TYPE mano_proxy_{k} counter")
            lines.append(f"mano_proxy_{k} {v}")
        lines.append("# TYPE mano_proxy_takeovers counter")
        lines.append(f"mano_proxy_takeovers {self.takeovers}")
        lines.append("# TYPE mano_proxy_active gauge")
        lines.append(
            f"mano_proxy_active {1 if self.role == 'active' else 0}")
        for be in self._backends.values():
            lab = f'{{backend="{be.name}"}}'
            lines.append(
                f"mano_proxy_backend_streams{lab} {len(be.streams)}")
            lines.append(
                f"mano_proxy_backend_routable{lab} "
                f"{1 if be.routable() else 0}")
            lines.append(
                f"mano_proxy_backend_stream_warm{lab} "
                f"{-1 if be.stream_warm is None else int(be.stream_warm)}")
        await write_response(
            writer, 200, ("\n".join(lines) + "\n").encode("utf-8"),
            content_type="text/plain; version=0.0.4")
        return True


class _StreamRelay:
    """One client stream session proxied onto (a succession of)
    backend sessions.

    The relay answers the 101 itself, then speaks strict one-line-in /
    one-line-out NDJSON both ways. State for migration: the ORIGINAL
    open msg (re-sent verbatim on handoff — betas travel with it, and
    subject keys are fleet-valid via the specialize broadcast), the
    last CONFIRMED pose (taken off each frame reply, still in wire
    encoding), and the confirmed-frame count (the numbering offset a
    sibling's fresh 0-based counter needs).
    """

    def __init__(self, proxy: EdgeProxy, rd: _Pushback, writer):
        self.proxy = proxy
        self.rd = rd
        self.writer = writer
        self.backend: Optional[Backend] = None
        self.b_rd: Optional[asyncio.StreamReader] = None
        self.b_w: Optional[asyncio.StreamWriter] = None
        self.open_msg: Optional[dict] = None
        self.last_pose: Optional[dict] = None   # wire-encoded [J,3]
        self.frames_confirmed = 0
        self.offset = 0
        self.migrate_evt = asyncio.Event()

    # ------------------------------------------------------------ plumbing
    async def _send_client(self, obj: dict) -> None:
        self.writer.write(proto.dumps(obj) + b"\n")
        await self.writer.drain()

    def _detach(self) -> None:
        if self.backend is not None:
            self.backend.streams.discard(self)
        if self.b_w is not None:
            try:
                self.b_w.close()
            except Exception:  # noqa: BLE001
                pass
        self.backend = self.b_rd = self.b_w = None

    async def _open_on(self, be: Backend, *, resume: bool):
        """Upgrade + open one backend session; returns the open reply.
        Raises ``BackendConnectError`` when nothing client-visible was
        dispatched (connect refused, upgrade refused, socket died
        before the reply — the dead worker's half-open session closes
        itself on our socket's death, span-once), ``_OpenRefused`` on
        a structured error line."""
        b_rd, b_w = await self.proxy._connect(be)
        try:
            b_w.write(
                (f"POST /v1/stream HTTP/1.1\r\n"
                 f"Host: {be.host}:{be.port}\r\n"
                 f"Upgrade: {proto.STREAM_UPGRADE}\r\n"
                 f"Connection: Upgrade\r\n"
                 f"Content-Length: 0\r\n\r\n").encode("latin-1"))
            await b_w.drain()
            status = await b_rd.readline()
            if not status.startswith(b"HTTP/1.1 101"):
                raise BackendConnectError(
                    f"{be.name} refused the stream upgrade: "
                    f"{status!r}")
            while True:                 # drain the 101 headers
                h = await b_rd.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            msg = dict(self.open_msg)
            if resume and self.last_pose is not None:
                msg["resume_pose"] = self.last_pose
            b_w.write(proto.dumps(msg) + b"\n")
            await b_w.drain()
            raw = await asyncio.wait_for(b_rd.readline(),
                                         self.proxy.upstream_timeout_s)
            if not raw:
                raise BackendConnectError(
                    f"{be.name} closed during the stream open")
            reply = json.loads(raw)
            if "error" in reply:
                raise _OpenRefused(reply)
            return b_rd, b_w, reply
        except (OSError, ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, ValueError) as e:
            try:
                b_w.close()
            except Exception:  # noqa: BLE001
                pass
            raise BackendConnectError(
                f"{be.name} died during the stream open: "
                f"{type(e).__name__}: {e}") from e
        except BaseException:
            try:
                b_w.close()
            except Exception:  # noqa: BLE001
                pass
            raise

    # ------------------------------------------------------------ handlers
    async def _handle_open(self, msg: dict) -> None:
        if self.backend is not None:
            await self._send_client(proto.error_body(
                "bad_request",
                "stream already open on this connection"))
            return
        self.open_msg = msg
        tried = set()
        while True:
            be = self.proxy._pick_stream(exclude=tried)
            if be is None:
                self.open_msg = None
                await self._send_client(proto.error_body(
                    "shutdown", "no routable backend in the fleet",
                    phase="proxy"))
                return
            tried.add(be.name)
            try:
                b_rd, b_w, reply = await self._open_on(be, resume=False)
            except BackendConnectError:
                be.breaker.record_failure()
                self.proxy.reroutes += 1
                continue
            except _OpenRefused as e:
                # A structured refusal (shed / bad open): the client's
                # problem, relayed verbatim; the connection stays
                # usable for a retry (the worker's own semantics).
                self.open_msg = None
                await self._send_client(e.reply)
                return
            break
        self.backend = be
        self.b_rd, self.b_w = b_rd, b_w
        be.streams.add(self)
        be.breaker.record_success()
        self.proxy.streams_opened += 1
        await self._send_client(reply)

    async def _migrate(self, *, polite: bool) -> bool:
        """Hand this session to a sibling, warm-started at the last
        confirmed pose. ``polite`` (the drain path) closes the old
        session with a real ``{"op": "close"}`` first so its span
        closes exactly once in the old worker's tracer; the failover
        path (backend already dead) skips the courtesy."""
        old = self.backend
        old_rd, old_w = self.b_rd, self.b_w
        if not polite:
            self._detach()
        elif old is not None and old_w is not None:
            old.streams.discard(self)
            try:
                old_w.write(proto.dumps({"op": "close"}) + b"\n")
                await old_w.drain()
                await asyncio.wait_for(old_rd.readline(), 5.0)
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError):
                pass                    # it died mid-drain: span closes
            finally:                    # via its disconnect path
                try:
                    old_w.close()
                except Exception:  # noqa: BLE001
                    pass
            self.backend = self.b_rd = self.b_w = None
        tried = {old.name} if old is not None else set()
        while True:
            be = self.proxy._pick_stream(exclude=tried)
            if be is None:
                return False
            tried.add(be.name)
            try:
                b_rd, b_w, _reply = await self._open_on(be, resume=True)
            except BackendConnectError:
                be.breaker.record_failure()
                continue
            except _OpenRefused:
                continue                # shed here: try the next sibling
            break
        self.backend = be
        self.b_rd, self.b_w = b_rd, b_w
        # The sibling's session numbers frames from 0 again; every
        # relayed reply gets the confirmed-count offset added so the
        # client sees one continuous stream.
        self.offset = self.frames_confirmed
        be.streams.add(self)
        be.breaker.record_success()
        self.proxy.migrations += 1
        return True

    async def _handle_frame(self, msg: dict) -> None:
        if self.backend is None:
            await self._send_client(proto.error_body(
                "bad_request", "no open stream — send "
                '{"op": "open", ...} first'))
            return
        if self.migrate_evt.is_set():   # drain landed between frames
            self.migrate_evt.clear()
            if not await self._migrate(polite=True):
                await self._send_client(proto.error_body(
                    "upstream", "stream lost: no sibling could adopt "
                    "the session", phase="proxy"))
                return
        line = proto.dumps(msg) + b"\n"
        resent = False
        while True:
            try:
                self.b_w.write(line)
                await self.b_w.drain()
                raw = await asyncio.wait_for(
                    self.b_rd.readline(),
                    self.proxy.upstream_timeout_s)
                if not raw:
                    raise ConnectionError("backend closed mid-frame")
                reply = json.loads(raw)
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                # The migration race: this frame was IN FLIGHT when the
                # backend died. Its reply never reached the client (one
                # line per op, ordered), so re-sending on a sibling
                # warm-started from the last CONFIRMED pose re-derives
                # the SAME result (deterministic fits) — not a double
                # submit: the dead worker's partial work died with it.
                if self.backend is not None:
                    self.backend.breaker.record_failure()
                if not await self._migrate(polite=False):
                    self.proxy.upstream_failures += 1
                    await self._send_client(proto.error_body(
                        "upstream",
                        f"backend lost mid-frame and no sibling "
                        f"could adopt the session: {e}",
                        phase="proxy"))
                    return
                resent = True
                continue
            break
        if resent:
            self.proxy.migrated_frames += 1
        if reply.get("event") == "frame":
            self.last_pose = reply.get("pose")
            reply["frame"] = int(reply.get("frame", 0)) + self.offset
            self.frames_confirmed = reply["frame"] + 1
            self.proxy.frames_relayed += 1
        await self._send_client(reply)

    async def _handle_close(self) -> None:
        if self.backend is None:
            await self._send_client({"event": "closed", "frames": 0})
            return
        try:
            self.b_w.write(proto.dumps({"op": "close"}) + b"\n")
            await self.b_w.drain()
            raw = await asyncio.wait_for(self.b_rd.readline(), 10.0)
            reply = json.loads(raw) if raw else {"event": "closed"}
        except (OSError, ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, ValueError):
            # The backend died with the close in flight: its session
            # closes via the disconnect path (span-once); the client
            # still deserves a terminal.
            reply = {"event": "closed"}
        reply["frames"] = int(reply.get("frames", 0)) + self.offset
        await self._send_client(reply)

    # ---------------------------------------------------------------- loop
    async def run(self) -> bool:
        self.writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: " + proto.STREAM_UPGRADE.encode() + b"\r\n"
            b"Connection: Upgrade\r\n\r\n")
        await self.writer.drain()
        # Like EdgeServer._h_stream: an idle parked session must not
        # count as an in-flight request against the proxy drain.
        self.proxy._active_requests -= 1
        line_task = None
        try:
            while True:
                if line_task is None:
                    line_task = asyncio.ensure_future(
                        self.rd.readline())
                mig_task = asyncio.ensure_future(
                    self.migrate_evt.wait())
                done, _ = await asyncio.wait(
                    {line_task, mig_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if line_task not in done:
                    # A drain fired while the client is idle: migrate
                    # NOW (the drain budget cannot wait on a client
                    # that owes nothing), keep the parked read.
                    self.migrate_evt.clear()
                    if self.backend is not None:
                        if not await self._migrate(polite=True):
                            await self._send_client(proto.error_body(
                                "upstream",
                                "stream lost during a backend drain: "
                                "no sibling could adopt the session",
                                phase="proxy"))
                            break
                    continue
                if not mig_task.done():
                    mig_task.cancel()
                line = line_task.result()
                line_task = None
                if not line:
                    break               # client gone: cleanup in finally
                try:
                    msg = json.loads(line)
                    op = msg.get("op")
                except ValueError:
                    await self._send_client(proto.error_body(
                        "bad_request", "stream frames must be one "
                        "JSON object per line"))
                    break
                self.proxy._active_requests += 1
                try:
                    if op == "open":
                        await self._handle_open(msg)
                    elif op == "frame":
                        await self._handle_frame(msg)
                    elif op == "close":
                        await self._handle_close()
                        break
                    else:
                        await self._send_client(proto.error_body(
                            "bad_request",
                            f"unknown stream op {op!r}"))
                finally:
                    self.proxy._active_requests -= 1
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            if line_task is not None and not line_task.done():
                line_task.cancel()
            # A vanished client (or any exit) hard-closes the backend
            # socket: the worker's disconnect path cancels in-flight
            # work and closes the session span — exactly once.
            self._detach()
            self.proxy._active_requests += 1
        return False                    # an upgraded connection is done
