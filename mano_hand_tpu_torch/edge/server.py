"""The network edge: a thin asyncio HTTP front-end over ServingEngine.

A port of the JAX package's ``edge/server.py`` over the port's engine.
The engine's serving machinery — bucketed coalescing, admission tiers,
deadlines, streams, lanes, precision tiers, SLO burn rates — is
reachable in-process through ``submit()``; this process boundary makes
it a service, and keeps every internal API honest about serialization:
everything that crosses this module is bytes.

The server is deliberately THIN: every decision it makes is a mapping
of machinery that already exists.

* **One-shot requests** (``POST /v1/forward``): the tier and TTL ride
  headers (``X-Mano-Priority``, ``X-Mano-Deadline-S``) straight into
  ``submit(priority=, deadline_s=)``; the response is the verts array,
  losslessly encoded (edge/protocol.py) so the wire result is
  BIT-identical to the in-process future's.
* **Backpressure**: a ``ServingError(kind="shed")`` maps to 429 with a
  per-tier ``Retry-After`` derived from ``load()`` — the O(µs)
  admission decision stays the engine's; the edge only translates it.
* **Streams** (``/v1/stream`` + ``Upgrade: mano-stream/1`` -> 101):
  the open/frame/close protocol over one persistent connection,
  newline-delimited JSON both ways. The socket IS the session: a
  client disconnect cancels the in-flight frame future (the caller-
  cancellation path — terminal kind ``cancelled``) and closes the
  session, so an abandoned user never pins engine capacity.
* **Graceful drain** (SIGTERM -> ``drain()``): new connections are
  refused (the listener closes first), fully-received in-flight
  requests resolve, idle keep-alive connections are swept, and the
  engine runs its ``stop(timeout_s=)`` sweep — every outstanding
  future resolves, every stream span closes, bounded by the timeout
  (monotonic arithmetic throughout).
* **Observability**: ``GET /metrics`` serves the Prometheus text export
  of the engine's registry; ``GET /healthz`` derives liveness from
  dispatcher/breaker/lane state; every 5xx response carries a
  flight-record capture in its body — the black box arrives WITH the
  incident, not after it.

Blocking discipline: the event loop never waits on the engine.
``submit``, ``specialize``, ``open_stream``, ``submit_frame`` and the
engine's ``stop`` run in the default executor (a card engine's device
work runs under its own ``_on_device()`` context on whichever thread
calls it); future resolution is awaited via ``asyncio.wrap_future``.
HTTP parsing is hand-rolled over asyncio streams (stdlib-only — the
protocol surface is deliberately tiny).

Multi-worker coexistence: the server takes NO device lock itself —
``serve`` wraps it in ``utils.devicelock.DeviceLock("server")`` (a
SHARED flock: N workers coexist, an exclusive benchmark's lock and
priority claim still win — see devicelock.py).
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Callable, Optional

import numpy as np

from mano_hand_tpu_torch.edge import protocol as proto
from mano_hand_tpu_torch.serving.engine import ServingError

#: Bound on request bodies (arrays are small: a 1024-row pose batch is
#: ~200 KB encoded) — a runaway body must fail fast, not grow memory.
MAX_BODY_BYTES = 8 << 20

#: asyncio stream readline limit (request line / one NDJSON frame).
_LINE_LIMIT = 1 << 20


class _Pushback:
    """Tiny buffered reader: the disconnect watcher reads one byte
    ahead of the parser; a byte that turns out to be the next
    request's first byte is pushed back instead of eaten."""

    def __init__(self, reader: asyncio.StreamReader):
        self.r = reader
        self.buf = b""

    async def readline(self) -> bytes:
        if self.buf:
            head, self.buf = self.buf, b""
            if b"\n" in head:               # a full buffered line
                i = head.index(b"\n") + 1
                self.buf = head[i:]
                return head[:i]
            return head + await self.r.readline()
        return await self.r.readline()

    async def readexactly(self, n: int) -> bytes:
        if self.buf:
            head, self.buf = self.buf[:n], self.buf[n:]
            if len(head) == n:
                return head
            return head + await self.r.readexactly(n - len(head))
        return await self.r.readexactly(n)

    async def read1(self) -> bytes:
        if self.buf:
            b, self.buf = self.buf[:1], self.buf[1:]
            return b
        return await self.r.read(1)

    def push(self, data: bytes) -> None:
        self.buf = data + self.buf


class _Request:
    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method, path, headers, body):
        self.method = method
        self.path = path
        self.headers = headers      # lower-cased keys
        self.body = body


async def write_response(writer, status: int, body,
                         *, content_type: str = "application/json",
                         extra_headers: Optional[dict] = None,
                         close: bool = False) -> None:
    """Serialize one HTTP/1.1 response (one implementation owns the
    bytes)."""
    payload = (body if isinstance(body, (bytes, bytearray))
               else proto.dumps(body))
    head = [f"HTTP/1.1 {status} {proto.reason(status)}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(payload)}"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    if close:
        head.append("Connection: close")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                 + bytes(payload))
    await writer.drain()


async def read_request(rd: _Pushback, writer, *,
                       max_body_bytes: int = MAX_BODY_BYTES,
                       draining: bool = False) -> Optional[_Request]:
    """Parse one HTTP/1.1 request off an upgraded-capable connection;
    answers the malformed cases itself (400/413) and returns None when
    the connection is done."""
    try:
        line = await rd.readline()
    except (ValueError, asyncio.LimitOverrunError):
        await write_response(writer, 400, proto.error_body(
            "bad_request", "request line too long"), close=draining)
        return None
    if not line:
        return None                 # clean EOF between requests
    try:
        method, path, _version = line.decode(
            "latin-1").strip().split(" ", 2)
    except ValueError:
        await write_response(writer, 400, proto.error_body(
            "bad_request", "malformed request line"), close=draining)
        return None
    headers = {}
    while True:
        h = await rd.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            return None             # EOF mid-headers: client gone
        if len(headers) > 128:
            await write_response(writer, 400, proto.error_body(
                "bad_request", "too many headers"), close=draining)
            return None
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    body = b""
    if headers.get("transfer-encoding"):
        await write_response(writer, 400, proto.error_body(
            "bad_request", "chunked bodies are not supported"),
            close=draining)
        return None
    clen = headers.get("content-length")
    if clen:
        try:
            n = int(clen)
        except ValueError:
            n = -1
        if n < 0 or n > max_body_bytes:
            await write_response(writer, 413, proto.error_body(
                "bad_request",
                f"body of {clen} bytes exceeds the "
                f"{max_body_bytes}-byte bound"), close=draining)
            return None
        body = await rd.readexactly(n)
    return _Request(method, path, headers, body)


class EdgeServer:
    """Asyncio HTTP front-end over one ``ServingEngine``.

    Runs its event loop in a daemon thread (``start()``); ``drain()``
    is the SIGTERM path and is callable from any thread. ``port=0``
    binds an ephemeral port (read ``self.port`` after ``start()``) —
    the loopback-drill/test form.

    The engine is caller-owned: the server starts it implicitly via
    the first ``submit`` and stops it ONLY inside ``drain()`` (the
    documented shutdown sweep). ``registry`` defaults to a fresh
    ``obs.metrics.engine_registry(engine)``.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 *, registry=None, drain_timeout_s: float = 10.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 retry_after_source: Optional[Callable] = None,
                 warm_streams: Optional[bool] = None,
                 log: Optional[Callable[[str], None]] = None):
        self._engine = engine
        # Did this worker pre-warm its stream path before declaring
        # ready (``serve --warm-streams``)? A tri-state fact surfaced on
        # /healthz so a front tier can keep NEW stream opens off a cold
        # worker. None = the owner never said (embedded/test servers)
        # and the key is omitted from healthz.
        self._warm_streams = warm_streams
        self.host = host
        self.port = int(port)           # rewritten to the bound port
        self._registry = registry
        self.drain_timeout_s = float(drain_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        # An optional ``(tier, load) -> Optional[int]`` callback (a
        # controller's ``retry_after_for``) that OWNS the 429 Retry-After
        # when it returns an int; None (no controller, no opinion, or
        # crashed) or a raise falls back to the static
        # ``protocol.retry_after_s`` formula.
        self._retry_after_source = retry_after_source
        self._log = log or (lambda m: None)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._conn_tasks: set = set()
        # Fully-received requests currently being served (the drain
        # wait's definition of "in flight"); loop-thread-only writes.
        self._active_requests = 0
        self._draining = False
        self._drained = False
        self._t0 = time.monotonic()
        self.requests_served = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EdgeServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="mano-edge", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError("edge server failed to bind within 30s")
        if self._boot_error is not None:
            raise RuntimeError(
                f"edge server failed to start: {self._boot_error}")
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
        self._ready.set()
        self._log(f"edge listening on {self.host}:{self.port}")
        await self._stop_event.wait()

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """The SIGTERM path: refuse new connections, resolve in-flight
        requests, sweep idle connections, run the engine's
        ``stop(timeout_s=)`` sweep, stop the loop. Callable from any
        thread; idempotent (a second drain reports the first's
        outcome). Returns a small report dict for the caller's exit
        line."""
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
            # The listening sockets close NOW: new connections refused.
            # Not ``wait_closed()`` here: since Python 3.12 it also waits
            # for every open connection to drop, and an idle keep-alive
            # client would hold the drain for its whole window.
            srv.close()
        # In-flight (fully received) requests get the rest of the
        # window to resolve; idle keep-alive connections are parked in
        # a readline and cannot "finish" — they are swept after.
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
        loop = asyncio.get_running_loop()
        eng_timeout = max(0.1, deadline - time.monotonic())
        # The engine's own drain sweep: blocking, so it runs in the
        # executor — the loop stays responsive to the task
        # cancellations above.
        await loop.run_in_executor(
            None, lambda: self._engine.stop(timeout_s=eng_timeout))
        self._stop_event.set()
        return {
            "drained": True,
            "inflight_resolved": inflight_resolved,
            "requests_served": self.requests_served,
            "within_timeout": time.monotonic() <= deadline,
        }

    # ----------------------------------------------------------- connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        rd = _Pushback(reader)
        try:
            while True:
                req = await self._read_request(rd, writer)
                if req is None:
                    break
                self._active_requests += 1
                try:
                    keep = await self._dispatch(req, rd, writer)
                finally:
                    self._active_requests -= 1
                    self.requests_served += 1
                if not keep or self._draining:
                    break
        except (asyncio.CancelledError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        except Exception as e:  # noqa: BLE001 — one bad conn != the server
            self._log(f"edge connection error: {type(e).__name__}: {e}")
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, rd: _Pushback,
                            writer) -> Optional[_Request]:
        return await read_request(
            rd, writer, max_body_bytes=self.max_body_bytes,
            draining=self._draining)

    async def _respond(self, writer, status: int, body,
                       *, content_type: str = "application/json",
                       extra_headers: Optional[dict] = None,
                       close: bool = False) -> None:
        await write_response(
            writer, status, body, content_type=content_type,
            extra_headers=extra_headers,
            close=close or self._draining)

    # ------------------------------------------------------------- routing
    async def _dispatch(self, req: _Request, rd: _Pushback,
                        writer) -> bool:
        """Serve one request; returns False to close the connection."""
        if self._draining:
            await self._respond(writer, 503, proto.error_body(
                "shutdown", "edge is draining; connection closing"),
                close=True)
            return False
        route = (req.method, req.path.split("?", 1)[0])
        try:
            if route == ("GET", "/healthz"):
                return await self._h_healthz(writer)
            if route == ("GET", "/metrics"):
                return await self._h_metrics(writer)
            if route == ("POST", "/v1/forward"):
                return await self._h_forward(req, rd, writer)
            if route == ("POST", "/v1/specialize"):
                return await self._h_specialize(req, writer)
            if route[1] == "/v1/stream":
                if (req.headers.get("upgrade") or "").lower() \
                        != proto.STREAM_UPGRADE:
                    await self._respond(writer, 400, proto.error_body(
                        "bad_request",
                        f"/v1/stream requires 'Upgrade: "
                        f"{proto.STREAM_UPGRADE}'"))
                    return True
                return await self._h_stream(rd, writer)
            status = 404 if route[1] not in (
                "/healthz", "/metrics", "/v1/forward",
                "/v1/specialize") else 405
            await self._respond(writer, status, proto.error_body(
                "bad_request", f"no route for {req.method} {req.path}"))
            return True
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — 500 + flight, not a crash
            await self._respond(
                writer, 500, proto.error_body(
                    "error", f"{type(e).__name__}: {e}",
                    flight=self._flight(f"edge_500_{route[1]}")))
            return True

    def _flight(self, reason: str) -> Optional[dict]:
        """A trimmed flight capture for a 5xx body (None without a
        tracer — the capture must never be the thing that fails)."""
        tr = self._engine.tracer
        if tr is None:
            return None
        try:
            from mano_hand_tpu_torch.obs import flight_record

            return flight_record(tr, self._engine.counters,
                                 reason=reason, max_spans=8,
                                 max_events=32)
        except Exception:  # noqa: BLE001
            return None

    # ------------------------------------------------------------ handlers
    async def _h_healthz(self, writer) -> bool:
        eng = self._engine
        load = eng.load()
        failure = getattr(eng, "_failure", None)
        policy = getattr(eng, "_policy", None)
        breaker = getattr(policy, "breaker", None)
        lanes = load.get("lanes")
        status = ("draining" if self._draining
                  else ("failed" if failure is not None else "serving"))
        ok = status == "serving"
        degraded = False
        if lanes:
            healthy = lanes.get("healthy")
            if healthy == 0:
                ok = False
            elif healthy is not None and healthy < lanes.get("n_lanes", 0):
                degraded = True
        if breaker is not None and breaker.state != "healthy":
            degraded = True     # CPU failover still serves: degraded, up
        body = {
            "ok": ok,
            "status": status,
            "degraded": degraded,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "engine": {
                "outstanding": load.get("outstanding"),
                "queued": load.get("queued"),
                "max_queued": load.get("max_queued"),
                "admission": load.get("admission"),
                "failure": (None if failure is None else str(failure)),
            },
            "streams": {
                "active": (load.get("streams") or {}).get("active"),
                "frames_in_flight": (load.get("streams") or {}
                                     ).get("frames_in_flight"),
            },
            "lanes": (None if not lanes else {
                "n_lanes": lanes.get("n_lanes"),
                "healthy": lanes.get("healthy"),
            }),
            "breaker": None if breaker is None else breaker.state,
        }
        if self._warm_streams is not None:
            body["warm_streams"] = bool(self._warm_streams)
        await self._respond(writer, 200 if ok else 503, body)
        return True

    async def _h_metrics(self, writer) -> bool:
        reg = self._registry
        if reg is None:
            from mano_hand_tpu_torch.obs.metrics import engine_registry

            reg = self._registry = engine_registry(self._engine)
        loop = asyncio.get_running_loop()
        # The scrape walks every collector (several one-lock-hold
        # snapshots); executor keeps the accept loop responsive.
        text = await loop.run_in_executor(None, reg.prometheus)
        await self._respond(writer, 200, text.encode("utf-8"),
                            content_type="text/plain; version=0.0.4")
        return True

    def _qos(self, req: _Request, body: dict):
        """(priority, deadline_s) from headers (body fields as the
        fallback — headers win so proxies can rewrite QoS)."""
        prio = req.headers.get(proto.PRIORITY_HEADER)
        if prio is None:
            prio = body.get("priority", 0)
        ddl = req.headers.get(proto.DEADLINE_HEADER)
        if ddl is None:
            ddl = body.get("deadline_s")
        return int(prio), (None if ddl in (None, "") else float(ddl))

    async def _h_forward(self, req: _Request, rd: _Pushback,
                         writer) -> bool:
        try:
            body = json.loads(req.body or b"{}")
            pose = proto.decode_array(body["pose"])
            shape = (proto.decode_array(body["shape"])
                     if body.get("shape") is not None else None)
            subject = body.get("subject")
            tier, deadline_s = self._qos(req, body)
        except (KeyError, ValueError, TypeError) as e:
            await self._respond(writer, 400, proto.error_body(
                "bad_request", f"malformed forward request: {e}"))
            return True
        loop = asyncio.get_running_loop()
        try:
            # Admission is host bookkeeping, but a card engine's submit
            # may start its dispatcher: executor, never the loop.
            fut = await loop.run_in_executor(
                None, lambda: self._engine.submit(
                    pose, shape, subject=subject, priority=tier,
                    deadline_s=deadline_s))
        except ServingError as e:
            return await self._serving_error(writer, e, tier)
        except (ValueError, RuntimeError) as e:
            # Caller errors (bad shape, unknown subject) and a dead
            # dispatcher: the former 400, the latter 503.
            if isinstance(e, RuntimeError):
                await self._respond(writer, 503, proto.error_body(
                    "shutdown", str(e),
                    flight=self._flight("edge_submit_failed")))
            else:
                await self._respond(writer, 400, proto.error_body(
                    "bad_request", str(e)))
            return True
        verts, gone = await self._await_future(fut, rd, deadline_s)
        if gone:
            return False                # disconnect: cancelled, no reply
        if isinstance(verts, ServingError):
            return await self._serving_error(writer, verts, tier)
        await self._respond(writer, 200, {
            "verts": proto.encode_array(np.asarray(verts))})
        return True

    async def _await_future(self, fut, rd: _Pushback,
                            deadline_s: Optional[float]):
        """Await one engine future while watching the connection: a
        client disconnect cancels the future (the caller-cancellation
        path) instead
        of serving a result nobody reads. Returns (result-or-
        ServingError, client_gone)."""
        afut = asyncio.ensure_future(asyncio.wrap_future(fut))
        eof = asyncio.ensure_future(rd.read1())
        # Backstop only: the engine's own deadline sweep resolves
        # expired futures — this cap exists so a deadline-less request
        # cannot pin a drained server forever.
        cap = None if deadline_s is None else deadline_s + 60.0
        try:
            while True:
                waiters = {afut} if eof is None else {afut, eof}
                done, _pending = await asyncio.wait(
                    waiters, timeout=cap,
                    return_when=asyncio.FIRST_COMPLETED)
                if afut in done:
                    break
                if eof is not None and eof in done:
                    data = eof.result()
                    if data:
                        # A pipelined byte, not a disconnect: push it
                        # back for the next request's parser and keep
                        # waiting (one watcher byte is enough — a
                        # half-closed writer still surfaces as EOF).
                        rd.push(data)
                        eof = None
                        continue
                    fut.cancel()
                    return None, True
                if not done:            # cap elapsed: backstop expiry
                    fut.cancel()
                    return ServingError(
                        "edge wait cap elapsed before the engine "
                        "resolved this request", phase="edge",
                        kind="error"), False
        finally:
            if eof is not None:
                if not eof.done():
                    eof.cancel()
                # Await the watcher OUT of the reader: task cancel is
                # asynchronous, and the next readline() would race a
                # still-pending read1() ("another coroutine is already
                # waiting"). A byte it managed to read before the
                # cancel landed belongs to the NEXT request — push it
                # back.
                try:
                    data = await eof
                    if data:
                        rd.push(data)
                except (asyncio.CancelledError, ConnectionError,
                        Exception):  # noqa: BLE001 — EOF errors land
                    pass             # again at the next reader call
            if not afut.done():
                afut.cancel()
        try:
            return afut.result(), False
        except ServingError as e:
            return e, False
        except asyncio.CancelledError:
            return ServingError("request cancelled at the engine",
                                phase="edge", kind="error"), False

    async def _serving_error(self, writer, e: ServingError,
                             tier: int) -> bool:
        status = proto.KIND_STATUS.get(e.kind, 500)
        extra = None
        if status == 429:
            # Backpressure: the Retry-After is the controller's actuated
            # value when one is attached and has an opinion, else it
            # derives from load()'s per-tier admission state
            # (protocol.retry_after_s).
            try:
                load = self._engine.load()
            except Exception:  # noqa: BLE001 — the header is advisory
                load = None
            retry_s = None
            if self._retry_after_source is not None:
                try:
                    retry_s = self._retry_after_source(tier, load)
                except Exception:  # noqa: BLE001 — advisory header; a
                    retry_s = None  # sick controller must not 500 a 429
            if retry_s is None:
                retry_s = proto.retry_after_s(tier, load)
            extra = {"Retry-After": int(retry_s)}
        flight = (self._flight(f"edge_5xx_{e.kind}")
                  if status >= 500 else None)
        await self._respond(writer, status, proto.error_body(
            e.kind, str(e), phase=getattr(e, "phase", "edge"),
            flight=flight), extra_headers=extra)
        return True

    async def _h_specialize(self, req: _Request, writer) -> bool:
        try:
            body = json.loads(req.body or b"{}")
            betas = proto.decode_array(body["betas"])
        except (KeyError, ValueError, TypeError) as e:
            await self._respond(writer, 400, proto.error_body(
                "bad_request", f"malformed specialize request: {e}"))
            return True
        loop = asyncio.get_running_loop()
        try:
            # specialize() bakes on device — executor, never the loop.
            key = await loop.run_in_executor(
                None, lambda: self._engine.specialize(betas))
        except (ValueError, TypeError) as e:
            # Engine-side caller errors (wrong betas length) are 400s,
            # exactly like _h_forward's — not 500-with-flight
            # incidents.
            await self._respond(writer, 400, proto.error_body(
                "bad_request", f"malformed specialize request: {e}"))
            return True
        await self._respond(writer, 200, {"subject": key})
        return True

    # -------------------------------------------------------------- streams
    async def _h_stream(self, rd: _Pushback, writer) -> bool:
        # The upgraded connection OUTLIVES the request that opened it:
        # an idle session parked in readline must not count as an
        # in-flight request, or drain() burns its whole window waiting
        # on a client that owes nothing. Release the _handle loop's
        # count here (its finally rebalances); per-FRAME work
        # re-enters via _stream_frame, which is the drain-visible
        # unit.
        self._active_requests -= 1
        try:
            return await self._h_stream_inner(rd, writer)
        finally:
            self._active_requests += 1

    async def _h_stream_inner(self, rd: _Pushback, writer) -> bool:
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: " + proto.STREAM_UPGRADE.encode() + b"\r\n"
            b"Connection: Upgrade\r\n\r\n")
        await writer.drain()
        loop = asyncio.get_running_loop()
        eng = self._engine
        sess = None
        disconnected = False
        try:
            while True:
                line = await rd.readline()
                if not line:
                    disconnected = True
                    break
                try:
                    msg = json.loads(line)
                    op = msg.get("op")
                except ValueError:
                    await self._send_line(writer, proto.error_body(
                        "bad_request", "stream frames must be one JSON "
                        "object per line"))
                    disconnected = True
                    break
                if op == "open":
                    if sess is not None:
                        await self._send_line(writer, proto.error_body(
                            "bad_request",
                            "stream already open on this connection"))
                        continue
                    try:
                        subject = msg.get("subject")
                        if subject is None:
                            subject = proto.decode_array(msg["betas"])
                        kw = {k: msg[k] for k in
                              ("n_steps", "data_term", "solver")
                              if k in msg}
                        if msg.get("resume_pose") is not None:
                            # Migration handoff: a session re-opened
                            # warm-started at the last confirmed pose
                            # (deterministic fits make the continuation
                            # bit-equal).
                            kw["resume_pose"] = proto.decode_array(
                                msg["resume_pose"])
                        sess = await loop.run_in_executor(
                            None, lambda: eng.open_stream(
                                subject,
                                frame_deadline_s=msg.get(
                                    "frame_deadline_s"),
                                idle_timeout_s=msg.get("idle_timeout_s"),
                                **kw))
                    except ServingError as e:
                        await self._send_line(writer, proto.error_body(
                            e.kind, str(e), phase="stream"))
                        continue
                    except (KeyError, ValueError, TypeError) as e:
                        await self._send_line(writer, proto.error_body(
                            "bad_request", f"malformed open: {e}"))
                        continue
                    await self._send_line(writer, {
                        "event": "opened",
                        "stream_id": sess.stream_id,
                        "subject": sess.subject,
                    })
                elif op == "frame":
                    if sess is None:
                        await self._send_line(writer, proto.error_body(
                            "bad_request", "no open stream — send "
                            '{"op": "open", ...} first'))
                        continue
                    try:
                        target = proto.decode_array(msg["target"])
                    except (KeyError, ValueError) as e:
                        await self._send_line(writer, proto.error_body(
                            "bad_request", f"malformed frame: {e}"))
                        continue
                    gone = await self._stream_frame(
                        sess, target, msg, rd, writer, loop)
                    if gone:
                        disconnected = True
                        break
                elif op == "close":
                    if sess is not None:
                        sess.close()
                    await self._send_line(writer, {
                        "event": "closed",
                        "frames": (0 if sess is None
                                   else sess.frames_submitted)})
                    break
                else:
                    await self._send_line(writer, proto.error_body(
                        "bad_request", f"unknown stream op {op!r}"))
        except (ConnectionError, asyncio.IncompleteReadError):
            disconnected = True
        finally:
            if sess is not None and disconnected:
                # The socket died with the session open: the client is
                # gone, so close the session (terminal "closed" —
                # span-once) rather than waiting for an idle sweep.
                sess.close()
        return False                    # an upgraded connection is done

    async def _stream_frame(self, sess, target, msg, rd: _Pushback,
                            writer, loop) -> bool:
        """One frame end-to-end; returns True when the client vanished
        (the in-flight frame future is cancelled and the caller closes
        the session)."""
        self._active_requests += 1
        try:
            kw = ({"deadline_s": msg["deadline_s"]}
                  if "deadline_s" in msg else {})
            # submit_frame runs the frozen-shape LM fit in its calling
            # thread (streams.py) — executor, never the loop.
            fut = await loop.run_in_executor(
                None, lambda: sess.submit_frame(target, **kw))
            res, gone = await self._await_future(
                fut, rd, msg.get("deadline_s", sess.frame_deadline_s))
            if gone:
                return True
            if isinstance(res, ServingError):
                await self._send_line(writer, proto.error_body(
                    res.kind, str(res), phase="stream"))
                return False
            await self._send_line(writer, {
                "event": "frame",
                "frame": int(res.frame),
                "fit_loss": float(res.fit_loss),
                "pose": proto.encode_array(np.asarray(res.pose)),
                "verts": proto.encode_array(np.asarray(res.verts)),
            })
            return False
        finally:
            self._active_requests -= 1

    async def _send_line(self, writer, obj) -> None:
        writer.write(proto.dumps(obj) + b"\n")
        await writer.drain()
