"""Loopback/test client for the edge wire protocol (stdlib-only).

A port of the JAX package's ``edge/client.py``. The edge drill, the
edge tests, and ``status --server`` all speak to a live edge through
THIS module, so the bytes the server is
judged against are produced by one shared implementation (the
protocol.py single-owner rule). It is deliberately synchronous —
drill workers are threads with one persistent connection each, the
shape real load-generator fleets take.

Every call is BOUNDED: the socket timeout covers connect and each
read, so a wedged server degrades to a structured ``EdgeError``
(never a hang — the `mano status` probe contract).
"""

from __future__ import annotations

import http.client
import json
import socket
from typing import NamedTuple, Optional

import numpy as np

from mano_hand_tpu_torch.edge import protocol as proto


class EdgeError(RuntimeError):
    """A structured edge failure: HTTP status + the server's
    kind/phase/message error body (+ Retry-After when the server sent
    backpressure)."""

    def __init__(self, status: int, body: Optional[dict] = None,
                 message: str = ""):
        err = (body or {}).get("error") or {}
        self.status = int(status)
        self.kind = err.get("kind", "error")
        self.phase = err.get("phase", "edge")
        self.flight = (body or {}).get("flight")
        self.retry_after_s: Optional[int] = None
        super().__init__(
            message or f"edge {status}: [{self.kind}] "
                       f"{err.get('message', '')}")


class FrameReply(NamedTuple):
    """One wire stream frame (mirrors serving.streams.FrameResult)."""

    pose: np.ndarray
    verts: np.ndarray
    fit_loss: float
    frame: int


class EdgeClient:
    """One persistent HTTP/1.1 connection to an edge worker.

    Thread-compatible, not thread-safe: one client per worker thread
    (the persistent-connection-per-worker shape). ``timeout_s`` bounds
    connect and every read.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 *, timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self._conn: Optional[http.client.HTTPConnection] = None

    # ----------------------------------------------------------- plumbing
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self) -> "EdgeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(self, method: str, path: str, body=None,
                 headers: Optional[dict] = None):
        """One round trip; reconnects once when the SEND fails on a
        stale keep-alive socket (the server may close between
        requests while draining). A failure after the request was
        sent is never retried — the server may have admitted the
        work, and a blind resend would double-submit a
        non-idempotent POST. Returns (status, headers, parsed-body).
        """
        payload = None if body is None else proto.dumps(body)
        hdrs = dict(headers or {})
        if payload is not None:
            hdrs.setdefault("Content-Type", "application/json")
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=payload, headers=hdrs)
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, socket.timeout, OSError):
                self.close()
                if attempt:
                    raise
                continue
            try:
                resp = conn.getresponse()
                raw = resp.read()
                break
            except BaseException:
                # The request is on the wire: whatever happened
                # (timeout, reset), resending is not safe.
                self.close()
                raise
        ctype = resp.getheader("Content-Type", "")
        if resp.getheader("Connection", "").lower() == "close":
            self.close()
        if ctype.startswith("application/json"):
            try:
                parsed = json.loads(raw) if raw else {}
            except ValueError:
                parsed = {"raw": raw.decode("utf-8", "replace")}
        else:
            parsed = raw
        return resp.status, dict(resp.getheaders()), parsed

    def _checked(self, method: str, path: str, body=None,
                 headers: Optional[dict] = None) -> dict:
        status, hdrs, parsed = self._request(method, path, body, headers)
        if status != 200:
            err = EdgeError(status, parsed if isinstance(parsed, dict)
                            else None)
            ra = {k.lower(): v for k, v in hdrs.items()}.get(
                "retry-after")
            if ra is not None:
                try:
                    err.retry_after_s = int(ra)
                except ValueError:
                    pass
            raise err
        return parsed

    # ------------------------------------------------------------ endpoints
    def healthz(self) -> dict:
        status, _hdrs, parsed = self._request("GET", "/healthz")
        if not isinstance(parsed, dict):
            raise EdgeError(status, message="healthz returned non-JSON")
        parsed["_status"] = status
        return parsed

    def metrics_text(self) -> str:
        status, _hdrs, parsed = self._request("GET", "/metrics")
        if status != 200:
            raise EdgeError(status, parsed if isinstance(parsed, dict)
                            else None)
        return (parsed if isinstance(parsed, str)
                else bytes(parsed).decode("utf-8"))

    def specialize(self, betas) -> str:
        out = self._checked("POST", "/v1/specialize",
                            {"betas": proto.encode_array(betas)})
        return out["subject"]

    def forward(self, pose, shape=None, subject: Optional[str] = None,
                *, priority: int = 0,
                deadline_s: Optional[float] = None) -> np.ndarray:
        """One-shot forward through the wire; mirrors
        ``ServingEngine.forward``. Raises ``EdgeError`` with the
        server's structured kind (shed -> status 429 with
        ``retry_after_s`` populated)."""
        body = {"pose": proto.encode_array(pose)}
        if shape is not None:
            body["shape"] = proto.encode_array(shape)
        if subject is not None:
            body["subject"] = subject
        headers = {proto.PRIORITY_HEADER: str(int(priority))}
        if deadline_s is not None:
            headers[proto.DEADLINE_HEADER] = repr(float(deadline_s))
        out = self._checked("POST", "/v1/forward", body, headers)
        return proto.decode_array(out["verts"])

    # -------------------------------------------------------------- streams
    def open_stream(self, *, subject: Optional[str] = None,
                    betas=None, frame_deadline_s: Optional[float] = None,
                    idle_timeout_s: Optional[float] = None,
                    resume_pose=None, **open_kw) -> "EdgeStreamClient":
        """Open a stream over a DEDICATED upgraded connection
        (the session is connection-affine; this client's one-shot
        connection stays usable beside it). ``resume_pose`` warm-starts
        the tracker — a migration handoff over the wire."""
        return EdgeStreamClient(
            self.host, self.port, timeout_s=self.timeout_s,
            subject=subject, betas=betas,
            frame_deadline_s=frame_deadline_s,
            idle_timeout_s=idle_timeout_s, resume_pose=resume_pose,
            **open_kw)


class EdgeStreamClient:
    """One upgraded stream connection: open -> frame* -> close.

    ``abort()`` hard-closes the socket mid-stream — the disconnect the
    server must answer with ``future.cancel()`` + session close (the
    edge drill's disconnect leg drives exactly this)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0,
                 subject: Optional[str] = None, betas=None,
                 frame_deadline_s: Optional[float] = None,
                 idle_timeout_s: Optional[float] = None,
                 resume_pose=None, **open_kw):
        if (subject is None) == (betas is None):
            raise ValueError("pass exactly one of subject= / betas=")
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._rfile = self._sock.makefile("rb")
        try:
            self._sock.sendall(
                (f"POST /v1/stream HTTP/1.1\r\n"
                 f"Host: {host}:{port}\r\n"
                 f"Upgrade: {proto.STREAM_UPGRADE}\r\n"
                 f"Connection: Upgrade\r\n"
                 f"Content-Length: 0\r\n\r\n").encode("latin-1"))
            status_line = self._rfile.readline()
            if not status_line.startswith(b"HTTP/1.1 101"):
                raise EdgeError(0, message=f"stream upgrade refused: "
                                           f"{status_line!r}")
            while True:                 # drain the 101 headers
                h = self._rfile.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            msg = {"op": "open"}
            if subject is not None:
                msg["subject"] = subject
            else:
                msg["betas"] = proto.encode_array(betas)
            if frame_deadline_s is not None:
                msg["frame_deadline_s"] = frame_deadline_s
            if idle_timeout_s is not None:
                msg["idle_timeout_s"] = idle_timeout_s
            if resume_pose is not None:
                msg["resume_pose"] = proto.encode_array(resume_pose)
            msg.update(open_kw)
            reply = self._roundtrip(msg)
            if "error" in reply:
                raise EdgeError(0, reply,
                                message=f"stream open refused: "
                                        f"{reply['error']}")
            self.stream_id = reply.get("stream_id")
            self.subject = reply.get("subject")
        except BaseException:
            self.abort()
            raise

    def _roundtrip(self, msg: dict) -> dict:
        self._sock.sendall(proto.dumps(msg) + b"\n")
        line = self._rfile.readline()
        if not line:
            raise EdgeError(0, message="stream connection closed by "
                                       "the server")
        return json.loads(line)

    def frame(self, target, *,
              deadline_s: Optional[float] = None) -> FrameReply:
        """One frame through the wire; raises ``EdgeError`` carrying
        the per-frame structured kind (shed/expired keep the stream
        open — retry or close is the caller's call)."""
        msg = {"op": "frame", "target": proto.encode_array(target)}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        reply = self._roundtrip(msg)
        if "error" in reply:
            raise EdgeError(0, reply,
                            message=f"frame failed: {reply['error']}")
        return FrameReply(
            pose=proto.decode_array(reply["pose"]),
            verts=proto.decode_array(reply["verts"]),
            fit_loss=float(reply["fit_loss"]),
            frame=int(reply["frame"]),
        )

    def close(self) -> Optional[dict]:
        """Protocol close (the polite path); returns the server's
        closed event, or None if the socket is already gone."""
        try:
            reply = self._roundtrip({"op": "close"})
        except (EdgeError, OSError, ValueError):
            reply = None
        self.abort()
        return reply

    def abort(self) -> None:
        """Hard-close the socket WITHOUT the close op — the abrupt
        client disappearance the server's disconnect handler exists
        for. ``shutdown`` first: a bare ``close()`` on a socket with a
        live ``makefile`` only drops an io-ref (no FIN reaches the
        server), and it also unblocks a sibling thread parked in
        ``frame()``'s readline."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self._rfile.close, self._sock.close):
            try:
                closer()
            except OSError:
                pass

    def __enter__(self) -> "EdgeStreamClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ResilientStream:
    """Reconnect-and-resume stream client: the last-confirmed-pose
    protocol applied at the CLIENT edge.

    Nothing on the server side survives the death of the process that
    holds the socket — the socket dies and the session's state dies
    with it. This wrapper keeps that state (the original open
    identity, the last CONFIRMED pose, the confirmed-frame count) on
    the client side and, when the transport dies mid-op, reconnects to
    the SAME host:port (a stable service port), re-opens with
    ``resume_pose=<last confirmed pose>``, and re-sends the in-flight
    frame. Re-sending is safe because the lost reply never reached us
    (one reply line per op, strictly ordered), and a deterministic fit
    warm-started from the
    same confirmed pose re-derives the SAME result. Frame numbers stay
    continuous: the resumed session counts from 0 again and every
    reply gets the confirmed-count offset added.

    Reconnects are BOUNDED (attempt cap + deadline + doubling
    backoff) and classified: a transport death retries, a structured
    server refusal (shed/expired/bad request) raises immediately —
    the stream is alive and the refusal is the caller's business.
    """

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0,
                 subject: Optional[str] = None, betas=None,
                 max_reconnects: int = 8,
                 reconnect_backoff_s: float = 0.1,
                 reconnect_timeout_s: float = 30.0,
                 **open_kw):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self._subject = subject
        self._betas = betas
        self._open_kw = dict(open_kw)
        self.max_reconnects = int(max_reconnects)
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self.reconnect_timeout_s = float(reconnect_timeout_s)
        self.reconnects = 0             # successful session re-opens
        self._last_pose: Optional[np.ndarray] = None
        self._frames_confirmed = 0
        self._offset = 0
        self._stream = self._dial(resume=False)

    # ----------------------------------------------------------- plumbing
    def _dial(self, *, resume: bool) -> EdgeStreamClient:
        kw = dict(self._open_kw)
        if resume and self._last_pose is not None:
            kw["resume_pose"] = self._last_pose
        return EdgeStreamClient(
            self.host, self.port, timeout_s=self.timeout_s,
            subject=self._subject, betas=self._betas, **kw)

    def _reconnect(self, cause: BaseException) -> None:
        """Bounded re-dial of the SAME address with resume state; on
        exhaustion raises an ``EdgeError`` that names both the
        original death and the last reconnect failure."""
        try:
            self._stream.abort()
        except Exception:  # noqa: BLE001 — already dead
            pass
        import time

        deadline = time.monotonic() + self.reconnect_timeout_s
        delay = self.reconnect_backoff_s
        attempt = 0
        last: BaseException = cause
        while True:
            attempt += 1
            try:
                self._stream = self._dial(resume=True)
                break
            except (EdgeError, OSError, ConnectionError,
                    ValueError) as e:
                last = e
                if (attempt >= self.max_reconnects
                        or time.monotonic() >= deadline):
                    raise EdgeError(0, message=(
                        f"stream lost ({type(cause).__name__}: {cause})"
                        f" and reconnect exhausted after {attempt} "
                        f"attempt(s): {type(last).__name__}: {last}"
                    )) from cause
                time.sleep(min(delay,
                               max(0.0, deadline - time.monotonic())))
                delay *= 2.0
        self._offset = self._frames_confirmed
        self.reconnects += 1

    # ------------------------------------------------------------- surface
    @property
    def stream_id(self):
        return self._stream.stream_id

    @property
    def subject(self):
        return self._stream.subject

    def frame(self, target, *,
              deadline_s: Optional[float] = None) -> FrameReply:
        msg = {"op": "frame", "target": proto.encode_array(target)}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        while True:
            try:
                # _roundtrip raises ONLY on transport death (closed
                # socket / timeout / torn line); structured refusals
                # come back as a reply dict and are never retried.
                reply = self._stream._roundtrip(msg)
                break
            except (EdgeError, OSError, ConnectionError,
                    ValueError) as e:
                self._reconnect(e)      # raises when exhausted
        if "error" in reply:
            raise EdgeError(0, reply,
                            message=f"frame failed: {reply['error']}")
        out = FrameReply(
            pose=proto.decode_array(reply["pose"]),
            verts=proto.decode_array(reply["verts"]),
            fit_loss=float(reply["fit_loss"]),
            frame=int(reply["frame"]) + self._offset,
        )
        self._last_pose = out.pose
        self._frames_confirmed = out.frame + 1
        return out

    def close(self) -> Optional[dict]:
        reply = self._stream.close()
        if isinstance(reply, dict) and "frames" in reply:
            reply["frames"] = int(reply["frames"]) + self._offset
        return reply

    def abort(self) -> None:
        self._stream.abort()

    def __enter__(self) -> "ResilientStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
