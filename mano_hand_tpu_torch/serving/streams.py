"""Streaming sessions: per-user hand tracking as a served workload.

The port of the JAX package's ``serving/streams.py``.
``ServingEngine.open_stream(subject)`` returns a session-affine handle
whose per-frame step composes the stack:

* **a frozen-shape LM fit** is the per-frame solve: the subject's betas
  are a known constant, so each frame fits the pose only, warm-started
  from the last converged pose through ``fitting/tracking.py:
  make_tracker``, on the engine's device;
* **cross-session coalescing**: the converged pose is served through
  ``engine.submit(pose, subject=key)`` — the gathered subject-table
  dispatch, K2 on a ``posed_kernel="fused"`` card engine — so concurrent
  streams' frames merge into mixed-subject batches, bit for bit the
  per-subject posed program;
* **tier-0 per-frame deadlines**: a frame carries one time to live over
  fit and dispatch; a frame already expired is swept BEFORE the fit, and
  the rest of the budget rides the engine's own deadline sweeps;
* **lifecycle spans**: each session carries a tracer span from ``open``
  to exactly one terminal — ``closed`` (client close), ``expired`` (idle
  past ``idle_timeout_s``), ``shed`` (admission refused the open) or
  ``shutdown`` (``engine.stop`` swept it) — while each frame rides the
  engine's own request span.

Chaos, failover and overload compose unchanged: the serving half of a
frame is an ordinary engine request and the fit runs before it, never
touching the chaos-wrapped programs, so a serving fault leaves the warm
start as the fit left it. Under the pipelined dispatch a frame's future
may resolve on a completion worker; frames of one session still resolve
in order (the stage delivers in launch order).

Locking: the ``StreamManager`` owns ONE lock over the registry and every
session's lifecycle fields, so ``snapshot()`` (the ``load()`` streams
block) is one lock-held copy. Each session's ``_fit_lock`` serializes
only its warm-start chain; the two are never nested, neither is held
across an engine lock, and span closes run outside the manager lock.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import NamedTuple, Optional

import numpy as np
import torch

from mano_hand_tpu_torch.serving.engine import ServingError

_UNSET = object()

#: Stream terminal kinds (``closed`` joins the engine's request kinds;
#: ``obs/trace.py:TERMINAL_KINDS``).
STREAM_TERMINAL_KINDS = ("closed", "expired", "shed", "shutdown")

#: The ``ServingEngine.load()["streams"]`` keys when no stream was ever
#: opened, in step with ``StreamManager.snapshot``.
EMPTY_SNAPSHOT = {
    "active": 0,
    "opened": 0,
    "frames_submitted": 0,
    "frames_resolved": 0,
    "frames_in_flight": 0,
    "backlog_age_s": 0.0,
    "closed_by_kind": {},
    "frames_by_kind": {},
}


def empty_snapshot() -> dict:
    """A FRESH empty streams block (its nested by-kind dicts are new, so
    a consumer mutating one load() result cannot corrupt the next)."""
    return {**EMPTY_SNAPSHOT, "closed_by_kind": {},
            "frames_by_kind": {}}


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _FrameFuture(Future):
    """The Future ``submit_frame`` hands out, its cancellation FORWARDED
    to the engine request's future: the engine's cancel bookkeeping fires
    (admission slot freed, request span closed ``cancelled``, the
    dispatch skips the work). A cancel landing before the engine request
    exists (the fit still runs) is honoured when it is attached."""

    def __init__(self):
        super().__init__()
        self._vfut: Optional[Future] = None
        self._vlock = threading.Lock()

    def _attach(self, vfut: Future) -> None:
        with self._vlock:
            self._vfut = vfut
            cancelled = self.cancelled()
        if cancelled:
            vfut.cancel()

    def cancel(self) -> bool:
        if not super().cancel():
            return False
        with self._vlock:
            vfut = self._vfut
        if vfut is not None:
            # Outside _vlock: the engine's hook does counter and span work.
            vfut.cancel()
        return True


class FrameResult(NamedTuple):
    """One resolved stream frame: the converged pose (the next frame's
    warm start) and the posed verts served through the gathered engine
    dispatch (bit for bit the per-subject posed program)."""

    pose: np.ndarray       # [J, 3] converged axis-angle pose
    verts: np.ndarray      # [V, 3] posed verts from the engine
    fit_loss: float        # final LM residual (frozen shape, pose only)
    frame: int             # 0-based frame index within the session


class StreamSession:
    """Session-affine handle over one subject's frame stream, built by
    ``ServingEngine.open_stream``. Frames of a session are serialized
    (the warm-start chain is causal); different sessions' frames run
    concurrently and their dispatches coalesce in the engine."""

    def __init__(self, manager: "StreamManager", stream_id: int,
                 subject: str, betas: np.ndarray, span, state, step,
                 frame_deadline_s: Optional[float],
                 idle_timeout_s: Optional[float]):
        self._mgr = manager
        self.stream_id = stream_id
        self.subject = subject          # the specialize() key
        self.betas = betas              # the frozen shape
        self.span = span                # the session's span id
        self.frame_deadline_s = frame_deadline_s
        self.idle_timeout_s = idle_timeout_s
        # The warm-start chain, guarded by _fit_lock.
        self._fit_lock = threading.Lock()
        self._state = state
        self._step = step
        # Lifecycle fields, guarded by the MANAGER's lock.
        self.terminal: Optional[str] = None
        self.last_activity = time.monotonic()
        self.inflight: dict = {}        # frame id -> submit t (monotonic)
        self.frames_submitted = 0
        self.frames_by_kind: dict = {}

    # ------------------------------------------------------------- frames
    @property
    def pose(self) -> np.ndarray:
        """The current warm start ([J, 3]): the last converged pose."""
        with self._fit_lock:
            return _host(self._state.pose)

    @property
    def frame(self) -> int:
        """Frames the tracker has consumed so far."""
        with self._fit_lock:
            return int(self._state.frame)

    def submit_frame(self, target, *, deadline_s=_UNSET) -> Future:
        """Fit one frame and serve its verts; returns a Future of a
        ``FrameResult``.

        The frozen-shape LM solve runs in the CALLING thread (under the
        session's fit lock, so concurrent submitters chain causally), then
        the converged pose goes through the engine's gathered pose-only
        path at tier 0 with what remains of the frame's deadline. Every
        outcome lands on the future — a ``FrameResult``, or a
        ``ServingError`` of kind ``shed``/``expired``/``error``/
        ``shutdown`` — except a frame sent to a stream already at a
        terminal, which raises here (kind ``shed``, phase ``stream``).
        Cancelling the future forwards to the engine request.
        """
        eng = self._mgr.engine
        if deadline_s is _UNSET:
            deadline_s = self.frame_deadline_s
        fid = self._mgr.admit_frame(self)   # raises if terminal
        tr = eng.tracer
        if tr is not None:
            tr.event(self.span, "frame", n=fid)
        fut: Future = _FrameFuture()
        deadline = (None if deadline_s is None
                    else time.monotonic() + float(deadline_s))
        loss = float("nan")
        try:
            with self._fit_lock:
                if deadline is None or time.monotonic() < deadline:
                    state, res = self._step(self._state, target)
                    # Read back INSIDE the lock: frame N+1 warm-starts
                    # from frame N's converged pose.
                    pose = _host(res.pose)
                    loss = float(_host(res.final_loss))
                    self._state = state
                else:
                    # Expired before the fit: no solver time is spent; the
                    # warm pose rides to the engine's born-expired path so
                    # the expiry is counted and span-closed there.
                    pose = _host(self._state.pose)
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            vfut = eng.submit(pose, subject=self.subject, priority=0,
                              deadline_s=remaining)
        except ServingError as e:
            # Admission shed (or a born-expired race): one channel for
            # every outcome.
            self._mgr.frame_done(self, fid, e.kind)
            fut.set_exception(e)
            return fut
        except BaseException as e:  # noqa: BLE001 — never strand a frame
            self._mgr.frame_done(self, fid, "error")
            fut.set_exception(e)
            return fut

        def _resolve(f, pose=pose, loss=loss, fid=fid):
            if f.cancelled():
                # The engine freed the slot and closed the request span
                # as ``cancelled``; mirror it on the frame and the ledger.
                fut.cancel()
                self._mgr.frame_done(self, fid, "cancelled")
                return
            exc = f.exception()
            try:
                if exc is None:
                    fut.set_result(FrameResult(
                        pose=pose, verts=f.result(), fit_loss=loss,
                        frame=fid))
                    kind = "ok"
                else:
                    fut.set_exception(exc)
                    kind = (exc.kind if isinstance(exc, ServingError)
                            else "error")
            except InvalidStateError:
                # Cancelled between the check and the resolution: the
                # result is discarded, the frame records the cancel.
                kind = "cancelled"
            self._mgr.frame_done(self, fid, kind)

        fut._attach(vfut)
        vfut.add_done_callback(_resolve)
        return fut

    def step(self, target, *, deadline_s=_UNSET) -> FrameResult:
        """Synchronous convenience: ``submit_frame(...).result()``."""
        return self.submit_frame(target, deadline_s=deadline_s).result()

    # ---------------------------------------------------------- lifecycle
    def close(self) -> bool:
        """Resolve this session's span with the ``closed`` terminal;
        False when it already reached a terminal (a double close is a
        no-op, never a double span close)."""
        return self._mgr.close(self, "closed")

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamManager:
    """Registry and lifecycle owner of an engine's stream sessions. One
    lock guards everything ``snapshot()`` reports; span closes run
    outside it."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._active: dict = {}         # stream id -> StreamSession
        # Sessions at a terminal with frames still in flight: visible to
        # snapshot() until those resolve, then dropped.
        self._draining: dict = {}
        # Set by shutdown() under the lock and checked by register(): an
        # open_stream racing or following engine.stop() is refused;
        # engine.start() reopens.
        self._stopped = False
        # Active sessions with an idle_timeout_s: the sweep's fast path.
        self._idle_sessions = 0
        self._next_id = 1
        self.opened = 0
        self.frames_submitted = 0
        self.frames_resolved = 0
        self.closed_by_kind: dict = {}
        self.frames_by_kind: dict = {}

    # ------------------------------------------------------------ opening
    def register(self, session_factory) -> StreamSession:
        """Allocate an id and register the session the factory builds
        (outside the lock). Raises ``ServingError(kind="shutdown")`` when
        the manager was swept by ``engine.stop()``, also by a stop landing
        between the two holds (the caller closes its span)."""
        with self._lock:
            if self._stopped:
                raise ServingError(
                    "engine stopped; open_stream refused (restart the "
                    "engine to open new streams)",
                    phase="stream", kind="shutdown")
            sid = self._next_id
            self._next_id += 1
        sess = session_factory(sid)
        with self._lock:
            if self._stopped:
                raise ServingError(
                    "engine stopped while this stream was opening; "
                    "open_stream refused (restart the engine)",
                    phase="stream", kind="shutdown")
            self._active[sid] = sess
            self.opened += 1
            if sess.idle_timeout_s is not None:
                self._idle_sessions += 1
        return sess

    def reopen(self) -> None:
        """``engine.start()``'s hook: new streams are accepted again
        (swept sessions stay terminal)."""
        with self._lock:
            self._stopped = False

    # ------------------------------------------------------------- frames
    def admit_frame(self, sess: StreamSession) -> int:
        """One frame's admission: sweeps idle sessions, then registers
        the frame in flight. Raises ``ServingError(kind="shed",
        phase="stream")`` when the session already reached a terminal."""
        self.sweep_idle()
        now = time.monotonic()
        with self._lock:
            if sess.terminal is not None:
                terminal = sess.terminal
            else:
                fid = sess.frames_submitted
                sess.frames_submitted += 1
                sess.inflight[fid] = now
                sess.last_activity = now
                self.frames_submitted += 1
                return fid
        raise ServingError(
            f"stream {sess.stream_id} is {terminal}; frames after a "
            "terminal are refused — open a new stream (the warm pose "
            "is available as session.pose)",
            phase="stream", kind="shed")

    def frame_done(self, sess: StreamSession, fid: int,
                   kind: str) -> None:
        with self._lock:
            sess.inflight.pop(fid, None)
            sess.last_activity = time.monotonic()
            self.frames_resolved += 1
            sess.frames_by_kind[kind] = sess.frames_by_kind.get(kind, 0) + 1
            self.frames_by_kind[kind] = self.frames_by_kind.get(kind, 0) + 1
            if sess.terminal is not None and not sess.inflight:
                self._draining.pop(sess.stream_id, None)

    # ---------------------------------------------------------- lifecycle
    def close(self, sess: StreamSession, kind: str) -> bool:
        """Move one session to a terminal exactly once: the first caller
        wins and closes the span, a repeat is a no-op."""
        with self._lock:
            if sess.terminal is not None:
                return False
            sess.terminal = kind
            self._active.pop(sess.stream_id, None)
            if sess.idle_timeout_s is not None:
                self._idle_sessions -= 1
            if sess.inflight:
                self._draining[sess.stream_id] = sess
            self.closed_by_kind[kind] = self.closed_by_kind.get(kind, 0) + 1
        tr = self.engine.tracer
        if tr is not None:
            tr.close(sess.span, kind, frames=sess.frames_submitted)
        return True

    def sweep_idle(self, now: Optional[float] = None) -> int:
        """Expire sessions idle past their ``idle_timeout_s``: swept at
        every frame admission and every ``snapshot()`` (the ``load()``
        polling path). Returns the number expired."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._idle_sessions == 0:
                return 0       # fast path: nothing can expire
            victims = [s for s in self._active.values()
                       if s.idle_timeout_s is not None
                       and now - s.last_activity >= s.idle_timeout_s]
        n = 0
        for s in victims:
            if self.close(s, "expired"):
                n += 1
        return n

    def shutdown(self) -> int:
        """``engine.stop``'s sweep: every open session reaches the
        ``shutdown`` terminal (span closed once); in-flight frames resolve
        through the engine's own sweeps; registrations are refused until
        ``engine.start()`` reopens."""
        with self._lock:
            self._stopped = True
            open_now = list(self._active.values())
        n = 0
        for s in open_now:
            if self.close(s, "shutdown"):
                n += 1
        return n

    # ------------------------------------------------------------ reading
    def snapshot(self) -> dict:
        """The ``load()`` streams block — active count, frame ledger and
        the backlog age (the oldest in-flight frame) — from ONE lock
        hold, after an idle sweep."""
        self.sweep_idle()
        now = time.monotonic()
        with self._lock:
            inflight = 0
            oldest = None
            for table in (self._active, self._draining):
                for s in table.values():
                    inflight += len(s.inflight)
                    for t0 in s.inflight.values():
                        if oldest is None or t0 < oldest:
                            oldest = t0
            return {
                "active": len(self._active),
                "opened": self.opened,
                "frames_submitted": self.frames_submitted,
                "frames_resolved": self.frames_resolved,
                "frames_in_flight": inflight,
                "backlog_age_s": (0.0 if oldest is None
                                  else max(0.0, now - oldest)),
                "closed_by_kind": dict(self.closed_by_kind),
                "frames_by_kind": dict(self.frames_by_kind),
            }


def open_stream(engine, subject, *, n_steps: int = 4,
                data_term: str = "joints", solver: str = "lm",
                frame_deadline_s: Optional[float] = None,
                idle_timeout_s: Optional[float] = None,
                resume_pose=None, **tracker_kw) -> StreamSession:
    """``ServingEngine.open_stream``'s body (see the method's docstring
    for the caller's contract)."""
    from mano_hand_tpu_torch.fitting import tracking
    from mano_hand_tpu_torch.serving.subject_store import subject_digest

    mgr = engine._stream_manager()
    # The subject as (key, betas). Betas are the natural identity (an
    # unknown subject bakes); an evicted key stays servable, its betas
    # outliving its table row.
    if isinstance(subject, str):
        with engine._lock:
            betas = engine._subject_betas.get(subject)
        if betas is None:
            raise ValueError(
                f"unknown subject {subject!r}; pass the betas array "
                "(open_stream bakes it) or a specialize() key")
        key = subject
        # Start a warm subject's promotion BEFORE the re-bake check: its
        # copy overlaps the open instead of stalling it.
        engine._prefetch_subject(key)
        engine.specialize(betas)    # refresh LRU; re-bake if evicted
    else:
        betas = np.ascontiguousarray(
            np.asarray(subject, np.float32).reshape(engine._n_shape))
        engine._prefetch_subject(subject_digest(betas))
        key = engine.specialize(betas)

    tr = engine.tracer
    span = tr.start("stream", tier=0) if tr is not None else None
    # Stream-open admission: under a bounded queue at the tier-0 quota
    # every frame would shed, so the OPEN sheds instead (advisory: frame
    # admission stays the hard bound).
    if engine.max_queued is not None:
        with engine._live_lock:
            outstanding = len(engine._live)
        quota = engine._quota(0)
        if outstanding >= quota:
            if tr is not None:
                tr.close(span, "shed")
            raise ServingError(
                f"stream open shed: {outstanding} outstanding >= tier-0 "
                f"quota {quota} — the engine is over capacity; poll "
                "load() and retry",
                phase="stream", kind="shed")

    try:
        state, step = tracking.make_tracker(
            engine._params, n_steps=n_steps, solver=solver,
            data_term=data_term, frozen_shape=betas,
            init_pose=resume_pose, **tracker_kw)

        def factory(sid: int) -> StreamSession:
            return StreamSession(
                mgr, sid, key, betas, span, state, step,
                frame_deadline_s=frame_deadline_s,
                idle_timeout_s=idle_timeout_s)

        sess = mgr.register(factory)
    except ServingError as e:
        # A stopped manager's refusal keeps its own terminal kind.
        if tr is not None:
            tr.close(span, e.kind)
        raise
    except BaseException:
        # A tracker-build error (a bad solver or tracker_kw) must not leak
        # the span it just opened.
        if tr is not None:
            tr.close(span, "error")
        raise
    if tr is not None:
        tr.event(span, "open", subject=key, stream=sess.stream_id)
    return sess
