"""Dynamic micro-batching server over the port's MANO forward.

Many small forward requests (per-frame trackers, per-user calls) arrive
with ragged row counts. The engine:

* **coalesces** pending requests on one dispatcher thread into one batch
  per dispatch, padded to the nearest power-of-two bucket
  (``serving/buckets.py``), and slices the pad rows back out of the
  results;
* keeps **full** requests (pose + betas; the port's plain
  ``core.forward_batched``) and **pose-only** requests (a subject key
  from ``specialize``) in separate batches;
* serves pose-only batches from a device-resident ``core.SubjectTable``:
  every specialized subject is one table row, and a batch mixing
  subjects carries an int32 ``[B]`` row index, so different subjects
  share a dispatch. ``posed_kernel="fused"`` runs that batch through the
  CUDA kernel K2 (``core.forward_posed_gather_fused``), ``"xla"`` (the
  default, named after the JAX family it mirrors) through the plain
  ``core.forward_posed_gather``;
* grows the table by doubling up to ``max_subjects`` rows; beyond that
  the least-recently-used subject's row is reused (evicted). Betas stay
  registered, so an evicted subject re-bakes on its next dispatch;
* under a ``PrecisionPolicy`` (``serving/precision.py``), serves the
  pose-only requests of the tiers it names (``submit(priority=...)``)
  from the bf16 gathered family (``compute_dtype=torch.bfloat16``: K2's
  bf16 variant under ``posed_kernel="fused"``). A batch serves one
  precision family, never both; full requests and every request of an
  engine without a policy are f32.

**Resilience.** Pass a ``runtime.DispatchPolicy`` and every batch runs
SUPERVISED: each primary attempt on a disposable worker thread under a
deadline (a wedged kernel is abandoned, the batch retried or failed
over), bounded classified retries with backoff and jitter, and a circuit
breaker (``runtime.health.CircuitBreaker``: healthy -> degraded -> down,
with a killable re-probe of the card) gating **graceful degradation to
the CPU tier** on a ``device="cpu"`` engine: the plain
``core.forward_batched`` at the batch's bucket, off the chaos-wrapped
primary. A pose-only batch fails over by re-running the full forward with
each row's betas from the host registry. Failover results are bit for bit
a direct CPU ``core.forward_batched`` call at the same padded bucket.
Every failover is counted (``failovers``) and warned (``warnings.warn``).
A card engine has no CPU tier: it refuses a policy with ``cpu_fallback``
(pass ``DispatchPolicy(cpu_fallback=False)``), so its work never moves
off the card, and a batch whose supervision is exhausted there resolves
to its ``ServingError``. The readback (``.cpu().numpy()``) runs inside the supervised window, so
a wedged kernel cannot outlive its deadline. A batch whose supervision is
exhausted resolves to a ``ServingError`` and the dispatcher lives on; a
deterministic failure (a shape bug, a sticky CUDA fault) stays
engine-fatal. Faults reproduce on the CPU through ``runtime.chaos``
(the policy's ``chaos`` plan wraps the PRIMARY callables only).

**Admission.** ``max_queued`` bounds the outstanding requests (queued,
parked and in flight): a submit past a tier's quota raises
``ServingError(kind="shed")`` in microseconds, before the dispatcher or
the card is touched; tiers >= 1 shed at half the queue by default, so the
headroom above is tier 0's. ``submit(deadline_s=)`` gives a request its
time to live: it is swept as ``kind="expired"`` without a dispatch at
every boundary where that is still possible (submit, the queue head,
coalescing, launch, after the primary attempts) and at readback a late
result is discarded, never served stale. ``future.cancel()`` frees the
admission slot at once. ``load()`` is the backpressure signal to poll
before the hard shed. ``stop(timeout_s=)`` resolves EVERY outstanding
future with a structured ``ServingError(phase="shutdown")`` even when the
dispatcher is wedged in a device call.

Table updates are functional (``core.table_set_row`` returns a new
table), so a batch's ``(table, slots)`` snapshot stays valid while
submitters install subjects. The engine runs on ``cuda`` unless the
caller passes ``device="cpu"``.

Typical use::

    eng = ServingEngine(params, max_bucket=256, posed_kernel="fused")
    with eng:
        verts = eng.forward(pose_n16x3, shape_n10)      # [n, 778, 3]
        subj = eng.specialize(betas)                    # bake the shape stage
        fut = eng.submit(pose_n16x3, subject=subj)      # pose-only, async
        verts = fut.result()
    print(eng.counters.snapshot())
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import queue
import threading
import time
import warnings
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.runtime import supervise
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.serving.precision import BF16, F32, PrecisionPolicy
from mano_hand_tpu_torch.utils.profiling import ServingCounters

_SENTINEL = object()


class ServingError(RuntimeError):
    """Structured terminal failure of one serving request.

    The engine's guarantee is "a result or a ServingError, within the
    configured deadline" — never a hang. The fields say which guarantee
    fired:

    * ``kind``: ``"shed"`` — refused at admission (bounded queue / tier
      quota; host bookkeeping, no device involved — retry later, see
      ``ServingEngine.load``); ``"expired"`` — the request's own
      ``deadline_s`` passed before a result could be delivered;
      ``"error"`` — the dispatch failed after supervision was exhausted;
      ``"shutdown"`` — ``stop()`` found the request outstanding.
    * ``phase`` names where it fired (``"admission"``, ``"coalesce"``,
      ``"dispatch"``, ``"failover"``, ``"readback"``, ``"shutdown"``);
      ``attempts`` counts primary tries; ``cause`` is the last underlying
      exception, if any.
    """

    def __init__(self, message: str, *, phase: str = "dispatch",
                 kind: Optional[str] = None, attempts: int = 0, cause=None):
        super().__init__(message)
        self.phase = phase
        self.kind = kind if kind is not None else (
            "shutdown" if phase == "shutdown" else "error")
        self.attempts = attempts
        self.cause = cause


def build_cpu_fallback_executable(params_cpu, bucket: int, n_joints: int,
                                  n_shape: int) -> Callable:
    """The graceful-degradation callable of one bucket: the plain
    ``core.forward_batched`` on float32 params on the CPU (a CPU
    engine's own), returning host verts. The same function as the full family's primary,
    so failover results match a direct CPU ``core.forward_batched`` call
    at the same padded bucket bit for bit. Never chaos-wrapped (the
    fallback is the clean path failover is measured against); warmed once
    with a zero batch."""

    def run(pose: np.ndarray, shape: np.ndarray) -> np.ndarray:
        # C-ordered copies: a broadcast shape row (stride 0) would take
        # another CPU matmul path and round differently.
        pose, shape = (torch.from_numpy(np.array(x, np.float32, order="C"))
                       for x in (pose, shape))
        with torch.no_grad():
            return core.forward_batched(params_cpu, pose, shape).verts.numpy()

    run(np.zeros((bucket, n_joints, 3), np.float32),
        np.zeros((bucket, n_shape), np.float32))
    return run


class _CancellableFuture(Future):
    """The Future ``submit`` hands out, with caller-initiated cancellation
    wired back into the engine.

    The engine never calls ``set_running_or_notify_cancel``, so a
    request's future stays PENDING until its terminal resolution — a
    ``cancel()`` before that succeeds, flips the future to CANCELLED
    (``result()`` raises ``CancelledError``), and fires the engine hook
    EXACTLY once: the admission slot frees immediately. A queued or
    parked cancelled request is skipped by every dispatch boundary (never
    batched); one already in flight completes on the device but its
    result is discarded at delivery. ``cancel()`` after any resolution
    returns False, the stdlib contract.
    """

    def __init__(self, on_cancel: Callable[[], None]):
        super().__init__()
        self._on_cancel = on_cancel
        self._cancel_notified = False

    def cancel(self) -> bool:
        if not super().cancel():
            return False
        hook = None
        # Future's own condition doubles as the once-guard: stdlib
        # cancel() returns True again on an already-cancelled future, but
        # the engine-side bookkeeping must fire exactly once.
        with self._condition:
            if not self._cancel_notified:
                self._cancel_notified = True
                hook = self._on_cancel
        if hook is not None:
            hook()
        return True


class _Request:
    __slots__ = ("pose", "shape", "rows", "squeeze", "subject", "tier",
                 "deadline", "future")

    def __init__(self, pose, shape, rows, squeeze, subject, tier=0,
                 deadline=None):
        self.pose = pose            # [n, J, 3] float32
        self.shape = shape          # [n, S] float32, None on the pose-only path
        self.rows = rows
        self.squeeze = squeeze      # caller passed one [J, 3] pose
        self.subject = subject      # subject key, or None (full path)
        self.tier = tier            # admission tier (0 = interactive)
        self.deadline = deadline    # absolute time.monotonic() or None
        self.future: Future = Future()


class ServingEngine:
    """Micro-batching forward server over one parameter set.

    Parameters
    ----------
    params: ``ManoParams`` (any float dtype and device; served as float32
        on ``device``).
    device: where the engine computes; default ``cuda`` (raises when CUDA
        is absent — pass ``device="cpu"`` to serve on the CPU).
    min_bucket/max_bucket: power-of-two bucket range; a request larger
        than ``max_bucket`` rows is rejected at ``submit``.
    max_delay_s: how long the dispatcher waits for more requests once it
        holds one (the latency/throughput knob).
    max_subjects: subject-table capacity ceiling (growth by doubling
        below it, LRU eviction at it).
    posed_kernel: ``"xla"`` (plain ``core.forward_posed_gather``) or
        ``"fused"`` (the K2 CUDA kernel; its plain version on the CPU).
    precision_policy: a ``PrecisionPolicy`` naming the tiers whose
        pose-only requests serve the bf16 family, or None (all f32).
    policy: a ``runtime.DispatchPolicy`` enabling supervised dispatch
        (per-batch deadline, classified retries with backoff, circuit-
        breaker-gated CPU failover, optional chaos injection). None (the
        default) keeps the unsupervised path: no worker threads, and a
        failed batch stops the dispatcher. On a card its ``cpu_fallback``
        must be False: the CPU tier serves ``device="cpu"`` engines only.
        A breaker's default probe (``health.device_probe``) checks card 0;
        an engine on another card passes ``probe=lambda:
        device_probe(index=i)``.
    max_queued: bounded admission. None (the default) keeps the queue
        unbounded; an int caps OUTSTANDING requests (submitted, not yet
        resolved), and a submit past a tier's quota raises
        ``ServingError(kind="shed")`` without touching the device.
    tier_quotas: per-priority thresholds over the shared outstanding
        count, e.g. ``{1: 16}`` (requires ``max_queued``). Defaults: tier
        0 may fill the whole queue, tiers >= 1 half of it. Clamped to
        ``max_queued``.
    busy_fraction: ``load()`` reports a tier "busy" once outstanding
        crosses this fraction of its quota, before hard shedding.
    """

    # Capacity the subject table starts at (clamped to max_subjects).
    _TABLE_INIT_CAPACITY = 8

    def __init__(self, params, *, device=None, min_bucket: int = 1,
                 max_bucket: int = 1024, max_delay_s: float = 0.002,
                 max_subjects: int = 4096, posed_kernel: str = "xla",
                 precision_policy: Optional[PrecisionPolicy] = None,
                 policy=None, max_queued: Optional[int] = None,
                 tier_quotas: Optional[dict] = None,
                 busy_fraction: float = 0.75):
        if posed_kernel not in ("xla", "fused"):
            raise ValueError(
                f"posed_kernel must be 'xla' or 'fused', got "
                f"{posed_kernel!r}")
        if precision_policy is not None and not isinstance(
                precision_policy, PrecisionPolicy):
            raise TypeError(
                f"precision_policy must be a serving.precision."
                f"PrecisionPolicy, got {type(precision_policy).__name__}")
        if max_subjects < 1:
            raise ValueError(f"max_subjects must be >= 1, got {max_subjects}")
        if max_queued is not None and max_queued < 0:
            raise ValueError(
                f"max_queued must be >= 0 (0 sheds everything), got "
                f"{max_queued}")
        if tier_quotas is not None and max_queued is None:
            raise ValueError(
                "tier_quotas require max_queued (quotas are thresholds "
                "over the bounded outstanding count)")
        for t, q in (tier_quotas or {}).items():
            if t < 0 or q < 0:
                raise ValueError(
                    f"tier_quotas entries must be non-negative, got "
                    f"{{{t}: {q}}}")
        if not 0.0 < busy_fraction <= 1.0:
            raise ValueError(
                f"busy_fraction must be in (0, 1], got {busy_fraction}")
        self.device = resolve_device(device)
        if (self.device.type != "cpu" and policy is not None
                and policy.cpu_fallback):
            raise ValueError(
                "the CPU tier serves device='cpu' engines only: a card "
                "engine's work never moves to the host. Pass "
                "DispatchPolicy(cpu_fallback=False); an exhausted batch "
                "then resolves to its ServingError")
        if self.device.type == "cuda" and self.device.index is None:
            # Pinned to an index: supervision runs each attempt on a fresh
            # thread, whose current device is not the caller's.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._policy = policy
        self._params = params.astype(torch.float32).to(self.device)
        self._n_joints = params.n_joints
        self._n_shape = params.n_shape
        self.buckets = bucket_mod.bucket_sizes(min_bucket, max_bucket)
        self.max_delay_s = float(max_delay_s)
        self.max_subjects = int(max_subjects)
        self._posed_kernel = posed_kernel
        self._precision_policy = precision_policy
        self.max_queued = None if max_queued is None else int(max_queued)
        self._tier_quotas = dict(tier_quotas or {})
        self.busy_fraction = float(busy_fraction)
        self.counters = ServingCounters()
        # The primary callables; under a chaos plan each consults it (one
        # plan-wide call index across both families). The CPU tier is
        # never wrapped.
        self._primary_full = self._run_full
        self._primary_posed = self._run_posed
        if policy is not None and policy.chaos is not None:
            self._primary_full = policy.chaos.wrap(
                self._run_full, on_fault=self.counters.count_fault)
            self._primary_posed = policy.chaos.wrap(
                self._run_posed, on_fault=self.counters.count_fault)
        self._cpu_exes: dict = {}          # bucket -> CPU-tier callable
        # _lock guards the subject maps and the live table reference;
        # _install_lock serializes table installs so the functional row
        # write runs outside _lock (lock order: _install_lock -> _lock).
        self._lock = threading.Lock()
        self._install_lock = threading.Lock()
        self._table: Optional[core.SubjectTable] = None
        self._subject_slots: dict = {}     # subject key -> table row
        self._subject_lru = collections.OrderedDict()  # key -> None
        self._subject_betas: dict = {}     # key -> host [S] betas, never evicted
        self._next_slot = 0                # first never-used row
        self._queue: queue.Queue = queue.Queue()
        # Requests _coalesce could not add to the batch it was building
        # (other path kind, bucket overflow, too many subjects); they lead
        # the next batches. Owned by the dispatcher thread.
        self._pending: collections.deque = collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._running = False
        self._failure: Optional[BaseException] = None
        # EVERY unresolved request, from submit to resolution: the
        # shutdown sweep resolves these even when the dispatcher is wedged
        # in a device call it will never return from. The admission
        # decision reads and writes it under _live_lock.
        self._live: dict = {}
        self._live_lock = threading.Lock()

    @property
    def posed_kernel(self) -> str:
        return self._posed_kernel

    @property
    def precision_policy(self) -> Optional[PrecisionPolicy]:
        return self._precision_policy

    @property
    def table(self) -> Optional[core.SubjectTable]:
        """The current subject table (a snapshot: updates replace it)."""
        with self._lock:
            return self._table

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingEngine":
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                # A fresh dispatcher is a fresh chance: a previous crash
                # no longer refuses work.
                self._failure = None
                self._running = True
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="mano-serving",
                    daemon=True)
                self._thread.start()
        return self

    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Serve everything already submitted, stop the dispatcher, and
        resolve EVERY future.

        ``timeout_s`` bounds the join: if the dispatcher does not exit in
        time (wedged in a device call, which nothing in-process can
        interrupt), the thread is ABANDONED (daemon) and every outstanding
        future resolves with ``ServingError(phase="shutdown")``. Default:
        a supervised engine with a deadline waits progress-aware — one
        per-batch window (deadline x attempts + grace) at a time, for as
        long as outstanding futures keep resolving; any other engine
        joins without a bound.
        """
        with self._thread_lock:
            thread = self._thread
            if thread is not None:
                self._running = False
                self._queue.put(_SENTINEL)
        if thread is not None:
            pol = self._policy
            if timeout_s is not None:
                thread.join(timeout_s)
            elif pol is not None and pol.deadline_s:
                per_batch = (pol.deadline_s * (pol.retries + 2)
                             + pol.backoff_cap_s * (pol.retries + 1) + 5.0)
                while True:
                    with self._live_lock:
                        before = len(self._live)
                    thread.join(per_batch)
                    if not thread.is_alive():
                        break
                    with self._live_lock:
                        after = len(self._live)
                    if after >= before:
                        # A whole window without one future resolved:
                        # wedged, not draining.
                        break
            else:
                thread.join()
            if thread.is_alive():
                err = ServingError(
                    "dispatcher wedged in a device call at stop() — thread "
                    "abandoned (a hung device call cannot be interrupted "
                    "in-process; see runtime/supervise.py)",
                    phase="shutdown")
                self._failure = err
                with self._thread_lock:
                    self._thread = None
                self._sweep_live(err)
                self._drain(err)
                # Parked requests were resolved by the sweep; drop the
                # stale objects so a restart does not re-dispatch them.
                self._pending.clear()
                # If the abandoned thread ever unwedges it must find a
                # sentinel and exit instead of blocking forever.
                self._queue.put(_SENTINEL)
                return
            with self._thread_lock:
                self._thread = None
        # A submit racing the shutdown can enqueue after the dispatcher's
        # own drain: nothing reads the queue now, so sweep it again, then
        # the registry (empty unless a crash path missed one).
        self._drain(self._failure)
        self._sweep_live(self._failure or ServingError(
            "serving engine stopped before this request was resolved",
            phase="shutdown"))

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- subjects
    def specialize(self, shape) -> str:
        """Bake one subject's betas into a table row; returns the subject
        key (a content hash of the float32 betas) for
        ``submit(pose, subject=key)``. Repeats are a dict hit."""
        shape = np.ascontiguousarray(
            np.asarray(shape, np.float32).reshape(self._n_shape))
        key = hashlib.sha256(shape.tobytes()).hexdigest()[:16]
        with self._lock:
            hit = key in self._subject_slots
            if hit:
                self._subject_lru.move_to_end(key)
        if hit:
            self.counters.count_specialize(hit=True)
            return key
        self._install_subject(key, shape)
        return key

    def _install_subject(self, key: str, betas: np.ndarray,
                         protected=()) -> int:
        """Bake ``betas`` and write them into a table row; returns the slot.

        Takes the next fresh row, else grows the table (doubling) while
        under ``max_subjects``, else evicts the least-recently-used
        subject not in ``protected`` (the subjects of the batch being
        resolved, so a batch never evicts its own members).
        """
        with torch.no_grad():
            shaped = core.specialize(
                self._params, torch.from_numpy(betas).to(self.device))
        with self._install_lock:
            grew = False
            with self._lock:
                if key in self._subject_slots:      # a racing install won
                    self._subject_lru.move_to_end(key)
                    return self._subject_slots[key]
                self._subject_betas.setdefault(key, betas)
                table = self._table
                cap = (table.capacity if table is not None
                       else min(self._TABLE_INIT_CAPACITY, self.max_subjects))
                if self._next_slot < cap:
                    slot = self._next_slot
                    self._next_slot += 1
                elif cap < self.max_subjects:
                    cap = min(self.max_subjects, cap * 2)
                    grew = True
                    slot = self._next_slot
                    self._next_slot += 1
                else:
                    victim = next((k for k in self._subject_lru
                                   if k not in protected), None)
                    if victim is None:
                        raise RuntimeError(
                            f"one batch references more live subjects than "
                            f"max_subjects={self.max_subjects} table rows")
                    slot = self._subject_slots.pop(victim)
                    del self._subject_lru[victim]
                    self.counters.count_evict()
            with torch.no_grad():
                if table is None:
                    table = core.subject_table(self._params, cap)
                elif grew:
                    table = core.table_grow(table, cap)
                    self.counters.count_table_growth()
                table = core.table_set_row(table, slot, shaped)
            with self._lock:
                self._table = table
                self._subject_slots[key] = slot
                self._subject_lru[key] = None
        self.counters.count_specialize(hit=False)
        return slot

    def _resolve_batch(self, reqs):
        """(table snapshot, per-request slots) of a pose-only batch, from
        one locked read; re-bakes any subject evicted while queued."""
        keys = {r.subject for r in reqs}
        for _ in range(len(keys) + 2):
            with self._lock:
                missing = [k for k in keys if k not in self._subject_slots]
                if not missing:
                    for k in keys:
                        self._subject_lru.move_to_end(k)
                    return (self._table,
                            [self._subject_slots[r.subject] for r in reqs])
                betas = {k: self._subject_betas[k] for k in missing}
            for k, b in betas.items():
                self._install_subject(k, b, protected=keys)
        raise RuntimeError(
            "could not pin this batch's subjects into the table; "
            "max_subjects is too small for the live working set")

    # ------------------------------------------------------------ admission
    def _quota(self, tier: int) -> int:
        """Outstanding-count threshold at which tier ``tier`` sheds. Tier
        0 defaults to the whole queue, lower-priority tiers to half of it
        — the gap is tier 0's reserved headroom."""
        q = self._tier_quotas.get(tier)
        if q is None:
            q = self.max_queued if tier <= 0 else self.max_queued // 2
        return min(q, self.max_queued)

    def set_admission(self, *, max_queued: Optional[int] = None,
                      tier_quotas: Optional[dict] = None) -> dict:
        """Retune bounded admission live: swap ``max_queued`` and/or
        ``tier_quotas`` in ONE ``_live_lock`` hold — the lock ``submit``
        decides admission under, so a concurrent submitter sees the old
        pair or the new one, never a mix. Boundedness itself is chosen at
        construction: an unbounded engine refuses. Returns ``{"before",
        "after"}``."""
        if self.max_queued is None:
            raise ValueError(
                "set_admission requires an engine built with bounded "
                "admission (max_queued=N); boundedness is a "
                "construction-time choice")
        if max_queued is not None and int(max_queued) < 0:
            raise ValueError(
                f"max_queued must be >= 0 (0 sheds everything), got "
                f"{max_queued}")
        for t, q in (tier_quotas or {}).items():
            if t < 0 or q < 0:
                raise ValueError(
                    f"tier_quotas entries must be non-negative, got "
                    f"{{{t}: {q}}}")
        with self._live_lock:
            before = {"max_queued": self.max_queued,
                      "tier_quotas": dict(self._tier_quotas)}
            if max_queued is not None:
                self.max_queued = int(max_queued)
            if tier_quotas is not None:
                self._tier_quotas = {int(t): int(q)
                                     for t, q in tier_quotas.items()}
            after = {"max_queued": self.max_queued,
                     "tier_quotas": dict(self._tier_quotas)}
        return {"before": before, "after": after}

    def load(self) -> dict:
        """The backpressure signal: a point-in-time load snapshot to poll
        BEFORE submitting. Per tier under ``admission``: ``"ok"``,
        ``"busy"`` (outstanding has crossed ``busy_fraction`` of the
        tier's quota — back off now) or ``"shed"`` (a submit now would
        raise ``ServingError(kind="shed")``); empty when admission is
        unbounded. ``precision`` (under a ``PrecisionPolicy``) names each
        tier's family and the stated envelope."""
        # The tier states derive inside the SAME hold that reads the
        # outstanding count (and that set_admission swaps the quotas
        # under): they always describe one instant.
        with self._live_lock:
            outstanding = len(self._live)
            max_queued = self.max_queued
            tiers = {}
            if max_queued is not None:
                for t in sorted({0, 1} | set(self._tier_quotas)):
                    q = self._quota(t)
                    if outstanding >= q:
                        state = "shed"
                    elif outstanding >= self.busy_fraction * q:
                        state = "busy"
                    else:
                        state = "ok"
                    tiers[str(t)] = state
        out = {
            "outstanding": outstanding,
            "queued": self._queue.qsize() + len(self._pending),
            "max_queued": max_queued,
            "admission": tiers,
            "backlog_peak": self.counters.backlog_peak,
        }
        if self._precision_policy is not None:
            pol = self._precision_policy
            out["precision"] = {
                "envelope_m": pol.max_vertex_err_m,
                "accumulate": pol.accumulate,
                "tiers": pol.tiers_snapshot((0, 1, *self._tier_quotas)),
            }
        return out

    # ------------------------------------------------------------ deadlines
    def _is_expired(self, req: _Request, now: Optional[float] = None,
                    ) -> bool:
        return (req.deadline is not None
                and (time.monotonic() if now is None else now)
                >= req.deadline)

    def _expire(self, req: _Request, phase: str) -> None:
        """Resolve one request as ``kind="expired"`` — the sweep that
        keeps device time off results nobody will read. Counted once: a
        second sweep of a resolved future is a no-op."""
        if self._set_exception_safe(req, ServingError(
                f"request expired before {phase} (deadline_s elapsed "
                f"{time.monotonic() - req.deadline:.3g}s ago); a stale "
                "result would not be read, so none was produced",
                phase=phase, kind="expired")):
            self.counters.count_expired(req.tier)
        self._deregister(req)

    # ------------------------------------------------------------- requests
    def submit(self, pose, shape=None, subject: Optional[str] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               ) -> Future:
        """Enqueue one forward request; returns a Future of the verts.

        ``pose`` is [n, J, 3] (the Future resolves to [n, V, 3] float32)
        or one [J, 3] (resolves to [V, 3]). ``shape`` is [n, S] or [S]
        (default zeros). ``subject`` (a key from ``specialize``) routes
        the request down the pose-only path instead; ``shape`` must then
        be omitted.

        ``priority`` is the admission tier (0 = interactive, >= 1 =
        batch): under a bounded queue (``max_queued``) overload sheds
        high-numbered tiers first, raising ``ServingError(kind="shed")``
        HERE without touching the device; under a ``precision_policy``
        it also selects a pose-only request's precision family.
        ``deadline_s`` is the request's time to live: past it the request
        resolves to ``ServingError(kind="expired")`` instead of a result,
        swept without a dispatch wherever the expiry is seen first; an
        already-expired deadline resolves the returned future at once.
        """
        pose = np.asarray(pose, np.float32)
        squeeze = pose.ndim == 2
        if squeeze:
            pose = pose[None]
        if pose.ndim != 3 or pose.shape[1:] != (self._n_joints, 3):
            raise ValueError(
                f"pose must be [n, {self._n_joints}, 3] or "
                f"[{self._n_joints}, 3], got {pose.shape}")
        n = pose.shape[0]
        if n < 1:
            raise ValueError("request must have at least one row")
        if n > self.buckets[-1]:
            raise ValueError(
                f"request of {n} rows exceeds the largest bucket "
                f"{self.buckets[-1]}; chunk it or raise max_bucket")
        if subject is not None:
            if shape is not None:
                raise ValueError(
                    "pass either shape (full path) or subject (pose-only "
                    "path), not both — the subject IS the baked shape")
            with self._lock:
                known = subject in self._subject_betas
                if subject in self._subject_lru:
                    self._subject_lru.move_to_end(subject)
            if not known:
                raise ValueError(
                    f"unknown subject {subject!r}; call specialize(betas) "
                    "first")
        elif shape is None:
            shape = np.zeros((n, self._n_shape), np.float32)
        else:
            shape = np.asarray(shape, np.float32)
            if shape.ndim == 1:
                shape = np.broadcast_to(shape[None], (n, self._n_shape))
            if shape.shape != (n, self._n_shape):
                raise ValueError(
                    f"shape must be [{n}, {self._n_shape}] to match pose, "
                    f"got {shape.shape}")
        tier = int(priority)
        if tier < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        if self._failure is not None:
            raise RuntimeError(
                "serving engine dispatcher died") from self._failure
        self.counters.count_tier_submit(tier)
        deadline = (None if deadline_s is None
                    else time.monotonic() + float(deadline_s))
        req = _Request(pose, shape, n, squeeze, subject, tier, deadline)
        req.future = _CancellableFuture(lambda: self._on_cancel(req))
        if deadline is not None and float(deadline_s) <= 0:
            # Born expired: no registration, no queue slot, no dispatch.
            self._expire(req, "admission")
            return req.future
        if self.max_queued is not None:
            # The admission check is ATOMIC with registration (one
            # _live_lock hold): two submitters cannot both take the last
            # slot. Dict bookkeeping only — no device.
            with self._live_lock:
                quota = self._quota(tier)
                outstanding = len(self._live)
                admitted = outstanding < quota
                if admitted:
                    self._live[id(req)] = req
                    outstanding += 1
            if not admitted:
                self.counters.count_shed(tier)
                raise ServingError(
                    f"admission shed: {outstanding} outstanding >= "
                    f"tier-{tier} quota {quota} "
                    f"(max_queued={self.max_queued}); the engine is "
                    "over capacity for this priority class — poll "
                    "load() and retry later",
                    phase="admission", kind="shed")
            self.counters.observe_backlog(outstanding)
        else:
            self.counters.observe_backlog(self._register(req))
        self.start()
        self._queue.put(req)
        if self._failure is not None:
            # The dispatcher died between the check above and the put:
            # nothing reads the queue any more.
            self._drain(self._failure)
            raise RuntimeError(
                "serving engine dispatcher died") from self._failure
        return req.future

    def forward(self, pose, shape=None, subject: Optional[str] = None, *,
                priority: int = 0,
                deadline_s: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(pose, shape, subject=subject, priority=priority,
                           deadline_s=deadline_s).result()

    def warmup(self, bucket_list: Optional[Sequence[int]] = None) -> dict:
        """Run one zero batch of the full family per bucket (first-use
        work: kernel builds, allocator growth) outside any request's
        latency — and of the CPU tier too under a policy with
        ``cpu_fallback``, so the first failover does not pay it during
        the outage. Returns {bucket: seconds}."""
        out = {}
        bucket_list = self._check_buckets(bucket_list)
        for b in bucket_list:
            t0 = time.perf_counter()
            self._run_full(np.zeros((b, self._n_joints, 3), np.float32),
                           np.zeros((b, self._n_shape), np.float32))
            out[b] = time.perf_counter() - t0
        if self._policy is not None and self._policy.cpu_fallback:
            for b in bucket_list:
                self._fallback_executable(b)
        return out

    def warmup_posed(self, bucket_list: Optional[Sequence[int]] = None,
                     ) -> dict:
        """``warmup`` for the pose-only family (needs one specialized
        subject, so the table exists) — and for the bf16 family too when
        the precision policy names a bf16 tier. Returns {bucket: seconds}
        over the families warmed."""
        table = self.table
        if table is None:
            raise RuntimeError(
                "warmup_posed needs a subject table: specialize() first")
        dtypes = [None]
        if self._precision_policy is not None \
                and self._precision_policy.bf16_tiers:
            dtypes.append(torch.bfloat16)
        out = {}
        for b in self._check_buckets(bucket_list):
            t0 = time.perf_counter()
            for dt in dtypes:
                self._run_posed(table, np.zeros((b,), np.int32),
                                np.zeros((b, self._n_joints, 3), np.float32),
                                dt)
            out[b] = time.perf_counter() - t0
        return out

    def _check_buckets(self, bucket_list):
        for b in bucket_list or self.buckets:
            if b not in self.buckets:
                raise ValueError(f"{b} is not one of {self.buckets}")
        return list(bucket_list or self.buckets)

    # ------------------------------------------------------------- dispatch
    def _on_device(self):
        """The engine's card as the current device: a supervised attempt
        runs on a fresh thread, whose current device is not ours."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_full(self, pose: np.ndarray, shape: np.ndarray) -> np.ndarray:
        with self._on_device(), torch.no_grad():
            verts = core.forward_batched(
                self._params, torch.from_numpy(pose).to(self.device),
                torch.from_numpy(shape).to(self.device)).verts
            return verts.cpu().numpy()

    def _run_posed(self, table, idx: np.ndarray, pose: np.ndarray,
                   compute_dtype=None) -> np.ndarray:
        with self._on_device(), torch.no_grad():
            idx_t = torch.from_numpy(idx).to(self.device)
            pose_t = torch.from_numpy(pose).to(self.device)
            if self._posed_kernel == "fused":
                verts = core.forward_posed_gather_fused(
                    table, idx_t, pose_t, compute_dtype=compute_dtype)
            else:
                verts = core.forward_posed_gather(
                    table, idx_t, pose_t, compute_dtype=compute_dtype).verts
            return verts.cpu().numpy()

    def _fallback_executable(self, bucket: int) -> Callable:
        """The CPU tier's callable of one bucket, built (and warmed) once;
        normally by ``warmup()``, lazily at a failover on a bucket never
        warmed."""
        with self._lock:
            exe = self._cpu_exes.get(bucket)
        if exe is None:
            exe = build_cpu_fallback_executable(
                self._params, bucket, self._n_joints, self._n_shape)
            with self._lock:
                exe = self._cpu_exes.setdefault(bucket, exe)
        return exe

    def _req_prec(self, req: _Request) -> str:
        """The precision family one request is served from: ``"bf16"``
        only for a pose-only request whose tier the policy names; full
        requests, and every request of a policy-less engine, are f32."""
        if self._precision_policy is None or req.subject is None:
            return F32
        return self._precision_policy.dtype_for_tier(req.tier)

    def _admit(self, nxt: _Request, posed: bool, subjects: set,
               rows: int, prec: str = F32) -> Optional[str]:
        """Why ``nxt`` cannot join the batch being built, or None:
        ``"kind"`` (full and pose-only never share a batch),
        ``"precision"`` (a batch serves one precision family),
        ``"overflow"`` (past the largest bucket) or ``"subjects"`` (one
        more distinct subject than the table can hold)."""
        if (nxt.subject is not None) != posed:
            return "kind"
        if posed and self._req_prec(nxt) != prec:
            return "precision"
        if rows + nxt.rows > self.buckets[-1]:
            return "overflow"
        if (posed and nxt.subject not in subjects
                and len(subjects) >= self.max_subjects):
            return "subjects"
        return None

    def _coalesce(self, first: _Request):
        """Gather requests behind ``first`` until the largest bucket fills
        or ``max_delay_s`` elapses; parked requests are tried first. A
        cancelled or expired request is dropped here, never batched or
        parked. Returns (requests, rows)."""
        reqs, rows = [first], first.rows
        posed = first.subject is not None
        prec = self._req_prec(first)
        subjects = {first.subject}
        top = self.buckets[-1]

        def admit(nxt, fresh=True) -> Optional[str]:
            if self._skip_cancelled(nxt):
                return "cancelled"
            if self._is_expired(nxt):
                self._expire(nxt, "coalesce")
                return "expired"
            why = self._admit(nxt, posed, subjects, rows, prec)
            if why is None:
                reqs.append(nxt)
                subjects.add(nxt.subject)
                return None
            self._pending.append(nxt)
            if why == "overflow" and fresh:
                # Counted at its first park from the live queue only.
                self.counters.count_overflow()
            return why

        for _ in range(len(self._pending)):
            if rows >= top:
                break
            nxt = self._pending.popleft()
            if admit(nxt, fresh=False) is None:
                rows += nxt.rows
        deadline = time.perf_counter() + self.max_delay_s
        while rows < top:
            timeout = deadline - time.perf_counter()
            try:
                nxt = (self._queue.get_nowait() if timeout <= 0
                       else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                self._queue.put(_SENTINEL)   # re-post for the main loop
                break
            why = admit(nxt)
            if why is None:
                rows += nxt.rows
            elif why == "overflow":
                break
        return reqs, rows

    def _pop_parked(self) -> _Request:
        """Take the highest-priority parked request: lowest tier first,
        then earliest deadline within the tier (deadline-less after
        deadlined ones), earliest-parked among the remaining ties."""
        best = 0
        for i in range(1, len(self._pending)):
            a, b = self._pending[i], self._pending[best]
            if a.tier != b.tier:
                if a.tier < b.tier:
                    best = i
            elif (a.deadline is not None
                    and (b.deadline is None or a.deadline < b.deadline)):
                best = i
        req = self._pending[best]
        del self._pending[best]
        return req

    def _dispatch_loop(self) -> None:
        try:
            while True:
                first = (self._pop_parked() if self._pending
                         else self._queue.get())
                if first is _SENTINEL:
                    if not self._running:
                        break
                    continue
                if self._skip_cancelled(first):
                    continue
                if self._is_expired(first):
                    self._expire(first, "dispatch")
                    continue
                self.counters.observe_queue_depth(
                    self._queue.qsize() + len(self._pending) + 1)
                reqs, rows = self._coalesce(first)
                self._launch(reqs, rows)
            self._drain()
        except BaseException as e:  # noqa: BLE001 — futures must not hang
            self._failure = e
            self._poison(list(self._pending), e)
            self._pending.clear()
            self._drain(e)
            raise

    def _launch(self, reqs, rows: int) -> None:
        """Sweep, pad, dispatch and deliver one batch. Without a policy a
        failure resolves the batch's futures with the exception and stops
        the dispatcher; with one, an exhausted batch resolves to its
        ``ServingError`` and the dispatcher goes on."""
        # The last deadline sweep that still costs no device time: the
        # coalesce window (and the batch before) can hold a member past
        # its deadline. An all-expired batch dispatches nothing.
        if any(r.deadline is not None or r.future.cancelled()
               for r in reqs):
            now = time.monotonic()
            alive = []
            for r in reqs:
                if self._skip_cancelled(r):
                    continue
                if self._is_expired(r, now):
                    self._expire(r, "dispatch")
                else:
                    alive.append(r)
            if not alive:
                return
            reqs, rows = alive, sum(r.rows for r in alive)
        try:
            bucket = bucket_mod.bucket_for(rows, self.buckets)
            pose = bucket_mod.pad_rows(
                np.concatenate([r.pose for r in reqs]), bucket)
            prec = self._req_prec(reqs[0])
            table = idx = shape = None
            if reqs[0].subject is not None:
                table, slots = self._resolve_batch(reqs)
                idx = bucket_mod.subject_index_rows(
                    slots, [r.rows for r in reqs], bucket)
                n_subjects = len(set(slots))
            else:
                shape = bucket_mod.pad_rows(
                    np.concatenate([r.shape for r in reqs]), bucket)
                n_subjects = 1
            if self._policy is not None:
                verts = self._supervised_dispatch(bucket, pose, shape, reqs,
                                                  table, idx, prec)
            elif table is not None:
                verts = self._run_posed(
                    table, idx, pose,
                    torch.bfloat16 if prec == BF16 else None)
            else:
                verts = self._run_full(pose, shape)
            self.counters.count_dispatch(bucket, rows, requests=len(reqs),
                                         subjects=n_subjects,
                                         bf16=prec == BF16)
        except ServingError as e:
            # Supervision exhausted for THIS batch: a failed batch is
            # traffic, not a broken engine; later submits stay servable.
            self._poison(reqs, e)
            return
        except BaseException as e:
            self._poison(reqs, e)
            raise
        self._deliver(reqs, verts)

    def _supervised_dispatch(self, bucket: int, pose, shape, reqs, table,
                             idx, prec: str = F32) -> np.ndarray:
        """One batch through the fault-tolerance envelope: supervised
        primary attempts (deadline + classified retries with backoff,
        breaker-gated), then the CPU tier, then a structured
        ``ServingError``. Deterministic failures are neither retried nor
        failed over: they propagate and stay engine-fatal. The readback
        to the host is part of each attempt, so a wedged kernel is killed
        at its deadline like a wedged call."""
        pol = self._policy
        breaker = pol.breaker
        if table is not None:
            dt = torch.bfloat16 if prec == BF16 else None

            def primary():
                return self._primary_posed(table, idx, pose, dt)
        else:
            def primary():
                return self._primary_full(pose, shape)
        # Supervision gives up once every member has expired: a retry or
        # failover past the LATEST member deadline produces a result
        # nobody reads.
        give_up_by = supervise.batch_give_up_by(r.deadline for r in reqs)
        last = None
        attempts = 0
        if breaker is None or breaker.allow_primary():
            try:
                out = supervise.supervised_call(
                    primary,
                    deadline_s=pol.deadline_s,
                    retries=pol.retries,
                    backoff_s=pol.backoff_s,
                    backoff_cap_s=pol.backoff_cap_s,
                    jitter=pol.jitter,
                    give_up_by=give_up_by,
                    keep_trying=(breaker.allow_primary
                                 if breaker is not None else None),
                    on_retry=self.counters.count_retry,
                    on_deadline_kill=self.counters.count_deadline_kill,
                    on_attempt_failure=(breaker.record_failure
                                        if breaker is not None else None),
                    name=f"serve-dispatch-b{bucket}",
                )
                if breaker is not None:
                    breaker.record_success()
                return out
            except supervise.RetriesExhausted as e:
                last, attempts = e.cause, e.attempts
        # The post-primary sweep: the attempts may have used up every
        # member's deadline; an expired request buys no fallback dispatch
        # and resolves as expired, not as an error.
        now = time.monotonic()
        if all(self._is_expired(r, now) for r in reqs):
            for r in reqs:
                self._expire(r, "failover")
            raise ServingError(
                f"every request in the batch expired during the "
                f"primary attempts ({attempts}); no further dispatch "
                "attempted — no caller would read the result",
                phase="failover", kind="expired",
                attempts=attempts, cause=last)
        if pol.cpu_fallback:
            self.counters.count_failover()
            warnings.warn(
                f"serving: bucket {bucket} failed over to the CPU tier "
                f"after {attempts} primary attempt(s)"
                + ("" if last is None
                   else f" ({type(last).__name__}: {last})"),
                RuntimeWarning, stacklevel=2)
            fb_shape = self._fallback_shape(reqs, bucket, shape,
                                            posed=table is not None)
            fb = self._fallback_executable(bucket)
            try:
                return supervise.call_with_deadline(
                    lambda: fb(pose, fb_shape), pol.deadline_s,
                    name=f"serve-fallback-b{bucket}")
            except BaseException as e:
                raise ServingError(
                    f"dispatch failed on the primary path "
                    f"({attempts} attempt(s)) AND the CPU fallback: "
                    f"{type(e).__name__}: {e}",
                    attempts=attempts, cause=e) from e
        raise ServingError(
            "dispatch failed: primary path "
            + ("unavailable (circuit breaker open)" if last is None
               else f"exhausted after {attempts} attempt(s): "
                    f"{type(last).__name__}: {last}")
            + " and cpu_fallback is disabled",
            attempts=attempts, cause=last)

    def _fallback_shape(self, reqs, bucket: int, shape, *, posed: bool):
        """The CPU tier's shape argument: a full batch's padded shape as
        it is; a pose-only batch's per-ROW betas from the host registry
        (pad rows repeat request 0's, as ``pad_rows`` and the index do),
        never from the device table."""
        if not posed:
            return shape
        with self._lock:
            betas = [self._subject_betas[r.subject] for r in reqs]
        return np.ascontiguousarray(bucket_mod.pad_rows(
            np.concatenate([np.broadcast_to(b[None], (r.rows, self._n_shape))
                            for b, r in zip(betas, reqs)]),
            bucket))

    def _deliver(self, reqs, verts) -> None:
        """Slice one completed batch back into its requests' futures. A
        result past its request's deadline resolves as expired, and one
        whose future was cancelled or swept meanwhile is discarded."""
        now = time.monotonic()
        lo = 0
        for r in reqs:
            piece = verts[lo:lo + r.rows]
            lo += r.rows
            if self._is_expired(r, now):
                self._expire(r, "readback")
                continue
            if self._set_result_safe(r, piece[0] if r.squeeze else piece):
                self.counters.count_served(r.tier)
            self._deregister(r)

    # ------------------------------------------------ resolution guarantees
    # Every request is registered at submit and deregistered where its
    # future resolves; _sweep_live is the last resort for a wedged or
    # dead dispatcher. No future submit() hands out can be waited on
    # forever.
    def _register(self, req: _Request) -> int:
        """Returns the outstanding count after the insert."""
        with self._live_lock:
            self._live[id(req)] = req
            return len(self._live)

    def _deregister(self, req: _Request) -> None:
        with self._live_lock:
            self._live.pop(id(req), None)

    def _on_cancel(self, req: _Request) -> None:
        """One caller's ``future.cancel()`` (fired exactly once): free the
        admission slot now and count it per tier. The request may still
        sit queued or parked; every dispatch boundary skips it."""
        self.counters.count_cancelled(req.tier)
        self._deregister(req)

    def _skip_cancelled(self, req: _Request) -> bool:
        if req.future.cancelled():
            self._deregister(req)
            return True
        return False

    def _set_result_safe(self, req: _Request, value) -> bool:
        """Resolve a future to a result unless something else (a cancel
        in the race window) got there first."""
        if req.future.done():
            return False
        try:
            req.future.set_result(value)
            return True
        except InvalidStateError:
            return False

    def _set_exception_safe(self, req: _Request, exc: BaseException,
                            ) -> bool:
        if req.future.done():
            return False
        try:
            req.future.set_exception(exc)
            return True
        except InvalidStateError:
            return False

    def _sweep_live(self, exc: BaseException) -> None:
        with self._live_lock:
            reqs, self._live = list(self._live.values()), {}
        for r in reqs:
            self._set_exception_safe(r, exc)

    def _poison(self, reqs, exc: BaseException) -> None:
        for r in reqs:
            self._set_exception_safe(r, exc)
            self._deregister(r)

    def _drain(self, exc: Optional[BaseException] = None) -> None:
        """Resolve every request still queued (the dispatcher is gone)."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is _SENTINEL:
                continue
            self._set_exception_safe(req, exc if exc is not None else
                                     ServingError(
                                         "serving engine stopped before "
                                         "this request was dispatched",
                                         phase="shutdown"))
            self._deregister(req)
