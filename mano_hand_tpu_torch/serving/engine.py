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

Table updates are functional (``core.table_set_row`` returns a new
table), so a batch's ``(table, slots)`` snapshot stays valid while
submitters install subjects. The engine runs on ``cuda`` unless the
caller passes ``device="cpu"``; it never falls back to the CPU.

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
import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.serving.precision import BF16, F32, PrecisionPolicy
from mano_hand_tpu_torch.utils.profiling import ServingCounters

_SENTINEL = object()


class _Request:
    __slots__ = ("pose", "shape", "rows", "squeeze", "subject", "tier",
                 "future")

    def __init__(self, pose, shape, rows, squeeze, subject, tier=0):
        self.pose = pose            # [n, J, 3] float32
        self.shape = shape          # [n, S] float32, None on the pose-only path
        self.rows = rows
        self.squeeze = squeeze      # caller passed one [J, 3] pose
        self.subject = subject      # subject key, or None (full path)
        self.tier = tier            # admission tier (0 = interactive)
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
    """

    # Capacity the subject table starts at (clamped to max_subjects).
    _TABLE_INIT_CAPACITY = 8

    def __init__(self, params, *, device=None, min_bucket: int = 1,
                 max_bucket: int = 1024, max_delay_s: float = 0.002,
                 max_subjects: int = 4096, posed_kernel: str = "xla",
                 precision_policy: Optional[PrecisionPolicy] = None):
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
        self.device = resolve_device(device)
        self._params = params.astype(torch.float32).to(self.device)
        self._n_joints = params.n_joints
        self._n_shape = params.n_shape
        self.buckets = bucket_mod.bucket_sizes(min_bucket, max_bucket)
        self.max_delay_s = float(max_delay_s)
        self.max_subjects = int(max_subjects)
        self._posed_kernel = posed_kernel
        self._precision_policy = precision_policy
        self.counters = ServingCounters()
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
                self._failure = None
                self._running = True
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="mano-serving",
                    daemon=True)
                self._thread.start()
        return self

    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Serve everything already submitted, stop the dispatcher, and
        resolve any request it did not reach with an error."""
        with self._thread_lock:
            thread = self._thread
            if thread is not None:
                self._running = False
                self._queue.put(_SENTINEL)
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                raise RuntimeError(
                    f"the serving dispatcher did not stop within "
                    f"{timeout_s} s")
            with self._thread_lock:
                self._thread = None
        self._drain(self._failure or RuntimeError(
            "serving engine stopped before this request was dispatched"))

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

    # ------------------------------------------------------------- requests
    def submit(self, pose, shape=None, subject: Optional[str] = None, *,
               priority: int = 0) -> Future:
        """Enqueue one forward request; returns a Future of the verts.

        ``pose`` is [n, J, 3] (the Future resolves to [n, V, 3] float32)
        or one [J, 3] (resolves to [V, 3]). ``shape`` is [n, S] or [S]
        (default zeros). ``subject`` (a key from ``specialize``) routes
        the request down the pose-only path instead; ``shape`` must then
        be omitted. ``priority`` is the admission tier (0 = interactive,
        >= 1 = batch); here it selects only the precision family a
        pose-only request is served from (``precision_policy``).
        """
        tier = int(priority)
        if tier < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
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
        if self._failure is not None:
            raise RuntimeError(
                "serving engine dispatcher died") from self._failure
        req = _Request(pose, shape, n, squeeze, subject, tier)
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
                priority: int = 0) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(pose, shape, subject=subject,
                           priority=priority).result()

    def warmup(self, bucket_list: Optional[Sequence[int]] = None) -> dict:
        """Run one zero batch of the full family per bucket (first-use
        work: kernel builds, allocator growth) outside any request's
        latency. Returns {bucket: seconds}."""
        out = {}
        for b in self._check_buckets(bucket_list):
            t0 = time.perf_counter()
            self._run_full(np.zeros((b, self._n_joints, 3), np.float32),
                           np.zeros((b, self._n_shape), np.float32))
            out[b] = time.perf_counter() - t0
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
    def _run_full(self, pose: np.ndarray, shape: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            verts = core.forward_batched(
                self._params, torch.from_numpy(pose).to(self.device),
                torch.from_numpy(shape).to(self.device)).verts
        return verts.cpu().numpy()

    def _run_posed(self, table, idx: np.ndarray, pose: np.ndarray,
                   compute_dtype=None) -> np.ndarray:
        idx_t = torch.from_numpy(idx).to(self.device)
        pose_t = torch.from_numpy(pose).to(self.device)
        with torch.no_grad():
            if self._posed_kernel == "fused":
                verts = core.forward_posed_gather_fused(
                    table, idx_t, pose_t, compute_dtype=compute_dtype)
            else:
                verts = core.forward_posed_gather(
                    table, idx_t, pose_t, compute_dtype=compute_dtype).verts
        return verts.cpu().numpy()

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
        or ``max_delay_s`` elapses; parked requests are tried first.
        Returns (requests, rows)."""
        reqs, rows = [first], first.rows
        posed = first.subject is not None
        prec = self._req_prec(first)
        subjects = {first.subject}
        top = self.buckets[-1]
        for _ in range(len(self._pending)):
            if rows >= top:
                break
            nxt = self._pending.popleft()
            if self._admit(nxt, posed, subjects, rows, prec) is None:
                reqs.append(nxt)
                rows += nxt.rows
                subjects.add(nxt.subject)
            else:
                self._pending.append(nxt)
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
            why = self._admit(nxt, posed, subjects, rows, prec)
            if why is None:
                reqs.append(nxt)
                rows += nxt.rows
                subjects.add(nxt.subject)
                continue
            self._pending.append(nxt)
            if why == "overflow":
                break
        return reqs, rows

    def _dispatch_loop(self) -> None:
        try:
            while True:
                first = (self._pending.popleft() if self._pending
                         else self._queue.get())
                if first is _SENTINEL:
                    if not self._running:
                        break
                    continue
                reqs, rows = self._coalesce(first)
                self._launch(reqs, rows)
        except BaseException as e:  # noqa: BLE001 — futures must not hang
            self._failure = e
            self._poison(list(self._pending), e)
            self._pending.clear()
            self._drain(e)
            raise

    def _launch(self, reqs, rows: int) -> None:
        """Pad, dispatch and deliver one batch. A failure resolves the
        batch's futures with the exception and stops the dispatcher."""
        try:
            bucket = bucket_mod.bucket_for(rows, self.buckets)
            pose = bucket_mod.pad_rows(
                np.concatenate([r.pose for r in reqs]), bucket)
            bf16 = self._req_prec(reqs[0]) == BF16
            if reqs[0].subject is not None:
                table, slots = self._resolve_batch(reqs)
                idx = bucket_mod.subject_index_rows(
                    slots, [r.rows for r in reqs], bucket)
                n_subjects = len(set(slots))
                verts = self._run_posed(table, idx, pose,
                                        torch.bfloat16 if bf16 else None)
            else:
                shape = bucket_mod.pad_rows(
                    np.concatenate([r.shape for r in reqs]), bucket)
                n_subjects = 1
                verts = self._run_full(pose, shape)
            self.counters.count_dispatch(bucket, rows, requests=len(reqs),
                                         subjects=n_subjects, bf16=bf16)
        except BaseException as e:
            self._poison(reqs, e)
            raise
        lo = 0
        for r in reqs:
            piece = verts[lo:lo + r.rows]
            lo += r.rows
            if not r.future.done():
                r.future.set_result(piece[0] if r.squeeze else piece)

    @staticmethod
    def _poison(reqs, exc: BaseException) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)

    def _drain(self, exc: BaseException) -> None:
        """Resolve every request still queued (the dispatcher is gone)."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not _SENTINEL and not req.future.done():
                req.future.set_exception(exc)
