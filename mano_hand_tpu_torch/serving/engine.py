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
Every failover is counted (``failovers``) and warned (a ``RuntimeWarning``
through ``obs/log.py``'s logger, which routes warnings through
``warnings``).
A card engine has no CPU tier: it refuses a policy with ``cpu_fallback``
(pass ``DispatchPolicy(cpu_fallback=False)``), so its work never moves
off the card, and a batch whose supervision is exhausted there resolves
to its ``ServingError``. The readback runs inside the supervised window, so
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

**Programs.** Each batch runs one PROGRAM of its family at its bucket
— full, gathered f32 (per table capacity) or gathered bf16 — built once
and cached, the counterpart of JAX's per-(family, bucket, capacity)
executables. On a card a program is a CUDA graph over static input and
output buffers, captured after one eager warm call and inside
``ieee_fp32()``; a replay copies the batch in, replays and reads the
result back, under its dispatch context's device lock, which every
device operation of that context holds (captures, replays, subject
installs; the engine's own context is the one without lanes). A
gathered graph reads a static table buffer per capacity, refreshed by a
stream-ordered copy whenever the batch's table snapshot differs from the
last one copied, so it never serves a row from another snapshot. The
kernels a graph captured are added to their launch counts at every
replay. On the CPU a program is the family's function called eagerly.
``compiles`` counts the programs built live, ``warmup``/``warmup_posed``
build them up front. A capture failure raises: unsupervised it stops the
dispatcher, supervised it resolves the batch to a ``ServingError``.

**Pipelined dispatch.** At ``inflight_depth > 1`` (2 by default) the
dispatcher hands each launched batch to a bounded FIFO completion stage
(``_CompletionStage``: ``depth`` workers run the dispatch and its
readback, the deadline re-check, the futures and the spans, delivering
in launch order) and assembles batch N+1 while batch N runs. A graph
program's dispatch is ``launch`` under the device lock (copy-in from
PINNED staging slabs the coalesce loop fills at admit time, the replay,
a ``non_blocking`` copy into a pinned output slab, an event) and
``wait`` outside it, so one worker's replay overlaps another's readback;
every device operation of the engine goes to the card's default stream,
whichever thread issues it, so stream order keeps each batch's readback
ahead of the next replay of the same static output. The coalesce window
adapts to the backlog (``_coalesce_window``, JAX's formula).
``inflight_depth=1`` is the serial cycle, byte for byte in telemetry
shape (no stage, no ``staged`` or ``pipeline`` event). Under a policy
the whole supervised dispatch, readback included, runs on the stage's
worker.

**Streams and the subject store.** ``open_stream`` opens a per-user
tracking session (``serving/streams.py``): each frame a frozen-shape LM
fit on the engine's device, then ``submit(pose, subject=key)`` at tier
0. ``subject_store=`` (``serving/subject_store.py``) puts warm (pinned
host) and cold (row pages on disk) tiers under the table: an evicted
row demotes, a later dispatch promotes it (prefetched at coalesce admit
on a side stream whose event the install's stream waits on) instead of
re-baking, and ``register_subjects`` registers betas without baking.

**Lanes.** ``lanes=N`` (``serving/lanes.py``) hands each assembled batch
to one of N dispatch lanes instead of the completion stage. Every
program runs in a DISPATCH CONTEXT (``_DispatchContext``: device, stream,
lock, graph pool, static tables): the engine's own is the card's default
stream; each lane has its own, on a stream of its own, so the lanes'
replays run concurrently on the card without sharing a buffer or a
graph pool. A lane reads the tables and rows the engine makes on its
stream only after waiting on it. Program builds, on any context, run
one at a time in the process (``_BUILD_LOCK``). Under a sharded subject
store each lane holds a shard of the table and ``_admit`` splits batches
by owner lane.

**Persistence.** ``aot_dir`` names a directory for the engine's baked
executable lattice (``bake_lattice``; ``io/export_aot.py``): every full
and gathered f32 program of the reachable (bucket, capacity) ladder, and
the CPU tier of a CPU engine, exported with ``torch.export`` with the
params and the table as runtime arguments. A fresh engine on that
directory loads each program from it (counted in ``aot_loads``; captured
after the load on a card) instead of building it live, bit for bit the
live program's output; a damaged, mismatched or foreign entry degrades
to a counted live build (``aot_load_failures``), never a crash. The K2
family and the bf16 family are never baked (a family swap across a
restart would change the numbers), as in JAX. Without a lattice, live
full programs also write the legacy per-bucket artifact there
(``export_forward`` with the params baked in). ``checkpoint_subjects``
/ ``restore_subjects`` carry the subject table's rows, betas and LRU
order across a restart (``io/state_ckpt.py``, JAX's pickle layout), so a
restored subject serves bit for bit without a shape-stage bake.

**Tracing.** ``tracer=`` (an ``obs.Tracer``) opens a span per request in
``submit`` and stamps the JAX engine's boundary events on it — ``coalesce``
or ``park``, ``launch``, ``dispatched`` (when the batch's replay is
enqueued), ``readback`` — then closes it exactly once with the future's
terminal kind (``ok``, ``shed``, ``expired``, ``error``, ``shutdown``,
``cancelled``). Runtime events share the timeline: ``chaos_fault``,
``breaker``, ``retry``, ``evict``, ``compile`` (one per live program
build), ``lattice_load`` and ``lattice_load_failed``, and the incidents
``deadline_kill``, ``failover`` and ``shed_burst`` a flight recorder
captures. ``tracer=None`` (the default) adds no call anywhere.
``numerics_probe_targets`` hands ``obs.NumericsSentinel`` the live
programs behind the same chaos wrap real dispatches take.

Table updates are functional (``core.table_set_row`` returns a new
table), so a batch's ``(table, slots)`` snapshot stays valid while
submitters install subjects. The engine runs on ``cuda`` unless the
caller passes ``device="cpu"``.

Typical use::

    eng = ServingEngine(params, max_bucket=256, posed_kernel="fused",
                        aot_dir="serve_cache/")
    with eng:
        verts = eng.forward(pose_n16x3, shape_n10)      # [n, 778, 3]
        subj = eng.specialize(betas)                    # bake the shape stage
        fut = eng.submit(pose_n16x3, subject=subj)      # pose-only, async
        verts = fut.result()
    print(eng.counters.snapshot())

On one card with four lanes: ``ServingEngine(params, lanes=4,
posed_kernel="fused")`` — the same calls; ``load()["lanes"]`` reads the
lanes' backlog, breakers and ladder hops.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import os
import queue
import functools
import threading
import time
from concurrent.futures import Future, InvalidStateError
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.obs import log as obs_log
from mano_hand_tpu_torch.ops.common import (
    add_launches, captured_launches, ieee_fp32, resolve_device,
)
from mano_hand_tpu_torch.runtime import supervise
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.serving.precision import BF16, F32, PrecisionPolicy
from mano_hand_tpu_torch.utils.profiling import ServingCounters

_SENTINEL = object()
_LOG = obs_log.get_logger("serving.engine")


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


def cpu_tier_forward(params_cpu, pose: np.ndarray,
                     shape: np.ndarray) -> np.ndarray:
    """The CPU tier's body: the plain ``core.forward_batched`` on a CPU
    engine's float32 params, host arrays in and out."""
    # C-ordered copies: a broadcast shape row (stride 0) would take
    # another CPU matmul path and round differently.
    pose, shape = (torch.from_numpy(np.array(x, np.float32, order="C"))
                   for x in (pose, shape))
    with torch.no_grad():
        return core.forward_batched(params_cpu, pose, shape).verts.numpy()


def build_cpu_fallback_executable(params_cpu, bucket: int, n_joints: int,
                                  n_shape: int) -> Callable:
    """The graceful-degradation callable of one bucket: ``cpu_tier_forward``
    (the full family's primary function, on the CPU). So failover results
    match a direct CPU ``core.forward_batched`` call at the same padded
    bucket bit for bit. Never chaos-wrapped (the fallback is the clean
    path failover is measured against); warmed once with a zero batch."""

    def run(pose: np.ndarray, shape: np.ndarray) -> np.ndarray:
        return cpu_tier_forward(params_cpu, pose, shape)

    run(np.zeros((bucket, n_joints, 3), np.float32),
        np.zeros((bucket, n_shape), np.float32))
    return run


def gather_body(fused: bool, compute_dtype=None) -> Callable:
    """A gathered family's function ``(table, idx, pose) -> verts``: K2
    (or K2-bf16 under ``compute_dtype=torch.bfloat16``) under ``fused``,
    else the plain ``core.forward_posed_gather``."""
    if fused:
        return lambda table, idx, pose: core.forward_posed_gather_fused(
            table, idx, pose, compute_dtype=compute_dtype)
    return lambda table, idx, pose: core.forward_posed_gather(
        table, idx, pose, compute_dtype=compute_dtype).verts


def _torch_dtype(x: np.ndarray) -> torch.dtype:
    return torch.int32 if x.dtype == np.int32 else torch.float32


class _DispatchContext:
    """Where a program runs, and what its programs share.

    ``device``; ``stream``, the CUDA stream every copy and replay of the
    context goes to (None on the CPU); ``lock``, held over a program's
    static buffers from its copy-in to the enqueue of its readback, over
    a capture, and over every write into a static table; ``pool``, the
    CUDA-graph memory pool its programs are captured into (graphs that
    share a pool must not replay at once: one pool a stream, whose order
    serialises them); ``static_tables``, a subject table of each
    capacity at a fixed address, the table its gathered graphs of that
    capacity read.

    The engine has one context, on the card's default stream. Each
    dispatch lane (``serving/lanes.py``) has its own, on a stream of its
    own, whose ``upstream`` is the engine's stream: the subject tables
    and baked rows a lane reads are made there. Torch's pool streams do
    not wait for the default stream, so ``wait_upstream`` orders a read
    of them after everything enqueued upstream so far and marks their
    memory as in use by this stream (it is not handed out again before
    this stream is done with it)."""

    def __init__(self, params, device: torch.device, stream=None,
                 upstream=None, lock=None):
        self.params = params
        self.device = device
        if device.type == "cuda" and stream is None:
            stream = torch.cuda.default_stream(device)
        self.stream = stream
        self.upstream = upstream
        if lock is None:
            lock = (threading.RLock() if device.type == "cuda"
                    else contextlib.nullcontext())
        self.lock = lock
        self.pool = None
        self.static_tables: dict = {}

    def on(self):
        """This context's device and stream as the current ones."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _on_stream(self.device, self.stream)

    def static_table(self, capacity: int) -> "_StaticTable":
        """The static table of one capacity (lock held)."""
        st = self.static_tables.get(capacity)
        if st is None:
            with self.on(), torch.no_grad():
                st = self.static_tables[capacity] = _StaticTable(
                    self.params, capacity)
        return st

    def wait_upstream(self, *tensors) -> None:
        """Order this stream's later work after the upstream stream's work
        so far, and keep ``tensors`` (made upstream) from being reused
        before this stream is done reading them."""
        if self.upstream is None:
            return
        self.stream.wait_stream(self.upstream)
        for t in tensors:
            t.record_stream(self.stream)


_ROW_LEAVES = ("v_shaped", "joints", "shape")


class _StaticTable:
    """A subject table of one capacity at a fixed address: the table a
    context's gathered graphs of that capacity read. ``refresh`` copies a
    snapshot in (on the context's stream, under its lock) unless it is the
    one copied last; ``put_rows`` writes rows in place."""

    def __init__(self, params, capacity: int):
        self.table = core.subject_table(params, capacity)
        self.source = None

    def refresh(self, snapshot: core.SubjectTable, wait=None) -> None:
        if snapshot is self.source:
            return
        if snapshot.capacity != self.table.capacity:
            raise ValueError(
                f"a capacity-{snapshot.capacity} table on a "
                f"capacity-{self.table.capacity} program")
        leaves = [getattr(snapshot, n) for n in _ROW_LEAVES]
        if wait is not None:
            wait(*leaves)
        for name, leaf in zip(_ROW_LEAVES, leaves):
            getattr(self.table, name).copy_(leaf)
        self.source = snapshot     # held: identity is never reused

    def put_rows(self, rows: dict, wait=None) -> None:
        """Write ``rows`` (slot -> ``ShapedHand``) in place."""
        for slot, shaped in rows.items():
            leaves = [getattr(shaped, n) for n in _ROW_LEAVES]
            if wait is not None:
                wait(*leaves)
            for name, leaf in zip(_ROW_LEAVES, leaves):
                getattr(self.table, name)[slot].copy_(leaf)


@contextlib.contextmanager
def _on_stream(dev: torch.device, stream):
    """``dev`` as the current device, ``stream`` as its current stream."""
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


_gc_lock = threading.Lock()
_gc_pauses = 0


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection while a graph is captured. A
    collection during the capture could destroy another program's graph
    (an engine dropped in a reference cycle), whose teardown is a CUDA
    call a capture does not allow: the capture would fail. Reference
    counted across threads, like ``ieee_fp32``."""
    global _gc_pauses
    with _gc_lock:
        if _gc_pauses == 0:
            gc.disable()
        _gc_pauses += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pauses -= 1
            if _gc_pauses == 0:
                gc.enable()


# One program build at a time in the process. A build synchronises the
# device and ``torch.cuda.graph`` empties the allocator's cache before it
# captures, which must not happen while another thread captures; and
# every capture goes to torch's one shared capture stream. Held outside
# any context's lock; replays on other streams go on meanwhile.
_BUILD_LOCK = threading.RLock()


class _Launched:
    """The handle of one launched dispatch on a card: its pinned output
    slab and the event recorded behind the slab's copy."""

    __slots__ = ("_slab", "_event")

    def __init__(self, slab, event):
        self._slab, self._event = slab, event

    def result(self) -> np.ndarray:
        slab, self._slab = self._slab, None
        if slab is None:
            raise RuntimeError("this launch was already waited for")
        self._event.synchronize()
        # The slab itself, no host copy (~0.3 ms at 2.4 MB): the array
        # keeps the block, which rejoins the cache once the result dies.
        return slab.numpy()


def _readback(ctx: _DispatchContext, out: torch.Tensor) -> _Launched:
    """A ``non_blocking`` copy of ``out`` into a fresh PINNED slab of
    torch's host cache, and an event behind it, on ``ctx``'s stream. The
    copy records its event on the block, so a block freed before the copy
    lands (an abandoned attempt's) is not handed out again until it has."""
    slab = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    slab.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(ctx.stream)
    return _Launched(slab, done)


class _EagerProgram:
    """A program that runs its family's function eagerly on each batch:
    every program of a CPU context, and on a card the engine-snapshot
    fallback of a lane with a shard table (``serving/lanes.py``), which
    keeps no static table of the engine's size. ``body(*tensors)`` (the
    gathered families take the batch's table first) returns the verts;
    ``example`` are the host zeros of one batch, run once at build so a
    program that cannot execute fails at build time, not inside a
    dispatch. ``on_enqueued`` (a tracing hook) is called once the body's
    work is enqueued (on the CPU: as the body starts; the body IS the
    device work). The card program's two calls: ``launch`` does the work
    and returns a handle (on the CPU the host result itself), ``wait``
    hands the result back; ``run`` is ``wait(launch(...))``."""

    def __init__(self, ctx: _DispatchContext, body: Callable,
                 example: tuple, table=None):
        self._ctx = ctx
        self._body = body
        if ctx.stream is None:
            self.run(*example, table=table)
            return
        # On a card a build as a graph's: one at a time, and what the
        # warm call cached (index tensors, operand packs) lands before
        # another stream reads it.
        with _BUILD_LOCK:
            torch.cuda.synchronize(ctx.device)
            self.run(*example, table=table)
            torch.cuda.synchronize(ctx.device)

    def launch(self, *host, table=None, on_enqueued=None):
        ctx = self._ctx
        if ctx.stream is None:
            args = [torch.from_numpy(np.ascontiguousarray(x)) for x in host]
            with ctx.lock:
                if on_enqueued is not None:
                    on_enqueued()
                with torch.no_grad(), ieee_fp32():
                    out = self._body(*args) if table is None \
                        else self._body(table, *args)
            return out.numpy()
        with ctx.lock:
            if supervise.abandoned():
                raise supervise.DeadlineExceeded(
                    "an abandoned attempt touches no device buffer")
            with ctx.on(), torch.no_grad(), ieee_fp32():
                args = [torch.from_numpy(np.ascontiguousarray(x)).to(
                    ctx.device, non_blocking=True) for x in host]
                if table is not None:
                    ctx.wait_upstream(*(getattr(table, n)
                                        for n in _ROW_LEAVES))
                    args.insert(0, table)
                out = self._body(*args)
                if on_enqueued is not None:
                    on_enqueued()
                return _readback(ctx, out)

    @staticmethod
    def wait(handle) -> np.ndarray:
        return handle.result() if isinstance(handle, _Launched) else handle

    def run(self, *host, table=None, on_enqueued=None) -> np.ndarray:
        return self.wait(self.launch(*host, table=table,
                                     on_enqueued=on_enqueued))


class _GraphProgram:
    """A card program: ``body`` captured once into a CUDA graph over
    static input buffers (and, for a gathered family, its context's
    static table of its capacity) and a static output.

    Built under ``_BUILD_LOCK`` and its context's lock, after a device
    synchronisation (whatever a sibling context's build cached, and the
    tables and params it reads, has landed): one eager warm call (kernel
    builds, operand packs, index tensors: everything a capture must find
    cached), then the capture into the context's pool, both inside
    ``ieee_fp32()`` so the graph's matmuls are IEEE fp32 whatever the
    caller's TF32 setting at replay. The kernel launches the capture noted
    are added to their counts at every replay.

    A dispatch is two calls. ``launch`` runs under the context's lock:
    the copy-in from the host arrays (``non_blocking``: from pinned
    staging slabs it is asynchronous), the static-table refresh, the
    replay, and a ``non_blocking`` copy of the static output into a fresh
    PINNED output slab, then an event recorded behind it; it returns a
    handle. ``wait(handle)`` synchronises on that event OUTSIDE the lock
    and returns the slab as the host array, so another batch's launch
    queues behind this one's replay and readback on the card while this
    thread waits. Every copy and replay goes to the context's stream,
    whichever thread calls (the dispatcher, a completion worker or lane
    worker, a supervised attempt's fresh thread, the sentinel): stream
    order alone keeps batch N+1's copy-in and replay behind batch N's
    readback of the one static output. An attempt its supervisor
    abandoned before its launch touches no buffer. ``run`` is
    ``wait(launch(...))``.

    ``launch(..., on_enqueued=hook)`` calls ``hook()`` once the replay is
    enqueued, before the readback waits for it: the engine stamps its
    spans' ``dispatched`` there, so on the port the ``dispatch`` stage
    (``obs/trace.py:Tracer._span_stages``) holds the batch assembly, the
    program fetch, the wait for the context's lock (held by a probe, an
    install or a capture) and the copy-in, and the ``device`` stage the
    replay's execution on the card and the readback to the host — JAX's
    stage semantics, where ``device`` is execution plus transfer."""

    def __init__(self, ctx: _DispatchContext, body: Callable,
                 example: tuple, capacity: Optional[int] = None, keep=None):
        # The context, not the engine: a program in the engine's cache
        # must not close a reference cycle.
        self._ctx = ctx
        # What the graph reads but does not own: a loaded program's
        # module, whose constants (FK's index tensors among them) the
        # replays read in place. Freed, its memory would be reused under
        # the graph.
        self._keep = keep
        dev = ctx.device
        with _BUILD_LOCK, ctx.lock, ctx.on(), torch.no_grad(), \
                ieee_fp32():
            torch.cuda.synchronize(dev)
            self._table = (None if capacity is None
                           else ctx.static_table(capacity))
            self._static = [torch.zeros(x.shape, dtype=_torch_dtype(x),
                                        device=dev) for x in example]
            args = list(self._static)
            if self._table is not None:
                args.insert(0, self._table.table)
            body(*args)
            torch.cuda.synchronize(dev)
            if ctx.pool is None:
                ctx.pool = torch.cuda.graph_pool_handle()
            self._graph = torch.cuda.CUDAGraph()
            with _gc_paused(), captured_launches() as log, torch.cuda.graph(
                    self._graph, pool=ctx.pool,
                    capture_error_mode="thread_local"):
                self._out = body(*args)
            self._launches = tuple(log)

    def launch(self, *host, table=None, on_enqueued=None) -> _Launched:
        ctx = self._ctx
        with ctx.lock:
            if supervise.abandoned():
                raise supervise.DeadlineExceeded(
                    "an abandoned attempt touches no device buffer")
            with ctx.on():
                for buf, x in zip(self._static, host):
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(x)),
                              non_blocking=True)
                if self._table is not None:
                    self._table.refresh(table, ctx.wait_upstream)
                self._graph.replay()
                add_launches(self._launches)
                if on_enqueued is not None:
                    on_enqueued()
                return _readback(ctx, self._out)

    @staticmethod
    def wait(handle: _Launched) -> np.ndarray:
        return handle.result()

    def run(self, *host, table=None, on_enqueued=None) -> np.ndarray:
        return self.wait(self.launch(*host, table=table,
                                     on_enqueued=on_enqueued))


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
                 "deadline", "future", "span", "t_submit")

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
        self.span = None            # obs.Tracer span id, or None
        self.t_submit = time.perf_counter()   # the coalesce window's age


class _Dispatched:
    """Stamps ``dispatched`` on one batch's spans exactly once: from the
    program's ``on_enqueued`` hook when its replay is enqueued, else by
    the dispatcher once the dispatch returned (a CPU-tier failover).
    ``close()`` disarms it, so an attempt that wakes after its batch was
    resolved stamps nothing. ``fields`` ride on the event (a lane's
    index)."""

    def __init__(self, tracer, reqs, **fields):
        self._tracer, self._reqs, self._fields = tracer, reqs, fields
        self._lock = threading.Lock()
        self._done = False

    def _take(self) -> bool:
        with self._lock:
            first, self._done = not self._done, True
            return first

    def __call__(self) -> None:
        if self._take():
            for r in self._reqs:
                self._tracer.event(r.span, "dispatched", **self._fields)

    def close(self) -> None:
        self._take()


class _Staging:
    """One batch-assembly slab set: ``pose`` [max_bucket, J, 3],
    ``shape`` [max_bucket, S] and ``idx`` [max_bucket] host arrays — on a
    card engine numpy views of PINNED tensors, so a graph program's
    copy-in from them is asynchronous.

    The coalesce loop writes each admitted request's rows at admit time
    (``append``), so the launch hands the program contiguous
    ``slab[:bucket]`` views instead of re-stacking every member on the
    critical path; ``finish`` pads by repeating row 0, the
    ``buckets.pad_rows`` rule, so a staged batch is bit for bit the
    concatenate-and-pad assembly. A slab belongs to its batch until the
    batch's copy-in has completed on the device (its readback finishing
    implies it, by stream order), then returns to the engine's pool."""

    __slots__ = ("pose", "shape", "idx", "rows", "full")

    def __init__(self, pose, shape, idx):
        self.pose = pose
        self.shape = shape
        self.idx = idx
        self.rows = 0               # write cursor (== batch rows)
        self.full = False           # full path: shape rows staged too

    def append(self, req: _Request) -> None:
        n = req.rows
        self.pose[self.rows:self.rows + n] = req.pose
        if self.full:
            self.shape[self.rows:self.rows + n] = req.shape
        self.rows += n

    def finish(self, bucket: int):
        """Pad to ``bucket`` (repeat row 0) and return the batch's
        ``(pose, shape)`` views; ``shape`` is None on the pose-only
        path."""
        if self.rows < bucket:
            self.pose[self.rows:bucket] = self.pose[:1]
            if self.full:
                self.shape[self.rows:bucket] = self.shape[:1]
        return (self.pose[:bucket],
                self.shape[:bucket] if self.full else None)

    def put_idx(self, idx: np.ndarray) -> np.ndarray:
        """The batch's subject index rows, staged into the slab."""
        out = self.idx[:idx.shape[0]]
        out[:] = idx
        return out


class _StageItem:
    """One launched batch in the completion stage."""

    __slots__ = ("seq", "fn", "reqs", "rows", "bucket", "n_subjects",
                 "staging", "bf16", "mark", "posed")

    def __init__(self, seq, fn, reqs, rows, bucket, n_subjects, staging,
                 bf16, mark, posed):
        self.seq, self.fn, self.reqs, self.rows = seq, fn, reqs, rows
        self.bucket, self.n_subjects = bucket, n_subjects
        self.staging, self.bf16, self.mark = staging, bf16, mark
        self.posed = posed


class _CompletionStage:
    """The bounded completion stage of the pipelined dispatch: ``depth``
    daemon workers that finish launched batches — the dispatch (launch
    and readback, or the whole supervised envelope), the deadline
    re-check, the futures, the spans — while the dispatcher assembles
    the next batch.

    ``depth`` bounds launched-but-unresolved batches: ``submit`` blocks
    once ``depth`` are in flight (the pipeline's backpressure), and with
    one worker a slot, up to ``depth`` dispatches overlap: one worker's
    batch replays while another's waits on its readback, outside the
    device lock. Delivery is STRICT FIFO: each batch takes a launch-order
    sequence number at submit and ``_finish_in_order`` holds a completed
    batch at a reorder barrier until every predecessor has resolved.

    Failure contract (``_launch``'s): a ``ServingError`` poisons ONLY its
    batch and the stage keeps completing; any other exception is
    engine-fatal — the failing worker poisons its batch and everything
    still queued, records the failure, retires and wakes the dispatcher,
    and ``check``/``submit``/``drain`` re-raise it on the dispatcher,
    whose crash path owns the shutdown: the engine dies at once, as the
    serial cycle's does.

    ``_completion_lock`` is a Condition and the stage's one lock, a leaf:
    nothing else is taken under it, and device work and future
    resolution run outside it.
    """

    def __init__(self, eng: "ServingEngine", depth: int):
        self._eng = eng
        self.depth = int(depth)
        self._completion_lock = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._inflight = 0          # submitted, not yet delivered
        self._next_seq = 0          # launch order, assigned at submit
        self._deliver_seq = 0       # next seq allowed to resolve
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._threads = [
            threading.Thread(
                target=self._worker,
                name=f"mano-serving-completion-{i}", daemon=True)
            for i in range(max(1, self.depth))]
        for t in self._threads:
            t.start()

    def inflight(self) -> int:
        with self._completion_lock:
            return self._inflight

    def submit(self, fn, reqs, rows: int, bucket: int, n_subjects: int,
               staging, bf16: bool = False, mark=None,
               posed: bool = False) -> int:
        """Hand one launched batch to the stage; blocks at ``depth``.
        Returns the in-flight count after the enqueue. Re-raises a
        worker's engine-fatal failure on the dispatcher; the batch is
        then not enqueued (``_launch`` poisons it)."""
        with self._completion_lock:
            while (self._failure is None and not self._closed
                   and self._inflight >= self.depth):
                self._completion_lock.wait()
            if self._failure is not None:
                raise self._failure
            if self._closed:
                raise ServingError(
                    "completion stage closed during submit (engine "
                    "stopping)", phase="shutdown")
            seq = self._next_seq
            self._next_seq += 1
            self._inflight += 1
            self._items.append(_StageItem(seq, fn, reqs, rows, bucket,
                                          n_subjects, staging, bf16, mark,
                                          posed))
            self._completion_lock.notify_all()
            return self._inflight

    def check(self) -> None:
        """Re-raise a worker's engine-fatal failure, if any."""
        with self._completion_lock:
            if self._failure is not None:
                raise self._failure

    def drain(self) -> None:
        """Block until every submitted batch has resolved (the
        dispatcher's clean-exit barrier). Re-raises a worker's
        engine-fatal failure; returns at once once closed."""
        with self._completion_lock:
            while (self._failure is None and not self._closed
                   and self._inflight > 0):
                self._completion_lock.wait()
            if self._failure is not None:
                raise self._failure

    def close(self, exc: Optional[BaseException] = None) -> None:
        """Retire the pool (idempotent). Queued, never-dispatched batches
        are poisoned — with ``exc`` on a dispatcher crash, else with the
        shutdown ``ServingError``. A worker wedged inside a batch stays
        abandoned (daemon); its batch, and any batch behind it at the
        reorder barrier, falls to ``stop()``'s sweep."""
        with self._completion_lock:
            self._closed = True
            leftovers = list(self._items)
            self._items.clear()
            self._completion_lock.notify_all()
        err = exc if exc is not None else ServingError(
            "serving engine stopped before this launched batch "
            "completed", phase="shutdown")
        for it in leftovers:
            self._eng._poison(it.reqs, err)
            self._eng._staging_release(it.staging)

    # Worker side ------------------------------------------------------
    def _worker(self) -> None:
        eng = self._eng
        item = None
        try:
            while True:
                with self._completion_lock:
                    while (not self._items and not self._closed
                           and self._failure is None):
                        self._completion_lock.wait()
                    if self._failure is not None or not self._items:
                        return      # failed, or closed and drained
                    item = self._items.popleft()
                outcome = None
                try:
                    outcome = self._run_call(item)
                finally:
                    # A batch that did not end in a completed readback (a
                    # supervised batch exhausted with an attempt still
                    # queued on the card) returns its slab behind a fence.
                    eng._staging_release(
                        item.staging,
                        fence=outcome is None or outcome[0] == "poison")
                self._finish_in_order(item, outcome)
                item = None
        except BaseException as e:  # noqa: BLE001 — engine-fatal class
            if item is not None:
                if item.mark is not None:
                    item.mark.close()
                eng._poison(item.reqs, e)
            with self._completion_lock:
                if self._failure is None:
                    self._failure = e
                leftovers = list(self._items)
                self._items.clear()
                self._completion_lock.notify_all()
            for it in leftovers:
                eng._poison(it.reqs, e)
                eng._staging_release(it.staging)
            eng._queue.put(_SENTINEL)     # the dispatcher re-raises it

    def _run_call(self, item: _StageItem):
        """The parallel phase: the deadline re-check, the dispatch and
        its readback. Runs concurrently across workers; returns an
        outcome tag for the in-order delivery phase."""
        eng = self._eng
        reqs = item.reqs
        # The batch waited in the stage queue after its launch-boundary
        # sweep: re-check now, the last instant a sweep costs no device
        # time. Only a WHOLLY expired or cancelled batch skips its
        # dispatch; a live member keeps it, and stragglers expire at
        # readback.
        if any(r.deadline is not None or r.future.cancelled()
               for r in reqs):
            now = time.monotonic()
            if all(r.future.cancelled() or eng._is_expired(r, now)
                   for r in reqs):
                return ("presweep", None)
        try:
            verts = item.fn()      # a host array: launch, then wait
        except ServingError as e:
            return ("poison", e)
        eng.counters.count_dispatch(item.bucket, item.rows,
                                    requests=len(reqs),
                                    subjects=item.n_subjects,
                                    bf16=item.bf16, gathered=item.posed)
        if item.mark is not None:
            item.mark()            # unless the replay's enqueue stamped it
        return ("ok", verts)

    def _finish_in_order(self, item: _StageItem, outcome) -> None:
        """The serial phase: hold this completed batch at the reorder
        barrier until every earlier launch has resolved, then resolve
        its futures and close its spans."""
        eng = self._eng
        with self._completion_lock:
            while self._deliver_seq != item.seq and self._failure is None:
                self._completion_lock.wait()
        kind, payload = outcome
        reqs = item.reqs
        if kind == "presweep":
            if item.mark is not None:
                item.mark.close()
            for r in reqs:
                if not eng._skip_cancelled(r):
                    eng._expire(r, "dispatch")
            eng.counters.count_pipeline_presweep()
        elif kind == "poison":
            if item.mark is not None:
                item.mark.close()
            eng._poison(reqs, payload)
        else:
            eng.counters.count_pipeline_completion()
            eng._deliver(reqs, payload, item.bucket)
        with self._completion_lock:
            self._deliver_seq = item.seq + 1
            self._inflight -= 1
            self._completion_lock.notify_all()


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
    adaptive_coalesce: shrink that wait as the backlog and the head
        request's age rise (``_coalesce_window``): once the queue could
        fill a batch the wait buys nothing. False pins the fixed window.
        Never changes which requests may share a batch.
    inflight_depth: how many launched, unresolved batches the completion
        stage holds (2, the default: batch N+1 assembles and launches
        while batch N executes and reads back; resolution stays strictly
        in launch order). 1 is the serial assemble -> launch -> read back
        -> resolve cycle on the dispatcher, byte for byte in telemetry
        shape: no stage, no ``staged`` event, no ``pipeline`` event.
        Under a ``policy`` the whole supervised dispatch runs on the
        stage's worker, its readback inside the supervised window.
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
    tracer: an ``obs.Tracer``, or None (the default: no tracing call on
        any path). With one, every request carries a span from submit to
        its terminal resolution and runtime events share the timeline
        (module docstring); an unclaimed breaker's ``on_transition`` is
        wired to it.
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
    aot_dir: directory of persistent programs. When it holds a baked
        executable LATTICE (``bake_lattice()``) every full and gathered
        f32 program it covers — and a CPU engine's CPU tier — loads from
        it (``aot_loads``) bit-identical to the live build, and a damaged
        or mismatched entry degrades to a counted live build
        (``aot_load_failures``). Otherwise the legacy per-bucket full
        artifacts apply: a missing bucket is built live AND exported
        there; a present one loads. None = in-memory cache only.
    subject_store: a ``serving.subject_store.SubjectStore``, the warm
        (pinned host rows) and cold (row pages on disk) tiers under the
        device table: an evicted row demotes to warm, a later dispatch
        promotes it back (prefetched at coalesce admit) instead of
        re-running the shape stage. None (the default): the table alone.
        A sharded store needs ``lanes``: its N shards are the lanes'
        tables.
    store_warm_capacity: retarget the store's warm-tier row budget
        (requires ``subject_store``).
    lanes: dispatch lanes (``serving/lanes.py``). None (the default): the
        single-context dispatch above, no lane thread anywhere. An int N
        builds N lanes over ``parallel.lane_devices`` at the first warm-up
        or dispatch (round-robin over the engine's device type: on one
        card, N CUDA streams of that card), each with its own stream,
        lock, graph pool, static tables, programs, worker thread and,
        under a ``policy``, circuit breaker. The dispatcher hands each
        assembled batch to the least-backlogged healthy lane (a sharded
        store's batch to its owner lane); the subject table is mirrored
        into each lane (row writes, never a capture) or, under a sharded
        store, split over them; an exhausted batch walks the failover
        ladder: its lane, the healthy siblings, then the CPU tier of a
        ``device="cpu"`` engine. Results are bit for bit the single
        context's on the same batches. ``load()`` gains a ``"lanes"``
        block. The completion stage is bypassed: the lanes are the
        overlap.
    lane_probe: per-lane breaker probe, ``lane_probe(index) -> bool``
        (requires ``lanes``); default: the policy breaker's probe.
    """

    # Capacity the subject table starts at (clamped to max_subjects).
    _TABLE_INIT_CAPACITY = 8

    def __init__(self, params, *, device=None, min_bucket: int = 1,
                 max_bucket: int = 1024, max_delay_s: float = 0.002,
                 max_subjects: int = 4096, posed_kernel: str = "xla",
                 precision_policy: Optional[PrecisionPolicy] = None,
                 policy=None, max_queued: Optional[int] = None,
                 tier_quotas: Optional[dict] = None,
                 busy_fraction: float = 0.75, aot_dir=None, tracer=None,
                 adaptive_coalesce: bool = True, inflight_depth: int = 2,
                 subject_store=None,
                 store_warm_capacity: Optional[int] = None,
                 lanes: Optional[int] = None,
                 lane_probe: Optional[Callable[[int], bool]] = None):
        if inflight_depth < 1:
            raise ValueError(
                f"inflight_depth must be >= 1, got {inflight_depth}")
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
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if lane_probe is not None and lanes is None:
            raise ValueError("lane_probe requires lanes")
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
        self.adaptive_coalesce = bool(adaptive_coalesce)
        self.inflight_depth = int(inflight_depth)
        self.max_subjects = int(max_subjects)
        self._posed_kernel = posed_kernel
        self._precision_policy = precision_policy
        self.max_queued = None if max_queued is None else int(max_queued)
        self._tier_quotas = dict(tier_quotas or {})
        self.busy_fraction = float(busy_fraction)
        self.counters = ServingCounters()
        self._tracer = tracer
        if tracer is not None and policy is not None:
            breaker = policy.breaker
            if breaker is not None and breaker.on_transition is None:
                # Breaker changes belong on the request timeline; a
                # caller-wired hook wins.
                breaker.on_transition = (
                    lambda old, new: tracer.runtime_event(
                        "breaker", old=old, new=new))
        # The primary callables; under a chaos plan each consults it (one
        # plan-wide call index across both families). The CPU tier is
        # never wrapped.
        self._primary_full = self._run_full
        self._primary_posed = self._run_posed
        if policy is not None and policy.chaos is not None:
            self._primary_full = policy.chaos.wrap(
                self._run_full, on_fault=self._on_chaos_fault)
            self._primary_posed = policy.chaos.wrap(
                self._run_posed, on_fault=self._on_chaos_fault)
        # The program cache (under _lock): bucket -> program, and bucket
        # -> (capacity, program) for the gathered families.
        self._exes: dict = {}
        self._gather_exes: dict = {}
        self._gather_exes_bf16: dict = {}
        self._cpu_exes: dict = {}          # bucket -> CPU-tier callable
        # The engine's dispatch context: its card's default stream, the
        # graph pool, the static tables. On a card every device operation
        # of the engine holds its lock: the static buffers of a program
        # serve one batch at a time.
        self._ctx = _DispatchContext(self._params, self.device)
        self._device_lock = self._ctx.lock
        # Persistence: the lattice is opened once (single-flight).
        self.aot_dir = aot_dir
        self._digest: Optional[str] = None
        self._lattice = None
        self._lattice_loaded = False
        self._lattice_lock = threading.Lock()
        self._lat_leaves = None
        # _lock guards the subject maps, the live table reference and the
        # program cache; _install_lock serializes table installs so the
        # functional row write runs outside _lock (lock order:
        # _install_lock -> _device_lock -> _lock).
        self._lock = threading.Lock()
        self._install_lock = threading.Lock()
        self._table: Optional[core.SubjectTable] = None
        self._table_version = 0            # bumped at every table swap
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
        # The pipelined dispatch: the completion stage (built by the
        # dispatcher at depth > 1; stop()'s wedged branch closes it) and
        # the staging slab pool (recycled once a batch's copy-in has
        # completed; a slab whose batch may still have a copy queued on
        # the card waits behind a fence event first).
        self._completion: Optional[_CompletionStage] = None
        self._slab_pool: collections.deque = collections.deque()
        self._slab_fenced: collections.deque = collections.deque()
        self._slab_lock = threading.Lock()
        # Streaming sessions: the manager is built on the first
        # open_stream; _streams_stopped mirrors stop()/start() so a
        # manager built after (or racing) a stop refuses registrations.
        self._streams = None
        self._streams_stopped = False
        # Dispatch lanes (serving/lanes.py): built at the first warm-up or
        # dispatch, never here.
        self._lane_count = None if lanes is None else int(lanes)
        self._lane_probe = lane_probe
        self._laneset = None
        # The tiered subject store, bound to this engine's counters and
        # device (and lane count: its shards are the lanes' tables); it
        # touches no device at construction.
        if subject_store is not None:
            from mano_hand_tpu_torch.serving.subject_store import (
                SubjectStore,
            )

            if not isinstance(subject_store, SubjectStore):
                raise TypeError(
                    f"subject_store must be a serving.subject_store."
                    f"SubjectStore, got {type(subject_store).__name__}")
            if subject_store.config.sharded and self._lane_count is None:
                raise ValueError(
                    "a sharded subject_store requires lanes (the shards "
                    "are the per-lane tables; pass lanes=N)")
            subject_store.bind(self.counters, device=self.device,
                               n_shards=self._lane_count)
        if store_warm_capacity is not None:
            if subject_store is None:
                raise ValueError(
                    "store_warm_capacity requires subject_store (it "
                    "retargets the warm tier's row budget)")
            subject_store.resize_warm(int(store_warm_capacity))
        self._subject_store = subject_store

    @property
    def tracer(self):
        """The engine's ``obs.Tracer`` (or None): the wiring point for
        ``obs.metrics.engine_registry`` and ``obs.NumericsSentinel``."""
        return self._tracer

    @property
    def posed_kernel(self) -> str:
        return self._posed_kernel

    @property
    def precision_policy(self) -> Optional[PrecisionPolicy]:
        return self._precision_policy

    @property
    def subject_store(self):
        """The engine's ``serving.subject_store.SubjectStore``, or None
        (the device table alone)."""
        return self._subject_store

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
                with self._live_lock:
                    # A restarted engine accepts new streams again.
                    self._streams_stopped = False
                    mgr = self._streams
                if mgr is not None:
                    mgr.reopen()
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
        joins without a bound. Every open stream session reaches its
        ``shutdown`` terminal first.
        """
        with self._live_lock:
            # Marked under the lock the lazy manager build publishes
            # under: an open_stream racing this stop sees a swept manager
            # or builds one born stopped.
            self._streams_stopped = True
            streams_mgr = self._streams
        if streams_mgr is not None:
            streams_mgr.shutdown()
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
                stage = self._completion
                if stage is not None:
                    # A batch wedged in the completion stage wedges the
                    # dispatcher behind it by backpressure: close the
                    # stage so queued batches poison and a blocked submit
                    # wakes; the sweep resolves what a stuck worker holds.
                    stage.close(err)
                    self._completion = None
                if self._laneset is not None:
                    # A short lane drain: the sweep below resolves what a
                    # wedged lane worker holds.
                    self._laneset.stop(timeout_s=1.0)
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
        if self._laneset is not None:
            # The dispatcher is drained: every lane finishes its queued
            # batches, then whatever a wedged lane worker left is
            # poisoned; the sweep below backstops an abandoned worker.
            self._laneset.stop(timeout_s=timeout_s)
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

    def register_subjects(self, betas_batch) -> list:
        """Register many subjects' betas WITHOUT baking a table row — the
        on-ramp of the tiered store: raw betas cost ~40 bytes a subject,
        a baked row ~10 KB of device memory. A registered subject is
        submittable at once; its row bakes, or promotes from a warm or
        cold tier, on its first dispatch (``_resolve_batch``). Returns the
        subject keys in input order (duplicates collapse to one key)."""
        betas_batch = np.ascontiguousarray(
            np.asarray(betas_batch, np.float32).reshape(-1, self._n_shape))
        keys = []
        rows = {}
        for b in betas_batch:
            b = np.ascontiguousarray(b)
            key = hashlib.sha256(b.tobytes()).hexdigest()[:16]
            keys.append(key)
            rows[key] = b
        with self._lock:
            for key, b in rows.items():
                self._subject_betas.setdefault(key, b)
        return keys

    def _prefetch_subject(self, key: Optional[str]) -> None:
        """Start an asynchronous warm -> device promotion the moment a
        subject is known to dispatch soon (coalesce admit, open_stream):
        the copy overlaps the coalesce window instead of stalling the
        install. A hot or unknown key is a dict lookup."""
        store = self._subject_store
        if store is None or key is None:
            return
        with self._lock:
            hot = key in self._subject_slots
        if not hot:
            with self._on_device():
                store.prefetch(key)

    def _install_subject(self, key: str, betas: np.ndarray,
                         protected=(), shaped=None) -> int:
        """Bake ``betas`` and write them into a table row; returns the slot.

        ``shaped`` supplies PRE-BAKED rows (the checkpoint-restore path):
        the shape stage is not re-run, the persisted bytes are written as
        they are (bit identity across the restart), and the install counts
        ``subjects_restored`` instead of ``specializations``. Takes the
        next fresh row, else grows the table (doubling) while under
        ``max_subjects``, else evicts the least-recently-used subject not
        in ``protected`` (the subjects of the batch being resolved, so a
        batch never evicts its own members). A growth makes the warm
        gathered programs stale: they are rebuilt here, counted, so the
        rebuild never lands inside a dispatch.

        Under a subject store a row the warm or cold tier holds is
        promoted instead of baked (its persisted bytes, as a restore: bit
        for bit the bake; counted in the store's hits, not in
        ``specializations``), a row no tier holds is a counted miss, and
        the row an eviction displaces demotes to the warm tier after the
        locks are released.
        """
        restored = shaped is not None
        store = self._subject_store
        tier = None
        if not restored and store is not None:
            # Before the install lock: a promotion's stall never
            # serializes other installers.
            with self._on_device():
                fetched = store.fetch_row(key)
            if fetched is not None:
                rows, tier = fetched
                shaped = core.ShapedHand(
                    rows["v_shaped"], rows["joints"], rows["shape"],
                    self._params.pose_basis, self._params.lbs_weights,
                    tuple(self._params.parents))
            else:
                self.counters.count_store_miss()
        with self._device_lock, self._on_device(), torch.no_grad():
            if shaped is None:
                shaped = core.specialize(
                    self._params, torch.from_numpy(betas).to(self.device))
        victim_table = None
        with self._install_lock:
            grew = False
            evicted = None
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
                    evicted = victim
                    # The victim's row lives on in THIS snapshot (updates
                    # are functional): the demotion below reads it.
                    victim_table = table
            if evicted is not None and self._tracer is not None:
                self._tracer.runtime_event("evict", subject=evicted,
                                           slot=slot)
            prev = table
            with self._device_lock, self._on_device(), torch.no_grad():
                if table is None:
                    table = core.subject_table(self._params, cap)
                elif grew:
                    table = core.table_grow(table, cap)
                    self.counters.count_table_growth()
                table = core.table_set_row(table, slot, shaped)
            with self._lock:
                self._table = table
                self._table_version += 1
                version = self._table_version
                self._subject_slots[key] = slot
                self._subject_lru[key] = None
                stale = ([b for b, (c, _) in self._gather_exes.items()
                          if c != cap] if grew else [])
                stale_bf16 = ([b for b, (c, _)
                               in self._gather_exes_bf16.items()
                               if c != cap] if grew else [])
            lanes = self._laneset
            if lanes is not None:
                # The new row into every lane's replica (or, sharded, its
                # owner's shard table): a row of data movement a lane,
                # never a capture. Still under _install_lock, the table's
                # one mutator, so broadcasts are serialized.
                lanes.broadcast_row(slot, shaped, grew=grew, prev=prev,
                                    table=table, version=version,
                                    digest=key)
        if evicted is not None and store is not None:
            # Outside every lock: the device-to-host copy happens in the
            # store, on the engine's stream (behind the writes that made
            # the snapshot) and synchronously, so the row is on the host
            # before anything can reuse its memory.
            row = core.table_row(victim_table, slot)
            with self._on_device():
                store.demote(evicted, {"v_shaped": row.v_shaped,
                                       "joints": row.joints,
                                       "shape": row.shape})
        if restored:
            self.counters.count_restore()
        elif tier is None:
            self.counters.count_specialize(hit=False)
        for b in stale:
            self._gather_executable(b)
        for b in stale_bf16:
            self._gather_executable(b, prec=BF16)
        return slot

    def _resolve_batch(self, reqs):
        """(table snapshot, per-request slots) of a pose-only batch, from
        one locked read; re-bakes any subject evicted while queued."""
        keys = {r.subject for r in reqs}
        counted_hot = self._subject_store is None
        for _ in range(len(keys) + 2):
            with self._lock:
                missing = [k for k in keys if k not in self._subject_slots]
                if not counted_hot:
                    # The store's hot hits: the batch's subjects already
                    # in the table at its first resolution, once a batch.
                    counted_hot = True
                    if len(keys) > len(missing):
                        self.counters.count_store_hot(
                            len(keys) - len(missing))
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
        tier's family and the stated envelope; with a tracer,
        ``latency_by_tier`` and ``backlog_age_s`` ride along."""
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
        # Streaming sessions: the active count and the per-frame backlog
        # age from one manager-lock hold; the empty block keeps the
        # surface's shape when no stream was ever opened.
        mgr = self._streams
        if mgr is not None:
            out["streams"] = mgr.snapshot()
        else:
            from mano_hand_tpu_torch.serving import streams as streams_mod

            out["streams"] = streams_mod.empty_snapshot()
        ls = self._laneset
        if ls is not None:
            # Per-lane backlog, breaker and ladder counters, one LaneSet
            # lock hold.
            out["lanes"] = ls.snapshot()
        if self._subject_store is not None:
            # Tier occupancy and in-flight promotions, one store-lock hold.
            out["subject_store"] = self._subject_store.snapshot()
        if self._tracer is not None:
            # Per-tier served latency quantiles and the backlog age, from
            # ONE tracer lock hold (obs/trace.py:load_snapshot).
            out.update(self._tracer.load_snapshot())
        return out

    # ------------------------------------------------------ stream sessions
    def _stream_manager(self):
        """The engine's ``StreamManager``, built on first use (a losing
        racer's is discarded). Published under ``_live_lock``, the hold
        ``stop()``/``start()`` flip ``_streams_stopped`` under, so a
        manager built after or racing a stop is born refusing
        registrations."""
        mgr = self._streams
        if mgr is None:
            from mano_hand_tpu_torch.serving.streams import StreamManager

            mgr = StreamManager(self)
            with self._live_lock:
                if self._streams is None:
                    # Not yet published: no other thread holds its lock.
                    mgr._stopped = self._streams_stopped
                    self._streams = mgr
                mgr = self._streams
        return mgr

    def open_stream(self, subject, *, n_steps: int = 4,
                    data_term: str = "joints", solver: str = "lm",
                    frame_deadline_s: Optional[float] = None,
                    idle_timeout_s: Optional[float] = None,
                    resume_pose=None, **tracker_kw):
        """Open one per-user tracking session; returns a
        ``serving.streams.StreamSession``.

        ``subject`` is the user's betas (baked through ``specialize``: an
        unknown subject is a first bake, not an error) or a
        ``specialize()`` key (an evicted key stays valid: its row re-bakes
        or promotes on the next dispatch). Each ``submit_frame(target)``
        runs a frozen-shape LM solve on the engine's device, warm-started
        from the last converged pose (``fitting/tracking.py:make_tracker``),
        then serves the posed verts through ``submit(pose, subject=key)``
        at tier 0 — K2 on a ``posed_kernel="fused"`` card engine — so
        concurrent streams' frames coalesce into mixed-subject batches.
        ``frame_deadline_s`` is each frame's default time to live (fit and
        dispatch; swept before the fit), ``idle_timeout_s`` expires a
        session nobody feeds, ``resume_pose`` seeds the warm start.
        ``n_steps``/``data_term``/``solver``/``tracker_kw`` pass to
        ``make_tracker`` with ``frozen_shape`` pinned to the subject's
        betas. The terminals ``closed``/``expired``/``shed``/``shutdown``
        (``stop()`` sweeps open sessions) each close the session's span
        exactly once."""
        from mano_hand_tpu_torch.serving import streams as streams_mod

        return streams_mod.open_stream(
            self, subject, n_steps=n_steps, data_term=data_term,
            solver=solver, frame_deadline_s=frame_deadline_s,
            idle_timeout_s=idle_timeout_s, resume_pose=resume_pose,
            **tracker_kw)

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
            if self._tracer is not None:
                self._tracer.close(req.span, "expired", phase=phase)
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
        tr = self._tracer
        if tr is not None:
            # Opened after validation (a caller error is not a request),
            # before any resolution path: every terminal kind below
            # closes exactly this span.
            req.span = tr.start("posed" if subject is not None else "full",
                                tier=tier, rows=n)
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
                if tr is not None:
                    tr.close(req.span, "shed")
                    tr.note_shed()      # a sustained burst: one incident
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
        if tr is not None:
            tr.note_admit()             # resets the shed-burst streak
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
        """Build (or load from the lattice) the full family's program of
        each bucket up front — and the CPU tier's too under a policy with
        ``cpu_fallback``, so the first failover does not build during the
        outage. Returns {bucket: "jit" | "aot" | "cached"}: "jit" built
        live in this process (a capture on a card), "aot" loaded from the
        lattice or artifact, "cached" already built. After it, full
        traffic over these buckets builds nothing."""
        out = {}
        bucket_list = self._check_buckets(bucket_list)
        for b in bucket_list:
            with self._lock:
                known = b in self._exes
            if known:
                out[b] = "cached"
                continue
            before = self.counters.aot_loads
            self._executable(b)
            out[b] = "aot" if self.counters.aot_loads > before else "jit"
        if self._policy is not None and self._policy.cpu_fallback:
            for b in bucket_list:
                self._fallback_executable(b)
        if self._lane_count is not None:
            # Lanes serve full traffic from programs of their own: warm
            # every lane's too, so steady traffic and a ladder hop onto
            # any sibling build nothing.
            self._get_lanes().warm(bucket_list, posed=False)
        return out

    def warmup_posed(self, bucket_list: Optional[Sequence[int]] = None,
                     ) -> dict:
        """``warmup`` for the gathered pose-only family at the current
        table capacity (needs one specialized subject, so the table
        exists) — and for the bf16 family too when the precision policy
        names a bf16 tier (always built live: it has no lattice tier).
        Returns {bucket: "jit" | "aot" | "cached"} of the f32 family."""
        bucket_list = self._check_buckets(bucket_list)
        with self._lock:
            table = self._table
        if table is None:
            raise RuntimeError(
                "warmup_posed needs a subject table: specialize() first")
        out = {}
        for b in bucket_list:
            with self._lock:
                entry = self._gather_exes.get(b)
                cap = self._table.capacity
            if entry is not None and entry[0] == cap:
                out[b] = "cached"
                continue
            before = self.counters.aot_loads
            self._gather_executable(b)
            out[b] = "aot" if self.counters.aot_loads > before else "jit"
        if self._bf16_serving():
            for b in bucket_list:
                with self._lock:
                    entry = self._gather_exes_bf16.get(b)
                    cap = self._table.capacity
                if entry is None or entry[0] != cap:
                    self._gather_executable(b, prec=BF16)
        if self._lane_count is not None:
            self._get_lanes().warm(bucket_list, posed=True)
        return out

    # --------------------------------------------------------- dispatch lanes
    @property
    def lane_count(self) -> Optional[int]:
        """Configured dispatch lanes (None: the single-context dispatch)."""
        return self._lane_count

    def _get_lanes(self):
        """The engine's ``LaneSet``, built on first use (never in the
        constructor). A losing racer's set is discarded: it holds no
        thread before its first batch."""
        if self._lane_count is None:
            return None
        ls = self._laneset
        if ls is None:
            from mano_hand_tpu_torch.serving.lanes import LaneSet

            ls = LaneSet(self, self._lane_count, probe=self._lane_probe)
            with self._lock:
                if self._laneset is None:
                    self._laneset = ls
                ls = self._laneset
        return ls

    def _shard_of(self, digest: Optional[str]) -> Optional[int]:
        """The owner lane of one subject under a sharded store (None on an
        unsharded or storeless engine): content-based, so placement holds
        across restarts and registration order."""
        store = self._subject_store
        if store is None or digest is None:
            return None
        return store.shard_for(digest)

    def _check_buckets(self, bucket_list):
        for b in bucket_list or self.buckets:
            if b not in self.buckets:
                raise ValueError(f"{b} is not one of {self.buckets}")
        return list(bucket_list or self.buckets)

    def _bf16_serving(self) -> bool:
        return (self._precision_policy is not None
                and bool(self._precision_policy.bf16_tiers))

    # ------------------------------------------------------------- programs
    def _program(self, body: Callable, bucket: int, capacity=None,
                 table=None, keep=None, ctx=None, eager=False):
        """One program of a family at ``bucket`` (and table ``capacity``
        for a gathered one) in dispatch context ``ctx`` (default: the
        engine's): a CUDA graph on a card, the eager function on the CPU
        or under ``eager``. Built and warmed here; counting is the
        caller's. ``keep`` lives as long as the program (a loaded entry's
        body)."""
        ctx = self._ctx if ctx is None else ctx
        if capacity is None:
            example = (np.zeros((bucket, self._n_joints, 3), np.float32),
                       np.zeros((bucket, self._n_shape), np.float32))
        else:
            example = (np.zeros((bucket,), np.int32),
                       np.zeros((bucket, self._n_joints, 3), np.float32))
        if ctx.stream is not None and not eager:
            return _GraphProgram(ctx, body, example, capacity, keep)
        return _EagerProgram(ctx, body, example, table)

    def _live_full(self, pose, shape):
        return core.forward_batched(self._params, pose, shape).verts

    def _executable(self, bucket: int):
        """The full family's program of one bucket: in memory, then the
        lattice, then the legacy artifact, then built live (counted in
        ``compiles``; with ``aot_dir`` set the live build also writes the
        legacy artifact the next process loads)."""
        with self._lock:
            prog = self._exes.get(bucket)
        if prog is not None:
            return prog
        lat = self._get_lattice()
        if lat is not None:
            call = lat.get("full", bucket, platform=self.device.type)
            if call is not None:
                leaves = self._lattice_leaves()
                prog = self._load_program(
                    f"lattice full/b{bucket}",
                    lambda pose, shape: call(leaves, pose, shape), bucket,
                    family="full")
        if prog is None and self.aot_dir is not None:
            path = self._artifact_path(bucket)
            if path.exists():
                prog = self._load_artifact(path, bucket)
        if prog is None:
            prog = self._program(self._live_full, bucket)
            self._count_compile("full", bucket)
            if self.aot_dir is not None:
                self._write_artifact(bucket)
        with self._lock:
            # Two threads can race the build: first writer wins, so the
            # cache never flips programs under steady traffic.
            return self._exes.setdefault(bucket, prog)

    def _count_compile(self, family: str, bucket: int, **fields) -> None:
        """One live program build: counted, and a ``compile`` event."""
        self.counters.count_compile()
        if self._tracer is not None:
            self._tracer.runtime_event("compile", family=family,
                                       bucket=bucket, **fields)

    def _lattice_event(self, ok: bool, family: str, bucket: int,
                       **fields) -> None:
        if self._tracer is not None:
            self._tracer.runtime_event(
                "lattice_load" if ok else "lattice_load_failed",
                family=family, bucket=bucket, **fields)

    def _load_program(self, what: str, body: Callable, bucket: int,
                      capacity=None, table=None, family=None, ctx=None,
                      **fields):
        """A program over a loaded entry (in context ``ctx``, default the
        engine's), or None when it fails to run here: counted in
        ``aot_loads``, or in ``aot_load_failures`` with a warning (the
        caller then builds it live). ``family`` names a lattice entry's
        family for its ``lattice_load`` / ``lattice_load_failed`` event
        (None: a legacy artifact); ``fields`` ride along on it."""
        cap = {} if capacity is None else {"capacity": capacity}
        cap.update(fields)
        try:
            prog = self._program(body, bucket, capacity, table, keep=body,
                                 ctx=ctx)
        except Exception as e:  # noqa: BLE001 — degrade, never crash boot
            self.counters.count_aot_load_failure()
            _LOG.warning(f"{what} failed at execution ({type(e).__name__}: "
                         f"{e}); building it live (counted)")
            if family is not None:
                self._lattice_event(False, family, bucket, **cap)
            return None
        self.counters.count_aot_load()
        if family is not None:
            self._lattice_event(True, family, bucket, **cap)
        return prog

    def _load_artifact(self, path: Path, bucket: int):
        """The legacy per-bucket artifact (params baked in), or None: a
        truncated, corrupt or foreign file is counted, warned and rebuilt
        (and rewritten) live."""
        from mano_hand_tpu_torch.io.export_aot import load_forward

        try:
            fwd = load_forward(path)
            have = fwd.meta.get("params_digest")
            if have is not None and have != self._params_digest():
                raise ValueError(
                    f"artifact params_digest {have} does not match this "
                    "engine's parameter set — serving it would return "
                    "another asset's meshes")
            if self.device.type not in fwd.platforms:
                raise ValueError(f"artifact exported for {fwd.platforms}")
        except Exception as e:  # noqa: BLE001 — self-heal
            self.counters.count_aot_load_failure()
            _LOG.warning(f"invalid serving artifact {path} "
                         f"({type(e).__name__}: {e}); building it live "
                         "and rewriting it")
            return None
        return self._load_program(f"artifact {path.name}",
                                  lambda pose, shape: fwd(pose, shape)["verts"],
                                  bucket)

    def _write_artifact(self, bucket: int) -> None:
        """Atomic write (temp + rename) of one bucket's legacy artifact: a
        process killed mid-export leaves no artifact or a whole one."""
        from mano_hand_tpu_torch.io.export_aot import export_forward

        Path(self.aot_dir).mkdir(parents=True, exist_ok=True)
        path = self._artifact_path(bucket)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        tmp.write_bytes(export_forward(
            self._params, batch=bucket, platforms=(self.device.type,)))
        os.replace(tmp, path)

    def _artifact_path(self, bucket: int) -> Path:
        return Path(self.aot_dir) / (
            f"serve_{self._params_digest()}_b{bucket}.torchexp")

    def _gather_executable(self, bucket: int, table=None, prec: str = F32):
        """The gathered pose-only program of one bucket at ``table``'s
        capacity (default: the live table's), of the f32 family (K2 under
        ``posed_kernel="fused"``, else the plain gather: in memory, the
        lattice, then built live) or the bf16 family (``prec="bf16"``:
        always built live). Counted like every build; a growth makes the
        cached entry stale. A program built for an older, smaller
        snapshot serves that dispatch uncached, never replacing a newer
        capacity's."""
        if table is None:
            with self._lock:
                table = self._table
        if table is None:
            raise RuntimeError(
                "no specialized subject to warm the pose-only path with; "
                "call specialize(betas) first")
        cap = table.capacity
        cache = self._gather_exes_bf16 if prec == BF16 else \
            self._gather_exes
        with self._lock:
            entry = cache.get(bucket)
        if entry is not None and entry[0] == cap:
            return entry[1]
        fused = self._posed_kernel == "fused"
        prog = None
        if prec == F32 and not fused:
            lat = self._get_lattice()
            call = (None if lat is None else
                    lat.get("gather", bucket, cap, platform=self.device.type))
            if call is not None:
                from mano_hand_tpu_torch.io.export_aot import table_leaves

                prog = self._load_program(
                    f"lattice gather/b{bucket}/c{cap}",
                    lambda tab, idx, pose: call(table_leaves(tab), idx, pose),
                    bucket, cap, table, family="gather")
        if prog is None:
            prog = self._program(
                gather_body(fused, torch.bfloat16 if prec == BF16 else None),
                bucket, cap, table)
            self._count_compile(
                ("gather_fused" if fused else "gather")
                + ("_bf16" if prec == BF16 else ""), bucket, capacity=cap)
        with self._lock:
            cur = cache.get(bucket)
            if cur is not None and cur[0] == cap:
                return cur[1]    # a racing build won at this capacity
            if cur is None or cur[0] < cap:
                cache[bucket] = (cap, prog)
        return prog

    def _fallback_executable(self, bucket: int) -> Callable:
        """The CPU tier's callable of one bucket (CPU engines only): the
        lattice's ``cpu`` entry, else built live — normally by
        ``warmup()``, lazily at a failover on a bucket never warmed.
        Counted either way."""
        with self._lock:
            exe = self._cpu_exes.get(bucket)
        if exe is not None:
            return exe
        lat = self._get_lattice()
        call = None if lat is None else lat.get("cpu", bucket, platform="cpu")
        if call is not None:
            leaves = self._lattice_leaves()

            def run(pose, shape):
                pose, shape = (torch.from_numpy(np.array(x, np.float32,
                                                         order="C"))
                               for x in (pose, shape))
                with torch.no_grad(), ieee_fp32():
                    return call(leaves, pose, shape).numpy()

            try:
                run(np.zeros((bucket, self._n_joints, 3), np.float32),
                    np.zeros((bucket, self._n_shape), np.float32))
                exe = run
                self.counters.count_aot_load()
                self._lattice_event(True, "cpu", bucket)
            except Exception as e:  # noqa: BLE001 — degrade
                self.counters.count_aot_load_failure()
                _LOG.warning(f"lattice cpu/b{bucket} entry failed at "
                             f"execution ({type(e).__name__}: {e}); "
                             "building it live (counted)")
                self._lattice_event(False, "cpu", bucket)
        if exe is None:
            exe = build_cpu_fallback_executable(
                self._params, bucket, self._n_joints, self._n_shape)
            self._count_compile("cpu", bucket)
        with self._lock:
            return self._cpu_exes.setdefault(bucket, exe)

    # ------------------------------------------------------- persistence
    def _params_digest(self) -> str:
        if self._digest is None:
            from mano_hand_tpu_torch.io.export_aot import params_digest

            self._digest = params_digest(self._params)
        return self._digest

    def _lattice_leaves(self) -> tuple:
        if self._lat_leaves is None:
            from mano_hand_tpu_torch.io.export_aot import params_leaves

            self._lat_leaves = params_leaves(self._params)
        return self._lat_leaves

    def _get_lattice(self):
        """The aot_dir's lattice, opened once per engine. A manifest that
        is unreadable, of another schema or baked for another parameter
        set degrades to a counted boot without it
        (``aot_load_failures``)."""
        if self.aot_dir is None:
            return None
        with self._lock:
            if self._lattice_loaded:
                return self._lattice
        with self._lattice_lock:
            with self._lock:
                if self._lattice_loaded:
                    return self._lattice
            from mano_hand_tpu_torch.io.export_aot import load_lattice

            lat = load_lattice(
                self.aot_dir, self._params_digest(),
                on_failure=self._on_lattice_failure)
            with self._lock:
                self._lattice, self._lattice_loaded = lat, True
                return lat

    def _on_lattice_failure(self, key: str, reason: str) -> None:
        """A manifest or entry the lattice refused (damaged, foreign,
        another schema): counted; a refused entry (``full/b8``,
        ``gather/b8/c16``, ``cpu/b8``) is also a ``lattice_load_failed``
        event. The caller then builds the program live."""
        self.counters.count_aot_load_failure()
        if key != "<manifest>":
            family, *rest = key.split("/")
            self._lattice_event(False, family, **{
                ("bucket" if r[0] == "b" else "capacity"): int(r[1:])
                for r in rest})

    def _lattice_capacities(self) -> list:
        """The table-capacity doubling ladder this engine can reach:
        ``_TABLE_INIT_CAPACITY`` doubling up to ``max_subjects``."""
        caps = []
        c = min(self._TABLE_INIT_CAPACITY, self.max_subjects)
        while True:
            caps.append(c)
            if c >= self.max_subjects:
                return caps
            c = min(c * 2, self.max_subjects)

    def bake_lattice(self, *, capacities: Optional[Sequence[int]] = None,
                     include_cpu_fallback: Optional[bool] = None) -> dict:
        """Bake THIS engine's reachable lattice into ``aot_dir``
        (``io/export_aot.py:bake_lattice``): every bucket's full program,
        every (bucket x capacity ladder) gathered program (and, with
        sharded lanes, at the shard tables' capacity) and — when the
        policy enables the CPU tier (or ``include_cpu_fallback=True``) —
        the CPU tier, exported for the engine's device type. A card engine
        has no CPU tier and bakes no ``cpu/`` entries. After
        it, a fresh engine on the same directory loads every one of those
        programs (``warmup``/``warmup_posed`` report "aot"). Returns the
        manifest."""
        if self.aot_dir is None:
            raise ValueError("bake_lattice requires aot_dir")
        from mano_hand_tpu_torch.io.export_aot import bake_lattice

        if include_cpu_fallback is None:
            include_cpu_fallback = bool(
                self._policy is not None and self._policy.cpu_fallback)
        if include_cpu_fallback and self.device.type != "cpu":
            raise ValueError(
                "a card engine has no CPU tier: it bakes no cpu/ entries")
        if capacities is None:
            caps = self._lattice_capacities()
            store = self._subject_store
            if self._lane_count and store is not None and store.sharded:
                # Sharded lanes serve shard tables of a fixed capacity,
                # max_subjects split over the lanes, generally off the
                # doubling ladder: bake it too, or every lane builds its
                # shard programs live at boot.
                shard_cap = max(1, -(-self.max_subjects // self._lane_count))
                if shard_cap not in caps:
                    caps.append(shard_cap)
        else:
            caps = list(capacities)
        manifest = bake_lattice(
            self._params, self.aot_dir, buckets=self.buckets,
            capacities=caps, platforms=(self.device.type,),
            cpu_fallback=include_cpu_fallback)
        with self._lock:
            # Re-open on the next fetch: the bake may have replaced a
            # lattice this engine already gave up on.
            self._lattice_loaded, self._lattice = False, None
        return manifest

    _CKPT_SCHEMA = 1

    def checkpoint_subjects(self, path) -> str:
        """Persist the warm subject table — baked rows, raw betas and LRU
        order — so a restarted process serves every specialized subject
        bit for bit WITHOUT a shape-stage bake (``io/state_ckpt.py``, the
        JAX package's pickle layout: either package restores it).
        Evicted-but-registered subjects ride along as betas only. Taken
        under ``_install_lock``, so it never interleaves with an install.
        """
        from mano_hand_tpu_torch.io import state_ckpt

        with self._install_lock:
            with self._lock:
                table = self._table
                slots = dict(self._subject_slots)
                lru = list(self._subject_lru)
                betas = dict(self._subject_betas)
        live = [k for k in lru if k in slots]       # LRU order, oldest first
        evicted = [k for k in betas if k not in slots]
        if table is not None and live:
            rows = torch.tensor([slots[k] for k in live],
                                device=table.v_shaped.device)
            with self._device_lock:
                v_shaped, joints, shape_rows = (
                    getattr(table, n)[rows].cpu().numpy()
                    for n in ("v_shaped", "joints", "shape"))
        else:
            v_shaped = np.zeros((0, self._params.n_verts, 3), np.float32)
            joints = np.zeros((0, self._n_joints, 3), np.float32)
            shape_rows = np.zeros((0, self._n_shape), np.float32)
        none = np.zeros((0, self._n_shape), np.float32)
        meta = {
            "schema": self._CKPT_SCHEMA,
            "params_digest": self._params_digest(),
            "capacity": table.capacity if table is not None else 0,
            "digests": live,
            "evicted_digests": evicted,
            "dtype": "float32",
        }
        arrays = {
            "betas": np.stack([betas[k] for k in live]) if live else none,
            "v_shaped": v_shaped,
            "joints": joints,
            "shape_rows": shape_rows,
            "evicted_betas": (np.stack([betas[k] for k in evicted])
                              if evicted else none),
        }
        return str(state_ckpt.save_state(meta, arrays, path))

    def restore_subjects(self, path, *, strict: bool = False) -> dict:
        """Revive a ``checkpoint_subjects`` snapshot into this engine.

        Each live subject's BAKED rows are written straight into the table
        (``subjects_restored``; no shape-stage bake), in checkpointed LRU
        order, so eviction priority survives the restart; betas-only
        (evicted) subjects re-register and re-bake on first use. Restores
        go through the same serialized installer as ``specialize()``: a
        subject a racing ``specialize`` already installed is skipped. A
        missing, damaged, foreign or orbax-written checkpoint DEGRADES to
        an empty restore with an ``"error"`` field and a warning (subjects
        re-specialize on demand) unless ``strict=True``."""
        from mano_hand_tpu_torch.io import state_ckpt

        summary = {"restored": 0, "betas_only": 0, "skipped": 0}
        try:
            meta, arrays = state_ckpt.load_state(path)
            if meta.get("schema") != self._CKPT_SCHEMA:
                raise ValueError(
                    f"checkpoint schema {meta.get('schema')} != supported "
                    f"{self._CKPT_SCHEMA}")
            if meta.get("params_digest") != self._params_digest():
                raise ValueError(
                    "checkpoint params_digest does not match this engine's "
                    "parameter set — restoring would serve another asset's "
                    "subjects")
            digests = list(meta.get("digests") or ())
            for name in ("betas", "v_shaped", "joints", "shape_rows"):
                if len(arrays[name]) != len(digests):
                    raise ValueError(
                        f"checkpoint arrays[{name!r}] rows "
                        f"{len(arrays[name])} != {len(digests)} digests")
        except Exception as e:  # noqa: BLE001 — degrade, not crash
            if strict:
                raise
            _LOG.warning(
                f"subject checkpoint {path}: {type(e).__name__}: {e}; "
                "restoring nothing (subjects re-specialize on demand)")
            summary["error"] = f"{type(e).__name__}: {e}"
            return summary
        for k, b in zip(meta.get("evicted_digests") or (),
                        arrays["evicted_betas"]):
            with self._lock:
                self._subject_betas.setdefault(
                    k, np.ascontiguousarray(b, np.float32))
            summary["betas_only"] += 1
        for i, key in enumerate(digests):
            with self._lock:
                present = key in self._subject_slots
            if present:          # a racing specialize() already baked it
                summary["skipped"] += 1
                continue
            with self._device_lock:
                v_shaped, joints, shape = (
                    torch.from_numpy(np.ascontiguousarray(
                        arrays[n][i], np.float32)).to(self.device)
                    for n in ("v_shaped", "joints", "shape_rows"))
            shaped = core.ShapedHand(
                v_shaped, joints, shape, self._params.pose_basis,
                self._params.lbs_weights, tuple(self._params.parents))
            self._install_subject(
                key, np.ascontiguousarray(arrays["betas"][i], np.float32),
                shaped=shaped)
            summary["restored"] += 1
        return summary

    # ------------------------------------------------------------- dispatch
    def _on_device(self):
        """The engine's card as the current device and its default stream
        as the current stream: a supervised attempt or a completion
        worker runs on a thread whose current device is not ours, and a
        caller's thread may have made another stream current. Every
        device operation of the engine's own context goes to that one
        stream, so stream order alone orders its copies, installs and
        replays (a lane's reads of them wait on it: ``wait_upstream``)."""
        return self._ctx.on()

    def _run_full(self, pose: np.ndarray, shape: np.ndarray, *, prog=None,
                  mark=None) -> np.ndarray:
        """The full family's primary: ``prog`` (a cached program: the
        sentinel's probes) or the bucket's program, fetched or built.
        ``mark`` is the batch's ``_Dispatched`` (traced engines only)."""
        if prog is None:
            prog = self._executable(pose.shape[0])
        with self._on_device():
            return prog.run(pose, shape, on_enqueued=mark)

    def _run_posed(self, table, idx: np.ndarray, pose: np.ndarray,
                   compute_dtype=None, *, prog=None, mark=None) -> np.ndarray:
        if prog is None:
            prog = self._gather_executable(
                pose.shape[0], table, F32 if compute_dtype is None else BF16)
        with self._on_device():
            return prog.run(idx, pose, table=table, on_enqueued=mark)

    def _on_chaos_fault(self, kind: Optional[str] = None,
                        index: Optional[int] = None) -> None:
        """The chaos plan's fault hook: the counter, and the fault on the
        timeline (``ChaosPlan.wrap`` passes the kind and call index)."""
        self.counters.count_fault()
        if self._tracer is not None:
            self._tracer.runtime_event("chaos_fault", kind=kind, index=index)

    def numerics_probe_targets(self) -> dict:
        """One consistent read, under one ``_lock`` hold, of every LIVE
        program family: the raw material of ``obs.NumericsSentinel``.

        ``full``, ``gather`` and ``gather_bf16`` map each bucket to a
        callable of its CACHED program behind the same chaos wrap real
        dispatches take (the gathered ones at the current table capacity
        only); ``cpu`` maps a CPU engine's CPU-tier callables. A target
        never builds a program, so a probe captures nothing and leaves
        ``compiles`` as it was. With them: the table snapshot, the
        params, dims and dtype, the precision envelope (when a tier
        serves bf16), the gathered kernel (``posed_kernel``,
        ``gather_fused``) and the engine's ``device`` and
        ``device_lock``, which a probe's references hold on a card."""
        with self._lock:
            cap = self._table.capacity if self._table is not None else None
            full = dict(self._exes)
            gather = {b: p for b, (c, p) in self._gather_exes.items()
                      if c == cap}
            gather_bf16 = {b: p for b, (c, p)
                           in self._gather_exes_bf16.items() if c == cap}
            cpu = dict(self._cpu_exes)
            table = self._table
        posed = self._primary_posed
        return {
            "full": {b: functools.partial(self._primary_full, prog=p)
                     for b, p in full.items()},
            "gather": {b: functools.partial(posed, prog=p)
                       for b, p in gather.items()},
            "gather_bf16": {b: functools.partial(
                posed, compute_dtype=torch.bfloat16, prog=p)
                for b, p in gather_bf16.items()},
            "cpu": cpu,
            "table": table,
            "params": self._params,
            "n_joints": self._n_joints,
            "n_shape": self._n_shape,
            "dtype": "float32",
            "precision_envelope": (
                self._precision_policy.max_vertex_err_m
                if self._bf16_serving() else None),
            "posed_kernel": self._posed_kernel,
            "gather_fused": self._posed_kernel == "fused",
            "device": self.device,
            "device_lock": self._device_lock,
        }

    def _req_prec(self, req: _Request) -> str:
        """The precision family one request is served from: ``"bf16"``
        only for a pose-only request whose tier the policy names; full
        requests, and every request of a policy-less engine, are f32."""
        if self._precision_policy is None or req.subject is None:
            return F32
        return self._precision_policy.dtype_for_tier(req.tier)

    def _admit(self, nxt: _Request, posed: bool, subjects: set,
               rows: int, prec: str = F32,
               shard: Optional[int] = None) -> Optional[str]:
        """Why ``nxt`` cannot join the batch being built, or None:
        ``"kind"`` (full and pose-only never share a batch),
        ``"precision"`` (a batch serves one precision family),
        ``"shard"`` (under a sharded store a batch serves from ONE lane's
        shard table: a request another lane owns waits for a batch bound
        for its lane), ``"overflow"`` (past the largest bucket) or
        ``"subjects"`` (one more distinct subject than the table can
        hold)."""
        if (nxt.subject is not None) != posed:
            return "kind"
        if posed and self._req_prec(nxt) != prec:
            return "precision"
        if posed and shard is not None \
                and self._shard_of(nxt.subject) != shard:
            # Checked before overflow: a cross-shard request keeps the
            # overflow counter honest.
            return "shard"
        if rows + nxt.rows > self.buckets[-1]:
            return "overflow"
        if (posed and nxt.subject not in subjects
                and len(subjects) >= self.max_subjects):
            return "subjects"
        return None

    def _coalesce(self, first: _Request):
        """Gather requests behind ``first`` until the largest bucket fills
        or the coalesce window (``_coalesce_window``) elapses; parked
        requests are tried first. A cancelled or expired request is
        dropped here, never batched or parked. Each admitted request's
        rows are written into a staging slab at admit time, and a
        pose-only request's subject is prefetched from the store's warm
        tier, so both overlap the window. Returns (requests, rows,
        staging)."""
        reqs, rows = [first], first.rows
        posed = first.subject is not None
        prec = self._req_prec(first)
        shard = self._shard_of(first.subject) if posed else None
        subjects = {first.subject}
        top = self.buckets[-1]
        staging = self._staging_acquire(posed)
        staging.append(first)
        if posed:
            self._prefetch_subject(first.subject)

        def admit(nxt, fresh=True) -> Optional[str]:
            if self._skip_cancelled(nxt):
                return "cancelled"
            if self._is_expired(nxt):
                self._expire(nxt, "coalesce")
                return "expired"
            why = self._admit(nxt, posed, subjects, rows, prec, shard)
            if why is None:
                reqs.append(nxt)
                staging.append(nxt)
                subjects.add(nxt.subject)
                if posed:
                    self._prefetch_subject(nxt.subject)
                if self._tracer is not None:
                    self._tracer.event(nxt.span, "coalesce")
                return None
            self._pending.append(nxt)
            if self._tracer is not None:
                self._tracer.event(nxt.span, "park", why=why)
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
        deadline = time.perf_counter() + self._coalesce_window(first)
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
        return reqs, rows, staging

    def _coalesce_window(self, first: _Request) -> float:
        """How long ``_coalesce`` may wait for stragglers this batch: the
        base ``max_delay_s`` when traffic is sparse; zero once the waiting
        backlog could fill the largest bucket; scaled down linearly with
        the backlog below that; and decayed as the head request's age
        climbs to many multiples of the base (a head one dispatch cycle
        old barely charges: charging it would thin every batch under
        paced load). ``adaptive_coalesce=False`` pins the fixed window.
        The window only shapes how long assembly waits, never which
        requests may share a batch."""
        base = self.max_delay_s
        if not self.adaptive_coalesce or base <= 0.0:
            return base
        backlog = self._queue.qsize() + len(self._pending)
        cap = self.buckets[-1]
        if backlog + 1 >= cap:
            return 0.0
        age = time.perf_counter() - first.t_submit
        pressure = max(backlog / cap, min(1.0, age / (8.0 * base)))
        return base * (1.0 - pressure)

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
        # At inflight_depth > 1 launched batches go to a bounded
        # completion stage (dispatch and readback, the deadline re-check,
        # the futures and the spans on its workers, delivered in launch
        # order), so batch N+1 assembles while batch N executes. Depth 1
        # keeps the serial assemble -> launch -> read back -> resolve
        # cycle on this thread: no stage, no "staged" stamps, no pipeline
        # event.
        stage = None
        if self.inflight_depth > 1 and self._lane_count is None:
            # (Lane mode bypasses the stage: each lane worker is its own
            # FIFO, and the lanes are the overlap.)
            stage = _CompletionStage(self, self.inflight_depth)
            self._completion = stage
            if self._tracer is not None:
                self._tracer.runtime_event("pipeline",
                                           depth=self.inflight_depth)
        try:
            while True:
                first = (self._pop_parked() if self._pending
                         else self._queue.get())
                if first is _SENTINEL:
                    if stage is not None:
                        stage.check()       # a worker's engine-fatal fault
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
                reqs, rows, staging = self._coalesce(first)
                item = self._launch(reqs, rows, staging)
                if item is not None:
                    self._resolve(item)     # the serial cycle
            if stage is not None:
                # Clean exit: every launched batch resolves before the
                # queue drains (a stage failure re-raises here).
                stage.drain()
                stage.close()
                self._completion = None
            self._drain()
        except BaseException as e:  # noqa: BLE001 — futures must not hang
            self._failure = e
            if stage is not None:
                stage.close(e)
                self._completion = None
            self._poison(list(self._pending), e)
            self._pending.clear()
            self._drain(e)
            raise

    def _staging_acquire(self, posed: bool) -> _Staging:
        """One assembly slab set from the pool (allocated when the pool is
        dry): pinned host memory on a card engine. Fenced slabs whose
        event has completed rejoin the pool first."""
        with self._slab_lock:
            while self._slab_fenced and all(
                    e.query() for e in self._slab_fenced[0][0]):
                self._slab_pool.append(self._slab_fenced.popleft()[1])
            st = self._slab_pool.pop() if self._slab_pool else None
        if st is None:
            cap = self.buckets[-1]
            st = _Staging(*(self._host_slab(shape, dtype) for shape, dtype
                            in (((cap, self._n_joints, 3), np.float32),
                                ((cap, self._n_shape), np.float32),
                                ((cap,), np.int32))))
        st.rows = 0
        st.full = not posed
        return st

    def _host_slab(self, shape, dtype) -> np.ndarray:
        """A host array for staging: a numpy view of a pinned tensor on a
        card engine (the view keeps the tensor alive)."""
        if self.device.type != "cuda":
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=_torch_dtype(np.empty(0, dtype)),
                           pin_memory=True).numpy()

    def _staging_release(self, st: Optional[_Staging],
                         fence: bool = False, contexts=None) -> None:
        """Recycle a batch's slab once its copy-in has completed on the
        card (bounded pool: the in-flight depth or the lane count, one
        assembling, one spare; a surplus slab goes to the allocator).
        ``fence``: the batch did not end in a completed readback — a
        supervised attempt abandoned after its launch may still have a
        copy from this slab queued — so the slab waits behind an event
        recorded on the stream of each context that may have copied from
        it (``contexts``; default the engine's), each under its lock
        (every launch there so far has enqueued its copies), until the
        card has passed them all."""
        if st is None:
            return
        if fence and self.device.type == "cuda":
            events = []
            for ctx in (contexts or (self._ctx,)):
                done = torch.cuda.Event()
                with ctx.lock, ctx.on():
                    done.record(ctx.stream)
                events.append(done)
            with self._slab_lock:
                # Never dropped here: freeing a slab a queued copy still
                # reads would hand its memory to the allocator early.
                self._slab_fenced.append((events, st))
            return
        with self._slab_lock:
            if len(self._slab_pool) < max(self.inflight_depth,
                                          self._lane_count or 0) + 2:
                self._slab_pool.append(st)

    def _launch(self, reqs, rows: int, staging: Optional[_Staging] = None):
        """Sweep, pad and dispatch one batch. Pipelined, hand it to the
        completion stage and return None; serial, return the item
        ``_resolve`` delivers. Without a policy a failure resolves the
        batch's futures with the exception and stops the dispatcher; with
        one, an exhausted batch resolves to its ``ServingError`` and the
        dispatcher goes on."""
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
                self._staging_release(staging)
                return None
            if len(alive) != len(reqs):
                # The staged slab has holes where swept members sat: this
                # (rare) batch re-stacks its rows instead.
                self._staging_release(staging)
                staging = None
                reqs, rows = alive, sum(r.rows for r in alive)
        tr = self._tracer
        mark = None
        try:
            bucket = bucket_mod.bucket_for(rows, self.buckets)
            if tr is not None:
                # The launch boundary: the queue and coalesce wait ends.
                for r in reqs:
                    tr.event(r.span, "launch", bucket=bucket)
                mark = _Dispatched(tr, reqs)
            kw = {} if mark is None else {"mark": mark}
            posed = reqs[0].subject is not None
            if staging is not None:
                # The rows were written at admit time; what remains is the
                # pad fill, pad_rows' bytes.
                pose, shape = staging.finish(bucket)
            else:
                pose = bucket_mod.pad_rows(
                    np.concatenate([r.pose for r in reqs]), bucket)
                shape = None if posed else bucket_mod.pad_rows(
                    np.concatenate([r.shape for r in reqs]), bucket)
            if self._lane_count is not None:
                # Lane mode: the least-backlogged healthy lane (a sharded
                # store's batch: its owner lane) runs the dispatch, the
                # ladder and the futures; the slab goes with the batch and
                # its lane returns it. A pose-only batch resolves its
                # subjects in the lane's worker, against the table that
                # lane serves from.
                if mark is not None:
                    mark.close()     # the lane stamps its own
                self._get_lanes().submit_batch(
                    bucket, pose, shape, posed, reqs, rows, staging=staging,
                    shard=(self._shard_of(reqs[0].subject) if posed
                           else None))
                return None
            prec = self._req_prec(reqs[0])
            bf16 = prec == BF16
            dt = torch.bfloat16 if bf16 else None
            table = idx = None
            n_subjects = 1
            if posed:
                # Resolved here, not on the stage's worker: the (table,
                # slots) pair is a functional snapshot, valid however
                # installs move the live table while the batch waits.
                table, slots = self._resolve_batch(reqs)
                idx = bucket_mod.subject_index_rows(
                    slots, [r.rows for r in reqs], bucket)
                if staging is not None:
                    idx = staging.put_idx(idx)
                n_subjects = len(set(slots))
            stage = self._completion
            if stage is not None:
                # Pipelined: the dispatch, its readback and the futures
                # run on the stage's worker, in launch order. An
                # unsupervised batch's program is fetched HERE, so a
                # build stays on the dispatcher.
                if self._policy is not None:
                    def fn():
                        return self._supervised_dispatch(
                            bucket, pose, shape, reqs, table, idx, prec,
                            mark)
                elif posed:
                    self._gather_executable(bucket, table, prec)

                    def fn():
                        return self._run_posed(table, idx, pose, dt, **kw)
                else:
                    self._executable(bucket)

                    def fn():
                        return self._run_full(pose, shape, **kw)
                if tr is not None:
                    # Stamped before the submit: a submit blocked on the
                    # stage's backpressure is stage wait. Counts this
                    # batch in.
                    depth_now = stage.inflight() + 1
                    for r in reqs:
                        tr.event(r.span, "staged", inflight=depth_now)
                n = stage.submit(fn, reqs, rows, bucket, n_subjects,
                                 staging, bf16, mark, posed)
                self.counters.observe_pipeline_inflight(n)
                return None
            if self._policy is not None:
                verts = self._supervised_dispatch(bucket, pose, shape, reqs,
                                                  table, idx, prec, mark)
            elif posed:
                verts = self._run_posed(table, idx, pose, dt, **kw)
            else:
                verts = self._run_full(pose, shape, **kw)
            self.counters.count_dispatch(bucket, rows, requests=len(reqs),
                                         subjects=n_subjects, bf16=bf16,
                                         gathered=posed)
            if mark is not None:
                mark()          # unless the replay's enqueue stamped it
            return verts, reqs, bucket, staging
        except ServingError as e:
            # Supervision exhausted for THIS batch: a failed batch is
            # traffic, not a broken engine; later submits stay servable.
            if mark is not None:
                mark.close()
            self._poison(reqs, e)
            self._staging_release(staging, fence=True)
            return None
        except BaseException as e:
            if mark is not None:
                mark.close()
            self._poison(reqs, e)
            self._staging_release(staging, fence=True)
            raise

    def _resolve(self, item) -> None:
        """The serial cycle's delivery: the batch's readback has run (the
        program's ``run`` waited for it), so its slab is free again."""
        verts, reqs, bucket, staging = item
        self._staging_release(staging)
        self._deliver(reqs, verts, bucket)

    def _supervised_dispatch(self, bucket: int, pose, shape, reqs, table,
                             idx, prec: str = F32, mark=None) -> np.ndarray:
        """One batch through the fault-tolerance envelope: supervised
        primary attempts (deadline + classified retries with backoff,
        breaker-gated), then the CPU tier, then a structured
        ``ServingError``. Deterministic failures are neither retried nor
        failed over: they propagate and stay engine-fatal. The readback
        to the host is part of each attempt, so a wedged kernel is killed
        at its deadline like a wedged call. The program is fetched (so
        possibly built) before the attempts, outside their deadline: a
        build is warm-up-class work, and each attempt finds it cached. A build that fails resolves the batch
        to a ``ServingError`` and counts as a breaker failure."""
        pol = self._policy
        breaker = pol.breaker
        try:
            if table is None:
                self._executable(bucket)
            else:
                self._gather_executable(bucket, table, prec)
        except Exception as e:  # noqa: BLE001 — the batch's error, counted
            if breaker is not None:
                breaker.record_failure()
            raise ServingError(
                f"bucket {bucket}'s program failed to build "
                f"({type(e).__name__}: {e})", cause=e) from e
        kw = {} if mark is None else {"mark": mark}
        if table is not None:
            dt = torch.bfloat16 if prec == BF16 else None

            def primary():
                return self._primary_posed(table, idx, pose, dt, **kw)
        else:
            def primary():
                return self._primary_full(pose, shape, **kw)
        tr = self._tracer
        if tr is None:
            on_retry = self.counters.count_retry
            on_kill = self.counters.count_deadline_kill
        else:
            def on_retry():
                self.counters.count_retry()
                tr.runtime_event("retry", bucket=bucket)

            def on_kill():
                # An abandoned worker: an incident, not just a counter.
                self.counters.count_deadline_kill()
                tr.incident("deadline_kill", bucket=bucket)
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
                    on_retry=on_retry,
                    on_deadline_kill=on_kill,
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
            if tr is not None:
                tr.incident("failover", bucket=bucket, attempts=attempts)
            _LOG.warning(
                f"bucket {bucket} failed over to the CPU tier "
                f"after {attempts} primary attempt(s)"
                + ("" if last is None
                   else f" ({type(last).__name__}: {last})"),
                RuntimeWarning, stacklevel=3)
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

    def _deliver(self, reqs, verts, bucket: int) -> None:
        """Slice one completed batch back into its requests' futures. A
        result past its request's deadline resolves as expired, and one
        whose future was cancelled or swept meanwhile is discarded."""
        now = time.monotonic()
        tr = self._tracer
        lo = 0
        for r in reqs:
            piece = verts[lo:lo + r.rows]
            lo += r.rows
            if tr is not None:
                # The batch is on the host: what remains per request is
                # the slice and the future (the "readback" stage).
                tr.event(r.span, "readback")
            if self._is_expired(r, now):
                self._expire(r, "readback")
                continue
            if self._set_result_safe(r, piece[0] if r.squeeze else piece):
                self.counters.count_served(r.tier)
                if tr is not None:
                    tr.close(r.span, "ok", bucket=bucket)
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
        if self._tracer is not None:
            self._tracer.close(req.span, "cancelled", phase="cancel")
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

    @staticmethod
    def _terminal_kind(exc: Optional[BaseException]) -> str:
        """The span-close kind of an exception-resolved future: the
        ``ServingError.kind`` the caller sees; any other exception is an
        engine ``error``."""
        if isinstance(exc, ServingError):
            return exc.kind
        return "shutdown" if exc is None else "error"

    def _close_span(self, req: _Request, exc, phase: str) -> None:
        if self._tracer is not None:
            self._tracer.close(req.span, self._terminal_kind(exc),
                               phase=phase)

    def _sweep_live(self, exc: BaseException) -> None:
        with self._live_lock:
            reqs, self._live = list(self._live.values()), {}
        for r in reqs:
            if self._set_exception_safe(r, exc):
                self._close_span(r, exc, "sweep")

    def _poison(self, reqs, exc: BaseException) -> None:
        for r in reqs:
            if self._set_exception_safe(r, exc):
                self._close_span(r, exc, "poison")
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
            err = exc if exc is not None else ServingError(
                "serving engine stopped before this request was "
                "dispatched", phase="shutdown")
            if self._set_exception_safe(req, err):
                self._close_span(req, err, "drain")
            self._deregister(req)
