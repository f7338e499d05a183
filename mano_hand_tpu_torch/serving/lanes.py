"""Dispatch lanes with a sibling failover ladder.

The port of the JAX package's ``serving/lanes.py``. ``ServingEngine(lanes=N)``
keeps its one dispatcher (coalescing is a host policy: split per lane, it
would fragment batches) and hands each assembled batch to a LANE:

* **N lanes** over ``parallel.lane_devices``. On one card a lane is a CUDA
  stream of that card with a dispatch context of its own
  (``engine._DispatchContext``): its own lock over its programs' static
  buffers, its own CUDA-graph memory pool (graphs that share a pool must
  not replay at once, and lanes replay at once), its own static tables,
  its own programs of every family (the full forward, the gathered f32
  family — K2 under ``posed_kernel="fused"`` — and the bf16 family under
  a ``PrecisionPolicy``), a worker thread and, under a policy, a
  ``CircuitBreaker``. A CPU engine's lanes run eager programs on the CPU.
  Placement takes the least-backlogged healthy lane, ties round-robin.
* **The subject table mirrored into each lane.** A lane's replica is its
  static table of the table's capacity, refreshed from the batch's
  snapshot (``_StaticTable.refresh``: a copy only when the snapshot
  differs from the one it holds, so a lane always serves exactly the
  snapshot its batch resolved against, whatever installs happened
  since); ``broadcast_row`` writes a newly installed row into every
  replica in place (a row of data movement a lane, never a capture), and
  a growth re-adopts and rebuilds the lane's gathered programs, counted
  like the engine's own growth builds.
* **Or split, not mirrored.** Under a sharded ``SubjectStore`` lane *k*
  holds the rows of shard *k* only (``shard_for``) in a shard table of
  fixed capacity, ``ceil(max_subjects / N)`` rows: its static table of
  that capacity, written in place and read in place by its graphs. The
  slot map swaps under one ``_lock`` hold and the rows land under the
  lane's device lock on its stream; a dispatch reads its slots and
  launches under that same lock, so the rows it gathers are the rows its
  slots name. The engine's ``_admit`` splits cross-shard batches
  and a posed batch is placed on its owner lane while that lane is
  healthy. Ladder hops and an owner lane's outage serve from the engine's
  snapshot instead (an eager program on a card: no static table of the
  engine's size on a sharded lane). On an owner lane's loss its shard is
  reassigned to the survivors (``rebalance_shard``), and handed back once
  the lane is healthy again (``SubjectStore.restore_shard``).
* **The failover ladder** (``runtime/health.py:failover_ladder``): an
  exhausted batch tries each healthy sibling once, least-loaded first,
  then the CPU tier of a ``device="cpu"`` engine. A card engine has no
  CPU tier: there the ladder ends at the siblings and an exhausted batch
  resolves to its ``ServingError``. Failback captures nothing: a lane's
  programs stay built while its breaker is open.
* **Per-lane chaos and telemetry.** Each lane's dispatch consults the
  policy's chaos plan with its lane index, so a ``%LANE`` event kills
  one lane while its siblings serve. Every lane counter mutates under the
  ONE ``LaneSet._lock``, so ``load()["lanes"]`` is one hold's snapshot;
  spans get a ``lane`` event, breaker changes and ladder hops are runtime
  events and incidents.

Streams. A lane's stream does not wait for the card's default stream,
where the engine makes its subject tables and baked rows, so every read
of them waits on it first (``wait_upstream``: an event behind the
engine's work so far, and ``record_stream`` so their memory is not
reused before the lane is done). Within a lane, stream order keeps batch
N's readback ahead of batch N+1's replay, as on the engine's one stream.
A staging slab goes to the lane with its batch and comes back once the
lane's readback has landed (its copy-in before it, by stream order); a
batch that did not end in a readback on the lane that copied in fences
its slab behind an event on the stream of every lane it was launched on.
An attempt killed at its deadline leaves its queued work on its own
lane's stream only: a retry on a sibling waits for nothing of it (it
reads the pinned slab, which nobody writes until the fence has passed,
and its own lane's buffers).

Locks. ``_lock`` guards placement, telemetry and the table references
only: no device work runs inside it. ``_resolve_lock`` lets one lane at a
time resolve a batch against the engine's table (concurrent resolutions
would evict each other's subjects from a full table; the single
dispatcher never races itself). Program builds hold the engine's
process-wide build lock and then the lane's device lock; installs the
resolve lock, then the engine's install lock, then the lane's device
lock; nothing that holds a device lock waits for any of the others.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.obs import log as obs_log
from mano_hand_tpu_torch.runtime import health, supervise
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.serving.engine import (
    ServingError, _DispatchContext, _Dispatched, gather_body,
)
from mano_hand_tpu_torch.serving.precision import BF16, F32

_SENTINEL = object()

_LOG = obs_log.get_logger("serving.lanes")


class _ShardMoved(Exception):
    """A row of the batch left the lane's shard table between the batch's
    resolution and its launch (a racing install reused its slot): the
    lane resolves again. Deterministic to supervision: never retried
    there, never a breaker failure."""

    transient = False


def _call(fn):
    return fn()


def _full_body(params, pose, shape):
    return core.forward_batched(params, pose, shape).verts


class Lane:
    """One dispatch lane: a device, a dispatch context (stream, lock,
    graph pool, static tables), its programs and its replica or shard
    table, a work queue, a worker thread and a breaker. Telemetry fields
    mutate only under the owning ``LaneSet._lock``."""

    def __init__(self, index: int, device: torch.device, breaker, ctx):
        self.index = index
        self.device = device
        self.breaker = breaker
        self.ctx = ctx
        self.call = _call            # the dispatch, chaos-wrapped per lane
        self.q: queue.Queue = queue.Queue()
        self.worker: Optional[threading.Thread] = None
        self.lat_leaves = None       # the lattice's params leaves
        # Replicated: the engine snapshot the replica derives from, and
        # the engine table version it is. Sharded: the shard table.
        self.table = None
        self.table_version = -1
        self.exes: dict = {}         # bucket -> full program
        self.gather_exes: dict = {}  # bucket -> (capacity, program)
        self.gather_exes_bf16: dict = {}
        #   Sharded lanes key both by (bucket, capacity, kind), kind
        #   "shard" (the shard table's graphs) or "snapshot" (the engine
        #   snapshot's fallback).
        self.shard_slots: dict = {}          # digest -> local slot
        self.shard_lru = collections.OrderedDict()  # digest -> None
        self.shard_next_slot = 0             # first never-used local row
        # -- telemetry (LaneSet._lock) --
        self.backlog_batches = 0     # queued + in flight
        self.backlog_rows = 0
        self.inflight = 0            # batches executing right now
        self.assigned = 0            # batches ever placed here
        self.dispatched = 0          # batches that reached a device
        self.served_requests = 0     # requests resolved ok by this lane
        self.failovers_out = 0       # batches this lane handed up-ladder
        self.failovers_in = 0        # sibling batches this lane absorbed
        self.cpu_failovers = 0       # batches that fell through to CPU
        self.errors = 0              # batches resolved as ServingError


class LaneSet:
    """The engine's lanes: placement, workers, the replica broadcast or
    the shard tables, and the failover ladder. Built by
    ``ServingEngine`` at its first warm-up or dispatch."""

    def __init__(self, engine, n: int,
                 probe: Optional[Callable[[int], bool]] = None):
        from mano_hand_tpu_torch.parallel import lane_devices
        from mano_hand_tpu_torch.runtime.health import CircuitBreaker

        if n < 1:
            raise ValueError(f"lanes must be >= 1, got {n}")
        self._eng = engine
        self._lock = threading.Lock()
        # One lane resolves a batch against the engine's table at a time:
        # concurrent resolutions would evict each other's subjects from a
        # full table until one gives up, where the single dispatcher
        # resolves one batch at a time.
        self._resolve_lock = threading.Lock()
        self._rr = 0    # equal-backlog tie-break cursor (placement)
        store = engine._subject_store
        self._sharded = bool(store is not None and store.sharded)
        # Shards whose rebalance thread was started (under _lock): one
        # rebalance a dead shard, never a spawn storm.
        self._rebalance_kicked: set = set()
        devs = []
        for d in lane_devices(n, platform=engine.device.type):
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        self.n_devices = len({str(d) for d in devs})
        pol = engine._policy
        proto = getattr(pol, "breaker", None) if pol is not None else None
        tracer = engine._tracer
        self.lanes = []
        for i, dev in enumerate(devs):
            breaker = None
            if pol is not None:
                # The policy's breaker is the TEMPLATE: thresholds and
                # cadence copied, state not shared (one sick lane must not
                # open its siblings'). ``probe`` overrides it per lane.
                kw = {}
                if proto is not None:
                    kw = dict(
                        failure_threshold=proto.failure_threshold,
                        probe_interval_s=proto.probe_interval_s,
                        probe_backoff=proto.probe_backoff,
                        probe_interval_cap_s=proto.probe_interval_cap_s,
                        respect_priority_claim=(
                            proto.respect_priority_claim),
                        probe=proto.probe,
                        clock=proto.clock,
                    )
                if probe is not None:
                    kw["probe"] = (lambda i=i: bool(probe(i)))
                breaker = CircuitBreaker(**kw)
                if tracer is not None:
                    breaker.on_transition = (
                        lambda old, new, i=i: tracer.runtime_event(
                            "lane_breaker", lane=i, old=old, new=new))
                elif proto is not None and proto.on_transition is not None:
                    breaker.on_transition = proto.on_transition
            lane = Lane(i, dev, breaker, self._context(dev))
            if pol is not None and pol.chaos is not None:
                lane.call = pol.chaos.wrap(
                    _call, on_fault=engine._on_chaos_fault, lane=i)
            self.lanes.append(lane)

    def _context(self, dev: torch.device) -> _DispatchContext:
        """A lane's dispatch context: on a card a stream of its own whose
        upstream is the engine's stream, on the CPU eager programs. Its
        lock is a real one on the CPU too: a shard table's rows change in
        place under it."""
        eng = self._eng
        params = eng._params
        if dev != eng.device:
            params = params.to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if dev.type != "cuda":
            return _DispatchContext(params, dev, lock=threading.RLock())
        up = eng._ctx.stream
        stream = torch.cuda.Stream(dev)
        # Everything the engine enqueued so far (its params among it)
        # before anything of this lane.
        stream.wait_stream(up)
        return _DispatchContext(params, dev, stream=stream, upstream=up,
                                lock=threading.RLock())

    # ------------------------------------------------------------ placement
    def submit_batch(self, bucket: int, pose, shape, posed: bool, reqs,
                     rows: int, staging=None,
                     shard: Optional[int] = None) -> None:
        """Place one assembled batch on the least-backlogged healthy lane
        (every lane down: the least-backlogged anyway, whose worker walks
        the ladder) and wake its worker. ``staging`` (the batch's slab)
        goes with it and the lane returns it. ``shard``: a sharded
        store's owner lane, where placement pins while it is healthy.
        Called by the engine's dispatcher thread only."""
        with self._lock:
            lane = self._place_locked(rows, shard)
            lane.assigned += 1
            lane.backlog_batches += 1
            lane.backlog_rows += rows
            if lane.worker is None or not lane.worker.is_alive():
                lane.worker = threading.Thread(
                    target=self._worker, args=(lane,),
                    name=f"mano-lane-{lane.index}", daemon=True)
                lane.worker.start()
        for ln in self.lanes:
            # Failback: placement avoids a DOWN lane, so nothing else
            # would re-probe it. A due re-probe runs on a disposable
            # thread (the breaker single-flights it and backs off).
            if (ln.breaker is not None and ln is not lane
                    and ln.breaker.probe_due()):
                threading.Thread(
                    target=ln.breaker.allow_primary,
                    name=f"mano-lane-{ln.index}-probe",
                    daemon=True).start()
        tr = self._eng._tracer
        if tr is not None:
            for r in reqs:
                tr.event(r.span, "lane", lane=lane.index)
        lane.q.put((bucket, pose, shape, posed, reqs, rows, staging))

    def _place_locked(self, rows: int, shard: Optional[int] = None) -> Lane:
        # Caller holds self._lock. A dead shard whose lane is healthy
        # again is handed back first.
        store = self._eng._subject_store
        if self._sharded:
            for dead in store.reassigned_shards():
                if self._healthy(self.lanes[dead]):
                    self._rebalance_kicked.discard(dead)
                    self._restore_locked(dead)
        if shard is not None:
            owner = self.lanes[shard]
            if self._healthy(owner):
                return owner
            if self._sharded and shard not in self._rebalance_kicked:
                # Owner lane DOWN: its shard is adopted by the survivors
                # off this thread (the adoption is device work); once a
                # shard, re-armed if it fails.
                self._rebalance_kicked.add(shard)
                threading.Thread(
                    target=self._rebalance_kick, args=(shard,),
                    name=f"mano-shard-rebalance-{shard}",
                    daemon=True).start()
        # Backlog = queued + in-flight rows; ties rotate round-robin, so a
        # low-rate stream still spreads over the lanes, deterministically.
        cands = [ln for ln in self.lanes if self._healthy(ln)]
        if not cands:
            cands = self.lanes
        n = len(self.lanes)
        lane = min(cands, key=lambda ln: (ln.backlog_rows,
                                          (ln.index - self._rr) % n))
        self._rr = (lane.index + 1) % n
        return lane

    @staticmethod
    def _healthy(lane: Lane) -> bool:
        return lane.breaker is None or lane.breaker.state != health.DOWN

    # ----------------------------------------------------------- lane state
    def _lane_lat_leaves(self, lane: Lane):
        """The lane's params as the lattice's runtime leaves."""
        if lane.lat_leaves is None:
            from mano_hand_tpu_torch.io.export_aot import params_leaves

            lane.lat_leaves = params_leaves(lane.ctx.params)
        return lane.lat_leaves

    def _adopt(self, lane: Lane):
        """Re-derive the lane's replica from the engine's live table: the
        table and its version read under one engine-lock hold, the static
        table of its capacity refreshed on the lane's stream (warm-up-class
        data movement), the reference swapped only forward. Returns the
        lane's (table, version)."""
        eng = self._eng
        if self._sharded:
            return self._adopt_shard(lane)
        with eng._lock:
            src = eng._table
            v = eng._table_version
        if src is None:
            raise RuntimeError(
                "no specialized subject to replicate into lanes; call "
                "specialize(betas) first")
        ctx = lane.ctx
        if ctx.stream is not None:
            with ctx.lock, ctx.on(), torch.no_grad():
                ctx.static_table(src.capacity).refresh(src, ctx.wait_upstream)
        with self._lock:
            if lane.table is None or lane.table_version < v:
                lane.table, lane.table_version = src, v
            return lane.table, lane.table_version

    # ---------------------------------------------------------- shard tables
    def _effective_shard(self, digest: str) -> int:
        """The digest's owner lane: the store's shard map, rebalance
        overlay included (so adoption, broadcast and the sharded resolve
        agree with the engine's ``_admit`` and the dispatcher's shard
        tags), else the content placement."""
        store = self._eng._subject_store
        if store is not None:
            s = store.shard_for(digest)
            if s is not None:
                return s
        from mano_hand_tpu_torch.serving.subject_store import shard_of

        return shard_of(digest, len(self.lanes))

    def _shard_capacity_max(self) -> int:
        """A shard table's rows: ``max_subjects`` split evenly over the
        lanes (ceiling)."""
        return max(1, -(-self._eng.max_subjects // len(self.lanes)))

    def _adopt_shard(self, lane: Lane):
        """(Re)fill ``lane``'s shard table from the engine's live state:
        the rows this lane owns, most recently used first, up to its
        budget. The first-use path of a lane no broadcast has reached.
        Returns the lane's (table, version)."""
        eng = self._eng
        with eng._lock:
            src = eng._table
            v = eng._table_version
            owned = [d for d in eng._subject_lru
                     if self._effective_shard(d) == lane.index]
            eslots = {d: eng._subject_slots[d] for d in owned}
        if src is None:
            raise RuntimeError(
                "no specialized subject to shard into lanes; call "
                "specialize(betas) first")
        owned = owned[-self._shard_capacity_max():]   # LRU keeps the tail
        rows = {d: core.table_row(src, eslots[d]) for d in owned}
        self._install_shard_rows(lane, rows, version=v)
        with self._lock:
            return lane.table, lane.table_version

    def _install_shard_rows(self, lane: Lane, rows: dict,
                            version: Optional[int] = None) -> bool:
        """Write ``rows`` (digest -> ``ShapedHand``) into ``lane``'s shard
        table and swap its slot map and LRU in one ``_lock`` hold.

        The shard table is the lane's static table of the budget's
        capacity, allocated once and never resized, so its graphs'
        shapes and addresses stay fixed and steady traffic captures
        nothing. Never-used rows fill first, then the local LRU row not
        among ``rows`` is reused. Runs under the lane's device lock, where
        a dispatch reads its slots and launches: a launch sees the slot
        map and the rows of one swap, and installers take turns (JAX
        stages a new table outside any lock and needs an epoch to refuse
        a racing swap; here no swap can race). Returns False when ``rows``
        exceeds the budget (the dispatch then serves the engine's
        snapshot)."""
        cap = self._shard_capacity_max()
        if len(rows) > cap:
            return False
        ctx = lane.ctx
        with ctx.lock:
            with self._lock:
                slots = dict(lane.shard_slots)
                lru = list(lane.shard_lru)
                nxt = lane.shard_next_slot
            assign = {}
            for d in rows:
                if d in slots:
                    assign[d] = slots[d]
                elif nxt < cap:
                    assign[d] = slots[d] = nxt
                    nxt += 1
                else:
                    victim = next((k for k in lru if k not in rows), None)
                    if victim is None:       # rows wider than the budget
                        return False
                    s = slots.pop(victim)
                    lru.remove(victim)
                    assign[d] = slots[d] = s
                if d in lru:
                    lru.remove(d)
                lru.append(d)
            with ctx.on(), torch.no_grad():
                st = ctx.static_table(cap)
                st.source = st.table     # read in place, never refreshed
                st.put_rows({assign[d]: shaped for d, shaped in rows.items()},
                            ctx.wait_upstream)
            with self._lock:
                lane.table = st.table
                lane.shard_slots = slots
                lane.shard_lru = collections.OrderedDict(
                    (k, None) for k in lru)
                lane.shard_next_slot = nxt
                if version is not None:
                    lane.table_version = version
        return True

    # -------------------------------------------------------- shard rebalance
    def _rebalance_kick(self, dead: int) -> None:
        """The placement's rebalance thread: on failure, re-arm the kick
        guard so a later placement tries again."""
        ok = False
        try:
            ok = self.rebalance_shard(dead)
        except Exception as e:  # noqa: BLE001 — the dispatcher must survive
            _LOG.warning(
                f"shard {dead} rebalance failed "
                f"({type(e).__name__}: {e}); will retry on next "
                "owner-down placement")
        if not ok:
            with self._lock:
                self._rebalance_kicked.discard(dead)

    def rebalance_shard(self, dead: int) -> bool:
        """Adopt a dead lane's shard onto the surviving lanes.

        First the store's reassignment overlay (``reassign_shard``: the
        dead shard's digests spread over the survivors by a second
        content hash), which re-routes admission, the shard tags,
        placement and the sharded resolve at once, since each asks
        ``shard_for``; then the dead shard's engine-hot rows go into their
        adopters' shard tables. The rest re-enters lazily through the
        engine's ``_resolve_batch`` (the store's warm and cold tiers).
        Captures nothing. Idempotent (the overlay decides); counted in
        ``shard_rebalances``. Returns whether this call installed the
        overlay."""
        from mano_hand_tpu_torch.serving.subject_store import shard_of

        eng = self._eng
        store = eng._subject_store
        if not self._sharded or store is None:
            return False
        n = len(self.lanes)
        if not 0 <= dead < n:
            raise ValueError(f"shard {dead} out of range [0, {n})")
        with self._lock:
            survivors = [ln.index for ln in self.lanes
                         if ln.index != dead and self._healthy(ln)]
        if not survivors:
            return False     # every lane down: the ladder serves alone
        try:
            if not store.reassign_shard(dead, survivors):
                return False             # someone already adopted it
        except ValueError as e:
            # A survivor went DOWN or was reassigned since the pick: no
            # overlay landed.
            _LOG.warning(f"shard {dead} reassignment rejected: {e}")
            return False
        # The rows whose CONTENT placement is the dead shard move.
        with eng._lock:
            src = eng._table
            owned = [d for d in eng._subject_lru if shard_of(d, n) == dead]
            eslots = {d: eng._subject_slots[d] for d in owned}
        moved = 0
        if src is not None and owned:
            by_owner: dict = {}
            for d in owned:
                by_owner.setdefault(self._effective_shard(d), []).append(d)
            cap = self._shard_capacity_max()
            for idx, ds in sorted(by_owner.items()):
                rows = {d: core.table_row(src, eslots[d])
                        for d in ds[-cap:]}    # LRU keeps the tail
                if self._install_shard_rows(self.lanes[idx], rows):
                    moved += len(rows)
        eng.counters.count_shard_rebalance(rows=moved)
        tr = eng._tracer
        if tr is not None:
            tr.runtime_event("shard_rebalance", shard=dead,
                             survivors=list(survivors), rows=moved)
        _LOG.warning(
            f"shard {dead} rebalanced onto lanes {survivors} "
            f"({moved} hot row(s) adopted eagerly)")
        return True

    def _restore_locked(self, dead: int) -> bool:
        """Hand a rebalanced shard back to its lane once it is healthy
        again (the failback mirror of ``rebalance_shard``): drops the
        store's overlay (``SubjectStore.restore_shard``); the lane's own
        rows re-enter through the same lazy path. Caller holds ``_lock``
        (the store's lock is a leaf). Returns whether an overlay was
        removed."""
        store = self._eng._subject_store
        if store is None or not store.restore_shard(dead):
            return False
        tr = self._eng._tracer
        if tr is not None:
            tr.runtime_event("shard_restore", shard=dead)
        return True

    def _lane_table(self, lane: Lane):
        """The lane's replica or shard table, adopted on first use: the
        warm-up and build entry point. Dispatch does not rely on it being
        current (each batch serves the snapshot it resolved against)."""
        with self._lock:
            tab = lane.table
        if tab is not None:
            return tab
        return self._adopt(lane)[0]

    def broadcast_row(self, slot: int, shaped, grew: bool, prev, table,
                      version: int, digest: Optional[str] = None) -> None:
        """Mirror one installed row into the lanes, called by the engine's
        ``_install_subject`` after its table swap, still under its install
        lock (the table's one mutator: broadcasts are serialized).
        ``table`` is the new engine snapshot and ``prev`` the one it was
        made from. A lane whose replica is exactly one version behind
        takes the row in place (in each static table that holds ``prev``:
        a row of data movement, never a capture); a growth, a gap or a
        lane without a replica re-adopts the table, and a growth also
        rebuilds the lane's gathered programs at the new capacity, counted
        like the engine's own growth builds.

        Sharded: the row goes to its owner lane's shard table only."""
        if self._sharded:
            if digest is not None:
                self._install_shard_rows(
                    self.lanes[self._effective_shard(digest)],
                    {digest: shaped}, version=version)
            return
        for lane in self.lanes:
            with self._lock:
                tab, v = lane.table, lane.table_version
            if tab is None:
                self._adopt(lane)
                continue
            if v >= version and not grew:
                continue    # a racing adoption already has it
            if grew or v != version - 1:
                self._adopt(lane)
                if grew:
                    self._rebuild_stale_gather(lane)
                continue
            ctx = lane.ctx
            if ctx.stream is not None:
                with ctx.lock, ctx.on(), torch.no_grad():
                    st = ctx.static_tables.get(table.capacity)
                    if st is not None and st.source is prev:
                        st.put_rows({slot: shaped}, ctx.wait_upstream)
                        st.source = table
            with self._lock:
                if lane.table_version == v:
                    lane.table, lane.table_version = table, version

    def _rebuild_stale_gather(self, lane: Lane) -> None:
        """Rebuild a lane's gathered programs of a stale capacity (both
        families) after a growth, so a growth build never lands inside a
        lane's dispatch."""
        with self._lock:
            cap = None if lane.table is None else lane.table.capacity
            stale = [b for b, (c, _) in lane.gather_exes.items()
                     if c != cap]
            stale_bf16 = [b for b, (c, _) in lane.gather_exes_bf16.items()
                          if c != cap]
        if cap is None:
            return
        for b in stale:
            self._gather_executable(lane, b)
        for b in stale_bf16:
            self._gather_executable(lane, b, prec=BF16)

    # --------------------------------------------------------------- programs
    def _full_executable(self, lane: Lane, bucket: int):
        """The lane's full program of one bucket: the lattice entry with
        the lane's params as its runtime leaves, else built live (counted,
        a ``compile`` event with the lane)."""
        with self._lock:
            prog = lane.exes.get(bucket)
        if prog is not None:
            return prog
        eng = self._eng
        prog = None
        lat = eng._get_lattice()
        call = (None if lat is None else
                lat.get("full", bucket, platform=lane.device.type))
        if call is not None:
            leaves = self._lane_lat_leaves(lane)
            prog = eng._load_program(
                f"lane {lane.index}: lattice full/b{bucket}",
                lambda pose, shape: call(leaves, pose, shape), bucket,
                family="full", ctx=lane.ctx, lane=lane.index)
        if prog is None:
            prog = eng._program(functools.partial(_full_body,
                                                  lane.ctx.params),
                                bucket, ctx=lane.ctx)
            eng._count_compile("full", bucket, lane=lane.index)
        with self._lock:
            return lane.exes.setdefault(bucket, prog)

    def _gather_executable(self, lane: Lane, bucket: int, tab=None,
                           prec: str = F32):
        """``(program, table)`` of the gathered family ``prec`` at
        ``tab``'s capacity on ``lane`` (``tab`` default: the lane's replica
        or shard table). The family follows the engine's: K2 under
        ``posed_kernel="fused"``, the bf16 family under ``prec="bf16"``,
        so a ladder hop or a failback never changes a request's kernel or
        precision. The f32 plain family loads from the lattice first.

        A sharded lane keys its programs by (bucket, capacity, kind):
        ``"shard"`` programs are graphs over the shard table itself;
        ``"snapshot"`` programs (the fallback over the engine's snapshot)
        run eagerly, so no static table of the engine's size stays on the
        lane."""
        if tab is None:
            tab = self._lane_table(lane)
        cap = tab.capacity
        eng = self._eng
        cache = (lane.gather_exes_bf16 if prec == BF16
                 else lane.gather_exes)
        snapshot = False
        key = bucket
        if self._sharded:
            with self._lock:
                snapshot = tab is not lane.table
            key = (bucket, cap, "snapshot" if snapshot else "shard")
        with self._lock:
            entry = cache.get(key)
        if entry is not None and entry[0] == cap:
            return entry[1], tab
        fused = eng.posed_kernel == "fused"
        prog = None
        if prec == F32 and not fused and not snapshot:
            lat = eng._get_lattice()
            call = (None if lat is None else
                    lat.get("gather", bucket, cap,
                            platform=lane.device.type))
            if call is not None:
                from mano_hand_tpu_torch.io.export_aot import table_leaves

                prog = eng._load_program(
                    f"lane {lane.index}: lattice gather/b{bucket}/c{cap}",
                    lambda t, idx, pose: call(table_leaves(t), idx, pose),
                    bucket, cap, tab, family="gather", ctx=lane.ctx,
                    lane=lane.index)
        if prog is None:
            prog = eng._program(
                gather_body(fused, torch.bfloat16 if prec == BF16 else None),
                bucket, cap, tab, ctx=lane.ctx, eager=snapshot)
            eng._count_compile(
                ("gather_fused" if fused else "gather")
                + ("_bf16" if prec == BF16 else ""), bucket, capacity=cap,
                lane=lane.index)
        with self._lock:
            cur = cache.get(key)
            if cur is not None and cur[0] == cap:
                return cur[1], tab
            if self._sharded or cur is None or cur[0] < cap:
                cache[key] = (cap, prog)
        return prog, tab

    def warm(self, buckets: Sequence[int], *, posed: bool) -> None:
        """Build every lane's programs for ``buckets`` up front (both
        precision families under a bf16 tier, so a ladder hop never builds
        mid-outage). Sharded lanes also build the fallback over the
        engine's snapshot, so an owner lane's outage or a hop costs no
        build in traffic."""
        eng = self._eng
        snap = None
        if posed and self._sharded:
            with eng._lock:
                snap = eng._table
        precs = (F32, BF16) if posed and eng._bf16_serving() else (F32,)
        for lane in self.lanes:
            for b in buckets:
                if not posed:
                    self._full_executable(lane, b)
                    continue
                for prec in precs:
                    self._gather_executable(lane, b, prec=prec)
                    if snap is not None:
                        self._gather_executable(lane, b, snap, prec=prec)

    # --------------------------------------------------------------- dispatch
    def _attempt_fn(self, target: Lane, item, mark, snapshot=False):
        """One rung's dispatch on ``target`` as a callable, resolved and
        fetched here, outside any attempt's deadline (a build is
        warm-up-class work). The index of a pose-only batch comes from the
        slots THIS rung resolved, never from placement time."""
        bucket, pose, shape, posed, reqs, rows, _ = item
        if not posed:
            prog = self._full_executable(target, bucket)
            return lambda: prog.run(pose, shape, on_enqueued=mark)
        prec = self._eng._req_prec(reqs[0])
        sizes = [r.rows for r in reqs]
        table, slots = self._resolve_for_lane(target, reqs, snapshot)
        if table is None:
            return self._shard_fn(target, bucket, pose, reqs, prec, mark)
        prog, table = self._gather_executable(target, bucket, table, prec)
        idx = bucket_mod.subject_index_rows(slots, sizes, bucket)
        return lambda: prog.run(idx, pose, table=table, on_enqueued=mark)

    def _resolve_for_lane(self, lane: Lane, reqs, snapshot: bool = False):
        """What one pose-only batch serves from on ``lane``: ``(None,
        None)`` when its rows are resident in the lane's shard table (the
        launch reads their slots under the lane's lock), else the
        engine's table snapshot and the batch's slots, from one
        consistent read. JAX proves a replica's version against the slots
        (an eviction reuses slots); here a lane serves the snapshot itself
        (its static table refreshes by identity), so the pair is
        consistent by construction, whatever installs happen while the
        batch waits. ``snapshot`` forces the engine's snapshot."""
        if self._sharded and not snapshot and self._resolve_sharded(
                lane, reqs):
            return None, None
        with self._resolve_lock:
            return self._eng._resolve_batch(reqs)

    def _resolve_sharded(self, lane: Lane, reqs) -> bool:
        """Whether a batch whose subjects ``lane`` owns is resident in its
        shard table, missing rows pulled in first through the engine's
        ``_resolve_batch`` (which re-bakes or promotes and counts them).
        False for a foreign batch (a ladder hop, an owner lane's outage)
        or rows the shard table cannot hold: the engine's snapshot serves
        those."""
        eng = self._eng
        digests = [r.subject for r in reqs]
        if any(self._effective_shard(d) != lane.index for d in digests):
            return False
        for attempt in range(2):
            with self._lock:
                resident = lane.table is not None and all(
                    d in lane.shard_slots for d in digests)
                if resident:
                    for d in digests:
                        lane.shard_lru.move_to_end(d)
            if resident:
                # The shard's fast path never reaches _resolve_batch, so
                # its hot hit is counted here.
                eng.counters.count_store_hot(len(set(digests)))
                return True
            if attempt:
                return False
            with self._resolve_lock:
                src, eslots = eng._resolve_batch(reqs)
            self._install_shard_rows(
                lane, {d: core.table_row(src, s)
                       for d, s in zip(digests, eslots)})
        return False

    def _shard_fn(self, lane: Lane, bucket: int, pose, reqs, prec: str,
                  mark):
        """The dispatch of a batch resident in ``lane``'s shard table: it
        reads the slots and launches under the lane's device lock, where
        installs write the rows, and raises ``_ShardMoved`` if a racing
        install took a row away since the resolution."""
        digests = [r.subject for r in reqs]
        sizes = [r.rows for r in reqs]
        prog, tab = self._gather_executable(lane, bucket, prec=prec)
        ctx = lane.ctx

        def fn():
            with ctx.lock:
                with self._lock:
                    slots = [lane.shard_slots.get(d) for d in digests]
                if any(s is None for s in slots):
                    raise _ShardMoved(
                        "a row left the shard table before the launch")
                idx = bucket_mod.subject_index_rows(slots, sizes, bucket)
                handle = prog.launch(idx, pose, table=tab,
                                     on_enqueued=mark)
            return prog.wait(handle)

        return fn

    def _rung(self, target: Lane, item, mark, call):
        """Run one rung on ``target``: ``call(fn)`` runs the rung's
        dispatch (``target.call`` behind it). A shard row that moved
        before the launch resolves again; a third time serves the
        engine's snapshot, which cannot move."""
        for tries in range(3):
            fn = self._attempt_fn(target, item, mark, snapshot=tries == 2)
            try:
                return call(fn)
            except _ShardMoved:
                continue
        raise AssertionError("unreachable: the snapshot rung cannot move")

    def _worker(self, lane: Lane) -> None:
        while True:
            item = lane.q.get()
            if item is _SENTINEL:
                return
            try:
                self._run_batch(lane, item)
            except BaseException as e:  # noqa: BLE001 — futures must not hang
                # A lane is one of N: poison THIS batch, count it, and keep
                # the lane serving (unlike the single dispatcher, where a
                # deterministic failure is engine-fatal).
                self._eng._poison(item[4], e)
                with self._lock:
                    lane.errors += 1
                _LOG.warning(
                    f"lane {lane.index} batch failed "
                    f"({type(e).__name__}: {e}); batch poisoned, "
                    "lane worker continues")

    def _run_batch(self, lane: Lane, item) -> None:
        bucket, pose, shape, posed, reqs, rows, staging = item
        eng = self._eng
        tr = eng._tracer
        n_subjects = len({r.subject for r in reqs}) if posed else 1
        bf16 = posed and eng._req_prec(reqs[0]) == BF16
        tried: list = []     # lanes a launch may have copied the slab on
        done = [None]        # the lane whose readback landed
        mark = None
        with self._lock:
            lane.inflight += 1
        try:
            # An ALL-dead batch (every member cancelled or expired while
            # queued behind this lane) buys no dispatch.
            now = time.monotonic()
            if all(r.future.cancelled() or eng._is_expired(r, now)
                   for r in reqs):
                for r in reqs:
                    if not eng._skip_cancelled(r):
                        eng._expire(r, "dispatch")
                return
            if tr is not None:
                mark = _Dispatched(tr, reqs, lane=lane.index)
            try:
                if eng._policy is None:
                    tried.append(lane)
                    out = self._rung(lane, item, mark, lane.call)
                    done[0] = lane
                else:
                    out = self._ladder_dispatch(lane, item, mark, tried,
                                                done)
            except ServingError as e:
                # Supervision and the whole ladder exhausted for THIS
                # batch: a failed batch is traffic, the lane lives on.
                self._release_staging(staging, tried, done[0])
                staging = None
                if mark is not None:
                    mark.close()
                with self._lock:
                    lane.errors += 1
                eng._poison(reqs, e)
                return
            except BaseException:
                if mark is not None:
                    mark.close()
                raise
            # The slab is done with before the futures resolve.
            self._release_staging(staging, tried, done[0])
            staging = None
            eng.counters.count_dispatch(bucket, rows, requests=len(reqs),
                                        subjects=n_subjects, bf16=bf16,
                                        gathered=posed)
            with self._lock:
                lane.dispatched += 1
            if mark is not None:
                mark()            # unless the launch stamped it
            eng._deliver(reqs, out, bucket)
            with self._lock:
                lane.served_requests += sum(
                    1 for r in reqs
                    if r.future.done() and not r.future.cancelled()
                    and r.future.exception() is None)
        finally:
            with self._lock:
                lane.inflight -= 1
                lane.backlog_batches -= 1
                lane.backlog_rows -= rows
            self._release_staging(staging, tried, done[0])

    def _release_staging(self, staging, tried: list, done) -> None:
        """Return a batch's staging slab: at once when the lane that read
        it back was the only one to copy from it (its copy-in landed
        before its readback, by stream order), else behind a fence on the
        stream of every other lane it was launched on."""
        fence = list({id(ln): ln.ctx for ln in tried
                      if ln is not done}.values())
        self._eng._staging_release(staging, fence=bool(fence),
                                   contexts=fence)

    def _ladder_dispatch(self, lane: Lane, item, mark, tried: list,
                         done: list):
        """One batch through the failover LADDER: the supervised primary
        on its lane, then one supervised attempt on each healthy sibling
        (least-loaded first), then the CPU tier of a ``device="cpu"``
        engine; the expired-members sweep between rungs. Raises
        ``ServingError`` when every rung is exhausted; a deterministic
        failure propagates unretried. ``tried`` collects the lanes
        launched on, ``done[0]`` the lane whose dispatch completed."""
        bucket, pose, shape, posed, reqs, rows, _ = item
        eng = self._eng
        pol = eng._policy
        tr = eng._tracer
        give_up_by = supervise.batch_give_up_by(r.deadline for r in reqs)

        def attempt_on(target: Lane, retries: int):
            br = target.breaker

            def on_retry():
                eng.counters.count_retry()
                if tr is not None:
                    tr.runtime_event("retry", bucket=bucket,
                                     lane=target.index)

            def on_kill():
                eng.counters.count_deadline_kill()
                if tr is not None:
                    tr.incident("deadline_kill", bucket=bucket,
                                lane=target.index)

            def supervised(fn):
                return supervise.supervised_call(
                    lambda: target.call(fn),
                    deadline_s=pol.deadline_s,
                    retries=retries,
                    backoff_s=pol.backoff_s,
                    backoff_cap_s=pol.backoff_cap_s,
                    jitter=pol.jitter,
                    give_up_by=give_up_by,
                    keep_trying=(br.allow_primary if br is not None
                                 else None),
                    on_retry=on_retry,
                    on_deadline_kill=on_kill,
                    on_attempt_failure=(br.record_failure
                                        if br is not None else None),
                    name=f"lane{target.index}-dispatch-b{bucket}",
                )

            tried.append(target)
            out = self._rung(target, item, mark, supervised)
            done[0] = target
            return out

        last = None
        attempts = 0
        if lane.breaker is None or lane.breaker.allow_primary():
            try:
                out = attempt_on(lane, pol.retries)
                if lane.breaker is not None:
                    lane.breaker.record_success()
                return out
            except supervise.RetriesExhausted as e:
                last, attempts = e.cause, e.attempts

        def all_expired() -> Optional[ServingError]:
            # Between rungs: once every member has expired, no further
            # rung may dispatch.
            now = time.monotonic()
            if not all(r.future.cancelled() or eng._is_expired(r, now)
                       for r in reqs):
                return None
            for r in reqs:
                if not eng._skip_cancelled(r):
                    eng._expire(r, "failover")
            return ServingError(
                f"every request in the batch expired during the lane "
                f"attempts ({attempts}); the ladder stops here — no "
                "caller would read the result",
                phase="failover", kind="expired",
                attempts=attempts, cause=last)

        err = all_expired()
        if err is not None:
            raise err

        # -- middle rung: healthy siblings, least-loaded first ----------
        with self._lock:
            backlog = {ln.index: ln.backlog_rows for ln in self.lanes}
        order = health.failover_ladder(
            lane.index, len(self.lanes), backlog,
            allow=lambda i: self._healthy(self.lanes[i]))
        hopped = False
        for j in order:
            sib = self.lanes[j]
            if sib.breaker is not None and not sib.breaker.allow_primary():
                continue
            if not hopped:
                hopped = True
                with self._lock:
                    lane.failovers_out += 1
            with self._lock:
                sib.failovers_in += 1
            if tr is not None:
                tr.incident("lane_failover", bucket=bucket,
                            from_lane=lane.index, to_lane=sib.index)
            try:
                out = attempt_on(sib, 0)   # one supervised try a rung
                if sib.breaker is not None:
                    sib.breaker.record_success()
                return out
            except supervise.RetriesExhausted as e:
                last = e.cause
                attempts += e.attempts
            err = all_expired()
            if err is not None:
                raise err

        # -- last rung: the CPU tier of a CPU engine ---------------------
        if pol.cpu_fallback:
            eng.counters.count_failover()
            with self._lock:
                lane.cpu_failovers += 1
            if tr is not None:
                tr.incident("failover", bucket=bucket, lane=lane.index,
                            attempts=attempts)
            _LOG.warning(
                f"lane {lane.index}: bucket {bucket} failed over to the "
                f"CPU tier after {attempts} attempt(s) on the lanes"
                + ("" if last is None
                   else f" ({type(last).__name__}: {last})"),
                RuntimeWarning, stacklevel=3)
            fb_shape = eng._fallback_shape(reqs, bucket, shape,
                                           posed=posed)
            fb = eng._fallback_executable(bucket)
            try:
                return supervise.call_with_deadline(
                    lambda: fb(pose, fb_shape), pol.deadline_s,
                    name=f"lane{lane.index}-fallback-b{bucket}")
            except BaseException as e:
                raise ServingError(
                    f"dispatch failed on lane {lane.index}, every "
                    f"sibling rung, AND the CPU fallback "
                    f"({attempts} attempt(s)): {type(e).__name__}: {e}",
                    attempts=attempts, cause=e) from e
        raise ServingError(
            f"dispatch failed: lane {lane.index} "
            + ("unavailable (breaker open)" if last is None
               else f"exhausted after {attempts} attempt(s): "
                    f"{type(last).__name__}: {last}")
            + ", every sibling rung failed or is down, and "
            "cpu_fallback is disabled",
            attempts=attempts, cause=last)

    # -------------------------------------------------------------- telemetry
    def snapshot(self) -> dict:
        """The ``load()["lanes"]`` block: every lane's backlog, breaker
        state and ladder counters from ONE ``_lock`` hold
        (``assigned_total`` is summed in the same hold, so it always
        equals the per-lane sum)."""
        with self._lock:
            per = []
            for ln in self.lanes:
                per.append({
                    "lane": ln.index,
                    "device": str(ln.device),
                    "state": (ln.breaker.state if ln.breaker is not None
                              else health.HEALTHY),
                    # Device rows of the lane's table / rows holding a
                    # subject: a replica's residency is its capacity, a
                    # shard table holds its slot-mapped digests only.
                    "table_capacity": (ln.table.capacity
                                       if ln.table is not None else 0),
                    "resident_rows": (len(ln.shard_slots)
                                      if self._sharded else
                                      (ln.table.capacity
                                       if ln.table is not None else 0)),
                    "backlog_batches": ln.backlog_batches,
                    "backlog_rows": ln.backlog_rows,
                    "inflight": ln.inflight,
                    "assigned": ln.assigned,
                    "dispatched": ln.dispatched,
                    "served_requests": ln.served_requests,
                    "failovers_out": ln.failovers_out,
                    "failovers_in": ln.failovers_in,
                    "cpu_failovers": ln.cpu_failovers,
                    "errors": ln.errors,
                })
            return {
                "n_lanes": len(self.lanes),
                "n_devices": self.n_devices,
                "sharded": self._sharded,
                "healthy": sum(1 for p in per
                               if p["state"] != health.DOWN),
                "assigned_total": sum(p["assigned"] for p in per),
                "backlog_rows_total": sum(p["backlog_rows"]
                                          for p in per),
                "per_lane": per,
            }

    # -------------------------------------------------------------- lifecycle
    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Drain and stop every lane worker; poison whatever stays
        queued. A wedged worker is abandoned (daemon): the engine's final
        sweep resolves its batch's futures."""
        with self._lock:
            workers = [(ln, ln.worker) for ln in self.lanes]
        for ln, _ in workers:
            ln.q.put(_SENTINEL)
        join_s = timeout_s if timeout_s is not None else 30.0
        deadline = time.monotonic() + join_s
        for ln, w in workers:
            if w is not None and w.is_alive():
                w.join(max(0.0, deadline - time.monotonic()))
        for ln, w in workers:
            while True:
                try:
                    item = ln.q.get_nowait()
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    continue
                self._eng._poison(item[4], ServingError(
                    "serving engine stopped before this batch's lane "
                    "dispatched it", phase="shutdown"))
                self._eng._staging_release(item[6])
                with self._lock:
                    # The worker's finally never ran for a drained item:
                    # release its backlog here, or a restarted engine
                    # places around phantom load.
                    ln.backlog_batches -= 1
                    ln.backlog_rows -= item[5]
            if w is not None and w.is_alive():
                # The drain may have eaten the worker's sentinel: an
                # abandoned worker that ever unwinds must find one.
                ln.q.put(_SENTINEL)
