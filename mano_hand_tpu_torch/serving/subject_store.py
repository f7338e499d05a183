"""Tiered subject store: page many subjects through device, host and disk.

The port of the JAX package's ``serving/subject_store.py``. The engine's
device ``SubjectTable`` is the HOT tier and stays the one source of what
a dispatch gathers from; this module adds the two tiers under it and the
shard map of a lane fleet:

* **warm** — an evicted row lands as PINNED host tensors in a bounded LRU
  (``warm_capacity``); a later dispatch PROMOTES the row back instead of
  re-running the shape stage. ``prefetch`` (called at coalesce admit and
  ``open_stream``, where a dispatch is known to be coming) starts the
  host-to-device copy asynchronously on a side stream and records an
  event behind it; ``fetch_row`` makes the installing stream wait on that
  event before any copy can read the rows, and times what the install
  still waited for into ``subject_store_promotion_ms``.
* **cold** — warm-LRU overflow pages rows to disk as the port's row pages
  (``io/state_ckpt.py``: JAX's pickle layout, one directory per subject
  digest with a sha256 per array). A damaged page never errors a request:
  the load degrades to a counted re-bake (``subject_store_cold_damage``).
  JAX's ``backend`` knob ("orbax" | "pickle") maps to this one layout.

* **shards** — under ``sharded=True`` (an engine with ``lanes=N``) lane
  *k* holds rows only for the subjects of shard *k* in a shard table of
  its own (``serving/lanes.py``), so N lanes hold N disjoint slices
  instead of N replicas. ``shard_for`` is the owner lane, and
  ``reassign_shard`` spreads a dead lane's subjects over the survivors
  until ``restore_shard`` hands them back.

``subject_digest`` and ``shard_of`` are JAX's, bit for bit: the digest is
``ServingEngine.specialize``'s key, the shard map the placement of a lane
fleet. A sharded store needs an engine with lanes.

Locking: the store's ``_lock`` is a leaf — taken with no engine lock held
by the store, nothing taken under it, and no device work inside it.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# The baked row's arrays: the checkpoint schema of
# ``ServingEngine.checkpoint_subjects``. "shape" IS the digest preimage
# (the float32 betas ``specialize`` hashed), so a cold page verifies
# itself without a sidecar.
ROW_KEYS = ("v_shaped", "joints", "shape")


def subject_digest(betas) -> str:
    """The engine's subject key of float32 betas (``specialize``'s
    hashing)."""
    if torch.is_tensor(betas):
        betas = betas.detach().cpu().numpy()
    return hashlib.sha256(
        np.ascontiguousarray(betas).tobytes()).hexdigest()[:16]


def shard_of(digest: str, n_shards: int) -> int:
    """Content-based subject -> shard placement: stable across restarts,
    independent of registration order, uniform over sha256 prefixes."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return int(digest[:8], 16) % n_shards


@dataclass
class SubjectStoreConfig:
    """Tier sizing for one :class:`SubjectStore`.

    ``warm_capacity``: most rows held on the host (past it the LRU row
    pages to ``cold_dir`` when set, else it is dropped and its next
    dispatch re-bakes). ``cold_dir``: the row-page directory (None: no
    cold tier). ``sharded``: lanes hold disjoint shard tables instead of
    replicas (the engine refuses it without lanes). ``backend``: JAX's
    cold-page
    serialization knob, accepted for parity; every page is the pickle
    layout."""

    warm_capacity: int = 1024
    cold_dir: Optional[str] = None
    sharded: bool = False
    backend: Optional[str] = None

    def __post_init__(self):
        if self.warm_capacity < 1:
            raise ValueError(
                f"warm_capacity must be >= 1, got {self.warm_capacity}")
        if self.backend not in (None, "orbax", "pickle"):
            raise ValueError(f"backend must be 'orbax' or 'pickle', "
                             f"got {self.backend!r}")


def _host_row(row, pin: bool) -> dict:
    """A row's arrays as host tensors (pinned for a card engine), copied
    synchronously: a device row is on the host when this returns."""
    out = {}
    for k in ROW_KEYS:
        v = row[k]
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.array(v))
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        host.copy_(v)
        out[k] = host
    return out


class SubjectStore:
    """The warm and cold tiers under one serving engine.

    One store binds to ONE engine (``ServingEngine(subject_store=...)``
    calls :meth:`bind` with its counters and device); every mutation runs
    on engine threads under the store's leaf lock.
    """

    def __init__(self, config: Optional[SubjectStoreConfig] = None, **kw):
        self.config = config if config is not None else SubjectStoreConfig(
            **kw)
        self._lock = threading.Lock()
        self._warm: "OrderedDict[str, dict]" = OrderedDict()
        # digest -> (device rows, event or None) of an in-flight
        # promotion; consumed (popped) by fetch_row on the install path.
        self._promotions: dict = {}
        self._cold_index: set = set()
        self._counters = None
        self._device = torch.device("cpu")
        self._side = None               # the card's promotion stream
        self._n_shards: Optional[int] = None
        # Dead shard -> the surviving shards adopting its subjects.
        # ``shard_for`` remaps through it, so admission, placement and
        # the lanes' shard tables agree on the new owner the moment it
        # lands. Values are tuples swapped whole: readers take no lock.
        self._reassigned: dict = {}
        if self.config.cold_dir is not None:
            # Adopt the pages a previous process left: paging is a
            # persistence layer, not per-process scratch.
            from mano_hand_tpu_torch.io import state_ckpt

            self._cold_index.update(
                state_ckpt.list_row_pages(self.config.cold_dir))

    # ------------------------------------------------------------- attach
    def bind(self, counters, device=None,
             n_shards: Optional[int] = None) -> None:
        """Attach to an engine's counters and device, and to its lane
        count when sharded. Binding to a second engine is a wiring
        bug."""
        with self._lock:
            if self._counters is not None and self._counters is not counters:
                raise RuntimeError(
                    "SubjectStore is already bound to another engine")
            self._counters = counters
            if device is not None:
                self._device = torch.device(device)
            if n_shards is not None:
                self._n_shards = int(n_shards)

    @property
    def sharded(self) -> bool:
        return self.config.sharded

    @property
    def n_shards(self) -> Optional[int]:
        return self._n_shards

    def shard_for(self, digest: str) -> Optional[int]:
        """The owning shard (lane) of one subject digest, or None when the
        store is unsharded or not bound to a lane count. A shard
        reassigned on a lane's loss (``reassign_shard``) maps its subjects
        onto the survivors by a second content hash, so the dead shard's
        load spreads deterministically."""
        n = self._n_shards
        if not self.config.sharded or not n:
            return None
        s = shard_of(digest, n)
        survivors = self._reassigned.get(s)
        if survivors is None:
            return s
        return survivors[int(digest[:8], 16) % len(survivors)]

    def reassign_shard(self, dead: int, survivors) -> bool:
        """Route a dead shard's subjects onto ``survivors``. Idempotent: a
        shard already reassigned is left alone (False). Survivors must be
        live shards: in range, not the dead one and not reassigned
        themselves (a chain would make ownership depend on the order the
        overlays landed in)."""
        n = self._n_shards
        if not self.config.sharded or not n:
            raise RuntimeError("reassign_shard on an unsharded store")
        if not 0 <= dead < n:
            raise ValueError(f"dead shard {dead} out of range [0, {n})")
        surv = tuple(sorted(set(int(s) for s in survivors)))
        if not surv:
            raise ValueError("reassign_shard needs >= 1 survivor")
        with self._lock:
            if dead in self._reassigned:
                return False
            for s in surv:
                if not 0 <= s < n or s == dead or s in self._reassigned:
                    raise ValueError(
                        f"survivor shard {s} is not live (range [0, {n}), "
                        f"dead={dead}, reassigned="
                        f"{sorted(self._reassigned)})")
            self._reassigned[dead] = surv
        return True

    def reassigned_shards(self) -> tuple:
        """The dead shards whose subjects the survivors serve now."""
        return tuple(self._reassigned)

    def restore_shard(self, dead: int) -> bool:
        """Undo ``reassign_shard`` once the lane is back; returns whether
        an overlay was removed."""
        with self._lock:
            return self._reassigned.pop(dead, None) is not None

    @property
    def _card(self) -> bool:
        return self._device.type == "cuda"

    # ------------------------------------------------------------ prefetch
    def prefetch(self, digest: str) -> bool:
        """Start an ASYNCHRONOUS host -> device promotion of a warm row;
        returns whether one was started. On a card the copy runs on the
        store's side stream from pinned memory, an event recorded behind
        it. A hot, cold-only or unknown digest is a cheap no-op (the
        install handles those tiers itself)."""
        with self._lock:
            if digest in self._promotions:
                return False
            row = self._warm.get(digest)
            if row is not None and self._card and self._side is None:
                self._side = torch.cuda.Stream(self._device)
        if row is None:
            return False
        # Device work outside the lock; returning with the copy in flight
        # IS the prefetch.
        event = None
        if self._card:
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._side):
                rows = {k: v.to(self._device, non_blocking=True)
                        for k, v in row.items()}
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            rows = {k: v.to(self._device) for k, v in row.items()}
        with self._lock:
            # A racing prefetch of the same digest copied the same bytes;
            # the last writer wins harmlessly.
            self._promotions[digest] = (rows, event)
        if self._counters is not None:
            self._counters.count_store_prefetch()
        return True

    # --------------------------------------------------------------- fetch
    def fetch_row(self, digest: str):
        """Resolve one digest from the warm or cold tier for an install;
        returns ``(rows, tier)`` with the rows on the bound device and
        ordered before any later work of the CURRENT stream (the
        install's), or None on a miss (the caller re-bakes and counts
        it). What this call waited for lands in the promotion-stall
        reservoir: for a prefetched row only the residual wait on its
        event."""
        t0 = time.perf_counter()
        with self._lock:
            prom = self._promotions.pop(digest, None)
            row = self._warm.get(digest)
            if row is not None:
                self._warm.move_to_end(digest)
        if prom is not None:
            rows, event = prom
            self._settle(rows, event)
            self._record(t0, "warm")
            return rows, "warm"
        if row is not None:
            # A warm hit without a prefetch: the stall is the whole
            # synchronous copy, measured as such.
            rows = self._promote(row)
            self._record(t0, "warm")
            return rows, "warm"
        row = self._load_cold(digest)
        if row is None:
            return None
        row = _host_row(row, self._card)
        victims = []
        with self._lock:
            # Cold rows promote THROUGH warm (inclusive tiers): the next
            # eviction of this subject demotes for free.
            self._warm[digest] = row
            self._warm.move_to_end(digest)
            while len(self._warm) > self.config.warm_capacity:
                victims.append(self._warm.popitem(last=False))
        self._page_out(victims)
        rows = self._promote(row)
        self._record(t0, "cold")
        return rows, "cold"

    def _settle(self, rows: dict, event) -> None:
        """Order a prefetched promotion before the current stream's later
        work and wait for it: the stream waits on the side stream's
        event, the rows are marked as used by the current stream (their
        memory is not reused before it is done with them), and the host
        waits for the event (the residual stall)."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(event)
        for t in rows.values():
            t.record_stream(cur)
        event.synchronize()

    def _promote(self, row: dict) -> dict:
        """A host row on the device, copied on the current stream and
        waited for."""
        if not self._card:
            return {k: v.to(self._device) for k, v in row.items()}
        rows = {k: v.to(self._device, non_blocking=True)
                for k, v in row.items()}
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._device))
        done.synchronize()
        return rows

    def _record(self, t0: float, tier: str) -> None:
        c = self._counters
        if c is None:
            return
        if tier == "warm":
            # The promotion quantile measures the WARM host -> device stall
            # only, the one the prefetch exists to hide; cold paging is
            # disk-bound and counted by its own hits.
            c.record_promotion_stall(time.perf_counter() - t0)
            c.count_store_warm()
        else:
            c.count_store_cold()
        c.count_store_promotion()

    # -------------------------------------------------------------- demote
    def demote(self, digest: str, row) -> None:
        """Insert one evicted subject's row into the warm tier. ``row``
        maps ``ROW_KEYS`` to device tensors (or host arrays); the
        device-to-host copy happens HERE, synchronously on the current
        stream, outside every lock — callers hold no engine lock. Warm
        overflow pages the LRU row to the cold tier."""
        host = _host_row(row, self._card)
        victims = []
        with self._lock:
            self._warm[digest] = host
            self._warm.move_to_end(digest)
            while len(self._warm) > self.config.warm_capacity:
                victims.append(self._warm.popitem(last=False))
            self._promotions.pop(digest, None)
        if self._counters is not None:
            self._counters.count_store_demotion_warm()
        self._page_out(victims)

    # -------------------------------------------------------------- resize
    def resize_warm(self, new_capacity: int) -> dict:
        """Retarget the warm tier's row budget at run time: one lock hold
        flips the capacity and takes out the oldest rows a shrink
        strands; paging runs after the release. Evictions are counted
        (``subject_store_resize_evictions``), never an error."""
        new_capacity = int(new_capacity)
        if new_capacity < 1:
            raise ValueError(
                f"warm_capacity must be >= 1, got {new_capacity}")
        victims = []
        with self._lock:
            old = self.config.warm_capacity
            self.config.warm_capacity = new_capacity
            while len(self._warm) > new_capacity:
                victims.append(self._warm.popitem(last=False))
        if victims and self._counters is not None:
            self._counters.count_store_resize_eviction(len(victims))
        self._page_out(victims)
        return {"warm_capacity": new_capacity, "previous": old,
                "evicted": len(victims)}

    # ------------------------------------------------------------ cold tier
    def _page_out(self, victims) -> None:
        for digest, row in victims:
            if self.config.cold_dir is None:
                continue    # no cold tier: the next access re-bakes
            with self._lock:
                present = digest in self._cold_index
            if present:
                # Content-addressed: a verified page of this digest IS
                # this row; rewriting identical bytes buys nothing.
                continue
            from mano_hand_tpu_torch.io import state_ckpt

            state_ckpt.save_row_page(digest, row, self.config.cold_dir)
            with self._lock:
                self._cold_index.add(digest)
            if self._counters is not None:
                self._counters.count_store_demotion_cold()

    def _load_cold(self, digest: str):
        """Load and verify one cold page as host arrays; None on a miss
        OR damage (damage is counted and degrades to a re-bake)."""
        if self.config.cold_dir is None:
            return None
        with self._lock:
            known = digest in self._cold_index
        if not known:
            return None
        from mano_hand_tpu_torch.io import state_ckpt

        try:
            meta, arrays = state_ckpt.load_row_page(
                digest, self.config.cold_dir)
            row = {k: np.asarray(arrays[k]) for k in ROW_KEYS}
            # Self-verification: "shape" is the digest preimage, and each
            # array must match the hash recorded at save time.
            if subject_digest(row["shape"]) != digest:
                raise ValueError("betas digest mismatch")
            want = meta.get("row_sha256") or {}
            for k in ROW_KEYS:
                got = hashlib.sha256(
                    np.ascontiguousarray(row[k]).tobytes()).hexdigest()
                if want.get(k) != got:
                    raise ValueError(f"row hash mismatch on {k!r}")
        except Exception:  # noqa: BLE001 — degrade, never error
            # Out of the index: one bad file costs one re-bake.
            with self._lock:
                self._cold_index.discard(digest)
            if self._counters is not None:
                self._counters.count_store_cold_damage()
            return None
        return row

    def cold_page_path(self, digest: str) -> Optional[Path]:
        """Where one digest's cold page lives (for drills and tests that
        damage one); None without a cold tier."""
        if self.config.cold_dir is None:
            return None
        from mano_hand_tpu_torch.io import state_ckpt

        return state_ckpt.row_page_path(digest, self.config.cold_dir)

    def cold_digests(self) -> list:
        with self._lock:
            return sorted(self._cold_index)

    def warm_digests(self) -> list:
        with self._lock:
            return list(self._warm)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """Tier occupancy, every field read under one hold of the store
        lock."""
        with self._lock:
            return {
                "warm_rows": len(self._warm),
                "warm_capacity": self.config.warm_capacity,
                "promotions_pending": len(self._promotions),
                "cold_pages": len(self._cold_index),
                "cold_dir": (None if self.config.cold_dir is None
                             else str(self.config.cold_dir)),
                "sharded": self.config.sharded,
                "shards": self._n_shards,
                "reassigned_shards": {
                    str(d): list(s)
                    for d, s in sorted(self._reassigned.items())},
            }
