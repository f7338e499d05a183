"""Input pipeline: epoch batching and ahead-of-time device prefetch.

The port of the JAX package's ``utils/data.py``. The input pattern that
matters on a card is overlap: while the card runs step N, the host
should already be shipping batch N+1, so a step never waits on a
host-to-device copy. ``batches`` is the JAX package's, copied;
``prefetch_to_device`` keeps batches in flight as ``non_blocking``
copies from pinned host memory:

    from mano_hand_tpu_torch.utils.data import batches, prefetch_to_device

    it = prefetch_to_device(
        batches({"pose": poses, "target": verts}, batch_size=256,
                shuffle=True, seed=0),
        size=2,          # batches in flight
        mesh=mesh,       # optional: each rank gets its rows, as a DTensor
    )
    for batch in it:
        state, loss = step(state, batch["target"])
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch


def batches(
    arrays: Mapping[str, np.ndarray],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int = 1,
) -> Iterator[dict]:
    """Slice a dict of equal-leading-dim arrays into per-epoch batches.

    ``drop_remainder=True`` keeps every batch the same static shape (a
    ragged tail batch is a new shape for every shape-keyed cache: the
    serving engine's buckets, a captured CUDA graph); pad upstream if
    every sample matters. ``epochs`` repeats with a fresh shuffle order
    each epoch (seeded: identical runs see identical order).
    """
    # Validate HERE, not in the generator body: a generator defers its
    # body to first next(), which would surface call-site mistakes deep
    # inside the consumer (e.g. mid-prefetch) instead of at the call.
    if not arrays:
        raise ValueError("batches() needs at least one array")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    n = len(next(iter(arrays.values())))
    for name, a in arrays.items():
        if len(a) != n:
            raise ValueError(
                f"leading dims disagree: {name} has {len(a)}, expected {n}")
    if n < batch_size and drop_remainder:
        raise ValueError(
            f"batch_size {batch_size} exceeds dataset size {n} and "
            "drop_remainder would yield nothing")

    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else None
            stop = n - batch_size + 1 if drop_remainder else n
            for lo in range(0, stop, batch_size):
                if order is None:
                    # Plain slices are views — no per-batch host copy on
                    # the sequential path.
                    yield {k: a[lo:lo + batch_size]
                           for k, a in arrays.items()}
                else:
                    idx = order[lo:lo + batch_size]
                    yield {k: a[idx] for k, a in arrays.items()}

    return gen()


def _map(fn, tree):
    """``fn`` over the leaves of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _Shipper:
    """Copies host leaves to one device. On a card each leaf goes through
    a pinned staging buffer of its own, copied ``non_blocking`` on the
    current stream; the buffer is held until an event recorded after its
    copy has completed, so no staging memory is reused under a copy in
    flight. Elsewhere a leaf is copied plainly."""

    def __init__(self, device: torch.device, mesh):
        self.device, self.mesh = device, mesh
        self.in_flight: collections.deque = collections.deque()

    def leaf(self, x):
        host = x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))
        rows = host
        if self.mesh is not None:
            from mano_hand_tpu_torch.parallel.sharding import (
                _BATCH, _local_chunk,
            )

            rows = _local_chunk(host, self.mesh, _BATCH)
        if self.device.type == "cuda":
            staged = torch.empty(rows.shape, dtype=rows.dtype,
                                 pin_memory=True)
            staged.copy_(rows)
            out = staged.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self.in_flight.append((done, staged))
        else:
            out = rows.to(self.device, copy=True)
        if self.mesh is None:
            return out
        from mano_hand_tpu_torch.parallel.sharding import _BATCH, _dtensor

        return _dtensor(out, self.mesh, _BATCH, host.shape)

    def release(self) -> None:
        """Drop the staging buffers whose copies have landed."""
        while self.in_flight and self.in_flight[0][0].query():
            self.in_flight.popleft()


def prefetch_to_device(
    iterator: Iterable,
    size: int = 2,
    device=None,
    mesh=None,
) -> Iterator:
    """Keep ``size`` batches already ON the device ahead of the consumer.

    The copies are enqueued ``non_blocking`` from pinned host memory on
    the current stream, so shipping the next batches overlaps the
    current step and a step that reads a batch is ordered after its
    copy. ``device`` defaults to ``cuda`` (pass ``"cpu"`` for the CPU).
    With a ``mesh`` (``parallel.make_mesh``), each batch lands already
    sharded: this rank's rows (the 'data' split, the same on every rank
    of a 'model' group) on its device, as a DTensor of the global shape,
    which the sharded forward and fit programs take directly.

    Dicts, lists and tuples of arrays (or tensors) keep their structure,
    so dict batches from :func:`batches` pass through whole.
    """
    # Validate HERE, not in the generator body (the batches() pattern): a
    # generator defers its body to first next(), which would surface a
    # bad size deep inside the consumer instead of at the call.
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if mesh is not None:
        from mano_hand_tpu_torch.parallel.sharding import _mesh_device

        device = _mesh_device(mesh) if device is None else device
    from mano_hand_tpu_torch.ops.common import resolve_device

    ship = _Shipper(resolve_device(device), mesh)

    def gen():
        queue: collections.deque = collections.deque()
        it = iter(iterator)
        try:
            while True:
                while len(queue) < size:
                    queue.append(_map(ship.leaf, next(it)))
                ship.release()
                yield queue.popleft()
        except StopIteration:
            while queue:
                ship.release()
                yield queue.popleft()

    return gen()
