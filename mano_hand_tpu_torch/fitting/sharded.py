"""Fits of a target sharded over ranks: the counterpart of the JAX
package's ``fit`` / ``fit_sequence`` on a target placed with
``NamedSharding(mesh, P('data'))``, which GSPMD partitions.

Here the target is a ``DTensor`` over a ``parallel.make_mesh`` mesh,
split on its leading axis over the mesh's ``data`` dim (``Shard(0)``, by
DTensor's chunk rule) and replicated over the other dims, given to the
same functions with no new argument:

* ``fit`` (independent problems, one per row): each rank fits its own
  rows as plain tensors, which is the unsharded fit of those rows, since
  every problem's loss and solver state are its own.
* ``fit_sequence`` (one clip whose frames are coupled by the smoothness
  priors and share one shape): each rank gathers the clip (one
  all-reduce of its frames placed in zeros, exact) and runs the
  unsharded fit of the whole clip, then keeps its own frames. A clip is
  small (T x 778 x 3), so the copy costs less than the exchanges a
  split optimisation would need every step.

Every rank first sums the row counts of the split over the ``data`` dim,
so a split other than the chunk rule (``DTensor.from_local`` accepts any
with ``shape=``) raises the same ``ValueError`` on every rank.

Results come back as DTensors of the global shape: per-row (per-frame)
leaves with the target's placements, the clip's shape and losses
replicated.
"""

from __future__ import annotations

import functools
import inspect
import sys
from typing import Optional

import numpy as np
import torch


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (checked without
    importing the distributed package: nothing can hold a DTensor before
    it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


class _Split:
    """This rank's rows of a tensor split over the mesh's ``data`` dim."""

    def __init__(self, target):
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard

        from mano_hand_tpu_torch.parallel.mesh import DATA_AXIS

        mesh, placements = target.device_mesh, tuple(target.placements)
        names = mesh.mesh_dim_names or ()
        if DATA_AXIS not in names:
            raise ValueError(f"a sharded target needs a mesh with a "
                             f"{DATA_AXIS!r} dim, got dims {names}")
        dim = names.index(DATA_AXIS)
        ok = all(p == (Shard(0) if i == dim else Replicate())
                 for i, p in enumerate(placements))
        if not ok:
            raise ValueError(
                "a sharded target must be split on its leading axis over "
                f"the mesh's {DATA_AXIS!r} dim (Shard(0)) and replicated "
                f"over the others; got placements {placements}")
        self.mesh, self.placements = mesh, placements
        self.group = mesh.get_group(DATA_AXIS)
        self.n, self.index = mesh.size(dim), mesh.get_local_rank(DATA_AXIS)
        self.total = target.shape[0]
        self.local = target.to_local()
        # Every rank's rows, summed so that all of them see the same split
        # and raise together where it is not DTensor's chunk rule.
        counts = self.local.new_zeros(self.n)
        counts[self.index] = self.local.shape[0]
        dist.all_reduce(counts, group=self.group)
        step = -(-self.total // self.n)
        want = [max(0, min(step, self.total - i * step))
                for i in range(self.n)]
        got = [int(c) for c in counts.tolist()]
        if got != want:
            raise ValueError(
                f"a sharded target of {self.total} rows must be split over "
                f"the {self.n} {DATA_AXIS!r} shards by DTensor's chunk rule "
                f"(rows {want}), got rows {got}")
        self.offset = min(self.index * step, self.total)
        self.count = want[self.index]

    def rows(self, x):
        """This rank's rows of a per-row argument: a DTensor's local
        piece (split as the target), or the rank's slice of a global
        tensor or array."""
        if x is None:
            return None
        if is_dtensor(x):
            return self.like(x).local
        return x[self.offset:self.offset + self.count]

    def per_row(self, x, row_ndim: int):
        """``x`` cut to this rank's rows when it carries the row axis (its
        rank above ``row_ndim``, the rank of one row's value), else whole
        (an argument shared by every row)."""
        if x is None:
            return None
        ndim = x.dim() if torch.is_tensor(x) else np.ndim(x)
        return self.rows(x) if ndim > row_ndim else x

    def like(self, x) -> "_Split":
        """The split of a per-row DTensor argument, which must be the
        target's."""
        other = _Split(x)
        if other.total != self.total:
            raise ValueError(f"a sharded argument of {other.total} rows "
                             f"beside a target of {self.total}")
        return other

    def whole(self) -> torch.Tensor:
        """Every rank's rows on every rank: one all-reduce of this rank's
        rows placed in zeros (exact)."""
        import torch.distributed as dist

        buf = self.local.new_zeros((self.total, *self.local.shape[1:]))
        buf[self.offset:self.offset + self.count] = self.local
        dist.all_reduce(buf, group=self.group)
        return buf

    def wrap(self, local: Optional[torch.Tensor], sharded: bool = True):
        """A DTensor of the global shape from this rank's ``local``
        rows (``sharded``) or from the same value on every rank."""
        from torch.distributed.tensor import DTensor, Replicate

        if local is None:
            return None
        if sharded:
            placements = self.placements
            shape = torch.Size((self.total, *local.shape[1:]))
        else:
            placements = tuple(Replicate() for _ in self.placements)
            shape = local.shape
        stride = tuple(torch.empty(shape, device="meta").stride())
        return DTensor.from_local(local.contiguous(), self.mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)


def _bound(fn):
    sig = inspect.signature(fn)
    return sig, list(sig.parameters)[1]


#: The per-row arguments of the batched solvers: (name, rank of one row).
_ROW_ARGS = (("target_conf", 1), ("frozen_shape", 1), ("target_mask", 2))


def over_data_rows(fn):
    """``fit``'s sharded entry: a DTensor target fits each rank's rows
    (the per-row ``target_conf``, ``init``, ``frozen_shape`` and
    ``target_mask`` cut to them) and returns DTensor leaves."""
    sig, target_name = _bound(fn)
    row_args = [(n, d) for n, d in _ROW_ARGS if n in sig.parameters]

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        bound = sig.bind_partial(*args, **kw)
        target = bound.arguments.get(target_name)
        if not is_dtensor(target):
            return fn(*args, **kw)
        if target.dim() < 3:
            raise ValueError(
                "a sharded target must be a batch of problems (its leading "
                f"axis the problems), got shape {tuple(target.shape)}")
        split = _Split(target)
        a = bound.arguments
        a[target_name] = split.local
        for name, row_ndim in row_args:
            if a.get(name) is not None:
                a[name] = split.per_row(a[name], row_ndim)
        if a.get("init"):
            a["init"] = {k: split.rows(v) for k, v in a["init"].items()}
        res = fn(**a)
        return type(res)(*(split.wrap(x) for x in res))

    return wrapper


def over_data_frames(fn):
    """``fit_sequence``'s sharded entry: a DTensor clip (and a DTensor
    per-frame ``target_conf``/``target_mask``) is gathered whole on every
    rank, ``fn`` fits the whole clip, and the result comes back as
    DTensor leaves (per-frame sharded, the clip's shape and losses
    replicated)."""
    sig, target_name = _bound(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        bound = sig.bind_partial(*args, **kw)
        target = bound.arguments.get(target_name)
        if not is_dtensor(target):
            return fn(*args, **kw)
        split = _Split(target)
        a = bound.arguments
        a[target_name] = split.whole()
        for name in ("target_conf", "target_mask"):
            if is_dtensor(a.get(name)):
                a[name] = split.like(a[name]).whole()
        res = fn(**a)
        rows = slice(split.offset, split.offset + split.count)
        return type(res)(
            pose=split.wrap(res.pose[rows]),
            shape=split.wrap(res.shape, sharded=False),
            final_loss=split.wrap(res.final_loss, sharded=False),
            loss_history=split.wrap(res.loss_history, sharded=False),
            trans=None if res.trans is None else split.wrap(res.trans[rows]),
        )

    return wrapper
