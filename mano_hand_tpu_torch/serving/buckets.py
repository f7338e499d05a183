"""Shape-bucket policy for the serving path.

Every request batch is rounded up to a power-of-two bucket, the tail rows
are padded, and the pad rows are masked back out of the results, so the
engine only ever dispatches ``log2(max_bucket)`` distinct batch shapes.
Padding is row-independent by construction: every row of the forward is
computed from its own inputs. Pure numpy/python bookkeeping.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def bucket_sizes(min_bucket: int = 1, max_bucket: int = 1024) -> Tuple[int, ...]:
    """The powers of two in [min_bucket, max_bucket], endpoints rounded up.

    >>> bucket_sizes(8, 64)
    (8, 16, 32, 64)
    """
    if min_bucket < 1 or max_bucket < min_bucket:
        raise ValueError(
            f"need 1 <= min_bucket <= max_bucket, got "
            f"({min_bucket}, {max_bucket})")
    lo = 1 << (int(min_bucket) - 1).bit_length()
    hi = 1 << (int(max_bucket) - 1).bit_length()
    return tuple(1 << e for e in range(lo.bit_length() - 1,
                                       hi.bit_length()))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n. ``buckets`` must be sorted ascending.

    Raises when n exceeds the largest bucket: a silently truncated
    request would drop rows (the engine rejects at submit).
    """
    if n < 1:
        raise ValueError(f"request rows must be >= 1, got {n}")
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(
        f"request of {n} rows exceeds the largest bucket "
        f"{buckets[-1]}; raise max_bucket or chunk the request")


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad ``arr``'s leading dim up to ``bucket`` by repeating row 0.

    Row 0 (real data) rather than zeros: pad rows then run the numeric
    regime of live traffic — no denormals, no degenerate geometry.
    """
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f"cannot pad {n} rows down to bucket {bucket}")
    pad = np.broadcast_to(arr[:1], (bucket - n, *arr.shape[1:]))
    return np.concatenate([arr, pad])


def subject_index_rows(slots: Sequence[int], rows: Sequence[int],
                       bucket: int) -> np.ndarray:
    """The per-row int32 subject index of a coalesced mixed-subject batch.

    Request ``k`` contributes ``rows[k]`` rows of table slot ``slots[k]``;
    the result is padded to ``bucket`` by repeating row 0 (the
    ``pad_rows`` contract: pad rows replay the first request's subject).
    """
    slots = np.asarray(slots, np.int32)
    rows = np.asarray(rows, np.int64)
    if slots.shape != rows.shape:
        raise ValueError(
            f"slots and rows must pair up, got {slots.shape} vs "
            f"{rows.shape}")
    if rows.size and rows.min() < 1:
        raise ValueError("every request must contribute >= 1 row")
    idx = np.repeat(slots, rows)
    if idx.size < 1:
        raise ValueError("a batch needs at least one row")
    return pad_rows(idx, bucket)


def pad_tree_rows(tree: dict, bucket: int) -> dict:
    """``pad_rows`` over every leaf of a flat {name: array} dict (warm-start
    seeds for the bucketed fit wrappers)."""
    return {k: pad_rows(np.asarray(v), bucket) for k, v in tree.items()}
