"""Warm-state persistence: a (meta, arrays) pair on disk, and row pages.

The port's counterpart of the JAX package's ``io/orbax_ckpt.py``
(``save_state``, ``load_state`` and the row pages) without orbax. It
writes the layout of JAX's PICKLE backend byte for byte: a directory
holding ``state.pkl`` (the non-empty arrays, a pickled dict of numpy
arrays) and ``state_meta.json`` (the meta, ``"backend": "pickle"``, and
the empty arrays' shapes and dtypes, which ride in the meta sidecar). A
checkpoint written by either package loads in the other. One written by
JAX's orbax backend raises here, naming orbax. The meta lands LAST
(temp + rename), so a checkpoint killed mid-write has no meta and loads
as absent, never half-blank.

``orbax_ckpt.save``, ``load`` and ``wait`` (orbax PyTree I/O of fit
results) are not ported: ``io/checkpoints.py`` covers fit results.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from pathlib import Path
from typing import Union

import numpy as np
import torch

PathLike = Union[str, Path]

_STATE_META = "state_meta.json"
_STATE_PICKLE = "state.pkl"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(meta: dict, arrays: dict, path: PathLike) -> Path:
    """Persist ``(meta, arrays)`` into directory ``path`` (arrays: numpy
    arrays or tensors, stored as numpy). Returns the absolute path."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    arrays = {k: _host(v) for k, v in arrays.items()}
    empty = {k: [list(v.shape), str(v.dtype)]
             for k, v in arrays.items() if v.size == 0}
    arrays = {k: v for k, v in arrays.items() if v.size > 0}
    meta = {**meta, "_empty_arrays": empty}
    tmp = path / f"{_STATE_PICKLE}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(arrays, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path / _STATE_PICKLE)
    tmp = path / f"{_STATE_META}.tmp{os.getpid()}"
    tmp.write_text(json.dumps({**meta, "backend": "pickle"},
                              indent=1, sort_keys=True))
    os.replace(tmp, path / _STATE_META)
    return path


def load_state(path: PathLike):
    """Restore a ``save_state`` checkpoint: ``(meta, arrays)`` with numpy
    arrays. Raises FileNotFoundError when ``path`` holds no complete
    checkpoint (no meta file — the killed-mid-write case), ValueError for
    a checkpoint of JAX's orbax backend."""
    path = Path(path).absolute()
    meta_path = path / _STATE_META
    if not meta_path.exists():
        raise FileNotFoundError(
            f"no complete checkpoint at {path} (missing {_STATE_META})")
    meta = json.loads(meta_path.read_text())
    backend = meta.get("backend", "pickle")
    if backend != "pickle":
        raise ValueError(
            f"checkpoint at {path} was written by the {backend!r} backend "
            "(orbax, the JAX package's); this package reads the pickle "
            "layout only — write it with the JAX package's backend="
            "'pickle'")
    with open(path / _STATE_PICKLE, "rb") as f:
        arrays = pickle.load(f)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    for k, (shape, dtype) in (meta.pop("_empty_arrays", None) or {}).items():
        arrays[k] = np.zeros(shape, dtype)
    return meta, arrays


# --------------------------------------------------------------------------
# Row pages: one directory per subject digest holding that subject's baked
# table row as a (meta, arrays) state pair, with a sha256 per array in the
# meta so a reader can verify the content before serving it.

_ROW_PAGE_PREFIX = "row-"


def row_page_path(digest: str, root: PathLike) -> Path:
    return Path(root).absolute() / f"{_ROW_PAGE_PREFIX}{digest}"


def save_row_page(digest: str, arrays: dict, root: PathLike) -> Path:
    """Write one subject's baked row as a verifiable page."""
    arrays = {k: _host(v) for k, v in arrays.items()}
    meta = {
        "kind": "subject_row_page",
        "digest": digest,
        "row_sha256": {
            k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()},
    }
    return save_state(meta, arrays, row_page_path(digest, root))


def load_row_page(digest: str, root: PathLike):
    """Restore one page as ``(meta, arrays)``. Raises on a missing or
    unreadable page; verifying the content against ``meta["row_sha256"]``
    is the caller's job."""
    return load_state(row_page_path(digest, root))


def list_row_pages(root: PathLike) -> list:
    """Digests with a COMPLETE page under ``root`` (meta file present)."""
    root = Path(root).absolute()
    if not root.is_dir():
        return []
    return sorted(
        p.name[len(_ROW_PAGE_PREFIX):] for p in root.iterdir()
        if p.is_dir() and p.name.startswith(_ROW_PAGE_PREFIX)
        and (p / _STATE_META).exists())
