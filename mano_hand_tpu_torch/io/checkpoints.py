"""Checkpointing for fitted parameters and pose banks.

A port copy of the JAX package's ``io/checkpoints.py``. Format: flat
``.npz`` — host-portable, no pickle execution on load. Values may be
tensors on any device as well as arrays; they load back as NumPy arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from mano_hand_tpu_torch.utils.arrays import as_numpy

PathLike = Union[str, Path]


def _npz_path(path: PathLike) -> Path:
    # np.savez appends ".npz" to suffix-less paths; normalize up front so the
    # returned path is always the file that exists on disk.
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz"
    )


def result_fields(result) -> dict:
    """Fitting-result NamedTuple (FitResult, LMResult, ...) -> dict of its
    non-None fields."""
    if hasattr(result, "_asdict"):
        fields = result._asdict()
    else:
        fields = {k: getattr(result, k)
                  for k in ("pose", "shape", "final_loss", "loss_history",
                            "pca")
                  if hasattr(result, k)}
    return {k: v for k, v in fields.items() if v is not None}


def save_fit_result(result, path: PathLike) -> Path:
    """Persist a fitting result NamedTuple (FitResult, LMResult, ...).

    Every non-None field is saved generically, so solver-specific extras
    (e.g. LMResult.damping_history) survive the round-trip instead of
    being silently dropped.
    """
    path = _npz_path(path)
    arrays = {k: as_numpy(v) for k, v in result_fields(result).items()}
    np.savez(path, **arrays)
    return path


def load_fit_result(path: PathLike) -> dict:
    """Load a saved fit as a dict of numpy arrays."""
    return load_arrays(path)


def save_arrays(path: PathLike, **arrays) -> Path:
    """Generic named-array checkpoint (pose banks, targets, ...)."""
    path = _npz_path(path)
    np.savez(path, **{k: as_numpy(v) for k, v in arrays.items()})
    return path


def load_arrays(path: PathLike) -> dict:
    # Mirror the save-side .npz normalization so save_*(x, "ckpt") /
    # load_*("ckpt") round-trips; a literal existing path still wins.
    path = Path(path)
    if not path.exists():
        path = _npz_path(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
