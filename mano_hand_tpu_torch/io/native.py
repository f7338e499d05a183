"""ctypes binding to the repo's native OBJ serializer (``native/objio.cpp``).

The port's counterpart of the JAX package's ``io/native.py``, with the
same contract: every entry point degrades to the pure-Python writer when
no compiler is available, so the native layer is an accelerator, never a
requirement. This is host-side file I/O, not a device path.

The library is compiled from the checkout's source with ``g++`` (the
flags of ``native/Makefile``) into ``mano_hand_tpu_torch/_build/``, named
by a hash of the source and the flags, and loaded with ctypes. The build
writes a temporary file and renames it into place, so processes that
build at once never load a half-written library. ``native/`` itself is
only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from mano_hand_tpu_torch.utils.arrays import as_numpy

_SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "objio.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Optional[Path]:
    """Where the library for the checkout's source lives (None when the
    source is missing)."""
    if not _SOURCE.exists():
        return None
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libmanoio_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the native library with ``g++``. Returns True on success."""
    out = lib_path()
    if out is None:
        return False
    if out.exists() and not force:
        return True
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *_FLAGS, "-o", tmp, str(_SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out.exists()
    except (OSError, subprocess.SubprocessError):
        return False


def load(build_if_needed: bool = True) -> Optional[ctypes.CDLL]:
    """Load (optionally building) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    out = lib_path()
    if out is None or (not build_if_needed and not out.exists()):
        return None
    # The failed-build latch only suppresses rebuild attempts; a library
    # that has appeared since (another process built it) is loaded.
    if _tried and not out.exists():
        return None
    _tried = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.mano_write_obj.restype = ctypes.c_int
    lib.mano_write_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.mano_write_obj_sequence.restype = ctypes.c_int
    lib.mano_write_obj_sequence.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available(build_if_needed: bool = True) -> bool:
    return load(build_if_needed) is not None


def _faces_c(faces) -> np.ndarray:
    return np.ascontiguousarray(as_numpy(faces), dtype=np.int32).reshape(-1, 3)


def write_obj(verts, faces, path) -> None:
    """Native single-mesh OBJ write; raises RuntimeError on failure."""
    lib = load()
    if lib is None:
        raise RuntimeError("native objio unavailable (no compiler?)")
    verts = np.ascontiguousarray(as_numpy(verts),
                                 dtype=np.float64).reshape(-1, 3)
    faces = _faces_c(faces)
    rc = lib.mano_write_obj(
        str(path).encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        verts.shape[0],
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        faces.shape[0],
    )
    if rc != 0:
        raise RuntimeError(f"mano_write_obj failed with code {rc} for {path}")


def write_obj_sequence(verts_seq, faces, directory, stem="frame") -> int:
    """Native animation dump; returns the number of frames written."""
    lib = load()
    if lib is None:
        raise RuntimeError("native objio unavailable (no compiler?)")
    verts_seq = np.ascontiguousarray(as_numpy(verts_seq), dtype=np.float64)
    t, v = verts_seq.shape[0], verts_seq.shape[1]
    faces = _faces_c(faces)
    Path(directory).mkdir(parents=True, exist_ok=True)
    rc = lib.mano_write_obj_sequence(
        str(directory).encode(), stem.encode(),
        verts_seq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), t, v,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), faces.shape[0],
    )
    if rc < 0:
        raise RuntimeError(f"mano_write_obj_sequence failed with code {rc}")
    return rc
