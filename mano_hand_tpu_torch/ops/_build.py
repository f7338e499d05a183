"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources are ``mano_hand_tpu_torch/csrc/*.cu`` and ``*.cuh``. Each
``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then the objects are linked into one shared
library with a plain C interface. The library lands in
``mano_hand_tpu_torch/_build/`` under a name carrying a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as is. A missing ``nvcc`` or a failed build raises: nothing falls
back to another implementation.

No ``--use_fast_math``: the kernels rely on accurate ``sinf``/``cosf``
and IEEE division (see ``ops/common.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def sources() -> list:
    """Every kernel source file, sorted (``*.cu`` and ``*.cuh``)."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of the sources and the compile flags: the library's identity."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(h: str) -> Path:
    return BUILD_DIR / f"libmano_kernels_{h}.so"


def log_path(h: str) -> Path:
    return BUILD_DIR / f"build_{h}.log"


def nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA "
        "toolkit to build")


def build() -> Path:
    """Compile the library unless this source hash is already built;
    returns its path. The compiler's output (including ``-Xptxas -v``
    register and spill counts) is kept beside it as ``build_<hash>.log``."""
    h = source_hash()
    so = library_path(h)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        units = [p for p in sources() if p.suffix == ".cu"]
        procs = []
        for src in units:
            obj = work / (src.stem + ".o")
            cmd = [cc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / so.name
        link = subprocess.run(
            [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        log_path(h).write_text("\n".join(log))
        os.replace(tmp_so, so)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def build_log() -> str:
    """The compiler output of the current build ('' before a build)."""
    p = log_path(source_hash())
    return p.read_text() if p.exists() else ""


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mano_fused_forward.argtypes = ([ptr] * 7 + [i32] * 7
                                       + [ptr, ctypes.POINTER(i32)])
    lib.mano_fused_forward.restype = i32
    lib.mano_fused_posed.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.mano_fused_posed.restype = i32
    lib.mano_skin.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.mano_skin.restype = i32
    lib.mano_blend_skin.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.mano_blend_skin.restype = i32
    lib.mano_cuda_error_string.argtypes = [i32]
    lib.mano_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.mano_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
