"""Wavefront OBJ export and import, format-compatible with the reference:
``v %f %f %f`` lines then 1-indexed ``f %d %d %d`` lines, and the twin
``<stem>_restpose.obj`` file.

A port copy of the JAX package's ``io/obj.py``: for the same float64
arrays the bytes are identical. Arrays may also be tensors on any device
(copied to the host). An optional native writer (``io/native.py``, the
repo's ``native/objio.cpp``) formats large sequence dumps in C++ with the
same bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from mano_hand_tpu_torch.utils.arrays import as_numpy

PathLike = Union[str, Path]


def format_obj(
    verts: np.ndarray,
    faces: np.ndarray,
    normals: np.ndarray | None = None,
) -> str:
    """Build the OBJ text for one mesh. Matches the reference's '%f'/'%d'
    formatting (6-decimal fixed point, 1-indexed faces).

    With ``normals`` ([V, 3], e.g. from ops.vertex_normals), emits ``vn``
    lines and ``f a//a`` face refs — per-vertex normals share the vertex
    index. The reference never writes normals (its viewer recomputes
    them); plain calls stay byte-identical to it.
    """
    verts = as_numpy(verts, np.float64).reshape(-1, 3)
    faces = as_numpy(faces).reshape(-1, 3) + 1
    v_lines = "\n".join("v %f %f %f" % (x, y, z) for x, y, z in verts)
    if normals is None:
        f_lines = "\n".join("f %d %d %d" % (a, b, c) for a, b, c in faces)
        return v_lines + "\n" + f_lines + "\n"
    normals = as_numpy(normals, np.float64).reshape(-1, 3)
    if normals.shape != verts.shape:
        raise ValueError(
            f"normals shape {normals.shape} != verts {verts.shape}"
        )
    n_lines = "\n".join("vn %f %f %f" % (x, y, z) for x, y, z in normals)
    f_lines = "\n".join(
        "f %d//%d %d//%d %d//%d" % (a, a, b, b, c, c)
        for a, b, c in faces
    )
    return v_lines + "\n" + n_lines + "\n" + f_lines + "\n"


def export_obj(
    verts: np.ndarray, faces: np.ndarray, path: PathLike,
    use_native: bool | None = None,
    normals: np.ndarray | None = None,
) -> None:
    """Write a single mesh as OBJ.

    Uses the C++ serializer (io/native.py) when it is already built —
    output is byte-identical, so the switch is transparent. A single-mesh
    write never triggers a compile (a ``g++`` run would dwarf the
    millisecond write); ``use_native=True`` forces (and builds) the native
    path, ``False`` forces Python. ``normals`` adds ``vn``/``f a//a``
    records (Python path only — the native writer speaks the reference's
    normal-free dialect).
    """
    if normals is not None:
        if use_native:
            raise ValueError("native objio does not write normals")
        with open(path, "w") as fp:
            fp.write(format_obj(verts, faces, normals))
        return
    if use_native is not False:
        from mano_hand_tpu_torch.io import native

        if native.available(build_if_needed=bool(use_native)):
            native.write_obj(verts, faces, path)
            return
        if use_native:
            raise RuntimeError("native objio requested but unavailable")
    with open(path, "w") as fp:
        fp.write(format_obj(verts, faces))


def restpose_path(path: PathLike) -> Path:
    """Derive the '<stem>_restpose.obj' twin path. Like the reference
    (mano_np.py:196), the path must contain '.obj'; unlike it, we raise a
    clear error instead of str.index's ValueError."""
    s = str(path)
    if ".obj" not in s:
        raise ValueError(f"OBJ path must contain '.obj', got {s!r}")
    return Path(s[: s.index(".obj")] + "_restpose.obj")


def export_obj_pair(
    verts: np.ndarray,
    rest_verts: np.ndarray,
    faces: np.ndarray,
    path: PathLike,
) -> tuple[Path, Path]:
    """Write the posed mesh at ``path`` and the rest-pose mesh at the
    ``_restpose`` twin, exactly as the reference's export_obj does
    (mano_np.py:190-201). Returns both paths."""
    path = Path(path)
    rp = restpose_path(path)
    export_obj(verts, faces, path)
    export_obj(rest_verts, faces, rp)
    return path, rp


def export_obj_sequence(
    verts_seq: np.ndarray,  # [T, V, 3]
    faces: np.ndarray,
    directory: PathLike,
    stem: str = "frame",
    use_native: bool | None = None,
) -> list[Path]:
    """Dump an animation as frame_%05d.obj files (the batch analogue of the
    reference's per-frame viewer loop, ``data_explore.py:12-15``).

    The native sequence writer formats all frames in C++ (one call, no
    per-frame Python overhead); a sequence dump is the case where the
    one-off build pays for itself, so this path builds on demand.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    verts_seq = as_numpy(verts_seq)
    paths = [
        directory / f"{stem}_{t:05d}.obj" for t in range(verts_seq.shape[0])
    ]
    if use_native is not False:
        from mano_hand_tpu_torch.io import native

        if native.available():
            native.write_obj_sequence(verts_seq, faces, directory, stem)
            return paths
        if use_native:
            raise RuntimeError("native objio requested but unavailable")
    for p, verts in zip(paths, verts_seq):
        export_obj(verts, faces, p, use_native=False)
    return paths


def read_obj(path: PathLike):
    """Parse a Wavefront OBJ into a ``ply.PlyMesh`` (verts, faces, normals).

    The read half of the reference's only export format
    (``mano_np.py:181-201``) — so meshes written by this package, the
    reference, or any DCC tool round-trip (as fit targets, for one).
    Handles the real-world dialect: ``v`` with
    optional per-vertex color columns (ignored), ``f`` with ``v``,
    ``v/vt``, ``v//vn`` or ``v/vt/vn`` references (vertex index taken,
    negative = relative from the end), polygons fan-triangulated,
    ``vn`` lines returned only when they map 1:1 onto vertices (the
    layout this package writes; OBJ's general per-corner normal
    indexing has no per-vertex equivalent).
    """
    from mano_hand_tpu_torch.io.ply import PlyMesh

    verts: list[list[float]] = []
    normals: list[list[float]] = []
    faces: list[list[int]] = []
    vn_identity = True
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for ln, raw in enumerate(fh, 1):
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag in ("v", "vn"):
                if len(parts) < 4:
                    raise ValueError(
                        f"{path}:{ln}: '{tag}' line needs 3 components: "
                        f"{raw.rstrip()!r}"
                    )
                try:
                    xyz = [float(x) for x in parts[1:4]]
                except ValueError:
                    raise ValueError(
                        f"{path}:{ln}: bad '{tag}' component: "
                        f"{raw.rstrip()!r}"
                    ) from None
                (verts if tag == "v" else normals).append(xyz)
            elif tag == "f":
                if len(parts) < 4:
                    raise ValueError(
                        f"{path}:{ln}: face line needs >= 3 vertices: "
                        f"{raw.rstrip()!r}"
                    )
                idx = []
                for ref in parts[1:]:
                    fields = ref.split("/")
                    try:
                        i = int(fields[0])
                    except ValueError:
                        raise ValueError(
                            f"{path}:{ln}: bad face reference {ref!r}"
                        ) from None
                    # OBJ is 1-indexed; negative counts from the end of
                    # the vertices seen SO FAR (the spec's streaming rule).
                    vi = i - 1 if i > 0 else len(verts) + i
                    idx.append(vi)
                    # Track whether vn references are the IDENTITY map
                    # onto vertices; general per-corner vn indexing has
                    # no per-vertex equivalent, so anything else means
                    # "no normals" rather than silently mis-associated
                    # ones (a DCC's vn order need not match v order).
                    if len(fields) == 3 and fields[2]:
                        try:
                            ni = int(fields[2])
                        except ValueError:
                            raise ValueError(
                                f"{path}:{ln}: bad face reference {ref!r}"
                            ) from None
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                        if ni != vi:
                            vn_identity = False
                # Fan-triangulate polygons (quads are common DCC output).
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"{path}: no vertex lines — not an OBJ mesh?")
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int32) if faces else None
    if f is not None and (f.min() < 0 or f.max() >= len(verts)):
        raise ValueError(
            f"{path}: face index out of range (0..{len(verts) - 1} after "
            "1-indexed conversion)"
        )
    n = (
        np.asarray(normals, np.float64)
        if len(normals) == len(verts) and vn_identity else None
    )
    return PlyMesh(verts=v, faces=f, normals=n)
