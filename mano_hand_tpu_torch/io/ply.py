"""PLY (Stanford polygon) I/O — binary and ASCII.

A port copy of the JAX package's ``io/ply.py``: for the same arrays the
bytes are identical (the header's comment line included). ``export_ply``
writes little-endian binary (or ASCII), float32 positions (+ optional
float32 normals), uchar-count int32 face indices — the layout every PLY
reader (MeshLab, Open3D, trimesh) expects. ``read_ply`` loads scanner
and tool output back: both byte orders, float/double coordinates, extra
vertex properties skipped by offset, faces optional. Arrays may also be
tensors on any device (copied to the host).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Union

import numpy as np

from mano_hand_tpu_torch.utils.arrays import as_numpy

PathLike = Union[str, Path]


def vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals, pure NumPy.

    Same math as ops.normals.vertex_normals (un-normalized face normals
    scatter-added to corners), for writer paths that must not touch a
    device — e.g. ``MANOModel(backend="np").export_ply``.
    """
    verts = as_numpy(verts, np.float64).reshape(-1, 3)
    faces = as_numpy(faces).reshape(-1, 3)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    acc = np.zeros_like(verts)
    np.add.at(acc, faces.reshape(-1), np.repeat(fn, 3, axis=0))
    return acc / np.maximum(
        np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12
    )


class PlyMesh(NamedTuple):
    """What ``read_ply`` returns. ``faces`` / ``normals`` are None when the
    file has no face element / no nx,ny,nz properties (point clouds)."""

    verts: np.ndarray                  # [V, 3] float
    faces: Optional[np.ndarray]        # [F, 3] int32 or None
    normals: Optional[np.ndarray]      # [V, 3] float or None


# PLY scalar type names (both the 1.0-spec names and the C-style aliases
# tools emit) → numpy dtype codes, endianness applied at parse time.
_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _parse_faces_loop(body, offset, count, props, idx_prop, bo, out):
    """General (mixed-size lists / extra scalars) face parse; returns the
    advanced offset. Dtypes hoisted — the loop body is pure offset math."""
    specs = []
    for p, spec in props:
        if isinstance(spec, tuple):
            _, cnt_t, item_t = spec
            specs.append((p, np.dtype(bo + cnt_t), np.dtype(bo + item_t)))
        else:
            specs.append((p, None, np.dtype(bo + spec)))
    for _ in range(count):
        for p, cnt_d, item_d in specs:
            if cnt_d is None:
                offset += item_d.itemsize
                continue
            n = int(np.frombuffer(body, cnt_d, count=1, offset=offset)[0])
            offset += cnt_d.itemsize
            items = np.frombuffer(body, item_d, count=n, offset=offset)
            offset += item_d.itemsize * n
            if p == idx_prop:
                out.append(items)
    return offset


def read_ply(path: PathLike) -> PlyMesh:
    """Load a PLY mesh or point cloud (binary either endianness, or ASCII).

    Tolerant of what scanners actually write: extra vertex properties
    (colors, quality, ...) are skipped; the face list count may be any
    integer type; non-triangle faces are rejected with a clear error
    (MANO-side consumers are triangle-only). Only list properties named
    ``vertex_indices``/``vertex_index`` are honored on faces.
    """
    blob = Path(path).read_bytes()
    marker = b"end_header"
    idx = blob.find(marker)
    if not blob.startswith(b"ply") or idx < 0:
        raise ValueError(f"{path}: not a PLY file")
    body = blob[blob.index(b"\n", idx) + 1:]
    header = blob[:idx].decode("ascii", "replace").splitlines()

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_code | list spec)])
    for line in header[1:]:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise ValueError(f"{path}: property before any element")
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], ("list", _PLY_TYPES[parts[2]],
                                _PLY_TYPES[parts[3]]))
                )
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: unsupported format {fmt!r}")
    bo = ">" if fmt == "binary_big_endian" else "<"

    verts = faces = normals = None
    offset = 0
    ascii_rows = (
        body.decode("ascii", "replace").split("\n") if fmt == "ascii"
        else None
    )
    row_cursor = 0
    for name, count, props in elements:
        is_vertex = name == "vertex"
        is_face = name == "face"
        if is_vertex:
            if any(isinstance(d, tuple) for _, d in props):
                raise ValueError(f"{path}: list property on vertex element")
            rec = np.dtype([(p, bo + d) for p, d in props])
            if fmt == "ascii":
                rows = ascii_rows[row_cursor:row_cursor + count]
                row_cursor += count
                data = np.loadtxt(
                    rows, dtype=np.float64, ndmin=2
                ) if count else np.zeros((0, len(props)))
                if data.shape[0] != count:
                    # loadtxt silently skips blank/'#' lines; rows were
                    # sliced BY count, so a skip desyncs every later
                    # element block — fail here with the real cause.
                    raise ValueError(
                        f"{path}: vertex element declares {count} rows but "
                        f"{data.shape[0]} parsed (blank or comment line "
                        "inside the vertex block?)"
                    )
                cols = {p: data[:, i] for i, (p, _) in enumerate(props)}
            else:
                data = np.frombuffer(
                    body, rec, count=count, offset=offset
                )
                offset += rec.itemsize * count
                cols = {p: data[p] for p, _ in props}
            for need in ("x", "y", "z"):
                if need not in cols:
                    raise ValueError(f"{path}: vertex missing '{need}'")
            verts = np.stack(
                [cols["x"], cols["y"], cols["z"]], axis=1
            ).astype(np.float64)
            if all(k in cols for k in ("nx", "ny", "nz")):
                normals = np.stack(
                    [cols["nx"], cols["ny"], cols["nz"]], axis=1
                ).astype(np.float64)
        elif is_face:
            out = []
            lists = [
                (p, spec) for p, spec in props if isinstance(spec, tuple)
            ]
            idx_prop = next(
                (p for p, _ in lists
                 if p in ("vertex_indices", "vertex_index")), None
            )
            if fmt == "ascii":
                rows = ascii_rows[row_cursor:row_cursor + count]
                row_cursor += count
                for i, r in enumerate(rows):
                    vals = r.split()
                    if not vals or vals[0].startswith("#"):
                        # Same scanner artifact as the vertex-block check:
                        # a blank/comment row would otherwise die below as
                        # an int() parse error with no file/element
                        # context.
                        raise ValueError(
                            f"{path}: blank or comment line inside the "
                            f"face element (row {i} of {count})"
                        )
                    # Per-row: scalars and lists in property order; pick
                    # the vertex-index list, skip everything else.
                    pos = 0
                    for p, spec in props:
                        if isinstance(spec, tuple):
                            n = int(vals[pos])
                            items = vals[pos + 1:pos + 1 + n]
                            pos += 1 + n
                            if p == idx_prop:
                                out.append([int(v) for v in items])
                        else:
                            pos += 1
            elif (count and len(props) == 1 and idx_prop is not None):
                # Fast path — the layout every mesh tool (and export_ply)
                # writes: one list property, uniform triangle counts. One
                # vectorized frombuffer instead of ~4 tiny calls per face
                # (a 10^5-face scan loads in ms, not seconds). Falls back
                # to the general loop below on mixed-size lists.
                _, cnt_t, item_t = props[0][1]
                n0 = int(np.frombuffer(
                    body, np.dtype(bo + cnt_t), count=1, offset=offset
                )[0])
                rec = np.dtype([
                    ("n", bo + cnt_t), ("idx", bo + item_t, (n0,))
                ])
                try:
                    data = np.frombuffer(
                        body, rec, count=count, offset=offset
                    )
                except ValueError:   # mixed counts shrank the tail
                    data = None
                if data is not None and (data["n"] == n0).all():
                    offset += rec.itemsize * count
                    if n0 != 3:
                        raise ValueError(
                            f"{path}: non-triangle faces "
                            "(triangulate first)"
                        )
                    out = list(data["idx"])
                else:
                    offset = _parse_faces_loop(
                        body, offset, count, props, idx_prop, bo, out
                    )
            else:
                offset = _parse_faces_loop(
                    body, offset, count, props, idx_prop, bo, out
                )
            if idx_prop is not None:
                if any(len(f) != 3 for f in out):
                    raise ValueError(
                        f"{path}: non-triangle faces (triangulate first)"
                    )
                faces = np.asarray(out, np.int32).reshape(-1, 3)
        else:
            # Unknown element: skip its data so later elements stay aligned.
            if fmt == "ascii":
                row_cursor += count
            else:
                if any(isinstance(d, tuple) for _, d in props):
                    raise ValueError(
                        f"{path}: cannot skip binary list element {name!r}"
                    )
                rec = np.dtype([(p, bo + d) for p, d in props])
                offset += rec.itemsize * count
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    return PlyMesh(verts=verts, faces=faces, normals=normals)


def _ply_header(
    n_verts: int,
    n_faces: int,
    with_normals: bool,
    binary: bool,
) -> str:
    fmt = "binary_little_endian" if binary else "ascii"
    lines = [
        "ply",
        f"format {fmt} 1.0",
        "comment mano_hand_tpu export",
        f"element vertex {n_verts}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if with_normals:
        lines += [
            "property float nx",
            "property float ny",
            "property float nz",
        ]
    if n_faces:
        lines += [
            f"element face {n_faces}",
            "property list uchar int vertex_indices",
        ]
    lines.append("end_header")
    return "\n".join(lines) + "\n"


def export_ply(
    verts: np.ndarray,                 # [V, 3]
    faces: Optional[np.ndarray],       # [F, 3] int, or None → point cloud
    path: PathLike,
    normals: Optional[np.ndarray] = None,  # [V, 3]
    binary: bool = True,
) -> Path:
    """Write a mesh (or, with ``faces=None``, a point cloud) as PLY.

    Positions and normals are written float32 — PLY readers assume it,
    and float32 already carries the full on-chip precision. Face indices
    are int32 with the standard uchar list count (3).
    """
    path = Path(path)
    verts = as_numpy(verts, "<f4").reshape(-1, 3)
    if normals is not None:
        normals = as_numpy(normals, "<f4").reshape(-1, 3)
        if normals.shape != verts.shape:
            raise ValueError(
                f"normals shape {normals.shape} != verts {verts.shape}"
            )
        vdata = np.concatenate([verts, normals], axis=1)
    else:
        vdata = verts
    if faces is not None:
        faces = as_numpy(faces, "<i4").reshape(-1, 3)
        if faces.size and (
            faces.min() < 0 or faces.max() >= verts.shape[0]
        ):
            raise ValueError(
                f"face indices out of range [0, {verts.shape[0]})"
            )
    n_faces = 0 if faces is None else faces.shape[0]
    header = _ply_header(
        verts.shape[0], n_faces, normals is not None, binary
    )
    if binary:
        with open(path, "wb") as fp:
            fp.write(header.encode("ascii"))
            fp.write(vdata.tobytes())
            if faces is not None:
                # Per row: uchar 3 then three int32s — a structured array
                # writes it in one contiguous block.
                rec = np.empty(
                    n_faces,
                    dtype=[("n", "u1"), ("idx", "<i4", (3,))],
                )
                rec["n"] = 3
                rec["idx"] = faces
                fp.write(rec.tobytes())
    else:
        with open(path, "w") as fp:
            fp.write(header)
            # %.9g: the shortest format that round-trips float32 exactly
            # (%g keeps 6 significant digits and would make ascii and
            # binary exports of the same mesh disagree at ~1e-6).
            fp.write(
                "\n".join(
                    " ".join("%.9g" % x for x in row) for row in vdata
                )
            )
            fp.write("\n")
            if faces is not None and n_faces:
                fp.write(
                    "\n".join(
                        "3 %d %d %d" % tuple(row) for row in faces
                    )
                )
                fp.write("\n")
    return path
