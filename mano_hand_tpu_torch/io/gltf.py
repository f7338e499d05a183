"""Binary glTF 2.0 (GLB) export: viewer-ready meshes, standard library only.

A port copy of the JAX package's ``io/gltf.py``: for the same arrays the
bytes are identical (the asset's ``generator`` field included). GLB is the
interchange the OBJ path cannot cover: one binary file that three.js,
Blender and every glTF viewer load directly, with normals, the winding
kept and, for clips, a morph-target or skinned animation. Arrays may also
be tensors on any device (each copied to the host once). ``read_glb``
parses the container back for integrity checks.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Sequence

import numpy as np
import torch

from mano_hand_tpu_torch.utils.arrays import as_numpy

_MAGIC = 0x46546C67          # 'glTF'
_CHUNK_JSON = 0x4E4F534A     # 'JSON'
_CHUNK_BIN = 0x004E4942      # 'BIN\0'
_F32 = 5126                  # GL_FLOAT
_U32 = 5125                  # GL_UNSIGNED_INT


def _pad4(b: bytes, fill: bytes) -> bytes:
    return b + fill * (-len(b) % 4)


class _Builder:
    """Shared buffer/view/accessor assembly for both GLB exporters."""

    _TYPES = {1: "SCALAR", 3: "VEC3", 4: "VEC4", 16: "MAT4"}
    _CTYPES = {np.dtype(np.float32): _F32, np.dtype(np.uint32): _U32,
               np.dtype(np.uint8): 5121}

    def __init__(self):
        self.buffers: list[bytes] = []
        self.views = []
        self.accessors = []

    def add(self, data: np.ndarray, target=None, minmax=False):
        data = np.ascontiguousarray(data)
        raw = data.tobytes()
        offset = sum(len(b) for b in self.buffers)
        self.buffers.append(_pad4(raw, b"\x00"))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(raw)}
        if target:
            view["target"] = target
        self.views.append(view)
        acc = {
            "bufferView": len(self.views) - 1,
            "componentType": self._CTYPES[data.dtype],
            "count": int(data.shape[0] if data.ndim > 1 else data.size),
            "type": self._TYPES[1 if data.ndim == 1 else data.shape[-1]],
        }
        if minmax:
            acc["min"] = [float(x) for x in data.min(axis=0)]
            acc["max"] = [float(x) for x in data.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_times(self, times: np.ndarray):
        """Keyframe-time accessor (scalar min/max required by the spec)."""
        idx = self.add(times)
        self.accessors[idx]["min"] = [float(times.min())]
        self.accessors[idx]["max"] = [float(times.max())]
        return idx

    def write(self, gltf: dict, path) -> str:
        bin_chunk = b"".join(self.buffers)
        gltf["buffers"] = [{"byteLength": len(bin_chunk)}]
        gltf["bufferViews"] = self.views
        gltf["accessors"] = self.accessors
        json_chunk = _pad4(
            json.dumps(gltf, separators=(",", ":")).encode(), b" ")
        total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", _MAGIC, 2, total))
            f.write(struct.pack("<II", len(json_chunk), _CHUNK_JSON))
            f.write(json_chunk)
            f.write(struct.pack("<II", len(bin_chunk), _CHUNK_BIN))
            f.write(bin_chunk)
        return str(path)


def _check_mesh_args(verts, faces):
    if verts.ndim != 2 or verts.shape[-1] != 3:
        raise ValueError(f"verts must be [V, 3], got {verts.shape}")
    if faces.ndim != 2 or faces.shape[-1] != 3:
        raise ValueError(f"faces must be [F, 3], got {faces.shape}")


def _check_fps(fps):
    if not fps > 0:
        # arange/fps would put inf/nan keyframe times into the JSON
        # chunk (json.dumps emits bare Infinity — invalid glTF that
        # strict viewers reject with an opaque parse error).
        raise ValueError(f"fps must be > 0, got {fps}")


def _check_colors(vertex_colors, verts):
    vertex_colors = as_numpy(vertex_colors, np.float32)
    if vertex_colors.shape != verts.shape:
        raise ValueError(
            f"vertex_colors must be [V, 3] matching verts, got "
            f"{vertex_colors.shape}")
    return vertex_colors


def export_glb(
    verts: np.ndarray,            # [V, 3] float
    faces: np.ndarray,            # [F, 3] int
    path,
    normals: Optional[np.ndarray] = None,   # [V, 3]; computed if None
    morph_frames: Optional[Sequence[np.ndarray]] = None,  # T x [V, 3]
    fps: float = 30.0,
    vertex_colors: Optional[np.ndarray] = None,  # [V, 3] RGB in [0, 1]
) -> str:
    """Write a mesh (optionally an animated clip) as a GLB file.

    ``morph_frames`` turns the export into a playable animation: each
    frame's vertices become a morph target (displacements from the base
    mesh) driven by a step-less linear weight animation at ``fps`` —
    exactly one target active per frame time. Viewers play it directly;
    the data path is the same `[T, V, 3]` array `fit_sequence` or
    `evaluate_sequence` produce. ``vertex_colors`` writes a float
    ``COLOR_0`` attribute — e.g. ``viz.error_colormap`` output, making a
    fit-error heatmap inspectable as a 3D object in any glTF viewer
    (``cli fit --heatmap err.glb``). Returns the path.
    """
    verts = as_numpy(verts, np.float32)
    faces = as_numpy(faces, np.uint32)
    _check_mesh_args(verts, faces)
    if normals is None:
        normals = _vertex_normals_np(verts, faces)
    normals = as_numpy(normals, np.float32)
    if vertex_colors is not None:
        vertex_colors = _check_colors(vertex_colors, verts)

    b = _Builder()
    a_pos = b.add(verts, target=34962, minmax=True)       # ARRAY_BUFFER
    a_nrm = b.add(normals, target=34962)
    a_idx = b.add(faces.reshape(-1), target=34963)        # ELEMENT_ARRAY

    primitive = {
        "attributes": {"POSITION": a_pos, "NORMAL": a_nrm},
        "indices": a_idx,
        "mode": 4,  # TRIANGLES
    }
    if vertex_colors is not None:
        primitive["attributes"]["COLOR_0"] = b.add(vertex_colors,
                                                   target=34962)
    gltf = {
        "asset": {"version": "2.0", "generator": "mano_hand_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "hand"}],
        "meshes": [{"primitives": [primitive]}],
    }

    if morph_frames is not None:
        _check_fps(fps)
        if torch.is_tensor(morph_frames):
            morph_frames = as_numpy(morph_frames)
        frames = [as_numpy(f, np.float32) for f in morph_frames]
        if not frames:
            raise ValueError("morph_frames is empty")
        for f in frames:
            if f.shape != verts.shape:
                raise ValueError(
                    f"morph frame shape {f.shape} != verts {verts.shape}"
                )
        targets = []
        for f in frames:
            targets.append({"POSITION": b.add(f - verts, target=34962,
                                              minmax=True)})
        primitive["targets"] = targets
        t_frames = len(frames)
        gltf["meshes"][0]["weights"] = [0.0] * t_frames
        # One-hot weight tracks sampled at frame times: LINEAR
        # interpolation cross-fades adjacent frames — smooth playback of
        # the clip without shipping per-frame meshes.
        a_time = b.add_times(np.arange(t_frames, dtype=np.float32) / fps)
        weights = np.eye(t_frames, dtype=np.float32).reshape(-1)
        a_wts = b.add(weights)
        gltf["animations"] = [{
            "name": "clip",
            "samplers": [{
                "input": a_time,
                "interpolation": "LINEAR",
                "output": a_wts,
            }],
            "channels": [{
                "sampler": 0,
                "target": {"node": 0, "path": "weights"},
            }],
        }]

    return b.write(gltf, path)


def export_glb_skinned(
    verts: np.ndarray,            # [V, 3] shaped REST-pose vertices
    faces: np.ndarray,            # [F, 3] int
    joints_rest: np.ndarray,      # [J, 3] shaped rest-pose joints
    parents: Sequence[int],       # len J, parents[0] == -1 (root)
    lbs_weights: np.ndarray,      # [V, J] skinning weights (rows sum to 1)
    path,
    pose_frames: Optional[np.ndarray] = None,  # [T, J, 3] axis-angle
    trans_frames: Optional[np.ndarray] = None,  # [T, 3] root translation
    fps: float = 30.0,
    normals: Optional[np.ndarray] = None,
    vertex_colors: Optional[np.ndarray] = None,
    max_influences: int = 4,
) -> str:
    """Write a SKINNED GLB: real skeleton, LBS weights, rotation tracks.

    The morph-target path (``export_glb``) ships baked vertices — exact
    (pose correctives included) but frame-count-sized and unposeable
    after export. This writes the model the way engines actually drive
    hands: joint nodes in the MANO hierarchy (node translation = rest
    offset from parent, so glTF's local-rotation compose IS the FK of
    ops/fk.py),
    inverse bind matrices from the rest joints, per-vertex JOINTS_0/
    WEIGHTS_0, and (optionally) the pose clip as quaternion rotation
    channels at ``fps`` (+ a root translation track). Any glTF engine
    can then retarget, blend, or drive the skeleton live.

    Honest divergence from the exact forward: glTF skinning is plain
    LBS — the pose-corrective blendshapes cannot be
    encoded in a skin, so posed surfaces differ from ``core.forward`` by
    the corrective magnitude (millimeter-scale). Export morph targets
    when exactness beats drivability. glTF caps influences at 4 per set;
    rows are top-``max_influences`` re-normalized (MANO weights
    concentrate on <=4 joints, so the dropped mass is tiny).
    """
    verts = as_numpy(verts, np.float32)
    faces = as_numpy(faces, np.uint32)
    _check_mesh_args(verts, faces)
    joints_rest = as_numpy(joints_rest, np.float32)
    w = as_numpy(lbs_weights, np.float32)
    j = joints_rest.shape[0]
    if joints_rest.shape != (j, 3) or len(parents) != j:
        raise ValueError(
            f"joints_rest {joints_rest.shape} / parents len {len(parents)} "
            "disagree")
    if parents[0] != -1 and parents[0] is not None:
        raise ValueError(f"parents[0] must mark the root, got {parents[0]}")
    if w.shape != (verts.shape[0], j):
        raise ValueError(f"lbs_weights must be [V, {j}], got {w.shape}")
    if not (1 <= max_influences <= 4):
        raise ValueError("max_influences must be in 1..4 (glTF set size)")
    if trans_frames is not None and pose_frames is None:
        # Refuse rather than silently drop the caller's clip (every other
        # bad input here raises; this one must too).
        raise ValueError("trans_frames requires pose_frames (the root "
                         "translation track rides the same keyframes)")
    if normals is None:
        normals = _vertex_normals_np(verts, faces)
    normals = as_numpy(normals, np.float32)

    b = _Builder()
    add = b.add

    # Top-k influence selection, re-normalized (glTF: 4 per attribute set).
    order = np.argsort(-w, axis=1)[:, :max_influences]        # [V, k]
    sel = np.take_along_axis(w, order, axis=1)                # [V, k]
    sel = sel / np.maximum(sel.sum(axis=1, keepdims=True), 1e-12)
    k = max_influences
    joints0 = np.zeros((verts.shape[0], 4), np.uint8)
    weights0 = np.zeros((verts.shape[0], 4), np.float32)
    joints0[:, :k] = order.astype(np.uint8)
    weights0[:, :k] = sel

    a_pos = add(verts, target=34962, minmax=True)
    a_nrm = add(normals, target=34962)
    a_idx = add(faces.reshape(-1), target=34963)
    a_j0 = add(joints0, target=34962)          # uint8 -> UNSIGNED_BYTE
    a_w0 = add(weights0, target=34962)

    primitive = {
        "attributes": {"POSITION": a_pos, "NORMAL": a_nrm,
                       "JOINTS_0": a_j0, "WEIGHTS_0": a_w0},
        "indices": a_idx,
        "mode": 4,
    }
    if vertex_colors is not None:
        primitive["attributes"]["COLOR_0"] = add(
            _check_colors(vertex_colors, verts), target=34962)

    # Joint nodes: local translation = rest offset from parent; the mesh
    # node (0) carries the skin, joints are nodes 1..J in input order.
    nodes = [{"mesh": 0, "skin": 0, "name": "hand"}]
    for jj in range(j):
        par = parents[jj]
        off = (joints_rest[jj] if (par is None or par < 0)
               else joints_rest[jj] - joints_rest[par])
        nodes.append({"name": f"joint_{jj}",
                      "translation": [float(x) for x in off]})
    for jj in range(j):
        par = parents[jj]
        if par is not None and par >= 0:
            nodes[1 + par].setdefault("children", []).append(1 + jj)

    # Inverse bind matrices: rotation-free rest pose -> translate(-p_j),
    # column-major per glTF.
    ibm = np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (j, 1))
    ibm[:, 12:15] = -joints_rest
    a_ibm = add(ibm)

    gltf = {
        "asset": {"version": "2.0", "generator": "mano_hand_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": nodes,
        "meshes": [{"primitives": [primitive]}],
        "skins": [{"inverseBindMatrices": a_ibm,
                   "joints": list(range(1, j + 1)),
                   "skeleton": 1}],
    }

    if pose_frames is not None:
        _check_fps(fps)
        pose_frames = as_numpy(pose_frames, np.float32)
        if pose_frames.ndim != 3 or pose_frames.shape[1:] != (j, 3):
            raise ValueError(
                f"pose_frames must be [T, {j}, 3] axis-angle, got "
                f"{pose_frames.shape}")
        t_frames = pose_frames.shape[0]
        a_time = b.add_times(np.arange(t_frames, dtype=np.float32) / fps)

        # Axis-angle -> unit quaternion [x, y, z, w] per joint track.
        theta = np.linalg.norm(pose_frames, axis=-1, keepdims=True)
        half = 0.5 * theta
        # sin(x)/x, series-guarded at zero like ops/rodrigues.py.
        small = theta < 1e-6
        sinc = np.where(small, 0.5 - theta * theta / 48.0,
                        np.sin(half) / np.maximum(theta, 1e-12))
        quat = np.concatenate(
            [pose_frames * sinc, np.cos(half)], axis=-1
        ).astype(np.float32)                                 # [T, J, 4]

        samplers = []
        channels = []
        for jj in range(j):
            a_rot = add(np.ascontiguousarray(quat[:, jj, :]))
            samplers.append({"input": a_time,
                             "interpolation": "LINEAR",
                             "output": a_rot})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": 1 + jj,
                                        "path": "rotation"}})
        if trans_frames is not None:
            trans_frames = as_numpy(trans_frames, np.float32)
            if trans_frames.shape != (t_frames, 3):
                raise ValueError(
                    f"trans_frames must be [{t_frames}, 3], got "
                    f"{trans_frames.shape}")
            # Root translation composes with the root's rest offset.
            a_tr = add(trans_frames + joints_rest[0])
            samplers.append({"input": a_time,
                             "interpolation": "LINEAR",
                             "output": a_tr})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": 1, "path": "translation"}})
        gltf["animations"] = [{"name": "clip", "samplers": samplers,
                               "channels": channels}]

    return b.write(gltf, path)


def _vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, pure numpy (export-time only — the
    differentiable version lives in ops/normals.py)."""
    v = verts.astype(np.float64)
    f = faces.astype(np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for c in range(3):
        np.add.at(n, f[:, c], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(lens > 1e-12, n / np.maximum(lens, 1e-12),
                 np.array([0.0, 0.0, 1.0]))
    return n.astype(np.float32)  # spec wants unit normals — even for
    #   vertices no face references (possible on synthetic assets)


def read_glb(path) -> dict:
    """Parse a GLB container: the glTF JSON dict plus raw chunk sizes.

    For integrity checks (same role as viz/avi.py's ``read_avi_info``);
    not a general loader.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"glTF":
        raise ValueError("not a GLB file (bad magic)")
    magic, version, total = struct.unpack_from("<III", data, 0)
    if total != len(data):
        raise ValueError(
            f"truncated GLB: header says {total} bytes, file has {len(data)}"
        )
    jlen, jtype = struct.unpack_from("<II", data, 12)
    if jtype != _CHUNK_JSON:
        raise ValueError("first GLB chunk is not JSON")
    gltf = json.loads(data[20:20 + jlen].decode())
    out = {"gltf": gltf, "version": version, "json_bytes": jlen}
    off = 20 + jlen
    if off < len(data):
        blen, btype = struct.unpack_from("<II", data, off)
        if btype != _CHUNK_BIN:
            raise ValueError("second GLB chunk is not BIN")
        out["bin_bytes"] = blen
        out["bin"] = data[off + 8:off + 8 + blen]
    return out
