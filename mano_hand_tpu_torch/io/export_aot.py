"""Ahead-of-time export of the MANO forward (``torch.export``).

The port's copy of the JAX package's ``io/export_aot.py``, same names.
Export the forward ONCE — parameters baked in as constants — and serve
it from a process that needs only ``torch`` and this module: no asset
on disk, no model code on the call path. The batch dimension is
symbolic (``torch.export.Dim``) or pinned.

Artifact layout: a small self-describing container — ``MANOTCH1`` magic
+ uint32 header length + JSON header (shapes, the batch, the keypoint
spec, ``platforms``, ``params_digest``: the JAX header's fields) + one
``torch.export.save`` program per platform, back to back (sizes in the
header's ``programs``). ``platforms`` are torch device types (``"cpu"``,
``"cuda"``): an exported program carries its constants on the device it
was traced on, so each platform is traced on its own device, which must
be present at export time. The magic differs from JAX's ``MANOAOT1``:
neither package takes the other's file for its own.

Typical use::

    save_forward(params, "mano_fwd.torchexp", tip_vertex_ids="smplx")
    ...                                   # later, anywhere:
    fwd = load_forward("mano_fwd.torchexp")
    out = fwd(pose_b16x3, shape_b10)      # {"verts": ..., "keypoints": ...}

The executable lattice below is the serving engine's persistent program
cache: every program ``ServingEngine`` can reach, with the parameters and
the subject table as runtime ARGUMENTS.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from mano_hand_tpu_torch.assets.schema import ARRAY_FIELDS
from mano_hand_tpu_torch.ops.common import ieee_fp32

_MAGIC = b"MANOTCH1"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x))


def params_digest(params, n_hex: int = 16) -> str:
    """Content digest of a parameter set (hex, ``n_hex`` chars): every
    array leaf's bytes with its dtype and shape, in ``ARRAY_FIELDS``
    order, then ``parents`` and ``side``. The JAX package's
    ``params_digest`` of the same arrays gives the same hex, so a lattice
    or checkpoint names its asset the same way in both packages."""
    h = hashlib.sha256()
    for name in ARRAY_FIELDS:
        a = _host(getattr(params, name))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(tuple(params.parents)).encode())
    h.update(params.side.encode())
    return h.hexdigest()[:n_hex]


def _devices(platforms: Optional[Sequence[str]]) -> tuple:
    platforms = tuple(platforms) if platforms else ("cpu",)
    for p in platforms:
        if p not in ("cpu", "cuda"):
            raise ValueError(
                f"platforms are torch device types ('cpu', 'cuda'), got {p!r}")
        if p == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                "platform 'cuda' is traced on the card, and CUDA is not "
                "available on this machine")
    return platforms


def _serialize(module: torch.nn.Module, args, dynamic_shapes=None) -> bytes:
    with torch.no_grad(), ieee_fp32():
        ep = torch.export.export(module, args, dynamic_shapes=dynamic_shapes)
    if hasattr(ep, "_example_inputs"):
        # The zeros it was traced on would be saved with it (a lattice
        # entry's params leaves: 1.5 MB of 1.6).
        ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _container(header: dict, blobs: Sequence[bytes]) -> bytes:
    header = json.dumps({**header, "programs": [len(b) for b in blobs]})
    head = header.encode()
    return _MAGIC + struct.pack("<I", len(head)) + head + b"".join(blobs)


class _Forward(torch.nn.Module):
    def __init__(self, params, tips, order: str):
        super().__init__()
        self.params, self.tips, self.order = params, tips, order

    def forward(self, pose, shape):
        from mano_hand_tpu_torch.models import core

        out = core.forward_batched(self.params, pose, shape)
        return {"verts": out.verts,
                "keypoints": core.select_keypoints(
                    out.verts, out.posed_joints, self.tips, self.order)}


def export_forward(
    params,
    *,
    batch: Union[str, int] = "b",
    tip_vertex_ids=None,
    keypoint_order: str = "mano",
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize the batched forward as a self-contained artifact.

    ``batch`` is a symbolic dimension name (default: any batch size) or a
    concrete int to pin it. Parameters ride inside the artifact as
    constants. ``tip_vertex_ids`` / ``keypoint_order`` bake the extended
    keypoint selection (``core.keypoints``) in. ``platforms`` (default
    ``("cpu",)``): the device types to export for, one program each."""
    from mano_hand_tpu_torch.models import core

    tips = core.resolve_tip_ids(tip_vertex_ids, params.n_verts)
    if keypoint_order not in ("mano", "openpose"):
        raise ValueError(
            f"keypoint_order must be 'mano' or 'openpose', "
            f"got {keypoint_order!r}")
    platforms = _devices(platforms)
    n_joints, n_shape = params.n_joints, params.n_shape
    b = 2 if isinstance(batch, str) else int(batch)
    dyn = None
    if isinstance(batch, str):
        dim = torch.export.Dim(batch)
        dyn = ({0: dim}, {0: dim})
    blobs = []
    for platform in platforms:
        on = params.to(platform)
        args = (torch.zeros((b, n_joints, 3), dtype=on.dtype, device=platform),
                torch.zeros((b, n_shape), dtype=on.dtype, device=platform))
        blobs.append(_serialize(_Forward(on, tips, keypoint_order), args, dyn))
    header = {
        "n_joints": n_joints,
        "n_shape": n_shape,
        "n_verts": params.n_verts,
        "dtype": str(_host(params.v_template).dtype),
        "batch": batch if isinstance(batch, int) else None,
        "tip_vertex_ids": list(tips) if tips else None,
        "keypoint_order": keypoint_order,
        "platforms": list(platforms),
        "params_digest": params_digest(params),
    }
    return _container(header, blobs)


def save_forward(params, path, **kw) -> str:
    """``export_forward`` to a file; returns the path."""
    data = export_forward(params, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _split_container(data: bytes):
    """(meta, [program blobs]) of a ``_MAGIC`` container; ValueError on
    damage."""
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError(
            "not a MANO torch AOT artifact (bad magic); expected a file "
            "written by save_forward/export_forward of mano_hand_tpu_torch")
    off = len(_MAGIC)
    if len(data) < off + 4:
        raise ValueError("truncated MANO AOT artifact (no header length)")
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    if len(data) < off + hlen:
        raise ValueError("truncated MANO AOT artifact (incomplete header)")
    meta = json.loads(data[off:off + hlen].decode())
    off += hlen
    blobs = []
    for size in meta.get("programs", ()):
        if len(data) < off + size:
            raise ValueError("truncated MANO AOT artifact (incomplete "
                             "program)")
        blobs.append(data[off:off + size])
        off += size
    return meta, blobs


def _load_program(blob: bytes) -> torch.nn.Module:
    return torch.export.load(io.BytesIO(blob)).module()


def _platform_of(x) -> str:
    return x.device.type if torch.is_tensor(x) else "cpu"


class AotForward:
    """A deserialized forward artifact: callable, with its metadata.

    ``fwd(pose[B, J, 3], shape[B, S]) -> {"verts": [B, V, 3],
    "keypoints": [B, K, 3]}`` on the device of ``pose`` (numpy input runs
    on the CPU), which must be one of ``platforms``. ``meta`` is the
    export-time header dict."""

    def __init__(self, meta: dict, programs: dict):
        self.meta = meta
        self._programs = programs     # platform -> loaded module

    @property
    def platforms(self):
        return tuple(self.meta["platforms"])

    @property
    def n_keypoints(self) -> int:
        tips = self.meta["tip_vertex_ids"]
        return self.meta["n_joints"] + (len(tips) if tips else 0)

    def __call__(self, pose, shape):
        platform = _platform_of(pose)
        prog = self._programs.get(platform)
        if prog is None:
            raise ValueError(
                f"this artifact was exported for {list(self.platforms)}, "
                f"not {platform!r}")
        pose, shape = (torch.as_tensor(x, device=platform)
                       for x in (pose, shape))
        with torch.no_grad(), ieee_fp32():
            return prog(pose, shape)

    def __repr__(self):
        m = self.meta
        return (
            f"AotForward(verts={m['n_verts']}, joints={m['n_joints']}, "
            f"keypoints={self.n_keypoints}, "
            f"batch={m['batch'] or 'symbolic'}, "
            f"platforms={m['platforms']})")


def load_forward(src) -> AotForward:
    """Load an artifact from a path or raw bytes; no model assets needed."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    meta, blobs = _split_container(data)
    if len(blobs) != len(meta.get("platforms", ())):
        raise ValueError("MANO AOT artifact: one program per platform "
                         f"expected, found {len(blobs)}")
    return AotForward(meta, {p: _load_program(b)
                             for p, b in zip(meta["platforms"], blobs)})


# --------------------------------------------------------------------------
# The executable lattice: EVERY program the serving engine can reach —
# (bucket x family {full, pose-only gathered} x table capacity, plus the
# CPU tier of a CPU engine) — baked as versioned artifacts keyed by
# params_digest, so a restarted process boots from disk.
#
# Unlike ``export_forward`` (constants baked in), lattice entries keep
# the parameters / subject table as runtime ARGUMENTS, the engine's
# bit-identity policy. Entries take the array leaves as a flat tuple in a
# fixed order (``params_leaves``, ``table_leaves``); ``parents`` and
# ``side`` are baked at trace time and guarded by the digest. A served
# entry is bit-identical to the live program of its family on the same
# device (pinned in tests/test_torch_coldstart.py). The fused family
# (K2) and the bf16 family are never baked, as in JAX.
#
# Manifest (``lattice.json``): {"schema": 1, "params_digest": "<hex16>",
# "dtype": "float32", "n_joints": 16, "n_shape": 10, "entries":
# {"full/b8": {"file", "sha256", "bucket", "platforms"}, "gather/b8/c16":
# {..., "capacity"}, "cpu/b8": {...}}}. ``schema`` bumps on ANY
# incompatible change; a different schema or digest, or a damaged entry,
# degrades to a counted live build — never a crash, never a wrong
# program.

LATTICE_SCHEMA_VERSION = 1
LATTICE_MANIFEST = "lattice.json"

# SubjectTable leaves in lattice calling-convention order.
_TABLE_FIELDS = ("v_shaped", "joints", "shape", "pose_basis", "lbs_weights")


def params_leaves(params) -> tuple:
    """A ManoParams' tensors as the flat tuple lattice ``full``/``cpu``
    entries take (``ARRAY_FIELDS`` order)."""
    return tuple(getattr(params, n) for n in ARRAY_FIELDS)


def table_leaves(table) -> tuple:
    """A SubjectTable's tensors as the flat tuple lattice ``gather``
    entries take (fixed order)."""
    return tuple(getattr(table, n) for n in _TABLE_FIELDS)


class _ServeFull(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.params = params

    def forward(self, leaves, pose, shape):
        import dataclasses

        from mano_hand_tpu_torch.models import core

        q = dataclasses.replace(self.params, **dict(zip(ARRAY_FIELDS, leaves)))
        return core.forward_batched(q, pose, shape).verts


class _ServeGather(torch.nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = table

    def forward(self, leaves, idx, pose):
        import dataclasses

        from mano_hand_tpu_torch.models import core

        t = dataclasses.replace(self.table,
                                **dict(zip(_TABLE_FIELDS, leaves)))
        return core.forward_posed_gather(t, idx, pose).verts


def _pack(kind: str, params, extra: dict, blobs) -> bytes:
    return _container({
        "program": kind,
        "schema": LATTICE_SCHEMA_VERSION,
        "params_digest": params_digest(params),
        "n_joints": params.n_joints,
        "n_shape": params.n_shape,
        "dtype": str(_host(params.v_template).dtype),
        **extra,
    }, blobs)


def export_serve_full(params, bucket: int, *,
                      platforms: Sequence[str] = ("cpu",)) -> bytes:
    """One ``full`` lattice entry: the bucketed full forward
    (``core.forward_batched``) with params as runtime arguments. Call
    convention: ``call(params_leaves, pose[b, J, 3], shape[b, S]) ->
    verts``."""
    platforms = _devices(platforms)
    blobs = []
    for platform in platforms:
        on = params.to(platform)
        args = (params_leaves(on),
                torch.zeros((bucket, on.n_joints, 3), dtype=on.dtype,
                            device=platform),
                torch.zeros((bucket, on.n_shape), dtype=on.dtype,
                            device=platform))
        blobs.append(_serialize(_ServeFull(on), args))
    return _pack("serve_full", params,
                 {"bucket": int(bucket), "platforms": list(platforms)}, blobs)


def export_serve_gather(params, bucket: int, capacity: int, *,
                        platforms: Sequence[str] = ("cpu",)) -> bytes:
    """One ``gather`` lattice entry: the mixed-subject pose-only program
    (``core.forward_posed_gather``) at (bucket, table capacity), table
    and index as runtime arguments. Call convention:
    ``call(table_leaves, idx[b] int32, pose[b, J, 3]) -> verts``."""
    from mano_hand_tpu_torch.models import core

    platforms = _devices(platforms)
    blobs = []
    for platform in platforms:
        table = core.subject_table(params.to(platform), capacity)
        args = (table_leaves(table),
                torch.zeros((bucket,), dtype=torch.int32, device=platform),
                torch.zeros((bucket, table.n_joints, 3),
                            dtype=table.v_shaped.dtype, device=platform))
        blobs.append(_serialize(_ServeGather(table), args))
    return _pack("serve_gather", params,
                 {"bucket": int(bucket), "capacity": int(capacity),
                  "platforms": list(platforms)}, blobs)


def _entry_name(digest: str, key: str) -> str:
    return f"lat_{digest}_{key.replace('/', '_')}.torchexp"


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def bake_lattice(
    params,
    out_dir,
    *,
    buckets: Sequence[int],
    capacities: Sequence[int] = (),
    platforms: Sequence[str] = ("cpu",),
    cpu_fallback: bool = True,
) -> dict:
    """Pre-bake the executable lattice into ``out_dir``; returns the
    manifest dict (also written as ``lattice.json``).

    Entries: ``full/b{B}`` for every bucket; ``gather/b{B}/c{C}`` for
    every (bucket, capacity) pair; ``cpu/b{B}`` (the CPU tier,
    platforms=("cpu",)) when ``cpu_fallback``. Every write is atomic
    (temp + rename) and the manifest lands LAST, so a process killed
    mid-bake leaves either no manifest or a complete, checksummed one. A
    same-schema, same-digest manifest already there is merged into (two
    engine configs may share one directory); any other is replaced."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = params_digest(params)
    entries = {}
    prior = out_dir / LATTICE_MANIFEST
    if prior.exists():
        try:
            old = json.loads(prior.read_text())
            if (old.get("schema") == LATTICE_SCHEMA_VERSION
                    and old.get("params_digest") == digest):
                entries = dict(old.get("entries") or {})
        except (OSError, ValueError):
            pass

    def emit(key: str, data: bytes, meta: dict):
        name = _entry_name(digest, key)
        _write_atomic(out_dir / name, data)
        entries[key] = {"file": name,
                        "sha256": hashlib.sha256(data).hexdigest(), **meta}

    platforms = list(_devices(platforms))
    for b in buckets:
        emit(f"full/b{b}", export_serve_full(params, b, platforms=platforms),
             {"bucket": int(b), "platforms": platforms})
        for c in capacities:
            emit(f"gather/b{b}/c{c}",
                 export_serve_gather(params, b, c, platforms=platforms),
                 {"bucket": int(b), "capacity": int(c),
                  "platforms": platforms})
        if cpu_fallback:
            emit(f"cpu/b{b}", export_serve_full(params, b, platforms=("cpu",)),
                 {"bucket": int(b), "platforms": ["cpu"]})
    manifest = {
        "schema": LATTICE_SCHEMA_VERSION,
        "params_digest": digest,
        "dtype": str(_host(params.v_template).dtype),
        "n_joints": int(params.n_joints),
        "n_shape": int(params.n_shape),
        "entries": entries,
    }
    _write_atomic(prior, json.dumps(manifest, indent=1,
                                    sort_keys=True).encode())
    return manifest


class ExecutableLattice:
    """Boot-time view of a baked lattice directory.

    ``get(kind, bucket, capacity, platform=)`` returns the loaded program
    (a callable module), or None when the entry is absent or DAMAGED — a
    truncated, corrupted, checksum-, schema-, digest- or platform-
    mismatched entry is reported through ``on_failure`` (the engine
    counts it as ``aot_load_failures``) and the caller falls back to a
    live build. A bad entry can never crash boot or serve wrong results
    (the checksum covers the whole file; the header re-checks provenance
    after it). Loaded programs are cached, so a warm entry is a dict hit.
    Thread-safe: the read and deserialize run outside the lock, and the
    first writer wins."""

    def __init__(self, directory, manifest: dict, on_failure=None):
        self.dir = Path(directory)
        self.manifest = manifest
        self._on_failure = on_failure
        self._lock = threading.Lock()
        self._cache: dict = {}
        self._bad: set = set()

    @staticmethod
    def key_of(kind: str, bucket: int, capacity=None) -> str:
        if kind == "gather":
            return f"gather/b{bucket}/c{capacity}"
        return f"{kind}/b{bucket}"

    def __contains__(self, key: str) -> bool:
        return key in self.manifest.get("entries", {})

    def _fail(self, key: str, reason: str):
        with self._lock:
            self._bad.add(key)
        if self._on_failure is not None:
            self._on_failure(key, reason)
        warnings.warn(f"lattice entry {key}: {reason}; degrading to a live "
                      "build (counted)")
        return None

    def get(self, kind: str, bucket: int, capacity=None, platform=None):
        """``platform`` (a torch device type, the engine's) selects that
        platform's program; an entry baked for other platforms is a
        counted degrade, not a device-mismatch crash in the middle of
        boot. None takes the entry's first platform."""
        key = self.key_of(kind, bucket, capacity)
        with self._lock:
            if (key, platform) in self._cache:
                return self._cache[(key, platform)]
            if key in self._bad:
                return None
        ent = self.manifest.get("entries", {}).get(key)
        if ent is None:
            return None        # never baked: a plain miss, not a failure
        try:
            data = (self.dir / ent["file"]).read_bytes()
        except OSError as e:
            return self._fail(key, f"unreadable ({e})")
        if hashlib.sha256(data).hexdigest() != ent["sha256"]:
            return self._fail(
                key, "checksum mismatch (truncated or corrupted entry)")
        try:
            meta, blobs = _split_container(data)
        except ValueError as e:
            return self._fail(key, str(e))
        if meta.get("schema") != self.manifest.get("schema"):
            return self._fail(
                key, f"entry schema {meta.get('schema')} != manifest "
                     f"{self.manifest.get('schema')}")
        if meta.get("params_digest") != self.manifest.get("params_digest"):
            return self._fail(
                key, "entry params_digest does not match the manifest "
                     "(artifact baked from a different parameter set)")
        have = list(meta.get("platforms") or ())
        want = have[0] if platform is None and have else platform
        if want not in have or len(blobs) != len(have):
            return self._fail(
                key, f"entry was exported for {have}, not the running "
                     f"device type {platform!r}")
        try:
            call = _load_program(blobs[have.index(want)])
        except Exception as e:  # noqa: BLE001 — degrade, never crash boot
            return self._fail(
                key, f"deserialize failed ({type(e).__name__}: {e})")
        with self._lock:
            return self._cache.setdefault((key, platform), call)


def load_lattice(aot_dir, params_or_digest, *, on_failure=None):
    """Open ``aot_dir``'s lattice for the given parameter set.

    Returns None when no manifest exists (no lattice was ever baked — not
    a fault) AND when the manifest is unusable (unparseable, wrong schema
    version, or baked for a different ``params_digest``): those report
    through ``on_failure("<manifest>", reason)`` and the engine boots
    without the lattice — counted live builds beat wrong results."""
    path = Path(aot_dir) / LATTICE_MANIFEST
    if not path.exists():
        return None
    digest = (params_or_digest if isinstance(params_or_digest, str)
              else params_digest(params_or_digest))

    def fail(reason):
        if on_failure is not None:
            on_failure("<manifest>", reason)
        warnings.warn(f"lattice manifest {path}: {reason}; booting without "
                      "the lattice (counted)")
        return None

    try:
        manifest = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        return fail(f"unreadable ({type(e).__name__}: {e})")
    if manifest.get("schema") != LATTICE_SCHEMA_VERSION:
        return fail(f"schema {manifest.get('schema')} != supported "
                    f"{LATTICE_SCHEMA_VERSION} (versioning rule: bump = "
                    "re-bake)")
    if manifest.get("params_digest") != digest:
        return fail(f"params_digest {manifest.get('params_digest')} does "
                    f"not match this parameter set ({digest})")
    return ExecutableLattice(aot_dir, manifest, on_failure=on_failure)
