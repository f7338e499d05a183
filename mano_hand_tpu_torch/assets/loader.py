"""Asset I/O: official MANO pickles, reference-style dumped pickles, and the
canonical ``.npz`` form.

A port copy of the JAX package's ``assets/loader.py``: the same formats,
the same tolerant unpickling of chumpy-era pickles, the same side
inference and the same ``load_model`` sniffing. Parsing stays NumPy
float64; each loader hands the arrays to ``params_from_numpy``, which
returns validated ``ManoParams`` on ``device`` (default ``cuda``) in
``dtype`` (default float64, the master precision of an asset).

Formats:
  * the official chumpy-era ``MANO_{LEFT,RIGHT}.pkl`` (sparse
    J_regressor densified, ``kintree_table`` row 0 as the parents, the
    root's sentinel mapped to -1), with no chumpy installed;
  * the nine-key dumped pickle of the reference's ``dump_model.py``
    (``parents[0] = None``), str or bytes keys;
  * official SMPL-family body pickles (no hand PCA: an identity basis
    and zero mean are synthesised, the asset is unsided);
  * the official SMPL-X ``.npz`` and chumpy-era ``.pkl`` (``load_smplx``:
    betas and expression split out of ``shapedirs``, no hand PCA);
  * the canonical flat ``.npz`` (no pickle at load time).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Union

import numpy as np
import torch

from mano_hand_tpu_torch import constants as C
from mano_hand_tpu_torch.assets.convert import params_from_numpy
from mano_hand_tpu_torch.assets.schema import ARRAY_FIELDS, ManoParams
from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.utils.arrays import as_numpy

PathLike = Union[str, Path]

_PICKLE_KEYS = {
    "pose_pca_basis": "pca_basis",
    "pose_pca_mean": "pca_mean",
    "J_regressor": "j_regressor",
    "skinning_weights": "lbs_weights",
    "mesh_pose_basis": "pose_basis",
    "mesh_shape_basis": "shape_basis",
    "mesh_template": "v_template",
    "faces": "faces",
}


class _StubPickled:
    """Stand-in for classes whose module is unimportable at unpickle time.

    The official MANO pickle holds ``chumpy.Ch`` wrappers; chumpy is dead
    upstream and absent from modern images, so unpickling must not need
    the real class. The stub absorbs any construction protocol pickle
    uses (``__setstate__`` dict, ``_reconstructor`` args) and exposes the
    wrapped ndarray the way ``_dense`` probes for it.
    """

    def __init__(self, *args, **kwargs):
        self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self._state = state

    def _arrays(self):
        return [v for v in self.__dict__.values()
                if isinstance(v, np.ndarray)]

    @property
    def r(self):
        # chumpy.Ch stores its value in attribute ``x``; fall back to the
        # largest ndarray in the state for chumpy subclasses that rename it.
        x = self.__dict__.get("x")
        if isinstance(x, np.ndarray):
            return x
        arrays = self._arrays()
        if not arrays:
            raise ValueError(
                f"stubbed pickle object has no array payload: "
                f"{sorted(self.__dict__)}"
            )
        return max(arrays, key=lambda a: a.size)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that substitutes ``_StubPickled`` for missing classes.

    It loads only what it can resolve for real and stubs the rest: asset
    pickles are untrusted input, so it never fabricates imports, it only
    narrows what a plain ``pickle.load`` would execute.
    """

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _StubPickled


def _tolerant_load(f, encoding: str):
    return _TolerantUnpickler(f, encoding=encoding).load()


def _dense(a) -> np.ndarray:
    """Materialise chumpy arrays / scipy sparse matrices as dense ndarrays."""
    if hasattr(a, "toarray"):  # scipy sparse
        return np.asarray(a.toarray())
    if hasattr(a, "r"):  # chumpy Ch object (or its _StubPickled stand-in)
        return np.asarray(a.r)
    return np.asarray(a)


def _parents_from(raw) -> tuple:
    parents = list(raw)
    parents[0] = -1  # the reference stores None; the schema uses -1
    return tuple(int(p) for p in parents)


def _infer_side(path: PathLike, explicit: str | None) -> str:
    if explicit is not None:
        return explicit
    name = Path(path).name.lower()
    # 'neutral' marks an unsided asset only when NO side marker is
    # present: a sided file whose name merely mentions neutral (e.g.
    # neutral_pose_left.pkl) keeps its handedness.
    if "neutral" in name and "left" not in name and "right" not in name:
        return C.NEUTRAL
    return C.LEFT if "left" in name else C.RIGHT


def _build(arrays: dict, parents, side: str, device, dtype) -> ManoParams:
    return params_from_numpy(dict(arrays, parents=parents, side=side),
                             device=device, dtype=dtype)


def load_dumped_pickle(path: PathLike, side: str | None = None,
                       device=None, dtype=torch.float64) -> ManoParams:
    """Load an asset in the reference's dumped-pickle format (nine keys).

    Keys may be str or bytes: the reference reads its own dumps with
    ``encoding='bytes'``, so py2-era dumps with bytes keys are legitimate
    inputs.
    """
    dev = resolve_device(device)
    with open(path, "rb") as f:
        raw = _tolerant_load(f, encoding="bytes")
    raw = {k.decode() if isinstance(k, bytes) else k: v
           for k, v in raw.items()}
    arrays = {ours: _dense(raw[theirs])
              for theirs, ours in _PICKLE_KEYS.items()}
    arrays["faces"] = arrays["faces"].astype(np.int32)
    return _build(arrays, _parents_from(raw["parents"]),
                  _infer_side(path, side), dev, dtype)


def load_official_pickle(path: PathLike, side: str | None = None,
                         device=None, dtype=torch.float64) -> ManoParams:
    """Load an official MANO_{LEFT,RIGHT}.pkl directly (chumpy-era pickle).

    Folds in the reference's offline conversion: densify the sparse
    J_regressor, take row 0 of kintree_table as the parent array, and
    strip chumpy wrappers (``encoding='latin1'`` for the py2-era pickle).
    Works WITHOUT chumpy installed: unresolvable classes unpickle as
    ``_StubPickled``, whose ``.r`` hands ``_dense`` the wrapped array.
    """
    return _official_params(_read_latin1(path), path, side,
                            resolve_device(device), dtype)


def _read_latin1(path: PathLike) -> dict:
    """A chumpy-era pickle's dict (``encoding='latin1'``, no chumpy)."""
    with open(path, "rb") as f:
        return _tolerant_load(f, encoding="latin1")


def _official_params(raw: dict, path: PathLike, side: str | None, dev,
                     dtype) -> ManoParams:
    """``load_official_pickle`` on the dict ``_read_latin1`` gave."""
    arrays = dict(
        v_template=_dense(raw["v_template"]).astype(np.float64),
        shape_basis=_dense(raw["shapedirs"]).astype(np.float64),
        pose_basis=_dense(raw["posedirs"]).astype(np.float64),
        j_regressor=_dense(raw["J_regressor"]).astype(np.float64),
        lbs_weights=_dense(raw["weights"]).astype(np.float64),
        pca_basis=_dense(raw["hands_components"]).astype(np.float64),
        pca_mean=_dense(raw["hands_mean"]).astype(np.float64),
        faces=_dense(raw["f"]).astype(np.int32),
    )
    return _build(arrays, _parents_from(_dense(raw["kintree_table"])[0]),
                  _infer_side(path, side), dev, dtype)


def load_smpl_pickle(path: PathLike, side: str | None = None,
                     device=None, dtype=torch.float64) -> ManoParams:
    """Load an official SMPL-family body pickle (SMPL/SMPL-H style keys).

    The core is topology-generic (level-parallel FK over any
    topologically ordered tree), so a body model is a bigger asset: V =
    6890, J = 24, P = 207 for SMPL. The pickle shares MANO's chumpy-era
    container but carries no hand-pose PCA, so a pass-through PCA space
    is synthesised (identity basis, zero mean, (J - 1) * 3 dims): every
    pose-PCA API keeps working and decodes to the coefficients
    themselves. Body assets are unsided (``side='neutral'``); SMPL's root
    parent arrives as uint32 ``2**32 - 1`` and maps to -1.
    """
    return _smpl_params(_read_latin1(path), side, resolve_device(device),
                        dtype)


def _smpl_params(raw: dict, side: str | None, dev, dtype) -> ManoParams:
    """``load_smpl_pickle`` on the dict ``_read_latin1`` gave."""
    j_reg = _dense(raw["J_regressor"]).astype(np.float64)
    n_aa = (j_reg.shape[0] - 1) * 3
    arrays = dict(
        v_template=_dense(raw["v_template"]).astype(np.float64),
        shape_basis=_dense(raw["shapedirs"]).astype(np.float64),
        pose_basis=_dense(raw["posedirs"]).astype(np.float64),
        j_regressor=j_reg,
        lbs_weights=_dense(raw["weights"]).astype(np.float64),
        pca_basis=np.eye(n_aa, dtype=np.float64),
        pca_mean=np.zeros(n_aa, dtype=np.float64),
        faces=_dense(raw["f"]).astype(np.int32),
    )
    parents = _parents_from(_dense(raw["kintree_table"]).astype(np.int64)[0])
    return _build(arrays, parents, C.NEUTRAL if side is None else side,
                  dev, dtype)


#: The SMPL-X file's shape space when it holds the full one (v1.1): 300
#: betas, then 100 expression columns (the ``smplx`` package's
#: ``SMPLX.SHAPE_SPACE_DIM`` and ``EXPRESSION_SPACE_DIM``). A shorter file
#: (v1.0) holds 10 betas, then 10 expression columns.
SMPLX_BETAS, SMPLX_EXPRESSION = 300, 100
SMPLX_SHORT_BETAS = 10
#: SMPL-X's joints: body 22, jaw, two eyes, 2 x 15 finger joints.
SMPLX_JOINTS = len(C.SMPLX_PARENTS)


def _smplx_arrays(raw) -> dict:
    """The numeric arrays of an official SMPL-X file's contents (an open
    ``.npz`` or the chumpy-era ``.pkl``'s dict) by their own names
    (``shapedirs``, ``posedirs``, ``J_regressor``, ...), densified.
    Nothing else is read: no object array of the ``.npz`` is unpickled."""
    return {k: _dense(raw[k]) for k in (
        "v_template", "shapedirs", "posedirs", "J_regressor", "weights",
        "kintree_table", "f")}


def _is_smplx(raw, pickled: bool) -> bool:
    """An official SMPL-X file's contents: a 55-joint ``kintree_table``
    (SMPL-H, which shares every other key, has 52) beside ``shapedirs``,
    without the port's own ``shape_basis`` (an ``.npz``), or with the
    per-hand PCA's ``hands_componentsl`` (a pickle)."""
    keys = set(raw.keys())
    need = {"shapedirs", "kintree_table"}
    if pickled:
        need.add("hands_componentsl")
    return (need <= keys and "shape_basis" not in keys
            and np.shape(_dense(raw["kintree_table"]))[-1] == SMPLX_JOINTS)


def _smplx_params(raw: dict, name: str, side: str | None, dev, dtype,
                  num_betas: int = 10, num_expression: int = 10) -> ManoParams:
    """``load_smplx`` on the arrays ``_smplx_arrays`` read from ``name``."""
    dirs = raw["shapedirs"].astype(np.float64)
    cols = dirs.shape[-1]
    if cols >= SMPLX_BETAS + SMPLX_EXPRESSION:
        betas, start, expression = SMPLX_BETAS, SMPLX_BETAS, SMPLX_EXPRESSION
    else:
        betas = start = SMPLX_SHORT_BETAS
        expression = max(0, min(cols - start, SMPLX_SHORT_BETAS))
    if not (0 <= num_betas <= min(betas, cols)
            and 0 <= num_expression <= expression):
        raise ValueError(
            f"{name} has {cols} shape columns: at most "
            f"{min(betas, cols)} betas and {expression} expression "
            f"coefficients, asked for {num_betas} and {num_expression}")
    j_reg = raw["J_regressor"].astype(np.float64)
    n_aa = (j_reg.shape[0] - 1) * 3
    arrays = dict(
        v_template=raw["v_template"].astype(np.float64),
        shape_basis=np.concatenate(
            [dirs[..., :num_betas],
             dirs[..., start:start + num_expression]], axis=-1),
        pose_basis=raw["posedirs"].astype(np.float64),
        j_regressor=j_reg,
        lbs_weights=raw["weights"].astype(np.float64),
        pca_basis=np.eye(n_aa, dtype=np.float64),
        pca_mean=np.zeros(n_aa, dtype=np.float64),
        faces=raw["f"].astype(np.int32),
    )
    parents = _parents_from(raw["kintree_table"].astype(np.int64)[0])
    return _build(arrays, parents, C.NEUTRAL if side is None else side,
                  dev, dtype)


def load_smplx(path: PathLike, num_betas: int = 10, num_expression: int = 10,
               side: str | None = None, device=None,
               dtype=torch.float64) -> ManoParams:
    """Load an official SMPL-X model (Pavlakos et al., CVPR 2019:
    ``SMPLX_{NEUTRAL,MALE,FEMALE}.npz`` or the chumpy-era ``.pkl``).

    V = 10,475, J = 55 (``kintree_table`` row 0 as the parents, the
    root's sentinel mapped to -1), P = 486. The shape basis is
    ``num_betas`` body columns followed by ``num_expression`` expression
    columns of ``shapedirs``, where the expression columns start at 300
    in a file of at least 400 columns (v1.1) and at 10 otherwise (v1.0),
    as the ``smplx`` package's ``SMPLX.__init__`` reads them. So the
    port's shape input is ``shape = cat(betas, expression)``, [B,
    num_betas + num_expression]. A count the file cannot give raises
    ``ValueError`` (the ``smplx`` package would clamp it).

    Like SMPL bodies (``load_smpl_pickle``), the hand pose is full
    axis-angle: the pose-PCA space is the identity pass-through ((J - 1)
    * 3 dims, zero mean). The file's own hand PCA (``hands_componentsl``,
    ``hands_componentsr``, their means), its face landmarks and every
    other key are not read. The asset is unsided (``side='neutral'``
    unless given)."""
    dev = resolve_device(device)
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as z:
            raw = _smplx_arrays(z)
    else:
        raw = _smplx_arrays(_read_latin1(p))
    return _smplx_params(raw, p.name, side, dev, dtype, num_betas,
                         num_expression)


def save_npz(params: ManoParams, path: PathLike) -> None:
    """Canonical on-disk form: a flat .npz, no pickle objects."""
    arrays = {f: as_numpy(getattr(params, f)) for f in ARRAY_FIELDS}
    np.savez(
        path,
        parents=np.asarray(params.parents, dtype=np.int32),
        side=np.asarray(params.side),
        **arrays,
    )


def load_npz(path: PathLike, side: str | None = None, device=None,
             dtype=torch.float64) -> ManoParams:
    """Load the canonical ``.npz`` form (``save_npz``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {f: z[f] for f in ARRAY_FIELDS}
        arrays["faces"] = arrays["faces"].astype(np.int32)
        parents = tuple(int(p) for p in z["parents"])
        side = side if side is not None else str(z["side"])
    return _build(arrays, parents, side, dev, dtype)


def save_dumped_pickle(params: ManoParams, path: PathLike) -> None:
    """Write the reference's dumped-pickle format for interop: the same
    nine keys the reference reads, including the ``parents[0] = None``
    sentinel."""
    out = {theirs: as_numpy(getattr(params, ours))
           for theirs, ours in _PICKLE_KEYS.items()}
    out["parents"] = [None] + [int(p) for p in params.parents[1:]]
    with open(path, "wb") as f:
        pickle.dump(out, f)


def load_model(path: PathLike, side: str | None = None, device=None,
               dtype=torch.float64) -> ManoParams:
    """Load an asset of any supported format, sniffed by extension and
    content, onto ``device`` (default ``cuda``; pass ``device="cpu"``
    explicitly for the CPU) in ``dtype``."""
    dev = resolve_device(device)
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as z:
            raw = _smplx_arrays(z) if _is_smplx(z, pickled=False) else None
        if raw is not None:
            return _smplx_params(raw, p.name, side, dev, dtype)
        return load_npz(p, side=side, device=dev, dtype=dtype)
    # Every pickle flavour ends in .pkl; sniff by content: reference-style
    # dumped keys, then official MANO (has the hand-PCA keys), then
    # SMPL-X (per-hand PCA keys), then an SMPL-family body (same
    # container, no hand PCA).
    try:
        return load_dumped_pickle(p, side=side, device=dev, dtype=dtype)
    except (KeyError, UnicodeDecodeError):
        pass
    raw = _read_latin1(p)
    try:
        return _official_params(raw, p, side, dev, dtype)
    except KeyError as e:
        # Fall through to the body loader ONLY when what is missing is the
        # hand-PCA pair: any other missing key is a corrupt official
        # pickle that must fail loudly, not load as a fabricated body.
        if e.args and e.args[0] not in ("hands_components", "hands_mean"):
            raise
        if _is_smplx(raw, pickled=True):
            return _smplx_params(_smplx_arrays(raw), p.name, side, dev,
                                 dtype)
        loaded = _smpl_params(raw, side, dev, dtype)
        if loaded.n_joints == C.N_JOINTS:
            # A 16-joint asset without the hand-PCA keys is a broken MANO
            # file, not a body model: an identity PCA would silently
            # replace the real MANO pose space.
            raise KeyError(
                "hands_components/hands_mean missing from a 16-joint "
                "asset — corrupt MANO pickle? Use load_smpl_pickle "
                "explicitly to load it as a PCA-less body."
            ) from e
        return loaded
