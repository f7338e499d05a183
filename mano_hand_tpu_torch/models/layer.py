"""Stateful MANOModel wrapper: the reference's ergonomics over the core.

The port of the JAX package's ``models/layer.py``. It keeps the
reference API and its quirks:

  * ``set_params(pose_abs | pose_pca, shape, global_rot)`` mutates state
    and returns a copy of the vertices;
  * ``global_rot`` is honoured **only** in the PCA branch, and persists
    across calls (``self.rot`` is stateful);
  * a freshly constructed model already holds the rest-pose mesh
    (``update()`` runs in ``__init__``);
  * exposed attributes: ``verts``, ``rest_verts``, ``J``, ``R``,
    ``posed_J`` (float64 NumPy) and ``faces``.

The backend flag (``np`` | ``torch``) selects the float64 NumPy oracle
(``models/oracle.py``) or the PyTorch core on the model's device (default
``cuda``; ``device="cpu"`` explicitly for the CPU) in ``dtype`` (default
float32). The float64 master copy of the asset stays on the host, and the
``np`` backend touches no device: the device copy is made at the first
``torch`` evaluation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from mano_hand_tpu_torch import constants
from mano_hand_tpu_torch.assets.loader import load_model
from mano_hand_tpu_torch.assets.schema import ManoParams
from mano_hand_tpu_torch.io.obj import export_obj_pair
from mano_hand_tpu_torch.io.ply import export_ply, vertex_normals_np
from mano_hand_tpu_torch.models import core, oracle
from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.utils.arrays import as_numpy
from mano_hand_tpu_torch.utils.profiling import ServingCounters

BACKENDS = ("np", "torch")

__all__ = ["BACKENDS", "MANOModel"]


def _ndim(x) -> int:
    return x.dim() if torch.is_tensor(x) else np.ndim(x)


class MANOModel:
    """Drop-in replacement for the reference's MANOModel class."""

    def __init__(
        self,
        model: Union[str, Path, ManoParams],
        backend: str = "torch",
        device=None,
        dtype=torch.float32,
    ):
        if isinstance(model, (str, Path)):
            model = load_model(model, device="cpu")
        # The float64 host master (the oracle's input).
        self._params_np = model.to("cpu").astype(torch.float64)
        self._device = device
        self._dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self._params_dev_cache = None  # built at the first torch evaluation
        self._bucket_fns = {}  # bucket -> callable (forward_bucketed)
        self.serving_counters = None  # built with the first bucketed call
        # (betas bytes, core.ShapedHand): the one-entry specialisation
        # cache. set_params holds betas fixed across per-frame pose
        # updates, so the torch path re-runs only the pose stage then.
        self._shaped_cache = None
        self.backend = self._check_backend(backend)

        self.n_joints = self._params_np.n_joints
        self.n_shape_params = self._params_np.n_shape
        self.faces = as_numpy(self._params_np.faces)
        self.side = self._params_np.side

        # Reference state layout.
        self.pose = np.zeros((self.n_joints, 3))
        self.shape = np.zeros(self.n_shape_params)
        self.rot = np.zeros((1, 3))
        self.verts = None
        self.rest_verts = None
        self.J = None
        self.R = None
        self.posed_J = None

        self.update()

    @staticmethod
    def _check_backend(backend: str) -> str:
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        return backend

    @property
    def params(self) -> ManoParams:
        """The float64 host parameter set (the asset's master copy)."""
        return self._params_np

    @property
    def device(self) -> torch.device:
        """The device of the torch backend (``cuda`` unless the model was
        built with another one; raises without CUDA)."""
        return resolve_device(self._device)

    @property
    def _params_dev(self) -> ManoParams:
        if self._params_dev_cache is None:
            self._params_dev_cache = self._params_np.to(
                self.device).astype(self._dtype)
        return self._params_dev_cache

    def specialize(self, shape=None) -> "core.ShapedHand":
        """Bake betas into a ``core.ShapedHand``, cached per betas value.

        The wrapper holds ONE subject, so one live entry suffices: a
        repeat call with the same betas (every ``set_params`` that only
        moves the pose) returns the cached bake and the forward pays only
        the pose stage; a betas change replaces the entry. torch backend
        only.
        """
        shape = (np.zeros(self.n_shape_params, self._np_dtype)
                 if shape is None else as_numpy(shape, self._np_dtype))
        key = shape.tobytes()
        if self._shaped_cache is None or self._shaped_cache[0] != key:
            params = self._params_dev
            self._shaped_cache = (key, core.specialize(
                params, torch.from_numpy(shape).to(params.device)))
        return self._shaped_cache[1]

    # ------------------------------------------------------------ reference API
    def set_params(self, pose_abs=None, pose_pca=None, shape=None,
                   global_rot=None) -> np.ndarray:
        """Reference semantics, including the quirk that global_rot only
        takes effect through the PCA branch and persists."""
        if pose_abs is not None:
            self.pose = as_numpy(pose_abs, np.float64)
        if pose_pca is not None:
            if global_rot is not None:
                self.rot = as_numpy(global_rot, np.float64).reshape(1, 3)
            fingers = oracle.decode_pca_pose(self._params_np, pose_pca)[1:]
            self.pose = np.concatenate([self.rot, fingers], axis=0)
        if shape is not None:
            self.shape = as_numpy(shape, np.float64)
        self.update()
        return self.verts.copy()

    def update(self) -> None:
        """Recompute verts/J/R/rest_verts/posed_J from the current state
        through the selected backend."""
        out = self._evaluate(self.pose, self.shape, self.backend)
        self.verts = as_numpy(out.verts, np.float64)
        self.rest_verts = as_numpy(out.rest_verts, np.float64)
        self.J = as_numpy(out.joints, np.float64)
        self.R = as_numpy(out.rot_mats, np.float64)
        self.posed_J = as_numpy(out.posed_joints, np.float64)

    def export_obj(self, path: Union[str, Path]) -> None:
        """Write the posed + rest-pose OBJ pair (reference parity)."""
        export_obj_pair(self.verts, self.rest_verts, self.faces, path)

    def export_ply(self, path: Union[str, Path], with_normals: bool = True,
                   binary: bool = True) -> None:
        """Write the posed mesh as PLY (binary by default). Normals are the
        area-weighted vertex normals of the current pose, computed in
        NumPy, so the np backend touches no device here either."""
        normals = (vertex_normals_np(self.verts, self.faces)
                   if with_normals else None)
        export_ply(self.verts, self.faces, path, normals=normals,
                   binary=binary)

    def fit(self, target, solver: str = "adam",
            deadline_s: Optional[float] = None, retries: int = 0,
            **solver_kw):
        """Recover pose/shape from a target and ADOPT the solution.

        The stateful counterpart of ``fitting.fit``/``fitting.fit_lm`` on
        the torch backend's device: one call fits a SINGLE problem (the
        wrapper holds one hand), writes the recovered pose and shape into
        the float64 host state, runs ``update()`` and returns the solver
        result. Any data term and option passes through ``solver_kw``.
        ``fit_trans`` is refused: the wrapper, like the reference, keeps
        the hand origin-centred and has no translation state.

        ``deadline_s``/``retries`` run the solve under
        ``runtime.supervise.supervised_call``, the device work inside the
        supervised window: on a failure the model's state stays as it
        was. Deterministic solver errors (bad shapes, bad options) are
        never retried.
        """
        from mano_hand_tpu_torch import fitting
        from mano_hand_tpu_torch.runtime.supervise import supervised_call

        if solver not in ("adam", "lm"):
            raise ValueError(f"solver must be 'adam' or 'lm', got {solver!r}")
        if solver_kw.get("fit_trans"):
            raise ValueError(
                "MANOModel.fit has no translation state (the wrapper is "
                "origin-centered like the reference); use fitting.fit("
                "..., fit_trans=True) directly"
            )
        # An explicit fit_trans=False means "off": drop it.
        solver_kw.pop("fit_trans", None)
        fn = fitting.fit if solver == "adam" else fitting.fit_lm
        params = self._params_dev

        def solve():
            res = fn(params, target, **solver_kw)
            if res.pose.is_cuda:
                torch.cuda.synchronize(res.pose.device)
            return res

        if deadline_s is not None or retries:
            res = supervised_call(solve, deadline_s=deadline_s,
                                  retries=retries, name=f"model-fit-{solver}")
        else:
            res = fn(params, target, **solver_kw)
        if res.pose.dim() != 2:
            raise ValueError(
                "MANOModel.fit adopts ONE solution; batched targets "
                f"produced pose shape {tuple(res.pose.shape)} — use "
                "fitting.fit for batches"
            )
        self.pose = as_numpy(res.pose, np.float64)
        self.shape = as_numpy(res.shape, np.float64)
        self.update()
        return res

    def keypoints(self, tip_vertex_ids=None, order: str = "mano"):
        """Current-state keypoints [16(+T), 3] (float64 NumPy): the posed
        skeleton joints, optionally extended with fingertip vertex picks
        (``"smplx"``/``"manopth"`` or explicit vertex ids) and re-ordered
        to the OpenPose/FreiHAND convention (see ``core.keypoints``).
        Pure NumPy, so the np backend touches no device."""
        tips = core.resolve_tip_ids(tip_vertex_ids, self.verts.shape[0])
        kp = self.posed_J
        if tips is not None:
            kp = np.concatenate([kp, self.verts[list(tips)]], axis=0)
        if order == "openpose":
            if kp.shape[0] != len(constants.MANO21_TO_OPENPOSE):
                raise ValueError(
                    "order='openpose' needs the 21-keypoint set (16 "
                    f"joints + 5 tips), got {kp.shape[0]} keypoints")
            kp = kp[list(constants.MANO21_TO_OPENPOSE)]
        elif order != "mano":
            raise ValueError(
                f"order must be 'mano' or 'openpose', got {order!r}")
        return kp.copy()

    # ------------------------------------------------------------ functional API
    def __call__(self, pose=None, shape=None, pose_pca=None, global_rot=None,
                 backend: Optional[str] = None) -> np.ndarray:
        """Stateless evaluation: verts for the given pose/shape, as NumPy.

        ``backend`` selects ``np`` (float64 oracle) or ``torch`` (the core
        on the model's device) per call. Accepts an absolute pose
        [.., J, 3] or PCA coefficients [.., n <= (J-1)*3]; leading batch
        dimensions go to ``core.forward_batched`` (the np backend is
        unbatched, like the reference).
        """
        backend = self._check_backend(backend or self.backend)
        if (pose is None) == (pose_pca is None):
            if pose is None:
                pose = np.zeros((self.n_joints, 3))
            else:
                raise ValueError("pass exactly one of pose / pose_pca")
        if global_rot is not None and pose_pca is None:
            # An absolute pose carries the root rotation in row 0; silently
            # ignoring global_rot would return an un-rotated mesh.
            raise ValueError(
                "global_rot is only meaningful with pose_pca; with an "
                "absolute pose, put the root rotation in pose[..., 0, :]")
        if pose_pca is not None and backend == "np" and _ndim(pose_pca) > 1:
            raise ValueError(
                "np backend is unbatched (like the reference); "
                "use backend='torch' for batched evaluation")
        if pose_pca is not None:
            if backend == "np":
                pose = oracle.decode_pca_pose(self._params_np, pose_pca,
                                              global_rot)
            else:
                pose = core.decode_pca(self._params_dev, pose_pca,
                                       global_rot)
        if shape is None:
            shape = np.zeros((*tuple(pose.shape)[:-2], self.n_shape_params)
                             if torch.is_tensor(pose)
                             else (*np.shape(pose)[:-2], self.n_shape_params))
        return as_numpy(self._evaluate(pose, shape, backend).verts)

    def forward_bucketed(self, pose, shape=None, *, min_bucket: int = 1,
                         max_bucket: int = 1024) -> np.ndarray:
        """Bucket-aware batched forward: verts [n, V, 3] for ANY n >= 1.

        The batch is padded to the nearest power-of-two bucket
        (``serving/buckets.py``: pad rows repeat row 0), runs
        ``core.forward_batched`` on the model's device through a
        per-bucket callable held on this instance, and the pad rows are
        sliced back off. ``serving_counters`` counts one ``compiles`` the
        first time a bucket's callable is built and one dispatch per
        call. Pad rows are independent rows of the batch, so the result
        equals the direct ``__call__`` torch path to float32 rounding:
        it is held to a tolerance, not to bit identity (a different batch
        size may take another summation order).
        """
        if self.serving_counters is None:
            self.serving_counters = ServingCounters()
        pose = as_numpy(pose, self._np_dtype)
        if pose.ndim != 3 or pose.shape[1:] != (self.n_joints, 3):
            raise ValueError(
                f"forward_bucketed pose must be [n, {self.n_joints}, 3], "
                f"got {pose.shape} (single poses: use __call__)")
        n = pose.shape[0]
        if shape is None:
            shape = np.zeros((n, self.n_shape_params), self._np_dtype)
        else:
            shape = as_numpy(shape, self._np_dtype)
            if shape.shape != (n, self.n_shape_params):
                raise ValueError(
                    f"forward_bucketed shape must be "
                    f"[{n}, {self.n_shape_params}], got {shape.shape}")
        sizes = bucket_mod.bucket_sizes(min_bucket, max_bucket)
        bucket = bucket_mod.bucket_for(n, sizes)
        fn = self._bucket_fns.get(bucket)
        if fn is None:
            fn = self._build_bucket_fn(bucket)
            self._bucket_fns[bucket] = fn
            self.serving_counters.count_compile()
        out = fn(bucket_mod.pad_rows(pose, bucket),
                 bucket_mod.pad_rows(shape, bucket))
        self.serving_counters.count_dispatch(bucket, n)
        return as_numpy(out)[:n]

    def _build_bucket_fn(self, bucket: int):
        params = self._params_dev
        dev = params.device

        def run(pose: np.ndarray, shape: np.ndarray) -> torch.Tensor:
            with torch.no_grad():
                return core.forward_batched(
                    params, torch.from_numpy(pose).to(dev),
                    torch.from_numpy(shape).to(dev)).verts

        return run

    def _evaluate(self, pose, shape, backend: str):
        if backend == "np":
            if _ndim(pose) > 2:
                raise ValueError(
                    "np backend is unbatched (like the reference); "
                    "use backend='torch' for batched evaluation")
            return oracle.forward(self._params_np, pose=pose, shape=shape)
        params = self._params_dev
        dtype, dev = params.dtype, params.device
        pose_t = torch.as_tensor(pose, device=dev).to(dtype)
        if pose_t.dim() > 2:
            shape_t = torch.as_tensor(shape, device=dev).to(dtype)
            lead = pose_t.shape[:-2]
            with torch.no_grad():
                out = core.forward_batched(
                    params, pose_t.reshape(-1, self.n_joints, 3),
                    shape_t.reshape(-1, self.n_shape_params))
            return core.ManoOutput(
                *(x.reshape(*lead, *x.shape[1:]) for x in out))
        # Single pose: through the specialisation cache (the dominant
        # wrapper pattern is pose-only updates on one subject). The cache
        # key hashes HOST betas; betas already on the device would cost a
        # blocking copy back per call, so they take the one-call forward.
        with torch.no_grad():
            if torch.is_tensor(shape):
                return core.forward(params, pose_t,
                                    shape.to(device=dev, dtype=dtype))
            return core.forward_posed(self.specialize(shape), pose_t)

