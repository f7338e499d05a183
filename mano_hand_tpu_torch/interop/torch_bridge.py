"""The torch-facing API for users of torch MANO stacks (manopth, smplx).

The port's counterpart of the JAX package's ``interop/torch_bridge.py``
(the name is kept so the two are easy to pair). There the bridge carried
torch tensors into JAX and back; here the model is torch already, so it is
native:

* ``params_from_torch`` builds ``ManoParams`` from a dict of tensors or
  arrays under this package's names or the smplx/manopth aliases;
* ``forward_from_torch`` evaluates the core on torch inputs;
* ``TorchManoLayer`` (and ``make_torch_layer``) is a real
  ``torch.nn.Module``: ``forward(pose, shape=None, trans=None)`` returns
  ``(verts, joints)`` with ``trans`` added to both, and its gradients
  come from torch autograd through the plain ``core.forward_batched`` /
  ``core.forward_batched_rotmats``, as the JAX layer's come from
  ``jax.vjp`` through its plain core.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mano_hand_tpu_torch.assets.convert import params_from_numpy
from mano_hand_tpu_torch.assets.schema import ManoParams
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops.common import resolve_device
from mano_hand_tpu_torch.utils.arrays import as_numpy


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # scipy sparse (an official J_regressor)
        return np.asarray(x.toarray())
    return as_numpy(x)


def to_torch(tree: Any):
    """NumPy array, NamedTuple (e.g. ``ManoOutput``), dataclass (as a
    dict), list/tuple or dict of them -> the same tree with CPU tensor
    leaves (sharing memory with writeable contiguous arrays). Tensors pass
    through unchanged."""
    if torch.is_tensor(tree):
        return tree
    if hasattr(tree, "_asdict"):  # NamedTuple
        return type(tree)(*(to_torch(v) for v in tree))
    if dataclasses.is_dataclass(tree):
        return {f.name: to_torch(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (str, type(None), int, float)):
        return tree
    arr = np.ascontiguousarray(np.asarray(tree))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def params_from_torch(tensors: dict, side: str = "right",
                      dtype=torch.float32, device=None) -> ManoParams:
    """Build validated ``ManoParams`` on ``device`` (default ``cuda``) from
    a dict of tensors / arrays.

    Accepts this package's key names and the common torch-stack aliases
    (smplx/manopth naming): v_template, shapedirs -> shape_basis,
    posedirs -> pose_basis ([V, 3, P] or the transposed [P, V*3]),
    J_regressor -> j_regressor (dense or scipy sparse), lbs_weights /
    weights, faces / f, parents (or kintree_table's parent row; a root of
    None, -1 or uint32(-1)), hands_components / hands_mean -> the PCA
    basis / mean (an identity basis and zero mean when absent).
    """
    dev = resolve_device(device)
    t = {k: _to_np(v) for k, v in tensors.items()}

    def pick(*names):
        for n in names:
            if n in t:
                return t[n]
        return None

    required = {
        "v_template": ("v_template", "mesh_template"),
        "shape_basis": ("shape_basis", "shapedirs", "mesh_shape_basis"),
        "pose_basis": ("pose_basis", "posedirs", "mesh_pose_basis"),
        "j_regressor": ("j_regressor", "J_regressor"),
        "lbs_weights": ("lbs_weights", "weights", "skinning_weights"),
        "faces": ("faces", "f"),
        "parents": ("parents", "kintree_table"),
    }
    missing = [canonical for canonical, aliases in required.items()
               if pick(*aliases) is None]
    if missing:
        raise ValueError(
            f"params dict is missing required keys: {missing} "
            f"(accepted aliases: "
            f"{ {k: v for k, v in required.items() if k in missing} })")

    v_template = pick("v_template", "mesh_template")
    n_verts = v_template.shape[0]
    pose_basis = pick("pose_basis", "posedirs", "mesh_pose_basis")
    if pose_basis.ndim == 2:
        # torch-stack layout: [P, V*3] (flattened, transposed)
        pose_basis = pose_basis.T.reshape(n_verts, 3, -1)
    parents = pick("parents")
    if parents is None:
        parents = t["kintree_table"][0]
    # Root encodings seen in the wild: None, -1, or uint32(-1).
    parents = tuple(
        -1 if (p is None or int(p) < 0 or int(p) >= 2**31 - 1) else int(p)
        for p in np.asarray(parents, dtype=object).reshape(-1))
    j_regressor = pick("j_regressor", "J_regressor")
    # The PCA space covers the articulated joints' axis-angles: 3 (J - 1).
    pca_basis = pick("pca_basis", "hands_components", "pose_pca_basis")
    if pca_basis is None:
        pca_basis = np.eye(3 * (j_regressor.shape[0] - 1))
    pca_mean = pick("pca_mean", "hands_mean", "pose_pca_mean")
    if pca_mean is None:
        pca_mean = np.zeros(pca_basis.shape[1])
    return params_from_numpy(dict(
        v_template=v_template,
        shape_basis=pick("shape_basis", "shapedirs", "mesh_shape_basis"),
        pose_basis=pose_basis,
        j_regressor=j_regressor,
        lbs_weights=pick("lbs_weights", "weights", "skinning_weights"),
        pca_basis=pca_basis,
        pca_mean=pca_mean,
        faces=pick("faces", "f"),
        parents=parents,
        side=side,
    ), device=dev, dtype=dtype)


def _is_batched(pose: torch.Tensor, pose2rot: bool) -> bool:
    if pose2rot:   # [B, J, 3] or [B, J*3] (unbatched: [J, 3] or [J*3])
        return pose.dim() == 3 or (pose.dim() == 2 and pose.shape[-1] != 3)
    return pose.dim() == 4   # [B, J, 3, 3] (unbatched: [J, 3, 3])


class TorchManoLayer(torch.nn.Module):
    """Differentiable MANO layer (the training tier): a drop-in
    ``nn.Module`` for the manopth/smplx layers.

    ``forward(pose, shape=None, trans=None) -> (verts, joints)``: pose is
    unbatched ([J, 3] / [J*3]) or batched ([B, J, 3] / [B, J*3]); with
    ``pose2rot=False`` it is rotation matrices ([B?, J, 3, 3], the smplx
    contract). ``trans`` is a global translation added to the vertices
    and to the posed joints. Inputs move to the layer's device and dtype
    (``device`` default ``cuda``, ``dtype`` default float32); gradients
    reach pose, shape and trans through torch autograd over the plain
    core (the port's f32 contractions pinned to IEEE fp32 in the forward
    and the backward).
    """

    def __init__(self, params: ManoParams, pose2rot: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.params = params.to(resolve_device(device)).astype(dtype)
        self.pose2rot = pose2rot

    def forward(self, pose, shape=None, trans=None):
        p = self.params
        dev, dtype = p.device, p.dtype
        pose = torch.as_tensor(pose, device=dev).to(dtype)
        batched = _is_batched(pose, self.pose2rot)
        lead = (pose.shape[0],) if batched else (1,)
        row = (p.n_joints, 3) if self.pose2rot else (p.n_joints, 3, 3)
        pose_b = pose.reshape(*lead, *row)
        if shape is None:
            shape_b = torch.zeros((*lead, p.n_shape), dtype=dtype,
                                  device=dev)
        else:
            shape_b = torch.as_tensor(shape, device=dev).to(dtype).reshape(
                *lead, p.n_shape)
        if trans is None:
            trans_b = torch.zeros((*lead, 3), dtype=dtype, device=dev)
        else:
            trans_b = torch.as_tensor(trans, device=dev).to(dtype).reshape(
                *lead, 3)
        if self.pose2rot:
            out = core.forward_batched(p, pose_b, shape_b)
        else:
            out = core.forward_batched_rotmats(p, pose_b, shape_b)
        verts = out.verts + trans_b[:, None, :]
        joints = out.posed_joints + trans_b[:, None, :]
        if not batched:
            return verts[0], joints[0]
        return verts, joints


def make_torch_layer(params: ManoParams, pose2rot: bool = True,
                     device=None, dtype=torch.float32) -> TorchManoLayer:
    """``layer(pose, shape=None, trans=None) -> (verts, joints)``: a
    ``TorchManoLayer`` (the JAX package's factory name)."""
    return TorchManoLayer(params, pose2rot, device=device, dtype=dtype)


def forward_from_torch(params: ManoParams, pose,
                       shape: Optional[Any] = None,
                       pose2rot: bool = True) -> core.ManoOutput:
    """Evaluate the core on torch inputs (the inference tier): a
    ``ManoOutput`` of tensors on ``params``' device.

    pose is unbatched or batched axis-angle, or with ``pose2rot=False``
    per-joint rotation matrices (the smplx keyword; rotation-space
    pipelines skip Rodrigues); shape [B?, S] (zeros when None).
    """
    dev, dtype = params.device, params.dtype
    pose = torch.as_tensor(pose, device=dev).to(dtype)
    batched = _is_batched(pose, pose2rot)
    lead = (pose.shape[0],) if batched else ()
    row = (params.n_joints, 3) if pose2rot else (params.n_joints, 3, 3)
    pose = pose.reshape(*lead, *row)
    if shape is None:
        shape = torch.zeros((*lead, params.n_shape), dtype=dtype, device=dev)
    else:
        shape = torch.as_tensor(shape, device=dev).to(dtype)
    if pose2rot:
        fwd = core.forward_batched if batched else core.forward
    else:
        fwd = core.forward_batched_rotmats if batched else core.forward_rotmats
    return fwd(params, pose, shape)
