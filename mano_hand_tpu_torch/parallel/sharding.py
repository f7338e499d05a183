"""Sharded MANO execution: the parameter layout and three forwards over a
('data', 'model') ``DeviceMesh`` (``parallel/mesh.py``).

The port of the JAX package's ``parallel/sharding.py``. Tensor-parallel
layout: the vertex dimension (V = 778) is the only axis with real
extent, so vertex-indexed tensors shard over the 'model' mesh dim while
joint-level state stays replicated (DTensor placements over (data,
model)):

    v_template  [V, 3]     -> (Replicate(), Shard(0))
    shape_basis [V, 3, S]  -> (Replicate(), Shard(0))
    pose_basis  [V, 3, P]  -> (Replicate(), Shard(0))
    lbs_weights [V, J]     -> (Replicate(), Shard(0))
    j_regressor [J, V]     -> (Replicate(), Shard(1))   (contraction dim)
    pca_basis/pca_mean/faces -> replicated

The joint regression J = Jreg . v_shaped contracts over the sharded V, so
each rank holds a partial sum: one all-reduce over 'model' makes the
joints (and the small FK that consumes them) replicated, and skinning
runs on the local vertex rows with no further communication. The batch
shards over 'data'.

Three forwards:

* ``gspmd_forward`` runs the port's plain forward (``core.forward_batched``)
  on DTensors: DTensor places the collectives, as XLA's partitioner does
  for JAX's ``jit`` with shardings.
* ``shard_map_forward`` is the explicit per-rank program with one
  hand-placed all-reduce (``torch.distributed.nn.functional.all_reduce``,
  which carries gradients, so ``parallel/fit.py`` differentiates through
  it).
* ``pallas_forward_dp`` runs the hand-written CUDA forward on every rank:
  K1 (``ops/fused_forward.py:forward_verts_fused_full``) with
  ``full=True``, the K4 route (``forward_verts_fused``) without, on the
  rank's rows of a batch sharded over both mesh dims. On CPU tensors the
  wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from mano_hand_tpu_torch import ops
from mano_hand_tpu_torch.assets.schema import ARRAY_FIELDS, ManoParams
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.ops import fused_forward
from mano_hand_tpu_torch.ops.common import cdiv, einsum
from mano_hand_tpu_torch.parallel.mesh import MODEL_AXIS

PARAM_SPECS = {
    "v_template": (Replicate(), Shard(0)),
    "shape_basis": (Replicate(), Shard(0)),
    "pose_basis": (Replicate(), Shard(0)),
    "j_regressor": (Replicate(), Shard(1)),
    "lbs_weights": (Replicate(), Shard(0)),
    "pca_basis": (Replicate(), Replicate()),
    "pca_mean": (Replicate(), Replicate()),
    "faces": (Replicate(), Replicate()),
}

# ``torch.distributed.nn.functional.all_reduce`` is the all-reduce that
# carries gradients (``dist.all_reduce`` does not, and the functional
# collectives' ``all_reduce`` has no autograd formula); newer torch marks
# it deprecated in favour of the latter.
warnings.filterwarnings(
    "ignore", message=r"torch\.distributed\.nn\.functional\.all_reduce is "
    r"deprecated", category=FutureWarning)

#: A batch over the data dim (replicated over 'model': each rank of a
#: data row holds the same rows), and a batch over both dims (every rank
#: its own rows, row-major over the ranks).
_BATCH = (Shard(0), Replicate())
_BATCH_ALL = (Shard(0), Shard(0))


def pad_verts(params: ManoParams, multiple: int) -> tuple[ManoParams, int]:
    """Zero-pad the vertex dimension to a multiple of the model-dim size.

    Padded rows are inert: zero template/basis rows and zero skinning
    weights contribute nothing to joints and produce zero vertices, which
    callers slice off. Returns (padded params, original V).
    """
    v = params.v_template.shape[0]
    pad = (-v) % multiple
    if pad == 0:
        return params, v

    def pad0(x):
        return F.pad(x, [0, 0] * (x.ndim - 1) + [0, pad])

    return dataclasses.replace(
        params,
        v_template=pad0(params.v_template),
        shape_basis=pad0(params.shape_basis),
        pose_basis=pad0(params.pose_basis),
        lbs_weights=pad0(params.lbs_weights),
        j_regressor=F.pad(params.j_regressor, [0, pad]),
    ), v


class ShardedParams(NamedTuple):
    """Mesh-placed (possibly vertex-padded) parameters + the true V.

    Padding must never leak: every consumer slices outputs back to
    ``n_verts``, so carrying the true count next to the padded tensors is
    the only way a default argument can be correct.
    """

    params: ManoParams
    n_verts: int


def _dtensor(local: torch.Tensor, mesh: DeviceMesh, placements,
             shape) -> DTensor:
    """This rank's ``local`` piece of a contiguous global tensor of
    ``shape`` under ``placements`` (no communication)."""
    shape = torch.Size(shape)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _local_chunk(full: torch.Tensor, mesh: DeviceMesh,
                 placements) -> torch.Tensor:
    """This rank's piece of ``full`` (the same tensor on every rank) under
    ``placements``, by DTensor's ``torch.chunk`` rule: no communication."""
    local = full
    for dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            n, i = mesh.size(dim), mesh.get_local_rank(dim)
            pieces = torch.chunk(local, n, dim=placement.dim)
            local = (pieces[i] if i < len(pieces)
                     else local.narrow(placement.dim, 0, 0))
    return local.contiguous()


def _place(full: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``full`` as a DTensor with ``placements``, each rank keeping its
    piece of its own copy (every rank holds the same values)."""
    full = full.to(_mesh_device(mesh)).contiguous()
    return _dtensor(_local_chunk(full, mesh, placements), mesh, placements,
                    full.shape)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_params(params: ManoParams, mesh: DeviceMesh) -> ShardedParams:
    """Place parameters on the mesh with the tensor-parallel layout.

    Pads V to the model-dim size if needed; the returned ShardedParams
    remembers the true V so forward/fit builders slice outputs correctly.
    """
    padded, n_verts = pad_verts(params, mesh[MODEL_AXIS].size())
    placed = dataclasses.replace(padded, **{
        name: _place(getattr(padded, name), mesh, spec)
        for name, spec in PARAM_SPECS.items()})
    return ShardedParams(placed, n_verts)


def _unwrap(params) -> tuple[ManoParams, int]:
    if isinstance(params, ShardedParams):
        return params.params, params.n_verts
    return params, params.v_template.shape[0]


def _local_params(params: ManoParams) -> ManoParams:
    """Each DTensor field's local piece (plain fields stay)."""
    return dataclasses.replace(params, **{
        f: getattr(params, f).to_local()
        for f in ARRAY_FIELDS if isinstance(getattr(params, f), DTensor)})


def _replicated_params(params: ManoParams, mesh: DeviceMesh) -> ManoParams:
    """Every field whole on this rank's device (a DTensor field is
    gathered once)."""
    dev = _mesh_device(mesh)
    return dataclasses.replace(params, **{
        f: (t.full_tensor() if isinstance(t, DTensor) else t).to(dev)
        for f in ARRAY_FIELDS for t in (getattr(params, f),)})


def _local_rows(x, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's rows of a batch: a DTensor is redistributed to
    ``placements`` (communication only where the layouts differ); a plain
    tensor is the global batch, the same on every rank, and is cut here.
    The batch must divide evenly."""
    parts = 1
    for dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            parts *= mesh.size(dim)
    if x.shape[0] % parts:
        raise ValueError(f"global batch {x.shape[0]} not divisible by the "
                         f"{parts} ranks it shards over")
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements).to_local()
    return _local_chunk(x.to(_mesh_device(mesh)), mesh, placements)


def _batch_dtensor(x, mesh: DeviceMesh) -> DTensor:
    if isinstance(x, DTensor):
        return x.redistribute(mesh, _BATCH)
    return _dtensor(_local_rows(x, mesh, _BATCH), mesh, _BATCH, x.shape)


def gspmd_forward(params, mesh: DeviceMesh, n_verts: Optional[int] = None):
    """Build a batched forward whose collectives DTensor places.

    ``params`` is a ShardedParams (from shard_params) or a plain
    ManoParams (replicated). Returns fn(pose [B, 16, 3], shape [B, S]) ->
    verts, a DTensor [B, n_verts, 3] with the batch sharded over 'data'
    and the vertices over 'model' (replicated over 'model' when
    ``n_verts`` does not divide it). ``pose`` and ``shape`` are DTensors
    or the global batch as plain tensors.

    The forward is ``core.forward_batched``'s fused path on DTensors: the
    blends, the joint regression and the skinning are DTensor ops, and
    DTensor places their collectives (the joints' partial sums become
    replicated by an all-reduce over 'model', as XLA's partitioner
    places JAX's psum). The kinematic chain (FK and the inverse bind)
    runs on each rank's replicated rows as plain tensors: its in-place
    level writes (``index_put_``) have no DTensor sharding rule in every
    torch this port runs on, and it is joint-level work every rank of a
    data row repeats anyway, as in JAX's partitioned program.
    """
    params, true_v = _unwrap(params)
    n_verts = n_verts or true_v
    # The true V may not divide the model dim (778 = 2 x 389); when
    # padding was applied, the sliced output cannot stay vertex-sharded.
    out = ((Shard(0), Shard(1)) if n_verts % mesh[MODEL_AXIS].size() == 0
           else _BATCH)
    v = params.v_template.shape[0]

    def replicated_rows(local, like: DTensor) -> DTensor:
        return _dtensor(local, mesh, _BATCH, (like.shape[0], *local.shape[1:]))

    def fwd(pose, shape):
        pose, shape = _batch_dtensor(pose, mesh), _batch_dtensor(shape, mesh)
        # Plain tensors the blends make on the way (the identity) join
        # the DTensors as replicated.
        with implicit_replication():
            rot = ops.rotation_matrix(pose.reshape(pose.shape[0], -1, 3))
            vertex_basis, joint_template, joint_shape_basis = \
                core.fused_blend_bases(params)
            eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
            coeff = torch.cat([shape, (rot[:, 1:] - eye).flatten(-3)], -1)
            v_posed = (params.v_template.reshape(-1) + einsum(
                "rk,bk->br", vertex_basis, coeff)).unflatten(-1, (v, 3))
            joints = joint_template + einsum("jcs,bs->bjc",
                                             joint_shape_basis, shape)
            joints_rows = joints.redistribute(mesh, _BATCH).to_local()
            world_rot, world_t = ops.forward_kinematics(
                params.parents, rot.to_local(), joints_rows)
            skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t,
                                                       joints_rows)
            verts = ops.skin(params.lbs_weights,
                             replicated_rows(skin_rot, pose),
                             replicated_rows(skin_t, pose), v_posed)
            return verts[:, :n_verts].redistribute(mesh, out)

    return fwd


def _per_rank_verts(local: ManoParams, pose: torch.Tensor,
                    shape: torch.Tensor, group) -> torch.Tensor:
    """The explicit per-rank forward over a local vertex shard: [b, V_local,
    3]. Its one collective sums the partial joints over ``group``."""
    v_shaped = ops.shape_blend(local.v_template, local.shape_basis, shape)
    partial = ops.regress_joints(local.j_regressor, v_shaped)
    joints = dist_fn.all_reduce(partial, group=group)
    rot = ops.rotation_matrix(pose)
    v_posed = ops.pose_blend(v_shaped, local.pose_basis, rot)
    world_rot, world_t = ops.forward_kinematics(local.parents, rot, joints)
    skin_rot, skin_t = ops.skinning_transforms(world_rot, world_t, joints)
    return ops.skin(local.lbs_weights, skin_rot, skin_t, v_posed)


def _vertex_keep(mesh: DeviceMesh, local_v: int, n_verts: int) -> int:
    """Rows of this rank's vertex shard that lie below ``n_verts``."""
    start = mesh.get_local_rank(MODEL_AXIS) * local_v
    return max(0, min(local_v, n_verts - start))


def _vertex_sharded(local: torch.Tensor, mesh: DeviceMesh, batch: int,
                    n_verts: int) -> DTensor:
    """Per-rank vertex shards [b, V_local, 3] (V_local rows a rank, V
    padded to the model dim) as the DTensor [batch, n_verts, 3] over
    (data, model)."""
    m, local_v = mesh[MODEL_AXIS].size(), local.shape[1]
    if cdiv(n_verts, m) == local_v:
        # DTensor's uneven split of n_verts is this one, cut at n_verts.
        keep = _vertex_keep(mesh, local_v, n_verts)
        return _dtensor(local[:, :keep].contiguous(), mesh,
                        (Shard(0), Shard(1)), (batch, n_verts, 3))
    full = _dtensor(local, mesh, (Shard(0), Shard(1)),
                    (batch, local_v * m, 3))
    return full[:, :n_verts]


def _local_sharded_params(params, mesh: DeviceMesh):
    if not isinstance(params, ShardedParams):
        params = shard_params(params, mesh)
    return _local_params(params.params), params.n_verts


def shard_map_forward(params, mesh: DeviceMesh,
                      n_verts: Optional[int] = None):
    """Explicit-collective forward: a per-rank program + one all-reduce.

    The only communication in the forward is the [b, J, 3] joint
    all-reduce over the 'model' dim (a few hundred bytes a row), after
    which FK runs replicated and skinning is vertex-parallel. Returns
    fn(pose, shape) -> DTensor [B, n_verts, 3] over (data, model);
    ``pose``/``shape`` as ``gspmd_forward``'s. A plain ManoParams is
    sharded first.
    """
    local, true_v = _local_sharded_params(params, mesh)
    n_verts = n_verts or true_v
    group = mesh.get_group(MODEL_AXIS)

    def fwd(pose, shape):
        b = pose.shape[0]
        verts = _per_rank_verts(local, _local_rows(pose, mesh, _BATCH),
                                _local_rows(shape, mesh, _BATCH), group)
        return _vertex_sharded(verts, mesh, b, n_verts)

    return fwd


def pallas_forward_dp(params, mesh: DeviceMesh,
                      block_b: Optional[int] = None, full: bool = False):
    """Data-parallel kernel forward: every rank runs the hand-written CUDA
    forward on its rows of the batch.

    Params are replicated (about 1.4 MB at MANO width, far below the point
    where the vertex sharding of ``shard_map_forward`` pays on the kernel
    path), so the per-rank program has no collective: the batch shards
    over BOTH mesh dims (rank-major), and the world size must divide it.
    ``full=True`` launches K1 (the whole forward in one kernel,
    ``ops/fused_forward.py:forward_verts_fused_full``) on each rank;
    ``full=False`` the K4 route (``forward_verts_fused``: the PyTorch
    pre-stage, then blend and skin in one kernel). A ShardedParams is
    gathered whole once, here, and the padding sliced off every output.

    Returns fn(pose, shape) -> DTensor [B, V, 3] (rows over both dims).
    ``block_b`` is accepted for JAX's signature and has no effect: the
    CUDA kernels choose their own row tile. On CPU tensors the kernel
    wrappers run their plain versions (JAX's ``interpret=``).
    """
    del block_b
    params, true_v = _unwrap(params)
    params = _replicated_params(params, mesh)
    kernel = (fused_forward.forward_verts_fused_full if full
              else fused_forward.forward_verts_fused)

    def fwd(pose, shape):
        b = pose.shape[0]
        verts = kernel(params, _local_rows(pose, mesh, _BATCH_ALL),
                       _local_rows(shape, mesh, _BATCH_ALL))
        if verts.shape[1] != true_v:
            verts = verts[:, :true_v].contiguous()
        return _dtensor(verts, mesh, _BATCH_ALL, (b, true_v, 3))

    return fwd

