"""Distributed fitting: a sharded optimization step over the 2-D mesh.

The port of the JAX package's ``parallel/fit.py``. Data parallelism: each
data row of the mesh carries its own rows of the batch of fitting
problems (per-sample parameters and per-sample Adam state, so no
gradient all-reduce over 'data' is needed). Tensor parallelism: the
model parameters keep the vertex-sharded layout of
``sharding.PARAM_SPECS``, so each forward's joint regression all-reduces
over 'model' (``sharding.shard_map_forward``'s per-rank program), and
the gradients flow back through that all-reduce. The per-sample
parameters are replicated over 'model': each rank's gradient covers its
vertex shard, and one all-reduce over 'model' sums them before the
update, so the ranks of a data row step alike.

The loss is the JAX package's ``objectives.vertex_l2`` over the GLOBAL
batch and the true vertices: each rank's sum of squared distances over
its rows and vertices, divided by the global count, summed over the
world.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mano_hand_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mano_hand_tpu_torch.parallel.sharding import (
    _BATCH, _local_rows, _local_sharded_params, _mesh_device,
    _per_rank_verts, _unwrap, _vertex_keep,
)


class FitState(NamedTuple):
    pose: torch.Tensor     # [b, J, 3]: this rank's rows of the batch
    shape: torch.Tensor    # [b, S]
    opt_state: Any         # the optimizer stepping (pose, shape)


def init_state(params, batch: int, optimizer: Callable,
               mesh: Optional[DeviceMesh] = None) -> FitState:
    """Zero pose and shape for this rank's rows of a global ``batch``
    (every row without a ``mesh``: one rank), and the optimizer over
    them. ``optimizer`` is a factory of a ``torch.optim.Optimizer`` over
    a list of tensors, such as ``fitting.solvers.adam(lr)`` (optax's Adam
    arithmetic, the counterpart of an ``optax.GradientTransformation``).
    """
    params, _ = _unwrap(params)
    rows = batch
    device = params.v_template.device
    if mesh is not None:
        n_data = mesh[DATA_AXIS].size()
        if batch % n_data:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"data axis ({n_data})")
        rows, device = batch // n_data, _mesh_device(mesh)
    dtype = params.v_template.dtype
    pose = torch.zeros((rows, params.n_joints, 3), dtype=dtype,
                       device=device, requires_grad=True)
    shape = torch.zeros((rows, params.n_shape), dtype=dtype, device=device,
                        requires_grad=True)
    return FitState(pose, shape, optimizer([pose, shape]))


def make_fit_step(
    params,
    mesh: DeviceMesh,
    optimizer: Callable,
    n_verts: Optional[int] = None,
):
    """Build the sharded step: (state, targets) -> (state, loss).

    ``targets`` is [B, V, 3]: a DTensor sharded over 'data', or the
    global batch as a plain tensor. ``params`` is a ShardedParams from
    ``sharding.shard_params`` (vertex-sharded over 'model', carrying the
    true V) or a plain ManoParams (sharded here). ``state`` comes from
    ``init_state(..., mesh=mesh)``; the step updates its tensors in place
    through ``state.opt_state`` (made by ``optimizer``) and returns the
    global loss as a 0-d tensor on the rank's device. ``optimizer`` is
    the factory ``init_state`` was given (JAX's signature): the state
    carries the optimizer made from it.
    """
    local, true_v = _local_sharded_params(params, mesh)
    n_verts = n_verts or true_v
    model_group = mesh.get_group(MODEL_AXIS)
    n_model = mesh[MODEL_AXIS].size()

    def step(state: FitState, targets):
        batch = targets.shape[0]
        tgt = _local_rows(targets, mesh, _BATCH)
        local_v = local.v_template.shape[0]
        start = mesh.get_local_rank(MODEL_AXIS) * local_v
        keep = _vertex_keep(mesh, local_v, n_verts)
        tgt = tgt[:, start:start + keep]
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            verts = _per_rank_verts(local, state.pose, state.shape,
                                    model_group)[:, :keep]
            loss = ((verts - tgt) ** 2).sum() / (batch * n_verts)
            loss.backward()
        if n_model > 1:
            grads = torch.cat([state.pose.grad.flatten(),
                               state.shape.grad.flatten()])
            dist.all_reduce(grads, group=model_group)
            n_pose = state.pose.numel()
            state.pose.grad.copy_(grads[:n_pose].view_as(state.pose))
            state.shape.grad.copy_(grads[n_pose:].view_as(state.shape))
        opt.step()
        total = loss.detach().clone()
        dist.all_reduce(total)
        return state, total

    step.bound_params = _unwrap(params)[0]
    return step
