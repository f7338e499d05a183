"""JAX's two sharded fits (``tests/test_parallel.py``:
``test_mask_fit_batch_shards_over_data_axis`` and
``test_fit_sequence_frames_shard_over_data_axis``) on the port, at JAX's
sizes and seeds: a batch of mask fits sharded over the mesh's ``data``
dim, and a clip whose frames are sharded over it (with and without the
translation DOF); and beside them each fit given a target split other than by
DTensor's chunk rule, which every rank must refuse.

``cases(mesh, device)`` runs both on every rank of the group (the same
inputs on each), sharded and unsharded, and returns this rank's pieces
of the sharded results with the whole unsharded ones, each refusal's message (and, with
``gather=True``, the sharded results gathered whole: gloo gathers CPU
tensors only). The parallel tests call it from their rank processes
(``tests/torch_parallel_ranks.py``, four gloo ranks on the CPU); run as

    python tests/torch_sharded_fits.py RANK WORLD STORE OUT DEVICE

it is a rank of its own (gloo over the ``FileStore`` at STORE, a
WORLD x 1 mesh, tensors on DEVICE: the card tests put two ranks on
``cuda:0``), writing ``OUT/sharded_fits_rank<RANK>.npz``. It imports no
JAX.
"""

import os
import sys

import numpy as np

MASK_KW = dict(n_steps=12, lr=0.01, data_term="silhouette", sil_sigma=1.0,
               fit_trans=True, pose_prior_weight=1.0, shape_prior_weight=1.0)
SEQ_KW = dict(n_steps=40, lr=0.05, smooth_pose_weight=1e-3)
SEQ_FRAMES = 8   # divisible by the 4-way data axis


def mask_inputs():
    """The [4, 1, 3] mask shifts of JAX's mask test (z zeroed)."""
    rng = np.random.default_rng(7)
    shifts = rng.normal(scale=0.02, size=(4, 1, 3)).astype(np.float32)
    shifts[:, :, 2] = 0.0
    return shifts


def sequence_poses():
    """The [8, 16, 3] pose track of JAX's sequence test."""
    rng = np.random.default_rng(21)
    a = rng.normal(scale=0.25, size=(16, 3)).astype(np.float32)
    b = rng.normal(scale=0.25, size=(16, 3)).astype(np.float32)
    w = np.linspace(0, 1, SEQ_FRAMES, dtype=np.float32)[:, None, None]
    return (1 - w) * a + w * b


def _rows_dtensor(full, mesh):
    """``full`` (the same on every rank) as a DTensor split over the data
    dim: each rank wraps its own rows, no communication."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n, i = mesh.size(0), mesh.get_local_rank("data")
    local = torch.chunk(full, n)[i].contiguous()
    placements = (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _uneven_dtensor(full, mesh):
    """``full`` split over the data dim other than by the chunk rule: the
    first rank one row more, the last one row less."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n, i = mesh.size(0), mesh.get_local_rank("data")
    counts = [len(c) for c in torch.chunk(full, n)]
    counts[0], counts[-1] = counts[0] + 1, counts[-1] - 1
    start = sum(counts[:i])
    local = full[start:start + counts[i]].contiguous()
    placements = (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _refusal(fn, *args, **kw) -> str:
    """The ValueError's message of ``fn(*args, **kw)`` ('' if none)."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return ""


def cases(mesh, device, gather: bool = False) -> dict:
    """Both fits sharded over ``mesh``'s data dim and unsharded, on
    ``device``: numpy arrays, ``<case>_<leaf>`` (this rank's rows of a
    sharded leaf, the whole of a replicated one), ``<case>_<leaf>_full``
    (``gather``: the leaf gathered whole), ``<case>_<leaf>_local`` (the
    unsharded fit's leaf), the mask fit's ``mask_target``, and
    ``uneven_<fit>_error`` (the refusal of an uneven split)."""
    import torch

    from mano_hand_tpu_torch import fitting, viz
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.viz.silhouette import soft_silhouette

    out = {}

    def keep(case, res, leaves, sharded):
        for leaf in leaves:
            local = getattr(res, leaf)
            out[f"{case}_{leaf}_local"] = local.detach().cpu().numpy()
            got = getattr(sharded, leaf)
            out[f"{case}_{leaf}"] = got.to_local().detach().cpu().numpy()
            out[f"{case}_{leaf}_placements"] = np.array(
                [repr(p) for p in got.placements])
            if gather:
                out[f"{case}_{leaf}_full"] = (
                    got.full_tensor().detach().cpu().numpy())

    small = synthetic_params(seed=3, n_verts=48, n_faces=64,
                             dtype=torch.float32, device=device)
    cam = viz.WeakPerspectiveCamera(
        rot=torch.eye(3, device=device), scale=3.0)
    shifts = torch.as_tensor(mask_inputs(), device=device)
    base = core.forward(small).verts
    masks = (soft_silhouette(base[None] + shifts, small.faces, cam,
                             height=16, width=16, sigma=1.0) > 0.5
             ).to(torch.float32)                           # [4, H, W]
    out["mask_target"] = masks.cpu().numpy()
    res_local = fitting.fit(small, masks, camera=cam, **MASK_KW)
    res_sharded = fitting.fit(small, _rows_dtensor(masks, mesh), camera=cam,
                              **MASK_KW)
    keep("mask", res_local, ("pose", "shape", "trans", "loss_history"),
         res_sharded)
    out["uneven_fit_error"] = np.array(_refusal(
        fitting.fit, small, _uneven_dtensor(masks, mesh), camera=cam,
        **MASK_KW))

    params = synthetic_params(seed=0, dtype=torch.float32, device=device)
    targets = core.forward_batched(
        params, torch.as_tensor(sequence_poses(), device=device),
        torch.zeros((SEQ_FRAMES, 10), device=device)).verts
    seq_local = fitting.fit_sequence(params, targets, **SEQ_KW)
    seq_sharded = fitting.fit_sequence(params, _rows_dtensor(targets, mesh),
                                       **SEQ_KW)
    keep("seq", seq_local, ("pose", "shape", "loss_history", "final_loss"),
         seq_sharded)
    # With the translation DOF and the 6D pose (two coupled frame keys).
    kw6 = dict(SEQ_KW, fit_trans=True, pose_space="6d")
    seq6_local = fitting.fit_sequence(params, targets, **kw6)
    seq6_sharded = fitting.fit_sequence(
        params, _rows_dtensor(targets, mesh), **kw6)
    keep("seq6d", seq6_local, ("pose", "shape", "trans", "loss_history"),
         seq6_sharded)
    out["uneven_fit_sequence_error"] = np.array(_refusal(
        fitting.fit_sequence, params, _uneven_dtensor(targets, mesh),
        **SEQ_KW))
    return out


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_path, out_dir, device = sys.argv[3:6]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from mano_hand_tpu_torch import parallel

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = parallel.make_mesh(world, 1, devices=[device] * world)
    out = cases(mesh, torch.device(device))
    np.savez(os.path.join(out_dir, f"sharded_fits_rank{rank}.npz"), **out)
    dist.barrier()
    parallel.mesh.destroy_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
