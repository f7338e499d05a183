"""One rank of the port's parallel tests (``tests/test_torch_parallel.py``).

Run as ``python tests/torch_parallel_ranks.py RANK WORLD STORE INPUTS OUT``
in WORLD processes at once: they join a gloo group over the ``FileStore``
at STORE, run every case of the port's ``parallel`` package on CPU
tensors with the inputs in the ``.npz`` at INPUTS, and write what they
saw to OUT (rank 0 the gathered arrays, every rank its own facts). The
process imports no JAX: it records whether any JAX module was loaded.
"""

import json
import os
import sys

import numpy as np


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _comm_counts(fn):
    from torch.distributed.tensor.debug import CommDebugMode

    mode = CommDebugMode()
    with mode:
        out = fn()
    return out, {str(k).split("'")[1] if "'" in str(k) else str(k): v
                 for k, v in mode.get_comm_counts().items()}


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_path, inputs_path, out_dir = sys.argv[3:6]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from mano_hand_tpu_torch import parallel
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.fitting import solvers
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.parallel import multihost
    from mano_hand_tpu_torch.parallel import sharding as shd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    inp = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    params = synthetic_params(seed=0, dtype=torch.float32, device="cpu")
    arrays, facts = {}, {"rank": rank}

    # Meshes: shapes, the whole group on data, JAX's errors.
    mesh = parallel.make_mesh(data=2, model=2)
    facts["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    facts["mesh_all_data"] = list(parallel.make_mesh().shape)
    facts["mesh_error_model3"] = _error(lambda: parallel.make_mesh(model=3))
    facts["mesh_error_3x2"] = _error(
        lambda: parallel.make_mesh(data=3, model=2))
    facts["mesh_coords"] = [mesh.get_local_rank("data"),
                            mesh.get_local_rank("model")]

    # The tensor-parallel layout at model=2: no padding, true V kept.
    sp = shd.shard_params(params, mesh)
    facts["layout"] = {
        "n_verts": sp.n_verts,
        "v_template": list(sp.params.v_template.shape),
        "local_v_template": list(sp.params.v_template.to_local().shape),
        "local_j_regressor": list(sp.params.j_regressor.to_local().shape),
        "placements_match": all(
            tuple(getattr(sp.params, k).placements) == tuple(v)
            for k, v in shd.PARAM_SPECS.items()),
    }

    def gather(name, dt):
        facts[name + "_placements"] = [repr(p) for p in dt.placements]
        full = dt.full_tensor()
        if rank == 0:
            arrays[name] = full.numpy()

    gather("gspmd_2x2", shd.gspmd_forward(sp, mesh, n_verts=778)(
        inp["pose_a"], inp["beta_a"]))
    out, facts["smap_2x2_comms"] = _comm_counts(
        lambda: shd.shard_map_forward(sp, mesh, n_verts=778)(
            inp["pose_b"], inp["beta_b"]))
    gather("smap_2x2", out)
    for full in (False, True):
        name = "dp_full_2x2" if full else "dp_2x2"
        out, facts[name + "_comms"] = _comm_counts(
            lambda: shd.pallas_forward_dp(params, mesh, block_b=2,
                                          full=full)(
                inp["pose_c"], inp["beta_c"]))
        facts[name + "_local_rows"] = out.to_local().shape[0]
        gather(name, out)

    # The sharded fit step: 50 Adam steps from rest towards the targets.
    targets = core.forward_batched(params, inp["pose_fit"],
                                   inp["beta_fit"]).verts
    opt = solvers.adam(0.05)
    step = parallel.make_fit_step(sp, mesh, opt, n_verts=778)
    state = parallel.init_state(params, batch=8, optimizer=opt, mesh=mesh)
    losses = []
    for _ in range(50):
        state, loss = step(state, targets)
        losses.append(float(loss))
    arrays["fit_2x2"] = np.array(losses)

    # model=4 pads V to 780; every output still has the true 778.
    mesh4 = parallel.make_mesh(data=1, model=4)
    sp4 = shd.shard_params(params, mesh4)
    facts["layout4"] = {
        "n_verts": sp4.n_verts,
        "v_template": list(sp4.params.v_template.shape),
        "local_v_template": list(sp4.params.v_template.to_local().shape),
    }
    gather("gspmd_1x4", shd.gspmd_forward(sp4, mesh4)(
        inp["pose_d"], inp["beta_d"]))
    out, facts["smap_1x4_comms"] = _comm_counts(
        lambda: shd.shard_map_forward(sp4, mesh4)(
            inp["pose_d"], inp["beta_d"]))
    facts["smap_1x4_local"] = list(out.to_local().shape)
    gather("smap_1x4", out)
    gather("dp_1x4", shd.pallas_forward_dp(sp4, mesh4, block_b=2)(
        inp["pose_e"], inp["beta_e"]))
    gather("dp_full_1x4", shd.pallas_forward_dp(sp4, mesh4, block_b=2,
                                                full=True)(
        inp["pose_e"], inp["beta_e"]))
    step4 = parallel.make_fit_step(sp4, mesh4, opt)
    state4 = parallel.init_state(sp4, batch=8, optimizer=opt, mesh=mesh4)
    state4, loss4 = step4(state4, targets)
    facts["fit_1x4_loss"] = float(loss4)

    # JAX's two sharded fits (tests/torch_sharded_fits.py): over 'data'
    # of 4 (JAX's split) and of 2 with the model dim replicated.
    from torch_sharded_fits import cases

    for shape in ((4, 1), (2, 2)):
        fits = cases(parallel.make_mesh(*shape), torch.device("cpu"),
                     gather=True)
        if rank == 0:
            tag = "fits_{}x{}_".format(*shape)
            arrays.update({tag + k: v for k, v in fits.items()
                           if not k.endswith(("_placements", "_error"))})
        facts["fits_{}x{}_placements".format(*shape)] = {
            k[:-len("_placements")]: [str(p) for p in v]
            for k, v in fits.items() if k.endswith("_placements")}
        facts["fits_{}x{}_errors".format(*shape)] = {
            k[len("uneven_"):-len("_error")]: str(v)
            for k, v in fits.items() if k.endswith("_error")}

    # The multi-process helpers over the same four ranks.
    facts["initialize"] = multihost.initialize()
    gm = multihost.global_mesh(model=2)
    facts["global_mesh"] = dict(zip(gm.mesh_dim_names, gm.shape))
    sl = multihost.process_local_slice(16, gm)
    facts["slice"] = [sl.start, sl.stop]
    facts["slice_error"] = _error(
        lambda: multihost.process_local_slice(7, gm))
    facts["global_mesh_error_model3"] = _error(
        lambda: multihost.global_mesh(model=3))
    facts["global_mesh_error_3x2"] = _error(
        lambda: multihost.global_mesh(data=3, model=2))
    full = np.arange(16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3) / 1e3
    arr = multihost.global_batch_array(full[sl], gm)
    facts["global_batch_shape"] = list(arr.shape)
    facts["global_batch_total"] = float(arr.sum().full_tensor())
    facts["global_batch_expect"] = float(full.sum(dtype=np.float64))
    verts = shd.gspmd_forward(shd.shard_params(params, gm), gm, n_verts=778)(
        arr, torch.zeros((16, 10)))
    want = core.forward_batched(params, torch.from_numpy(full),
                                torch.zeros((16, 10))).verts
    facts["global_batch_forward_err"] = float(
        (verts.full_tensor() - want).abs().max())

    facts["jax_loaded"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "mano_hand_tpu"))
    if rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
