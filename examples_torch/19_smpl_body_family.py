"""Body models on the same engine: SMPL-family asset -> batched forward
-> pose recovery -> OBJ export.

The compute core is topology-generic (level-parallel FK over any
topologically ordered tree, blendshapes by contraction), so a 24-joint
SMPL-scale body is just a bigger asset for the SAME programs the hand
runs — no body-specific code path exists anywhere:

1. write an official-style SMPL body pickle (the same chumpy-era
   container as MANO: sparse ``J_regressor``, ``kintree_table`` with a
   uint32 root sentinel, no hand-PCA keys) and load it with
   ``assets.load_smpl_pickle`` / ``load_model`` sniffing;
2. run the batched forward and check it against the f64 oracle;
3. recover a body pose from target vertices with the stock second-order
   solver (Gauss-Newton/LM with the analytic Jacobian) — the derivative
   assembly is as topology-generic as the forward;
4. export the posed body as OBJ (+ rest-pose twin, reference format).

With a real SMPL download the pickle-writing step disappears: point
``load_model`` at the official ``.pkl``. Everything here is synthetic
(schema-true random body) because model assets are license-gated.

    python examples_torch/19_smpl_body_family.py [--device cpu]
"""

import argparse
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_flag, example_device


def write_body_pickle(path) -> None:
    """An official-style SMPL body pickle (a stand-in for
    SMPL_NEUTRAL.pkl): the JAX example's synthetic body, seed 19."""
    import scipy.sparse as sp

    from mano_hand_tpu_torch.assets.synthetic import synthetic_arrays

    body = synthetic_arrays(seed=19, n_verts=437, n_joints=24, n_shape=16,
                            n_faces=870)
    raw = {
        "v_template": body["v_template"],
        "shapedirs": body["shape_basis"],
        "posedirs": body["pose_basis"],
        "J_regressor": sp.csc_matrix(body["j_regressor"]),
        "weights": body["lbs_weights"],
        "f": np.asarray(body["faces"], np.uint32),
        "kintree_table": np.stack([
            np.asarray([2**32 - 1] + list(body["parents"][1:]), np.uint32),
            np.arange(24, dtype=np.uint32),
        ]),
    }
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--out", default="body.obj")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    from mano_hand_tpu_torch.assets import load_model
    from mano_hand_tpu_torch.fitting import fit_lm
    from mano_hand_tpu_torch.io.obj import export_obj_pair
    from mano_hand_tpu_torch.models import core, oracle

    # 1. An official-style body pickle (stand-in for SMPL_NEUTRAL.pkl).
    write_body_pickle("SMPL_NEUTRAL.pkl")
    body64 = load_model("SMPL_NEUTRAL.pkl", device=dev)
    body = body64.astype(torch.float32)
    print(f"loaded body asset: V={body.n_verts} J={body.n_joints} "
          f"S={body.n_shape} side={body.side}")

    # 2. Batched forward on the generic core, pinned against the oracle.
    rng = np.random.default_rng(0)
    pose = rng.normal(scale=0.25, size=(4, 24, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(4, 16)).astype(np.float32)
    out = core.forward_batched(body, torch.as_tensor(pose, device=dev),
                               torch.as_tensor(beta, device=dev))
    want = oracle.forward(body64, pose=pose[0].astype(np.float64),
                          shape=beta[0].astype(np.float64)).verts
    err = float(np.abs(out.verts[0].cpu().numpy() - want).max())
    print(f"forward batch=4: verts {tuple(out.verts.shape)}, "
          f"max err vs f64 oracle {err:.2e}")
    assert err < 1e-4

    # 3. Pose recovery with the stock LM solver — same API as the hand;
    # the analytic Jacobian assembly is topology-generic too.
    target = out.verts[:1]
    res = fit_lm(body, target, n_steps=args.steps)
    v_err = float((core.forward_batched(body, res.pose, res.shape).verts
                   - target).abs().max())
    print(f"fit: LM recovered the body pose to {v_err * 1e3:.4f} mm max "
          f"vertex error in {args.steps} steps")
    assert v_err < 1e-4

    # 4. Ship it (posed + rest twin, reference OBJ format).
    posed = core.forward(body, res.pose[0], res.shape[0])
    export_obj_pair(posed.verts, posed.rest_verts, body.faces, args.out)
    print(f"wrote {args.out} (+ rest-pose twin)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
