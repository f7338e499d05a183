"""The reference against the port's plain path at a tiny size on the
CPU, in float64: the two are written apart and must agree to rounding."""

import torch

from benchmark import gen, harness
from benchmark.entries.common import program_params
from benchmark.reference import mano

CPU = torch.device("cpu")
CFG = harness.load_json("configs", "mano_pair")


def setup(seed=11, n=24):
    g = gen.generator(seed, CPU)
    hands = [{k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                  else v) for k, v in a.items()}
             for a in gen.config_arrays(CFG, g, CPU)]
    return (hands, gen.poses(n, CFG, g, CPU).double(),
            gen.shapes(n, CFG, g, CPU).double())


def test_forward_matches_the_ports_plain_forward():
    from mano_hand_tpu_torch.models import core

    hands, pose, shape = setup()
    pose[0] = 0.0        # the zero rotation takes the small-angle branch
    for a, side in zip(hands, CFG["hands"]):
        want = core.forward_batched(program_params(a, side), pose, shape,
                                    fused=False).verts
        got = mano.forward(a, pose, shape)
        assert (got - want).abs().max() < 1e-12
    blocks = list(mano.forward_blocks(hands[0], pose, shape, block=7))
    assert [b[:2] for b in blocks] == [(0, 7), (7, 14), (14, 21), (21, 24)]
    torch.testing.assert_close(torch.cat([b[2] for b in blocks]),
                               mano.forward(hands[0], pose, shape),
                               rtol=0, atol=1e-15)


def test_forward_matches_the_ports_gathered_pose_only_forward():
    from mano_hand_tpu_torch.models import core

    hands, pose, _ = setup(seed=12)
    g = gen.generator(5, CPU)
    subjects = gen.shapes(5, CFG, g, CPU).double()
    idx = gen.zipf_indices(pose.shape[0], 5, 1.0, g, CPU)
    params = program_params(hands[1], "right")
    shaped = core.specialize(params, subjects)
    table = core.SubjectTable(shaped.v_shaped, shaped.joints, shaped.shape,
                              shaped.pose_basis, shaped.lbs_weights)
    want = core.forward_posed_gather(table, idx, pose).verts
    got = mano.forward(hands[1], pose, subjects[idx])
    assert (got - want).abs().max() < 1e-12


def test_tf32_precision_restores_the_callers_setting():
    saved = torch.get_float32_matmul_precision()
    with mano.matmul_precision("tf32"):
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == saved
