"""The generator: one seed, one set of arrays; weights structurally
valid for the program's loader."""

import torch

from benchmark import gen, harness
from benchmark.entries.common import program_params

CFG = harness.load_json("configs", "mano_pair")
CPU = torch.device("cpu")


def draw(seed):
    g = gen.generator(seed, CPU)
    hands = gen.config_arrays(CFG, g, CPU)
    return hands, (gen.poses(32, CFG, g, CPU),
                   gen.shapes(32, CFG, g, CPU),
                   gen.zipf_indices(64, 50, 1.0, g, CPU))


def test_same_seed_same_inputs_and_weights():
    big = 2 ** 31 + 12345
    (h1, x1), (h2, x2) = draw(big), draw(big)
    for a, b in zip(h1, h2):
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k], b[k]), k
    for a, b in zip(x1, x2):
        assert torch.equal(a, b)
    (h3, x3) = draw(big + 1)
    assert not torch.equal(x1[0], x3[0])
    assert not torch.equal(h1[0]["pose_basis"], h3[0]["pose_basis"])


def test_weights_are_structurally_valid():
    hands, (pose, shape, idx) = draw(7)
    assert len(hands) == 2 and not torch.equal(hands[0]["v_template"],
                                               hands[1]["v_template"])
    for a, side in zip(hands, CFG["hands"]):
        p = program_params(a, side)
        assert p.v_template.dtype == torch.float32
        torch.testing.assert_close(a["j_regressor"].sum(1),
                                   torch.ones(16), rtol=0, atol=1e-6)
        torch.testing.assert_close(a["lbs_weights"].sum(1),
                                   torch.ones(778), rtol=0, atol=1e-6)
        assert (a["j_regressor"] >= 0).all() and (a["lbs_weights"] >= 0).all()
        q = a["pca_basis"].double()
        torch.testing.assert_close(q @ q.T, torch.eye(45, dtype=q.dtype),
                                   rtol=0, atol=1e-6)
        f = a["faces"].long()
        assert f.shape == (1538, 3)
        assert ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
                & (f[:, 0] != f[:, 2])).all()
    assert pose.shape == (32, 16, 3) and shape.shape == (32, 10)
    assert idx.min() >= 0 and idx.max() < 50


def test_zipf_skew():
    g = gen.generator(3, CPU)
    idx = gen.zipf_indices(20000, 1000, 1.0, g, CPU)
    counts = torch.bincount(idx, minlength=1000).sort(descending=True).values
    # Rank 1 of a Zipf(1) over 1,000 subjects draws ~13 % of the traffic.
    assert 0.10 < counts[0].item() / 20000 < 0.17
    assert counts[:10].sum().item() / 20000 > 0.35
