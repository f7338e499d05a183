"""Small parts of the public surface, each a one-line port, held against
the JAX package: ``assets.synthetic_pair``, ``constants.SMPLH_PARENTS``,
``serving.pad_tree_rows`` and ``models.fused_blend_bases``."""

import numpy as np
import pytest
import torch

import mano_hand_tpu as jmh
from mano_hand_tpu import constants as jconstants
from mano_hand_tpu.serving import pad_tree_rows as jax_pad_tree_rows
import mano_hand_tpu_torch as mh
from mano_hand_tpu_torch import constants, models
from mano_hand_tpu_torch.assets import ARRAY_FIELDS, synthetic_pair
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.serving import pad_tree_rows


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_pair_matches_jax(seed):
    got = synthetic_pair(seed=seed, device="cpu")
    want = jmh.synthetic_pair(seed=seed)
    assert mh.synthetic_pair is synthetic_pair
    for g, w in zip(got, want):
        assert g.side == w.side
        assert tuple(g.parents) == tuple(w.parents)
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
        assert getattr(g, "v_template").dtype == torch.float64


def test_smplh_parents_matches_jax():
    assert constants.SMPLH_PARENTS == jconstants.SMPLH_PARENTS
    assert len(constants.SMPLH_PARENTS) == 52
    assert all(p < i for i, p in enumerate(constants.SMPLH_PARENTS))


@pytest.mark.parametrize("n, bucket", [(1, 1), (3, 4), (5, 8)])
def test_pad_tree_rows_matches_jax(n, bucket):
    rng = np.random.default_rng(n)
    tree = {"pose": rng.normal(size=(n, 16, 3)).astype(np.float32),
            "shape": rng.normal(size=(n, 10)),
            "trans": [[float(i)] * 3 for i in range(n)]}
    got, want = pad_tree_rows(tree, bucket), jax_pad_tree_rows(tree, bucket)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        pad_tree_rows(tree, n - 1 if n > 1 else 0)


def test_fused_blend_bases_is_public():
    assert "fused_blend_bases" in models.__all__
    assert models.fused_blend_bases is core.fused_blend_bases
