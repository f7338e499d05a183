"""``smplx_neutral``, SMPL-X at its published widths and tree (Pavlakos
et al., CVPR 2019, ``SMPLX_NEUTRAL.npz``): 10,475 vertices, 20,908
faces, 55 joints, 10 betas then 10 expression coefficients (the
``smplx`` package's defaults), a 486-wide pose basis."""

import pytest

from benchmark import harness
from benchmark.tests.test_hb_files import SMPLX_PARENTS

NAME = "smplx_neutral"
#: (vertices, joints, shape coefficients, pose-corrective columns).
WIDTHS = (10475, 55, 20, 486)
FACES = 20908

#: Changes that leave the configuration whole but not SMPL-X.
ALTERED = {
    "verts": dict(n_verts=10476),
    "faces": dict(n_faces=20900),
    "betas": dict(n_betas=16, n_shape=26),
    "expression": dict(n_expression=0, n_shape=10),
    "split": dict(n_betas=20, n_expression=0),
    "joints": dict(n_joints=52, n_pose_basis=459, parents=SMPLX_PARENTS[:52]),
    "tree": dict(parents=SMPLX_PARENTS[:22] + [14] + SMPLX_PARENTS[23:]),
}


def check_smplx(data: dict) -> None:
    assert (data["n_verts"], data["n_joints"], data["n_shape"],
            data["n_pose_basis"]) == WIDTHS
    assert data["n_faces"] == FACES
    assert (data["n_betas"], data["n_expression"]) == (10, 10)
    assert data["parents"] == SMPLX_PARENTS
    assert data["hands"] == ["neutral"]


def test_holds_smplxs_widths():
    check_smplx(harness.load_json("configs", NAME))


@pytest.mark.parametrize("changes", ALTERED.values(), ids=list(ALTERED))
def test_refuses_other_widths(changes):
    """Altered so that it still holds together, it is refused all the
    same: the pin does not weaken."""
    with pytest.raises(AssertionError):
        check_smplx(dict(harness.load_json("configs", NAME), **changes))
