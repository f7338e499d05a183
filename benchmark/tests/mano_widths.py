"""MANO's published widths (Romero, Tzionas and Black, "Embodied Hands",
SIGGRAPH Asia 2017), which the MANO configurations' own test files pin:
(vertices, joints, shape coefficients, pose-corrective columns), faces,
and the kinematic tree (a wrist and five three-joint fingers)."""

from benchmark import harness

WIDTHS = (778, 16, 10, 135)
FACES = 1538
PARENTS = [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14]

#: Changes that leave a configuration whole but not MANO.
ALTERED = {
    "verts": dict(n_verts=779),
    "shape": dict(n_shape=20),
    "faces": dict(n_faces=1540),
    "joints": dict(n_joints=17, n_pose_basis=144, parents=PARENTS + [15]),
    "tree": dict(parents=PARENTS[:4] + [3] + PARENTS[5:]),
}


def config(name: str) -> dict:
    return harness.load_json("configs", name)


def check_mano(data: dict) -> None:
    assert (data["n_verts"], data["n_joints"], data["n_shape"],
            data["n_pose_basis"]) == WIDTHS
    assert data["n_faces"] == FACES
    assert data["parents"] == PARENTS
