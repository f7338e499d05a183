"""Deterministic synthetic MANO-shaped assets for tests and benchmarks.

The official MANO pickles are license-gated, so every test and benchmark
runs on a generated asset with the exact MANO schema. The generator is
seeded NumPy, line for line the same draws as the JAX package's
``assets/synthetic.py``, so one seed gives the same arrays in both.
"""

from __future__ import annotations

import numpy as np
import torch

from mano_hand_tpu_torch import constants as C
from mano_hand_tpu_torch.assets.convert import params_from_numpy
from mano_hand_tpu_torch.assets.schema import ManoParams


def synthetic_arrays(
    seed: int = 0,
    n_verts: int = C.N_VERTS,
    n_joints: int = C.N_JOINTS,
    n_shape: int = C.N_SHAPE,
    n_faces: int = C.N_FACES,
) -> dict:
    """The float64 NumPy arrays (plus ``parents``) of one synthetic asset.

    Properties the real asset has and tests rely on:
      * j_regressor rows are non-negative and sum to 1,
      * lbs_weights rows are non-negative and sum to 1, concentrated on a
        few joints,
      * pca_basis is orthonormal (rows = components),
      * parents is the true MANO kinematic tree when n_joints == 16.
    """
    rng = np.random.default_rng(seed)
    n_pose_aa = (n_joints - 1) * 3
    n_pose_basis = (n_joints - 1) * 9

    # A blobby hand-scale (~10 cm) point cloud as the template.
    v_template = rng.normal(scale=0.04, size=(n_verts, 3))
    v_template[:, 1] += np.linspace(0.0, 0.1, n_verts)  # stretch along +y

    shape_basis = rng.normal(scale=5e-3, size=(n_verts, 3, n_shape))
    pose_basis = rng.normal(scale=5e-4, size=(n_verts, 3, n_pose_basis))

    # Joint regressor: each joint draws from a random vertex neighborhood.
    j_regressor = rng.random((n_joints, n_verts)) ** 8  # sparse-ish
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)

    # Skinning weights: concentrate each vertex on ~2 joints.
    lbs_weights = rng.random((n_verts, n_joints)) ** 6
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    # Orthonormal PCA basis via QR; small mean pose.
    q, _ = np.linalg.qr(rng.normal(size=(n_pose_aa, n_pose_aa)))
    pca_basis = q
    pca_mean = rng.normal(scale=0.05, size=(n_pose_aa,))

    # Random valid triangles (distinct vertex ids per face).
    faces = np.stack(
        [rng.choice(n_verts, size=3, replace=False) for _ in range(n_faces)]
    ).astype(np.int32)

    if n_joints == C.N_JOINTS:
        parents = C.MANO_PARENTS
    else:
        parents = (-1,) + tuple(
            int(rng.integers(0, i)) for i in range(1, n_joints))

    return dict(
        v_template=v_template, shape_basis=shape_basis,
        pose_basis=pose_basis, j_regressor=j_regressor,
        lbs_weights=lbs_weights, pca_basis=pca_basis, pca_mean=pca_mean,
        faces=faces, parents=parents,
    )


def synthetic_params(
    seed: int = 0,
    side: str = C.RIGHT,
    n_verts: int = C.N_VERTS,
    n_joints: int = C.N_JOINTS,
    n_shape: int = C.N_SHAPE,
    n_faces: int = C.N_FACES,
    dtype=torch.float64,
    device=None,
) -> ManoParams:
    """A random but structurally valid MANO-like asset on ``device``
    (default ``cuda``; pass ``device="cpu"`` explicitly for the CPU)."""
    arrays = synthetic_arrays(seed, n_verts, n_joints, n_shape, n_faces)
    return params_from_numpy(dict(arrays, side=side), device=device,
                             dtype=dtype)


def synthetic_pair(seed: int = 0, dtype=torch.float64, device=None):
    """A (left, right) pair of synthetic hands, distinct but seeded (the
    JAX package's draws: left from ``seed + 1``, right from ``seed``)."""
    return (
        synthetic_params(seed=seed + 1, side=C.LEFT, dtype=dtype,
                         device=device),
        synthetic_params(seed=seed, side=C.RIGHT, dtype=dtype,
                         device=device),
    )
