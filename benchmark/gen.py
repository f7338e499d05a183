"""The benchmark's one generator: weights and inputs from ``--seed``.

Everything is drawn on the run's device from one ``torch.Generator``
seeded with the run's seed, in a fixed order and in a few large calls,
so the same seed gives the same arrays on the same device. The weights
are random but structurally valid MANO-shaped arrays (the published
asset is licence-gated): the rules are those of the port's
``assets/synthetic.py`` (a ~10 cm template stretched along +y, shape and
pose bases at 5e-3 and 5e-4, regressor and skinning rows non-negative
and summing to 1, an orthonormal PCA basis, distinct vertex ids per
face), drawn with torch on the device instead of NumPy on the host.

Nothing here imports the port: the program and the reference receive
the same tensors.
"""

from __future__ import annotations

import torch

#: Spreads of the drawn inputs: root and finger rotations (radians),
#: shape coefficients.
GLOBAL_POSE_STD = 1.0
FINGER_POSE_STD = 0.4
SHAPE_STD = 1.0


def generator(seed: int, device) -> torch.Generator:
    """The run's generator on ``device``, seeded with ``seed`` (any
    non-negative whole number below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def hand_arrays(cfg: dict, gen: torch.Generator, device) -> dict:
    """One hand's float32 arrays on ``device``, drawn from ``gen``:
    ``v_template`` [V, 3], ``shape_basis`` [V, 3, S], ``pose_basis``
    [V, 3, P], ``j_regressor`` [J, V], ``lbs_weights`` [V, J],
    ``pca_basis`` [3(J-1), 3(J-1)], ``pca_mean`` [3(J-1)], ``faces``
    [F, 3] int32, and ``parents`` (a tuple)."""
    v, j, s, f = (cfg[k] for k in ("n_verts", "n_joints", "n_shape",
                                   "n_faces"))
    p = 9 * (j - 1)
    a = 3 * (j - 1)
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    # One normal draw for every Gaussian leaf, split in a fixed order.
    sizes = (v * 3, v * 3 * s, v * 3 * p, a * a, a)
    normal = torch.randn(sum(sizes), **kw).split(sizes)
    v_template = normal[0].reshape(v, 3) * 0.04
    v_template[:, 1] += torch.linspace(0.0, 0.1, v, device=device)
    shape_basis = normal[1].reshape(v, 3, s) * 5e-3
    pose_basis = normal[2].reshape(v, 3, p) * 5e-4
    pca_basis = torch.linalg.qr(normal[3].reshape(a, a).double())[0].float()
    pca_mean = normal[4] * 0.05
    uniform = torch.rand(j * v + v * j, **kw).split((j * v, v * j))
    j_regressor = uniform[0].reshape(j, v) ** 8
    j_regressor = j_regressor / j_regressor.sum(dim=1, keepdim=True)
    lbs_weights = uniform[1].reshape(v, j) ** 6
    lbs_weights = lbs_weights / lbs_weights.sum(dim=1, keepdim=True)
    # Three distinct vertices a face: the top 3 of a random row.
    faces = torch.rand(f, v, **kw).topk(3, dim=1).indices.to(torch.int32)
    return dict(v_template=v_template, shape_basis=shape_basis,
                pose_basis=pose_basis, j_regressor=j_regressor,
                lbs_weights=lbs_weights, pca_basis=pca_basis,
                pca_mean=pca_mean, faces=faces,
                parents=tuple(cfg["parents"]))


def config_arrays(cfg: dict, gen: torch.Generator, device) -> list:
    """Every hand of the configuration, in ``cfg["hands"]`` order."""
    return [hand_arrays(cfg, gen, device) for _ in cfg["hands"]]


def poses(n: int, cfg: dict, gen: torch.Generator,
          device) -> torch.Tensor:
    """[n, J, 3] axis-angle poses: the root rotation's components with
    standard deviation ``GLOBAL_POSE_STD``, every finger joint's with
    ``FINGER_POSE_STD`` (radians)."""
    j = cfg["n_joints"]
    pose = torch.randn(n, j, 3, generator=gen, device=device)
    scale = torch.full((j, 1), FINGER_POSE_STD, device=device)
    scale[0] = GLOBAL_POSE_STD
    return pose * scale


def shapes(n: int, cfg: dict, gen: torch.Generator,
           device) -> torch.Tensor:
    """[n, S] shape coefficients with standard deviation ``SHAPE_STD``."""
    return torch.randn(n, cfg["n_shape"], generator=gen,
                       device=device) * SHAPE_STD


def zipf_indices(n: int, subjects: int, exponent: float,
                 gen: torch.Generator, device) -> torch.Tensor:
    """[n] int64 subject indices, Zipf-skewed: rank r (1-based) drawn
    with weight r ** -exponent, ranks mapped to subjects by a seeded
    permutation (so the popular subjects differ from seed to seed)."""
    ranks = torch.arange(1, subjects + 1, device=device, dtype=torch.float64)
    weights = ranks ** -float(exponent)
    drawn = torch.multinomial(weights, n, replacement=True, generator=gen)
    perm = torch.randperm(subjects, generator=gen, device=device)
    return perm[drawn]
