"""The MANO parameter set: the data contract between assets and the core.

A frozen dataclass of tensors with the kinematic tree (``parents``) and
handedness (``side``) carried as plain Python values. Identity equality
(``eq=False``) lets per-asset caches (the fused kernels' packed operands)
key on the object itself.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from mano_hand_tpu_torch import constants as C

ARRAY_FIELDS = (
    "v_template",
    "shape_basis",
    "pose_basis",
    "j_regressor",
    "lbs_weights",
    "pca_basis",
    "pca_mean",
    "faces",
)

#: The float fields the forward reads, in the order the kernel routes'
#: autograd Functions take them: the five that gradients reach.
FORWARD_FIELDS = (
    "v_template",
    "shape_basis",
    "pose_basis",
    "j_regressor",
    "lbs_weights",
)


@dataclasses.dataclass(frozen=True, eq=False)
class ManoParams:
    """Frozen MANO model parameters.

    Shapes (V=778 verts, J=16 joints, S=10 shape dims, P=135 pose-basis dims):
      v_template     [V, 3]    rest-pose template mesh
      shape_basis    [V, 3, S] shape blendshapes ("shapedirs")
      pose_basis     [V, 3, P] pose-corrective blendshapes ("posedirs")
      j_regressor    [J, V]    joint regressor (dense)
      lbs_weights    [V, J]    linear-blend-skinning weights
      pca_basis      [45, 45]  finger-pose PCA basis, rows = components
      pca_mean       [45]      mean finger pose (flattened 15x3 axis-angle)
      faces          [F, 3]    triangle indices, 0-based int32
    """

    v_template: torch.Tensor
    shape_basis: torch.Tensor
    pose_basis: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    pca_basis: torch.Tensor
    pca_mean: torch.Tensor
    faces: torch.Tensor
    parents: Tuple[int, ...] = C.MANO_PARENTS
    side: str = C.RIGHT

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def n_shape(self) -> int:
        return self.shape_basis.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @property
    def dtype(self) -> torch.dtype:
        return self.v_template.dtype

    def forward_tensors(self) -> Tuple[torch.Tensor, ...]:
        """The ``FORWARD_FIELDS`` tensors, in that order."""
        return tuple(getattr(self, f) for f in FORWARD_FIELDS)

    def astype(self, dtype: torch.dtype) -> "ManoParams":
        """Cast all float fields to ``dtype`` (faces stay integer)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f) if f == "faces" else getattr(self, f).to(dtype)
            for f in ARRAY_FIELDS})

    def to(self, device) -> "ManoParams":
        """Move every tensor to ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


#: The ``side`` of a ``StackedParams``: never a valid single-hand side.
STACKED = "stacked"


@dataclasses.dataclass(frozen=True, eq=False)
class StackedParams:
    """Several hands' parameter sets on a leading hand axis (the output of
    ``core.stack_params``): every ``ARRAY_FIELDS`` tensor is ``[H, ...]``
    and the hands share one kinematic tree. Its ``side`` is ``"stacked"``,
    so it is never ``validate``d; ``hands`` gives each hand back as a
    ``ManoParams`` of views (their in-place updates reach the stack)."""

    v_template: torch.Tensor     # [H, V, 3]
    shape_basis: torch.Tensor    # [H, V, 3, S]
    pose_basis: torch.Tensor     # [H, V, 3, P]
    j_regressor: torch.Tensor    # [H, J, V]
    lbs_weights: torch.Tensor    # [H, V, J]
    pca_basis: torch.Tensor      # [H, 45, 45]
    pca_mean: torch.Tensor       # [H, 45]
    faces: torch.Tensor          # [H, F, 3]
    parents: Tuple[int, ...] = C.MANO_PARENTS
    sides: Tuple[str, ...] = ()  # each hand's own side
    side: str = STACKED

    @property
    def n_hands(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[1]

    @property
    def n_joints(self) -> int:
        return self.j_regressor.shape[1]

    @property
    def n_shape(self) -> int:
        return self.shape_basis.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @property
    def dtype(self) -> torch.dtype:
        return self.v_template.dtype

    def forward_tensors(self) -> Tuple[torch.Tensor, ...]:
        """The stacked ``FORWARD_FIELDS`` tensors, in that order."""
        return tuple(getattr(self, f) for f in FORWARD_FIELDS)

    @functools.cached_property
    def hands(self) -> Tuple[ManoParams, ...]:
        """One ``ManoParams`` per hand, its tensors views of the stack
        (built once, so per-asset caches keyed on them hit)."""
        return tuple(
            ManoParams(**{f: getattr(self, f)[h] for f in ARRAY_FIELDS},
                       parents=self.parents, side=self.sides[h])
            for h in range(self.n_hands))


def validate(p: ManoParams) -> ManoParams:
    """Shape/consistency check of the asset contract; returns ``p``.

    Raises ValueError with a precise message on any mismatch, so a bad
    asset fails at load time rather than deep inside a forward pass.
    """
    v, j = p.v_template.shape[0], p.j_regressor.shape[0]
    s = p.shape_basis.shape[-1]
    expect = {
        "v_template": (v, 3),
        "shape_basis": (v, 3, s),
        "pose_basis": (v, 3, (j - 1) * 9),
        "j_regressor": (j, v),
        "lbs_weights": (v, j),
        "pca_basis": ((j - 1) * 3, (j - 1) * 3),
        "pca_mean": ((j - 1) * 3,),
    }
    for name, shape in expect.items():
        got = tuple(getattr(p, name).shape)
        if got != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {got}")
    if p.faces.ndim != 2 or p.faces.shape[1] != 3:
        raise ValueError(f"faces: expected [F, 3], got {tuple(p.faces.shape)}")
    if len(p.parents) != j:
        raise ValueError(f"parents: expected length {j}, got {len(p.parents)}")
    if p.parents[0] != -1:
        raise ValueError("parents[0] must be -1 (root)")
    for i, par in enumerate(p.parents[1:], start=1):
        if not (0 <= par < i):
            raise ValueError(
                f"parents must be topologically ordered; parents[{i}]={par}"
            )
    if p.faces.numel():
        lo, hi = int(p.faces.min()), int(p.faces.max())
        if lo < 0 or hi >= v:
            raise ValueError(
                f"faces indices must be in [0, {v}); got range [{lo}, {hi}]")
    if p.side not in (C.LEFT, C.RIGHT, C.NEUTRAL):
        raise ValueError(
            f"side must be 'left', 'right' or 'neutral', got {p.side!r}")
    return p
