"""Per-tier precision policy for the serving engine.

The policy is deliberately narrow:

* **Only the baked-shape/pose (gathered) path ever serves bf16.** The
  steady-state interactive workload is ``submit(pose, subject=key)``:
  the pose blend and the skinning over baked subject rows. Full-path
  requests stay f32.
* **bf16 means bf16 compute with f32 accumulation.** The two contractions
  of the pose stage (pose-corrective blend, LBS skinning) take bf16
  operands and accumulate into f32 (``compute_dtype=torch.bfloat16`` in
  ``models/core.py``; on the kernel tier, K2's bf16 variant). Rodrigues,
  FK and every residual add stay f32, and the served vertices are f32.
* **The envelope is part of the policy.** ``max_vertex_err_m`` is the
  stated per-request vertex-error budget (meters) the bf16 tier must hold
  against the f32 path.

Tiers not named in ``bf16_tiers`` default to f32: an engine with no
policy at all serves exactly as before.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable

#: The compute dtypes a tier can be mapped to.
F32 = "f32"
BF16 = "bf16"

#: Default stated vertex-error budget of the bf16 tier: 2 mm in model
#: units (meters) — several times the measured bf16-vs-f32 error, small
#: against fingertip dimensions, and loose enough that it gates real
#: drift, not float weather.
DEFAULT_ENVELOPE_M = 2e-3


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Which admission tiers serve the bf16 baked-shape/pose path.

    Parameters
    ----------
    bf16_tiers: tiers whose POSE-ONLY (subject) requests are served by
        the bf16-compute/f32-accumulate gathered family. Default:
        tier 0 only — interactive traffic, the tier with a latency SLO
        and a stated mm-level error budget. Full-path requests on any
        tier stay f32 (the bf16 family exists only where the shape
        stage is pre-baked).
    accumulate: accumulation dtype of the bf16 contractions. Only
        ``"f32"`` is supported: bf16 accumulation is a silent-collapse
        class of error no envelope covers.
    max_vertex_err_m: the stated per-request vertex-error envelope
        (meters) vs the f32 path.
    """

    bf16_tiers: FrozenSet[int] = frozenset({0})
    accumulate: str = F32
    max_vertex_err_m: float = DEFAULT_ENVELOPE_M

    def __post_init__(self):
        tiers = frozenset(int(t) for t in self.bf16_tiers)
        if any(t < 0 for t in tiers):
            raise ValueError(
                f"bf16_tiers must be non-negative, got {sorted(tiers)}")
        object.__setattr__(self, "bf16_tiers", tiers)
        if self.accumulate != F32:
            raise ValueError(
                f"accumulate must be {F32!r} (bf16 accumulation is a "
                f"silent-collapse class of error), got {self.accumulate!r}")
        if not (self.max_vertex_err_m > 0):
            raise ValueError(
                f"max_vertex_err_m must be > 0, got "
                f"{self.max_vertex_err_m}")

    def dtype_for_tier(self, tier: int) -> str:
        """``"bf16"`` | ``"f32"`` for one admission tier's pose-only
        requests — a tier without an entry defaults f32 (absence of
        policy is never a precision change)."""
        return BF16 if int(tier) in self.bf16_tiers else F32

    def tiers_snapshot(self, extra_tiers: Iterable[int] = (0, 1)) -> dict:
        """{tier: dtype} over ``bf16_tiers`` plus ``extra_tiers`` (the
        shape a load or metrics export reports)."""
        tiers = sorted(set(int(t) for t in extra_tiers)
                       | set(self.bf16_tiers))
        return {str(t): self.dtype_for_tier(t) for t in tiers}
