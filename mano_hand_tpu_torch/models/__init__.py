"""The MANO forward core (``core``), clip evaluation (``anim``) and the
float64 NumPy oracle (``oracle``)."""

from mano_hand_tpu_torch.models.core import (
    ManoOutput,
    forward,
    forward_batched,
    forward_batched_pallas,
    forward_batched_pallas_fused,
    forward_batched_pallas_fused_full,
    forward_chunked,
    forward_hands,
    forward_hands_pallas_fused_full,
    stack_params,
)

__all__ = [
    "ManoOutput", "forward", "forward_batched", "forward_batched_pallas",
    "forward_batched_pallas_fused", "forward_batched_pallas_fused_full",
    "forward_chunked", "forward_hands", "forward_hands_pallas_fused_full",
    "stack_params",
]
