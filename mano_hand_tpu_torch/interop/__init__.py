"""The torch-facing API for users of torch MANO stacks (manopth, smplx):
``params_from_torch``, ``forward_from_torch``, ``TorchManoLayer`` /
``make_torch_layer`` and ``to_torch``."""

from mano_hand_tpu_torch.interop.torch_bridge import (
    TorchManoLayer,
    forward_from_torch,
    make_torch_layer,
    params_from_torch,
    to_torch,
)

__all__ = [
    "TorchManoLayer",
    "forward_from_torch",
    "make_torch_layer",
    "params_from_torch",
    "to_torch",
]
