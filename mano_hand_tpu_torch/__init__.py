"""mano_hand_tpu_torch: the MANO hand model in PyTorch and CUDA.

The port of ``mano_hand_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. It imports torch and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the five hand-written CUDA
kernels (``ops/fused_forward.py`` K1, K5 and K4, ``ops/fused_posed.py``
K2 in f32 and in the bf16 serving tier, ``ops/fused_skin.py`` K3) build
with ``nvcc`` at their first launch. Gradients reach pose, shape and the
parameters through the three differentiable kernel routes and
``forward_chunked``, the huge-batch entry point; ``forward_hands`` and
K5 run both hands of a ``stack_params`` pair.

The quick start: ``load_model`` (every asset format) ->
``MANOModel(params, backend="torch")`` -> ``set_params`` ->
``keypoints`` / ``export_obj``; ``TorchManoLayer`` is the
differentiable ``nn.Module`` for torch training loops.
"""

from mano_hand_tpu_torch import constants
from mano_hand_tpu_torch.assets import (
    ManoParams, load_model, params_from_numpy, synthetic_pair,
    synthetic_params, validate,
)
from mano_hand_tpu_torch.interop import TorchManoLayer
from mano_hand_tpu_torch.models import (
    MANOModel, ManoOutput, decode_pca, forward, forward_batched, forward_batched_pallas,
    forward_batched_pallas_fused, forward_batched_pallas_fused_full,
    forward_chunked, forward_hands, forward_hands_pallas_fused_full,
    forward_pca, keypoints, stack_params,
)

__all__ = ["MANOModel", "ManoOutput", "ManoParams", "TorchManoLayer",
           "constants", "decode_pca", "forward", "forward_batched",
           "forward_batched_pallas", "forward_batched_pallas_fused",
           "forward_batched_pallas_fused_full", "forward_chunked",
           "forward_hands", "forward_hands_pallas_fused_full",
           "forward_pca", "keypoints", "load_model", "params_from_numpy",
           "stack_params", "synthetic_pair", "synthetic_params", "validate"]
