"""Host NumPy views of tensors, for the writers and loaders that format
or hash arrays on the host."""

from __future__ import annotations

import numpy as np
import torch


def as_numpy(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a nested sequence) as a
    host NumPy array, cast to ``dtype`` when given."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)
