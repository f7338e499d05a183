"""Runtime configuration.

The port of the JAX package's ``utils/config.py``: one dataclass, JSON
round-trippable with the same fields and the same files, that builds the
port's objects it describes. A file the JAX package wrote loads here: its
``backend: "jax"`` reads as ``"torch"``. ``precision`` is kept, checked
and written back, but the port computes in IEEE fp32 whatever it says
(its contractions are pinned by ``ops/common.py:ieee_fp32``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Union

PathLike = Union[str, Path]

#: The JAX package's precision names (bf16 passes per f32 matmul there).
PRECISIONS = ("high", "highest", "default")


@dataclasses.dataclass
class ManoConfig:
    asset: str = "synthetic"        # path to .npz/.pkl, or "synthetic"
    side: Optional[str] = None      # left | right | None (infer)
    backend: str = "torch"          # np | torch ("jax" reads as "torch")
    dtype: str = "float32"          # compute dtype for the torch path
    precision: str = "high"         # high | highest | default: kept for
                                    # JAX's files; the port is IEEE fp32
    mesh_data: int = 1              # data-parallel mesh extent
    mesh_model: int = 1             # tensor-parallel mesh extent
    chunk_size: int = 8192          # huge-batch chunking
    seed: int = 0                   # synthetic-asset seed

    def __post_init__(self) -> None:
        if self.backend == "jax":
            self.backend = "torch"
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{self.precision!r}")

    # ----------------------------------------------------------- build
    def load_params(self, device=None):
        """The asset on ``device`` (default ``cuda``; pass ``"cpu"`` for
        the CPU): float64 for the ``np`` backend, ``dtype`` for
        ``torch``."""
        import torch

        from mano_hand_tpu_torch.assets import load_model, synthetic_params

        if self.asset == "synthetic":
            params = synthetic_params(seed=self.seed,
                                      side=self.side or "right",
                                      device=device)
        else:
            params = load_model(self.asset, side=self.side, device=device)
        if self.backend == "torch":
            return params.astype(getattr(torch, self.dtype))
        return params

    def build_model(self, device=None):
        """A ``MANOModel`` over the asset; ``device`` is where its torch
        backend evaluates (default ``cuda``)."""
        import torch

        from mano_hand_tpu_torch.models.layer import MANOModel

        return MANOModel(self.load_params(device="cpu"),
                         backend=self.backend, device=device,
                         dtype=getattr(torch, self.dtype))

    def build_mesh(self, devices=None):
        """The ('data', 'model') mesh of ``mesh_data`` x ``mesh_model``
        ranks (``parallel.make_mesh``; ``devices`` as its)."""
        from mano_hand_tpu_torch.parallel import make_mesh

        return make_mesh(data=self.mesh_data, model=self.mesh_model,
                         devices=devices)

    # ------------------------------------------------------------ json
    def to_json(self, path: Optional[PathLike] = None) -> str:
        text = json.dumps(dataclasses.asdict(self), indent=2)
        if path is not None:
            Path(path).write_text(text)
        return text

    @classmethod
    def from_json(cls, source: Union[str, PathLike]) -> "ManoConfig":
        p = Path(str(source))
        text = p.read_text() if p.exists() else str(source)
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)
