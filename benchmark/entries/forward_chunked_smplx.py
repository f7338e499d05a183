"""``core.forward_chunked`` over K1 for SMPL-X: ``forward_chunked``'s
calls, judged against SMPL-X's own reference (``reference/smplx.py``).

The program takes the drawn shape [B, n_betas + n_expression] and shape
basis whole, as ``assets.load_smplx`` hands them over (betas first); the
reference gets them split: betas and expression against ``shapedirs``
and ``exprdirs``.
"""

from __future__ import annotations

from benchmark.entries.common import CHECK_BLOCK
from benchmark.entries.forward_chunked import ChunkedForward
from benchmark.reference import smplx


def build(ctx):
    return SmplxChunkedForward(ctx)


def reference_model(arrays: dict, n_betas: int) -> dict:
    """The reference's model, in SMPL-X's names, over the benchmark's
    arrays (views: the shape basis split after ``n_betas`` columns)."""
    basis = arrays["shape_basis"]
    return {"v_template": arrays["v_template"],
            "shapedirs": basis[..., :n_betas],
            "exprdirs": basis[..., n_betas:],
            "posedirs": arrays["pose_basis"],
            "J_regressor": arrays["j_regressor"],
            "weights": arrays["lbs_weights"],
            "parents": arrays["parents"]}


class SmplxChunkedForward(ChunkedForward):
    def __init__(self, ctx):
        cfg = ctx.cfg
        if cfg["n_betas"] + cfg["n_expression"] != cfg["n_shape"]:
            raise ValueError(f"{cfg['name']}: n_betas + n_expression must be "
                             f"n_shape")
        super().__init__(ctx)
        self.n_betas = cfg["n_betas"]
        self.model = reference_model(self.arrays, self.n_betas)

    def reference_blocks(self, slot: int, precision: str):
        pose, shape = self.inputs[slot]
        nb = self.n_betas
        yield from smplx.forward_blocks(self.model, pose, shape[:, :nb],
                                        shape[:, nb:], precision,
                                        CHECK_BLOCK)
