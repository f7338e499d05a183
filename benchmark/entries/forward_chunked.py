"""``core.forward_chunked`` over K1: one hand, ``rows`` meshes a call.

Each call runs ``forward_chunked(params, pose, shape, chunk_size,
use_pallas_fused_full=True)``: the rows in chunks of ``chunk_size``, one
K1 launch a chunk, and the library's concatenation.
"""

from __future__ import annotations

import torch

from benchmark import gen, work
from benchmark.entries.common import POOL, BulkForward, program_params


def build(ctx):
    return ChunkedForward(ctx)


class ChunkedForward(BulkForward):
    def __init__(self, ctx):
        from mano_hand_tpu_torch.models import core

        cfg, traffic = ctx.cfg, ctx.traffic
        (self.arrays,) = gen.config_arrays(cfg, ctx.gen, ctx.device)
        self.rows_total = rows = int(traffic["rows"])
        self.pool = POOL
        self.inputs = [(gen.poses(rows, cfg, ctx.gen, ctx.device),
                        gen.shapes(rows, cfg, ctx.gen, ctx.device))
                       for _ in range(self.pool)]
        v, j, s = cfg["n_verts"], cfg["n_joints"], cfg["n_shape"]
        self.out_shape = (rows, v, 3)
        flops, moved = work.forward_work(rows, v, j, s)
        super().__init__(ctx, flops, moved, rows)
        self.params = program_params(self.arrays, cfg["hands"][0])
        self.chunk = int(traffic["chunk_size"])
        self.forward = core.forward_chunked

    def call(self, slot):
        pose, shape = self.inputs[slot]
        with torch.no_grad():
            return self.forward(self.params, pose, shape,
                                chunk_size=self.chunk,
                                use_pallas_fused_full=True)

    def release(self):
        del self.params, self.forward

    def segments(self, slot):
        pose, shape = self.inputs[slot]
        return [(self.arrays, pose, shape)]
