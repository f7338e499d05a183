"""``core.forward_hands_pallas_fused_full``: both hands in one K5 launch.

Each call runs the whole forward of ``rows_per_hand`` meshes of every
hand of the configuration's ``stack_params`` pair, pose [H, B, J, 3] and
shape [H, B, S], in one launch.
"""

from __future__ import annotations

import torch

from benchmark import gen, work
from benchmark.entries.common import POOL, BulkForward, program_params


def build(ctx):
    return HandsForward(ctx)


class HandsForward(BulkForward):
    def __init__(self, ctx):
        from mano_hand_tpu_torch.models import core

        cfg, traffic = ctx.cfg, ctx.traffic
        self.hands = gen.config_arrays(cfg, ctx.gen, ctx.device)
        h = len(self.hands)
        rows = int(traffic["rows_per_hand"])
        self.rows_total = h * rows
        self.pool = POOL
        self.inputs = []
        for _ in range(self.pool):
            pose = gen.poses(h * rows, cfg, ctx.gen, ctx.device)
            shape = gen.shapes(h * rows, cfg, ctx.gen, ctx.device)
            self.inputs.append((pose.reshape(h, rows, *pose.shape[1:]),
                                shape.reshape(h, rows, -1)))
        v, j, s = cfg["n_verts"], cfg["n_joints"], cfg["n_shape"]
        self.out_shape = (h, rows, v, 3)
        flops, moved = work.forward_work(rows, v, j, s)
        super().__init__(ctx, h * flops, h * moved, h * rows)
        left, right = (program_params(a, side)
                       for a, side in zip(self.hands, cfg["hands"]))
        self.stacked = core.stack_params(left, right)
        self.forward = core.forward_hands_pallas_fused_full

    def call(self, slot):
        pose, shape = self.inputs[slot]
        with torch.no_grad():
            return self.forward(self.stacked, pose, shape)

    def release(self):
        del self.stacked, self.forward

    def segments(self, slot):
        pose, shape = self.inputs[slot]
        return [(a, pose[h], shape[h]) for h, a in enumerate(self.hands)]
