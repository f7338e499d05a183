"""``core.forward_posed_gather_fused`` over f32 K2: stored subjects
re-posed in bulk.

Set-up bakes ``subjects`` seeded shapes into a ``SubjectTable`` through
the program's ``specialize``; each call poses ``rows`` meshes whose
subject indices are drawn Zipf-skewed, one K2 launch.
"""

from __future__ import annotations

import torch

from benchmark import gen, work
from benchmark.entries.common import POOL, BulkForward, program_params


def build(ctx):
    return PosedGather(ctx)


class PosedGather(BulkForward):
    def __init__(self, ctx):
        from mano_hand_tpu_torch.models import core

        cfg, traffic = ctx.cfg, ctx.traffic
        (self.arrays,) = gen.config_arrays(cfg, ctx.gen, ctx.device)
        self.rows_total = rows = int(traffic["rows"])
        subjects = int(traffic["subjects"])
        self.subject_shapes = gen.shapes(subjects, cfg, ctx.gen,
                                         ctx.device)
        self.pool = POOL
        self.inputs = [
            (gen.zipf_indices(rows, subjects, traffic["zipf_exponent"],
                              ctx.gen, ctx.device),
             gen.poses(rows, cfg, ctx.gen, ctx.device))
            for _ in range(self.pool)]
        v, j = cfg["n_verts"], cfg["n_joints"]
        self.out_shape = (rows, v, 3)
        # The needed work of the pool's calls, each by the distinct
        # subjects it indexes; a call's bound is the pool's mean.
        used = [int(idx.unique().numel()) for idx, _ in self.inputs]
        flops, moved = work.posed_work(rows, sum(used) / len(used), v, j)
        super().__init__(ctx, flops, moved, rows)
        params = program_params(self.arrays, cfg["hands"][0])
        shaped = core.specialize(params, self.subject_shapes)
        self.table = core.SubjectTable(
            shaped.v_shaped, shaped.joints, shaped.shape, shaped.pose_basis,
            shaped.lbs_weights, tuple(shaped.parents))
        self.idx32 = [idx.to(torch.int32) for idx, _ in self.inputs]
        self.forward = core.forward_posed_gather_fused

    def call(self, slot):
        _, pose = self.inputs[slot]
        with torch.no_grad():
            return self.forward(self.table, self.idx32[slot], pose)

    def release(self):
        del self.table, self.forward

    def segments(self, slot):
        idx, pose = self.inputs[slot]
        return [(self.arrays, pose, self.subject_shapes[idx])]
