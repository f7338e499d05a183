"""What the entries share: the program's parameters, made from the
benchmark's arrays, and the bulk-forward check against the reference.

An entry is built from a run's context (``cfg``, ``traffic``, ``gen``,
``device``) and offers ``pool`` (input slots, ``POOL``), ``call(slot)`` (one call
into the program, enqueued), ``release()`` (drop the program's state
before the check), ``check(kept)`` (the numbers compared, from outputs
of the window) and ``control()`` (put the reference, in the nearest
precision below the configuration's, in the program's place), and the
work a call does: ``meshes_per_call``, ``flops_per_mesh``,
``bound_s_per_call`` and ``peak_flops`` (the last two None off the
card).
"""

from __future__ import annotations

import math

import torch

from benchmark import work
from benchmark.reference import mano

#: Input batches an entry draws in set-up and calls in turn.
POOL = 4
#: Rows of the reference a block, so that it fits beside a run's state.
CHECK_BLOCK = 4096


def program_params(arrays: dict, side: str):
    """The port's validated ``ManoParams`` over the benchmark's arrays
    (the tensors themselves, not copies)."""
    from mano_hand_tpu_torch.assets.schema import (
        ARRAY_FIELDS, ManoParams, validate)

    return validate(ManoParams(**{f: arrays[f] for f in ARRAY_FIELDS},
                               parents=tuple(arrays["parents"]), side=side))


class BulkForward:
    """A forward over ``rows_total`` meshes a call, judged row by row
    against the float64 reference; subclasses set ``pool``,
    ``rows_total`` and ``out_shape``, and give ``call`` and ``segments``."""

    def __init__(self, ctx, flops: int, moved: int, meshes: int):
        self.device = ctx.device
        self.meshes_per_call = meshes
        self.flops_per_mesh = flops / meshes
        # No published peak applies off the card (the CPU tests).
        self.peak_flops = self.bound_s_per_call = None
        if ctx.device.type == "cuda":
            name = torch.cuda.get_device_name(ctx.device)
            self.peak_flops = work.peaks(name)[0]
            self.bound_s_per_call = work.bound_s(flops, moved, name)

    def check(self, kept) -> dict:
        """``max_vertex_err_m``: the largest |program - reference| over
        every vertex coordinate of every kept output (inf for an output
        of the wrong shape or one that is not finite)."""
        err = 0.0
        for _, slot, out in kept:
            flat = out.reshape(-1, *out.shape[-2:])
            if tuple(flat.shape) != (self.rows_total, *out.shape[-2:]):
                return {"max_vertex_err_m": math.inf}
            for lo, hi, ref in self.reference_blocks(slot, "float64"):
                gap = (flat[lo:hi].double() - ref).abs()
                err = max(err, float(gap.nan_to_num(nan=math.inf).max()))
        return {"max_vertex_err_m": err}

    def control(self) -> None:
        """The reference in TF32 in the program's place."""
        def call(slot):
            out = torch.empty(self.out_shape, device=self.device)
            flat = out.reshape(-1, *out.shape[-2:])
            for lo, hi, ref in self.reference_blocks(slot, "tf32"):
                flat[lo:hi] = ref
            return out
        self.call = call

    def reference_blocks(self, slot: int, precision: str):
        """``(lo, hi, reference rows)`` over the output's flattened rows,
        from the subclass's ``segments(slot)``: (arrays, pose, shape) of
        consecutive rows, hand by hand."""
        base = 0
        for arrays, pose, shape in self.segments(slot):
            for lo, hi, ref in mano.forward_blocks(arrays, pose, shape,
                                                   precision, CHECK_BLOCK):
                yield base + lo, base + hi, ref
            base += pose.shape[0]
