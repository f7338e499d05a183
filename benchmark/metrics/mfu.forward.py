"""The whole step's share of the chip's fp32 peak: the needed forward
FLOP (``benchmark/work.py``) of the meshes completed in the measured
window over its length (host clock: the untraced window that a
``--trace 1`` run makes before its traced one), against 67 TFLOP/s
(H100 SXM data sheet, at the card's power limit, which the run prints
beside it)."""


def read(r):
    peak = getattr(r.entry, "peak_flops", None)
    if r.timeline is None or peak is None:
        return None
    flops = r.entry.flops_per_mesh * r.entry.meshes_per_call * r.window.calls
    return 100.0 * flops / r.window.seconds / peak
