"""The forward's share of its roofline: the least time the chip could
take for the traced calls' needed work (``benchmark/work.py``, the
larger of operations over the fp32 peak and bytes over the memory rate)
over the device time of every operation the traced calls launched, whatever
kernels implement the forward (in the traced window every device
operation belongs to a call)."""


def read(r):
    t, bound = r.timeline, getattr(r.entry, "bound_s_per_call", None)
    if t is None or bound is None or not t.device_op_s:
        return None
    return 100.0 * r.traced.calls * bound / t.device_op_s
