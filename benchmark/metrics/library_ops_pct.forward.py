"""The library's own device operations' share of the device time of the
operations its spans enqueued in the traced window: those enqueued
inside its padding, concatenation, operand-copy and repack spans, over
those and the ones inside its kernel-launch spans; each operation's
device time from the profiler, paired with its span by enqueue order
(``benchmark/library_spans.py``)."""

from benchmark import library_spans


def read(r):
    got = library_spans.paired(r)
    if got is None:
        return None
    own = kernels = 0
    for name, ns in zip(*got):
        if name in library_spans.LIBRARY_OPS:
            own += ns
        elif name is not None and name.startswith(library_spans.LAUNCH):
            kernels += ns
    if not own + kernels:
        return None
    return 100.0 * own / (own + kernels)
