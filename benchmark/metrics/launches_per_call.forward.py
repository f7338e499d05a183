"""Device operations one call of the library's forward entry enqueued:
the median over the traced window's root entry spans (the program's own
ranges) of the enqueuing CUDA calls inside each (kernel launches, copies
and fills), where the window's enqueuing calls pair with the profiler's
device operations (``benchmark/library_spans.py``)."""

import statistics

from benchmark import library_spans


def read(r):
    if library_spans.paired(r) is None:
        return None
    return statistics.median(
        library_spans.per_root(r, library_spans.enqueues(r)))
