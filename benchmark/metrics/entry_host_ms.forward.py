"""Median host milliseconds the library spends in one call of its forward
entry outside its kernel launches: a root entry span's length less the
``mano.launch.*`` spans inside it (the program's own ranges in the
traced window's capture; ``benchmark/library_spans.py``): its checks,
caches, allocations, padding and copies."""

import statistics
from bisect import bisect_left, bisect_right

from benchmark import library_spans


def read(r):
    roots = library_spans.roots(r)
    if roots is None:
        return None
    launches = sorted((a, b) for n, a, b in library_spans.window_host(r)
                      if n.startswith(library_spans.LAUNCH))
    starts = [a for a, _ in launches]
    own = []
    for _, a, b in roots:
        inside = launches[bisect_left(starts, a):bisect_right(starts, b)]
        own.append(b - a - sum(y - x for x, y in inside if y <= b))
    return statistics.median(own) / 1e6
