"""Median host milliseconds to enqueue one call of the library's forward
entry (the benchmark's own span around the call, host clock, in the
untraced window), without the wait for the call in flight before it."""

import statistics


def read(r):
    enq = r.window.enqueue_ns
    return statistics.median(enq) / 1e6 if enq else None
