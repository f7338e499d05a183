"""The library's spans in the traced window, each device operation
paired with the span that enqueued it: for the readers of
``library_ops_pct.forward``, ``launches_per_call.forward`` and
``entry_host_ms.forward``.

The program opens a profiler range (a span) around each call of a
forward route and around each device operation it enqueues
(``mano_hand_tpu_torch/obs/spans.py``), so the capture holds them among
its host events, beside the CUDA runtime calls that enqueued each device
operation. The window's one client thread enqueues on one stream, which
runs its operations in that order: the k-th enqueuing call of the window
made its k-th device operation. That pairs each operation with the
innermost span open at its enqueue, from the capture alone. The
profiler can lose the records of the first device operations of a
capture (2 to 5 of some 7,200 on an H100, while every enqueuing call
was recorded), so the pairing runs from the window's end: the calls
left over at its start, at most ``LOST``, pair with nothing.

There is nothing to read (None) without a traced window or device
operations, in a program without spans, where the root entry spans are
not one a traced call, and where the enqueuing calls and the device
operations do not pair so.
"""

from __future__ import annotations

import bisect
import re

#: The program's span names (``obs/spans.py``).
SPAN = "mano."
ENTRIES = frozenset({"mano.forward_chunked", "mano.forward_hands",
                     "mano.forward_posed_gather"})
LAUNCH = "mano.launch."
LIBRARY_OPS = frozenset({"mano.pad", "mano.concat", "mano.copy",
                         "mano.pack"})

#: CUDA runtime and driver calls that enqueue one device operation each
#: (a kernel, a copy, a fill), as the profiler names them.
ENQUEUE = re.compile(
    r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")

#: The most enqueuing calls at a window's start left without a device
#: operation's record: this many, or a hundredth of the window's calls.
LOST = 16


def window_host(r) -> list:
    """(name, start_ns, end_ns) of the host events inside the window."""
    lo, hi = r.timeline.window
    return [(n, a, b) for n, a, b in r.timeline.host if lo <= a and b <= hi]


def roots(r):
    """The window's root entry spans, (name, start_ns, end_ns) in order:
    entry spans inside no other. None unless one a traced call."""
    if r.timeline is None or r.traced is None:
        return None
    found, end = [], None
    for n, a, b in sorted((e for e in window_host(r) if e[0] in ENTRIES),
                          key=lambda e: (e[1], -e[2])):
        if end is None or a >= end:
            found.append((n, a, b))
            end = b
    return found if found and len(found) == r.traced.calls else None


def enqueues(r) -> list:
    """Ascending start times of the window's enqueuing calls."""
    return sorted(a for n, a, _ in window_host(r) if ENQUEUE.match(n))


def innermost(spans, times) -> list:
    """For each of the ascending ``times``: the name of the innermost of
    ``spans`` ((name, start, end), nested) open then, or None."""
    order = sorted((a, -b, n) for n, a, b in spans)
    names, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            a, nb, n = order[i]
            while stack and stack[-1][1] <= a:
                stack.pop()
            stack.append((a, -nb, n))
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def paired(r):
    """``(spans, ns)``: per recorded device operation of the window, in
    order, the innermost span open at its enqueue (None outside every
    span) and its device nanoseconds; None where nothing pairs (see the
    module's doc)."""
    if r.timeline is None or not r.timeline.device_ops or roots(r) is None:
        return None
    calls = enqueues(r)
    ops = sorted((a, b) for _, a, b in r.timeline.device
                 if a >= r.timeline.window[0])
    lost = len(calls) - len(ops)
    if not ops or not 0 <= lost <= max(LOST, len(calls) // 100):
        return None
    spans = [e for e in window_host(r) if e[0].startswith(SPAN)]
    return innermost(spans, calls[lost:]), [b - a for a, b in ops]


def per_root(r, times) -> list:
    """For each root entry span: how many of the ascending ``times`` it
    holds."""
    return [bisect.bisect_right(times, b) - bisect.bisect_left(times, a)
            for _, a, b in roots(r)]
