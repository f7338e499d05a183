"""The traced window: a ``torch.profiler`` capture read into a timeline.

The benchmark drives the profiler itself (CPU and CUDA activity) around
a window of whole calls: the card is synchronised before the capture
starts and inside it at the end, and the harness launches nothing of its
own in it, so every device operation in the capture belongs to a call
that the window made. The host spans are the harness's own
``record_function`` ranges (``bench.window``, ``bench.call``,
``bench.wait``) and the operators the program ran under them.
"""

from __future__ import annotations

import collections
import contextlib
from types import SimpleNamespace

import torch

#: How many entries each list of the breakdown keeps.
TOP = 10


@contextlib.contextmanager
def capture(device: torch.device):
    """Profile the body; yields a namespace whose ``events`` is set to
    the capture's (name, is_device, start_ns, end_ns) tuples on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    out = SimpleNamespace(events=[])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield out
    finally:
        prof.stop()
    out.events = events_of(prof)


def events_of(prof) -> list:
    """(name, is_device, start_ns, end_ns) of every event of a stopped
    profiler. A device event is an operation that ran on the card
    (kernel, copy, fill); the ranges that ``record_function`` annotations
    leave on the device's timeline are not operations and are dropped."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = list(prof.profiler.kineto_results.events())
    annotations = {e.name() for e in raw
                   if e.device_type() != cuda and e.is_user_annotation()}
    events = []
    for e in raw:
        start, on_device = e.start_ns(), e.device_type() == cuda
        if on_device and (e.is_user_annotation() or e.name() in annotations
                          or "annotation" in kind(e)):
            continue
        events.append((e.name(), on_device, start, start + e.duration_ns()))
    return events


def kind(event) -> str:
    """The event's kineto activity type, where this torch exposes it."""
    get = getattr(event, "activity_type", None)
    return str(get()) if get is not None else ""


def union_length(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals, lo: int, hi: int) -> list:
    """(start, end) of the stretches of [lo, hi] that no interval covers."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


class Timeline:
    """Device operations and host spans of one traced window.

    ``device`` holds (name, start_ns, end_ns) of every device operation
    (kernels, copies, fills), ``host`` (name, start_ns, end_ns) of every
    host event, ``window`` the (start, end) of ``bench.window``."""

    def __init__(self, device_ops, host, window):
        self.device = device_ops
        self.host = host
        self.window = window

    @classmethod
    def from_capture(cls, events):
        device_ops = [(n, a, b) for n, d, a, b in events if d]
        host = [(n, a, b) for n, d, a, b in events if not d]
        spans = [(a, b) for n, a, b in host if n == "bench.window"]
        if not spans:
            raise RuntimeError("the capture holds no bench.window span")
        return cls(device_ops, host, spans[0])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return union_length((a, b) for _, a, b in self.device) / 1e9

    @property
    def device_op_s(self) -> float:
        """Summed device time of every operation (one stream: no two
        overlap, so this is the busy time counted per operation)."""
        return sum(b - a for _, a, b in self.device) / 1e9

    @property
    def device_ops(self) -> int:
        return len(self.device)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        of the window summed by what the host was doing when each gap
        began: the harness span and the innermost host event open then."""
        by_op = collections.Counter()
        for n, a, b in self.device:
            by_op[n] += (b - a) / 1e9
        gaps = idle_gaps([(a, b) for _, a, b in self.device], *self.window)
        by_host = collections.Counter()
        for (a, b), name in zip(gaps, self.host_activity([a for a, _ in gaps])):
            by_host[name] += (b - a) / 1e9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(TOP)]}

    def host_activity(self, times) -> list:
        """For each of the ascending ``times``: "<harness span>/<innermost
        host event>" open then, by one sweep over the host events (nested
        on the calling thread; an event of another thread that does not
        nest is attributed as if it did)."""
        spans = sorted((a, b, n) for n, a, b in self.host
                       if n in ("bench.call", "bench.wait"))
        inner = sorted((a, -b, n) for n, a, b in self.host
                       if not n.startswith("bench."))
        names, stack, si, ii = [], [], 0, 0
        for t in times:
            while si < len(spans) and spans[si][1] <= t:
                si += 1
            span = (spans[si][2] if si < len(spans) and spans[si][0] <= t
                    else "outside")
            while ii < len(inner) and inner[ii][0] <= t:
                a, nb, n = inner[ii]
                while stack and stack[-1][1] <= a:
                    stack.pop()
                stack.append((a, -nb, n))
                ii += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            names.append(f"{span}/{stack[-1][2]}" if stack else span)
        return names
