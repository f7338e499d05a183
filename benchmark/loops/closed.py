"""The closed loop: one client, calls back to back.

Call ``i`` is enqueued once call ``i - depth`` has finished (its CUDA
event), so the card holds up to ``depth`` calls of work queued ahead
and a pause of the host shorter than that work leaves it busy. Once
``seconds`` have passed nothing more is sent; the window ends when every
call sent has completed, so a rate is all the window's work over all its
time. A seeded reservoir keeps ``keep`` of the window's outputs for the
check after the window.

Traffic parameters it reads: ``depth``, the calls in flight (default
``DEPTH``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from types import SimpleNamespace

import torch

#: Calls in flight where the mix names none: enough to enqueue a call
#: while the one before runs.
DEPTH = 2


class _HostEvent:
    """A stand-in for a timing ``torch.cuda.Event`` off the card: host
    work is done when the call returns, so recording is completing."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def run(entry, traffic: dict, seconds: float, device: torch.device, rng,
        keep: int, max_calls: int | None = None, annotate: bool = False):
    """Run calls until ``seconds`` have passed (or ``max_calls`` calls
    were made), ``depth`` in flight; wait for all of them. Returns the
    window's record: ``calls``; ``seconds``, host time from the first
    enqueue to the last completion; ``kept``, a reservoir of (call
    index, slot, output); and per call ``issued_s`` (host seconds from the window's start to the
    call's enqueue), ``enqueue_ns`` (host time the call took to enqueue)
    and ``done_s`` (device seconds from the window's start to the call's
    completion, from timing events)."""
    from torch.profiler import record_function

    span = record_function if annotate else (
        lambda _name: contextlib.nullcontext())
    depth = int(traffic.get("depth", DEPTH))
    inflight = collections.deque()
    events, kept, issued_ns, enqueue_ns = [], [], [], []
    origin = _event(device)
    i = 0
    t_start = time.perf_counter()
    t_start_ns = time.perf_counter_ns()
    origin.record()
    with span("bench.window"):
        while True:
            if max_calls is not None:
                if i >= max_calls:
                    break
            elif i and time.perf_counter() - t_start >= seconds:
                break
            if len(inflight) >= depth:
                with span("bench.wait"):
                    inflight.popleft().synchronize()
            slot = i % entry.pool
            e0 = time.perf_counter_ns()
            with span("bench.call"):
                out = entry.call(slot)
            e1 = time.perf_counter_ns()
            ev = _event(device)
            ev.record()
            inflight.append(ev)
            events.append(ev)
            issued_ns.append(e0 - t_start_ns)
            enqueue_ns.append(e1 - e0)
            if len(kept) < keep:
                kept.append((i, slot, out))
            else:
                j = rng.randrange(i + 1)
                if j < keep:
                    kept[j] = (i, slot, out)
            del out
            i += 1
        with span("bench.wait"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_start
    return SimpleNamespace(
        calls=i, seconds=window_s, kept=kept,
        issued_s=[t / 1e9 for t in issued_ns], enqueue_ns=enqueue_ns,
        done_s=[origin.elapsed_time(ev) / 1e3 for ev in events])
