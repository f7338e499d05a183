"""Production traffic traces: deterministic, seeded, replayable.

The port's own copy of the JAX package's ``serving/traffic.py`` (that
module imports no JAX, but the port imports nothing of the JAX package).
A controller drill needs *shaped* load, and it needs the SAME trace
replayed under every leg (static, controlled, crashed), or the
comparison measures the generator, not the controller. This module makes
arrival traces as plain data (a tuple of ``(t_s, tier)`` pairs, offsets
from the trace's start) from a seed and a named shape:

* ``diurnal`` — one sinusoidal day compressed into the window: load
  swings between ``floor_fraction`` and 1.0 of ``peak_hz``.
* ``bursty`` — on/off square bursts (duty-cycled) over a baseline.
* ``flash_crowd`` — a steady baseline, then at ``crowd_at_fraction`` of
  the window the rate steps to ``peak_hz`` and decays exponentially back.

Arrivals come from an inhomogeneous Poisson process by Lewis thinning:
candidates at the peak rate, each kept with probability ``rate(t)/peak``.
All randomness is one ``random.Random(seed)`` (Mersenne Twister, stable
across platforms and Python builds), so the same (kind, seed, knobs)
give byte-identical ``serialize()`` output — the JAX package's bytes too.
Tier assignment rides the same stream (tier 0 with ``tier0_fraction``,
else tier 1).

No wall clock anywhere: traces are pure offsets, and the replayer
(``measure.py:control_drill_run``) owns the pacing.
"""

from __future__ import annotations

import math
import random
from typing import Callable, List, Tuple

__all__ = ["TRACE_KINDS", "make_trace", "serialize", "trace_stats"]

TRACE_KINDS = ("diurnal", "bursty", "flash_crowd")


def _rate_fn(kind: str, duration_s: float, base_hz: float,
             peak_hz: float, *, floor_fraction: float,
             burst_duty: float, burst_period_s: float,
             crowd_at_fraction: float, crowd_decay_s: float,
             ) -> Callable[[float], float]:
    """rate(t) in arrivals/s for one named shape; peak_hz is the thinning
    envelope, so every shape stays <= peak_hz."""
    if kind == "diurnal":
        lo = floor_fraction * peak_hz

        def rate(t: float) -> float:
            # One full "day": trough at t=0, peak mid-window.
            phase = 2.0 * math.pi * (t / duration_s)
            return lo + (peak_hz - lo) * 0.5 * (1.0 - math.cos(phase))
        return rate
    if kind == "bursty":
        def rate(t: float) -> float:
            in_burst = (t % burst_period_s) < burst_duty * burst_period_s
            return peak_hz if in_burst else base_hz
        return rate
    if kind == "flash_crowd":
        t0 = crowd_at_fraction * duration_s

        def rate(t: float) -> float:
            if t < t0:
                return base_hz
            spike = (peak_hz - base_hz) * math.exp(-(t - t0)
                                                   / crowd_decay_s)
            return base_hz + spike
        return rate
    raise ValueError(
        f"unknown trace kind {kind!r}; expected one of {TRACE_KINDS}")


def make_trace(kind: str, *, seed: int, duration_s: float,
               base_hz: float, peak_hz: float,
               tier0_fraction: float = 0.5,
               floor_fraction: float = 0.2,
               burst_duty: float = 0.25,
               burst_period_s: float = 1.0,
               crowd_at_fraction: float = 0.35,
               crowd_decay_s: float = 1.0,
               ) -> Tuple[Tuple[float, int], ...]:
    """A seeded arrival trace: a tuple of ``(t_offset_s, tier)`` sorted by
    time. Deterministic — same arguments, same bytes (``serialize``)."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if not 0.0 < base_hz <= peak_hz:
        raise ValueError(
            f"rates must satisfy 0 < base_hz <= peak_hz, got "
            f"({base_hz}, {peak_hz})")
    if not 0.0 <= tier0_fraction <= 1.0:
        raise ValueError(
            f"tier0_fraction must be in [0, 1], got {tier0_fraction}")
    rate = _rate_fn(kind, duration_s, base_hz, peak_hz,
                    floor_fraction=floor_fraction,
                    burst_duty=burst_duty,
                    burst_period_s=burst_period_s,
                    crowd_at_fraction=crowd_at_fraction,
                    crowd_decay_s=crowd_decay_s)
    rng = random.Random(seed)
    out: List[Tuple[float, int]] = []
    t = 0.0
    while True:
        # Lewis thinning: exponential gaps at the envelope rate, each
        # candidate accepted with rate(t)/peak.
        t += rng.expovariate(peak_hz)
        if t >= duration_s:
            break
        if rng.random() * peak_hz <= rate(t):
            tier = 0 if rng.random() < tier0_fraction else 1
            out.append((t, tier))
    return tuple(out)


def serialize(trace: Tuple[Tuple[float, int], ...]) -> bytes:
    """Canonical bytes for a trace — fixed-precision offsets, so the
    byte-identity test has no float-repr ambiguity (the control drill's
    sha256 receipt is taken from these bytes)."""
    lines = [f"{t:.9f} {tier}" for t, tier in trace]
    return ("\n".join(lines) + "\n").encode("ascii")


def trace_stats(trace: Tuple[Tuple[float, int], ...]) -> dict:
    """Headline numbers for logs and artifacts: arrivals by tier and the
    peak 100 ms-window rate (what the admission bound has to survive)."""
    n0 = sum(1 for _, tier in trace if tier == 0)
    peak = 0
    win: List[float] = []
    for t, _ in trace:
        win.append(t)
        while win and win[0] < t - 0.1:
            win.pop(0)
        peak = max(peak, len(win))
    return {
        "arrivals": len(trace),
        "tier0": n0,
        "tier1": len(trace) - n0,
        "peak_rate_hz": peak * 10.0,
        "duration_s": trace[-1][0] if trace else 0.0,
    }
