"""Incident flight recorder + timeline export: a copy of the JAX
package's ``obs/recorder.py`` (the port imports nothing of that
package).

The black-box half of the observability story: when something goes
wrong — a deadline kill, a failover, a shed burst, the poison path, a
watchdog fire — the numbers that explain it are the ones from JUST
BEFORE the incident, and by the time a human looks, the ring has moved
on. The ``FlightRecorder`` subscribes to the tracer's incident stream
and captures a bounded, schema-versioned artifact per trigger (recent
spans + runtime events + a counters snapshot); drills attach a trimmed
capture to their results so span accounting can be judged, and
``write_trace_dir`` exports the full Chrome-trace timeline for
``obs/trace_report.py`` to merge with a ``torch.profiler`` device
capture.

Artifact versioning follows the lattice-manifest rule
(io/export_aot.py): ``schema`` bumps on any shape change; consumers
judge only artifacts whose schema they know.

Clock note: captures carry BOTH the monotonic stamp (comparable with
span timestamps) and a wall-clock ISO label (for humans correlating
with external logs) — wall-clock is never used in any arithmetic.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional

FLIGHT_SCHEMA = 1

#: Default bound on in-memory captures a recorder retains (oldest
#: evicted): incidents during a long outage must not grow memory.
DEFAULT_KEEP = 8


def flight_record(tracer, counters=None, *, reason: str = "on_demand",
                  max_spans: int = 16, max_events: int = 64) -> dict:
    """One bounded flight-record artifact: tracer accounting, the most
    recent ``max_spans`` spans and ``max_events`` runtime events, and a
    counters snapshot when given. Small enough to ride inside a JSON
    result line (the drills attach one each); the full-ring export is
    ``write_trace_dir``'s job.

    The tracer half derives from ONE ``snapshot()`` (a single lock
    hold), so a capture taken mid-incident is internally consistent —
    its accounting, spans, and runtime events all describe the same
    instant (the ServingCounters torn-telemetry rule)."""
    from mano_hand_tpu_torch.obs.trace import (
        ACCOUNTING_KEYS, spans_from_events,
    )

    snap = tracer.snapshot()
    spans = spans_from_events(snap["events"], set(snap["open_spans"]))
    runtime = [[ts, name, fields]
               for ts, sid, name, fields in snap["events"] if sid == 0]
    return {
        "schema": FLIGHT_SCHEMA,
        "reason": reason,
        "t_monotonic": time.monotonic(),
        "wall_time_utc": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "accounting": {k: snap[k] for k in ACCOUNTING_KEYS},
        "recent_spans": spans[-max_spans:],
        "recent_runtime_events": runtime[-max_events:],
        "counters": (counters.snapshot()
                     if counters is not None else None),
    }


class FlightRecorder:
    """Auto-capture on tracer incidents; bounded in-memory history,
    optional on-disk dumps.

    >>> tracer = Tracer()
    >>> rec = FlightRecorder(tracer, counters, out_dir="traces/")
    >>> # ... incidents (deadline_kill / failover / shed_burst /
    >>> # watchdog) now each leave a flight_<seq>_<reason>.json ...
    >>> rec.captures[-1]["reason"]
    """

    def __init__(self, tracer, counters=None,
                 out_dir: Optional[str] = None,
                 keep: int = DEFAULT_KEEP):
        self.tracer = tracer
        self.counters = counters
        self.out_dir = Path(out_dir) if out_dir else None
        self.keep = max(1, int(keep))
        self.captures: List[dict] = []
        self._seq = 0
        tracer.on_incident(self._on_incident)

    def _on_incident(self, reason: str, fields: dict) -> None:
        self.capture(reason=reason)

    def capture(self, reason: str = "on_demand") -> dict:
        """One capture now (also the on-demand entry point)."""
        art = flight_record(self.tracer, self.counters, reason=reason)
        self._seq += 1
        art["seq"] = self._seq
        self.captures.append(art)
        del self.captures[:-self.keep]
        if self.out_dir is not None:
            try:
                self.out_dir.mkdir(parents=True, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in reason)[:40]
                path = self.out_dir / f"flight_{self._seq:04d}_{safe}.json"
                path.write_text(json.dumps(art))
            except OSError:
                # A full/readonly disk must not take the dispatch path
                # down with it — the in-memory capture stands.
                pass
        return art


def write_trace_dir(tracer, out_dir, counters=None,
                    reason: str = "final") -> dict:
    """Export the full timeline into ``out_dir``: the Chrome-trace
    engine span file (``engine.trace.json`` — the ``*.trace.json``
    suffix is what ``obs/trace_report.py`` globs) plus a final
    flight record. Returns ``{"engine_trace": path, "flight": path}``.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "engine.trace.json"
    trace_path.write_text(json.dumps(tracer.chrome_trace()))
    flight_path = out / "flight_final.json"
    flight_path.write_text(json.dumps(
        flight_record(tracer, counters, reason=reason)))
    return {"engine_trace": str(trace_path), "flight": str(flight_path)}
