"""Summarize a profiler trace and/or an engine span export into one
merged host+device timeline report: the port's copy of the JAX
package's ``scripts/trace_report.py``, with its flags, output and exit
codes, that also reads ``torch.profiler`` captures.

``utils/profiling.py:torch_trace(DIR, tracer=)`` writes a
``torch.profiler`` Chrome trace under ``DIR`` and the serving engine's
host-span timeline beside it (``DIR/engine.trace.json``, also written
by ``obs.write_trace_dir``; marked by a ``manoEngineTrace`` block). This
tool turns either — or BOTH, merged — into which ops burn the device
time, and where each REQUEST's wall time went (queue wait vs dispatch vs
device vs readback, per bucket/tier). The engine export alone still
yields the host-side stage breakdown.

Stdlib only (gzip + json over Chrome-trace JSON):

    python -m mano_hand_tpu_torch trace-report DIR [--top 15]
    python -m mano_hand_tpu_torch trace-report DIR --json

Ranks complete ('X') events by summed wall duration per (track, op
name). A track is a device track when its name is one (JAX's rule:
'/device:TPU:0', 'XLA Ops') or when it carries CUDA device work: events
whose ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, as
``torch.profiler`` (Kineto) labels them on its per-stream tracks. Host
tracks are reported separately so dispatch overhead is visible next to
device compute. Durations are SUMS over a track (nested slices
double-count parents; compare names at the same nesting level — kernel
rows are leaves, so their sums are honest).

Where a directory holds a ``torch_trace`` capture with device work, the
report also sums the device's idle gaps inside the capture's
``torch_trace.body`` span by the innermost program span open when each
gap begins, both on the profiler's clock ("outside" where none is
open): the engine's (``engine.trace.json``) or the library's (the
capture's own ``mano.*`` host ranges, ``obs/spans.py``).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_traces(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    # Gzipped Chrome traces (JAX's profiler) and plain JSON ones
    # (torch.profiler's, and the engine's span exports).
    hits = sorted(
        glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(path, "**", "*.trace.json"),
                    recursive=True))
    return hits


def load_capture(trace_path: str) -> dict:
    """One capture file as a dict ({} on damage); a truncated/corrupt
    file (a process killed mid-write) degrades to a warning, not a
    traceback. Gzip or plain JSON by suffix."""
    try:
        opener = (gzip.open if trace_path.endswith(".gz") else open)
        with opener(trace_path, "rt") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except Exception as e:  # gzip EOFError, JSONDecodeError, OSError
        print(f"skipping unreadable trace {trace_path}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return {}


def load_events(trace_path: str) -> list[dict]:
    return load_capture(trace_path).get("traceEvents", [])


#: ``utils/profiling.py``'s name of the body span of a ``torch_trace``
#: capture.
TRACE_BODY = "torch_trace.body"
#: The prefix of the library's span names (``obs/spans.py``).
LIBRARY_SPAN = "mano."


def summarize(events: list[dict]) -> dict:
    """Per (process, op name): total µs, count. Returns
    {process_name: [(name, total_us, count), ...] sorted by total}."""
    proc_names, thread_names = _track_names(events)
    totals: dict = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0.0, 0]))
    for e in events:
        if e.get("ph") != "X":
            continue
        track = _track(e, proc_names, thread_names)
        cell = totals[track][e.get("name", "?")]
        cell[0] += float(e.get("dur", 0.0))
        cell[1] += 1
    return {
        track: sorted(
            ((name, tot, cnt) for name, (tot, cnt) in per.items()),
            key=lambda row: -row[1],
        )
        for track, per in totals.items()
    }


#: ``cat`` of the events ``torch.profiler`` records ON the card: kernels
#: (replayed CUDA-graph kernels included), copies and fills.
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def _track_names(events: list[dict]) -> tuple[dict, dict]:
    proc_names: dict = {}
    thread_names: dict = {}
    for e in events:
        if e.get("ph") == "M":
            pid = e.get("pid")
            args = e.get("args") or {}
            if e.get("name") == "process_name":
                proc_names[pid] = args.get("name", str(pid))
            elif e.get("name") == "thread_name":
                thread_names[(pid, e.get("tid"))] = args.get("name", "")
    return proc_names, thread_names


def _track(e: dict, proc_names: dict, thread_names: dict) -> str:
    pid = e.get("pid")
    proc = proc_names.get(pid, str(pid))
    tname = thread_names.get((pid, e.get("tid")), "")
    return f"{proc}:{tname}" if tname else proc


def is_device_event(e: dict) -> bool:
    """A CUDA event on the card (by its ``cat``), not host work."""
    return str(e.get("cat", "")).lower() in DEVICE_CATEGORIES


def device_event_tracks(events: list[dict]) -> set:
    """The tracks carrying at least one complete CUDA device event."""
    proc_names, thread_names = _track_names(events)
    return {_track(e, proc_names, thread_names) for e in events
            if e.get("ph") == "X" and is_device_event(e)}


def is_device_track(track: str) -> bool:
    t = track.lower()
    return "tpu" in t or "/device" in t or "xla op" in t


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] no interval covers."""
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


def innermost(spans, times) -> list:
    """For each of the ascending ``times``, the name of the innermost of
    ``spans`` ((name, start, end)) open then, or "outside": one sweep
    (spans that overlap without nesting count as if the later one
    nested)."""
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
        names.append(stack[-1][2] if stack else "outside")
    return names


def capture_timeline(cap: dict):
    """(body (start, end), device intervals) of a ``torch.profiler``
    capture in µs since the Unix epoch (its ``ts`` plus its
    ``baseTimeNanoseconds``), or None without a ``TRACE_BODY`` span or
    device work."""
    base = cap.get("baseTimeNanoseconds")
    if base is None:
        return None
    base_us = base / 1e3
    body, device = None, []
    for e in cap.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        a = float(e.get("ts", 0.0)) + base_us
        b = a + float(e.get("dur", 0.0))
        if e.get("name") == TRACE_BODY:
            body = (a, b)
        elif is_device_event(e):
            device.append((a, b))
    return (body, device) if body is not None and device else None


def program_spans(cap: dict) -> list:
    """(name, start, end), in µs since the Unix epoch, of the program's
    spans in one file: an engine span export's complete events, or the
    library's ``mano.*`` host ranges in a ``torch.profiler`` capture (not
    the copies the profiler draws of them on the device's track); else
    []."""
    engine = "manoEngineTrace" in cap
    if not engine and "baseTimeNanoseconds" not in cap:
        return []
    base_us = 0.0 if engine else cap["baseTimeNanoseconds"] / 1e3
    spans = []
    for e in cap.get("traceEvents", []):
        name = str(e.get("name", "?"))
        if e.get("ph") != "X" or "ts" not in e or not engine and (
                not name.startswith(LIBRARY_SPAN)
                or str(e.get("cat", "")).startswith("gpu_")):
            continue
        a = float(e["ts"]) + base_us
        spans.append((name, a, a + float(e.get("dur", 0.0))))
    return spans


def idle_by_span(body, device, spans) -> dict:
    """The device's idle gaps inside ``body``, summed by the innermost
    program span open when each gap begins."""
    gaps = idle_gaps(device, *body)
    by = collections.defaultdict(lambda: [0.0, 0])
    for (a, b), name in zip(gaps, innermost(spans, [a for a, _ in gaps])):
        by[name][0] += b - a
        by[name][1] += 1
    return {"body_us": body[1] - body[0],
            "idle_us": sum(b - a for a, b in gaps), "gaps": len(gaps),
            "by_span": sorted(((n, us, c) for n, (us, c) in by.items()),
                              key=lambda row: (-row[1], row[0]))}


def show_idle_gaps(run: str, idle: dict, top: int) -> None:
    print(f"\n== device idle gaps by program span [{run}]  "
          f"(body {idle['body_us'] / 1e3:.3f} ms, idle "
          f"{idle['idle_us'] / 1e3:.3f} ms in {idle['gaps']} gaps)")
    rows = idle["by_span"][:top]
    width = max((len(n[:60]) for n, _, _ in rows), default=4)
    for name, us, cnt in rows:
        pct = 100.0 * us / idle["idle_us"] if idle["idle_us"] else 0.0
        print(f"  {name[:60]:<{width}}  {us / 1e3:9.3f} ms "
              f"{pct:5.1f}%  x{cnt}")


def show_stage_breakdown(run: str, engine: dict) -> None:
    """The engine export's per-(bucket, tier) stage table: where one
    request's wall time went — queue wait vs dispatch vs device vs
    readback (obs/trace.py stage semantics; 'device' on the
    unsupervised path includes pipeline wait)."""
    acc = engine.get("accounting") or {}
    stages = engine.get("stages") or {}
    cells = stages.get("by_bucket_tier") or {}
    print(f"\n== engine stage breakdown [{run}]  "
          f"({stages.get('complete_spans')} complete spans; "
          f"{acc.get('spans_closed')}/{acc.get('spans_started')} spans "
          f"closed, {acc.get('spans_open')} open, "
          f"{acc.get('incidents')} incidents)")
    if not cells:
        print("  (no complete spans in the ring)")
        return
    hdr = (f"  {'cell':<14} {'n':>5}  {'queue':>16} {'dispatch':>16} "
           f"{'device':>16} {'readback':>16}")
    print(hdr + "   (p50/p99 ms)")
    for key, c in cells.items():
        def pair(stage, c=c):
            return (f"{c.get(f'{stage}_p50_ms', 0.0):7.2f}/"
                    f"{c.get(f'{stage}_p99_ms', 0.0):8.2f}")
        print(f"  {key:<14} {c.get('n', 0):>5}  {pair('queue')} "
              f"{pair('dispatch')} {pair('device')} {pair('readback')}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="trace-report")
    ap.add_argument("path", help="trace dir (torch_trace / "
                                 "write_trace_dir DIR) or one "
                                 "*.trace.json[.gz]")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--all-tracks", action="store_true",
                    help="include host tracks in the table (device tracks "
                         "are always shown first)")
    args = ap.parse_args(argv)

    traces = find_traces(args.path)
    if not traces:
        print(f"no *.trace.json[.gz] under {args.path}", file=sys.stderr)
        return 1

    # Summarize PER capture file: pid namespaces are file-local (every
    # capture calls its device track pid 1), so concatenating events
    # would merge runs and double-count same-named ops. With more than
    # one capture, tracks are qualified by their run directory.
    summary: dict = {}
    cuda_tracks: set = set()   # keys of tracks holding CUDA device work
    engines: dict = {}   # run -> manoEngineTrace block (span exports)
    # Per directory: torch_trace captures' (body, device) and the program
    # spans in its files.
    captures: dict = collections.defaultdict(list)
    programs: dict = collections.defaultdict(list)
    for t in traces:
        cap = load_capture(t)
        events = cap.get("traceEvents", [])
        per = summarize(events)
        on_card = device_event_tracks(events)
        run = os.path.basename(os.path.dirname(t))
        timeline = capture_timeline(cap)
        if timeline is not None:
            captures[os.path.dirname(t)].append(timeline)
        programs[os.path.dirname(t)] += program_spans(cap)
        for track, rows in per.items():
            key = f"{run}:{track}" if len(traces) > 1 else track
            summary[key] = rows
            if track in on_card:
                cuda_tracks.add(key)
        eng = cap.get("manoEngineTrace")
        if isinstance(eng, dict) and eng.get("schema") == 1:
            engines[run if len(traces) > 1 else "engine"] = eng
        elif isinstance(eng, dict):
            print(f"{t}: engine trace schema {eng.get('schema')} is not "
                  "supported by this report (expected 1); its raw "
                  "traceEvents are still summarized", file=sys.stderr)
    if not summary and not engines:
        print("trace holds no complete events", file=sys.stderr)
        return 1

    def on_device(track: str) -> bool:
        return is_device_track(track) or track in cuda_tracks

    device = {k: v for k, v in summary.items() if on_device(k)}
    host = {k: v for k, v in summary.items() if not on_device(k)}
    idle = {}
    for path, timelines in captures.items():
        for i, (body, dev) in enumerate(timelines):
            run = os.path.basename(path) + (f"#{i}" if i else "")
            idle[run] = idle_by_span(body, dev, programs[path])

    if args.json:
        out = {
            "traces": traces,
            "tracks": {
                track: [
                    {"name": n, "total_us": round(tot, 1), "count": c}
                    for n, tot, c in rows[:args.top]
                ]
                for track, rows in {**device, **host}.items()
            },
        }
        if engines:
            out["engine"] = engines
        if idle:
            out["idle_gaps"] = {
                run: {**{k: round(v, 1) if k.endswith("_us") else v
                         for k, v in g.items() if k != "by_span"},
                      "by_span": [{"name": n, "total_us": round(us, 1),
                                   "count": c}
                                  for n, us, c in g["by_span"][:args.top]]}
                for run, g in idle.items()}
        print(json.dumps(out))
        return 0

    def show(track: str, rows) -> None:
        track_total = sum(tot for _, tot, _ in rows)
        print(f"\n== {track}  (sum {track_total / 1e3:.2f} ms over "
              f"{len(rows)} op names)")
        width = max((len(n[:60]) for n, _, _ in rows[:args.top]),
                    default=4)
        for name, tot, cnt in rows[:args.top]:
            pct = 100.0 * tot / track_total if track_total else 0.0
            print(f"  {name[:60]:<{width}}  {tot / 1e3:9.3f} ms "
                  f"{pct:5.1f}%  x{cnt}")

    if device:
        for track, rows in device.items():
            show(track, rows)
    else:
        print("(no device track found — host-only capture)")
    if args.all_tracks or not device:
        for track, rows in host.items():
            show(track, rows)
    # The merged-timeline half: engine span exports print their stage
    # breakdown AFTER the op tables, so device hot ops and per-request
    # queue/dispatch/device/readback waits read as one report.
    for run, eng in engines.items():
        show_stage_breakdown(run, eng)
    for run, g in idle.items():
        show_idle_gaps(run, g, args.top)
    return 0


def run(argv: list[str] | None = None) -> int:
    """``main`` for a command line: ``| head`` closing the pipe is not an
    error."""
    try:
        return main(argv)
    except BrokenPipeError:
        # Point stdout at devnull so the interpreter's shutdown flush
        # doesn't raise a second BrokenPipeError (exit 120 otherwise).
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(run())
