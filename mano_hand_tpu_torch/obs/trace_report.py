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
    for t in traces:
        cap = load_capture(t)
        events = cap.get("traceEvents", [])
        per = summarize(events)
        on_card = device_event_tracks(events)
        run = os.path.basename(os.path.dirname(t))
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
