"""The port's ``trace-report`` (``mano_hand_tpu_torch/obs/trace_report.py``
and ``python -m mano_hand_tpu_torch trace-report``) against the JAX
package's ``scripts/trace_report.py`` run as a subprocess, on the JAX
test's fixtures (an XLA-style device capture, engine span exports): the
same text and the same ``--json``. Beyond JAX's: a ``torch.profiler``
capture reads cleanly, and CUDA-category events (kernels, copies, fills)
make their track a device track.
"""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mano_hand_tpu_torch import cli
from mano_hand_tpu_torch.obs import trace_report

ROOT = Path(__file__).parent.parent


def _write_trace(path: Path, events) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"displayTimeUnit": "ns", "traceEvents": events}, f)


def _xla_fixture(tmp_path: Path) -> Path:
    """``tests/test_trace_report.py``'s capture, the jax.profiler layout."""
    tdir = tmp_path / "trace"
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 1, "tid": 7, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 7, "name": "fused_full.3",
         "ts": 0, "dur": 900.0},
        {"ph": "X", "pid": 1, "tid": 7, "name": "fused_full.3",
         "ts": 1000, "dur": 850.0},
        {"ph": "X", "pid": 1, "tid": 7, "name": "dot.2",
         "ts": 2000, "dur": 300.0},
        {"ph": "X", "pid": 2, "name": "ExecuteSharded", "ts": 0,
         "dur": 5000.0},
        {"ph": "B", "pid": 1, "tid": 7, "name": "ignored", "ts": 0},
    ]
    _write_trace(tdir / "plugins" / "profile" / "run1" / "t.trace.json.gz",
                 events)
    return tdir


def _engine_trace(path: Path, n_spans=3, schema=1) -> None:
    """``tests/test_trace_report.py``'s engine span export (schema 1)."""
    pid = 9001
    events = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": "mano-serving-engine"}},
        {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
         "args": {"name": "tier 0"}},
    ]
    for i in range(n_spans):
        t0 = i * 10_000.0
        events.append({"ph": "X", "pid": pid, "tid": 0,
                       "name": "request/full/b8", "ts": t0, "dur": 900.0,
                       "args": {"terminal": "ok"}})
        for stage, off, dur in (("queue", 0, 500.0),
                                ("dispatch", 500, 50.0),
                                ("device", 550, 300.0),
                                ("readback", 850, 50.0)):
            events.append({"ph": "X", "pid": pid, "tid": 0,
                           "name": f"stage/{stage}", "ts": t0 + off,
                           "dur": dur})
    cell = {"n": n_spans}
    for stage, ms in (("queue", 0.5), ("dispatch", 0.05), ("device", 0.3),
                      ("readback", 0.05), ("total", 0.9)):
        for q in ("p50", "p99", "mean"):
            cell[f"{stage}_{q}_ms"] = ms
    block = {
        "schema": schema,
        "accounting": {"spans_started": n_spans, "spans_closed": n_spans,
                       "spans_open": 0, "spans_double_closed": 0,
                       "closed_by_kind": {"ok": n_spans},
                       "events_total": 6 * n_spans, "events_dropped": 0,
                       "ring_len": 6 * n_spans, "ring_capacity": 8192,
                       "incidents": 0},
        "stages": {"complete_spans": n_spans,
                   "by_bucket_tier": {"b8/tier0": cell}},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"displayTimeUnit": "ms",
                                "traceEvents": events,
                                "manoEngineTrace": block}))


def _jax(*argv):
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
         *map(str, argv)], capture_output=True, text=True, timeout=60)


def _port(capsys, *argv):
    rc = trace_report.main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _case(tmp_path, name):
    if name == "xla":
        return _xla_fixture(tmp_path)
    if name == "engine":
        tdir = tmp_path / "trace"
        _engine_trace(tdir / "engine.trace.json")
        return tdir
    if name == "merged":
        tdir = _xla_fixture(tmp_path)
        _engine_trace(tdir / "engine.trace.json")
        return tdir
    if name == "two_runs":
        tdir = _xla_fixture(tmp_path)
        _write_trace(tdir / "plugins" / "profile" / "run2" /
                     "t.trace.json.gz", [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "/device:TPU:0"}},
            {"ph": "M", "pid": 1, "tid": 7, "name": "thread_name",
             "args": {"name": "XLA Ops"}},
            {"ph": "X", "pid": 1, "tid": 7, "name": "fused_full.3",
             "ts": 0, "dur": 111.0}])
        return tdir
    if name == "unknown_schema":
        tdir = tmp_path / "trace"
        _engine_trace(tdir / "engine.trace.json", schema=99)
        return tdir
    if name == "truncated":
        tdir = _xla_fixture(tmp_path)
        bad = tdir / "plugins" / "profile" / "run0" / "t.trace.json.gz"
        bad.parent.mkdir(parents=True)
        good = (tdir / "plugins" / "profile" / "run1" /
                "t.trace.json.gz").read_bytes()
        bad.write_bytes(good[: len(good) // 2])
        return tdir
    raise AssertionError(name)


@pytest.mark.parametrize("flags", [(), ("--json",), ("--all-tracks",),
                                   ("--top", "1")])
@pytest.mark.parametrize("case", ["xla", "engine", "merged", "two_runs",
                                  "unknown_schema", "truncated"])
def test_same_report_as_jax_on_jax_fixtures(tmp_path, capsys, case, flags):
    path = _case(tmp_path, case)
    want = _jax(path, *flags)
    rc, out, err = _port(capsys, path, *flags)
    assert rc == want.returncode == 0
    assert out == want.stdout
    assert err == want.stderr


@pytest.mark.parametrize("case", ["missing", "empty_dir", "no_events"])
def test_error_cases_exit_like_jax(tmp_path, capsys, case):
    path = tmp_path / "nope"
    if case == "empty_dir":
        path.mkdir()
    elif case == "no_events":
        path.mkdir()
        (path / "x.trace.json").write_text(json.dumps(
            {"traceEvents": [{"ph": "M", "pid": 1, "name": "process_name",
                              "args": {"name": "p"}}]}))
    want = _jax(path)
    rc, out, err = _port(capsys, path)
    assert rc == want.returncode == 1
    assert (out, err) == (want.stdout, want.stderr)


def test_cli_trace_report(tmp_path, capsys):
    """``python -m mano_hand_tpu_torch trace-report`` with JAX's flags, in
    process; rc 1 on a missing directory."""
    path = _case(tmp_path, "merged")
    assert cli.main(["trace-report", str(path), "--json", "--top",
                     "2"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data == json.loads(_jax(path, "--json", "--top", "2").stdout)
    assert cli.main(["--device", "cpu", "trace-report",
                     str(tmp_path / "nope")]) == 1


def test_cli_trace_report_subprocess_closed_pipe(tmp_path):
    """The command line in a fresh process, piped into ``head``: rc 0
    and no BrokenPipe noise."""
    path = _case(tmp_path, "xla")
    proc = subprocess.run(
        ["bash", "-c", f"set -o pipefail; {sys.executable} -m "
                       f"mano_hand_tpu_torch trace-report {path} "
                       f"--all-tracks | head -1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "BrokenPipeError" not in proc.stderr


def test_cuda_categories_make_a_device_track(tmp_path, capsys):
    """A Kineto-style CUDA capture (stream tracks named by the profiler,
    not '/device'): kernels, copies and fills are device work; the
    launches on the host thread are not."""
    events = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7"}},
        {"ph": "M", "pid": 4242, "tid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 4242, "tid": 4242, "name": "thread_name",
         "args": {"name": "thread 4242 (python3)"}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void posed_kernel<128>(Args)", "ts": 10, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void posed_kernel<128>(Args)", "ts": 60, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pageable)", "ts": 100,
         "dur": 30.0},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7,
         "name": "Memset (Device)", "ts": 5, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242,
         "name": "cudaGraphLaunch", "ts": 0, "dur": 12.0},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242,
         "name": "aten::copy_", "ts": 0, "dur": 200.0},
    ]
    path = tmp_path / "cap" / "torch.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_report.device_event_tracks(events) == {"python3:stream 7"}
    assert trace_report.is_device_event(events[4])
    assert not trace_report.is_device_event(events[8])
    rc, out, _ = _port(capsys, path, "--json")
    tracks = json.loads(out)["tracks"]
    assert rc == 0
    assert tracks["python3:stream 7"][0] == {
        "name": "void posed_kernel<128>(Args)", "total_us": 80.0,
        "count": 2}
    rc, out, _ = _port(capsys, path)
    assert out.index("python3:stream 7") >= 0
    assert "aten::copy_" not in out          # host hidden by default
    rc, out, _ = _port(capsys, path, "--all-tracks")
    assert "aten::copy_" in out


def test_torch_profiler_capture_reads_cleanly(tmp_path, capsys):
    from mano_hand_tpu_torch.obs import Tracer
    from mano_hand_tpu_torch.utils.profiling import torch_trace

    tr = Tracer()
    s = tr.start("full", tier=0, rows=1)
    for name in ("launch", "dispatched", "readback"):
        tr.event(s, name, **({"bucket": 2} if name == "launch" else {}))
    tr.close(s, "ok", bucket=2)
    with torch_trace(tmp_path / "cap", tracer=tr):
        x = torch.ones(16, 16)
        (x @ x).sum()
    rc, out, err = _port(capsys, tmp_path / "cap")
    assert rc == 0 and "skipping" not in err
    assert "no device track found" in out         # a CPU capture
    assert "aten::mm" in out
    assert "engine stage breakdown" in out and "b2/tier0" in out
