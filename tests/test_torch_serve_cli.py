"""The ``serve-bench``, ``status`` and ``serve`` command lines of the port
against the JAX package's ``cli.py``.

``serve-bench``'s composition guards exit with JAX's codes and messages
(the port's with ``--device cpu``); its stdout is one JSON line under
``--trace`` and ``--metrics`` with JAX's keys (less the controller's
counters, the port has no controller yet). ``status`` probes the CPU,
degrades on a hung probe and a down server with rc 0, and re-renders
``--prom`` to JAX's text from one snapshot. ``serve`` and ``serve-bench``
refuse to serve from the CPU unless asked; ``serve`` stands down with
rc 2 on a busy card. The ``serve`` subprocess (ready line, requests,
``status --server``, SIGTERM drain) is ``slow``, as JAX's is.
"""

import contextlib
import json
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from mano_hand_tpu import cli as j_cli
from mano_hand_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent

#: Counter-snapshot keys the port's ``ServingCounters`` does not keep:
#: the closed-loop controller's (the port has no controller yet).
JAX_ONLY_COUNTERS = {"control_ticks", "control_actuations",
                     "control_reverts"}
#: ... and keeps beside JAX's: bf16-family batches.
PORT_ONLY_COUNTERS = {"dispatches_bf16", "dispatches_gathered"}


def _run(capsys, main, argv):
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


SB_GUARDS = [
    ["serve-bench", "--requests", "0"],
    ["serve-bench", "--min-rows", "0"],
    ["serve-bench", "--min-rows", "4", "--max-rows", "2"],
    ["serve-bench", "--max-rows", "64", "--max-bucket", "32"],
    ["serve-bench", "--overload", "--metrics", "m"],
    ["serve-bench", "--subjects", "2", "--metrics", "m"],
    ["serve-bench", "--streams", "2", "--metrics", "m"],
    ["serve-bench", "--chaos", "drill", "--metrics", "m"],
    ["serve-bench", "--cold-start", "--metrics", "m"],
    ["serve-bench", "--cold-start", "--chaos", "error@0"],
    ["serve-bench", "--cold-start", "--subjects", "2"],
    ["serve-bench", "--cold-start", "--deadline-s", "1"],
    ["serve-bench", "--cold-start"],
    ["serve-bench", "--streams", "2", "--chaos", "error@0"],
    ["serve-bench", "--streams", "2", "--aot-dir", "a"],
    ["serve-bench", "--streams", "2", "--deadline-s", "1"],
    ["serve-bench", "--overload", "--chaos", "error@0"],
    ["serve-bench", "--overload", "--subjects", "2"],
    ["serve-bench", "--overload", "--aot-dir", "a"],
    ["serve-bench", "--overload", "--deadline-s", "1"],
    ["serve-bench", "--chaos", "drill", "--subjects", "2"],
    ["serve-bench", "--chaos", "nonsense@@"],
    ["serve-bench", "--subjects", "2", "--aot-dir", "a"],
]


@pytest.mark.parametrize("argv", SB_GUARDS, ids=lambda a: " ".join(a[1:]))
def test_serve_bench_guards_exit_as_jax(capsys, argv):
    j = _run(capsys, j_cli.main, argv)
    p = _run(capsys, cli.main, ["--device", "cpu"] + argv)
    assert j[0] == 2, j
    assert p == j


def test_serve_and_serve_bench_refuse_the_cpu_without_asking(capsys,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve-bench", "--requests", "4"], ["serve"]):
        rc, out, err = _run(capsys, cli.main, argv)
        assert rc == 2 and out == ""
        assert "pass --device cpu" in err
    # `serve --control` is not there until the port has a controller.
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "serve", "--control"])
    assert e.value.code == 2


def test_serve_bench_line_under_trace_and_metrics(capsys, tmp_path):
    args = ["serve-bench", "--requests", "6", "--max-rows", "2",
            "--max-bucket", "4", "--trace", "{d}/trace", "--metrics",
            "{d}/metrics"]
    lines = {}
    for side, main, extra in (("jax", j_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / side
        rc, out, _ = _run(capsys, main, extra + [
            a.replace("{d}", str(d)) for a in args])
        assert rc == 0
        assert out.endswith("\n") and out.count("\n") == 1, out[-300:]
        lines[side] = json.loads(out)
    port, jax_line = lines["port"], lines["jax"]
    assert set(port) == (set(jax_line) - JAX_ONLY_COUNTERS) | \
        PORT_ONLY_COUNTERS
    assert port["backend"] == "cpu" and jax_line["backend"] == "cpu"
    assert set(port["trace_export"]) == set(jax_line["trace_export"])
    assert set(port["metrics_export"]) == set(jax_line["metrics_export"])
    for path in port["trace_export"].values():
        assert Path(path).exists()
    # status re-renders the persisted scrape; --prom gives JAX's text
    # from the same snapshot.
    mdir = str(tmp_path / "port" / "metrics")
    rc, ours, _ = _run(capsys, cli.main, ["status", "--metrics-dir", mdir,
                                          "--prom"])
    jrc, theirs, _ = _run(capsys, j_cli.main, ["status", "--metrics-dir",
                                               mdir, "--prom"])
    assert rc == jrc == 0 and ours == theirs
    assert "mano_serving_dispatches" in ours
    rc, out, _ = _run(capsys, cli.main, ["status", "--platforms", "",
                                         "--metrics-dir", mdir])
    report = json.loads(out)
    assert rc == 0 and report["metrics"]["metrics"] > 0
    assert report["metrics"]["path"].endswith("metrics.json")


def test_status_probes_the_cpu_as_jax(capsys):
    rc, out, _ = _run(capsys, cli.main, ["status", "--platforms", "cpu"])
    jrc, jout, _ = _run(capsys, j_cli.main, ["status", "--platforms", "cpu"])
    ours, theirs = json.loads(out), json.loads(jout)
    assert rc == jrc == 0
    assert ours["degraded"] is theirs["degraded"] is False
    assert set(ours) == set(theirs)
    # (JAX's harness runs 8 virtual CPU devices; the port counts one.)
    assert set(ours["probes"]["cpu"]) == set(theirs["probes"]["cpu"])
    assert ours["probes"]["cpu"] == {
        "ok": True, "devices": 1, "platform": "cpu", "device_kind": "cpu"}
    assert set(ours["host"]) == {"python", "platform", "torch", "numpy",
                                 "torch_cuda"}
    assert set(ours["goldens"]) == set(theirs["goldens"])
    assert ours["goldens"]["present"]
    # --prom without a readable --metrics-dir: JAX's message and rc.
    assert _run(capsys, cli.main, ["status", "--prom"]) == \
        _run(capsys, j_cli.main, ["status", "--prom"])


def test_status_degrades_on_a_hung_probe_and_a_down_server(capsys,
                                                           monkeypatch):
    # A probe that hangs is killed at --probe-timeout: the report
    # degrades, the command does not.
    monkeypatch.setattr(cli, "_STATUS_PROBE", "import time\ntime.sleep(60)")
    t0 = time.monotonic()
    rc, out, _ = _run(capsys, cli.main, [
        "status", "--platforms", "cpu", "--probe-timeout", "1",
        "--server", "127.0.0.1:9", "--server-timeout", "1"])
    assert time.monotonic() - t0 < 15.0
    report = json.loads(out)
    assert rc == 0 and report["degraded"] is True
    assert report["probes"]["cpu"]["killed"] is True
    assert "note" in report
    assert report["server"]["ok"] is False and "error" in report["server"]


def test_serve_stands_down_on_a_busy_card(capsys, monkeypatch, tmp_path):
    from mano_hand_tpu_torch.utils import devicelock

    monkeypatch.setattr(devicelock, "_LOCK_DIR", str(tmp_path))
    monkeypatch.setattr(devicelock, "LOCK_PATH", str(tmp_path / "l.lock"))
    claim = tmp_path / "l.priority"
    claim.write_text("{}")
    monkeypatch.setattr(devicelock, "CLAIM_PATH", str(claim))
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        rc, out, err = _run(capsys, cli.main, [
            "--device", "cpu", "serve", "--port", "0", "--max-bucket", "2",
            "--device-lock", "server"])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert rc == 2 and out == ""
    assert err.startswith("device busy:")


@contextlib.contextmanager
def _serve(argv, timeout_s=120.0):
    proc = subprocess.Popen(
        [sys.executable, "-m", "mano_hand_tpu_torch"] + argv,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=timeout_s)


@pytest.mark.slow
def test_serve_subprocess_ready_line_requests_and_sigterm_drain():
    from mano_hand_tpu_torch.edge import EdgeClient

    argv = ["--device", "cpu", "serve", "--port", "0", "--max-bucket",
            "4", "--posed-kernel", "fused", "--drain-timeout-s", "5"]
    with _serve(argv) as proc:
        ready = json.loads(proc.stdout.readline())
        assert set(ready["edge"]) == {"host", "port", "pid",
                                      "device_lock"}
        assert ready["edge"]["device_lock"] == "off"
        port = ready["edge"]["port"]
        rng = np.random.default_rng(0)
        with EdgeClient("127.0.0.1", port, timeout_s=30.0) as c:
            key = c.specialize(rng.normal(size=10).astype(np.float32))
            for n in (1, 3, 4):
                v = c.forward(rng.normal(scale=0.4, size=(n, 16, 3))
                              .astype(np.float32), subject=key)
                assert v.shape == (n, 778, 3)
        st = subprocess.run(
            [sys.executable, "-m", "mano_hand_tpu_torch", "status",
             "--platforms", "", "--server", f"127.0.0.1:{port}"],
            cwd=ROOT, capture_output=True, text=True, timeout=60)
        server = json.loads(st.stdout)["server"]
        assert server["ok"] and server["metrics"]["has_serving"]
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert time.monotonic() - t0 < 5.0 + 10.0
        exit_line = json.loads(out.strip().splitlines()[-1])["edge_exit"]
        assert exit_line["drained"] and exit_line["within_timeout"]
        assert exit_line["accounting"]["spans_open"] == 0
        assert set(exit_line["counters"]) == {"compiles", "aot_loads",
                                              "aot_load_failures"}
