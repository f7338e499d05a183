"""The port's worker-process supervision (``mano_hand_tpu_torch/edge/
fleet.py``) against the JAX package's ``edge/fleet.py``, on the CPU.

* ``WorkerSpec.argv``/``with_port`` and ``ProxySpec.argv`` flag for flag
  against JAX's — the module (``mano_hand_tpu_torch.cli``) and the
  port's global ``--device`` (JAX's ``--platform``) the only
  differences;
* ``WorkerProc``/``Fleet`` over a tiny fake worker script (the ``serve``
  stdout contract: a ready line, an exit line after SIGTERM, none after
  SIGKILL), each parse held against JAX's ``WorkerProc`` on the same
  script;
* JAX's quick ``FleetSupervisor`` cases (the storm budget, the sliding
  window, the torn-read hammer, a zero budget) on fake workers, the
  port's ledger held against JAX's;
* two ``python -m mano_hand_tpu_torch proxy`` processes on one lock:
  the active is SIGKILLed, the standby takes over with ``takeovers``
  1 and a ``ResilientStream`` loses no frame; ``status --server``
  against the pair mid-takeover returns rc 0.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from mano_hand_tpu.edge import fleet as jfleet
from mano_hand_tpu_torch.edge import fleet as pfleet

HOST = "127.0.0.1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --------------------------------------------------------------- argv
SPECS = [
    {},
    {"lanes": 2, "max_bucket": 8, "max_delay_ms": 1.0, "max_subjects": 32,
     "aot_dir": "/x/aot", "store_warm_capacity": 16, "warm_streams": True,
     "drain_timeout_s": 15.0, "port": 4321},
    {"asset": "a.npz", "side": "left", "no_warmup": True,
     "device_lock": "off", "max_queued": 0,
     "extra": ("--posed-kernel", "fused")},
]


def _normalize(argv, module, dev_flag):
    """argv less the interpreter, the module and the device flag pair."""
    assert argv[:3] == [sys.executable, "-m", module]
    out = list(argv[3:])
    if out and out[0] == dev_flag:
        out = out[2:]
    return out


@pytest.mark.parametrize("kw", SPECS, ids=["defaults", "drill", "extra"])
@pytest.mark.parametrize("device", ["", "cpu", "cuda"])
def test_worker_spec_argv_is_jax_s_flag_for_flag(kw, device):
    ours = pfleet.WorkerSpec(device=device, **kw)
    theirs = jfleet.WorkerSpec(platform=device, **kw)
    a = ours.argv()
    assert (a[3:5] == ["--device", device]) == bool(device)
    assert _normalize(a, "mano_hand_tpu_torch.cli", "--device") == \
        _normalize(theirs.argv(), "mano_hand_tpu.cli", "--platform")
    moved, jmoved = ours.with_port(5555), theirs.with_port(5555)
    assert moved is not ours and moved.port == jmoved.port == 5555
    assert ours.port == kw.get("port", 0)
    assert moved.extra == ours.extra and moved.extra_env == ours.extra_env
    assert moved.extra_env is not ours.extra_env
    assert _normalize(moved.argv(), "mano_hand_tpu_torch.cli",
                      "--device") == _normalize(
        jmoved.argv(), "mano_hand_tpu.cli", "--platform")


def test_proxy_spec_argv_is_jax_s():
    kw = dict(port=7000, lock_path="/tmp/p.lock",
              backends=[("w0", HOST, 1), ("w1", HOST, 2)],
              drain_timeout_s=3.0, upstream_timeout_s=9.0,
              extra=("--host", HOST))
    a, b = pfleet.ProxySpec(**kw).argv(), jfleet.ProxySpec(**kw).argv()
    assert a[2] == "mano_hand_tpu_torch.cli" and b[2] == "mano_hand_tpu.cli"
    assert a[3:] == b[3:]


# ------------------------------------------- WorkerProc over a fake worker
FAKE_WORKER = textwrap.dedent("""
    import json, os, signal, sys, threading
    mode = sys.argv[1]
    if mode == "die":
        sys.exit(3)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    print("boot noise, not json", flush=True)
    print(json.dumps({"edge": {"host": "127.0.0.1", "port": 4242,
                               "pid": os.getpid(),
                               "device_lock": "off"}}), flush=True)
    while not stop.wait(0.05):
        pass
    print(json.dumps({"edge_exit": {"drained": True,
                                    "counters": {"compiles": 0}}}),
          flush=True)
""")


def _fake_spec(module, script, mode):
    class Spec(module.WorkerSpec):
        def argv(self):
            return [sys.executable, script, mode]
    return Spec()


@pytest.fixture()
def fake_worker(tmp_path):
    path = tmp_path / "fake_worker.py"
    path.write_text(FAKE_WORKER)
    return str(path)


@pytest.mark.parametrize("module", [pfleet, jfleet], ids=["port", "jax"])
def test_worker_proc_parses_ready_and_exit_lines(module, fake_worker,
                                                  tmp_path):
    w = module.WorkerProc("w0", _fake_spec(module, fake_worker, "serve"),
                          stderr_path=str(tmp_path / "w0.stderr"))
    w.start().wait_ready(timeout_s=30.0)
    assert w.alive() and w.port == 4242
    assert w.ready_info["device_lock"] == "off"
    assert w.ready_info["pid"] == w.pid
    rep = w.terminate(timeout_s=30.0)
    assert rep == {"drained": True, "counters": {"compiles": 0}}
    assert w.returncode == 0 and not w.alive()
    assert w.stdout_lines[0] == "boot noise, not json"
    # SIGKILL: no exit line, by construction.
    k = module.WorkerProc("w1", _fake_spec(module, fake_worker, "serve"))
    k.start().wait_ready(timeout_s=30.0)
    k.kill()
    assert k.exit_report is None and k.returncode == -signal.SIGKILL
    # Death before the ready line: a bounded, reported failure.
    d = module.WorkerProc("w2", _fake_spec(module, fake_worker, "die"))
    with pytest.raises(RuntimeError, match="before its ready line"):
        d.start().wait_ready(timeout_s=30.0)


@pytest.mark.parametrize("module", [pfleet, jfleet], ids=["port", "jax"])
def test_fleet_boots_kills_and_stops_fake_workers(module, fake_worker,
                                                  tmp_path):
    specs = [_fake_spec(module, fake_worker, "serve") for _ in range(3)]
    fl = module.Fleet(specs, stderr_dir=str(tmp_path))
    fl.start(ready_timeout_s=60.0)
    try:
        assert sorted(fl.proxy.backends()) == ["w0", "w1", "w2"]
        assert all(w.port == 4242 for w in fl.workers.values())
        fl.kill_worker("w1")
        assert not fl.workers["w1"].alive()
    finally:
        reports = fl.stop(timeout_s=30.0)
    assert reports["w1"] is None
    assert reports["w0"] == reports["w2"] == {
        "drained": True, "counters": {"compiles": 0}}
    assert os.path.exists(tmp_path / "w0.stderr")


# ------------------------------------------------ supervisor (fake fleet)
class _FakeWorker:
    """Duck-typed WorkerProc: the surface the supervisor touches."""

    def __init__(self, name, *, alive=True, port=None, spec=None):
        self.name, self._alive, self.port, self.spec = (name, alive, port,
                                                        spec)
        self.exit_report = None
        self.pid = 4242

    def alive(self):
        return self._alive

    def kill(self):
        self._alive = False


class _FakeBoot:
    """Stands in for ``WorkerProc`` on the heal path: boots instantly;
    ``alive_after_boot=False`` is a dead-on-arrival flapper,
    ``lifetime_s`` a replacement that serves a while, then dies."""

    alive_after_boot = True
    lifetime_s = None

    def __init__(self, name, spec, *, env=None, stderr_path=None,
                 log=None):
        self.name, self.spec = name, spec
        self.port = getattr(spec, "port", None)
        self.pid = 31337
        self.exit_report = None
        self._alive = True
        self._death_at = None

    def start(self):
        return self

    def wait_ready(self, timeout_s=0.0):
        if not type(self).alive_after_boot:
            self._alive = False
        elif type(self).lifetime_s is not None:
            self._death_at = time.monotonic() + type(self).lifetime_s
        return self

    def alive(self):
        if self._death_at is not None \
                and time.monotonic() >= self._death_at:
            self._alive = False
        return self._alive

    def kill(self):
        self._alive = False


class _FakeFleet:
    proxy = None
    _stderr_dir = None
    _env = None

    def __init__(self, workers):
        self.workers = dict(workers)


def _supervisor(module, fleet, **kw):
    kw.setdefault("poll_interval_s", 0.001)
    kw.setdefault("probe_interval_s", 0.002)
    kw.setdefault("probe_timeout_s", 0.2)
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("ready_timeout_s", 1.0)
    kw.setdefault("spec_factory", lambda name, spec: spec)
    return module.FleetSupervisor(fleet, **kw)


def _boot(monkeypatch, module, alive=True, lifetime=None):
    boot = type("Boot", (_FakeBoot,), {"alive_after_boot": alive,
                                        "lifetime_s": lifetime})
    monkeypatch.setattr(module, "WorkerProc", boot)


def _ledger(f):
    """The deterministic part of ``load()["fleet"]``."""
    return {k: f[k] for k in ("restarts", "restarts_failed",
                              "deaths_detected", "incidents", "abandoned")
            } | {"left": f["budget"]["left"],
                 "incident": [i["incident"] for i in f["incident_log"]],
                 "heals": [(h["worker"], h["reason"]) for h in f["heals"]]}


def _storm(monkeypatch, module):
    _boot(monkeypatch, module, alive=False)      # dead on arrival
    fleet = _FakeFleet({"w0": _FakeWorker("w0", alive=False)})
    sup = _supervisor(module, fleet, restart_budget=1,
                      budget_window_s=3600.0)
    sup.start()
    try:
        deadline = time.monotonic() + 10.0
        while (sup.load()["fleet"]["incidents"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.005)
        first = sup.load()["fleet"]
        time.sleep(0.1)                          # no spin afterwards
        return _ledger(first), _ledger(sup.load()["fleet"])
    finally:
        sup.stop()


def test_restart_storm_degrades_with_one_incident_as_jax(monkeypatch):
    ours, theirs = _storm(monkeypatch, pfleet), _storm(monkeypatch, jfleet)
    assert ours == theirs
    first, later = ours
    assert first == later
    assert first["restarts"] == 1 and first["deaths_detected"] == 2
    assert first["incidents"] == 1 and first["abandoned"] == ["w0"]
    assert first["left"] == 0
    assert "budget exhausted" in first["incident"][0]


def _sliding(monkeypatch, module):
    _boot(monkeypatch, module, lifetime=0.2)
    fleet = _FakeFleet({"w0": _FakeWorker("w0", alive=False)})
    sup = _supervisor(module, fleet, restart_budget=1,
                      budget_window_s=0.05, failure_threshold=10_000)
    sup.start()
    try:
        deadline = time.monotonic() + 20.0
        while (sup.load()["fleet"]["restarts"] < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
        f = sup.load()["fleet"]
        return f["restarts"] >= 3, f["abandoned"], f["incidents"]
    finally:
        sup.stop()


def test_budget_window_slides_as_jax(monkeypatch):
    ours = _sliding(monkeypatch, pfleet)
    assert ours == _sliding(monkeypatch, jfleet) == (True, [], 0)


def _hammer(monkeypatch, module):
    _boot(monkeypatch, module, alive=True)
    dead_port = _free_port()                     # refused instantly
    spec = type("S", (), {"port": dead_port})()
    fleet = _FakeFleet({"w0": _FakeWorker("w0", alive=False,
                                          port=dead_port, spec=spec)})
    sup = _supervisor(module, fleet, restart_budget=10_000,
                      budget_window_s=3600.0,
                      spec_factory=lambda name, s: spec)
    torn = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            f = sup.load()["fleet"]
            if not (f["restarts"] == len(f["heals"]) == len(f["mttr_ms"])
                    and f["incidents"] == len(f["incident_log"])
                    and f["deaths_detected"]
                    >= f["restarts"] + f["incidents"]):
                torn.append(f)
                return

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    sup.start()
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while (sup.load()["fleet"]["restarts"] < 5
               and time.monotonic() < deadline):
            time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        f = sup.load()["fleet"]
        return (torn, f["restarts"] >= 5, f["heals"][0]["worker"],
                {h["reason"] for h in f["heals"]} <= {"exit", "probe"},
                all(h["mttr_ms"] >= 0.0 for h in f["heals"]),
                sorted(f), sorted(f["budget"]))
    finally:
        stop.set()
        sup.stop()


def test_supervisor_load_is_untorn_under_a_hammer_as_jax(monkeypatch):
    ours = _hammer(monkeypatch, pfleet)
    assert ours == _hammer(monkeypatch, jfleet)
    assert ours[:5] == ([], True, "w0", True, True)


def test_supervisor_rejects_a_zero_budget_as_jax():
    for module in (pfleet, jfleet):
        with pytest.raises(ValueError, match="restart_budget"):
            module.FleetSupervisor(_FakeFleet({}), restart_budget=0)


# ------------------------------------------- the active/standby proxy pair
def _status(port):
    return subprocess.run(
        [sys.executable, "-m", "mano_hand_tpu_torch", "status",
         "--platforms", "", "--server", f"{HOST}:{port}",
         "--server-timeout", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_proxy_pair_takeover_loses_no_frame_and_status_holds(tmp_path):
    """Two ``proxy`` processes on one lock in front of one in-process
    worker: the standby parks; SIGKILL of the active hands it the flock
    and the SAME port (takeover generation 1 in the lock file); a
    ``ResilientStream`` re-dials, resumes from its last confirmed pose,
    and numbers its frames on; ``status --server`` returns rc 0 mid-
    takeover (the error block or a role) and the survivor's story after.
    """
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.edge import (
        EdgeClient, EdgeServer, ProxyPair, ProxySpec, ResilientStream,
    )
    from mano_hand_tpu_torch.serving import ServingEngine

    params = synthetic_params(seed=0, device="cpu")
    rng = np.random.default_rng(23)
    betas = rng.normal(size=(10,)).astype(np.float32)
    targets = rng.normal(scale=0.1, size=(6, 16, 3)).astype(np.float32)
    eng = ServingEngine(params, device="cpu", max_bucket=4,
                        max_delay_s=0.001)
    eng.start()
    srv = EdgeServer(eng, port=0).start()
    sess = eng.open_stream(betas)
    want = [sess.step(t) for t in targets]
    sess.close()
    spec = ProxySpec(port=_free_port(),
                     lock_path=str(tmp_path / "proxy.lock"),
                     backends=[("w0", HOST, srv.port)],
                     upstream_timeout_s=120.0)
    pair = ProxyPair(spec, env={"PYTHONPATH": ROOT},
                     stderr_dir=str(tmp_path))
    rs = None
    try:
        pair.start(timeout_s=120.0)
        first = pair.active()
        assert first.active_info["takeovers"] == 0
        assert first.active_info["backends_up"] == 1
        standby = [p for p in pair.procs if p is not first][0]
        assert standby.ready_info["role"] == "standby"
        assert standby.active_info is None
        rs = ResilientStream(HOST, pair.port, timeout_s=60.0, betas=betas,
                             max_reconnects=8, reconnect_backoff_s=0.1,
                             reconnect_timeout_s=60.0,
                             frame_deadline_s=120.0)
        got = [rs.frame(t) for t in targets[:3]]
        victim = pair.kill_active()
        assert victim == first.name
        mid = _status(pair.port)                 # mid-takeover
        assert mid.returncode == 0, mid.stderr[-2000:]
        blk = json.loads(mid.stdout)["server"]
        assert ("error" in blk) or (blk.get("proxy_role")
                                    in ("active", "standby"))
        got += [rs.frame(t) for t in targets[3:]]
        survivor = pair.wait_active(timeout_s=60.0)
        assert survivor.name != victim
        assert survivor.active_info["takeovers"] == 1
        assert [f.frame for f in got] == list(range(6))
        assert rs.reconnects >= 1
        for f, w in zip(got, want):
            np.testing.assert_array_equal(f.pose, w.pose)
        with open(spec.lock_path) as f:
            assert json.load(f)["takeovers"] == 1
        with EdgeClient(HOST, pair.port, timeout_s=30.0) as cli:
            h = cli.healthz()
        assert (h["role"], h["proxy_role"], h["takeovers"]) == (
            "proxy", "active", 1)
        settled = _status(pair.port)
        assert settled.returncode == 0
        blk = json.loads(settled.stdout)["server"]
        assert (blk["role"], blk["proxy_role"], blk["takeovers"]) == (
            "proxy", "active", 1)
        rs.close()
        rs = None
        reports = pair.stop(timeout_s=30.0)
        assert reports[victim] is None
        assert reports[survivor.name]["takeovers"] == 1
        assert reports[survivor.name]["role"] == "active"
        assert reports[survivor.name]["drain"]["drained"] is True
    finally:
        if rs is not None:
            rs.abort()
        pair.stop(timeout_s=10.0)
        srv.drain(timeout_s=10.0)
        eng.stop()


def test_proxy_refuses_a_bad_backend_and_a_parked_standby_exits(tmp_path):
    """``proxy`` without a well-formed ``--backend`` exits 2 (JAX's
    rc); a standby parked on a held flock exits 0 on SIGTERM with its
    ``proxy_exit`` line (``served: False``), never having bound."""
    import fcntl

    cmd = [sys.executable, "-m", "mano_hand_tpu_torch", "proxy",
           "--port", str(_free_port()), "--lock",
           str(tmp_path / "p.lock")]
    bad = subprocess.run(cmd + ["--backend", "nope"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "NAME=HOST:PORT" in bad.stderr
    with open(tmp_path / "p.lock", "a+") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        proc = subprocess.Popen(cmd + ["--backend", f"w0={HOST}:1"],
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            ready = json.loads(proc.stdout.readline())["proxy"]
            assert ready["role"] == "standby" and ready["pid"] == proc.pid
            time.sleep(0.3)
            assert proc.poll() is None           # parked, not serving
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0
    assert json.loads(out.strip().splitlines()[-1]) == {
        "proxy_exit": {"role": "standby", "served": False}}
