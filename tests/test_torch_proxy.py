"""The port's fleet proxy (``mano_hand_tpu_torch/edge/proxy.py``) against
the JAX package's ``edge/proxy.py``.

Each scenario of JAX's proxy tests (``tests/test_fleet.py``) runs twice:
the port's ``EdgeProxy`` in front of port ``EdgeServer``s over
``device="cpu"`` port engines, and JAX's ``EdgeProxy`` in front of JAX
``EdgeServer``s over JAX engines. Deterministic backend failures come
from raw socket stubs (dead at connect, dead after dispatch, a canned
429, a stream that dies with its first frame in flight). Both sides must
give the same statuses, error kinds, Retry-After, proxy counters
(``_counter_dict``) and ``/healthz`` key trees, results within 1e-5 of
JAX's, and each side its own in-process bits (0.0). Streams fit vertex
targets (a joints-only fit leaves a bone's twist unobserved, where the
two packages part by ~7e-4 rad). The wire is also crossed both ways (the
port's proxy in front of a JAX server, JAX's in front of a port server),
and the port's proxy drains past an idle client in under 2 s.

Every socket has a timeout, every server and proxy is drained in a
``finally``: a hung test must fail, not wait.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.edge import Backend as JBackend
from mano_hand_tpu.edge import EdgeProxy as JEdgeProxy
from mano_hand_tpu.edge import EdgeServer as JEdgeServer
from mano_hand_tpu.obs import Tracer as JTracer
from mano_hand_tpu.serving.engine import ServingEngine as JEngine
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.edge import (
    Backend, EdgeClient, EdgeError, EdgeProxy, EdgeServer,
)
from mano_hand_tpu_torch.edge import protocol as proto
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.serving import ServingEngine

HOST = "127.0.0.1"
TIMEOUT = 120.0
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def _free_port() -> int:
    """A port just bound and released: a connect to it is refused."""
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Stub:
    """A raw threaded TCP backend that fails exactly where told:
    ``die_after_request`` reads a whole request and closes without a
    byte; ``shed_429`` answers a canned 429 with ``Retry-After: 7``;
    ``stream_die_first_frame`` speaks the upgrade and the open, then
    closes the moment the first frame line arrives (in flight)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.requests = 0
        self.frames_seen = 0
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((HOST, 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._one, args=(conn,),
                             daemon=True).start()

    def _read_request(self, rf) -> bool:
        length = 0
        if not rf.readline():
            return False
        while True:
            h = rf.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        if length:
            rf.read(length)
        self.requests += 1
        return True

    def _one(self, conn):
        conn.settimeout(30.0)
        rf = conn.makefile("rb")
        try:
            if not self._read_request(rf):
                return
            if self.mode == "shed_429":
                body = proto.dumps(proto.error_body(
                    "shed", "stub shed", phase="admission"))
                conn.sendall(
                    (f"HTTP/1.1 429 Too Many Requests\r\n"
                     f"Content-Type: application/json\r\n"
                     f"Retry-After: 7\r\nContent-Length: {len(body)}\r\n"
                     f"Connection: close\r\n\r\n").encode("latin-1")
                    + body)
            elif self.mode == "stream_die_first_frame":
                conn.sendall(
                    (f"HTTP/1.1 101 Switching Protocols\r\n"
                     f"Upgrade: {proto.STREAM_UPGRADE}\r\n"
                     f"Connection: Upgrade\r\n\r\n").encode("latin-1"))
                if not rf.readline():
                    return
                conn.sendall(proto.dumps(
                    {"event": "open", "stream_id": "stub-0"}) + b"\n")
                if rf.readline():
                    self.frames_seen += 1
        except OSError:
            pass
        finally:
            for closer in (rf.close, conn.close):
                try:
                    closer()
                except OSError:
                    pass

    def stop(self):
        try:
            self._srv.close()
        except OSError:
            pass


class Side:
    """One package's edge stack: engines, servers, and its proxy class."""

    def __init__(self, name, engines, server_cls, proxy_cls, backend_cls):
        self.name = name
        self.engines = engines
        self.servers = [server_cls(e, port=0).start() for e in engines]
        self.Server, self.Proxy, self.Backend = (server_cls, proxy_cls,
                                                 backend_cls)

    def proxy(self, *named_ports):
        return self.Proxy(
            [self.Backend(n, HOST, p) for n, p in named_ports],
            upstream_timeout_s=TIMEOUT).start()

    def close(self):
        for s in self.servers:
            s.drain(timeout_s=10.0)


def _port_engine():
    eng = ServingEngine(synthetic_params(seed=0, device="cpu"),
                        device="cpu", max_bucket=4, max_delay_s=0.001,
                        max_queued=32, tracer=Tracer())
    eng.start()
    return eng


def _jax_engine():
    eng = JEngine(jax_synthetic(seed=0).astype(np.float32), max_bucket=4,
                  max_delay_s=0.001, max_queued=32, tracer=JTracer())
    eng.start()
    return eng


@pytest.fixture(scope="module")
def sides():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    port = Side("port", [_port_engine(), _port_engine()], EdgeServer,
                EdgeProxy, Backend)
    jax = Side("jax", [_jax_engine(), _jax_engine()], JEdgeServer,
               JEdgeProxy, JBackend)
    try:
        yield port, jax
    finally:
        port.close()
        jax.close()
        torch.set_num_threads(threads)
    for side in (port, jax):
        for e in side.engines:
            acc = e.tracer.accounting()
            assert acc["spans_started"] == acc["spans_closed"], side.name
            assert acc["spans_open"] == 0, side.name


def _twin(sides, scenario):
    """Run ``scenario(side) -> dict`` on both stacks; hold every key but
    the arrays (``*_arr``) equal, and the arrays within 1e-5. Returns
    the port's record. A scenario reads its proxy's counters after the
    proxy's drain: ``requests_proxied`` counts a request once its
    connection handler is done, which may be after the client has the
    reply."""
    port, jax = (scenario(s) for s in sides)
    flat = {k: v for k, v in port.items() if not k.endswith("_arr")}
    assert flat == {k: v for k, v in jax.items()
                    if not k.endswith("_arr")}
    for k in port:
        if k.endswith("_arr"):
            assert np.abs(np.asarray(port[k], np.float64)
                          - jax[k]).max() <= TOL, k
    return port


def _pose(seed, n=1):
    return np.random.default_rng(seed).normal(
        scale=0.3, size=(n, 16, 3)).astype(np.float32)


def _betas(seed):
    return np.random.default_rng(seed).normal(size=(10,)).astype(
        np.float32)


def _verts_target(betas, seed):
    """A vertex target (a posed mesh of these betas): the stream fits
    it in both packages to within rounding."""
    p = synthetic_params(seed=0, device="cpu")
    with torch.no_grad():
        out = core.forward_batched(
            p, torch.from_numpy(_pose(seed)),
            torch.from_numpy(betas[None]))
    return out.verts[0].numpy()


# ------------------------------------------------------- one-shot relays
def test_dead_at_connect_reroutes_silently(sides):
    def run(side):
        srv = side.servers[0]
        px = side.proxy(("a_dead", _free_port()), ("b_live", srv.port))
        try:
            pose, betas = _pose(4), _betas(3)
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                got = c.forward(pose, shape=betas)
            with EdgeClient(HOST, srv.port, timeout_s=TIMEOUT) as c:
                direct = c.forward(pose, shape=betas)
            assert np.array_equal(got, direct)      # bitwise, each side
            assert px.reroutes >= 1
        finally:
            px.drain(timeout_s=10.0)
        return {"counters": px._counter_dict(), "verts_arr": got}

    rec = _twin(sides, run)
    assert rec["counters"]["upstream_failures"] == 0


def test_dead_after_dispatch_is_502_upstream_never_retried(sides):
    def run(side):
        stub = _Stub("die_after_request")
        px = side.proxy(("a_stub", stub.port),
                        ("b_live", side.servers[0].port))
        try:
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                with pytest.raises(EdgeError) as ei:
                    c.forward(_pose(5), shape=_betas(6))
        finally:
            px.drain(timeout_s=10.0)
            stub.stop()
        return {"status": ei.value.status, "kind": ei.value.kind,
                "counters": px._counter_dict(),
                "stub_requests": stub.requests}

    rec = _twin(sides, run)
    assert rec["status"] == 502 and rec["kind"] == "upstream"
    assert rec["counters"]["upstream_failures"] == 1
    assert rec["counters"]["reroutes"] == 0 and rec["stub_requests"] == 1


def test_429_and_its_retry_after_relay_verbatim(sides):
    def run(side):
        stub = _Stub("shed_429")
        px = side.proxy(("a_stub", stub.port),
                        ("b_live", side.servers[0].port))
        try:
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                with pytest.raises(EdgeError) as ei:
                    c.forward(_pose(7), shape=_betas(8))
        finally:
            px.drain(timeout_s=10.0)
            stub.stop()
        return {"status": ei.value.status, "kind": ei.value.kind,
                "retry_after": ei.value.retry_after_s,
                "counters": px._counter_dict()}

    rec = _twin(sides, run)
    assert (rec["status"], rec["kind"], rec["retry_after"]) == (
        429, "shed", 7)
    assert rec["counters"]["upstream_failures"] == 0
    assert rec["counters"]["reroutes"] == 0


def _raw(port, method, path, headers):
    conn = http.client.HTTPConnection(HOST, port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=b"{}", headers=headers)
        resp = conn.getresponse()
        body = json.loads(resp.read())
        return {"status": resp.status,
                "retry_after": resp.getheader("Retry-After"),
                "kind": body["error"]["kind"]}
    finally:
        conn.close()


@pytest.mark.parametrize("source", ["opinion", "none", "raises", "absent"])
def test_proxy_503s_carry_the_retry_after_source_as_jax(source):
    """The proxy's own three 503s — no routable backend for a relay, no
    routable backend for a specialize broadcast, and a request reaching a
    draining proxy — carry the source's Retry-After for the request's
    tier (load is None: the proxy has no engine); a source that answers
    None or raises, or none at all, gives no header."""
    calls = []

    def src(tier, load):
        calls.append((tier, load))
        if source == "raises":
            raise RuntimeError("sick controller")
        return None if source == "none" else 3 + tier

    kw = {} if source == "absent" else {"retry_after_source": src}
    recs = {}
    for name, cls in (("port", EdgeProxy), ("jax", JEdgeProxy)):
        px = cls([], upstream_timeout_s=TIMEOUT, **kw).start()
        try:
            got = []
            for tier in (0, 2):
                hdrs = {proto.PRIORITY_HEADER: str(tier),
                        "Content-Type": "application/json"}
                got.append(_raw(px.port, "POST", "/v1/forward", hdrs))
                got.append(_raw(px.port, "POST", "/v1/specialize", hdrs))
            px._draining = True       # the drain window, held open
            got.append(_raw(px.port, "GET", "/healthz",
                            {proto.PRIORITY_HEADER: "1"}))
            px._draining = False
        finally:
            px.drain(timeout_s=10.0)
        recs[name] = got
    assert recs["port"] == recs["jax"]
    assert [r["status"] for r in recs["port"]] == [503] * 5
    want = ([3, 3, 5, 5, 4] if source == "opinion" else [None] * 5)
    assert [None if r["retry_after"] is None else int(r["retry_after"])
            for r in recs["port"]] == want
    if source != "absent":
        assert [t for t, _ in calls] == [0, 0, 2, 2, 1] * 2
        assert all(load is None for _, load in calls)


# ------------------------------------------------------------- streams
def _frames(frames):
    return {"frames": [f.frame for f in frames],
            "pose_arr": np.stack([f.pose for f in frames]),
            "verts_arr": np.stack([f.verts for f in frames])}


def _reference(eng, betas, target, n):
    sess = eng.open_stream(betas, data_term="verts")
    try:
        return [sess.step(target) for _ in range(n)]
    finally:
        sess.close()


def test_migration_race_resends_the_frame_in_flight(sides):
    def run(side):
        stub = _Stub("stream_die_first_frame")
        px = side.proxy(("a_stub", stub.port),
                        ("b_live", side.servers[0].port))
        try:
            betas = _betas(11)
            target = _verts_target(betas, 12)
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                with c.open_stream(betas=betas, data_term="verts") as ws:
                    wire = [ws.frame(target) for _ in range(3)]
            ref = _reference(side.engines[0], betas, target, 3)
            for w, r in zip(wire, ref):
                assert np.array_equal(w.pose, r.pose), side.name
                assert np.array_equal(w.verts, r.verts), side.name
        finally:
            px.drain(timeout_s=10.0)
            stub.stop()
        return {"stub_frames": stub.frames_seen,
                "counters": px._counter_dict(), **_frames(wire)}

    rec = _twin(sides, run)
    assert rec["stub_frames"] == 1 and rec["frames"] == [0, 1, 2]
    assert rec["counters"]["migrations"] == 1
    assert rec["counters"]["migrated_frames"] == 1


def test_drain_backend_migrates_a_live_stream_warm(sides):
    def run(side):
        px = side.proxy(("a_live", side.servers[0].port),
                        ("b_live", side.servers[1].port))
        tr = side.engines[0].tracer
        before = tr.accounting()
        ws = None
        try:
            betas = _betas(21)
            target = _verts_target(betas, 22)
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                ws = c.open_stream(betas=betas, data_term="verts")
                first = ws.frame(target)
                hosted = len(px.backends()["a_live"].streams)
                report = px.drain_backend("a_live", timeout_s=30.0)
                dl = time.monotonic() + 10.0
                while px.migrations < 1 and time.monotonic() < dl:
                    time.sleep(0.01)
                moved = len(px.backends()["b_live"].streams)
                wire = [first] + [ws.frame(target) for _ in range(2)]
                ws.close()
                ws = None
            ref = _reference(side.engines[0], betas, target, 3)
            for w, r in zip(wire, ref):
                assert np.array_equal(w.pose, r.pose), side.name
                np.testing.assert_allclose(w.verts, r.verts, rtol=0,
                                           atol=1e-6)
            acc = tr.accounting()
        finally:
            if ws is not None:
                ws.abort()
            px.drain(timeout_s=10.0)
        return {"hosted": hosted, "moved": moved, "clean": report["clean"],
                "streams_migrated": report["streams_migrated"],
                "drained_spans_balanced": (
                    acc["spans_started"] - before["spans_started"]
                    == acc["spans_closed"] - before["spans_closed"]),
                "counters": px._counter_dict(), **_frames(wire)}

    rec = _twin(sides, run)
    assert rec["hosted"] == 1 and rec["moved"] == 1 and rec["clean"]
    assert rec["streams_migrated"] == 1 and rec["frames"] == [0, 1, 2]
    assert rec["drained_spans_balanced"]
    assert rec["counters"]["migrations"] == 1


def test_stream_open_prefers_warm_and_falls_back_when_all_cold(sides):
    def run(side):
        e0, e1 = side.engines
        cold = side.Server(e0, port=0, warm_streams=False).start()
        warm = side.Server(e1, port=0, warm_streams=True).start()
        cold2 = side.Server(e1, port=0, warm_streams=False).start()
        px = side.proxy(("a_cold", cold.port))
        px2 = side.proxy(("c_cold", cold.port), ("d_cold", cold2.port))
        out = {}
        try:
            px.add_backend(side.Backend("b_warm", HOST, warm.port))
            betas = _betas(41)
            target = _verts_target(betas, 42)
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                c.healthz()
                bes = px.backends()
                out["warm"] = [bes["a_cold"].stream_warm,
                               bes["b_warm"].stream_warm,
                               bes["b_warm"].boot_seq
                               > bes["a_cold"].boot_seq]
                with c.open_stream(betas=betas, data_term="verts") as ws:
                    out["placed"] = [len(px.backends()[n].streams)
                                     for n in ("a_cold", "b_warm")]
                    out["frame"] = ws.frame(target).frame
            with EdgeClient(HOST, px2.port, timeout_s=TIMEOUT) as c:
                c.healthz()
                out["all_cold"] = [px2.backends()[n].stream_warm
                                   for n in ("c_cold", "d_cold")]
                with c.open_stream(betas=betas, data_term="verts") as ws:
                    out["cold_frame"] = ws.frame(target).frame
        finally:
            for p in (px, px2):
                p.drain(timeout_s=10.0)
            for s in (cold, warm, cold2):
                s.drain(timeout_s=10.0)
        out["counters"] = px._counter_dict()
        out["counters2"] = px2._counter_dict()
        return out

    rec = _twin(sides, run)
    assert rec["warm"] == [False, True, True]
    assert rec["placed"] == [0, 1] and rec["frame"] == 0
    assert rec["all_cold"] == [False, False] and rec["cold_frame"] == 0


# ------------------------------------------------------ healthz + metrics
def test_healthz_aggregate_metrics_and_status_cli(sides):
    def run(side):
        px = side.proxy(("a_live", side.servers[0].port),
                        ("b_live", side.servers[1].port))
        try:
            with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c:
                h = c.healthz()
                text = c.metrics_text()
            return {"tree": _key_tree(h), "ok": h["ok"],
                    "role": h["role"], "proxy_role": h["proxy_role"],
                    "takeovers": h["takeovers"], "status": h["status"],
                    "backends": {n: (b["ok"], b["breaker"])
                                 for n, b in h["backends"].items()},
                    "counters": h["counters"],
                    "metric_names": sorted(
                        ln.split(" ")[0] for ln in text.splitlines()
                        if not ln.startswith("#"))}
        finally:
            px.drain(timeout_s=10.0)

    rec = _twin(sides, run)
    assert rec["ok"] is True and rec["role"] == "proxy"
    assert rec["proxy_role"] == "active" and rec["takeovers"] == 0
    assert rec["backends"] == {"a_live": (True, "healthy"),
                               "b_live": (True, "healthy")}
    # `status --server` against the port's proxy: its /healthz block.
    port = sides[0]
    px = port.proxy(("a_live", port.servers[0].port))
    try:
        res = subprocess.run(
            [sys.executable, "-m", "mano_hand_tpu_torch", "status",
             "--platforms", "", "--server", f"{HOST}:{px.port}",
             "--server-timeout", "30"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        blk = json.loads(res.stdout)["server"]
        assert blk["ok"] is True and blk["role"] == "proxy"
        assert set(blk["backends"]) == {"a_live"}
    finally:
        px.drain(timeout_s=10.0)


# ------------------------------------------------------- across the wire
@pytest.mark.parametrize("proxy_side,server_side", [(0, 1), (1, 0)],
                         ids=["port_proxy_jax_server",
                              "jax_proxy_port_server"])
def test_wire_compatible_both_ways(sides, proxy_side, server_side):
    """One package's proxy in front of the other's server: one-shot
    results, a specialize broadcast with a subject-keyed request, a
    stream, and the /healthz aggregate, each equal to the server
    package's own answers."""
    front, back = sides[proxy_side], sides[server_side]
    srv = back.servers[0]
    px = front.proxy(("w0", srv.port))
    try:
        pose, betas = _pose(31, 2), _betas(32)
        with EdgeClient(HOST, px.port, timeout_s=TIMEOUT) as c, \
                EdgeClient(HOST, srv.port, timeout_s=TIMEOUT) as d:
            assert np.array_equal(c.forward(pose, shape=betas),
                                  d.forward(pose, shape=betas))
            key = c.specialize(betas)
            assert key == d.specialize(betas)
            assert np.array_equal(c.forward(pose, subject=key),
                                  d.forward(pose, subject=key))
            h = c.healthz()
            assert h["role"] == "proxy" and h["backends"]["w0"]["ok"]
            target = _verts_target(betas, 33)
            with c.open_stream(betas=betas, data_term="verts") as ws:
                wire = [ws.frame(target) for _ in range(2)]
        ref = _reference(back.engines[0], betas, target, 2)
        for w, r in zip(wire, ref):
            assert w.frame == r.frame
            assert np.array_equal(w.pose, r.pose)
            assert np.array_equal(w.verts, r.verts)
        assert px._counter_dict()["frames_relayed"] == 2
    finally:
        px.drain(timeout_s=10.0)


# ------------------------------------------------------------------ drain
def test_drain_sweeps_an_idle_client_within_two_seconds(sides):
    """An idle keep-alive client must not hold the proxy's drain: the
    listener closes, the connection is swept, ``wait_closed`` waits at
    most 1 s (JAX's proxy awaits it first, which on Python 3.12 waits
    for every open connection)."""
    port = sides[0]
    px = port.proxy(("a_live", port.servers[0].port))
    idle = EdgeClient(HOST, px.port, timeout_s=TIMEOUT)
    try:
        assert idle.healthz()["ok"]
        t0 = time.monotonic()
        report = px.drain(timeout_s=1.0)
        wall = time.monotonic() - t0
        assert report["drained"] is True, report
        assert wall <= 2.0, wall
        with pytest.raises(OSError):
            socket.create_connection((HOST, px.port), timeout=2.0)
    finally:
        idle.close()


def test_a_down_backend_is_readmitted_without_traffic(sides):
    """A live worker whose breaker went DOWN comes back through the
    port proxy's own re-probe tick, with no request through the proxy.
    JAX's proxy re-probes only from a pick, so there it stays DOWN."""
    def run(side):
        px = side.proxy(("w0", side.servers[0].port))
        try:
            be = px.backends()["w0"]
            for _ in range(3):
                be.breaker.record_failure()
            down = be.routable()
            deadline = time.monotonic() + 3.0
            while not be.routable() and time.monotonic() < deadline:
                time.sleep(0.05)
            return down, be.breaker.state
        finally:
            px.drain(timeout_s=10.0)

    port, jax = sides
    assert run(port) == (False, "healthy")
    assert run(jax) == (False, "down")
