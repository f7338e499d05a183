"""The port's network edge (``mano_hand_tpu_torch/edge/``) against the JAX
package's ``edge/``.

The wire protocol's encodings, error bodies, Retry-After policy and status
map are held byte for byte against JAX's ``edge/protocol.py``. A loopback
``EdgeServer`` over a ``device="cpu"`` port engine and the JAX
``EdgeServer`` over the JAX engine answer the same requests: the same
status, error kind and phase, Retry-After and ``/healthz`` key tree, and
results within 1e-5 of JAX's; the port's wire results equal its engine's
in-process ``submit``/``submit_frame`` (0.0). Disconnect cancellation and
the drain run on the port's side.

Every socket has a timeout, every thread join a bound, and every server is
drained in a ``finally``: a hung test must fail, not wait.
"""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from mano_hand_tpu.assets import synthetic_params as jax_synthetic
from mano_hand_tpu.edge import EdgeServer as JEdgeServer
from mano_hand_tpu.edge import protocol as jproto
from mano_hand_tpu.runtime import ChaosPlan as JChaosPlan
from mano_hand_tpu.runtime import DispatchPolicy as JDispatchPolicy
from mano_hand_tpu.serving.engine import ServingEngine as JEngine
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.edge import EdgeClient, EdgeError, EdgeServer
from mano_hand_tpu_torch.edge import protocol as proto
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.runtime import ChaosPlan, DispatchPolicy
from mano_hand_tpu_torch.serving import ServingEngine

HOST = "127.0.0.1"
TIMEOUT = 30.0
TOL = 1e-5


# ---------------------------------------------------------------- protocol
@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4) * 0.1,
    np.array([[1.5, -2.25]], dtype=np.float64),
    np.arange(5, dtype=np.int32),
    np.float32(3.0) * np.ones((), np.float32),
    np.zeros((0, 3), np.float32),
    np.arange(6, dtype=">f4").reshape(2, 3),
    np.asfortranarray(np.arange(6, dtype=np.float32).reshape(2, 3)),
], ids=["f32", "f64", "i32", "scalar", "empty", "big_endian", "fortran"])
def test_array_codec_is_byte_equal_to_jax(arr):
    enc = proto.encode_array(arr)
    assert enc == jproto.encode_array(arr)
    assert proto.dumps(enc) == jproto.dumps(enc)
    got = proto.decode_array(enc)
    want = jproto.decode_array(enc)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", [
    None, {"shape": [1]}, {"b64": "!!!", "shape": [1]},
    {"b64": "AAAA", "shape": [4], "dtype": "float32"},
    {"b64": "AAAAAA==", "shape": [1], "dtype": "nonsense"},
], ids=["none", "no_b64", "bad_b64", "size", "dtype"])
def test_decode_errors_are_jax_s(bad):
    with pytest.raises(ValueError) as ours:
        proto.decode_array(bad)
    with pytest.raises(ValueError) as theirs:
        jproto.decode_array(bad)
    assert str(ours.value) == str(theirs.value)


def test_status_map_headers_retry_after_and_error_body_are_jax_s():
    assert proto.KIND_STATUS == jproto.KIND_STATUS
    for name in ("EDGE_SCHEMA", "STREAM_UPGRADE", "PRIORITY_HEADER",
                 "DEADLINE_HEADER"):
        assert getattr(proto, name) == getattr(jproto, name), name
    for status in (101, 200, 400, 404, 405, 408, 413, 429, 500, 502, 503,
                   504, 599):
        assert proto.reason(status) == jproto.reason(status)
    loads = [None, {}, {"admission": {}},
             {"admission": {"0": "ok", "1": "busy", "2": "shed"}},
             {"admission": {"0": "shed", "1": "shed", "3": "shed",
                            "9": "shed"}}]
    for tier in range(0, 10):
        for load in loads:
            assert (proto.retry_after_s(tier, load)
                    == jproto.retry_after_s(tier, load)), (tier, load)
    for kw in ({}, {"phase": "stream"},
               {"phase": "admission", "flight": {"reason": "x"}}):
        assert (proto.dumps(proto.error_body("shed", "m", **kw))
                == jproto.dumps(jproto.error_body("shed", "m", **kw)))


# ----------------------------------------------------------------- servers
def _port_engine(**kw):
    return ServingEngine(synthetic_params(seed=0, device="cpu"),
                         device="cpu", max_bucket=4, max_delay_s=0.001,
                         tracer=Tracer(), **kw)


def _jax_engine(**kw):
    from mano_hand_tpu.obs import Tracer as JTracer

    return JEngine(jax_synthetic(seed=0).astype(np.float32), max_bucket=4,
                   max_delay_s=0.001, tracer=JTracer(), **kw)


def _drain(srv):
    report = srv.drain(timeout_s=5.0)
    assert report.get("drained"), report
    return report


def _http(port, method, path, body=b"", headers=None):
    """One raw HTTP round trip on a fresh connection: (status, lower-case
    headers, parsed body)."""
    conn = http.client.HTTPConnection(HOST, port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    if hdrs.get("content-type", "").startswith("application/json"):
        return resp.status, hdrs, json.loads(raw)
    return resp.status, hdrs, raw


def _summary(reply):
    status, hdrs, body = reply
    err = (body.get("error") or {}) if isinstance(body, dict) else {}
    return {"status": status, "retry_after": hdrs.get("retry-after"),
            "kind": err.get("kind"), "phase": err.get("phase"),
            "flight": isinstance(body, dict) and "flight" in body}


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


@pytest.fixture(scope="module")
def pair():
    """The port's and JAX's edges, each over its engine (bucket 4)."""
    eng, jeng = _port_engine(), _jax_engine()
    eng.warmup()
    jeng.warmup()
    srv = EdgeServer(eng, port=0).start()
    jsrv = JEdgeServer(jeng, port=0).start()
    try:
        yield eng, srv, jeng, jsrv
    finally:
        _drain(srv)
        _drain(jsrv)


def _pose(rng, n):
    return rng.normal(scale=0.4, size=(n, 16, 3)).astype(np.float32)


def _body(**arrays):
    return proto.dumps({k: (proto.encode_array(v)
                            if isinstance(v, np.ndarray) else v)
                        for k, v in arrays.items()})


def test_forward_and_posed_results_match_jax_and_in_process(pair):
    eng, srv, jeng, jsrv = pair
    rng = np.random.default_rng(0)
    betas = rng.normal(size=(10,)).astype(np.float32)
    cases = [dict(pose=_pose(rng, 2)),
             dict(pose=_pose(rng, 3), shape=rng.normal(
                 size=(3, 10)).astype(np.float32)),
             dict(pose=_pose(rng, 1)[0])]
    with EdgeClient(HOST, srv.port, timeout_s=TIMEOUT) as c, \
            EdgeClient(HOST, jsrv.port, timeout_s=TIMEOUT) as jc:
        for kw in cases:
            got = c.forward(kw["pose"], kw.get("shape"))
            want = jc.forward(kw["pose"], kw.get("shape"))
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.abs(got - want).max() <= TOL
            inproc = eng.submit(kw["pose"], kw.get("shape")).result(
                timeout=TIMEOUT)
            assert np.abs(got - inproc).max() == 0.0
        key, jkey = c.specialize(betas), jc.specialize(betas)
        assert key == jkey
        pose = _pose(rng, 2)
        got = c.forward(pose, subject=key, priority=1)
        assert np.abs(got - jc.forward(pose, subject=jkey)).max() <= TOL
        inproc = eng.submit(pose, subject=key).result(timeout=TIMEOUT)
        assert np.abs(got - inproc).max() == 0.0


def test_caller_errors_and_routes_answer_as_jax(pair):
    _, srv, _, jsrv = pair
    rng = np.random.default_rng(1)
    big = {"Content-Length": str(64 << 20)}
    cases = [
        ("POST", "/v1/forward", _body(pose=_pose(rng, 1), subject="nope")),
        ("POST", "/v1/forward", _body(pose=np.zeros((1, 3, 3),
                                                    np.float32))),
        ("POST", "/v1/forward", _body(shape=np.zeros((1, 10), np.float32))),
        ("POST", "/v1/forward", b"{not json"),
        ("POST", "/v1/forward", proto.dumps({"pose": {"b64": "!!"}})),
        ("POST", "/v1/forward", _body(pose=np.zeros((9, 16, 3),
                                                    np.float32))),
        ("POST", "/v1/specialize", _body(betas=np.zeros(3, np.float32))),
        ("POST", "/v1/specialize", b"{}"),
        ("GET", "/nope", b""),
        ("POST", "/healthz", b""),
        ("GET", "/v1/forward", b""),
        ("POST", "/v1/stream", b""),
    ]
    for method, path, body in cases:
        ours = _summary(_http(srv.port, method, path, body))
        theirs = _summary(_http(jsrv.port, method, path, body))
        assert ours == theirs, (method, path, body[:40])
        assert ours["status"] in (400, 404, 405), ours
    # Expired at admission: 504, kind expired, no flight (not a 5xx
    # incident with a tracer-less body either side).
    body = _body(pose=_pose(rng, 1))
    hdrs = {proto.DEADLINE_HEADER: "0.0"}
    ours = _summary(_http(srv.port, "POST", "/v1/forward", body, hdrs))
    theirs = _summary(_http(jsrv.port, "POST", "/v1/forward", body, hdrs))
    assert ours == theirs and ours["status"] == 504
    assert ours["kind"] == "expired"
    # A body past the bound: 413 before any read of it.
    for port in (srv.port, jsrv.port):
        with socket.create_connection((HOST, port), timeout=TIMEOUT) as s:
            s.sendall(("POST /v1/forward HTTP/1.1\r\nHost: x\r\n"
                       f"Content-Length: {big['Content-Length']}\r\n\r\n"
                       ).encode())
            head = s.recv(4096)
        assert head.startswith(b"HTTP/1.1 413"), head[:40]


def test_healthz_and_metrics_as_jax(pair):
    _, srv, _, jsrv = pair
    ours, theirs = _http(srv.port, "GET", "/healthz"), \
        _http(jsrv.port, "GET", "/healthz")
    assert ours[0] == theirs[0] == 200
    assert _key_tree(ours[2]) == _key_tree(theirs[2])
    assert ours[2]["status"] == theirs[2]["status"] == "serving"
    assert ours[2]["lanes"] is None and ours[2]["breaker"] is None
    status, hdrs, text = _http(srv.port, "GET", "/metrics")
    jstatus, jhdrs, _ = _http(jsrv.port, "GET", "/metrics")
    assert status == jstatus == 200
    assert hdrs["content-type"] == jhdrs["content-type"]
    assert b"mano_serving_dispatches" in text


def test_shed_is_429_with_jax_s_retry_after_and_no_dispatch():
    eng, jeng = _port_engine(max_queued=0), _jax_engine(max_queued=0)
    srv = EdgeServer(eng, port=0).start()
    jsrv = JEdgeServer(jeng, port=0).start()
    try:
        body = _body(pose=np.zeros((1, 16, 3), np.float32))
        for tier in (0, 1, 2, 5):
            hdrs = {proto.PRIORITY_HEADER: str(tier)}
            ours = _summary(_http(srv.port, "POST", "/v1/forward", body,
                                  hdrs))
            theirs = _summary(_http(jsrv.port, "POST", "/v1/forward",
                                    body, hdrs))
            assert ours == theirs, tier
            assert ours["status"] == 429 and ours["kind"] == "shed"
            assert int(ours["retry_after"]) == proto.retry_after_s(
                tier, eng.load())
        with EdgeClient(HOST, srv.port, timeout_s=TIMEOUT) as c:
            with pytest.raises(EdgeError) as e:
                c.forward(np.zeros((1, 16, 3), np.float32), priority=1)
        assert e.value.status == 429 and e.value.retry_after_s == 3
        assert eng.counters.dispatches == jeng.counters.dispatches == 0
        assert eng._thread is None
    finally:
        _drain(srv)
        _drain(jsrv)


def test_a_failed_dispatch_is_500_with_a_flight_record():
    eng = _port_engine(policy=DispatchPolicy(
        retries=0, chaos=ChaosPlan("error@0-"), cpu_fallback=False))
    jeng = _jax_engine(policy=JDispatchPolicy(
        retries=0, chaos=JChaosPlan("error@0-"), cpu_fallback=False))
    srv = EdgeServer(eng, port=0).start()
    jsrv = JEdgeServer(jeng, port=0).start()
    try:
        body = _body(pose=np.zeros((1, 16, 3), np.float32))
        ours = _http(srv.port, "POST", "/v1/forward", body)
        theirs = _http(jsrv.port, "POST", "/v1/forward", body)
        assert _summary(ours) == _summary(theirs)
        assert _summary(ours)["status"] == 500
        assert _summary(ours)["flight"]
        assert set(ours[2]["flight"]) == set(theirs[2]["flight"])
    finally:
        _drain(srv)
        _drain(jsrv)


def _stream_lines(port, lines):
    """Upgrade a connection and exchange NDJSON lines; returns replies."""
    with socket.create_connection((HOST, port), timeout=TIMEOUT) as s:
        f = s.makefile("rb")
        s.sendall((f"POST /v1/stream HTTP/1.1\r\nHost: x\r\n"
                   f"Upgrade: {proto.STREAM_UPGRADE}\r\n"
                   "Connection: Upgrade\r\nContent-Length: 0\r\n\r\n"
                   ).encode())
        status = f.readline()
        while f.readline() not in (b"\r\n", b"\n", b""):
            pass
        out = [status.split()[1].decode()]
        for line in lines:
            s.sendall(line + b"\n")
            out.append(json.loads(f.readline()))
        f.close()
    return out


def test_stream_errors_answer_as_jax(pair):
    _, srv, _, jsrv = pair
    lines = [proto.dumps({"op": "frame", "target": proto.encode_array(
                 np.zeros((16, 3), np.float32))}),
             proto.dumps({"op": "dance"}),
             proto.dumps({"op": "open", "betas": {"b64": "!!"}}),
             proto.dumps({"op": "open"}),
             proto.dumps({"op": "close"})]
    ours = _stream_lines(srv.port, lines)
    theirs = _stream_lines(jsrv.port, lines)
    assert ours[0] == theirs[0] == "101"
    for a, b in zip(ours[1:], theirs[1:]):
        assert _key_tree(a) == _key_tree(b)
        assert (a.get("error") or {}).get("kind") == \
            (b.get("error") or {}).get("kind")
    assert ours[-1] == {"event": "closed", "frames": 0}


def test_stream_frames_over_the_wire_equal_submit_frame(pair):
    eng, srv, _, _ = pair
    rng = np.random.default_rng(2)
    betas = rng.normal(size=(10,)).astype(np.float32)
    targets = rng.normal(scale=0.05, size=(3, 16, 3)).astype(np.float32)
    with EdgeClient(HOST, srv.port, timeout_s=120.0) as c:
        with c.open_stream(betas=betas) as ws:
            wire = [ws.frame(t) for t in targets]
    sess = eng.open_stream(betas)
    try:
        for t, wf in zip(targets, wire):
            ref = sess.submit_frame(t).result(timeout=120.0)
            assert wf.frame == ref.frame
            assert np.abs(wf.verts - ref.verts).max() == 0.0
            assert np.abs(wf.pose - ref.pose).max() == 0.0
    finally:
        sess.close()


def test_disconnect_cancels_and_drain_sweeps_idle_connections():
    eng = _port_engine(policy=DispatchPolicy(
        deadline_s=5.0, retries=0, chaos=ChaosPlan("sat:0.35@0-"),
        cpu_fallback=False))
    eng.warmup([1])
    srv = EdgeServer(eng, port=0).start()
    try:
        # A one-shot request whose socket dies inside the 0.35 s window.
        body = _body(pose=np.zeros((1, 16, 3), np.float32))
        s = socket.create_connection((HOST, srv.port), timeout=TIMEOUT)
        s.sendall((f"POST /v1/forward HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        time.sleep(0.08)
        s.close()
        dl = time.monotonic() + 5.0
        while eng.counters.cancelled < 1 and time.monotonic() < dl:
            time.sleep(0.01)
        assert eng.counters.cancelled == 1
        # An idle keep-alive client beside an in-flight request: the
        # drain resolves the request and sweeps the idle connection
        # inside its window.
        idle = EdgeClient(HOST, srv.port, timeout_s=TIMEOUT)
        assert idle.healthz()["ok"]
        res = {}

        def inflight():
            with EdgeClient(HOST, srv.port, timeout_s=TIMEOUT) as c:
                res["verts"] = c.forward(np.zeros((1, 16, 3), np.float32))

        t = threading.Thread(target=inflight, daemon=True)
        t.start()
        dl = time.monotonic() + 5.0
        while srv._active_requests < 1 and time.monotonic() < dl:
            time.sleep(0.001)
        t0 = time.monotonic()
        report = srv.drain(timeout_s=5.0)
        wall = time.monotonic() - t0
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert report["drained"] and report["within_timeout"], report
        assert wall < 3.0, wall
        assert res["verts"].shape == (1, 778, 3)
        with pytest.raises(OSError):
            socket.create_connection((HOST, srv.port), timeout=2.0)
        idle.close()
        acc = eng.tracer.accounting()
        assert acc["spans_open"] == 0
        assert acc["closed_by_kind"].get("cancelled") == 1
    finally:
        srv.drain(timeout_s=5.0)
