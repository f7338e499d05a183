"""The metric arithmetic on a synthetic timeline."""

from types import SimpleNamespace

import pytest

from benchmark import harness, timeline

MS = 1_000_000   # ns


def synthetic():
    # A 10 ms window: two calls, each a 3 ms and a 1 ms device op, the
    # second call's ops after a 2 ms gap in which the host waited.
    device = [("k1", 1 * MS, 4 * MS), ("cat", 4 * MS, 5 * MS),
              ("k1", 7 * MS, 10 * MS - MS // 2), ("cat", 9.5 * MS, 10 * MS)]
    host = [("bench.window", 0, 10 * MS),
            ("bench.call", 0, 1 * MS), ("aten::cat", MS // 2, MS),
            ("bench.wait", 5 * MS, 7 * MS),
            ("cudaEventSynchronize", 5 * MS, 7 * MS),
            ("bench.call", 7 * MS, 8 * MS)]
    return timeline.Timeline(device, host, (0, 10 * MS))


def run_of(tl):
    entry = SimpleNamespace(meshes_per_call=1000, flops_per_mesh=1e6,
                            bound_s_per_call=1e-3, peak_flops=67e12)
    window = SimpleNamespace(calls=2, seconds=2.0,
                             enqueue_ns=[1 * MS, 3 * MS, 2 * MS],
                             issued_s=[0.0, 0.9], done_s=[1.0, 2.0])
    return SimpleNamespace(
        cell="c", entry=entry, traffic={}, setup_s=7.5, window=window,
        traced=SimpleNamespace(calls=2), timeline=tl)


def read(name, r):
    return harness.load_reader(name)(r)


def test_timeline_busy_idle_and_breakdown():
    tl = synthetic()
    assert tl.window_s == pytest.approx(0.010)
    assert tl.busy_s == pytest.approx(0.007)     # [1,5] and [7,10] ms
    assert tl.device_op_s == pytest.approx(0.007)
    b = tl.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.0055)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps == {"bench.call": pytest.approx(0.001),
                    "bench.wait/cudaEventSynchronize": pytest.approx(0.002)}


def test_readers():
    r = run_of(synthetic())
    assert read("meshes_per_s", r) == pytest.approx(1000.0)
    assert read("setup_s", r) == 7.5
    assert read("enqueue_ms.forward", r) == pytest.approx(2.0)
    assert read("forward_roofline", r) == pytest.approx(100 * 2e-3 / 7e-3)
    assert read("device_idle_pct.forward", r) == pytest.approx(30.0)
    assert read("mfu.forward", r) == pytest.approx(
        100 * 1e6 * 2000 / 2.0 / 67e12)


def test_readers_find_nothing_without_a_trace_or_a_peak():
    r = run_of(None)
    for name in ("forward_roofline", "device_idle_pct.forward",
                 "mfu.forward"):
        assert read(name, r) is None
    r = run_of(synthetic())
    r.entry.peak_flops = r.entry.bound_s_per_call = None
    assert read("mfu.forward", r) is None
    assert read("forward_roofline", r) is None
    empty = timeline.Timeline([], synthetic().host, (0, 10 * MS))
    assert read("device_idle_pct.forward", run_of(empty)) is None
