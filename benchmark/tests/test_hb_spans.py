"""The readers of the program's library spans: ``library_ops_pct.forward``,
``launches_per_call.forward`` and ``entry_host_ms.forward``, on synthetic
timelines, on a whole traced CPU run, and on the card against the
profiler's own count of device operations."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, library_spans, timeline
from benchmark.tests.small import SMALL

US = 1_000   # ns
READERS = ("library_ops_pct.forward", "launches_per_call.forward",
           "entry_host_ms.forward")


def two_calls():
    """(host, device) of two chunked calls in a window of [0, 1000] µs:
    each a 100 µs entry span holding two 10 µs launch spans (a 30 µs K1
    each) and a 5 µs concatenation (10 µs); the second call pads too
    (a 2 µs fill and a 3 µs copy). One enqueuing call a device
    operation, inside its span."""
    host = [("bench.window", 0, 1000 * US)]
    device = []
    for c, t in enumerate((100, 500)):
        ops = [("mano.launch.k1", 10, 30), ("mano.launch.k1", 30, 30),
               ("mano.concat", 50, 10)]
        if c:
            ops[:0] = [("mano.pad", 1, 2), ("mano.pad", 3, 3)]
        host += [("bench.call", (t - 1) * US, (t + 101) * US),
                 ("mano.forward_chunked", t * US, (t + 100) * US),
                 ("cudaEventRecord", (t + 101) * US, (t + 101) * US + 500)]
        run = 200 + 400 * c        # the device runs the call from here
        for name, at, ns in ops:
            host += [(name, (t + at) * US, (t + at + 5) * US),
                     ("cudaLaunchKernel" if name != "mano.pad" or at == 3
                      else "cudaMemsetAsync",
                      (t + at + 1) * US, (t + at + 2) * US)]
            device.append((name + ".op", run * US, (run + ns) * US))
            run += ns
    return host, device


def run_of(calls, host=None, device=None, window=(0, 1000 * US)):
    if host is None:
        host, device = two_calls()
    return SimpleNamespace(
        timeline=timeline.Timeline(device, host, window),
        traced=SimpleNamespace(calls=calls))


def read(name, r):
    return harness.load_reader(name)(r)


def test_readers_on_synthetic_spans():
    r = run_of(2)
    # 2 x 10 + 5 µs of library ops against 4 x 30 µs of launches.
    assert read("library_ops_pct.forward", r) == pytest.approx(
        100 * 25 / 145)
    assert read("launches_per_call.forward", r) == 4.0   # median of 3, 5
    # 100 µs less two 5 µs launch spans, each call.
    assert read("entry_host_ms.forward", r) == pytest.approx(0.09)


def test_readers_select_the_window_and_its_root_entries():
    host, device = two_calls()
    # An entry called inside another is not a call, and spans outside
    # the window are not read.
    host += [("mano.forward_hands", 510 * US, 520 * US),
             ("mano.forward_chunked", 1100 * US, 1200 * US),
             ("mano.launch.k1", 1110 * US, 1120 * US)]
    r = run_of(2, host, device)
    assert read("launches_per_call.forward", r) == 4.0
    assert read("entry_host_ms.forward", r) == pytest.approx(0.09)
    assert [a for _, a, _ in library_spans.roots(r)] == [100 * US, 500 * US]
    names, ns = library_spans.paired(r)
    assert names[:3] == ["mano.launch.k1", "mano.launch.k1", "mano.concat"]
    assert ns[:3] == [30 * US, 30 * US, 10 * US]


def test_readers_pair_from_the_end_past_lost_records():
    """The profiler's records of the window's first device operations
    lost: the calls left over at the window's start pair with nothing,
    and a call's count still reads its enqueuing calls."""
    host, device = two_calls()
    r = run_of(2, host, device[2:])          # the first two K1s lost
    assert read("launches_per_call.forward", r) == 4.0
    assert read("library_ops_pct.forward", r) == pytest.approx(
        100 * 25 / 85)
    names, ns = library_spans.paired(r)
    assert names[0] == "mano.concat" and ns[0] == 10 * US
    # More lost than the bound allows, or more operations than calls.
    host += [("cudaLaunchKernel", 900 * US, 901 * US)] * library_spans.LOST
    assert library_spans.paired(run_of(2, host, device[2:])) is None


@pytest.mark.parametrize("case", ["calls", "untraced", "no_program",
                                  "unpaired", "no_device"])
def test_readers_find_nothing_to_read(case):
    r = run_of(2)
    names = READERS
    host, device = two_calls()
    if case == "calls":
        r = run_of(3)
    elif case == "untraced":
        r = SimpleNamespace(timeline=None, traced=None)
    elif case == "no_program":     # a commit without spans
        r = run_of(2, [e for e in host if not e[0].startswith("mano.")],
                   device)
    elif case == "unpaired":       # a device operation no call enqueued
        r = run_of(2, host, device + [("x", 990 * US, 991 * US)])
        names = READERS[:2]
    else:                          # off the card: no device operation
        r = run_of(2, host, [])
        names = READERS[:2]
    for name in names:
        assert read(name, r) is None, name


def test_span_names_are_the_programs():
    from mano_hand_tpu_torch.obs import spans

    assert library_spans.ENTRIES == {spans.ENTRY_CHUNKED, spans.ENTRY_HANDS,
                                     spans.ENTRY_POSED_GATHER}
    assert library_spans.LIBRARY_OPS == spans.LIBRARY_OPS
    assert library_spans.LAUNCH == spans.LAUNCH
    assert spans.LAUNCH.startswith(library_spans.SPAN)


def test_innermost_span_at_each_time():
    spans = [("a", 0, 10), ("b", 2, 5), ("c", 6, 8), ("d", 20, 30)]
    assert library_spans.innermost(spans, [0, 3, 5, 7, 9, 15, 25]) == [
        "a", "b", "a", "c", "a", None, "d"]


def test_readers_on_a_traced_cpu_run():
    """A whole ``--trace 1`` run of the chunked cell on the CPU, at the
    tests' small size (48 rows in chunks of 20: a partial chunk): one
    root entry span a traced call, inside the harness's own span around
    the call; no device operation, so nothing pairs."""
    line = harness.run_cell("mano_right.bulk_forward", 3141592653, 0.1,
                            True, torch.device("cpu"), time.perf_counter(),
                            overrides=SMALL["bulk_forward"])
    metrics = line["metrics"]
    assert line["correct"]
    assert 0 < metrics["entry_host_ms.forward"]["value"]
    assert "launches_per_call.forward" not in metrics
    assert "library_ops_pct.forward" not in metrics


# ------------------------------------------------------------ on the card
def _route_call(dev, route):
    """A small call of one forward route, as the benchmark's cells call
    it."""
    from mano_hand_tpu_torch.assets import mirror_params, synthetic_params
    from mano_hand_tpu_torch.models import core

    params = synthetic_params(seed=0, device=dev).astype(torch.float32)
    g = torch.Generator(device=dev).manual_seed(7)
    j, s = params.n_joints, params.n_shape

    def draw(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    if route.startswith("chunked"):
        b, chunk = {"chunked": (47, 20), "chunked_129": (129, 1),
                    "chunked_whole": (40, 40)}[route]
        pose, shape = draw(b, j, 3, scale=0.4), draw(b, s)
        return lambda: core.forward_chunked(params, pose, shape,
                                            chunk_size=chunk,
                                            use_pallas_fused_full=True)
    if route == "hands":
        stacked = core.stack_params(mirror_params(params), params)
        pose, shape = draw(2, 33, j, 3, scale=0.4), draw(2, 33, s)
        return lambda: core.forward_hands_pallas_fused_full(stacked, pose,
                                                            shape)
    # A table of 7 subjects baked in one batched specialize, as the
    # gather cell bakes its 1,000: its joints are a strided view.
    shaped = core.specialize(params, draw(7, s))
    table = core.SubjectTable(shaped.v_shaped, shaped.joints, shaped.shape,
                              shaped.pose_basis, shaped.lbs_weights,
                              tuple(shaped.parents))
    idx = torch.randint(0, 7, (45,), generator=g, device=dev,
                        dtype=torch.int32)
    pose = draw(45, j, 3, scale=0.4)
    return lambda: core.forward_posed_gather_fused(table, idx, pose)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["chunked", "chunked_129",
                                   "chunked_whole", "hands", "gather"])
def test_launches_per_call_is_the_profilers_device_ops(card, route):
    """Three calls of each route at small shapes under the benchmark's
    own capture: every device operation pairs with an enqueuing call,
    ``launches_per_call.forward`` is the profiler's device operations a
    call, each of them was enqueued inside one of the library's
    device-op spans, and the library's ops' share reads where the route
    has its own (the chunked route's padding and concatenation, the
    gather's copy of its table's strided joints)."""
    from torch.profiler import record_function

    call = _route_call(card, route)
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with timeline.capture(card) as cap:
            # Before the window, operations whose records the profiler
            # may lose at a capture's start.
            x = torch.zeros(1, device=card)
            for _ in range(64):
                x.add_(1)
            torch.cuda.synchronize()
            with record_function("bench.window"):
                for _ in range(3):
                    with record_function("bench.call"):
                        call()
                torch.cuda.synchronize()
    r = SimpleNamespace(timeline=timeline.Timeline.from_capture(cap.events),
                        traced=SimpleNamespace(calls=3))
    names, ns = library_spans.paired(r)
    assert read("launches_per_call.forward", r) == len(ns) / 3
    assert all(n in library_spans.LIBRARY_OPS
               or n.startswith(library_spans.LAUNCH) for n in names), names
    share = read("library_ops_pct.forward", r)
    assert (share > 0) == (route != "hands"), share
    assert 0 < read("entry_host_ms.forward", r)
