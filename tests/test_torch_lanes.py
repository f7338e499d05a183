"""The port's dispatch lanes (``serving/lanes.py``) on the CPU.

JAX's ``tests/test_lanes.py`` scenarios on a ``device="cpu"`` port engine
at 4 lanes: placement spreads over every lane; results are bit for bit the
port's single-context engine on the same batches (requests one at a time,
or the same burst coalesced behind a held dispatcher) and within 1e-6 m of
the JAX single-device engine; a ``%LANE`` chaos plan kills one lane and
every future still resolves through the sibling ladder, the CPU tier only
once every lane is down; failback builds nothing; ``load()["lanes"]`` is
one hold's snapshot and reaches the metrics export; a stream's warm start
stays bit-equal through a lane loss. One twin runs the same ``%LANE``
plan on a 2-lane port engine and a 2-lane JAX engine (over the harness's
virtual host devices) and holds their outcomes, per-lane counts, ladder
hops and CPU failovers equal. On the CPU a lane's programs are eager, so
what these tests show of the card (streams, graph pools) is its control
flow only; ``tests/test_torch_cuda.py`` holds the rest on the card.
"""

import threading
import time
import warnings
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from mano_hand_tpu import runtime as jrt
from mano_hand_tpu.obs import metrics as jmetrics
from mano_hand_tpu.parallel import mesh as jmesh
from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu.serving.engine import ServingError as JaxError
from mano_hand_tpu_torch import runtime as prt
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.obs import metrics as pmetrics
from mano_hand_tpu_torch.parallel import lane_devices
from mano_hand_tpu_torch.runtime import health
from mano_hand_tpu_torch.serving import ServingEngine, ServingError

N_LANES = 4
BUCKETS = [1, 2, 4]
TOL = 1e-6


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _betas(seed, n=10):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def _poses(n, seed=0, rows=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.4, size=(rows, 16, 3)).astype(np.float32)
            for _ in range(n)]


def _policy(rt, plan=None, threshold=2):
    return rt.DispatchPolicy(
        deadline_s=10.0, retries=1, backoff_s=0.005, backoff_cap_s=0.01,
        jitter=0.0,
        breaker=rt.CircuitBreaker(
            failure_threshold=threshold, probe_interval_s=0.001,
            respect_priority_claim=False),
        chaos=plan, cpu_fallback=True)


def _lane_engine(params32, lane_ok, plan=None, tracer=None, lanes=N_LANES,
                 **kw):
    kw.setdefault("max_bucket", BUCKETS[-1])
    kw.setdefault("max_delay_s", 0.001)
    return ServingEngine(
        params32, device="cpu", policy=_policy(prt, plan), tracer=tracer,
        lanes=lanes, lane_probe=lambda i: lane_ok[i], **kw)


def _single(params32, **kw):
    kw.setdefault("max_bucket", BUCKETS[-1])
    return ServingEngine(params32, device="cpu", max_delay_s=0.001, **kw)


@pytest.fixture(scope="module")
def reference(params32, params):
    """The port's single-context engine over the shared request universe
    (the bit-identity bar every lane test compares against), and the JAX
    single-device engine's results on the same requests."""
    betas = [_betas(s) for s in (1, 2, 3)]
    poses = _poses(8, seed=5)
    out = {"betas": betas, "poses": poses}
    for name, eng in (("port", _single(params32)),
                      ("jax", JaxEngine(params.astype(np.float32),
                                        max_bucket=BUCKETS[-1],
                                        max_delay_s=0.001))):
        with eng:
            keys = [eng.specialize(b) for b in betas]
            out[name] = {
                "posed": [eng.forward(p, subject=keys[i % 3])
                          for i, p in enumerate(poses)],
                "full": [eng.forward(p, betas[i % 3])
                         for i, p in enumerate(poses)]}
    out["posed"], out["full"] = out["port"]["posed"], out["port"]["full"]
    return out


def _runtime(tr):
    """(name, fields) of the tracer's span-less events, oldest first."""
    return [(name, fields or {}) for _, sid, name, fields
            in tr.snapshot()["events"] if not sid]


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- devices
def test_lane_devices_round_robin_and_errors():
    cpu = torch.device("cpu")
    assert lane_devices(platform="cpu") == [cpu]
    assert lane_devices(4, platform="cpu") == [cpu] * 4
    devs = lane_devices(3, devices=["cpu", "meta"])
    assert devs == [cpu, torch.device("meta"), cpu]
    # JAX's rules: an explicit n oversubscribes round-robin.
    jdevs = jmesh.lane_devices(3, devices=["a", "b"])
    assert jdevs == ["a", "b", "a"]
    for fn in (lambda: lane_devices(0, platform="cpu"),
               lambda: jmesh.lane_devices(0, devices=["a"])):
        with pytest.raises(ValueError, match="lane count must be >= 1"):
            fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lane_devices(2)


# ------------------------------------------------------------- the scenarios
def test_lanes_bit_identical_and_balanced(params32, reference):
    """Placement spreads traffic over every lane; each lane's programs
    serve the single-context engine's bits on both families and stay
    within 1e-6 m of the JAX engine; warm steady state builds nothing."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    with eng:
        keys = [eng.specialize(b) for b in reference["betas"]]
        eng.warmup(BUCKETS)
        eng.warmup_posed(BUCKETS)
        warm = eng.counters.compiles
        got_posed = [eng.forward(p, subject=keys[i % 3])
                     for i, p in enumerate(reference["poses"])]
        got_full = [eng.forward(p, reference["betas"][i % 3])
                    for i, p in enumerate(reference["poses"])]
        assert eng.counters.compiles == warm   # zero steady builds
        snap = eng.load()["lanes"]
    _equal(got_posed, reference["posed"])
    _equal(got_full, reference["full"])
    for got, want in ((got_posed, reference["jax"]["posed"]),
                      (got_full, reference["jax"]["full"])):
        err = max(float(np.abs(g.astype(np.float64) - w).max())
                  for g, w in zip(got, want))
        assert err <= TOL
    assert snap["n_lanes"] == N_LANES
    assert snap["n_devices"] == 1              # four lanes on the one CPU
    per = snap["per_lane"]
    assert [p["lane"] for p in per] == list(range(N_LANES))
    assert all(p["assigned"] >= 1 for p in per)   # round-robin spread
    assert {p["device"] for p in per} == {"cpu"}
    assert snap["assigned_total"] == sum(p["assigned"] for p in per)


def test_held_burst_equals_the_single_engine(params32, reference):
    """The same burst, coalesced behind a held dispatcher into the same
    batches, through 4 lanes and through the single context: bit for bit,
    every request, both families."""
    poses = _poses(12, seed=17, rows=1) + _poses(6, seed=18, rows=2)
    out = {}
    for name, eng in (("lanes", _lane_engine(params32, [True] * N_LANES)),
                      ("single", _single(params32))):
        keys = [eng.specialize(b) for b in reference["betas"]]
        eng.start = lambda eng=eng: eng      # hold the dispatcher
        futs = [eng.submit(p, subject=keys[i % 3]) if i % 3 else
                eng.submit(p, reference["betas"][i % 2])
                for i, p in enumerate(poses)]
        del eng.start
        with eng:
            out[name] = [f.result(timeout=60) for f in futs]
            out[name + "_mixed"] = eng.counters.mixed_subject_batches
    _equal(out["lanes"], out["single"])
    assert out["lanes_mixed"] == out["single_mixed"] >= 1


def test_lane_loss_ladder_failover_and_recompile_free_failback(
        params32, reference):
    """Kill exactly one lane (%LANE chaos and its probe forced false):
    every future resolves through a healthy sibling (never the CPU tier)
    with the single context's bits; clear the fault and the lane serves
    again after its re-probe; the whole cycle builds nothing."""
    lane_ok = [True] * N_LANES
    plan = prt.ChaosPlan()
    tr = Tracer()
    eng = _lane_engine(params32, lane_ok, plan=plan, tracer=tr)
    kill = 1
    try:
        with eng:
            keys = [eng.specialize(b) for b in reference["betas"]]
            eng.warmup(BUCKETS)
            eng.warmup_posed(BUCKETS)
            warm = eng.counters.compiles
            lane_ok[kill] = False
            plan.schedule(f"error@0-%{kill}")
            n = len(reference["poses"])
            got = [eng.forward(p, subject=keys[(i % n) % 3])
                   for i, p in enumerate(reference["poses"] * 3)]
            _equal(got, reference["posed"] * 3)
            snap = eng.load()["lanes"]
            per = {p["lane"]: p for p in snap["per_lane"]}
            assert per[kill]["state"] == health.DOWN
            assert per[kill]["failovers_out"] >= 1
            assert sum(p["failovers_in"] for p in snap["per_lane"]) >= 1
            assert sum(p["cpu_failovers"] for p in snap["per_lane"]) == 0
            assert eng.counters.failovers == 0
            killed = eng._get_lanes().lanes[kill]
            assert killed.breaker.consecutive_failed_probes >= 1
            assert (killed.breaker.probe_wait_s()
                    > killed.breaker.probe_interval_s)
            plan.clear()
            lane_ok[kill] = True
            deadline = time.monotonic() + 30.0
            while killed.breaker.state != health.HEALTHY:
                [eng.forward(p, subject=keys[0])
                 for p in reference["poses"][:2]]
                assert time.monotonic() < deadline, "failback never came"
            before = {p["lane"]: p["assigned"]
                      for p in eng.load()["lanes"]["per_lane"]}
            got2 = [eng.forward(p, subject=keys[(i % n) % 3])
                    for i, p in enumerate(reference["poses"] * 2)]
            _equal(got2, reference["posed"] * 2)
            after = {p["lane"]: p["assigned"]
                     for p in eng.load()["lanes"]["per_lane"]}
            assert after[kill] > before[kill]     # the lane is back
            assert eng.counters.compiles == warm  # loss and failback: 0
    finally:
        plan.release.set()
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0
    names = {name for name, _ in _runtime(tr)}
    assert {"lane_breaker", "incident:lane_failover"} <= names


def test_all_lanes_down_falls_through_to_cpu_tier(params32, reference):
    """The ladder's last rung on a CPU engine: every lane down, the batch
    lands on the CPU tier (the full forward with per-row betas), counted
    and warned."""
    lane_ok = [False] * N_LANES
    plan = prt.ChaosPlan("error@0-")       # untagged: every lane faults
    eng = _lane_engine(params32, lane_ok, plan=plan)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with eng:
                keys = [eng.specialize(b) for b in reference["betas"]]
                eng.warmup(BUCKETS)           # warms the CPU tier too
                eng.warmup_posed(BUCKETS)
                got = eng.forward(reference["poses"][0], subject=keys[0])
                np.testing.assert_array_equal(got, reference["full"][0])
                got_full = eng.forward(reference["poses"][0],
                                       reference["betas"][0])
                np.testing.assert_array_equal(got_full,
                                              reference["full"][0])
                assert eng.counters.failovers >= 2
                snap = eng.load()["lanes"]
                assert sum(p["cpu_failovers"]
                           for p in snap["per_lane"]) >= 2
        assert sum("failed over to the CPU tier" in str(w.message)
                   for w in caught) == eng.counters.failovers
    finally:
        plan.release.set()


def test_subject_installed_after_warm_broadcasts_to_all_lanes(
        params32, reference):
    """A subject installed after the lanes are warm reaches every replica
    by the row broadcast, captures nothing, and serves the single
    context's bits from whichever lane placement picks."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    new_betas = _betas(77)
    pose = reference["poses"][0]
    with eng:
        eng.specialize(reference["betas"][0])
        eng.warmup_posed(BUCKETS)
        warm = eng.counters.compiles
        key = eng.specialize(new_betas)       # broadcast, not re-adopt
        got = [eng.forward(pose, subject=key) for _ in range(N_LANES * 2)]
        assert eng.counters.compiles == warm
        snap = eng.load()["lanes"]
        assert all(p["assigned"] >= 1 for p in snap["per_lane"])
        versions = {ln.table_version for ln in eng._get_lanes().lanes}
        assert versions == {eng._table_version}
    with _single(params32) as ref:
        ref.specialize(reference["betas"][0])
        want = ref.forward(pose, subject=ref.specialize(new_betas))
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_table_growth_readopts_lane_replicas(params32):
    """Growing past the first capacity re-adopts every lane's replica and
    rebuilds its gathered programs at once (counted growth builds):
    subjects from both sides of the growth serve the single context's
    bits and the dispatches build nothing."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok, max_subjects=16)
    all_betas = [_betas(100 + i) for i in range(10)]  # first capacity 8
    pose = _poses(1, seed=9, rows=1)[0]
    with eng:
        keys = [eng.specialize(b) for b in all_betas[:2]]
        eng.warmup_posed([1, 2])
        growths_before = eng.counters.table_growths
        keys += [eng.specialize(b) for b in all_betas[2:]]
        assert eng.counters.table_growths > growths_before
        compiles_after_growth = eng.counters.compiles
        got = [eng.forward(pose, subject=k) for k in keys]
        assert eng.counters.compiles == compiles_after_growth
        caps = {ln.table.capacity for ln in eng._get_lanes().lanes}
        assert caps == {16}
    with _single(params32, max_subjects=16) as ref:
        rkeys = [ref.specialize(b) for b in all_betas]
        want = [ref.forward(pose, subject=k) for k in rkeys]
    _equal(got, want)


def test_load_lanes_snapshot_untorn_and_shape_stable(params32, reference):
    """``load()["lanes"]`` is one LaneSet-lock hold: its sums equal its
    per-lane fields in every snapshot taken while submitters hammer the
    engine, and its keys are JAX's. A laneless engine's ``load()`` has no
    lanes block."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    torn = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            snap = eng.load().get("lanes")
            if snap is None:
                continue
            per = snap["per_lane"]
            if snap["assigned_total"] != sum(p["assigned"] for p in per):
                torn.append(snap)
            if snap["backlog_rows_total"] != sum(
                    p["backlog_rows"] for p in per):
                torn.append(snap)

    with eng:
        keys = [eng.specialize(b) for b in reference["betas"]]
        assert "lanes" not in eng.load()        # built at the first warm-up
        eng.warmup_posed(BUCKETS)
        t = threading.Thread(target=reader, daemon=True)
        t.start()
        futs = [eng.submit(p, subject=keys[i % 3])
                for i, p in enumerate(reference["poses"] * 6)]
        for f in futs:
            f.result(timeout=60)
        stop.set()
        t.join(10)
        assert not t.is_alive()
        snap = eng.load()["lanes"]
    assert torn == []
    assert set(snap) == {"n_lanes", "n_devices", "sharded", "healthy",
                         "assigned_total", "backlog_rows_total",
                         "per_lane"}
    assert set(snap["per_lane"][0]) == {
        "lane", "device", "state", "table_capacity", "resident_rows",
        "backlog_batches", "backlog_rows",
        "inflight", "assigned", "dispatched", "served_requests",
        "failovers_out", "failovers_in", "cpu_failovers", "errors"}
    with _single(params32) as bare:
        assert "lanes" not in bare.load()


def test_lanes_metrics_mapping(params32, reference):
    """The lanes block reaches the metrics export: fleet gauges and
    per-lane samples labelled by lane, the same structs as JAX's mapper
    makes of the same ``load()`` and the backlog in batches beside
    them."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    with eng:
        keys = [eng.specialize(b) for b in reference["betas"]]
        eng.warmup_posed(BUCKETS)
        [eng.forward(p, subject=keys[i % 3])
         for i, p in enumerate(reference["poses"])]
        ld = eng.load()
    out = pmetrics.load_samples(ld)
    want = jmetrics.load_samples(ld)
    assert {k: out[k] for k in want} == want
    assert set(out) - set(want) == {"load_lane_backlog_batches"}
    assert out["load_lanes_n_lanes"]["samples"][0][1] == N_LANES
    assert out["load_lanes_healthy"]["samples"][0][1] == N_LANES
    assigned = out["load_lane_assigned"]["samples"]
    assert {labels["lane"] for labels, _ in assigned} == {
        str(i) for i in range(N_LANES)}
    states = out["load_lane_state"]["samples"]
    assert all(v == 0 for _, v in states)         # all healthy


def test_stream_warm_start_bit_equal_through_lane_loss(params32):
    """A tracking stream keeps its warm start bit-equal through a lane
    lost mid-stream: its frames serve through whichever lane survives,
    and the single-context stream's poses and verts match exactly; the
    loss builds nothing."""
    rng = np.random.default_rng(3)
    betas = _betas(21)
    end = rng.normal(scale=0.25, size=(16, 3)).astype(np.float32)
    alphas = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    poses = torch.from_numpy(alphas[:, None, None] * end[None])
    with torch.no_grad():
        targets = core.forward_batched(
            params32, poses,
            torch.from_numpy(np.repeat(betas[None], 4, 0))
        ).posed_joints.numpy()
    with _single(params32) as ref_eng:
        sess = ref_eng.open_stream(betas, n_steps=4, data_term="joints")
        ref = [sess.step(t) for t in targets]
    lane_ok = [True] * N_LANES
    plan = prt.ChaosPlan()
    eng = _lane_engine(params32, lane_ok, plan=plan)
    kill = 2
    try:
        with eng:
            eng.specialize(betas)
            eng.warmup_posed(BUCKETS)
            warm = eng.counters.compiles
            sess = eng.open_stream(betas, n_steps=4, data_term="joints")
            out = [sess.step(targets[0]), sess.step(targets[1])]
            lane_ok[kill] = False
            plan.schedule(f"error@0-%{kill}")     # mid-stream lane loss
            out.append(sess.step(targets[2]))
            out.append(sess.step(targets[3]))
            assert eng.counters.compiles == warm
            for got, want in zip(out, ref):
                np.testing.assert_array_equal(got.pose, want.pose)
                np.testing.assert_array_equal(got.verts, want.verts)
            np.testing.assert_array_equal(sess.pose, ref[-1].pose)
    finally:
        plan.release.set()


def test_cancel_in_lane_mode_counts_and_frees(params32, reference):
    """``future.cancel()`` composes with lane dispatch: the cancelled
    request resolves as CancelledError and counts, the rest serve."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    with eng:
        keys = [eng.specialize(b) for b in reference["betas"]]
        eng.warmup_posed(BUCKETS)
        futs = [eng.submit(p, subject=keys[i % 3])
                for i, p in enumerate(reference["poses"])]
        cancelled = futs[3].cancel()
        done = 0
        for i, f in enumerate(futs):
            if i == 3 and cancelled:
                with pytest.raises(CancelledError):
                    f.result(timeout=60)
            else:
                assert f.result(timeout=60).shape[0] == 2
                done += 1
    snap = eng.counters.snapshot()
    assert snap["cancelled"] == (1 if cancelled else 0)
    assert done == len(futs) - (1 if cancelled else 0)


def test_lane_engine_stop_resolves_backlog(params32, reference):
    """``stop()`` drains the lane queues: no future is stranded, and the
    lanes' backlog counts return to zero."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok)
    with eng:
        keys = [eng.specialize(b) for b in reference["betas"]]
        eng.warmup_posed(BUCKETS)
        futs = [eng.submit(p, subject=keys[i % 3])
                for i, p in enumerate(reference["poses"] * 4)]
    for f in futs:
        try:
            f.result(timeout=5)
        except (ServingError, CancelledError):
            pass
    snap = eng.load()["lanes"]
    assert snap["backlog_rows_total"] == 0
    assert all(p["inflight"] == 0 and p["backlog_batches"] == 0
               for p in snap["per_lane"])


def test_lane_drill_tiny_e2e(params32):
    """The lane drill at plumbing size: every judged criterion present
    and passing (one worker: batches of one request, whose rows are the
    reference's bit for bit on the CPU)."""
    from mano_hand_tpu_torch.serving import lane_drill_run

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = lane_drill_run(params32, lanes=N_LANES, requests_per_pass=12,
                             subjects=3, workers=1, max_rows=2,
                             max_bucket=4, seed=0, device="cpu")
    assert out["futures_resolved_fraction"] == 1.0
    assert out["outcomes"]["error"] == 0
    assert out["outcomes"]["stranded"] == 0
    assert out["loss_vs_reference_max_abs_err"] == 0.0
    assert out["pre_vs_reference_max_abs_err"] == 0.0
    assert out["post_vs_reference_max_abs_err"] == 0.0
    assert out["steady_recompiles_pre"] == 0
    assert out["steady_recompiles_post"] == 0
    assert out["lane_failovers"] >= 1
    assert out["cpu_failovers"] == 0
    assert out["failback_served"] is True
    assert out["breaker_probe_backoff_grew"] is True
    assert out["spans"]["started"] == out["spans"]["closed"]
    assert set(out["lane_slo"]) == {str(i) for i in range(N_LANES)}
    assert out["flight_record"]["reason"] == "lane_drill_complete"


def test_eviction_churn_under_lanes_stays_bit_identical(params32):
    """An eviction reuses table slots while batches resolved against the
    older table may still be queued: every lane serves its batch's own
    snapshot, so a max_subjects=2 table churning through 4 subjects stays
    bit-identical to the single context."""
    lane_ok = [True] * N_LANES
    eng = _lane_engine(params32, lane_ok, max_subjects=2)
    all_betas = [_betas(200 + i) for i in range(4)]
    pose = _poses(1, seed=11, rows=1)[0]
    with _single(params32) as ref:
        want = [ref.forward(pose, subject=ref.specialize(b))
                for b in all_betas]
    with eng:
        keys = [eng.specialize(b) for b in all_betas[:2]]
        eng.warmup_posed([1])
        evicted_before = eng.counters.specializations_evicted
        keys += [eng.specialize(b) for b in all_betas[2:]]
        for _ in range(3):
            for i, k in enumerate(keys):
                np.testing.assert_array_equal(
                    eng.forward(pose, subject=k), want[i])
        assert (eng.counters.specializations_evicted
                > evicted_before + 4)


def test_lanes_serve_fused_family_with_loss_parity(params32):
    """Under ``posed_kernel="fused"`` the lanes serve K2's family (its
    plain version on the CPU): bit-equal to the single-context fused
    engine, within 1e-5 of the plain gather, and through a lane loss
    still the fused engine's bits."""
    betas = [_betas(s) for s in (1, 2, 3)]
    poses = _poses(8, seed=5)
    with _single(params32, posed_kernel="fused") as ref_eng:
        rkeys = [ref_eng.specialize(b) for b in betas]
        fused_want = [ref_eng.forward(p, subject=rkeys[i % 3])
                      for i, p in enumerate(poses)]
    with _single(params32) as xla_eng:
        xkeys = [xla_eng.specialize(b) for b in betas]
        xla_want = [xla_eng.forward(p, subject=xkeys[i % 3])
                    for i, p in enumerate(poses)]
    lane_ok = [True] * N_LANES
    plan = prt.ChaosPlan()
    tr = Tracer()
    eng = _lane_engine(params32, lane_ok, plan=plan, tracer=tr,
                       posed_kernel="fused")
    kill = 2
    try:
        with eng:
            keys = [eng.specialize(b) for b in betas]
            eng.warmup_posed(BUCKETS)
            warm = eng.counters.compiles
            got = [eng.forward(p, subject=keys[i % 3])
                   for i, p in enumerate(poses)]
            _equal(got, fused_want)
            assert max(float(np.abs(g - x).max())
                       for g, x in zip(got, xla_want)) <= 1e-5
            lane_ok[kill] = False
            plan.schedule(f"error@0-%{kill}")
            n = len(poses)
            got_loss = [eng.forward(p, subject=keys[(i % n) % 3])
                        for i, p in enumerate(poses * 2)]
            _equal(got_loss, fused_want * 2)
            snap = eng.load()["lanes"]
            per = {p["lane"]: p for p in snap["per_lane"]}
            assert per[kill]["failovers_out"] >= 1
            assert sum(p["cpu_failovers"] for p in snap["per_lane"]) == 0
            assert eng.counters.compiles == warm
    finally:
        plan.release.set()
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]
    families = {f.get("family") for name, f in _runtime(tr)
                if name == "compile"}
    assert families == {"gather_fused"}


# ----------------------------------------------------- the twin against JAX
def _twin_run(engine_cls, error_cls, rt, params, **extra):
    """Sequential pose-only traffic on a 2-lane engine at one bucket; lane
    1 dies after two batches. Returns outcomes and per-lane counts."""
    lane_ok = [True, True]
    plan = rt.ChaosPlan()
    eng = engine_cls(params, policy=_policy(rt, plan), lanes=2,
                     lane_probe=lambda i: lane_ok[i], min_bucket=2,
                     max_bucket=2, max_delay_s=0.02, **extra)
    outcomes = []
    try:
        with eng:
            keys = [eng.specialize(_betas(s)) for s in (1, 2)]
            eng.warmup_posed([2])
            for i, p in enumerate(_poses(10, seed=31, rows=1)):
                if i == 2:
                    lane_ok[1] = False
                    plan.schedule("error@0-%1")
                try:
                    outcomes.append(("ok", eng.forward(
                        p, subject=keys[i % 2])))
                except error_cls as e:
                    outcomes.append(("ServingError", e.kind, e.phase))
    finally:
        plan.release.set()
    # Read once stopped: a lane counts a request served after its future
    # resolved.
    snap = eng.load()["lanes"]
    counters = eng.counters.snapshot()
    per = [{k: p[k] for k in ("assigned", "dispatched", "failovers_out",
                              "failovers_in", "cpu_failovers", "errors",
                              "state", "served_requests")}
           for p in snap["per_lane"]]
    return outcomes, per, {k: counters[k] for k in (
        "retries", "failovers", "faults_injected", "dispatches")}


def test_lane_twin_equals_the_jax_lane_engine(params32, params):
    """The same ``%LANE`` plan on a 2-lane port engine and a 2-lane JAX
    engine: equal outcomes, per-lane placements, dispatches, ladder hops
    and CPU failovers, and results within 1e-6 m."""
    port = _twin_run(ServingEngine, ServingError, prt, params32,
                     device="cpu")
    jax = _twin_run(JaxEngine, JaxError, jrt, params.astype(np.float32))
    assert len(port[0]) == len(jax[0]) == 10
    for a, b in zip(port[0], jax[0]):
        assert a[0] == b[0]
        if a[0] == "ok":
            assert float(np.abs(a[1].astype(np.float64) - b[1]).max()) \
                <= TOL
        else:
            assert a == b
    assert port[1] == jax[1]
    assert port[2] == jax[2]
    assert port[1][1]["failovers_out"] >= 1
    assert sum(p["cpu_failovers"] for p in port[1]) == 0
