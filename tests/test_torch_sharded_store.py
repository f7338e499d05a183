"""The sharded half of the port's subject store on the CPU.

* The shard map (``shard_for``, ``reassign_shard``, ``restore_shard`` and
  the snapshot's ``shards`` block) equals the JAX store's on the same
  digests, errors included.
* JAX's ``test_cross_shard_batch_split_parity``: mixed-shard traffic
  through a 2-lane sharded engine is split at coalesce (``"shard"``
  parks) and serves the single-context engine's bits (K2's plain version,
  whose rows ignore their batchmates on the CPU as on the card).
* Per-lane device rows of the sharded lanes stay strictly below the
  replicated twin's.
* A lane lost under the sharded store: its subjects reroute, the shard is
  rebalanced onto the survivor and handed back after failback, with the
  single-context engine's bits throughout.
* The store drill end to end at plumbing size.
"""

import numpy as np
import pytest
import torch

from mano_hand_tpu.serving.subject_store import SubjectStore as JaxStore
from mano_hand_tpu.utils.profiling import ServingCounters as JaxCounters
from mano_hand_tpu_torch import runtime as prt
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.runtime import health
from mano_hand_tpu_torch.serving import ServingEngine
from mano_hand_tpu_torch.serving.subject_store import (
    SubjectStore, SubjectStoreConfig, subject_digest,
)
from mano_hand_tpu_torch.utils.profiling import ServingCounters


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _universe(n, seed=7):
    return np.random.default_rng(seed).normal(size=(n, 10)).astype(
        np.float32)


def _poses(n, seed=3, rows=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.4, size=(rows, 16, 3)).astype(np.float32)
            for _ in range(n)]


def _single(params32, **kw):
    return ServingEngine(params32, device="cpu", max_bucket=4,
                         max_delay_s=0.001, posed_kernel="fused", **kw)


def _want(params32, betas, poses, order):
    with _single(params32) as ref:
        keys = [ref.specialize(b) for b in betas]
        return [ref.forward(p, subject=keys[order[i]])
                for i, p in enumerate(poses)]


# ------------------------------------------------------------- the shard map
def test_shard_map_equals_jax():
    digests = [subject_digest(b) for b in _universe(64)]
    port, jax = SubjectStore(sharded=True), JaxStore(sharded=True)
    port.bind(ServingCounters(), n_shards=4)
    jax.bind(JaxCounters(), n_shards=4)
    assert port.n_shards == jax.n_shards == 4

    def shards():
        return ([port.shard_for(d) for d in digests],
                [jax.shard_for(d) for d in digests])

    a, b = shards()
    assert a == b and set(a) == {0, 1, 2, 3}
    assert port.reassign_shard(1, [3, 0, 2]) is jax.reassign_shard(
        1, [3, 0, 2]) is True
    assert port.reassign_shard(1, [0]) is jax.reassign_shard(1, [0]) is False
    a, b = shards()
    assert a == b and 1 not in set(a)
    for bad in ((2, [1]), (2, [2]), (5, [0]), (2, [])):
        errs = []
        for st in (port, jax):
            with pytest.raises(ValueError) as e:
                st.reassign_shard(*bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    keys = ("shards", "reassigned_shards", "sharded")
    assert ({k: port.snapshot()[k] for k in keys}
            == {k: jax.snapshot()[k] for k in keys}
            == {"shards": 4, "reassigned_shards": {"1": [0, 2, 3]},
                "sharded": True})
    assert port.reassigned_shards() == (1,)
    assert port.restore_shard(1) is jax.restore_shard(1) is True
    assert port.restore_shard(1) is jax.restore_shard(1) is False
    a, b = shards()
    assert a == b and set(a) == {0, 1, 2, 3}
    plain = SubjectStore()
    plain.bind(ServingCounters(), n_shards=4)
    assert plain.shard_for(digests[0]) is None
    with pytest.raises(RuntimeError, match="unsharded"):
        plain.reassign_shard(0, [1])


# ------------------------------------------------------------------ engines
def test_cross_shard_batch_split_parity(params32, tmp_path):
    """Mixed-shard traffic through a 2-lane sharded engine: coalesced
    windows split by owner lane, and every result is the single-context
    engine's."""
    betas = _universe(6)
    poses = _poses(12)
    order = [i % len(betas) for i in range(len(poses))]
    want = _want(params32, betas, poses, order)
    store = SubjectStore(SubjectStoreConfig(
        warm_capacity=8, cold_dir=str(tmp_path), sharded=True))
    tr = Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=4,
                        max_delay_s=0.005, lanes=2, subject_store=store,
                        posed_kernel="fused", tracer=tr)
    keys = [eng.specialize(b) for b in betas]
    assert {store.shard_for(k) for k in keys} == {0, 1}
    eng.start = lambda: eng            # the whole burst in the queue
    futs = [eng.submit(p, subject=keys[order[i]])
            for i, p in enumerate(poses)]
    del eng.start
    with eng:
        got = [f.result(timeout=60) for f in futs]
        snap = eng.load()["lanes"]
    assert snap["sharded"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    parks = [f for _, sid, name, f in tr.snapshot()["events"]
             if sid and name == "park"]
    assert any(f.get("why") == "shard" for f in parks)
    # Each lane served only its own shard's subjects.
    for ln in eng._get_lanes().lanes:
        assert all(store.shard_for(d) == ln.index for d in ln.shard_slots)


def test_per_lane_rows_below_the_replicated_twin(params32):
    """The shard tables' device rows: max_subjects split over the lanes,
    strictly below each replicated lane's full replica."""
    betas = _universe(8, seed=11)
    sharded = ServingEngine(
        params32, device="cpu", max_bucket=2, max_subjects=8, lanes=2,
        subject_store=SubjectStore(sharded=True), posed_kernel="fused")
    replicated = ServingEngine(params32, device="cpu", max_bucket=2,
                               max_subjects=8, lanes=2,
                               posed_kernel="fused")
    rows = {}
    for name, eng in (("sharded", sharded), ("replicated", replicated)):
        with eng:
            keys = [eng.specialize(b) for b in betas]
            eng.warmup_posed()
            for k in keys:
                eng.forward(_poses(1, rows=1)[0], subject=k)
            per = eng.load()["lanes"]["per_lane"]
        rows[name] = [p["table_capacity"] for p in per]
        rows[name + "_resident"] = [p["resident_rows"] for p in per]
    assert rows["sharded"] == [4, 4] and rows["replicated"] == [8, 8]
    assert max(rows["sharded"]) < min(rows["replicated"])
    assert sum(rows["sharded_resident"]) == len(betas)


def test_lane_loss_rebalances_and_restores_the_shard(params32, tmp_path):
    """Kill a subject's owner lane with ``%LANE``: its batches reroute
    through the ladder, the shard is reassigned to the survivor
    (``rebalance_shard``), and handed back once the lane is healthy again
    (``restore_shard``); every result is the single-context engine's and
    the whole cycle builds nothing."""
    betas = _universe(6, seed=5)
    poses = _poses(24, seed=9, rows=1)
    order = [i % len(betas) for i in range(len(poses))]
    want = _want(params32, betas, poses, order)
    lane_ok = [True, True]
    plan = prt.ChaosPlan()
    policy = prt.DispatchPolicy(
        deadline_s=10.0, retries=1, backoff_s=0.005, backoff_cap_s=0.01,
        jitter=0.0, breaker=prt.CircuitBreaker(
            failure_threshold=2, probe_interval_s=0.001,
            respect_priority_claim=False),
        chaos=plan, cpu_fallback=True)
    store = SubjectStore(SubjectStoreConfig(
        warm_capacity=8, cold_dir=str(tmp_path), sharded=True))
    tr = Tracer()
    eng = ServingEngine(params32, device="cpu", max_bucket=4,
                        max_delay_s=0.001, lanes=2, subject_store=store,
                        posed_kernel="fused", policy=policy, tracer=tr,
                        lane_probe=lambda i: lane_ok[i])
    keys = [eng.specialize(b) for b in betas]
    dead = store.shard_for(keys[0])
    got = []
    try:
        with eng:
            eng.warmup_posed()
            warm = eng.counters.compiles
            got += [eng.forward(p, subject=keys[order[i]])
                    for i, p in enumerate(poses[:6])]
            lane_ok[dead] = False
            plan.schedule(f"error@0-%{dead}")
            got += [eng.forward(p, subject=keys[order[i + 6]])
                    for i, p in enumerate(poses[6:12])]
            lanes = eng._get_lanes()
            assert lanes.lanes[dead].breaker.state == health.DOWN
            # The next placement for the dead shard kicks the rebalance.
            for _ in range(200):
                if eng.counters.shard_rebalances:
                    break
                eng.forward(poses[0], subject=keys[0])
            assert eng.counters.shard_rebalances == 1
            assert store.reassigned_shards() == (dead,)
            assert {store.shard_for(k) for k in keys} == {1 - dead}
            got += [eng.forward(p, subject=keys[order[i + 12]])
                    for i, p in enumerate(poses[12:18])]
            plan.clear()
            lane_ok[dead] = True
            for _ in range(200):
                if not store.reassigned_shards():
                    break
                eng.forward(poses[0], subject=keys[1])
            assert store.reassigned_shards() == ()
            assert lanes.lanes[dead].breaker.state == health.HEALTHY
            got += [eng.forward(p, subject=keys[order[i + 18]])
                    for i, p in enumerate(poses[18:])]
            assert eng.counters.compiles == warm
            snap = eng.load()["lanes"]
    finally:
        plan.release.set()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(p["cpu_failovers"] for p in snap["per_lane"]) == 0
    assert snap["per_lane"][dead]["failovers_out"] >= 1
    names = [name for _, sid, name, _ in tr.snapshot()["events"] if not sid]
    assert names.count("shard_rebalance") == 1
    assert names.count("shard_restore") == 1
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]


def test_tiny_store_drill_e2e(params32, tmp_path):
    """The store drill at plumbing size: the criteria JAX's
    ``judge_subject_store`` reads, each present and passing (one worker:
    batches of one request, whose rows are the reference's bit for bit on
    the CPU)."""
    from mano_hand_tpu_torch.serving import subject_store_drill_run

    out = subject_store_drill_run(
        params32, subjects=300, requests_per_leg=16, lanes=2,
        max_subjects=8, warm_capacity=12, max_rows=2, max_bucket=4,
        pair_slice=8, workers=1, seed=0, cold_dir=str(tmp_path),
        device="cpu", posed_kernel="fused")
    assert out["futures_resolved_fraction"] == 1.0
    assert out["outcomes"]["error"] == 0
    assert out["outcomes"]["stranded"] == 0
    assert out["outcomes_replicated"]["error"] == 0
    assert len(out["legs"]) >= 3
    for leg in out["legs"].values():
        assert leg["sharded_vs_reference_max_abs_err"] == 0.0
        if "replicated_vs_reference_max_abs_err" in leg:
            assert leg["replicated_vs_reference_max_abs_err"] == 0.0
    assert out["steady_recompiles"] == 0
    assert out["steady_recompiles_replicated"] == 0
    # A time: judged on the card (the smoke), reported here.
    assert isinstance(out["promotion_p99_within_window"], bool)
    assert out["damage_probe"]["injected"]
    assert out["damage_probe"]["damage_counted"] >= 1
    assert out["damage_probe"]["request_max_abs_err"] == 0.0
    assert out["store_counters"]["subject_store_cold_hits"] >= 1
    assert out["hot_tier_hit_rate"] >= 0.5
    rows_s = out["per_lane_device_rows_sharded"]
    rows_r = out["per_lane_device_rows_replicated"]
    assert max(rows_s) < min(rows_r)
    sp = out["spans"]
    assert sp["started"] == sp["closed"] and sp["open"] == 0
    assert out["lanes_sharded"] and out["subject_store"]["sharded"]
    assert out["flight_record"]["reason"] == "subject_store_drill_complete"
    pd = out["paired_dispatches"]
    assert pd["sharded"]["requests_dispatched"] == pd["replicated"][
        "requests_dispatched"] == 3 * 16


def test_shard_churn_under_threads_serves_every_subject(params32):
    """Twelve threads churn eight subjects through two shard tables of two
    rows each, with the interpreter switching threads every 10 us: every
    install reuses a slot some queued batch may name. Each result is its
    own subject's mesh (within 1e-6 m of the single context; a row from
    another subject is centimetres off) and the lanes' backlog drains to
    zero."""
    import sys
    import threading

    betas = _universe(8, seed=13)
    poses = _poses(120, seed=21, rows=1)
    order = [int(i) for i in np.random.default_rng(5).integers(0, 8, 120)]
    want = _want(params32, betas, poses, order)
    eng = ServingEngine(params32, device="cpu", max_bucket=4,
                        max_subjects=4, max_delay_s=0.001, lanes=2,
                        subject_store=SubjectStore(warm_capacity=8,
                                                   sharded=True),
                        posed_kernel="fused")
    keys = eng.register_subjects(betas)
    got = [None] * len(poses)
    errors = []

    def client(t):
        try:
            for i in range(t, len(poses), 12):
                got[i] = eng.forward(poses[i], subject=keys[order[i]])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with eng:
            ths = [threading.Thread(target=client, args=(t,))
                   for t in range(12)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    snap = eng.load()["lanes"]        # stopped: every lane worker joined
    assert not errors
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 1e-6
    assert snap["backlog_rows_total"] == 0
    assert all(p["table_capacity"] == 2 for p in snap["per_lane"])
    assert eng.counters.specializations_evicted >= 1


def test_sharded_lanes_boot_their_shard_programs_from_the_lattice(
        params32, tmp_path):
    """A sharded lane engine bakes its shard tables' capacity (3, off the
    doubling ladder of max_subjects=6) into the lattice, and a fresh one
    loads every lane's shard programs from it: their results are the
    live engine's bits."""
    aot = str(tmp_path / "aot")
    betas = _universe(4, seed=17)
    pose = _poses(1, seed=23, rows=2)[0]

    def engine():
        return ServingEngine(params32, device="cpu", max_bucket=2,
                             max_subjects=6, lanes=2, aot_dir=aot,
                             subject_store=SubjectStore(sharded=True))

    manifest = engine().bake_lattice()
    assert {"gather/b1/c3", "gather/b2/c3", "gather/b2/c6"} <= set(
        manifest["entries"])
    live, booted = engine(), engine()
    got = {}
    for name, eng in (("live", live), ("booted", booted)):
        keys = [eng.specialize(b) for b in betas]
        if name == "live":
            eng.aot_dir = None               # built live, no lattice
        eng.warmup_posed()
        with eng:
            got[name] = [eng.forward(pose, subject=k) for k in keys]
    # Each lane's shard programs (2 buckets) and the engine's own.
    assert booted.counters.aot_loads >= 2 * 2 + 2
    assert live.counters.aot_loads == 0
    for g, w in zip(got["booted"], got["live"]):
        np.testing.assert_array_equal(g, w)
