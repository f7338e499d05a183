"""The port's streaming sessions (``serving/streams.py``) on the CPU: the
mirror of the JAX package's ``tests/test_streams.py`` on the port engine,
plus frames held against the JAX engine's stream.

* a frame is a frozen-shape LM fit warm-started from the last converged
  pose, then the gathered tier-0 dispatch: the verts equal the port's
  per-subject posed program at the same padded bucket (0.0), and the
  pose and verts agree with the JAX engine's stream on the same targets
  (pose <= 1e-4, verts <= 1e-4 m);
* the lifecycle edges — open on an evicted subject re-bakes, frames after
  a terminal are refused, idle sessions expire, ``stop()`` sweeps open
  sessions to ``shutdown`` and a stopped engine refuses opens until it
  restarts — each terminal closing the session's span exactly once;
* chaos composes: a CPU-failover frame is a direct CPU call bit for bit
  and leaves the fault-free session's warm start;
* ``load()["streams"]`` is one lock-held snapshot, shape-stable, and
  exported by the metrics mapper; the tiny drill resolves every frame.
"""

import concurrent.futures as cf
import time

import numpy as np
import pytest
import torch

from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.obs import Tracer
from mano_hand_tpu_torch.serving import buckets as bucket_mod
from mano_hand_tpu_torch.serving import streams as streams_mod
from mano_hand_tpu_torch.serving.engine import ServingEngine, ServingError


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _betas(seed, n=10):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def _track(params32, betas, frames=3, seed=2, scale=0.25):
    """A smooth ground-truth pose track and its per-frame joint targets."""
    rng = np.random.default_rng(seed)
    end = rng.normal(scale=scale, size=(16, 3)).astype(np.float32)
    alphas = np.linspace(0.0, 1.0, frames, dtype=np.float32)
    poses = alphas[:, None, None] * end[None]
    with torch.no_grad():
        out = core.forward_batched(
            params32, torch.from_numpy(poses),
            torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(betas, (frames, 10)))))
    return poses, out.posed_joints.numpy()


def _engine(params32, tracer=None, **kw):
    kw.setdefault("min_bucket", 1)
    kw.setdefault("max_bucket", 4)
    kw.setdefault("max_delay_s", 0.001)
    return ServingEngine(params32, device="cpu", tracer=tracer, **kw)


def _posed_program(params32, betas, pose, buckets):
    """The per-subject posed program at the frame's padded bucket."""
    b = bucket_mod.bucket_for(1, buckets)
    with torch.no_grad():
        sh = core.specialize(params32, torch.from_numpy(betas))
        return core.forward_posed_batched(
            sh, torch.from_numpy(bucket_mod.pad_rows(pose[None], b))
        ).verts[0].numpy()


def test_stream_frames_serve_bit_identical(params32):
    tr = Tracer()
    betas = _betas(1)
    _, targets = _track(params32, betas, frames=3)
    with _engine(params32, tracer=tr) as eng:
        sess = eng.open_stream(betas, n_steps=4, data_term="joints")
        results = [sess.step(t) for t in targets]
        assert sess.frame == 3
        assert [r.frame for r in results] == [0, 1, 2]
        assert results[-1].fit_loss < 1e-8
        for r in results:
            np.testing.assert_array_equal(
                r.verts, _posed_program(params32, betas, r.pose,
                                        eng.buckets))
        np.testing.assert_array_equal(sess.pose, results[-1].pose)
        assert sess.close()
        assert not sess.close()
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0
    assert acc["closed_by_kind"].get("closed") == 1
    assert acc["closed_by_kind"].get("ok") == 3


@pytest.mark.parametrize("data_term", ["verts", "joints"])
def test_frames_agree_with_the_jax_stream(params, params32, data_term):
    """The same subject and targets through the port engine's stream and
    the JAX engine's (both pipelined, JAX's defaults): verts within 1e-4
    m frame by frame, both fits converged. On vertex targets the pose is
    determined and agrees within 1e-4 too; joint targets do not observe
    a finger's twist about its own bone, so the two solvers' f32 paths
    part there (~7e-4 rad measured) while the verts still agree."""
    betas = _betas(5)
    poses, _ = _track(params32, betas, frames=3, seed=9)
    with torch.no_grad():
        out = core.forward_batched(
            params32, torch.from_numpy(poses),
            torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(betas, (3, 10)))))
    targets = (out.verts if data_term == "verts"
               else out.posed_joints).numpy()
    with _engine(params32) as eng:
        sess = eng.open_stream(betas, n_steps=4, data_term=data_term)
        port = [sess.step(t) for t in targets]
    jeng = JaxEngine(params.astype(np.float32), min_bucket=1, max_bucket=4,
                     max_delay_s=0.001)
    with jeng:
        jsess = jeng.open_stream(betas, n_steps=4, data_term=data_term)
        jax_ = [jsess.step(t) for t in targets]
    for p, j in zip(port, jax_):
        assert p.frame == j.frame
        assert float(np.abs(p.verts - np.asarray(j.verts)).max()) <= 1e-4
        if data_term == "verts":
            assert float(np.abs(p.pose - np.asarray(j.pose)).max()) <= 1e-4
        assert p.fit_loss < 1e-12 and float(j.fit_loss) < 1e-12


def test_open_stream_unknown_and_evicted_subject(params32):
    b1, b2, b3 = _betas(11), _betas(12), _betas(13)
    _, targets = _track(params32, b1, frames=2)
    with _engine(params32, max_subjects=2) as eng:
        k1 = eng.specialize(b1)
        eng.specialize(b2)
        eng.specialize(b3)              # evicts k1
        assert eng.counters.specializations_evicted >= 1
        sess = eng.open_stream(k1, n_steps=4, data_term="joints")
        res = sess.step(targets[0])
        assert np.isfinite(res.fit_loss)
        sess2 = eng.open_stream(_betas(14), n_steps=4,
                                data_term="joints")
        assert sess2.subject != sess.subject
        with pytest.raises(ValueError, match="unknown subject"):
            eng.open_stream("deadbeef00000000")


def test_frames_after_close_refused(params32):
    betas = _betas(21)
    _, targets = _track(params32, betas, frames=2)
    with _engine(params32) as eng:
        sess = eng.open_stream(betas, n_steps=4, data_term="joints")
        sess.step(targets[0])
        sess.close()
        with pytest.raises(ServingError) as ei:
            sess.submit_frame(targets[1])
        assert ei.value.kind == "shed"
        assert ei.value.phase == "stream"
        assert "closed" in str(ei.value)


def test_idle_expiry_under_deadline_pressure(params32):
    tr = Tracer()
    betas = _betas(31)
    _, targets = _track(params32, betas, frames=2)
    with _engine(params32, tracer=tr) as eng:
        sess = eng.open_stream(betas, n_steps=4, data_term="joints",
                               idle_timeout_s=0.05)
        sess.step(targets[0])
        time.sleep(0.12)
        snap = eng.load()["streams"]
        assert snap["closed_by_kind"] == {"expired": 1}
        assert snap["active"] == 0
        with pytest.raises(ServingError) as ei:
            sess.submit_frame(targets[1])
        assert ei.value.kind == "shed" and "expired" in str(ei.value)
    assert tr.accounting()["closed_by_kind"].get("expired") == 1


def test_stop_sweeps_open_streams_to_shutdown(params32):
    tr = Tracer()
    eng = _engine(params32, tracer=tr)
    b = [_betas(41), _betas(42)]
    _, targets = _track(params32, b[0], frames=2)
    with eng:
        sessions = [eng.open_stream(x, n_steps=4, data_term="joints")
                    for x in b]
        sessions[0].step(targets[0])
    snap = eng.load()["streams"]
    assert snap["active"] == 0
    assert snap["closed_by_kind"] == {"shutdown": 2}
    assert tr.accounting()["closed_by_kind"].get("shutdown") == 2
    for s in sessions:
        with pytest.raises(ServingError, match="shutdown"):
            s.submit_frame(targets[1])
    with pytest.raises(ServingError) as ei:
        eng.open_stream(b[0], n_steps=4, data_term="joints")
    assert ei.value.kind == "shutdown"
    with eng:
        sess3 = eng.open_stream(b[0], n_steps=4, data_term="joints")
        sess3.step(targets[0])
    assert tr.accounting()["spans_open"] == 0
    # A manager built only after the stop is born stopped.
    eng2 = _engine(params32)
    with eng2:
        pass
    with pytest.raises(ServingError) as ei:
        eng2.open_stream(b[0], n_steps=4, data_term="joints")
    assert ei.value.kind == "shutdown"


def test_open_stream_sheds_at_admission_pressure(params32):
    tr = Tracer()
    eng = _engine(params32, tracer=tr, max_queued=0)
    with pytest.raises(ServingError) as ei:
        eng.open_stream(_betas(51), n_steps=4, data_term="joints")
    assert ei.value.kind == "shed" and ei.value.phase == "stream"
    assert tr.accounting()["closed_by_kind"].get("shed") == 1
    assert eng.load()["streams"]["opened"] == 0


def test_failover_frame_bit_identical_and_warm_start_valid(params32):
    """Under a persistent primary fault with the CPU tier every frame
    resolves, its verts a direct CPU ``core.forward_batched`` call at the
    frame's bucket bit for bit, and the pose track is the fault-free
    session's exactly (the serving fault never touches the solver)."""
    from mano_hand_tpu_torch.runtime.chaos import ChaosPlan
    from mano_hand_tpu_torch.runtime.supervise import DispatchPolicy

    betas = _betas(61)
    _, targets = _track(params32, betas, frames=3)

    def run(policy):
        with _engine(params32, policy=policy) as eng:
            sess = eng.open_stream(betas, n_steps=4, data_term="joints")
            return [sess.step(t) for t in targets]

    clean = run(None)
    plan = ChaosPlan("error@0-")
    pol = DispatchPolicy(deadline_s=10.0, retries=1, backoff_s=0.01,
                         backoff_cap_s=0.02, jitter=0.0, breaker=None,
                         chaos=plan, cpu_fallback=True)
    try:
        with pytest.warns(RuntimeWarning, match="failed over"):
            faulted = run(pol)
    finally:
        plan.release.set()
    for c, f in zip(clean, faulted):
        np.testing.assert_array_equal(c.pose, f.pose)
        with torch.no_grad():
            want = core.forward_batched(
                params32, torch.from_numpy(f.pose[None].copy()),
                torch.from_numpy(betas[None].copy())).verts[0].numpy()
        np.testing.assert_array_equal(f.verts, want)


def test_tracker_init_pose_seeds_warm_start(params32):
    from mano_hand_tpu_torch.fitting import make_tracker

    seed_pose = np.random.default_rng(71).normal(
        scale=0.2, size=(16, 3)).astype(np.float32)
    state, _ = make_tracker(params32, n_steps=2, solver="lm",
                            data_term="joints", init_pose=seed_pose)
    np.testing.assert_array_equal(state.pose.numpy(), seed_pose)
    assert state.frame == 1
    with _engine(params32) as eng:
        sess = eng.open_stream(_betas(72), n_steps=4, data_term="joints",
                               resume_pose=seed_pose)
        np.testing.assert_array_equal(sess.pose, seed_pose)
        assert sess.frame == 1


def test_load_streams_block_untorn_and_shape_stable(params32):
    empty = _engine(params32).load()["streams"]
    assert empty == streams_mod.EMPTY_SNAPSHOT
    betas = [_betas(81), _betas(82)]
    _, targets = _track(params32, betas[0], frames=4)
    with _engine(params32) as eng:
        sessions = [eng.open_stream(b, n_steps=4, data_term="joints")
                    for b in betas]
        assert set(eng.load()["streams"]) == set(empty)
        with cf.ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(sessions[i % 2].step, targets[i])
                    for i in range(4)]
            for _ in range(50):
                s = eng.load()["streams"]
                assert s["active"] == 2
                assert s["opened"] == 2
                assert 0 <= s["frames_in_flight"] <= 4
                assert s["frames_resolved"] <= s["frames_submitted"]
                assert s["backlog_age_s"] >= 0.0
                if s["frames_in_flight"] == 0:
                    assert s["backlog_age_s"] == 0.0
            for f in futs:
                f.result(timeout=60)
        s = eng.load()["streams"]
        assert s["frames_in_flight"] == 0
        assert s["frames_submitted"] == s["frames_resolved"] == 4
        assert s["frames_by_kind"] == {"ok": 4}


def test_metrics_mapper_and_slo_latency_objective(params32):
    from mano_hand_tpu_torch.obs.metrics import (
        DEFAULT_SLO_OBJECTIVES, load_samples, prometheus_text, slo_report,
    )

    betas = _betas(91)
    _, targets = _track(params32, betas, frames=2)
    with _engine(params32) as eng:
        sess = eng.open_stream(betas, n_steps=4, data_term="joints")
        sess.step(targets[0])
        out = load_samples(eng.load())
    assert out["load_streams_active"]["samples"][0][1] == 1.0
    assert out["load_streams_frames_submitted"]["samples"][0][1] == 1.0
    assert out["load_streams_frames_in_flight"]["samples"][0][1] == 0.0
    text = prometheus_text({"namespace": "mano", "metrics": out})
    assert "mano_load_streams_active 1.0" in text
    snap = eng.counters.snapshot()
    objectives = {"0": {**DEFAULT_SLO_OBJECTIVES["0"],
                        "p99_target_ms": 100.0},
                  "default": DEFAULT_SLO_OBJECTIVES["default"]}
    slo = slo_report(snap, objectives,
                     latency_by_tier={"0": {"p99_ms": 50.0, "n": 1}})
    t0 = slo["tiers"]["0"]
    assert t0["burn_rates"]["latency_p99"] == 0.5
    assert t0["latency_p99_ms"] == 50.0
    plain = slo_report(snap)
    assert "latency_p99" not in plain["tiers"]["0"]["burn_rates"]
    assert "latency_p99_ms" not in plain["tiers"]["0"]


def test_stream_drill_tiny_e2e(params32):
    from mano_hand_tpu.serving import measure as jmeasure
    from mano_hand_tpu_torch.serving.measure import stream_drill_run

    out = stream_drill_run(
        params32, streams=6, frames_per_stream=3, subjects=3,
        workers=4, warm_steps=4, cold_steps_candidates=(8,),
        calib_probes=3, fit_trials=1, min_bucket=4, max_bucket=8,
        seed=5, device="cpu")
    assert out["frames_resolved_fraction"] == 1.0
    assert out["outcomes"]["error"] == 0
    assert out["outcomes"]["stranded"] == 0
    assert out["steady_recompiles"] == 0
    assert out["failovers"] >= 1
    assert out["failover_vs_cpu_direct_max_abs_err"] == 0.0
    assert out["warm_start_after_failover_consistent"] is True
    spans = out["stream_spans"]
    assert spans["opened"] == 6
    assert spans["closed_by_kind"] == {"closed": 4, "shutdown": 2}
    assert spans["active_after_stop"] == 0
    assert "latency_p99" in out["slo"]["tiers"]["0"]["burn_rates"]
    acc = out["flight_record"]["accounting"]
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0
    assert out["fit_p50_ms"] > 0 and out["dispatch_p50_ms"] is not None
    # JAX's keys (its own and the calibration's), plus the port's split
    # of the frame latency into fit and dispatch.
    assert _jax_return_keys(jmeasure, "stream_drill_run") \
        | _jax_return_keys(jmeasure, "_stream_fit_calibration") \
        == set(out) - {"fit_p50_ms", "fit_p99_ms", "dispatch_p50_ms",
                       "dispatch_p99_ms"}


def _jax_return_keys(module, fn_name):
    """The literal keys of a JAX function's returned dict, from its
    source."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = [n.value for n in ast.walk(fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].keys if k is not None}


def test_stream_drill_chaos_on_retries_only(params32):
    """The card's shape of the chaos round on the CPU: no CPU tier, a
    spec the retries absorb — every frame ok, nothing failed over, the
    warm start the fit's."""
    from mano_hand_tpu_torch.serving.measure import stream_drill_run

    out = stream_drill_run(
        params32, streams=4, frames_per_stream=3, subjects=2, workers=4,
        warm_steps=4, cold_steps_candidates=(8,), calib_probes=2,
        fit_trials=1, min_bucket=4, max_bucket=8, seed=6, device="cpu",
        chaos_spec="error@0", posed_kernel="fused")
    assert out["outcomes"]["ok"] == 12 and out["failovers"] >= 0
    assert out["chaos_outcomes"]["ok"] == 4
    assert out["warm_start_after_failover_consistent"] is True


def test_stream_span_never_poisons_request_backlog(params32):
    tr = Tracer()
    betas = _betas(101)
    with _engine(params32, tracer=tr) as eng:
        eng.open_stream(betas, n_steps=4, data_term="joints")
        time.sleep(0.06)
        ld = eng.load()
        assert ld["streams"]["active"] == 1
        assert ld["backlog_age_s"] < 0.05
        with pytest.raises(ValueError, match="solver"):
            eng.open_stream(betas, n_steps=4, data_term="joints",
                            solver="bogus")
    acc = tr.accounting()
    assert acc["spans_started"] == acc["spans_closed"]
    assert acc["spans_open"] == 0
    assert acc["closed_by_kind"].get("error") == 1
