"""The port's tiered subject store (``serving/subject_store.py``) on the
CPU, against the JAX package's: the mirror of ``tests/test_subject_store
.py``'s tests that need no lanes, plus cross-package checks.

* ``subject_digest`` and ``shard_of`` equal JAX's for the same betas;
* warm demote -> promote and cold page -> promote round trips are bit for
  bit; cold rows promote THROUGH warm; a damaged page is a counted miss,
  never an error, and costs one re-bake; a new store adopts the pages a
  previous one left;
* a row page written by either package's store (JAX's pickle backend)
  loads in the other's, bit for bit;
* through the engine: warm and cold promotions and a damaged page serve
  the fresh bake's bits (0.0), an evicted subject under a live stream
  keeps its frames, ``load()["subject_store"]`` is one consistent block,
  ``register_subjects`` bakes nothing up front, and a sharded store
  without lanes raises JAX's own error.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from mano_hand_tpu.io import orbax_ckpt
from mano_hand_tpu.serving import subject_store as jstore
from mano_hand_tpu.utils.profiling import ServingCounters as JaxCounters
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.io import state_ckpt
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.serving import ServingEngine
from mano_hand_tpu_torch.serving.subject_store import (
    ROW_KEYS, SubjectStore, SubjectStoreConfig, shard_of, subject_digest,
)
from mano_hand_tpu_torch.utils.profiling import ServingCounters


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


def _betas(seed, n=10):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def _row(seed, n_verts=8, n_joints=4, n_shape=10):
    rng = np.random.default_rng(seed)
    shape = rng.normal(size=(n_shape,)).astype(np.float32)
    return subject_digest(shape), {
        "v_shaped": rng.normal(size=(n_verts, 3)).astype(np.float32),
        "joints": rng.normal(size=(n_joints, 3)).astype(np.float32),
        "shape": shape,
    }


def _host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _engine(params, **kw):
    kw.setdefault("max_bucket", 2)
    kw.setdefault("max_delay_s", 0.001)
    return ServingEngine(params, device="cpu", **kw)


# ---------------------------------------------------------------- pure logic
def test_shard_of_stable_in_range():
    d = subject_digest(_betas(0))
    assert shard_of(d, 4) == shard_of(d, 4)
    for n in (1, 2, 3, 8):
        assert 0 <= shard_of(d, n) < n
    hits = {shard_of(subject_digest(_betas(s)), 4) for s in range(64)}
    assert hits == {0, 1, 2, 3}
    with pytest.raises(ValueError):
        shard_of(d, 0)


@pytest.mark.parametrize("seed", range(6))
def test_digest_and_shard_equal_jax(seed):
    b = _betas(seed)
    d = subject_digest(b)
    assert d == jstore.subject_digest(b)
    assert d == subject_digest(torch.from_numpy(b))
    for n in (1, 2, 3, 4, 7):
        assert shard_of(d, n) == jstore.shard_of(d, n)


def test_config_validation():
    with pytest.raises(ValueError):
        SubjectStoreConfig(warm_capacity=0)
    with pytest.raises(ValueError):
        SubjectStoreConfig(backend="zarr")
    st = SubjectStore(warm_capacity=4)
    assert not st.sharded
    assert SubjectStore(sharded=True).sharded


def test_digest_is_content_addressed():
    a, b = _betas(0), _betas(0)
    assert subject_digest(a) == subject_digest(b)
    assert subject_digest(a) != subject_digest(_betas(1))


# ------------------------------------------------------------- store tiers
def test_warm_demote_promote_roundtrip():
    st = SubjectStore(warm_capacity=4)
    c = ServingCounters()
    st.bind(c)
    digest, row = _row(0)
    st.demote(digest, row)
    assert st.warm_digests() == [digest]
    assert st.prefetch(digest)
    assert not st.prefetch(digest)         # one promotion in flight
    handles, tier = st.fetch_row(digest)
    assert tier == "warm"
    for k in ROW_KEYS:
        np.testing.assert_array_equal(_host(handles[k]), row[k])
    snap = c.snapshot()
    assert snap["subject_store_warm_hits"] == 1
    assert snap["subject_store_prefetches"] == 1
    assert snap["subject_store_promotions"] == 1
    assert snap["subject_store_promotion_ms"]["n"] == 1
    assert st.warm_digests() == [digest]   # inclusive tiers
    assert st.fetch_row("0" * 16) is None


class _FakeEvent:
    def __init__(self, done: bool):
        self.done, self.waits = done, 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waits += 1


class _FakeRow:
    def __init__(self):
        self.marked = []

    def record_stream(self, stream) -> None:
        self.marked.append(stream)


@pytest.mark.parametrize("landed,same_stream", [
    (True, True), (False, True), (True, False)])
def test_settle_waits_only_for_a_copy_in_flight(monkeypatch, landed,
                                                same_stream):
    """A card promotion's settle, with stand-ins for the event, the
    stream and the rows: a landed copy is neither waited for nor ordered
    (no call that blocks), a copy in flight is waited for on the host
    once, and rows reach a stream they were not marked as used by only
    after being marked for it."""
    mine, other = object(), object()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: mine)
    event, rows = _FakeEvent(landed), {k: _FakeRow() for k in ROW_KEYS}
    SubjectStore(warm_capacity=2)._settle(
        rows, event, mine if same_stream else other)
    assert event.waits == (0 if landed else 1)
    for r in rows.values():
        assert r.marked == ([] if same_stream else [mine])


def test_cold_roundtrip_inclusive_promotion(tmp_path):
    st = SubjectStore(warm_capacity=1, cold_dir=str(tmp_path),
                      backend="pickle")
    c = ServingCounters()
    st.bind(c)
    d0, r0 = _row(0)
    d1, r1 = _row(1)
    st.demote(d0, r0)
    st.demote(d1, r1)           # warm_capacity=1: d0 pages to cold
    assert st.warm_digests() == [d1]
    assert st.cold_digests() == [d0]
    assert st.cold_page_path(d0).exists()
    handles, tier = st.fetch_row(d0)
    assert tier == "cold"
    for k in ROW_KEYS:
        np.testing.assert_array_equal(_host(handles[k]), r0[k])
    assert st.warm_digests() == [d0]
    assert set(st.cold_digests()) == {d0, d1}
    snap = c.snapshot()
    assert snap["subject_store_cold_hits"] == 1
    assert snap["subject_store_demotions_cold"] == 2
    st.demote(*_row(2))         # d0's page is content-addressed: kept
    assert c.snapshot()["subject_store_demotions_cold"] == 2


def test_damaged_cold_page_counted_rebake(tmp_path):
    st = SubjectStore(warm_capacity=1, cold_dir=str(tmp_path))
    c = ServingCounters()
    st.bind(c)
    d0, r0 = _row(0)
    st.demote(d0, r0)
    st.demote(*_row(1))         # evict d0 to cold
    assert d0 in st.cold_digests()
    # A self-consistent page of the WRONG subject: the per-array hashes
    # verify, the digest preimage does not.
    meta, arrays = state_ckpt.load_row_page(d0, str(tmp_path))
    arrays["shape"] = np.asarray(arrays["shape"]) + 1.0
    state_ckpt.save_row_page(d0, arrays, str(tmp_path))
    assert st.fetch_row(d0) is None     # degrade, never raise
    assert c.snapshot()["subject_store_cold_damage"] == 1
    assert d0 not in st.cold_digests()
    assert st.fetch_row(d0) is None
    assert c.snapshot()["subject_store_cold_damage"] == 1


def test_store_adopts_existing_pages(tmp_path):
    d0, r0 = _row(0)
    first = SubjectStore(warm_capacity=1, cold_dir=str(tmp_path))
    first.bind(ServingCounters())
    first.demote(d0, r0)
    first.demote(*_row(1))
    assert d0 in first.cold_digests()
    second = SubjectStore(warm_capacity=1, cold_dir=str(tmp_path))
    second.bind(ServingCounters())
    assert d0 in second.cold_digests()
    handles, tier = second.fetch_row(d0)
    assert tier == "cold"
    np.testing.assert_array_equal(_host(handles["shape"]), r0["shape"])


def test_bind_twice_to_different_engines_raises():
    st = SubjectStore(warm_capacity=2)
    a, b = ServingCounters(), ServingCounters()
    st.bind(a)
    st.bind(a)
    with pytest.raises(RuntimeError):
        st.bind(b)


def test_resize_warm_evicts_oldest_counted(tmp_path):
    st = SubjectStore(warm_capacity=3, cold_dir=str(tmp_path))
    c = ServingCounters()
    st.bind(c)
    rows = [_row(i) for i in range(3)]
    for d, r in rows:
        st.demote(d, r)
    assert st.resize_warm(1) == {"warm_capacity": 1, "previous": 3,
                                 "evicted": 2}
    assert st.warm_digests() == [rows[2][0]]
    assert st.cold_digests() == sorted(d for d, _ in rows[:2])
    assert c.snapshot()["subject_store_resize_evictions"] == 2
    with pytest.raises(ValueError):
        st.resize_warm(0)


# ------------------------------------------------------- across packages
def test_port_pages_load_in_the_jax_store(tmp_path):
    """Pages the port's store writes are pages JAX's store adopts and
    promotes, bit for bit."""
    rows = [_row(i) for i in range(3)]
    st = SubjectStore(warm_capacity=1, cold_dir=str(tmp_path))
    st.bind(ServingCounters())
    for d, r in rows:
        st.demote(d, r)
    js = jstore.SubjectStore(warm_capacity=4, cold_dir=str(tmp_path),
                             backend="pickle")
    js.bind(JaxCounters())
    assert js.cold_digests() == st.cold_digests() == sorted(
        d for d, _ in rows[:2])
    for d, r in rows[:2]:
        handles, tier = js.fetch_row(d)
        assert tier == "cold"
        for k in ROW_KEYS:
            np.testing.assert_array_equal(np.asarray(handles[k]), r[k])


def test_jax_pages_load_in_the_port_store(tmp_path):
    """The reverse: JAX's store, pickle backend, pages; the port's store
    adopts and promotes them bit for bit, and the page files are JAX's
    layout (``orbax_ckpt.load_row_page`` reads the port's too)."""
    rows = [_row(10 + i) for i in range(3)]
    js = jstore.SubjectStore(warm_capacity=1, cold_dir=str(tmp_path),
                             backend="pickle")
    js.bind(JaxCounters())
    for d, r in rows:
        js.demote(d, r)
    st = SubjectStore(warm_capacity=4, cold_dir=str(tmp_path))
    c = ServingCounters()
    st.bind(c)
    assert st.cold_digests() == js.cold_digests()
    for d, r in rows[:2]:
        handles, tier = st.fetch_row(d)
        assert tier == "cold"
        for k in ROW_KEYS:
            np.testing.assert_array_equal(_host(handles[k]), r[k])
        meta, arrays = orbax_ckpt.load_row_page(d, str(tmp_path))
        assert meta["digest"] == d
    assert c.snapshot()["subject_store_cold_damage"] == 0


# ---------------------------------------------------------- engine wiring
def test_sharded_store_without_lanes_raises_jaxs_error(params32):
    store = SubjectStore(SubjectStoreConfig(sharded=True))
    with pytest.raises(ValueError,
                       match="a sharded subject_store requires lanes"):
        _engine(params32, subject_store=store)
    with pytest.raises(TypeError):
        _engine(params32, subject_store=object())
    with pytest.raises(ValueError, match="store_warm_capacity requires"):
        _engine(params32, store_warm_capacity=4)
    store = SubjectStore(warm_capacity=8)
    eng = _engine(params32, subject_store=store, store_warm_capacity=3)
    assert eng.subject_store is store and store.config.warm_capacity == 3


def test_promotions_equal_a_fresh_bake(params32, tmp_path):
    """A two-row table over six subjects, a two-row warm tier and a cold
    tier: every result — hot, warm-promoted, cold-promoted, and served
    after a damaged page's counted re-bake — equals a storeless engine's
    fresh bakes bit for bit, and every tier is exercised."""
    rng = np.random.default_rng(4)
    betas = rng.normal(size=(6, 10)).astype(np.float32)
    order = [0, 0, 1, 2, 3, 0, 4, 4, 1, 5, 2, 0, 3, 1, 4, 5]
    poses = [_pose(seed=100 + i) for i in range(len(order))]
    with _engine(params32, max_subjects=8) as ref:
        keys = [ref.specialize(b) for b in betas]
        want = [ref.forward(p, subject=keys[s])
                for p, s in zip(poses, order)]
    store = SubjectStore(warm_capacity=2, cold_dir=str(tmp_path))
    with _engine(params32, max_subjects=2, subject_store=store) as eng:
        assert eng.register_subjects(betas) == keys
        got = [eng.forward(p, subject=keys[s])
               for p, s in zip(poses, order)]
        # Damage one paged subject's page, then serve it: a counted
        # re-bake, the fresh bake's bits.
        victim = next(k for k in store.cold_digests()
                      if k not in store.warm_digests()
                      and k not in eng._subject_slots)
        page = store.cold_page_path(victim) / "state.pkl"
        page.write_bytes(page.read_bytes()[:40])
        s = keys.index(victim)
        again = eng.forward(poses[0], subject=victim)
        load = eng.load()["subject_store"]
    with _engine(params32, max_subjects=8) as ref:
        want_again = ref.forward(poses[0], subject=ref.specialize(betas[s]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(again, want_again)
    c = eng.counters.snapshot()
    assert c["subject_store_warm_hits"] >= 1
    assert c["subject_store_cold_hits"] >= 1
    assert c["subject_store_hot_hits"] >= 1
    assert c["subject_store_demotions_warm"] >= 1
    assert c["subject_store_demotions_cold"] >= 1
    assert c["subject_store_cold_damage"] == 1
    assert c["subject_store_misses"] >= 1
    # A store hit bakes nothing: the bakes are the misses.
    assert c["specializations"] == c["subject_store_misses"]
    assert load["warm_rows"] <= 2 and load["cold_pages"] >= 1


def test_prefetch_at_coalesce_admit(params32):
    """A warm subject's promotion is started at coalesce admit and
    consumed by its install."""
    store = SubjectStore(warm_capacity=4)
    b = np.random.default_rng(8).normal(size=(3, 10)).astype(np.float32)
    with _engine(params32, max_subjects=2, subject_store=store) as eng:
        keys = eng.register_subjects(b)
        for k in keys:                  # keys[0] demotes to warm
            eng.forward(_pose(), subject=k)
        assert keys[0] in store.warm_digests()
        eng.forward(_pose(seed=1), subject=keys[0])
    c = eng.counters.snapshot()
    assert c["subject_store_prefetches"] >= 1
    assert c["subject_store_warm_hits"] >= 1
    assert c["subject_store_promotion_ms"]["n"] >= 1


def test_eviction_under_stream_rebakes(params32):
    """A stream whose subject is evicted from the hot tier mid-session
    keeps its frames bit for bit (a warm promotion)."""
    rng = np.random.default_rng(11)
    betas0 = rng.normal(size=(10,)).astype(np.float32)
    with torch.no_grad():
        target = core.forward_batched(
            params32, torch.zeros((1, 16, 3)),
            torch.from_numpy(betas0)[None]).posed_joints[0].numpy()
    pose_frame = rng.normal(scale=0.4, size=(1, 16, 3)).astype(np.float32)
    with _engine(params32, max_subjects=8) as ref:
        with ref.open_stream(betas0, n_steps=4, data_term="joints") as sess:
            want = [sess.submit_frame(target).result(timeout=60)
                    for _ in range(2)]
    store = SubjectStore(warm_capacity=8)
    with _engine(params32, max_subjects=2, subject_store=store) as eng:
        with eng.open_stream(betas0, n_steps=4, data_term="joints") as sess:
            first = sess.submit_frame(target).result(timeout=60)
            for _ in range(2):
                b = rng.normal(size=(10,)).astype(np.float32)
                eng.forward(pose_frame, subject=eng.specialize(b))
            again = sess.submit_frame(target).result(timeout=60)
        c = eng.counters.snapshot()
    for got, ref_fr in ((first, want[0]), (again, want[1])):
        np.testing.assert_array_equal(got.verts, ref_fr.verts)
        np.testing.assert_array_equal(got.pose, ref_fr.pose)
    assert c["subject_store_demotions_warm"] >= 1
    assert c["subject_store_warm_hits"] >= 1


def test_load_subject_store_untorn(params32):
    store = SubjectStore(warm_capacity=4)
    with _engine(params32, max_subjects=2, subject_store=store) as eng:
        assert eng.subject_store is store
        stop = threading.Event()

        def churn():
            rng = np.random.default_rng(23)
            while not stop.is_set():
                store.demote(*_row(int(rng.integers(0, 1 << 30))))

        t = threading.Thread(target=churn)
        t.start()
        try:
            for _ in range(50):
                blk = eng.load()["subject_store"]
                assert set(blk) == {"warm_rows", "warm_capacity",
                                    "promotions_pending", "cold_pages",
                                    "cold_dir", "sharded", "shards",
                                    "reassigned_shards"}
                assert 0 <= blk["warm_rows"] <= blk["warm_capacity"]
                assert blk["sharded"] is False
                assert blk["shards"] is None
                assert blk["reassigned_shards"] == {}
        finally:
            stop.set()
            t.join()
    with _engine(params32) as bare:
        assert "subject_store" not in bare.load()


def test_register_subjects_density(params32):
    rng = np.random.default_rng(3)
    universe = rng.normal(size=(512, 10)).astype(np.float32)
    with _engine(params32, max_subjects=4) as eng:
        keys = eng.register_subjects(universe)
        assert len(keys) == 512
        assert keys == eng.register_subjects(universe)   # idempotent
        assert eng.counters.specializations == 0
        pose = _pose()
        got = eng.submit(pose, subject=keys[200]).result(timeout=60)
        want = eng.forward(pose, subject=eng.specialize(universe[200]))
        np.testing.assert_array_equal(got, want)


def _pose(n=1, seed=0):
    return np.random.default_rng(seed).normal(
        scale=0.4, size=(n, 16, 3)).astype(np.float32)
