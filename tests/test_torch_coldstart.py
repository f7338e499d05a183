"""Crash-safe restarts of the port's serving engine, on the CPU: the
port's tests of the JAX file ``tests/test_coldstart.py``, plus three
across the packages.

* the executable LATTICE (``io/export_aot.py:bake_lattice``) bakes every
  reachable program — full, gathered pose-only per capacity, the CPU
  tier — with params and table as runtime arguments; a loaded entry is
  bit for bit the live program's output;
* every damage class (truncated or corrupted entries, a schema bump, a
  digest or platform mismatch, a half-written or orbax-written
  checkpoint) degrades to a counted live build or re-specialization,
  never a crash;
* ``checkpoint_subjects``/``restore_subjects`` revive baked rows, betas
  and LRU order bit for bit, and a restore racing ``specialize`` stays
  consistent;
* checkpoints move between the packages both ways (JAX's pickle layout),
  and on the same traffic the port's CPU engine counts what the JAX
  engine counts, ``compiles`` included.

The cold-start drill (``serving/measure.py:cold_start_drill_run``) is
rehearsed with the other drills, in ``tests/test_torch_drills.py``.

Sizes are small (buckets 1-4, capacities 4-8, 2-4 subjects); the
lattice most tests read is baked once per module.
"""

import hashlib
import json
import shutil
import struct
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from mano_hand_tpu.io import orbax_ckpt
from mano_hand_tpu.serving.engine import ServingEngine as JaxEngine
from mano_hand_tpu_torch.assets import synthetic_params
from mano_hand_tpu_torch.io import export_aot as ea
from mano_hand_tpu_torch.io import state_ckpt
from mano_hand_tpu_torch.models import core
from mano_hand_tpu_torch.runtime import DispatchPolicy
from mano_hand_tpu_torch.serving import ServingEngine


@pytest.fixture(scope="module")
def params32():
    return synthetic_params(seed=0, device="cpu").astype(torch.float32)


@pytest.fixture(scope="module")
def lattice(params32, tmp_path_factory):
    """One baked lattice: full/b2, gather/b2/c4 and the CPU tier cpu/b2."""
    d = tmp_path_factory.mktemp("lattice")
    man = ea.bake_lattice(params32, d, buckets=[2], capacities=[4],
                          cpu_fallback=True)
    return d, man


def _copy(lattice, dst):
    shutil.copytree(lattice[0], dst)
    return dst


def _betas(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(10,)).astype(np.float32) for _ in range(n)]


def _pose(n, seed=0):
    rng = np.random.default_rng(100 + seed)
    return rng.normal(scale=0.4, size=(n, 16, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------- the lattice
def test_lattice_bake_manifest_and_bitwise_load(params32, lattice):
    """Every entry kind round-trips through disk bit for bit the live
    program of its family."""
    d, man = lattice
    assert man["schema"] == ea.LATTICE_SCHEMA_VERSION
    assert man["params_digest"] == ea.params_digest(params32)
    assert sorted(man["entries"]) == ["cpu/b2", "full/b2", "gather/b2/c4"]
    for ent in man["entries"].values():
        assert (d / ent["file"]).exists()
        assert ent["platforms"] == ["cpu"]
    assert json.loads((d / ea.LATTICE_MANIFEST).read_text()) == man
    lat = ea.load_lattice(d, params32)
    assert lat is not None and "full/b2" in lat

    pose, shape = _t(_pose(2)), _t(np.asarray(_betas(2, seed=5)))
    with torch.no_grad():
        live = core.forward_batched(params32, pose, shape).verts
        leaves = ea.params_leaves(params32)
        assert torch.equal(lat.get("full", 2)(leaves, pose, shape), live)
        assert torch.equal(lat.get("cpu", 2, platform="cpu")(
            leaves, pose, shape), live)
        tab = core.table_set_row(core.subject_table(params32, 4), 1,
                                 core.specialize(params32,
                                                 _t(_betas(1, seed=7)[0])))
        idx = torch.tensor([1, -3], dtype=torch.int32)
        glive = core.forward_posed_gather(tab, idx, pose).verts
        assert torch.equal(
            lat.get("gather", 2, 4)(ea.table_leaves(tab), idx, pose), glive)
    assert lat.get("full", 2) is lat.get("full", 2)     # cached: a dict hit
    assert lat.get("full", 8) is None                   # never baked


def _repack(path, **header):
    """Rewrite an entry's header fields (a bake for other platforms);
    returns the new bytes."""
    data = path.read_bytes()
    meta, blobs = ea._split_container(data)
    head = json.dumps({**{k: v for k, v in meta.items() if k != "programs"},
                       **header, "programs": [len(b) for b in blobs]}).encode()
    new = ea._MAGIC + struct.pack("<I", len(head)) + head + b"".join(blobs)
    path.write_bytes(new)
    return new


def test_lattice_damage_degrades_counted_never_raises(params32, lattice,
                                                      tmp_path):
    """Truncation, checksum corruption, schema bumps and digest mismatches
    each produce on_failure + None: the caller builds live; nothing raises
    out of the loader."""
    d = _copy(lattice, tmp_path / "lat")
    path = d / lattice[1]["entries"]["full/b2"]["file"]
    good = path.read_bytes()
    fails = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path.write_bytes(good[:40])                    # truncated entry
        lat = ea.load_lattice(d, params32,
                              on_failure=lambda k, r: fails.append(k))
        assert lat.get("full", 2) is None
        assert fails == ["full/b2"]
        assert lat.get("full", 2) is None              # counted once
        assert fails == ["full/b2"]
        path.write_bytes(good[:-1] + bytes([good[-1] ^ 0xFF]))   # flipped
        lat = ea.load_lattice(d, params32,
                              on_failure=lambda k, r: fails.append(k))
        assert lat.get("full", 2) is None
        path.write_bytes(good)
        mpath = d / ea.LATTICE_MANIFEST
        manifest = json.loads(mpath.read_text())
        manifest["schema"] += 1                        # the versioning rule
        mpath.write_text(json.dumps(manifest))
        assert ea.load_lattice(d, params32, on_failure=lambda k, r:
                               fails.append(k)) is None
        manifest["schema"] -= 1
        mpath.write_text(json.dumps(manifest))
        import dataclasses

        other = dataclasses.replace(
            params32, v_template=params32.v_template + 1e-3)
        assert ea.load_lattice(d, other, on_failure=lambda k, r:
                               fails.append(k)) is None
        # An entry whose own header disagrees with its manifest.
        new = _repack(path, params_digest="0" * 16)
        manifest["entries"]["full/b2"]["sha256"] = \
            hashlib.sha256(new).hexdigest()
        mpath.write_text(json.dumps(manifest))
        lat = ea.load_lattice(d, params32,
                              on_failure=lambda k, r: fails.append(k))
        assert lat.get("full", 2) is None
    assert fails == ["full/b2", "full/b2", "<manifest>", "<manifest>",
                     "full/b2"]
    empty = tmp_path / "nolattice"
    empty.mkdir()
    assert ea.load_lattice(empty, params32, on_failure=fails.append) is None
    assert len(fails) == 5


def test_lattice_platform_mismatch_degrades(params32, lattice, tmp_path):
    """An entry exported for another device type (a card-baked lattice
    booted on the CPU) is a counted degrade at get() time, not a device
    mismatch crash in the middle of boot; an engine on it warms up by
    building live, counted, without raising."""
    d = _copy(lattice, tmp_path / "lat")
    mpath = d / ea.LATTICE_MANIFEST
    manifest = json.loads(mpath.read_text())
    for key in ("full/b2", "gather/b2/c4"):
        ent = manifest["entries"][key]
        new = _repack(d / ent["file"], platforms=["cuda"])
        ent["sha256"], ent["platforms"] = (hashlib.sha256(new).hexdigest(),
                                           ["cuda"])
    mpath.write_text(json.dumps(manifest))
    fails = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lat = ea.load_lattice(d, params32,
                              on_failure=lambda k, r: fails.append(r))
        assert lat.get("full", 2, platform="cpu") is None
    assert fails and "not the running device type" in fails[0]
    eng = ServingEngine(params32, device="cpu", min_bucket=2, max_bucket=2,
                        max_subjects=4, aot_dir=d)
    with eng, pytest.warns(UserWarning):
        assert eng.warmup([2]) == {2: "jit"}
        eng.specialize(_betas(1)[0])
        assert eng.warmup_posed([2]) == {2: "jit"}
    assert eng.counters.aot_load_failures == 2
    assert eng.counters.compiles == 2 and eng.counters.aot_loads == 0


def test_bake_lattice_merges_same_digest_manifest(params32, lattice,
                                                  tmp_path):
    """Two configs sharing one directory union their entries; a re-bake
    never clobbers entries it did not rebuild; another asset's manifest
    is replaced whole."""
    d = _copy(lattice, tmp_path / "lat")
    man = ea.bake_lattice(params32, d, buckets=[1], capacities=[],
                          cpu_fallback=False)
    assert sorted(man["entries"]) == ["cpu/b2", "full/b1", "full/b2",
                                      "gather/b2/c4"]
    lat = ea.load_lattice(d, params32)
    assert lat.get("full", 2) is not None    # the first bake survived
    import dataclasses

    other = dataclasses.replace(params32,
                                v_template=params32.v_template + 1e-3)
    man = ea.bake_lattice(other, d, buckets=[1], capacities=[],
                          cpu_fallback=False)
    assert sorted(man["entries"]) == ["full/b1"]


# ------------------------------------------------- state checkpoints
def test_save_load_state_and_all_empty(tmp_path):
    meta = {"schema": 1, "digests": ["a", "b"], "capacity": 8}
    arrays = {"betas": np.arange(20, dtype=np.float32).reshape(2, 10),
              "empty": np.zeros((0, 10), np.float32)}
    state_ckpt.save_state(meta, arrays, tmp_path / "ck")
    m2, a2 = state_ckpt.load_state(tmp_path / "ck")
    assert m2["backend"] == "pickle" and m2["digests"] == ["a", "b"]
    np.testing.assert_array_equal(a2["betas"], arrays["betas"])
    assert a2["empty"].shape == (0, 10)          # the meta sidecar
    # All arrays empty this time: the previous save's rows stay dead.
    state_ckpt.save_state({"digests": []},
                          {"betas": np.zeros((0, 10), np.float32)},
                          tmp_path / "ck")
    m3, a3 = state_ckpt.load_state(tmp_path / "ck")
    assert m3["digests"] == [] and set(a3) == {"betas"}
    assert a3["betas"].shape == (0, 10)
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        state_ckpt.load_state(tmp_path / "nothing_here")


def test_state_layout_is_jaxs_pickle_layout_byte_for_byte(tmp_path):
    """The same (meta, arrays) written by both packages: equal files, and
    each package loads the other's."""
    meta = {"schema": 1, "digests": ["a"], "capacity": 4}
    arrays = {"betas": np.arange(10, dtype=np.float32).reshape(1, 10),
              "v_shaped": np.ones((1, 5, 3), np.float32),
              "none": np.zeros((0, 3), np.float32)}
    state_ckpt.save_state(meta, arrays, tmp_path / "port")
    orbax_ckpt.save_state(meta, arrays, tmp_path / "jax", backend="pickle")
    for name in ("state_meta.json", "state.pkl"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    for load, src in ((state_ckpt.load_state, "jax"),
                      (orbax_ckpt.load_state, "port")):
        m, a = load(tmp_path / src)
        assert m["digests"] == ["a"] and a["none"].shape == (0, 3)
        np.testing.assert_array_equal(a["v_shaped"], arrays["v_shaped"])


def test_row_pages_round_trip(tmp_path):
    rows = {"v_shaped": np.ones((5, 3), np.float32),
            "shape": np.arange(10, dtype=np.float32)}
    state_ckpt.save_row_page("abc", rows, tmp_path)
    state_ckpt.save_row_page("abd", rows, tmp_path)
    (tmp_path / "row-zzz").mkdir()              # a page whose meta never landed
    assert state_ckpt.list_row_pages(tmp_path) == ["abc", "abd"]
    assert state_ckpt.list_row_pages(tmp_path / "absent") == []
    meta, got = state_ckpt.load_row_page("abc", tmp_path)
    assert meta["kind"] == "subject_row_page" and meta["digest"] == "abc"
    np.testing.assert_array_equal(got["shape"], rows["shape"])
    # The same page JAX writes: the same bytes.
    orbax_ckpt.save_row_page("abc", rows, tmp_path / "jax", backend="pickle")
    assert ((tmp_path / "jax" / "row-abc" / "state.pkl").read_bytes()
            == state_ckpt.row_page_path("abc", tmp_path).joinpath(
                "state.pkl").read_bytes())


# ------------------------------------------------- the engine
def test_engine_cold_boot_zero_compiles_bitwise(params32, tmp_path):
    """The acceptance shape: a warm engine bakes its lattice and a
    checkpoint; a fresh engine boots with ZERO live builds
    (``warmup``/``warmup_posed`` report "aot") and serves both request
    kinds bit for bit as the engine before the restart."""
    ck = tmp_path / "subjects"
    betas, pose = _betas(3, seed=1), _pose(2, seed=2)
    kw = dict(device="cpu", min_bucket=1, max_bucket=2, max_subjects=4,
              aot_dir=tmp_path)
    eng1 = ServingEngine(params32, **kw)
    with eng1:
        keys = [eng1.specialize(b) for b in betas]
        assert eng1.warmup() == {1: "jit", 2: "jit"}
        assert eng1.warmup() == {1: "cached", 2: "cached"}
        assert eng1.warmup_posed() == {1: "jit", 2: "jit"}
        man = eng1.bake_lattice()
        want_full = eng1.forward(pose)
        want_posed = eng1.forward(pose, subject=keys[1])
        eng1.checkpoint_subjects(ck)
    assert sorted(man["entries"]) == ["full/b1", "full/b2", "gather/b1/c4",
                                      "gather/b2/c4"]
    assert eng1.counters.compiles == 4
    assert sorted(p.name.split("_")[-1] for p in tmp_path.glob(
        "serve_*.torchexp")) == ["b1.torchexp", "b2.torchexp"]

    eng2 = ServingEngine(params32, **kw)
    with eng2:
        assert eng2.restore_subjects(ck) == {"restored": 3, "betas_only": 0,
                                             "skipped": 0}
        assert eng2.warmup() == {1: "aot", 2: "aot"}
        assert eng2.warmup_posed() == {1: "aot", 2: "aot"}
        got_full = eng2.forward(pose)
        got_posed = eng2.forward(pose, subject=keys[1])
    assert eng2.counters.compiles == 0
    assert eng2.counters.aot_loads == 4
    assert eng2.counters.subjects_restored == 3
    assert eng2.counters.specializations == 0
    np.testing.assert_array_equal(got_full, want_full)
    np.testing.assert_array_equal(got_posed, want_posed)


def test_legacy_artifact_serves_without_a_lattice(params32, tmp_path):
    """Without a lattice, a live full build writes the legacy per-bucket
    artifact and the next engine loads it; a truncated one is counted and
    rebuilt."""
    kw = dict(device="cpu", min_bucket=2, max_bucket=2, aot_dir=tmp_path)
    pose = _pose(2, seed=4)
    with ServingEngine(params32, **kw) as eng1:
        assert eng1.warmup() == {2: "jit"}
        want = eng1.forward(pose)
    with ServingEngine(params32, **kw) as eng2:
        assert eng2.warmup() == {2: "aot"}
        np.testing.assert_array_equal(eng2.forward(pose), want)
    (art,) = tmp_path.glob("serve_*_b2.torchexp")
    art.write_bytes(art.read_bytes()[:100])
    eng3 = ServingEngine(params32, **kw)
    with eng3, pytest.warns(UserWarning, match="invalid serving artifact"):
        assert eng3.warmup() == {2: "jit"}
    assert eng3.counters.aot_load_failures == 1
    assert eng3.counters.compiles == 1
    assert ea.load_forward(art).meta["batch"] == 2     # rewritten whole


def test_checkpoint_restore_lru_and_evicted(params32, tmp_path):
    """LRU order and evicted-but-registered betas survive the round trip;
    the evicted subject is servable again."""
    betas = _betas(4, seed=3)
    eng1 = ServingEngine(params32, device="cpu", max_bucket=2,
                         max_subjects=3)
    with eng1:
        keys = [eng1.specialize(b) for b in betas[:3]]
        eng1.specialize(betas[0])       # key 0 becomes the most recent
        k3 = eng1.specialize(betas[3])  # evicts key 1, the oldest
    assert eng1.counters.specializations_evicted == 1
    ck = tmp_path / "subjects"
    eng1.checkpoint_subjects(ck)
    meta, arrays = state_ckpt.load_state(ck)
    assert meta["backend"] == "pickle" and meta["schema"] == 1
    assert meta["evicted_digests"] == [keys[1]]
    assert meta["digests"] == [keys[2], keys[0], k3]
    np.testing.assert_array_equal(arrays["evicted_betas"][0], betas[1])

    eng2 = ServingEngine(params32, device="cpu", max_bucket=2,
                         max_subjects=3)
    with eng2:
        rs = eng2.restore_subjects(ck)
        assert rs == {"restored": 3, "betas_only": 1, "skipped": 0}
        assert list(eng2._subject_lru) == [keys[2], keys[0], k3]
        got = eng2.forward(_pose(1, seed=9), subject=keys[1])
        want = eng1.forward(_pose(1, seed=9), subject=keys[1])
    np.testing.assert_array_equal(got, want)
    assert eng2.counters.subjects_restored == 3


def test_restore_damage_degrades_and_strict_raises(params32, tmp_path):
    ck = tmp_path / "subjects"
    eng1 = ServingEngine(params32, device="cpu", max_bucket=2)
    with eng1:
        eng1.specialize(_betas(1)[0])
        eng1.checkpoint_subjects(ck)
    meta_file = ck / "state_meta.json"
    good = meta_file.read_text()
    # Half-written: the meta lands last, so a torn meta is the signature.
    meta_file.write_text(good[: len(good) // 2])
    eng2 = ServingEngine(params32, device="cpu", max_bucket=2)
    with pytest.warns(UserWarning, match="restoring nothing"):
        rs = eng2.restore_subjects(ck)
    assert rs["restored"] == 0 and "error" in rs
    with pytest.raises(Exception):
        eng2.restore_subjects(ck, strict=True)
    # Written by JAX's orbax backend: named, degraded.
    meta_file.write_text(good.replace('"backend": "pickle"',
                                      '"backend": "orbax"'))
    with pytest.warns(UserWarning, match="orbax"):
        rs = eng2.restore_subjects(ck)
    assert rs["restored"] == 0 and "orbax" in rs["error"]
    meta_file.write_text(good)
    import dataclasses

    other = dataclasses.replace(params32,
                                v_template=params32.v_template + 1e-3)
    eng3 = ServingEngine(other, device="cpu", max_bucket=2)
    with pytest.warns(UserWarning, match="params_digest"):
        rs = eng3.restore_subjects(ck)
    assert rs["restored"] == 0 and "error" in rs
    assert eng3.counters.subjects_restored == 0
    assert eng2.counters.subjects_restored == 0
    assert eng2.restore_subjects(ck)["restored"] == 1


def test_restore_racing_specialize_stays_consistent(params32, tmp_path):
    """A subject a racing specialize already installed is skipped, never
    installed twice: one digest, one row, one count — sequentially, and
    with the two on two threads at once."""
    ck = tmp_path / "subjects"
    betas = _betas(6, seed=11)
    eng1 = ServingEngine(params32, device="cpu", max_bucket=2)
    with eng1:
        keys = [eng1.specialize(b) for b in betas]
        eng1.checkpoint_subjects(ck)
        rows = {k: core.table_row(eng1.table, eng1._subject_slots[k])
                for k in keys}

    eng2 = ServingEngine(params32, device="cpu", max_bucket=2)
    with eng2:
        assert eng2.specialize(betas[0]) == keys[0]
        rs = eng2.restore_subjects(ck)
        assert rs == {"restored": 5, "betas_only": 0, "skipped": 1}
        assert eng2.counters.specializations == 1
        assert eng2.counters.subjects_restored == 5
        assert len(eng2._subject_slots) == 6
        got = [eng2.forward(_pose(1, seed=4), subject=k) for k in keys[:2]]
        want = [eng1.forward(_pose(1, seed=4), subject=k) for k in keys[:2]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for trial in range(3):
            eng = ServingEngine(params32, device="cpu", max_bucket=2)
            out = {}
            ths = [threading.Thread(target=lambda: out.update(
                       rs=eng.restore_subjects(ck))),
                   threading.Thread(target=lambda: [
                       eng.specialize(b) for b in betas[::-1]])]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
                assert not th.is_alive()
            c = eng.counters
            assert len(eng._subject_slots) == 6, trial
            assert len(set(eng._subject_slots.values())) == 6, trial
            assert c.specializations + c.subjects_restored == 6, trial
            assert out["rs"]["restored"] + out["rs"]["skipped"] == 6, trial
            for k in keys:
                row = core.table_row(eng.table, eng._subject_slots[k])
                assert torch.equal(row.v_shaped, rows[k].v_shaped), trial
                assert torch.equal(row.joints, rows[k].joints), trial
    finally:
        sys.setswitchinterval(old)


# --------------------------------------------- across the two packages
@pytest.fixture(scope="module")
def jax_params(params):
    return params.astype(np.float32)


def _jax_rows(eng, keys):
    slots = [eng._subject_slots[k] for k in keys]
    return {n: np.asarray(getattr(eng._table, n))[slots]
            for n in ("v_shaped", "joints", "shape")}


def _port_rows(eng, keys):
    slots = [eng._subject_slots[k] for k in keys]
    return {n: getattr(eng.table, n)[slots].numpy()
            for n in ("v_shaped", "joints", "shape")}


def test_jax_checkpoint_restores_into_the_port(params32, jax_params,
                                               tmp_path, monkeypatch):
    """A JAX engine's checkpoint (its pickle backend) restores into the
    port's engine: the same digests, LRU order and rows, bit for bit."""
    betas = _betas(3, seed=21)
    jeng = JaxEngine(jax_params, max_bucket=2, inflight_depth=1)
    keys = [jeng.specialize(b) for b in betas]
    monkeypatch.setattr(orbax_ckpt, "available", lambda: False)
    jeng.checkpoint_subjects(tmp_path / "ck")
    assert state_ckpt.load_state(tmp_path / "ck")[0]["backend"] == "pickle"
    eng = ServingEngine(params32, device="cpu", max_bucket=2)
    assert eng.restore_subjects(tmp_path / "ck") == {
        "restored": 3, "betas_only": 0, "skipped": 0}
    assert list(eng._subject_lru) == list(jeng._subject_lru) == keys
    want, got = _jax_rows(jeng, keys), _port_rows(eng, keys)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    assert eng.counters.specializations == 0


def test_port_checkpoint_restores_into_jax(params32, jax_params, tmp_path):
    """The reverse: the port's checkpoint restores into the JAX engine,
    rows bit for bit, LRU order and evicted betas kept."""
    betas = _betas(4, seed=22)
    eng = ServingEngine(params32, device="cpu", max_bucket=2, max_subjects=3)
    keys = [eng.specialize(b) for b in betas]       # keys[0] evicted
    eng.checkpoint_subjects(tmp_path / "ck")
    jeng = JaxEngine(jax_params, max_bucket=2, max_subjects=3,
                     inflight_depth=1)
    assert jeng.restore_subjects(tmp_path / "ck") == {
        "restored": 3, "betas_only": 1, "skipped": 0}
    assert list(jeng._subject_lru) == keys[1:]
    assert keys[0] in jeng._subject_betas
    want, got = _port_rows(eng, keys[1:]), _jax_rows(jeng, keys[1:])
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def _counters_twin(params32, jax_params, pipe):
    """The same traffic through both engines at the dispatch settings
    ``pipe``; the port's counters must equal JAX's."""
    rng = np.random.default_rng(5)
    betas = _betas(12, seed=23)
    traffic = [(rng.normal(scale=0.4, size=(int(n), 16, 3)).astype(
                    np.float32),
                rng.normal(size=(int(n), 10)).astype(np.float32), i % 3)
               for i, n in enumerate(rng.integers(1, 5, size=20))]

    def run(make):
        eng = make(DispatchPolicy(cpu_fallback=True, retries=0))
        outs = []
        with eng:
            keys = [eng.specialize(b) for b in betas[:3]]
            eng.warmup([1, 2])
            eng.warmup_posed([2])
            posed = 0
            for pose, shape, kind in traffic:
                if kind == 0:
                    outs.append(eng.forward(pose, shape))
                else:     # subjects 3, 4, ... 11, then 0, 1, ... again
                    posed += 1
                    k = eng.specialize(betas[(2 + posed) % len(betas)])
                    outs.append(eng.forward(pose, subject=k))
            outs.append(eng.forward(traffic[0][0], subject=keys[0]))
        return outs, eng.counters.snapshot()

    po, ps = run(lambda pol: ServingEngine(
        params32, device="cpu", max_bucket=4, max_subjects=9, policy=pol,
        **pipe))
    jo, js = run(lambda pol: JaxEngine(
        jax_params, max_bucket=4, max_subjects=9, policy=pol, **pipe))
    assert ps["table_growths"] >= 1 and ps["specializations_evicted"] >= 1
    assert ps["compiles"] > 0
    shared = set(ps) - {"dispatches_bf16", "dispatches_gathered"}
    assert shared <= set(js)
    assert {k: ps[k] for k in shared} == {k: js[k] for k in shared}
    for a, b in zip(po, jo):
        assert float(np.abs(a - np.asarray(b)).max()) <= 1e-6
    return ps


def test_counters_match_the_jax_engine_compiles_included(params32,
                                                         jax_params):
    """The same traffic through both engines — warm-ups, both request
    kinds, a table growth (whose stale gathered programs rebuild), LRU
    evictions and the CPU tier's build under a policy — at serial
    dispatch: every counter the port keeps equals JAX's, ``compiles``
    included (the port's extra keys, ``dispatches_bf16`` and
    ``dispatches_gathered``, aside)."""
    ps = _counters_twin(params32, jax_params, {
        "inflight_depth": 1, "adaptive_coalesce": False})
    assert ps["pipeline_completions"] == 0


def test_counters_match_the_jax_engine_at_the_jax_defaults(params32,
                                                           jax_params):
    """The same traffic with both engines pipelined (JAX's defaults):
    the counters still agree, the completion stage's included."""
    ps = _counters_twin(params32, jax_params, {
        "inflight_depth": 2, "adaptive_coalesce": True})
    assert ps["pipeline_completions"] == ps["dispatches"] > 0

