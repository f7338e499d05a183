"""Continuous numerics monitoring for the serving stack: the port's
``NumericsSentinel``, with the JAX package's API and behaviour
(``mano_hand_tpu/obs/sentinel.py``; the port imports nothing of it).

A lattice entry loaded wrong, a stale static table under a CUDA graph, a
race on a program's static buffers, an abandoned attempt waking up, a
library regression, a chaos ``wrong`` fault: each returns plausible
floats that no retry, breaker or deadline will ever flag. The sentinel
turns a one-shot check into a standing one:

* **Golden input.** ``golden_inputs``: a fixed seed and fixed rows, the
  same bytes in every process (byte-equal to JAX's).
* **Every live program family, as served.** Each probe runs the golden
  input through the engine's OWN cached programs behind the same chaos
  wrap real dispatches take (``ServingEngine.numerics_probe_targets``):
  ``full``, the gathered f32 family (K2 under ``posed_kernel="fused"``),
  the gathered bf16 family (K2-bf16) and a CPU engine's CPU tier. Only
  programs already built are probed: a probe captures nothing and
  leaves ``compiles`` as it was.
* **Clean references, the same body.** Each served output is compared
  with its family's function called eagerly on the engine's device
  inside ``ieee_fp32()``, without the chaos wrap (K2 launched directly
  for the fused family). A CUDA-graph replay equals its eager function
  bit for bit, so an f32 family must match by digest (``max_abs_err``
  0.0). The bf16 family is judged by the ``PrecisionPolicy`` envelope
  against the f32 truth (the plain gathered forward), its digest against
  the bf16 reference beside it. A mismatch raises a ``numerics_drift``
  incident on the tracer (a flight recorder captures it), and each probe
  rides a span closed exactly once as ``probe``, ``drift`` or ``error``.
* **Committed goldens.** ``arm()`` digests the clean references at the
  committed shape and compares them with ``obs/goldens.json`` and
  ``obs/goldens_bf16.json``, keyed by ``params_digest`` and the torch
  device type (``cpu``, ``cuda``). A mismatch means the ENVIRONMENT
  drifted (another PyTorch, cuBLAS or card): ``numerics_golden_mismatch``,
  distinct from a serving drift. Regenerate with ``python -m
  mano_hand_tpu_torch.obs.sentinel --device {cuda,cpu}`` after an
  intentional numerics change.

On a card engine every reference runs on the card, under the engine's
device lock (a capture never overlaps it), never on the CPU; a probe of
a served program goes through ``_GraphProgram.run`` and its lock like a
dispatch. A probe pins the engine's card, whatever the calling thread's
current device. A failed probe is counted (``probe_errors``) and closes
its span as ``error``; it is never swallowed silently.

Threading: ``start()`` runs one daemon probe thread (a bounded
``Event.wait`` loop); every stamp is ``time.monotonic()``; ``status()``
exposes the last probe's age, so a wedged sentinel is itself visible.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from mano_hand_tpu_torch.obs import log as obs_log
from mano_hand_tpu_torch.obs.metrics import metric

GOLDENS_SCHEMA = 1
#: Committed golden-input identity: rows and seed are part of the golden
#: contract — change either and every committed digest is void.
GOLDEN_SEED = 20260804
GOLDEN_ROWS = 4

_LOG = obs_log.get_logger("obs.sentinel")


def default_goldens_path() -> Path:
    return Path(__file__).resolve().parent / "goldens.json"


def default_bf16_goldens_path() -> Path:
    """The committed bf16-tier goldens, beside goldens.json: a digest of
    the bf16 family's own output plus its error against the f32 truth,
    judged against the ``PrecisionPolicy`` envelope."""
    return Path(__file__).resolve().parent / "goldens_bf16.json"


def golden_inputs(n_joints: int, n_shape: int, rows: int = GOLDEN_ROWS,
                  seed: int = GOLDEN_SEED):
    """THE committed golden input: deterministic (fixed seed) pose and
    shape arrays — identical bytes every process, every asset with the
    same dims."""
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.4, size=(rows, n_joints, 3)).astype(
        np.float32)
    shape = rng.normal(size=(rows, n_shape)).astype(np.float32)
    return pose, shape


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def f32_digest(arr) -> str:
    """Content digest of an array's f32 bytes (the bit-identity
    comparator: two digests equal iff the outputs are f32 ``==``)."""
    a = np.ascontiguousarray(np.asarray(_host(arr), np.float32))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _on_card(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _full(params, pose: np.ndarray, shape: np.ndarray) -> torch.Tensor:
    """The full family's body (``ServingEngine._live_full``), eager."""
    from mano_hand_tpu_torch.models import core
    from mano_hand_tpu_torch.ops.common import ieee_fp32

    dev = params.v_template.device
    with torch.no_grad(), ieee_fp32():
        return core.forward_batched(params, _tensor(pose, dev),
                                    _tensor(shape, dev)).verts


def _cpu_tier(params, pose: np.ndarray, shape: np.ndarray) -> np.ndarray:
    """The CPU tier's body, on a CPU engine's params."""
    from mano_hand_tpu_torch.serving.engine import cpu_tier_forward

    return cpu_tier_forward(params, pose, shape)


def _gathered(table, idx: np.ndarray, pose: np.ndarray, fused: bool,
              compute_dtype=None) -> torch.Tensor:
    """A gathered family's body (``serving/engine.py:gather_body``),
    eager: K2 (or K2-bf16) launched directly under ``fused``, else the
    plain gathered forward."""
    from mano_hand_tpu_torch.ops.common import ieee_fp32
    from mano_hand_tpu_torch.serving.engine import gather_body

    dev = table.v_shaped.device
    with torch.no_grad(), ieee_fp32():
        return gather_body(fused, compute_dtype)(
            table, _tensor(idx, dev), _tensor(pose, dev))


def _prepared(params, device):
    dev = torch.device(device) if device is not None \
        else params.v_template.device
    return params.astype(torch.float32).to(dev)


@contextlib.contextmanager
def _golden_threads(device: torch.device):
    """One intra-op thread while a CPU golden is derived: a CPU product's
    summation order (so its bits) follows torch's thread count, which
    differs between machines and test workers. Process-wide, so a
    golden is derived while the engine is idle (``arm``)."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def reference_digests(params, rows: int = GOLDEN_ROWS,
                      seed: int = GOLDEN_SEED, device=None) -> dict:
    """Clean-path golden digests on ``device`` (default: the params'
    device) at the committed fixed shape — what ``commit_goldens``
    persists and ``arm()`` re-derives. ``full`` everywhere; ``cpu`` (the
    CPU tier's body) on the CPU only: a card's goldens never compute on
    the host. A CPU golden is derived single-threaded
    (``_golden_threads``)."""
    prm = _prepared(params, device)
    dev = prm.v_template.device
    pose, shape = golden_inputs(prm.n_joints, prm.n_shape, rows=rows,
                                seed=seed)
    with _golden_threads(dev):
        out = {"full": f32_digest(_full(prm, pose, shape))}
        if dev.type == "cpu":
            out["cpu"] = f32_digest(_cpu_tier(prm, pose, shape))
    return out


def _golden_table(params, rows: int = GOLDEN_ROWS, seed: int = GOLDEN_SEED):
    """A deterministic SubjectTable of the golden subjects on the params'
    device: row ``i`` bakes golden shape row ``i``."""
    from mano_hand_tpu_torch.models import core

    _, shape = golden_inputs(params.n_joints, params.n_shape, rows=rows,
                             seed=seed)
    dev = params.v_template.device
    with torch.no_grad():
        return core.stack_shaped([
            core.specialize(params, _tensor(shape[i], dev))
            for i in range(rows)])


def reference_digests_bf16(params, rows: int = GOLDEN_ROWS,
                           seed: int = GOLDEN_SEED, device=None) -> dict:
    """Clean bf16-tier golden record on ``device`` at the committed fixed
    shape: the plain bf16 gathered family's output digest plus its max
    abs error against the plain f32 gathered truth (JAX's record) —
    what ``commit_goldens_bf16`` persists and ``arm()`` re-derives."""
    prm = _prepared(params, device)
    pose, _ = golden_inputs(prm.n_joints, prm.n_shape, rows=rows, seed=seed)
    idx = np.arange(rows, dtype=np.int32)
    with _golden_threads(prm.v_template.device):
        table = _golden_table(prm, rows=rows, seed=seed)
        bf = _host(_gathered(table, idx, pose, False, torch.bfloat16))
        f32 = _host(_gathered(table, idx, pose, False))
    return {"gather_bf16": {
        "digest": f32_digest(bf),
        "max_abs_err_vs_f32": float(np.abs(
            bf.astype(np.float32) - f32.astype(np.float32)).max()),
    }}


def golden_key(params, device) -> str:
    """``<params_digest of the f32 params>:<torch device type>``: an
    engine serves float32, whatever the asset's storage dtype."""
    from mano_hand_tpu_torch.io.export_aot import params_digest

    return (f"{params_digest(params.astype(torch.float32))}:"
            f"{torch.device(device).type}")


def _commit_golden_file(params, path, derive, rows: int, seed: int,
                        device) -> dict:
    """Shared body of ``commit_goldens``/``commit_goldens_bf16``:
    merge-with-existing (one file carries every (params_digest, device
    type) pair ever committed; a damaged or schema/shape-mismatched file
    is rewritten whole), derive the entry, write sorted JSON."""
    prm = _prepared(params, device)
    data = {"schema": GOLDENS_SCHEMA, "rows": rows, "seed": seed,
            "entries": {}}
    if path.exists():
        try:
            old = json.loads(path.read_text())
            if (old.get("schema") == GOLDENS_SCHEMA
                    and old.get("rows") == rows
                    and old.get("seed") == seed):
                data["entries"] = dict(old.get("entries") or {})
        except (OSError, ValueError):
            pass   # damaged file: rewrite whole
    key = golden_key(prm, prm.v_template.device)
    data["entries"][key] = derive(prm, rows=rows, seed=seed)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return data


def commit_goldens(params, path=None, rows: int = GOLDEN_ROWS,
                   seed: int = GOLDEN_SEED, device=None) -> dict:
    """Write the committed-goldens file for ``params`` on ``device``
    (default: the params' device), merging with existing entries."""
    path = Path(path) if path is not None else default_goldens_path()
    return _commit_golden_file(params, path, reference_digests, rows, seed,
                               device)


def commit_goldens_bf16(params, path=None, rows: int = GOLDEN_ROWS,
                        seed: int = GOLDEN_SEED, device=None) -> dict:
    """Write the committed bf16-tier goldens (same merge/keying rules as
    ``commit_goldens``)."""
    path = Path(path) if path is not None else default_bf16_goldens_path()
    return _commit_golden_file(params, path, reference_digests_bf16, rows,
                               seed, device)


def load_goldens(path=None) -> Optional[dict]:
    path = Path(path) if path is not None else default_goldens_path()
    if not path.exists():
        return None
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if data.get("schema") != GOLDENS_SCHEMA:
        return None
    return data


_STATUS_CODE = {"unchecked": -1, "match": 0, "absent": 1, "mismatch": 2}


class NumericsSentinel:
    """Low-rate background numerics probe over one ``ServingEngine``.

    One instance per engine; ``probe()`` for a manual pass, ``start()``
    for the background loop. Thread-safe: one private lock guards the
    result/counter state, never held across device work or tracer calls.
    """

    def __init__(self, engine, tracer=None, interval_s: float = 60.0,
                 goldens_path=None, bf16_goldens_path=None,
                 clock=time.monotonic):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        self._engine = engine
        self._tracer = (tracer if tracer is not None
                        else getattr(engine, "tracer", None))
        self.interval_s = float(interval_s)
        self._goldens_path = goldens_path
        self._bf16_goldens_path = bf16_goldens_path
        self._clock = clock
        self._lock = threading.Lock()
        self.probes = 0
        self.drifts = 0
        self.probe_errors = 0
        self.golden_status = "unchecked"   # unchecked|match|mismatch|absent
        # The bf16 tier's committed-golden anchor; stays "unchecked" on an
        # engine whose tiers serve no bf16 (nothing to anchor).
        self.golden_bf16_status = "unchecked"
        self._last: Optional[dict] = None
        self._last_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- probing
    def arm(self) -> dict:
        """One-time baseline: derive the clean golden digests at the
        committed fixed shape on the engine's device and check them
        against the committed goldens (match / mismatch / absent for this
        (params_digest, device type)). A mismatch is ENVIRONMENT drift —
        incident ``numerics_golden_mismatch`` — not a serving-path fault;
        per-probe serving checks are independent of it."""
        t = self._engine.numerics_probe_targets()
        dev = t["device"]
        with _on_card(dev), t["device_lock"]:
            got = reference_digests(t["params"], device=dev)
        committed = load_goldens(self._goldens_path)
        key = golden_key(t["params"], dev)
        entry = (committed or {}).get("entries", {}).get(key)
        if entry is None:
            status = "absent"
        elif entry == got:
            status = "match"
        else:
            status = "mismatch"
            _LOG.warning(
                f"committed golden digests for {key} do not match this "
                f"environment (committed {entry}, derived {got}); "
                "regenerate with `python -m "
                "mano_hand_tpu_torch.obs.sentinel` if intentional")
            if self._tracer is not None:
                self._tracer.incident("numerics_golden_mismatch", key=key)
        out = {"golden_status": status, "key": key, "derived": got,
               "committed": entry}
        bf16_status = "unchecked"
        envelope = t.get("precision_envelope")
        if envelope is not None:
            # The derived record must reproduce the committed DIGEST and
            # its error against the f32 truth must sit inside the policy's
            # envelope; either failure is environment-level drift.
            with _on_card(dev), t["device_lock"]:
                got_bf16 = reference_digests_bf16(t["params"], device=dev)
            committed_bf16 = load_goldens(
                self._bf16_goldens_path
                if self._bf16_goldens_path is not None
                else default_bf16_goldens_path())
            entry_bf16 = (committed_bf16 or {}).get(
                "entries", {}).get(key)
            derived_err = got_bf16["gather_bf16"]["max_abs_err_vs_f32"]
            if entry_bf16 is None:
                bf16_status = "absent"
            elif entry_bf16 == got_bf16:
                bf16_status = "match"
            else:
                bf16_status = "mismatch"
            if derived_err > envelope:
                bf16_status = "mismatch"
            if bf16_status == "mismatch":
                _LOG.warning(
                    f"bf16-tier goldens for {key}: derived "
                    f"{got_bf16['gather_bf16']} vs committed "
                    f"{entry_bf16} at envelope {envelope}; regenerate "
                    "with `python -m mano_hand_tpu_torch.obs.sentinel` "
                    "if intentional")
                if self._tracer is not None:
                    self._tracer.incident("numerics_golden_mismatch",
                                          key=f"{key}:bf16")
            out.update({"golden_bf16_status": bf16_status,
                        "derived_bf16": got_bf16["gather_bf16"],
                        "committed_bf16": entry_bf16,
                        "envelope_m": envelope})
        with self._lock:
            self.golden_status = status
            self.golden_bf16_status = bf16_status
        return out

    @staticmethod
    def _compare(served, want) -> dict:
        served, want = _host(served), _host(want)
        rec = {
            "served_digest": f32_digest(served),
            "want_digest": f32_digest(want),
            "max_abs_err": float(np.abs(
                served.astype(np.float32) - want.astype(np.float32)).max()),
        }
        rec["drift"] = rec["served_digest"] != rec["want_digest"]
        return rec

    def _probe_families(self, t: dict) -> Dict[str, dict]:
        """Every live family of one ``numerics_probe_targets`` read: the
        served program beside its clean reference (computed under the
        engine's device lock). Each record carries its ``ms``: the served
        call and the reference, results on the host."""
        lock = t["device_lock"]
        pose, shape = golden_inputs(t["n_joints"], t["n_shape"])
        families: Dict[str, dict] = {}
        t0 = time.perf_counter()

        def timed(rec: dict) -> dict:
            nonlocal t0
            t1 = time.perf_counter()
            rec["ms"] = (t1 - t0) * 1e3
            t0 = t1
            return rec

        if t["full"]:
            b = min(t["full"])
            pp, ss = _pad_rows(pose, b), _pad_rows(shape, b)
            served = t["full"][b](pp, ss)
            with lock:
                want = _full(t["params"], pp, ss)
            families["full"] = timed(dict(bucket=b,
                                          **self._compare(served, want)))
        if t["cpu"]:
            b = min(t["cpu"])
            pp, ss = _pad_rows(pose, b), _pad_rows(shape, b)
            families["cpu"] = timed(dict(bucket=b, **self._compare(
                t["cpu"][b](pp, ss), _cpu_tier(t["params"], pp, ss))))
        table = t["table"]
        fused = bool(t.get("gather_fused"))
        if t["gather"] and table is not None:
            b = min(t["gather"])
            idx = np.zeros((b,), np.int32)   # row 0 always baked
            pp = _pad_rows(pose, b)
            served = t["gather"][b](table, idx, pp)
            with lock:
                want = _gathered(table, idx, pp, fused)
            families["gather"] = timed(dict(
                bucket=b, capacity=table.capacity,
                family="gather_fused" if fused else "gather",
                **self._compare(served, want)))
        if t.get("gather_bf16") and table is not None:
            # Judged by the policy's ENVELOPE against the f32 truth (the
            # plain gathered forward); the bf16 reference's digest rides
            # along as the exact comparator.
            b = min(t["gather_bf16"])
            idx = np.zeros((b,), np.int32)
            pp = _pad_rows(pose, b)
            served = _host(t["gather_bf16"][b](table, idx, pp))
            with lock:
                same = _gathered(table, idx, pp, fused, torch.bfloat16)
                truth = _host(_gathered(table, idx, pp, False))
            env = t.get("precision_envelope")
            rec = {
                "bucket": b, "capacity": table.capacity,
                "family": "gather_fused_bf16" if fused else "gather_bf16",
                "served_digest": f32_digest(served),
                "want_digest": f32_digest(same),
                "max_abs_err": float(np.abs(
                    served.astype(np.float32)
                    - truth.astype(np.float32)).max()),
                "envelope": env,
            }
            rec["drift"] = bool(
                (env is not None and rec["max_abs_err"] > env)
                or rec["served_digest"] != rec["want_digest"])
            families["gather_bf16"] = timed(rec)
        return families

    def probe(self) -> dict:
        """One probe pass NOW over every live family. Returns the result
        dict ({family: {served_digest, want_digest, drift, max_abs_err}},
        ...); a drift raises the ``numerics_drift`` incident. The probe's
        span closes exactly once whatever happens (terminal kind
        probe/drift/error)."""
        tr = self._tracer
        sid = tr.start("sentinel", tier=0, rows=GOLDEN_ROWS) \
            if tr is not None else None
        kind = "error"
        families: Dict[str, dict] = {}
        drifted: list = []
        try:
            t = self._engine.numerics_probe_targets()
            with _on_card(t["device"]):
                families = self._probe_families(t)
            drifted = [f for f, rec in families.items() if rec["drift"]]
            kind = "drift" if drifted else "probe"
        except Exception as e:  # noqa: BLE001 — counted, logged, reported
            with self._lock:
                self.probe_errors += 1
            _LOG.warning(
                f"numerics probe failed: {type(e).__name__}: {e}")
            families["probe_error"] = {"error": f"{type(e).__name__}: {e}"}
        finally:
            if tr is not None:
                tr.close(sid, kind, families=",".join(sorted(families)))
        result = {
            "families": families,
            "drift": bool(drifted),
            "drifted_families": drifted,
            "t_monotonic": self._clock(),
        }
        with self._lock:
            self.probes += 1
            if drifted:
                self.drifts += 1
            self._last = result
            self._last_t = result["t_monotonic"]
        if drifted and tr is not None:
            # Outside self._lock: the tracer runs incident hooks.
            tr.incident("numerics_drift", families=",".join(drifted),
                        err=max(families[f]["max_abs_err"]
                                for f in drifted))
        return result

    # --------------------------------------------------- background loop
    def start(self) -> "NumericsSentinel":
        """Arm the background probe: one daemon thread, one probe per
        ``interval_s``, BOUNDED wait (``Event.wait`` — stops promptly,
        never a bare retry loop)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mano-numerics-sentinel",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe()
            except Exception:  # noqa: BLE001 — probe() already records
                pass

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            # Bounded join: a probe wedged in a device call is abandoned
            # (daemon); the handle is cleared only when the thread really
            # exited, so a wedged probe keeps reading armed=True and a
            # later start() does not spawn a second loop beside it.
            t.join(timeout_s)
            if not t.is_alive():
                self._thread = None

    def __enter__(self) -> "NumericsSentinel":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- reporting
    def status(self) -> dict:
        """One lock-held copy of the sentinel's own accounting."""
        now = self._clock()
        with self._lock:
            return {
                "probes": self.probes,
                "drifts": self.drifts,
                "probe_errors": self.probe_errors,
                "golden_status": self.golden_status,
                "golden_bf16_status": self.golden_bf16_status,
                "armed": (self._thread is not None
                          and self._thread.is_alive()),
                "last_probe_age_s": (None if self._last_t is None
                                     else max(0.0, now - self._last_t)),
                "last": self._last,
            }

    def samples(self) -> dict:
        """Registry-collector form of ``status()`` (obs/metrics.py)."""
        st = self.status()
        out = {
            "sentinel_probes": metric(
                "counter", st["probes"], help="numerics probes run"),
            "sentinel_drifts": metric(
                "counter", st["drifts"],
                help="probes that detected numerics drift"),
            "sentinel_probe_errors": metric(
                "counter", st["probe_errors"],
                help="probes that failed to complete"),
            "sentinel_golden_status": metric(
                "gauge", _STATUS_CODE.get(st["golden_status"], -1),
                help="-1 unchecked, 0 match, 1 absent, 2 mismatch"),
            "sentinel_golden_bf16_status": metric(
                "gauge", _STATUS_CODE.get(st["golden_bf16_status"], -1),
                help="bf16-tier golden anchor: -1 unchecked, 0 match, "
                     "1 absent, 2 mismatch (envelope-judged)"),
            "sentinel_armed": metric(
                "gauge", 1.0 if st["armed"] else 0.0),
        }
        if st["last_probe_age_s"] is not None:
            out["sentinel_last_probe_age_s"] = metric(
                "gauge", st["last_probe_age_s"],
                help="seconds since the last completed probe")
        return out


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Golden rows padded (row-0 repeat) or truncated to the probe
    bucket — self-contained so the sentinel never imports the bucket
    policy it is auditing."""
    if arr.shape[0] >= rows:
        return np.ascontiguousarray(arr[:rows])
    pad = np.broadcast_to(arr[:1], (rows - arr.shape[0],) + arr.shape[1:])
    return np.ascontiguousarray(np.concatenate([arr, pad]))


def main(argv=None) -> int:
    """Regenerate the committed goldens for the synthetic asset on one
    device type: ``python -m mano_hand_tpu_torch.obs.sentinel --device
    {cuda,cpu}`` (default cuda, which raises without a card). Run it
    after an INTENTIONAL numerics change and justify the diff."""
    from mano_hand_tpu_torch.assets import synthetic_params
    from mano_hand_tpu_torch.ops.common import resolve_device

    ap = argparse.ArgumentParser(prog="python -m "
                                      "mano_hand_tpu_torch.obs.sentinel")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = synthetic_params(seed=0, device=dev)
    data = commit_goldens(params)
    print(f"goldens committed to {default_goldens_path()}: "
          f"{sorted(data['entries'])}")
    data16 = commit_goldens_bf16(params)
    print(f"bf16 goldens committed to {default_bf16_goldens_path()}: "
          f"{sorted(data16['entries'])}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
