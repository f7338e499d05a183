"""Exportable metrics registry + SLO accounting: a copy of the JAX
package's ``obs/metrics.py`` (the port imports nothing of that package).

The serving stack reports itself through ``ServingCounters``/``load()``
snapshots with no export format and no objective to judge against: an
operator can ask "what happened" but not "are we meeting the SLO", and
nothing external can scrape either answer. This module is the aggregate
health surface:

* **Instruments.** ``Counter`` (monotone), ``Gauge`` (set-point), and
  ``Quantile`` (bounded-reservoir summary — the ServingCounters
  ``_LATENCY_RESERVOIR`` reasoning) registered on a ``MetricsRegistry``.
* **Collectors.** The existing telemetry sources register as pull
  collectors: ``engine_registry(engine)`` absorbs
  ``ServingCounters.snapshot()``, ``ServingEngine.load()``, the tracer
  accounting, and the per-tier SLO report — each source is read in ITS
  one lock hold (the torn-telemetry rule), and the registry's own
  instruments are copied in one registry-lock hold. A collector that
  raises degrades to an ``errors`` entry in the snapshot — telemetry
  must never take the dispatch path down.
* **Export.** ``snapshot()`` is the JSON form; ``prometheus_text``
  renders any snapshot (live or re-loaded from disk) as
  Prometheus-text exposition; ``export_metrics_dir`` persists both.
* **SLOs.** ``slo_report`` turns one counters snapshot into per-tier
  objective accounting: goodput (served/offered), deadline hit rate
  (served/(served+expired)), shed fraction — each with an error-budget
  BURN RATE (actual badness / budgeted badness; > 1.0 means the tier is
  spending budget faster than the objective allows).
  ``serving.measure.metrics_overhead_run`` carries the report.

Naming: every exported metric is ``<namespace>_<name>`` (default
namespace ``mano``); counters get no ``_total`` suffix magic — the
``# TYPE`` line is the contract, and the JSON snapshot carries the type
explicitly.

Counter-drift guard: ``serving_samples`` derives its
metrics GENERICALLY from the snapshot dict — a new ``ServingCounters``
field appears in the export automatically, and a field of a shape this
mapper does not understand is surfaced as a non-zero
``serving_unexported_keys`` gauge instead of vanishing
(tests/test_torch_metrics.py pins both directions).

Clock discipline: ages and uptimes stamp ``time.monotonic()``;
wall-clock appears only as a human-readable
export label, never in arithmetic.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

METRICS_SCHEMA = 1

#: Bounded per-instrument sample reservoir (the ServingCounters
#: _LATENCY_RESERVOIR reasoning at registry scale).
_RESERVOIR = 2048

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: ServingCounters snapshot keys that are high-water marks or ratios —
#: exported as gauges; every other scalar is a monotone counter.
_SERVING_GAUGE_KEYS = frozenset({
    "queue_depth_peak", "backlog_peak", "padding_waste",
    "coalesce_width_mean",
    # Dispatch-pipeline occupancy high-water: how much of
    # ``inflight_depth`` the completion stage actually used.
    "pipeline_inflight_peak",
})


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match {_NAME_RE.pattern} "
            "(prometheus-compatible, namespace added at export)")
    return name


class Counter:
    """Monotone event count. ``inc`` only — a counter that can go down
    is a gauge wearing the wrong ``# TYPE`` line."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name}: inc({n}) would decrease a "
                "monotone counter (use a Gauge)")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self) -> List[Tuple[Optional[dict], float]]:
        return [(None, self.value)]


class Gauge:
    """A set-point that moves both ways (backlog, table capacity, …)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self) -> List[Tuple[Optional[dict], float]]:
        return [(None, self.value)]


class Quantile:
    """Bounded-reservoir summary: ``observe`` samples, export p50/p99
    (+ count). Ring overwrite on a per-instrument cursor so a long-lived
    server cannot grow memory with traffic (the ServingCounters
    ``record_latency`` pattern)."""

    kind = "quantile"

    def __init__(self, name: str, help: str = "",
                 capacity: int = _RESERVOIR):
        self.name = _check_name(name)
        self.help = help
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._samples_buf: List[float] = []
        self._writes = 0

    def observe(self, v: float) -> None:
        with self._lock:
            if len(self._samples_buf) >= self.capacity:
                self._samples_buf[self._writes % self.capacity] = float(v)
            else:
                self._samples_buf.append(float(v))
            self._writes += 1

    def _samples(self) -> List[Tuple[Optional[dict], float]]:
        with self._lock:
            buf = list(self._samples_buf)
            n = self._writes
        out: List[Tuple[Optional[dict], float]] = []
        if buf:
            arr = np.asarray(buf)
            out.append(({"quantile": "0.5"},
                        float(np.percentile(arr, 50))))
            out.append(({"quantile": "0.99"},
                        float(np.percentile(arr, 99))))
        out.append(({"stat": "count"}, float(n)))
        return out


def sample(value: float, labels: Optional[dict] = None) -> list:
    """One normalized sample: ``[labels-or-None, value]`` — the shape
    collectors return and the exporters consume."""
    return [dict(labels) if labels else None, float(value)]


def metric(kind: str, value=None, *, help: str = "",
           samples: Optional[list] = None) -> dict:
    """One normalized metric struct for a collector's return dict."""
    if samples is None:
        samples = [sample(value)]
    return {"type": kind, "help": help, "samples": samples}


class MetricsRegistry:
    """Lock-light instrument registry with atomic snapshots.

    Thread-safe: submitters/dispatchers tick instruments under each
    instrument's own lock; ``snapshot()`` copies the instrument TABLE
    in one registry-lock hold, then reads each instrument and collector
    OUTSIDE it (each source is internally atomic — its own one lock
    hold), so a scrape never blocks a writer for longer than one copy
    and never publishes a torn view of any single source. Cross-source
    skew (the serving block an instant older than a gauge beside it) is
    inherent to multi-source scraping and documented, not hidden.
    """

    def __init__(self, namespace: str = "mano"):
        self.namespace = _check_name(namespace)
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._collectors: List[Tuple[str, Callable[[], dict]]] = []

    # ------------------------------------------------------- registration
    def _register(self, inst):
        with self._lock:
            cur = self._instruments.get(inst.name)
            if cur is not None:
                if type(cur) is not type(inst):
                    raise ValueError(
                        f"metric {inst.name!r} already registered as "
                        f"{type(cur).__name__}")
                return cur
            self._instruments[inst.name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def quantile(self, name: str, help: str = "",
                 capacity: int = _RESERVOIR) -> Quantile:
        return self._register(Quantile(name, help, capacity=capacity))

    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """``fn() -> {metric_name: metric-struct}`` pulled per snapshot.
        The callable owns its atomicity (one lock hold per source)."""
        with self._lock:
            self._collectors.append((_check_name(name), fn))

    # ------------------------------------------------------------ readers
    def snapshot(self) -> dict:
        """The JSON export: every instrument + every collector, each
        read atomically; a failing collector degrades to an ``errors``
        entry (telemetry never crashes the path it observes)."""
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        metrics: Dict[str, dict] = {}
        for inst in instruments:
            metrics[inst.name] = {
                "type": inst.kind,
                "help": inst.help,
                "samples": [[labels, value]
                            for labels, value in inst._samples()],
            }
        errors: Dict[str, str] = {}
        for name, fn in collectors:
            try:
                got = fn()
            except Exception as e:  # noqa: BLE001 — degrade, never raise
                errors[name] = f"{type(e).__name__}: {e}"
                continue
            for mname, struct in got.items():
                metrics[_check_name(mname)] = struct
        out = {
            "schema": METRICS_SCHEMA,
            "namespace": self.namespace,
            "t_monotonic": time.monotonic(),
            "wall_time_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "metrics": metrics,
        }
        if errors:
            out["errors"] = errors
        return out

    def prometheus(self) -> str:
        return prometheus_text(self.snapshot())


#: The persisted-scrape filename contract — ONE definition shared by
#: every writer (``metrics_overhead_run``'s ``metrics_dir``) and every
#: reader: a rename applied to one side cannot silently break the other.
METRICS_JSON = "metrics.json"
METRICS_PROM = "metrics.prom"
SLO_JSON = "slo.json"


def export_metrics_dir(snapshot: dict, out_dir, slo: Optional[dict]
                       = None) -> dict:
    """Persist one registry snapshot into ``out_dir`` as the JSON +
    Prometheus-text pair (+ the SLO report when given); returns the
    written paths. Raises OSError on an unwritable dir — callers own
    the degrade-vs-crash decision."""
    import json
    from pathlib import Path

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / METRICS_JSON).write_text(json.dumps(snapshot))
    (d / METRICS_PROM).write_text(prometheus_text(snapshot))
    out = {"metrics_json": str(d / METRICS_JSON),
           "metrics_prom": str(d / METRICS_PROM)}
    if slo is not None:
        (d / SLO_JSON).write_text(json.dumps(slo))
        out["slo_json"] = str(d / SLO_JSON)
    return out


def _prom_name(name: str) -> str:
    """Exposition-safe metric/label NAME: once requests arrive over
    the wire, bucket/kind/subject strings are user-influenced
    and may reach a label key or a reloaded snapshot's metric name —
    anything outside ``[a-zA-Z_][a-zA-Z0-9_]*`` is folded to ``_`` so
    the text format stays parseable (values are escaped, names cannot
    be)."""
    name = re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(value: str) -> str:
    """Exposition-format label-value escaping: ``\\`` first (so the
    escapes below cannot be double-escaped), then ``"`` and newlines;
    a bare CR is folded into the newline escape — the format is
    line-delimited and an unescaped CR would tear a sample line in
    CRLF-aware parsers."""
    value = str(value).replace("\\", "\\\\").replace('"', '\\"')
    value = value.replace("\r\n", "\n").replace("\r", "\n")
    return value.replace("\n", "\\n")


def _prom_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    parts = [f'{_prom_name(k)}="{_prom_escape(v)}"'
             for k, v in sorted(labels.items())]
    return "{" + ",".join(parts) + "}"


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot (live, or re-loaded from the JSON
    ``export_metrics_dir`` persisted) as Prometheus text exposition.
    Pure function of the snapshot, so the text form can be served
    without the process that owned the registry."""
    ns = _prom_name(snapshot.get("namespace", "mano"))
    lines: List[str] = []
    # "quantile" summaries render as untyped gauges per-quantile —
    # prometheus's native summary type requires _sum/_count pairs this
    # registry deliberately does not fake.
    type_map = {"counter": "counter", "gauge": "gauge",
                "quantile": "gauge"}
    for name in sorted(snapshot.get("metrics", {})):
        m = snapshot["metrics"][name]
        # Re-sanitize here, not just at registration: this renderer
        # also serves snapshots RE-LOADED from disk whose names never
        # passed _check_name.
        full = f"{ns}_{_prom_name(name)}"
        if m.get("help"):
            esc = str(m["help"]).replace("\\", "\\\\")
            esc = esc.replace("\r\n", " ").replace("\r", " ")
            esc = esc.replace("\n", " ")
            lines.append(f"# HELP {full} {esc}")
        lines.append(f"# TYPE {full} {type_map.get(m.get('type'), 'gauge')}")
        for labels, value in m.get("samples", []):
            v = float(value)
            txt = ("NaN" if np.isnan(v)
                   else ("+Inf" if v == np.inf
                         else ("-Inf" if v == -np.inf else repr(v))))
            lines.append(f"{full}{_prom_labels(labels)} {txt}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------- collectors
def serving_samples(snap: dict) -> dict:
    """``ServingCounters.snapshot()`` -> metric structs, derived
    GENERICALLY so a newly added counter field cannot silently skip the
    export (the counter-drift guard): scalars become
    ``serving_<key>`` counters/gauges, the per-tier ledgers become
    tier-labeled counters, the latency table becomes bucket-labeled
    gauges — and any key of a shape this mapper does not understand is
    counted in ``serving_unexported_keys`` (a non-zero value IS the
    drift alarm; the introspection test pins it at zero)."""
    out: Dict[str, dict] = {}
    unexported = 0
    for key, val in snap.items():
        if key == "tiers" and isinstance(val, dict):
            fields: Dict[str, list] = {}
            for tier, ledger in val.items():
                if not isinstance(ledger, dict):
                    unexported += 1
                    continue
                for f, v in ledger.items():
                    fields.setdefault(f, []).append(
                        sample(v, {"tier": tier}))
            for f, samples in fields.items():
                out[f"serving_tier_{f}"] = metric(
                    "counter", help=f"per-tier {f} ledger",
                    samples=samples)
        elif key == "latency_by_bucket" and isinstance(val, dict):
            p50, p99, counts = [], [], []
            for bucket, q in val.items():
                lb = {"bucket": str(bucket)}
                p50.append(sample(q.get("p50_ms", 0.0), lb))
                p99.append(sample(q.get("p99_ms", 0.0), lb))
                counts.append(sample(q.get("n", 0), lb))
            if p50:
                out["serving_latency_p50_ms"] = metric(
                    "gauge", help="per-bucket request latency p50",
                    samples=p50)
                out["serving_latency_p99_ms"] = metric(
                    "gauge", help="per-bucket request latency p99",
                    samples=p99)
                out["serving_latency_samples"] = metric(
                    "gauge", help="per-bucket latency sample count",
                    samples=counts)
        elif key == "subject_store_promotion_ms" and isinstance(val, dict):
            # The tiered store's promotion-stall summary: one {p50_ms,
            # p99_ms, n} dict — the quantiles export as gauges, the
            # sample count as its own gauge (the latency_by_bucket
            # convention without the bucket label).
            out["serving_subject_store_promotion_p50_ms"] = metric(
                "gauge", val.get("p50_ms", 0.0),
                help="subject-store promotion stall p50 (install-path "
                     "wait for a warm/cold row to be device-ready)")
            out["serving_subject_store_promotion_p99_ms"] = metric(
                "gauge", val.get("p99_ms", 0.0),
                help="subject-store promotion stall p99")
            out["serving_subject_store_promotion_samples"] = metric(
                "gauge", val.get("n", 0),
                help="promotion stall sample count")
        elif isinstance(val, bool) or not isinstance(val, (int, float)):
            unexported += 1
        else:
            kind = ("gauge" if key in _SERVING_GAUGE_KEYS
                    or isinstance(val, float) else "counter")
            out[f"serving_{key}"] = metric(
                kind, val, help=f"ServingCounters.{key}")
    out["serving_unexported_keys"] = metric(
        "gauge", unexported,
        help="snapshot keys the metrics mapper could not classify "
             "(non-zero = counter drift; see obs/metrics.py)")
    return out


def load_samples(load: dict) -> dict:
    """``ServingEngine.load()`` -> metric structs: the backpressure
    snapshot as scrapeable gauges (admission state encoded
    ok=0/busy=1/shed=2 per tier). The blocks of the JAX engine's lanes
    and controller, which the port's engine has not yet, are not
    mapped."""
    out: Dict[str, dict] = {}
    for key in ("outstanding", "queued", "backlog_peak"):
        if load.get(key) is not None:
            out[f"load_{key}"] = metric(
                "gauge", load[key], help=f"load().{key}")
    if load.get("max_queued") is not None:
        out["load_max_queued"] = metric(
            "gauge", load["max_queued"], help="bounded-admission cap")
    states = {"ok": 0, "busy": 1, "shed": 2}
    admission = [
        sample(states.get(state, -1), {"tier": tier})
        for tier, state in (load.get("admission") or {}).items()
    ]
    if admission:
        out["load_admission_state"] = metric(
            "gauge", help="per-tier admission state (0=ok 1=busy 2=shed)",
            samples=admission)
    lat = load.get("latency_by_tier") or {}
    p50 = [sample(q.get("p50_ms", 0.0), {"tier": t})
           for t, q in lat.items()]
    p99 = [sample(q.get("p99_ms", 0.0), {"tier": t})
           for t, q in lat.items()]
    if p50:
        out["load_latency_p50_ms"] = metric(
            "gauge", help="per-tier served-request latency p50",
            samples=p50)
        out["load_latency_p99_ms"] = metric(
            "gauge", help="per-tier served-request latency p99",
            samples=p99)
    if load.get("backlog_age_s") is not None:
        out["load_backlog_age_s"] = metric(
            "gauge", load["backlog_age_s"],
            help="age of the oldest still-open request span")
    streams = load.get("streams") or {}
    for key, help_txt in (
            ("active", "open stream sessions"),
            ("frames_in_flight", "stream frames submitted, unresolved"),
            ("backlog_age_s", "age of the oldest in-flight stream "
                              "frame across sessions"),
            ("opened", "stream sessions ever opened"),
            ("frames_submitted", "stream frames ever submitted"),
            ("frames_resolved", "stream frames resolved (any kind)")):
        if streams.get(key) is not None:
            out[f"load_streams_{key}"] = metric(
                "gauge" if key in ("active", "frames_in_flight",
                                   "backlog_age_s") else "counter",
                streams[key], help=help_txt)
    closed = [sample(v, {"kind": k})
              for k, v in (streams.get("closed_by_kind") or {}).items()]
    if closed:
        out["load_streams_closed_by_kind"] = metric(
            "counter", help="stream-session terminals by kind",
            samples=closed)
    # Precision tiers: which tier serves which precision
    # family (0=f32, 1=bf16 per tier label) and the policy's stated
    # vertex-error envelope — the scrape-side record an operator (or
    # an alert) reads beside the sentinel's bf16 drift gauges.
    prec = load.get("precision") or {}
    tiers = [
        sample(1.0 if dtype == "bf16" else 0.0, {"tier": t})
        for t, dtype in sorted((prec.get("tiers") or {}).items())
    ]
    if tiers:
        out["load_precision_tier_bf16"] = metric(
            "gauge", help="per-tier precision family "
                          "(1=bf16 pose path, 0=f32)",
            samples=tiers)
    if prec.get("envelope_m") is not None:
        out["load_precision_envelope_m"] = metric(
            "gauge", prec["envelope_m"],
            help="stated bf16-tier max vertex error envelope (m)")
    # Tiered subject store: warm/cold occupancy — the hit/miss COUNTERS
    # ride the generic serving_samples mapper; these are the set-point
    # gauges only load() knows.
    store = load.get("subject_store") or {}
    for key, help_txt in (
            ("warm_rows", "host-RAM warm-tier rows resident"),
            ("warm_capacity", "warm-tier LRU bound"),
            ("promotions_pending", "async host->device promotions "
                                   "in flight"),
            ("cold_pages", "cold-tier row pages on disk")):
        if store.get(key) is not None:
            out[f"load_subject_store_{key}"] = metric(
                "gauge", store[key], help=help_txt)
    return out


def tracer_samples(acc: dict) -> dict:
    """``Tracer.accounting()`` -> metric structs (the closed-exactly-
    once criterion as scrapeable numbers)."""
    out = {
        "trace_spans_started": metric("counter",
                                      acc.get("spans_started", 0)),
        "trace_spans_closed": metric("counter",
                                     acc.get("spans_closed", 0)),
        "trace_spans_open": metric("gauge", acc.get("spans_open", 0)),
        "trace_events_dropped": metric("counter",
                                       acc.get("events_dropped", 0)),
        "trace_incidents": metric("counter", acc.get("incidents", 0)),
    }
    by_kind = [sample(v, {"kind": k})
               for k, v in (acc.get("closed_by_kind") or {}).items()]
    if by_kind:
        out["trace_closed_by_kind"] = metric(
            "counter", help="span terminal resolutions by kind",
            samples=by_kind)
    return out


# ---------------------------------------------------------------- SLO layer
#: Default per-tier objectives. Tier 0 is the interactive class (the
#: overload drill's 95% goodput floor restated as a 99% target with a
#: burn-rate denominator); tiers >= 1 are batch work whose shed budget
#: IS the overload design (they absorb sheds so tier 0 doesn't).
DEFAULT_SLO_OBJECTIVES = {
    "0": {"goodput_target": 0.99, "deadline_hit_target": 0.999,
          "shed_budget": 0.01},
    "default": {"goodput_target": 0.50, "deadline_hit_target": 0.99,
                "shed_budget": 0.75},
}


def _burn(actual_good: float, target_good: float) -> float:
    """Error-budget burn rate: observed badness / budgeted badness.
    1.0 = exactly on budget; > 1.0 = burning faster than the objective
    allows; a zero budget (target 1.0) burns infinitely on any miss."""
    budget = 1.0 - target_good
    bad = 1.0 - actual_good
    if budget <= 0.0:
        return 0.0 if bad <= 0.0 else float("inf")
    return bad / budget


def slo_report(counters_snapshot: dict,
               objectives: Optional[dict] = None,
               latency_by_tier: Optional[dict] = None) -> dict:
    """Per-tier SLO accounting from ONE counters snapshot (pass the
    same dict the serving export used — two snapshot() calls would tear
    the two views apart). Returns per tier: the observed rates, each
    objective, and its error-budget burn rate; ``ok`` iff every burn
    rate <= 1.0. Requests still in flight (offered but not yet
    resolved) are excluded from the deadline-hit denominator but kept
    in goodput's offered denominator — goodput is a statement about
    offered load, not about resolved outcomes only.

    ``latency_by_tier`` (the ``load()``/tracer quantile dict,
    ``{tier: {"p50_ms", "p99_ms", ...}}``) adds a LATENCY objective for
    any tier whose objectives carry ``p99_target_ms``: the burn rate is
    observed p99 over the target (> 1.0 = frames are landing slower
    than the stream SLO allows). Absent either side, the report has no
    latency keys — existing consumers see no new keys they did not opt
    into."""
    objectives = objectives or DEFAULT_SLO_OBJECTIVES
    tiers_out: Dict[str, dict] = {}
    for tier, ledger in (counters_snapshot.get("tiers") or {}).items():
        obj = objectives.get(tier, objectives.get(
            "default", DEFAULT_SLO_OBJECTIVES["default"]))
        submitted = int(ledger.get("submitted", 0))
        served = int(ledger.get("served", 0))
        shed = int(ledger.get("shed", 0))
        expired = int(ledger.get("expired", 0))
        # Caller-cancelled requests leave the offered load: the
        # caller withdrew the work, so neither goodput nor the shed
        # fraction should charge the engine for not serving it.
        cancelled = int(ledger.get("cancelled", 0))
        offered = max(0, submitted - cancelled)
        goodput = served / offered if offered else 1.0
        decided = served + expired
        deadline_hit = served / decided if decided else 1.0
        shed_fraction = shed / offered if offered else 0.0
        burns = {
            "goodput": _burn(goodput, obj["goodput_target"]),
            "deadline_hit": _burn(deadline_hit,
                                  obj["deadline_hit_target"]),
            "shed": (0.0 if obj["shed_budget"] <= 0 and shed_fraction <= 0
                     else (float("inf") if obj["shed_budget"] <= 0
                           else shed_fraction / obj["shed_budget"])),
        }
        p99_target = obj.get("p99_target_ms")
        lat = (latency_by_tier or {}).get(tier) or {}
        if p99_target and lat.get("p99_ms") is not None:
            # Latency burn: observed badness IS the quantile itself, so
            # the rate is the direct quotient (1.0 = exactly at target).
            burns["latency_p99"] = lat["p99_ms"] / p99_target
        tiers_out[tier] = {
            "submitted": submitted,
            "served": served,
            "shed": shed,
            "expired": expired,
            # Shape-stable for cancellation-free consumers: the key
            # appears only once a caller actually cancelled something.
            **({"cancelled": cancelled} if cancelled else {}),
            **({"latency_p99_ms": round(float(lat["p99_ms"]), 4)}
               if p99_target and lat.get("p99_ms") is not None else {}),
            "goodput": round(goodput, 6),
            "deadline_hit_rate": round(deadline_hit, 6),
            "shed_fraction": round(shed_fraction, 6),
            "objectives": dict(obj),
            "burn_rates": {k: (v if v == float("inf")
                               else round(v, 4))
                           for k, v in burns.items()},
            "ok": all(v <= 1.0 for v in burns.values()),
        }
    return {
        "schema": METRICS_SCHEMA,
        "tiers": tiers_out,
        "ok": all(t["ok"] for t in tiers_out.values()) if tiers_out
              else True,
    }


def slo_samples(report: dict) -> dict:
    """An ``slo_report`` -> metric structs (burn rates as the scrape-
    and-alert surface)."""
    goodput, burns, ok = [], [], []
    for tier, t in (report.get("tiers") or {}).items():
        goodput.append(sample(t["goodput"], {"tier": tier}))
        ok.append(sample(1.0 if t["ok"] else 0.0, {"tier": tier}))
        for objective, v in t["burn_rates"].items():
            burns.append(sample(v, {"tier": tier,
                                    "objective": objective}))
    out: Dict[str, dict] = {}
    if goodput:
        out["slo_goodput"] = metric(
            "gauge", help="served / offered per tier", samples=goodput)
        out["slo_burn_rate"] = metric(
            "gauge",
            help="error-budget burn rate per (tier, objective); "
                 "> 1 = over budget",
            samples=burns)
        out["slo_ok"] = metric(
            "gauge", help="1 iff every burn rate <= 1", samples=ok)
    return out


def register_engine_collectors(reg: MetricsRegistry, engine,
                               tracer=None, sentinel=None,
                               objectives: Optional[dict] = None,
                               ) -> MetricsRegistry:
    """Absorb one engine's telemetry sources into an EXISTING registry
    — ``ServingCounters`` (+ the SLO report derived from the SAME
    snapshot, one lock hold), ``load()``, the tracer accounting, and
    (when given) the numerics sentinel's probe/drift counters."""

    def _serving() -> dict:
        snap = engine.counters.snapshot()   # ONE lock-held copy
        out = serving_samples(snap)
        out.update(slo_samples(slo_report(snap, objectives)))
        return out

    reg.register_collector("serving", _serving)
    reg.register_collector("load", lambda: load_samples(engine.load()))
    tr = tracer if tracer is not None else engine.tracer
    if tr is not None:
        reg.register_collector(
            "tracer", lambda: tracer_samples(tr.accounting()))
    if sentinel is not None:
        reg.register_collector("sentinel", sentinel.samples)
    return reg


def engine_registry(engine, tracer=None, sentinel=None,
                    objectives: Optional[dict] = None,
                    namespace: str = "mano") -> MetricsRegistry:
    """THE engine wiring: one fresh registry absorbing every telemetry
    source the serving stack already maintains (see
    ``register_engine_collectors``)."""
    return register_engine_collectors(
        MetricsRegistry(namespace), engine, tracer=tracer,
        sentinel=sentinel, objectives=objectives)
