"""Observability for the port's serving stack: request-lifecycle tracing,
an incident flight recorder, the leveled stderr logger, an exportable
metrics registry with SLO accounting, and the numerics sentinel — the
JAX package's ``obs.__all__``, ported (the port imports nothing of that
package).

* ``obs.trace.Tracer`` — bounded span/event ring; threaded through
  ``ServingEngine(tracer=...)``.
* ``obs.recorder`` — ``FlightRecorder`` (auto-capture on incidents),
  ``flight_record`` (one bounded artifact), ``write_trace_dir``
  (Chrome-trace export for ``obs/trace_report.py``).
* ``obs.log`` — ``get_logger``: info/debug to leveled stderr, warning
  through the ``warnings`` machinery, stdout never.
* ``obs.metrics`` — ``MetricsRegistry``, ``engine_registry`` (absorbs
  ``ServingCounters``/``load()``/tracer/SLO as collectors),
  ``prometheus_text`` + JSON export, ``slo_report`` burn rates.
* ``obs.sentinel`` — ``NumericsSentinel``: golden-input probes of every
  live program family against clean same-body references.
"""

from mano_hand_tpu_torch.obs.log import Logger, get_logger
from mano_hand_tpu_torch.obs.metrics import (
    MetricsRegistry,
    engine_registry,
    prometheus_text,
    slo_report,
)
from mano_hand_tpu_torch.obs.recorder import (
    FlightRecorder,
    flight_record,
    write_trace_dir,
)
from mano_hand_tpu_torch.obs.sentinel import NumericsSentinel
from mano_hand_tpu_torch.obs.trace import TERMINAL_KINDS, Tracer

__all__ = [
    "FlightRecorder",
    "Logger",
    "MetricsRegistry",
    "NumericsSentinel",
    "TERMINAL_KINDS",
    "Tracer",
    "engine_registry",
    "flight_record",
    "get_logger",
    "prometheus_text",
    "slo_report",
    "write_trace_dir",
]
