"""The fault-tolerant device runtime.

* ``runtime.chaos``     — deterministic fault injection (hang, transient
                          or persistent error, latency spike, saturation,
                          silent wrong output), so every device failure
                          mode reproduces on the CPU in the tests;
* ``runtime.supervise`` — supervised calls (per-attempt deadlines on a
                          disposable thread, exponential backoff and
                          jitter, transient-vs-deterministic failure
                          classification), the ``Watchdog`` thread, and
                          the killable-subprocess path (``run_python``);
* ``runtime.health``    — the healthy/degraded/down circuit breaker with
                          a killable re-probe of the card and awareness
                          of the device lock (``utils/devicelock.py``).

``serving.ServingEngine`` composes all three through a
``DispatchPolicy``: supervised per-batch dispatch, breaker-gated CPU
graceful degradation, and failback to the card.
"""

from mano_hand_tpu_torch.runtime.chaos import (
    ChaosPlan,
    FaultEvent,
    InjectedFault,
    parse_plan,
)
from mano_hand_tpu_torch.runtime.health import (
    DEGRADED,
    DOWN,
    HEALTHY,
    CircuitBreaker,
    device_probe,
)
from mano_hand_tpu_torch.runtime.supervise import (
    DETERMINISTIC,
    TRANSIENT,
    DeadlineExceeded,
    DispatchPolicy,
    RetriesExhausted,
    Watchdog,
    backoff_delay,
    call_with_deadline,
    classify_failure,
    run_python,
    supervised_call,
)

__all__ = [
    "ChaosPlan",
    "FaultEvent",
    "InjectedFault",
    "parse_plan",
    "CircuitBreaker",
    "device_probe",
    "HEALTHY",
    "DEGRADED",
    "DOWN",
    "DispatchPolicy",
    "DeadlineExceeded",
    "RetriesExhausted",
    "Watchdog",
    "TRANSIENT",
    "DETERMINISTIC",
    "backoff_delay",
    "call_with_deadline",
    "classify_failure",
    "run_python",
    "supervised_call",
]
