"""The network edge: the port's ``ServingEngine`` behind a wire protocol.

* ``protocol`` — the shared byte-level conventions (lossless array
  encoding, QoS headers, kind -> status mapping, Retry-After policy,
  the stream-upgrade NDJSON vocabulary), a copy of the JAX package's;
* ``server.EdgeServer`` — the thin asyncio HTTP front-end
  (``python -m mano_hand_tpu_torch serve`` is its command line);
* ``client.EdgeClient`` / ``client.EdgeStreamClient`` — the bounded
  stdlib client the edge drill, the tests and ``status --server``
  share; ``client.ResilientStream`` — client-side reconnect-and-resume,
  so a SIGKILLed proxy loses no stream;
* ``proxy.EdgeProxy`` — the fleet front tier: health-aware routing over
  N workers with live stream migration;
* ``fleet.Fleet`` / ``fleet.WorkerProc`` — kill -9-capable worker
  process supervision (the fleet drill's substrate);
* ``fleet.FleetSupervisor`` / ``fleet.ProxyPair`` — the self-healing
  tier: auto-restart of dead workers inside a budget, and the
  active/standby proxy pair behind flock takeover
  (``python -m mano_hand_tpu_torch proxy``).
"""

from mano_hand_tpu_torch.edge.client import (  # noqa: F401
    EdgeClient,
    EdgeError,
    EdgeStreamClient,
    FrameReply,
    ResilientStream,
)
from mano_hand_tpu_torch.edge.fleet import (  # noqa: F401
    Fleet,
    FleetSupervisor,
    ProxyPair,
    ProxyProc,
    ProxySpec,
    WorkerProc,
    WorkerSpec,
)
from mano_hand_tpu_torch.edge.proxy import Backend, EdgeProxy  # noqa: F401
from mano_hand_tpu_torch.edge.server import EdgeServer  # noqa: F401

__all__ = [
    "Backend",
    "EdgeClient",
    "EdgeError",
    "EdgeProxy",
    "EdgeServer",
    "EdgeStreamClient",
    "Fleet",
    "FleetSupervisor",
    "FrameReply",
    "ProxyPair",
    "ProxyProc",
    "ProxySpec",
    "ResilientStream",
    "WorkerProc",
    "WorkerSpec",
]
