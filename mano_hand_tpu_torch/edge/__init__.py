"""The network edge: the port's ``ServingEngine`` behind a wire protocol.

* ``protocol`` — the shared byte-level conventions (lossless array
  encoding, QoS headers, kind -> status mapping, Retry-After policy,
  the stream-upgrade NDJSON vocabulary), a copy of the JAX package's;
* ``server.EdgeServer`` — the thin asyncio HTTP front-end
  (``python -m mano_hand_tpu_torch serve`` is its command line);
* ``client.EdgeClient`` / ``client.EdgeStreamClient`` — the bounded
  stdlib client the edge drill, the tests and ``status --server``
  share; ``client.ResilientStream`` — client-side reconnect-and-resume.
"""

from mano_hand_tpu_torch.edge.client import (  # noqa: F401
    EdgeClient,
    EdgeError,
    EdgeStreamClient,
    FrameReply,
    ResilientStream,
)
from mano_hand_tpu_torch.edge.server import EdgeServer  # noqa: F401

__all__ = [
    "EdgeClient",
    "EdgeError",
    "EdgeServer",
    "EdgeStreamClient",
    "FrameReply",
    "ResilientStream",
]
