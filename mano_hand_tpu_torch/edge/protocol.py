"""The edge wire protocol: encodings, headers, and status mapping.

One module owns every byte-level convention the server and client share
(the METRICS_JSON filename-contract rule: a rename applied to one side
cannot silently break the other). A copy of the JAX package's
``edge/protocol.py``, byte for byte in what it encodes:

* **Arrays** travel as ``{"b64": ..., "shape": [...], "dtype": ...}`` —
  base64 of the raw little-endian C-contiguous bytes. LOSSLESS by
  construction: a float32 array decodes to the identical bits on the
  far side, which is what lets the edge drill judge wire results
  BIT-identical to in-process ``submit``/``submit_frame``. JSON-float
  round trips (repr/parse) are banned from every numeric payload.
* **Request metadata** rides headers: ``X-Mano-Priority`` is the
  admission tier, ``X-Mano-Deadline-S`` the end-to-end TTL — so a
  proxy/load-balancer can read (and rewrite) QoS without touching the
  body.
* **Terminal kinds -> HTTP status**: the engine's structured
  ``ServingError`` kinds map 1:1 onto status codes (below), so a
  client can branch on status alone and the JSON error body carries
  the full structured kind/phase/message for logging.
* **Backpressure**: a shed maps to 429 with a per-tier ``Retry-After``
  derived from the ``load()`` snapshot — tier 0 retries soonest (its
  quota headroom is reserved by construction), lower-priority tiers are
  told to wait longer, and a tier already hard-shedding gets an extra
  second on top of a merely "busy" one.
* **Streams** upgrade the connection (``Upgrade: mano-stream/1`` ->
  ``101``) and then speak newline-delimited JSON both ways: requests
  ``{"op": "open"|"frame"|"close", ...}``, responses
  ``{"event": ...}`` or ``{"error": {...}}`` — one line per frame,
  ordered, over one persistent socket (a session is connection-affine:
  the socket dying IS the client disappearing).
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

EDGE_SCHEMA = 1

#: Upgrade token for the stream protocol (open/frame/close over one
#: persistent connection).
STREAM_UPGRADE = "mano-stream/1"

#: Request-metadata headers (lower-case — header lookup is
#: case-insensitive and the parser normalizes).
PRIORITY_HEADER = "x-mano-priority"
DEADLINE_HEADER = "x-mano-deadline-s"

#: ServingError.kind -> HTTP status. "cancelled" is absent by design:
#: a cancelled request's client is GONE (cancellation is what the
#: server does on its disconnect), so there is nobody to answer.
KIND_STATUS = {
    "shed": 429,        # admission refused — back off and retry
    "expired": 504,     # the request's own deadline elapsed unserved
    "shutdown": 503,    # the engine is stopping/stopped
    "error": 500,       # dispatch failure — flight record attached
    "upstream": 502,    # a proxy lost a backend mid-response after the
    #   request hit its wire — re-sending is not safe (the worker may
    #   have admitted the work), so the client decides.
}

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable",
    504: "Gateway Timeout", 101: "Switching Protocols",
}


def reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


# ------------------------------------------------------------------ arrays
def encode_array(arr) -> dict:
    """Lossless wire form of one ndarray (little-endian raw bytes)."""
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":        # exotic caller: normalize
        a = a.astype(a.dtype.newbyteorder("<"))
    return {
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        "shape": list(a.shape),
        "dtype": a.dtype.name,
    }


def decode_array(obj: dict) -> np.ndarray:
    """Inverse of ``encode_array``; raises ValueError on a malformed
    payload (the server maps that to 400, never a 500)."""
    if not isinstance(obj, dict) or "b64" not in obj:
        raise ValueError("array payload must be {b64, shape, dtype}")
    try:
        raw = base64.b64decode(obj["b64"], validate=True)
        dtype = np.dtype(obj.get("dtype", "float32")).newbyteorder("<")
        shape = tuple(int(s) for s in obj.get("shape", []))
    except Exception as e:  # noqa: BLE001 — classify as caller error
        raise ValueError(f"malformed array payload: {e}") from e
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if dtype.itemsize * n != len(raw):
        raise ValueError(
            f"array payload size mismatch: {len(raw)} bytes for "
            f"shape {shape} dtype {dtype.name}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


# ------------------------------------------------------------ backpressure
def retry_after_s(tier: int, load: Optional[dict] = None) -> int:
    """Per-tier Retry-After (whole seconds, the header's delay form).

    Tier 0 is told to retry soonest — the quota ladder reserves its
    headroom, so a tier-0 shed clears as fast as one coalesce window
    drains. Lower tiers wait longer (they are the ones overload sheds
    FIRST and should be the last back in the door). A tier whose
    ``load()`` admission state is already "shed" gets one extra second
    over a merely "busy" one — the signal an adaptive client needs to
    back off harder while the burn is live.
    """
    base = 1 if tier <= 0 else min(1 + int(tier), 4)
    state = ((load or {}).get("admission") or {}).get(str(int(tier)))
    return base + (1 if state == "shed" else 0)


# ----------------------------------------------------------------- errors
def error_body(kind: str, message: str, *, phase: str = "edge",
               flight: Optional[dict] = None) -> dict:
    """The structured JSON error payload (mirrors ServingError's
    kind/phase vocabulary; ``flight`` attaches the flight-recorder
    capture on 5xx incidents)."""
    body = {"error": {"kind": kind, "phase": phase, "message": message}}
    if flight is not None:
        body["flight"] = flight
    return body


def dumps(obj) -> bytes:
    """Compact one-line JSON bytes (NDJSON-safe: no embedded newlines)."""
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")
