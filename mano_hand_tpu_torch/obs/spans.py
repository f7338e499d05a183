"""Library spans: named profiler ranges around what the port does inside
one call of a forward route.

The library's half of ``obs/`` (``obs/trace.py`` is the serving engine's
request ring). Each forward route opens an entry span around the call:
``forward_chunked`` (``ENTRY_CHUNKED``), ``forward_hands_pallas_fused_full``
(``ENTRY_HANDS``) and ``forward_posed_gather_fused``
(``ENTRY_POSED_GATHER``). Inside it, each device operation the library
enqueues sits in a device-op span: a kernel launch (``mano.launch.<k>``,
around the wrapper's call into the built library) and the library's own
operations (``PAD`` and ``CONCAT`` in ``forward_chunked``, ``COPY``: an
operand converted or made contiguous, ``PACK``: an operand cache's
rebuild). A span opened inside another nests in it; an entry span inside
no other is a root: one call.

**When.** Only while a ``torch.profiler`` capture is active
(``torch.autograd._profiler_enabled()``). Otherwise ``span`` makes that
check and returns a shared no-op context: no range, no allocation of its
own, no lock. When on, a span is a profiler range of its name
(``record_function``'s C++ form, ``_RecordFunctionFast``, at about a
fifteenth of its host cost) and nothing else: the library keeps no
record of its own and touches no stream.

**What a capture then holds.** Each span's host interval, on the
profiler's clock, among its host events; the CUDA runtime calls made
inside it; and the device operations those calls enqueued, which one
stream runs in the order they were enqueued. So a reader of the capture
pairs each device operation with the innermost span that enqueued it:
its device time, and the operations a call enqueued, come from the
capture itself (``benchmark/library_spans.py``, ``obs/trace_report.py``).
"""

from __future__ import annotations

import torch

#: Entry spans, one per forward route (``models/core.py``).
ENTRY_CHUNKED = "mano.forward_chunked"
ENTRY_HANDS = "mano.forward_hands"
ENTRY_POSED_GATHER = "mano.forward_posed_gather"

#: Kernel launches: ``LAUNCH + <kernel>``.
LAUNCH = "mano.launch."
LAUNCH_K1 = LAUNCH + "k1"
LAUNCH_K2 = LAUNCH + "k2"
LAUNCH_K2_BF16 = LAUNCH + "k2_bf16"
LAUNCH_K3 = LAUNCH + "k3"
LAUNCH_K4 = LAUNCH + "k4"
LAUNCH_K5 = LAUNCH + "k5"

#: The library's own device operations: ``forward_chunked``'s zero
#: padding of a partial chunk and its concatenation of the chunks, an
#: operand converted or made contiguous, an operand cache's rebuild.
PAD = "mano.pad"
CONCAT = "mano.concat"
COPY = "mano.copy"
PACK = "mano.pack"
LIBRARY_OPS = frozenset({PAD, CONCAT, COPY, PACK})

_profiling = torch.autograd._profiler_enabled
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class _Off:
    """The context ``span`` returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager around one piece of the library's work, named
    ``name`` (one of this module's constants): a profiler range while a
    ``torch.profiler`` capture runs, else a shared no-op."""
    if not _profiling():
        return _OFF
    return _range(name)
