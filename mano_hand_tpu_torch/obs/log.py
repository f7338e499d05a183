"""Leveled stderr logger for the serving/runtime stack: a copy of the JAX
package's ``obs/log.py`` (the port imports nothing of that package).

Two channels, chosen by what the message IS — not by where it happens
to print:

* ``debug``/``info`` — progress and diagnostics. Written straight to
  **stderr**, gated by the logger level (``MANO_LOG`` env var, default
  ``warning`` so library callers stay silent unless they opt in).
  NEVER stdout: ``chip_smoke.py`` and the CLI own stdout as a
  JSON-line artifact channel, and a stray progress print there corrupts
  whatever parses it.
* ``warning`` — structured degradation (a damaged AOT artifact, a
  checkpoint that would serve another asset's subjects). Routed through
  Python's ``warnings`` machinery, NOT a bare stderr write: callers can
  catch, filter, or assert on degradation (``pytest.warns``), and the
  default warning printer already lands on stderr.
* ``error`` — always written to stderr, level-independent.

No handlers, no formatters, no config files: one process-wide level, a
per-logger name prefix, and nothing imported beyond the stdlib — the
logger must stay importable from the engine's hot path without
touching torch.
"""

from __future__ import annotations

import os
import sys
import threading
import warnings
from typing import Dict, Optional, TextIO

#: Level names -> numeric rank (stdlib-logging-compatible ordering).
LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

#: Environment switch: ``MANO_LOG=info`` (or debug/warning/error) raises
#: or lowers the process default for loggers that don't pin their own
#: level. Unknown values fall back to "warning" (quiet).
ENV_VAR = "MANO_LOG"

_DEFAULT_LEVEL = "warning"


def _resolve(level: Optional[str]) -> int:
    if level is None:
        level = os.environ.get(ENV_VAR, _DEFAULT_LEVEL)
    return LEVELS.get(str(level).lower(), LEVELS[_DEFAULT_LEVEL])


class Logger:
    """One named, leveled stderr logger (see the module docstring for
    the channel split). ``level=None`` follows the ``MANO_LOG`` env var
    at construction time; an explicit level pins it."""

    def __init__(self, name: str, level: Optional[str] = None,
                 stream: Optional[TextIO] = None):
        self.name = name
        self._rank = _resolve(level)
        self._stream = stream   # None = sys.stderr resolved per write
                                # (capsys/redirect-friendly)

    def enabled(self, level: str) -> bool:
        return LEVELS.get(level, LEVELS["error"]) >= self._rank

    def _write(self, level: str, msg: str) -> None:
        stream = self._stream if self._stream is not None else sys.stderr
        print(f"[{level}] {self.name}: {msg}", file=stream, flush=True)

    def debug(self, msg: str) -> None:
        if self.enabled("debug"):
            self._write("debug", msg)

    def info(self, msg: str) -> None:
        if self.enabled("info"):
            self._write("info", msg)

    def warning(self, msg: str, category=UserWarning,
                stacklevel: int = 2) -> None:
        """Degradation channel: a real ``warnings.warn`` so callers can
        catch/filter/assert (the engine's damaged-artifact contracts),
        prefixed with the logger name for grep-ability. The warnings
        printer writes stderr; stdout stays pure. The default
        ``stacklevel=2`` (passed through verbatim: level 1 is the
        ``warn()`` call in this method, level 2 its caller) attributes
        the warning to the actual degradation site, not this shim."""
        warnings.warn(f"{self.name}: {msg}", category,
                      stacklevel=stacklevel)

    def error(self, msg: str) -> None:
        self._write("error", msg)


_REGISTRY: Dict[str, Logger] = {}
_REGISTRY_LOCK = threading.Lock()


def get_logger(name: str, level: Optional[str] = None) -> Logger:
    """Process-cached logger per name. An explicit ``level`` re-pins an
    existing logger (the CLI forcing ``info`` on a library logger)."""
    with _REGISTRY_LOCK:
        lg = _REGISTRY.get(name)
        if lg is None:
            lg = _REGISTRY[name] = Logger(name, level=level)
        elif level is not None:
            lg._rank = _resolve(level)
        return lg
