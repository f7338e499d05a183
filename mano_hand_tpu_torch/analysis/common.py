"""Shared infrastructure for the port's static-analysis checkers.

Findings, the ``# analysis: allow(<rule>)`` pragma, the default scan
scope, and the committed baseline file. The port's copy of the JAX
package's ``analysis/common.py``, pointed at ``mano_hand_tpu_torch/``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Set

#: Repo root (the package lives at <root>/mano_hand_tpu_torch/analysis).
REPO_ROOT = Path(__file__).resolve().parents[2]

#: The port's package directory.
PACKAGE = "mano_hand_tpu_torch"

#: The committed FX op-histogram baseline. Regenerate with
#: ``python -m mano_hand_tpu_torch analyze --update-baseline`` when an op
#: count change is intentional.
BASELINE = Path(__file__).resolve().parent / "baseline.json"

#: The port's own scripts beside the package (the rest of ``scripts/``
#: belongs to the JAX package).
PORT_SCRIPTS = ("time_fused_forward.py", "time_store_promotion.py")


@dataclass(frozen=True)
class Finding:
    """One rule violation: rule id, location, human message."""

    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


# The escape hatch for audited sites: a pragma on the flagged line, or
# on the line directly above it (comment-above-statement style), lifts
# the named rule(s) there. Multiple rules: allow(rule-a, rule-b).
_PRAGMA_RE = re.compile(r"#\s*analysis:\s*allow\(([\w\-, ]+)\)")


def pragma_map(source: str) -> Dict[int, Set[str]]:
    """Line number (1-based) -> rules allowed AT that line.

    A pragma on line N covers findings on lines N and N+1, so both the
    trailing-comment and the comment-above idioms work.
    """
    allowed: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        for ln in (i, i + 1):
            allowed.setdefault(ln, set()).update(rules)
    return allowed


def apply_pragmas(findings: Sequence[Finding],
                  source: str) -> List[Finding]:
    """Drop findings silenced by an ``analysis: allow`` pragma."""
    allowed = pragma_map(source)
    return [f for f in findings
            if f.rule not in allowed.get(f.line, ())]


def default_policy_paths(root: Path = REPO_ROOT) -> List[Path]:
    """The policy linter's scan scope: the port's package,
    ``chip_smoke.py`` and the port's scripts — the code that reaches the
    card. Tests are out of scope."""
    paths = sorted((root / PACKAGE).rglob("*.py"))
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        paths.append(smoke)
    paths.extend(p for p in (root / "scripts" / n for n in PORT_SCRIPTS)
                 if p.exists())
    return [p for p in paths if "__pycache__" not in p.parts]


def load_baseline(path: Path = BASELINE) -> dict:
    if not Path(path).exists():
        return {}
    with open(path) as f:
        return json.load(f)


def save_baseline(data: dict, path: Path = BASELINE) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def baseline_path() -> Path:
    return BASELINE
