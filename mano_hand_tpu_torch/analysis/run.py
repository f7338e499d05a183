"""`mano analyze` driver for the port: run every checker, print the
verdict.

One ``[PASS]``/``[FAIL]`` line per check, findings as ``file:line:
[rule] message``, exit code 0 iff everything passes. Every failure line
carries its escape hatch — the ``# analysis: allow(<rule>)`` pragma for
audited policy/lock sites, ``--update-baseline`` for intentional op-count
changes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

from .common import (
    BASELINE,
    PACKAGE,
    REPO_ROOT,
    default_policy_paths,
    load_baseline,
    save_baseline,
)
from .locks import check_lock_discipline
from .policy import lint_paths

#: Files the lock checker reads with no stated order (each class's own
#: locks: cycles, re-acquires and leaf locks only), beside the engine and
#: its lanes, which it holds to the port's order. The same files as the
#: JAX package's ``analysis/run.py``.
_UNORDERED = ("serving/streams.py", "serving/subject_store.py",
              "serving/control.py", "serving/traffic.py",
              "runtime/chaos.py")


def lock_paths(root: Path = REPO_ROOT) -> tuple:
    """(files held to the engine's order, files checked without one)."""
    pkg = root / PACKAGE
    ordered = [pkg / "serving" / "engine.py", pkg / "serving" / "lanes.py"]
    unordered = ([pkg / p for p in _UNORDERED]
                 + sorted((pkg / "obs").glob("*.py"))
                 + sorted((pkg / "edge").glob("*.py")))
    return ([p for p in ordered if p.exists()],
            [p for p in unordered if p.exists()])


def run_analysis(
    root: Path = REPO_ROOT,
    update_baseline: bool = False,
    skip_fx: bool = False,
    as_json: bool = False,
    log=print,
    baseline_file: Path = BASELINE,
) -> int:
    """Run every checker; returns the process exit code (0 = clean).
    ``baseline_file`` is the op-count baseline read (and, with
    ``update_baseline``, rewritten): the port's committed one."""
    baseline = load_baseline(baseline_file)
    sections: List[tuple] = []   # (name, findings, info)

    paths = default_policy_paths(root)
    sections.append(("policy", lint_paths(paths, root=root),
                     f"{len(paths)} files linted"))

    ordered, unordered = lock_paths(root)
    locks = []
    for p in ordered:
        locks += check_lock_discipline(p)
    for p in unordered:
        locks += check_lock_discipline(p, order=())
    sections.append((
        "lock-discipline", locks,
        "serving/engine.py + serving/lanes.py (the stated order) + "
        f"{len(unordered)} files of serving/, runtime/, obs/, edge/"))

    measured = None
    if not skip_fx:
        from .fx_audit import audit_programs

        fx_findings, measured = audit_programs(baseline)
        sections.append((
            "fx-audit", fx_findings,
            f"{len(measured['programs'])} programs traced on the CPU"))

    if update_baseline:
        new = dict(baseline)
        if measured is not None:
            new["programs"] = measured["programs"]
        save_baseline(new, baseline_file)
        if not as_json:
            log(f"baseline updated: {baseline_file}")
        # Baseline-relative findings are void once recommitted; the
        # structural rules (f64, host syncs, dtype policy, policy, locks)
        # still judge this run.
        void = {"fx-baseline", "fx-op-drift"}
        sections = [(n, [f for f in fs if f.rule not in void], info)
                    for n, fs, info in sections]

    all_findings = [f for _, fs, _ in sections for f in fs]
    rc = 1 if all_findings else 0

    if as_json:
        log(json.dumps({
            "ok": rc == 0,
            "findings": [f.__dict__ for f in all_findings],
            "sections": {n: len(fs) for n, fs, _ in sections},
            "baseline_updated": bool(update_baseline),
        }))
        return rc

    for name, findings, info in sections:
        ok = not findings
        log(f"  [{'PASS' if ok else 'FAIL'}] {name}: {info}"
            + ("" if ok else f" — {len(findings)} finding(s)"))
        for f in findings:
            log(f"    {f.format()}")
    if rc:
        log("RESULT: ANALYZE FAILING — audited sites may add "
            "`# analysis: allow(<rule>)` on (or above) the flagged line; "
            "intentional op-count changes recommit via "
            "`python -m mano_hand_tpu_torch analyze --update-baseline`")
    else:
        log("RESULT: ANALYZE OK")
    return rc
