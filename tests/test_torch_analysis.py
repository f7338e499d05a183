"""The port's static analysis (``mano_hand_tpu_torch/analysis/``,
``python -m mano_hand_tpu_torch analyze``).

Clean on the tree: the policy scope, the lock graphs under the port's
stated order, and the FX audit against the committed baseline. Every
rule fires on a seeded fault, as the JAX package's
``tests/test_analysis.py`` seeds them, names its rule and file:line, and
is silenced by its pragma.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from mano_hand_tpu_torch.analysis import (
    POLICY_RULES, check_lock_discipline, lint_source,
)
from mano_hand_tpu_torch.analysis import common, fx_audit
from mano_hand_tpu_torch.analysis.locks import ENGINE_LOCK_ORDER
from mano_hand_tpu_torch.analysis.run import run_analysis
from mano_hand_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parent.parent
JAX_BASELINE = ROOT / "mano_hand_tpu" / "analysis" / "baseline.json"


def _rules(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------- the tree
def test_analyze_is_clean_on_the_tree_and_the_baseline_is_current(
        tmp_path):
    """One full run (the FX audit traces every family once): nothing is
    found, and recommitting the baseline into a temp copy writes what is
    committed — the op counts are the tree's. Neither the committed
    baseline nor the JAX package's is touched."""
    copy = tmp_path / "baseline.json"
    shutil.copy(common.BASELINE, copy)
    before = (common.BASELINE.read_bytes(), JAX_BASELINE.read_bytes())
    lines = []
    rc = run_analysis(update_baseline=True, baseline_file=copy,
                      log=lines.append)
    assert rc == 0, "\n".join(lines)
    assert "RESULT: ANALYZE OK" in lines
    assert json.loads(copy.read_text()) == common.load_baseline()
    assert (common.BASELINE.read_bytes(),
            JAX_BASELINE.read_bytes()) == before
    assert set(common.load_baseline()["programs"]) == {
        "full", "posed", "gathered", "gathered_bf16", "fused_one",
        "fused_two", "gathered_fused", "gathered_fused_bf16",
        "cpu_fallback", "stream_fit"}


def test_cli_analyze_json_and_report(capsys):
    assert main(["analyze", "--skip-fx", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"ok", "findings", "sections", "baseline_updated"}
    assert out["ok"] is True and out["findings"] == []
    assert out["sections"] == {"policy": 0, "lock-discipline": 0}
    assert main(["analyze", "--skip-fx"]) == 0
    text = capsys.readouterr().out
    assert "[PASS] policy" in text and "[PASS] lock-discipline" in text
    assert "ANALYZE OK" in text


def test_policy_rules_and_scope():
    assert POLICY_RULES == ("unbounded-retry", "wallclock-deadline",
                            "device-under-lock",
                            "device-under-install-lock",
                            "device-under-completion-lock")
    paths = common.default_policy_paths()
    rel = {str(p.relative_to(ROOT)) for p in paths}
    assert "chip_smoke.py" in rel
    assert "mano_hand_tpu_torch/serving/engine.py" in rel
    assert "mano_hand_tpu_torch/parallel/sharding.py" in rel
    assert not any(r.startswith("mano_hand_tpu/") for r in rel)
    assert ENGINE_LOCK_ORDER == ("_resolve_lock", "_install_lock",
                                 "_BUILD_LOCK", "_device_lock", "_lock")


# ------------------------------------------------------- seeded: policy
_RETRY = '''import time
def wait(t):
    while True:
        t.cpu()
        time.sleep(1)
def bounded(t):
    while True:
        t.cpu()
        break
'''

_WALLCLOCK = '''import time
def wait(s):
    deadline = time.time() + s
    ttl: float = time.time() + s
    started = time.time()
    return deadline, ttl, started
'''

_UNDER_LOCKS = '''import threading
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._install_lock = threading.Lock()
        self._completion_lock = threading.Condition()
    def under_lock(self, t):
        with self._lock:
            return t.to("cuda")
    def under_install(self, t):
        with self._install_lock:
            t.numpy()
    def under_completion(self, graph):
        with self._completion_lock:
            graph.replay()
    def deferred(self, t):
        with self._lock:
            self.fn = lambda: t.item()
    def staged(self, t):
        out = t.cpu()
        with self._lock:
            self.out = out
'''


@pytest.mark.parametrize("source,rule,lines", [
    (_RETRY, "unbounded-retry", [3]),
    (_WALLCLOCK, "wallclock-deadline", [3, 4]),
    (_UNDER_LOCKS, "device-under-lock", [9]),
    (_UNDER_LOCKS, "device-under-install-lock", [12]),
    (_UNDER_LOCKS, "device-under-completion-lock", [15]),
])
def test_policy_rule_fires_and_its_pragma_silences(source, rule, lines):
    found = [f for f in lint_source(source, "seed.py") if f.rule == rule]
    assert sorted(f.line for f in found) == lines
    src = source.splitlines()
    for ln in lines:
        src[ln - 1] += f"  # analysis: allow({rule})"
    assert [f for f in lint_source("\n".join(src) + "\n", "seed.py")
            if f.rule == rule] == []


def test_seeded_faults_fail_analyze_naming_rule_and_line(tmp_path):
    """``analyze`` over a tree holding the seeded faults exits non-zero
    and prints each as file:line: [rule]."""
    pkg = tmp_path / "mano_hand_tpu_torch"
    (pkg / "serving").mkdir(parents=True)
    (pkg / "seed_retry.py").write_text(_RETRY)
    (pkg / "seed_locks.py").write_text(_UNDER_LOCKS)
    (pkg / "serving" / "engine.py").write_text(_INVERSION)
    lines = []
    assert run_analysis(root=tmp_path, skip_fx=True, log=lines.append) == 1
    text = "\n".join(lines)
    assert "mano_hand_tpu_torch/seed_retry.py:3: [unbounded-retry]" in text
    assert "mano_hand_tpu_torch/seed_locks.py:9: [device-under-lock]" in text
    assert "engine.py:10: [lock-discipline]" in text
    assert "[FAIL] policy" in text and "[FAIL] lock-discipline" in text


# -------------------------------------------------------- seeded: locks
_INVERSION = '''import threading
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._install_lock = threading.Lock()
        self._ctx = object()
        self._device_lock = self._ctx.lock
    def bad(self):
        with self._lock:
            with self._install_lock:
                pass
    def good(self):
        with self._install_lock, self._device_lock:
            with self._lock:
                pass
'''

_LEAF = '''import threading
class Stage:
    def __init__(self):
        self._completion_lock = threading.Condition()
        self._other = threading.Lock()
    def bad(self):
        with self._completion_lock:
            self._helper()
    def _helper(self):
        with self._other:
            pass
'''

_CYCLE = '''import threading
class Proxy:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
    def one(self):
        with self._a_lock:
            self._take_b()
    def _take_b(self):
        with self._b_lock:
            pass
    def two(self):
        with self._b_lock:
            with self._a_lock:
                pass
'''

_REACQUIRE = '''import threading
class Store:
    def __init__(self):
        self._lock = threading.Lock()
    def evict(self):
        with self._lock:
            self._page_out()
    def _page_out(self):
        with self._lock:
            pass
'''

_DEVICE_REENTRY = '''import threading
_BUILD_LOCK = threading.RLock()
class Program:
    def build(self, ctx):
        with _BUILD_LOCK, ctx.lock:
            with ctx.lock:
                pass
    def bad(self, ctx):
        with ctx.lock:
            with _BUILD_LOCK:
                pass
'''


@pytest.mark.parametrize("source,order,line,text", [
    (_INVERSION, ENGINE_LOCK_ORDER, 10, "inverting the stated order"),
    (_LEAF, (), 8, "leaf lock _completion_lock"),
    (_CYCLE, (), 8, "lock-nesting cycle"),
    (_REACQUIRE, (), 7, "re-acquisition"),
    (_DEVICE_REENTRY, ENGINE_LOCK_ORDER, 10, "_BUILD_LOCK while holding "
                                             "_device_lock"),
])
def test_lock_rule_fires_and_its_pragma_silences(tmp_path, source, order,
                                                 line, text):
    path = tmp_path / "seed.py"
    path.write_text(source)
    found = check_lock_discipline(path, order=order)
    assert any(f.line == line and text in f.message for f in found), [
        f.format() for f in found]
    src = source.splitlines()
    for ln in {f.line for f in found}:   # an inversion also closes a cycle
        src[ln - 1] += "  # analysis: allow(lock-discipline)"
    path.write_text("\n".join(src) + "\n")
    assert check_lock_discipline(path, order=order) == []


# ---------------------------------------------------------- seeded: FX
def _spec(fn, *args, bf16=False, name="seed"):
    return fx_audit.ProgramSpec(name, name, fn, args, bf16=bf16)


_X = torch.ones(4, 4)


@pytest.mark.parametrize("fn,bf16,rule,text", [
    (lambda x: (x.double() * 2).float(), False, "fx-f64-leak", "float64"),
    (lambda x: x * float(x.sum().item()), False, "fx-host-sync",
     "reads a device value"),
    (lambda x: (x.bfloat16() @ x.bfloat16()).float(), True,
     "fx-dtype-policy", "accumulate in bf16"),
    (lambda x: x @ x, True, "fx-dtype-policy", "no contraction takes"),
    (lambda x: (x.bfloat16().float() @ x).bfloat16(), True,
     "fx-dtype-policy", "outputs"),
])
def test_fx_rule_fires(fn, bf16, rule, text):
    findings, _ = fx_audit.audit_programs(None, specs=[_spec(fn, _X,
                                                             bf16=bf16)])
    hits = [f for f in findings if f.rule == rule]
    assert hits and text in hits[0].message, [f.format() for f in findings]


def test_fx_clean_bf16_family_and_op_drift():
    spec = _spec(lambda x: (x.bfloat16().float() @ x) + 1.0, _X, bf16=True)
    findings, measured = fx_audit.audit_programs(None, specs=[spec])
    assert _rules(findings) == ["fx-baseline"]
    ok, _ = fx_audit.audit_programs(measured, specs=[spec])
    assert ok == []
    ops = dict(measured["programs"]["seed"]["ops"])
    ops["aten.mm.default"] = 99
    bad, _ = fx_audit.audit_programs({"programs": {"seed": {"ops": ops}}},
                                     specs=[spec])
    assert _rules(bad) == ["fx-op-drift"]


def test_fx_trace_keeps_no_traced_value_in_the_caches():
    """A family traced first thing leaves the index cache holding plain
    tensors only (the fault repaired in port PR 12: FakeTensors memoised
    under ``torch.export``)."""
    from mano_hand_tpu_torch.ops import common as ops_common

    fx_audit.audit_programs(None, specs=fx_audit.build_program_specs()[:1])
    assert all(type(t) is torch.Tensor
               for t in ops_common._constants.values())
