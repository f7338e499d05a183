"""Lock-discipline checker for the port's serving engine and its
neighbours.

The port's lock order, outer first (``serving/engine.py``,
``serving/lanes.py``):

    LaneSet._resolve_lock -> _install_lock -> _BUILD_LOCK
        -> the dispatch context's device lock -> _lock

* ``_resolve_lock`` (``serving/lanes.py``) lets one lane at a time
  resolve a batch against the engine's table, and an install it starts
  takes the engine's install lock inside it.
* ``_install_lock`` (``serving/engine.py``) serializes table installs:
  the bake-and-swap writes the new row under it, then swaps the table
  under ``_lock`` (JAX's ``_install_lock -> _exe_lock``, where the port's
  ``_lock`` is JAX's ``_exe_lock``).
* ``_BUILD_LOCK`` (module level in ``serving/engine.py``): one program
  build at a time in the process, taken before the context's lock.
* The dispatch context's device lock (``_DispatchContext.lock``: an
  ``RLock`` on a card; the engine's is ``_device_lock``, a lane's
  ``ctx.lock``): every device operation of a context holds it.
* ``_lock`` (the engine's, and ``LaneSet._lock``): the subject maps,
  the table reference, the program cache, lane placement. No device
  work inside, and nothing taken inside it.
* ``_completion_lock``, the completion stage's Condition, is a LEAF:
  nothing is ever taken while it is held.

The checker is lexical, which is what makes it a review-time gate:

* lock attributes are discovered from ``self.<name> = threading.Lock()``
  (or ``RLock``, ``Condition``) assignments, and ``self.<name> =
  <...>.lock`` (a context's device lock) — all named ``_device_lock``
  where they are a dispatch context's lock; a ``with <...>.lock:`` on
  anything but ``self`` is the device lock too; module-level locks
  (``_BUILD_LOCK = threading.RLock()``) are taken by name;
* within each method, a ``with`` nested inside another adds an ordering
  edge ``outer -> inner``;
* a call ``self.m(...)`` made while a lock is lexically held adds edges
  from every held lock to every lock ``m`` may acquire — transitively
  through the intra-class call graph (a conservative over-approximation,
  the right bias for a deadlock gate);
* violations: any cycle in the edge graph (including a self-edge — a
  re-acquire of a non-reentrant ``threading.Lock`` deadlocks at once),
  any edge AGAINST the stated order, and any edge out of a leaf lock.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding, apply_pragmas

#: The port's stated order for the serving engine and its lanes (outer
#: first).
ENGINE_LOCK_ORDER = ("_resolve_lock", "_install_lock", "_BUILD_LOCK",
                     "_device_lock", "_lock")

#: Locks under which nothing else may be taken.
LEAF_LOCKS = ("_completion_lock",)

#: The name every dispatch context's device lock goes by.
DEVICE_LOCK = "_device_lock"

ENGINE_PATH = Path(__file__).resolve().parents[1] / "serving" / "engine.py"

_LOCK_CALLS = ("Lock", "RLock", "Condition")


def _attr_of_self(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lock_call(v: ast.AST) -> bool:
    return (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
            and v.func.attr in _LOCK_CALLS)


def _lock_attrs(cls: ast.ClassDef) -> Dict[str, str]:
    """Attribute -> lock name for the locks of a class: those assigned a
    ``threading.Lock()``/``RLock()``/``Condition()``, and those assigned
    another object's ``.lock`` (a dispatch context's device lock)."""
    locks: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        for t in node.targets:
            attr = _attr_of_self(t)
            if attr is None:
                continue
            if _is_lock_call(v):
                locks[attr] = attr
            elif isinstance(v, ast.Attribute) and v.attr == "lock":
                locks[attr] = DEVICE_LOCK
    return locks


def _module_locks(tree: ast.Module) -> Set[str]:
    return {t.id for node in tree.body if isinstance(node, ast.Assign)
            and _is_lock_call(node.value)
            for t in node.targets if isinstance(t, ast.Name)}


class _MethodScan(ast.NodeVisitor):
    """Per-method facts: direct nesting edges, lock acquisitions, and
    self-method calls annotated with the locks lexically held."""

    def __init__(self, locks: Dict[str, str], module_locks: Set[str],
                 methods: Set[str]):
        self.locks = locks
        self.module_locks = module_locks
        self.methods = methods
        self.held: List[str] = []
        self.acquires: Set[str] = set()      # locks acquired in this body
        self.edges: List[Tuple[str, str, int]] = []   # (outer, inner, line)
        self.calls: List[Tuple[Tuple[str, ...], str, int]] = []

    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        attr = _attr_of_self(expr)
        if attr is not None:
            return self.locks.get(attr)
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        if isinstance(expr, ast.Attribute) and expr.attr == "lock":
            return DEVICE_LOCK
        return None

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is None:
                continue
            self.acquires.add(name)
            # A re-acquire (name already held) lands here as the
            # self-edge (name, name): a guaranteed self-deadlock for a
            # non-reentrant Lock, reported as a cycle of one.
            for outer in self.held:
                self.edges.append((outer, name, node.lineno))
            self.held.append(name)
            entered.append(name)
        self.generic_visit(node)
        for _ in entered:
            self.held.pop()

    def visit_Call(self, node: ast.Call) -> None:
        attr = _attr_of_self(node.func)
        if attr in self.methods:
            # Recorded even when no lock is held: lock-free calls still
            # propagate acquisition sets through the call-graph fixpoint.
            self.calls.append((tuple(self.held), attr, node.lineno))
        self.generic_visit(node)

    # Nested defs/lambdas run later, outside the lexical lock context.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _transitive_acquires(scans: Dict[str, "_MethodScan"]
                         ) -> Dict[str, Set[str]]:
    """Locks each method may acquire, directly or via self-calls
    anywhere in its body (fixpoint over the intra-class call graph)."""
    callees = {name: {c for _, c, _ in scan.calls if c in scans}
               for name, scan in scans.items()}
    acq = {name: set(scan.acquires) for name, scan in scans.items()}
    changed = True
    while changed:
        changed = False
        for name in scans:
            for c in callees[name]:
                add = acq.get(c, set()) - acq[name]
                if add:
                    acq[name] |= add
                    changed = True
    return acq


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    path: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GREY
        path.append(n)
        for m in sorted(graph[n]):
            if color[m] == GREY:
                return path[path.index(m):] + [m]
            if color[m] == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(graph):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def check_lock_discipline(
    path: Path = ENGINE_PATH,
    order: Sequence[str] = ENGINE_LOCK_ORDER,
    class_name: Optional[str] = None,
    leaves: Sequence[str] = LEAF_LOCKS,
) -> List[Finding]:
    """Check one file's classes for lock-order violations and cycles."""
    path = Path(path)
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    findings: List[Finding] = []
    rel = path.name if path.is_absolute() else str(path)
    module_locks = _module_locks(tree)

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        if class_name is not None and cls.name != class_name:
            continue
        locks = _lock_attrs(cls)
        methods = {n.name for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        scans: Dict[str, _MethodScan] = {}
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan = _MethodScan(locks, module_locks, methods)
                for stmt in node.body:
                    scan.visit(stmt)
                scans[node.name] = scan
        if not any(scan.acquires for scan in scans.values()):
            continue

        acq = _transitive_acquires(scans)
        # Edge set: direct lexical nesting + (held locks x callee's
        # transitive acquisitions) for every under-lock self-call.
        edges: Dict[Tuple[str, str], Tuple[int, str]] = {}
        for mname, scan in scans.items():
            for a, b, line in scan.edges:
                edges.setdefault((a, b), (line, f"{cls.name}.{mname}"))
            for held, callee, line in scan.calls:
                for inner in acq.get(callee, set()):
                    for outer in held:
                        edges.setdefault(
                            (outer, inner),
                            (line, f"{cls.name}.{mname} -> "
                                   f"self.{callee}()"))

        rank = {name: i for i, name in enumerate(order)}
        for (a, b), (line, where) in sorted(edges.items(),
                                            key=lambda kv: kv[1][0]):
            if a == b:
                if a == DEVICE_LOCK or a in module_locks:
                    continue   # the device and build locks are RLocks
                findings.append(Finding(
                    "lock-discipline", rel, line,
                    f"{where}: re-acquisition of non-reentrant "
                    f"self.{a} while already held — guaranteed "
                    "deadlock"))
            elif a in leaves:
                findings.append(Finding(
                    "lock-discipline", rel, line,
                    f"{where}: takes {b} while holding the leaf lock {a} "
                    "— nothing may be acquired under a leaf"))
            elif a in rank and b in rank and rank[a] > rank[b]:
                findings.append(Finding(
                    "lock-discipline", rel, line,
                    f"{where}: acquires {b} while holding {a}, inverting "
                    f"the stated order {' -> '.join(order)} "
                    "(analysis/locks.py) — deadlocks against a compliant "
                    "holder"))
        cyc = _find_cycle({e for e in edges if e[0] != e[1]})
        if cyc:
            line = min(edges[(a, b)][0]
                       for a, b in zip(cyc, cyc[1:]) if (a, b) in edges)
            findings.append(Finding(
                "lock-discipline", rel, line,
                f"{cls.name}: lock-nesting cycle "
                f"{' -> '.join(cyc)} — two threads taking opposite "
                "arcs deadlock"))
    return apply_pragmas(findings, source)
