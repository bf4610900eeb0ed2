"""AST lock-graph extraction + blocking-call-under-lock detection (port of
``repro.analysis.concurrency``).

Walks every module under ``src/repro_torch``, finds the locks (created
through ``repro_torch.analysis.runtime.ordered_lock``/``ordered_rlock``/
``ordered_condition``, which carry their canonical name in the call), and
records which locks are acquired while which are held — both directly
(nested ``with``) and one call-graph closure deep (a ``with`` body calling
a method that itself takes a lock). Every extracted edge must go strictly
*forward* in :data:`repro_torch.analysis.runtime.LOCK_ORDER`; a backward or
same-rank edge is a potential deadlock and fails the pass. Order-respecting
edges also guarantee the graph is acyclic.

Rules:

* ``REPRO-C001`` — lock acquired out of documented order (cycle risk).
* ``REPRO-C002`` — blocking call (``.wait()``/``.result()``/``.join()``/
  ``.synchronize()``/``time.sleep``) while holding a lock. Exemption: a
  condition variable's own ``wait()`` inside ``with cond:`` (wait
  releases the lock).
* ``REPRO-C003`` — raw ``threading.Lock``/``RLock``/``Condition`` in
  ``src/repro_torch``: every lock must be created via ``ordered_lock`` (et al.)
  so it has a rank, shows up in this graph, and is runtime-checkable under
  ``REPRO_LOCK_CHECK=1``.

Call resolution is name-based and deliberately conservative: ``self.x()``
resolves within the enclosing class, bare names within the module, and
``obj.meth()`` to every class method of that name in the tree (minus the
enclosing class) — unions over candidates can only add edges, so a clean
report is trustworthy. ``# analysis: allow[RULE]`` suppresses per line.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import _ALLOW_RE, iter_python_files
from repro_torch.analysis.runtime import LOCK_ORDER, _RANK

_ORDERED_FACTORIES = {"ordered_lock": False, "ordered_rlock": True,
                      "ordered_condition": False}
_RAW_FACTORIES = {"Lock", "RLock", "Condition"}
_BLOCKING_ATTRS = {"wait", "result", "join", "synchronize"}
_BLOCKING_NAMES = {"sleep"}
# receiver-method names never resolved through the call graph (container /
# stdlib methods that shadow real method names would fan edges everywhere)
_CALL_STOPLIST = {
    "get", "pop", "popitem", "append", "extend", "items", "keys", "values",
    "setdefault", "move_to_end", "add", "discard", "remove", "insert",
    "index", "count", "sort", "copy", "clear", "update", "format", "split",
    "strip", "startswith", "endswith", "sum", "mean", "reshape", "astype",
    "set", "is_set", "acquire", "release", "notify", "notify_all",
}


def _dotted(func: ast.expr) -> str:
    parts: list[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclass
class LockGraph:
    """Extraction result: lock definition sites + acquisition edges."""

    locks: dict[str, list[str]] = field(default_factory=dict)
    reentrant: set[str] = field(default_factory=set)
    #: (held, acquired, where) — "where" is the acquisition site
    edges: set[tuple[str, str, str]] = field(default_factory=set)

    def order_violations(self) -> list[Finding]:
        out = []
        for src, dst, where in sorted(self.edges):
            if src == dst and src in self.reentrant:
                continue  # RLock re-entry
            if _RANK[src] >= _RANK[dst]:
                out.append(Finding(
                    "REPRO-C001", where,
                    f"acquires {dst!r} (rank {_RANK[dst]}) while holding "
                    f"{src!r} (rank {_RANK[src]}); documented order: "
                    f"{' < '.join(LOCK_ORDER)}"))
        return out


@dataclass
class _CallSite:
    name: str          # dotted call name as written
    held: tuple[str, ...]
    where: str


@dataclass
class _FuncInfo:
    qualname: str      # "module:Class.meth" or "module:func"
    module: str
    cls: str | None
    direct_locks: set[str] = field(default_factory=set)
    calls: list[_CallSite] = field(default_factory=list)


class _ModuleScan(ast.NodeVisitor):
    """One pass over a module in one of two modes: ``defs`` collects lock
    definitions (and raw-lock findings); ``uses`` records per-function
    acquisition info, direct nested-with edges, and blocking-call findings.
    Definitions are gathered across *all* modules before any uses pass runs
    so forward and cross-module lock references resolve."""

    def __init__(self, ext: "Extractor", module: str, rel: str,
                 source: str, mode: str = "uses"):
        self.ext = ext
        self.module = module
        self.rel = rel
        #: "defs" registers lock definitions only; "uses" records
        #: acquisitions/calls (definitions from every module are already
        #: known, so forward/cross-module references resolve)
        self.mode = mode
        self.allowed = {
            i: {m.group(1) for m in _ALLOW_RE.finditer(line)}
            for i, line in enumerate(source.splitlines(), start=1)
            if _ALLOW_RE.search(line)}
        self.cls: str | None = None
        self.func: _FuncInfo | None = None
        # held stack entries: (lock_name, ast.dump of the lock expression)
        self.held: list[tuple[str, str]] = []

    def _where(self, node: ast.AST) -> str:
        return f"{self.rel}:{getattr(node, 'lineno', 0)}"

    def _suppressed(self, node: ast.AST, rule: str) -> bool:
        return rule in self.allowed.get(getattr(node, "lineno", 0), ())

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if not self._suppressed(node, rule):
            self.ext.findings.append(Finding(rule, self._where(node), msg))

    # -- definitions -------------------------------------------------------

    def _lock_from_call(self, call: ast.Call) -> tuple[str, bool] | None:
        short = _dotted(call.func).rsplit(".", 1)[-1]
        if short in _ORDERED_FACTORIES:
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                return call.args[0].value, _ORDERED_FACTORIES[short]
        return None

    def _register(self, name: str, reentrant: bool, node: ast.AST) -> None:
        if name not in _RANK:
            self._emit("REPRO-C001", node,
                       f"lock name {name!r} not in runtime.LOCK_ORDER")
            return
        self.ext.graph.locks.setdefault(name, []).append(self._where(node))
        if reentrant:
            self.ext.graph.reentrant.add(name)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self.mode != "defs":
            self.generic_visit(node)
            return
        if isinstance(node.value, ast.Call):
            got = self._lock_from_call(node.value)
            raw = (_dotted(node.value.func).rsplit(".", 1)[-1]
                   in _RAW_FACTORIES
                   and _dotted(node.value.func) in (
                       "threading.Lock", "threading.RLock",
                       "threading.Condition", "Lock", "RLock", "Condition"))
            for tgt in node.targets:
                if got is not None:
                    name, reentrant = got
                    self._register(name, reentrant, node)
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and self.cls:
                        self.ext.attr_locks[(self.cls, tgt.attr)] = name
                        self.ext.attr_fallback.setdefault(
                            tgt.attr, set()).add(name)
                    elif isinstance(tgt, ast.Name):
                        self.ext.global_locks[
                            (self.module, tgt.id)] = name
                elif raw and not self.rel.endswith("analysis/runtime.py"):
                    self._emit(
                        "REPRO-C003", node,
                        "raw threading lock; create it via repro_torch."
                        "analysis.runtime.ordered_lock/ordered_rlock/"
                        "ordered_condition so it has a documented rank")
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict) -> None:
        if self.mode != "defs":
            self.generic_visit(node)
            return
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                    and isinstance(v, ast.Call):
                got = self._lock_from_call(v)
                if got is not None:
                    self._register(got[0], got[1], node)
                    self.ext.subscript_locks[k.value] = got[0]
        self.generic_visit(node)

    # -- scope tracking ----------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self.mode == "defs":
            self.generic_visit(node)
            return
        prev = self.func
        qual = (f"{self.module}:{self.cls}.{node.name}" if self.cls
                else f"{self.module}:{node.name}")
        self.func = _FuncInfo(qual, self.module, self.cls)
        self.ext.funcs[qual] = self.func
        if self.cls:
            self.ext.methods.setdefault(node.name, set()).add(qual)
        else:
            self.ext.module_funcs[(self.module, node.name)] = qual
        held_prev, self.held = self.held, []  # locks don't cross def scopes
        self.generic_visit(node)
        self.held = held_prev
        self.func = prev

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- acquisition tracking ----------------------------------------------

    def _resolve_lock_expr(self, expr: ast.expr) -> str | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            name = self.ext.attr_locks.get((self.cls or "", expr.attr))
            if name is None:
                cands = self.ext.attr_fallback.get(expr.attr, set())
                name = next(iter(cands)) if len(cands) == 1 else None
            return name
        if isinstance(expr, ast.Name):
            return self.ext.global_locks.get((self.module, expr.id))
        if isinstance(expr, ast.Subscript):
            sl = expr.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return self.ext.subscript_locks.get(sl.value)
        return None

    def visit_With(self, node: ast.With) -> None:
        if self.mode == "defs":
            self.generic_visit(node)
            return
        acquired: list[tuple[str, str]] = []
        for item in node.items:
            name = self._resolve_lock_expr(item.context_expr)
            if name is not None:
                for held_name, _ in self.held:
                    self.ext.graph.edges.add(
                        (held_name, name, self._where(node)))
                acquired.append((name, ast.dump(item.context_expr)))
                if self.func is not None:
                    self.func.direct_locks.add(name)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        if self.mode == "defs":
            self.generic_visit(node)
            return
        name = _dotted(node.func)
        short = name.rsplit(".", 1)[-1]
        if self.held:
            blocking = None
            if short in _BLOCKING_ATTRS and \
                    isinstance(node.func, ast.Attribute):
                recv = ast.dump(node.func.value)
                if not (short == "wait" and
                        any(recv == d for _, d in self.held)):
                    blocking = f".{short}()"
            elif short in _BLOCKING_NAMES:
                blocking = f"{short}()"
            if blocking is not None:
                self._emit(
                    "REPRO-C002", node,
                    f"blocking call {blocking} while holding "
                    f"{[h for h, _ in self.held]!r}")
        if self.func is not None and name and \
                short not in _CALL_STOPLIST and self.held:
            self.func.calls.append(_CallSite(
                name, tuple(h for h, _ in self.held), self._where(node)))
        elif self.func is not None and name and \
                short not in _CALL_STOPLIST:
            self.func.calls.append(_CallSite(name, (), self._where(node)))
        self.generic_visit(node)


class Extractor:
    def __init__(self) -> None:
        self.graph = LockGraph()
        self.findings: list[Finding] = []
        self.attr_locks: dict[tuple[str, str], str] = {}
        self.attr_fallback: dict[str, set[str]] = {}
        self.global_locks: dict[tuple[str, str], str] = {}
        self.subscript_locks: dict[str, str] = {}
        self.funcs: dict[str, _FuncInfo] = {}
        self.methods: dict[str, set[str]] = {}
        self.module_funcs: dict[tuple[str, str], str] = {}

    # -- call resolution ---------------------------------------------------

    def _callees(self, site: _CallSite, caller: _FuncInfo) -> set[str]:
        parts = site.name.split(".")
        short = parts[-1]
        if parts[0] == "self" and len(parts) == 2 and caller.cls:
            q = f"{caller.module}:{caller.cls}.{short}"
            return {q} if q in self.funcs else set()
        if len(parts) == 1:
            q = self.module_funcs.get((caller.module, short))
            return {q} if q else set()
        # obj.meth / self.obj.meth: every class method of that name,
        # excluding the caller's own class (the receiver is not self)
        cands = {q for q in self.methods.get(short, set())
                 if not (caller.cls and
                         q.startswith(f"{caller.module}:{caller.cls}."))}
        return cands

    def _transitive_locks(self) -> dict[str, set[str]]:
        locks = {q: set(f.direct_locks) for q, f in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for q, f in self.funcs.items():
                for site in f.calls:
                    for callee in self._callees(site, f):
                        extra = locks.get(callee, set()) - locks[q]
                        if extra:
                            locks[q] |= extra
                            changed = True
        return locks

    def close_over_calls(self) -> None:
        """Add edges held-lock -> every lock a called function (transitively)
        acquires."""
        locks = self._transitive_locks()
        for f in self.funcs.values():
            for site in f.calls:
                if not site.held:
                    continue
                acquired: set[str] = set()
                for callee in self._callees(site, f):
                    acquired |= locks.get(callee, set())
                for held in site.held:
                    for name in acquired:
                        self.graph.edges.add((held, name, site.where))


def extract(root: Path, subdirs: tuple[str, ...] = ("src/repro_torch",)
            ) -> tuple[list[Finding], LockGraph]:
    """Extract the lock graph and return (findings, graph)."""
    ext = Extractor()
    parsed: list[tuple[str, str, str, ast.Module]] = []
    for p in iter_python_files(root, subdirs):
        rel = p.relative_to(root).as_posix()
        module = rel[:-3].replace("/", ".")
        if module.startswith("src."):
            module = module[len("src."):]
        source = p.read_text()
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            ext.findings.append(Finding(
                "REPRO-C000", f"{rel}:{e.lineno or 0}",
                f"syntax error: {e.msg}"))
            continue
        parsed.append((module, rel, source, tree))
    for mode in ("defs", "uses"):
        for module, rel, source, tree in parsed:
            _ModuleScan(ext, module, rel, source, mode=mode).visit(tree)
    ext.close_over_calls()
    ext.findings.extend(ext.graph.order_violations())
    return ext.findings, ext.graph


def analyze_repo(root: Path) -> list[Finding]:
    return extract(root)[0]
