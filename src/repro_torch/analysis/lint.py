"""Repo-specific AST lint rules over the port (port of
``repro.analysis.lint``).

Rules (ids are stable and the JAX package's; catalog in README "Static
analysis"):

* ``REPRO-L001`` — internal use of a deprecated shim. The shims exist for
  external callers mid-migration; the port's code must use the
  replacement APIs. The defining module is exempt. The port's shims:
  ``kernels.sspnna.ops.sspnna_conv``/``sspnna_conv_from_plan`` and
  ``core.sparse_conv.sparse_conv_cirf``.
* ``REPRO-L002`` — host sync inside a serving hot path. ``_dispatch_stage``
  methods run on the wave pipeline's critical path and must only *enqueue*
  device work: host readbacks (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray``, ``host_array``) and
  ``torch.cuda.synchronize`` stall the pipeline.
* ``REPRO-L003`` — unnamed or non-daemon thread. Every
  ``threading.Thread`` must pass ``name=`` and ``daemon=True`` (watchdog
  traces, lock reports and ``health()`` snapshots attribute work by thread
  name; non-daemon threads wedge interpreter shutdown on crashed runs).
  ``ThreadPoolExecutor`` must pass ``thread_name_prefix=``.
* ``REPRO-L004`` — ``contextvars`` in ``serving/``. Ambient state consulted
  from planner/watchdog threads (the fault injector seam) must be a module
  global: a contextvar silently resets in pool threads.
* ``REPRO-L005`` — host readback inside a timed closure (an argument to
  ``measure``, ``time_ms``, ``device_ms`` or ``host_ms``). Readbacks time
  the transfer, not the kernel; ``torch.cuda.synchronize`` is the correct
  way to fence timed device work.

The pass lints ``src/repro_torch``, ``examples/*_torch.py`` and
``chip_smoke.py``. A line comment ``# analysis: allow[RULE-ID]``
suppresses that rule on that line (use sparingly; say why next to it).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding

# shim module -> names deprecated there (the module itself is exempt)
DEPRECATED_SHIMS: dict[str, frozenset[str]] = {
    "repro_torch.core.sparse_conv": frozenset({"sparse_conv_cirf"}),
    "repro_torch.kernels.sspnna.ops": frozenset(
        {"sspnna_conv", "sspnna_conv_from_plan"}),
}

#: what the pass lints: directories (recursively) and file globs
LINT_TARGETS = ("src/repro_torch", "examples/*_torch.py", "chip_smoke.py")

_HOT_FUNCS = ("_dispatch_stage",)
_TIMER_NAMES = ("measure", "time_ms", "device_ms", "host_ms")
_READBACK_ATTRS = ("item", "tolist", "cpu", "numpy")
_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([A-Z0-9-]+)\]")


def _allowed_lines(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _ALLOW_RE.finditer(line):
            out.setdefault(i, set()).add(m.group(1))
    return out


def _call_name(func: ast.expr) -> str:
    """Dotted name of a call target, best effort ('' when dynamic)."""
    parts: list[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _ModuleLint(ast.NodeVisitor):
    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.allowed = _allowed_lines(source)
        self.findings: list[Finding] = []
        self.in_serving = "/serving/" in rel.replace("\\", "/")
        self.module_name = self._module_name(rel)
        # alias -> fully qualified module (import ... ops as ops)
        self.mod_alias: dict[str, str] = {}
        # hot-path / timed-closure function stack
        self._hot_depth = 0
        self._timed_depth = 0
        self._local_funcs: dict[str, ast.AST] = {}

    @staticmethod
    def _module_name(rel: str) -> str:
        p = rel.replace("\\", "/")
        if p.endswith(".py"):
            p = p[:-3]
        if p.endswith("/__init__"):
            p = p[: -len("/__init__")]
        parts = p.split("/")
        if "src" in parts:
            parts = parts[parts.index("src") + 1:]
        return ".".join(parts)

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.allowed.get(line, ()):
            return
        self.findings.append(Finding(rule, f"{self.rel}:{line}", message))

    # -- shims (L001) ------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mod_alias[alias.asname or alias.name.split(".")[0]] = \
                alias.name
            if alias.name == "contextvars":
                self._l004(node)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if mod == "contextvars":
            self._l004(node)
        names = DEPRECATED_SHIMS.get(mod)
        if names and self.module_name != mod:
            for alias in node.names:
                if alias.name in names:
                    self._emit(
                        "REPRO-L001", node,
                        f"import of deprecated shim "
                        f"{mod}.{alias.name}; use the replacement API")
        for alias in node.names:
            # from repro_torch.kernels.sspnna import ops -> ops -> ...ops
            candidate = f"{mod}.{alias.name}" if mod else alias.name
            if candidate in DEPRECATED_SHIMS:
                self.mod_alias[alias.asname or alias.name] = candidate
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name):
            mod = self.mod_alias.get(node.value.id)
            # also catch dotted access: ops.sspnna_conv
            names = DEPRECATED_SHIMS.get(mod or "")
            if names and node.attr in names and self.module_name != mod:
                self._emit(
                    "REPRO-L001", node,
                    f"use of deprecated shim {mod}.{node.attr}; "
                    f"use the replacement API")
        self.generic_visit(node)

    def _l004(self, node: ast.AST) -> None:
        if self.in_serving:
            self._emit(
                "REPRO-L004", node,
                "contextvars in serving/: ambient seams consulted from "
                "planner threads must be module globals (see "
                "serving.faults._ACTIVE)")

    # -- threads (L003) ----------------------------------------------------

    def _check_thread_call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        short = name.rsplit(".", 1)[-1]
        if short == "Thread" and name in ("Thread", "threading.Thread"):
            kw = {k.arg: k.value for k in node.keywords}
            if "name" not in kw:
                self._emit("REPRO-L003", node,
                           "threading.Thread without name=; name every "
                           "thread so traces and health() attribute it")
            d = kw.get("daemon")
            if d is None or not (isinstance(d, ast.Constant)
                                 and d.value is True):
                self._emit("REPRO-L003", node,
                           "threading.Thread without daemon=True; "
                           "non-daemon threads wedge interpreter shutdown")
        if short == "ThreadPoolExecutor":
            if not any(k.arg == "thread_name_prefix" for k in node.keywords):
                self._emit("REPRO-L003", node,
                           "ThreadPoolExecutor without thread_name_prefix=")

    # -- host syncs (L002 / L005) ------------------------------------------

    def _check_host_sync(self, node: ast.Call, rule: str,
                         ban_synchronize: bool) -> None:
        name = _call_name(node.func)
        # attr-based so chained receivers (``f(x).item()``) still match
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        what = None
        if name.rsplit(".", 1)[-1] == "asarray" and \
                name.split(".")[0] in ("np", "numpy"):
            what = f"{name}() host readback"
        elif name.rsplit(".", 1)[-1] == "host_array":
            what = "host_array() host readback"
        elif attr in _READBACK_ATTRS:
            what = f".{attr}() host readback"
        elif attr == "synchronize" and ban_synchronize:
            what = "synchronize() device sync"
        if what is not None:
            where = ("dispatch stage" if rule == "REPRO-L002"
                     else "timed closure")
            self._emit(rule, node, f"{what} inside {where}")

    def visit_Call(self, node: ast.Call) -> None:
        self._check_thread_call(node)
        if self._hot_depth:
            self._check_host_sync(node, "REPRO-L002", ban_synchronize=True)
        elif self._timed_depth:
            self._check_host_sync(node, "REPRO-L005", ban_synchronize=False)
        # timed closures: measure(fn, ...) / time_ms(fn, ...) / ...
        name = _call_name(node.func).rsplit(".", 1)[-1]
        if name in _TIMER_NAMES and node.args:
            target = node.args[0]
            body = None
            if isinstance(target, ast.Lambda):
                body = target
            elif isinstance(target, ast.Name):
                body = self._local_funcs.get(target.id)
            if body is not None:
                self._timed_depth += 1
                for child in ast.iter_child_nodes(body):
                    self.visit(child)
                self._timed_depth -= 1
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._local_funcs[node.name] = node
        hot = node.name in _HOT_FUNCS
        if hot:
            self._hot_depth += 1
        self.generic_visit(node)
        if hot:
            self._hot_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]


def lint_source(source: str, rel: str, path: Path | None = None
                ) -> list[Finding]:
    """Lint one module's source; ``rel`` is the repo-relative path (used
    for scope decisions and finding locations)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("REPRO-L000", f"{rel}:{e.lineno or 0}",
                        f"syntax error: {e.msg}")]
    v = _ModuleLint(path or Path(rel), rel, source)
    v.visit(tree)
    return v.findings


def iter_python_files(root: Path, subdirs: tuple[str, ...]) -> list[Path]:
    """Every ``.py`` file under each of ``subdirs`` (a directory, searched
    recursively, or a glob of files relative to ``root``)."""
    out: list[Path] = []
    for sub in subdirs:
        base = root / sub
        if base.is_dir():
            found = sorted(base.rglob("*.py"))
        else:
            found = sorted(p for p in root.glob(sub) if p.suffix == ".py")
        out.extend(p for p in found if "__pycache__" not in p.parts)
    return out


def lint_repo(root: Path,
              subdirs: tuple[str, ...] = LINT_TARGETS) -> list[Finding]:
    """Run every lint rule over the port's own code (tests are exempt:
    they exercise shims and seeded violations deliberately)."""
    findings: list[Finding] = []
    for p in iter_python_files(root, subdirs):
        rel = p.relative_to(root).as_posix()
        findings.extend(lint_source(p.read_text(), rel, p))
    return findings
