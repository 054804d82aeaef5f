"""Lock-discipline lint: annotation-driven checking of shared mutable state.

The JAX package's ``repro.analysis.locklint``, kept as it is and pointed at
the port.  The serving runtime is concurrent — the asyncio event loop, the
``engine-step`` executor thread, the ``prefill-pool`` dispatch thread (which
launches kernels while the engine's thread does), the checkpoint writer —
and its safety argument lives in docstrings.  This pass
makes the argument machine-checked.  The grammar (all trailing comments):

* ``self.attr = ...  # guarded-by: self._lock`` — every access to ``attr``
  (outside ``__init__``) must sit inside ``with self._lock:``;
* ``self.attr = ...  # owned-by: <role>`` — every access must occur inside
  a function annotated ``def f(...):  # thread: <role>`` (roles are logical
  threads: ``event-loop``, ``engine-step``, ``prefill-pool``, ...);
* ``def f(...):  # thread: <role>`` — declares the function an entry point
  of ``<role>``; nested functions inherit unless they declare their own;
* ``# analysis: bind(var=ClassName)`` (module level) — attribute accesses
  through a variable named ``var`` are checked against ``ClassName``'s
  annotations (cross-object discipline, e.g. the decode pool writing the
  prefill pool's chunk-prefix mirror);
* ``# analysis: shared-global(NAME)`` (module level) — ``NAME`` is a
  process-wide singleton: rebinding it from function scope (or storing to
  ``<module>.NAME``) is flagged.

``__init__`` bodies are exempt (the object is not yet shared during
construction).  Waive individual accesses — or a whole function, with the
pragma on its ``def`` line — via ``# analysis: allow(lock:...) — reason``.

Known limitation, by design: the pass checks *attribute accesses*, not
call graphs.  A ``# thread:`` annotation asserts where the function runs;
callers are trusted to honor it (the assertion is the documentation the
next reader needs, and the accesses inside are then verified against it).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.common import AnalyzedFile, Finding, iter_python_files

PASS = "lock"

GUARD_RE = re.compile(r"#\s*guarded-by:\s*([^\s#]+)")
OWNER_RE = re.compile(r"#\s*owned-by:\s*([^\s#]+)")
THREAD_RE = re.compile(r"#\s*thread:\s*([^\s#]+)")
BIND_RE = re.compile(r"#\s*analysis:\s*bind\(([^)]*)\)")
SHARED_RE = re.compile(r"#\s*analysis:\s*shared-global\((\w+)\)")

# Files the lint is applied to on the real tree (annotation coverage is
# opt-in per attribute, so running wider is safe — this is the documented
# concurrency surface: the event loop, the ``engine-step`` executor, the
# ``prefill-pool`` thread, the checkpoint writer, and the launch counters
# two threads add to at once).
DEFAULT_SUBSET = (
    "serving/async_engine.py",
    "serving/disagg/prefill_pool.py",
    "serving/disagg/handoff.py",
    "serving/disagg/decode_pool.py",
    "obs/trace.py",
    "obs/metrics.py",
    "checkpoint/manager.py",
    "kernels/__init__.py",
)

# attr -> ("guard", lock_expr) | ("owner", role)
ClassAnnotations = Dict[str, Tuple[str, str]]


def _def_header_lines(af: AnalyzedFile, node: ast.AST) -> range:
    """Line range of a def's header (``def`` line through the line before
    the first body statement) — where a ``# thread:`` comment may sit."""
    body_start = node.body[0].lineno if getattr(node, "body", None) else node.lineno + 1
    return range(node.lineno, body_start)


def _thread_of(af: AnalyzedFile, node: ast.AST) -> Optional[str]:
    for ln in _def_header_lines(af, node):
        m = THREAD_RE.search(af.line(ln))
        if m:
            return m.group(1)
    return None


def collect_annotations(files: Sequence[AnalyzedFile]) -> Dict[str, ClassAnnotations]:
    """Phase 1: per-class attribute annotations, merged across files."""
    registry: Dict[str, ClassAnnotations] = {}
    for af in files:
        for cls in [n for n in ast.walk(af.tree) if isinstance(n, ast.ClassDef)]:
            anns: ClassAnnotations = registry.setdefault(cls.name, {})
            for node in ast.walk(cls):
                targets: List[ast.expr] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    targets = [node.target]
                else:
                    continue
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    line = af.line(node.lineno)
                    g = GUARD_RE.search(line)
                    o = OWNER_RE.search(line)
                    if g:
                        anns[t.attr] = ("guard", g.group(1))
                    elif o:
                        anns[t.attr] = ("owner", o.group(1))
    return registry


def _binds(af: AnalyzedFile) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in af.lines:
        m = BIND_RE.search(line)
        if not m:
            continue
        for part in m.group(1).split(","):
            if "=" in part:
                var, cls = part.split("=", 1)
                out[var.strip()] = cls.strip()
    return out


def _shared_globals(af: AnalyzedFile) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for i, line in enumerate(af.lines, start=1):
        m = SHARED_RE.search(line)
        if m:
            out[m.group(1)] = i
    return out


def _required_lock(guard: str, receiver_src: str) -> str:
    """Rewrite a guard expression declared against ``self`` for the actual
    receiver: guard ``self._lock`` accessed through ``pool`` must hold
    ``pool._lock``."""
    if guard.startswith("self.") and receiver_src != "self":
        return receiver_src + guard[len("self"):]
    return guard


class _Checker:
    def __init__(self, af: AnalyzedFile, registry: Dict[str, ClassAnnotations],
                 binds: Dict[str, str], findings: List[Finding]):
        self.af = af
        self.registry = registry
        self.binds = binds
        self.findings = findings
        self.locks: List[str] = []  # unparsed exprs of held `with` contexts
        self.thread: Optional[str] = None
        self.cls: Optional[str] = None
        self.def_lines: List[int] = []
        self.func: str = "<module>"

    # -------------------------------------------------------------- drive --

    def check_module(self) -> None:
        for node in self.af.tree.body:
            self._visit(node)

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.ClassDef):
            prev_cls, self.cls = self.cls, node.name
            for child in node.body:
                self._visit(child)
            self.cls = prev_cls
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "__init__" and self.cls is not None:
                return  # construction: the object is not shared yet
            prev_thread = self.thread
            declared = _thread_of(self.af, node)
            if declared is not None:
                self.thread = declared
            self.def_lines.append(node.lineno)
            prev_func, self.func = self.func, node.name
            for child in node.body:
                self._visit(child)
            self.func = prev_func
            self.def_lines.pop()
            self.thread = prev_thread
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            added = []
            for item in node.items:
                try:
                    added.append(ast.unparse(item.context_expr))
                except Exception:  # pragma: no cover - unparse is total on 3.9+
                    pass
            self.locks.extend(added)
            for child in node.body:
                self._visit(child)
            del self.locks[len(self.locks) - len(added):]
            return
        if isinstance(node, ast.Attribute):
            self._check_attribute(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    # -------------------------------------------------------------- check --

    def _receiver(self, node: ast.Attribute) -> Optional[Tuple[str, str]]:
        """(class name, receiver source) for a checkable attribute access."""
        v = node.value
        if isinstance(v, ast.Name):
            if v.id == "self" and self.cls is not None:
                return self.cls, "self"
            if v.id in self.binds:
                return self.binds[v.id], v.id
        if isinstance(v, ast.Attribute) and v.attr in self.binds:
            try:
                return self.binds[v.attr], ast.unparse(v)
            except Exception:  # pragma: no cover
                return None
        return None

    def _check_attribute(self, node: ast.Attribute) -> None:
        recv = self._receiver(node)
        if recv is None:
            return
        cls_name, recv_src = recv
        anns = self.registry.get(cls_name, {})
        ann = anns.get(node.attr)
        if ann is None:
            return
        kind, arg = ann
        if kind == "guard":
            required = _required_lock(arg, recv_src)
            if required in self.locks:
                return
            rule = "lock:unguarded"
            msg = (f"{cls_name}.{node.attr} is guarded-by {arg} but "
                   f"{self.func} accesses it without holding {required}")
        else:
            if self.thread == arg:
                return
            rule = "lock:thread"
            held = self.thread or "an unannotated context"
            msg = (f"{cls_name}.{node.attr} is owned-by {arg} but "
                   f"{self.func} (running on {held}) accesses it — annotate "
                   f"the entry point '# thread: {arg}' or fix the handoff")
        if self.af.waived(rule, node.lineno, self.def_lines):
            return
        scope = f"{self.cls}.{self.func}" if self.cls else self.func
        self.findings.append(
            Finding(PASS, rule, self.af.rel, node.lineno, msg, scope=scope))


def _check_shared_globals(files: Sequence[AnalyzedFile],
                          findings: List[Finding]) -> None:
    declared: Dict[str, str] = {}  # name -> declaring file
    for af in files:
        for name in _shared_globals(af):
            declared[name] = af.rel
    if not declared:
        return
    rule = "lock:global-rebind"
    for af in files:
        for node in ast.walk(af.tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                name = None
                if isinstance(t, ast.Attribute) and t.attr in declared:
                    name = t.attr  # e.g. trace.TRACER = ...
                if name is None:
                    continue
                if af.waived(rule, node.lineno):
                    continue
                findings.append(Finding(
                    PASS, rule, af.rel, node.lineno,
                    f"rebinding shared global {name} (declared in "
                    f"{declared[name]}) — instrumentation sites hold direct "
                    f"references; rebinding silently splits the singleton"))
    for af in files:
        shared_here = _shared_globals(af)
        if not shared_here:
            continue
        for fn in [n for n in ast.walk(af.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            global_names = {
                n for node in ast.walk(fn)
                if isinstance(node, ast.Global) for n in node.names}
            hot = global_names & set(shared_here)
            if not hot:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id in hot:
                            if not af.waived(rule, node.lineno):
                                findings.append(Finding(
                                    PASS, rule, af.rel, node.lineno,
                                    f"function-scope rebind of shared global "
                                    f"{t.id} via 'global'", scope=fn.name))


def run(root: Path, subset: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the lock-discipline pass over ``root`` (``src/repro_torch`` on the
    real tree).  ``subset=None`` uses :data:`DEFAULT_SUBSET` when those paths
    exist, else every ``.py`` file (fixture trees)."""
    if subset is None:
        paths = iter_python_files(root, DEFAULT_SUBSET)
        if not paths:
            paths = iter_python_files(root)
    else:
        paths = iter_python_files(root, subset)
    files = [AnalyzedFile(p, root) for p in paths]
    findings: List[Finding] = []
    for af in files:
        findings.extend(af.pragma_findings)
    registry = collect_annotations(files)
    for af in files:
        _Checker(af, registry, _binds(af), findings).check_module()
    _check_shared_globals(files, findings)
    return findings
