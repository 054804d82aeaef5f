"""Determinism lint: replay-critical modules must not consult nondeterminism.

The JAX package's ``repro.analysis.determinism`` pointed at the port, with
its PRNG rule aimed at torch.  The greedy and sampled streams must be
bit-identical across {contiguous, paged} x {fp, int8, int4} x {chunked,
spec, disagg, preempt-replay}: everything that decides *token values* is a
pure function of (prompt, seed, schedule-independent engine state).  This
pass walks the replay-critical modules and flags:

* ``det:wallclock`` — calls into ``time.*`` / ``random.*`` /
  ``os.urandom`` / ``np.random.*`` / ``datetime.*.now``.  Timestamps that
  only feed stats (TTFT/ITL metering, trace spans) are fine — but each one
  must say so with ``# analysis: allow(det:wallclock) — <reason>``, which
  turns "probably just a stat" into an audited claim;
* ``det:bare-set-iter`` — ``for``/comprehension iteration over a bare
  ``set`` (literal, ``set(...)`` call, or a local inferred to be one).
  Set iteration order is salted per-process; feeding it into scheduling or
  sampling silently breaks replay.  ``sorted(...)`` the set first;
* ``det:unkeyed-prng`` — a torch draw (``torch.rand``/``randn``/
  ``randint``/``randperm``/``multinomial``/``bernoulli``/``normal``/
  ``poisson``, the ``*_like`` forms, the in-place ``uniform_``/
  ``normal_``/``exponential_``/``random_``/``bernoulli_``/``geometric_``/
  ``cauchy_``/``log_normal_``) without an explicit ``generator=``: the
  default generator's state depends on every draw before it, so a
  preempted stream would not resample identically.  The sampler draws no
  such value: its bits are threefry of ``fold_in(PRNGKey(seed),
  token_index)`` (``core/sampling.py``), which this rule protects.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.common import AnalyzedFile, Finding, iter_python_files

PASS = "determinism"

DEFAULT_SUBSET = (
    "serving/core.py",
    "serving/paging.py",
    "serving/spec_decode.py",
    "core/sampling.py",
)

WALLCLOCK_RE = re.compile(
    r"^(time\.\w+|random\.\w+|os\.urandom|(np|numpy)\.random\.\w+"
    r"|datetime\.(datetime|date)\.(now|today|utcnow))$")

# torch draws: each takes the default generator unless it is handed one
DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli", "normal", "poisson",
    "rand_like", "randn_like", "randint_like",
})
# draws that are also Tensor methods (x.multinomial(...)), and the in-place
# draws
TENSOR_DRAWS = frozenset({"multinomial", "bernoulli"})
INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "exponential_", "random_", "bernoulli_", "geometric_",
    "cauchy_", "log_normal_",
})


def _call_name(node: ast.Call) -> str:
    try:
        return ast.unparse(node.func)
    except Exception:  # pragma: no cover
        return ""


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.Sub, ast.BitXor)):
        # set algebra propagates set-ness from either side
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _draw_name(node: ast.Call) -> Optional[str]:
    """The draw a call makes (``torch.rand``, ``x.normal_``, ``x.multinomial``),
    or None.  A seeded numpy generator's methods (``rng.normal``) are not
    torch draws."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in INPLACE_DRAWS or f.attr in TENSOR_DRAWS:
        return f.attr
    if f.attr in DRAWS and isinstance(f.value, ast.Name) and f.value.id == "torch":
        return f"torch.{f.attr}"
    return None


def _has_generator(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "generator":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
    return False


class _Checker:
    def __init__(self, af: AnalyzedFile, findings: List[Finding]):
        self.af = af
        self.findings = findings
        self.def_lines: List[int] = []
        self.func = "<module>"
        # names bound (anywhere in the enclosing function) to set exprs — a
        # flow-insensitive but effective local inference
        self.set_names: List[Set[str]] = [set()]

    def _emit(self, rule: str, lineno: int, msg: str) -> None:
        if self.af.waived(rule, lineno, self.def_lines):
            return
        self.findings.append(
            Finding(PASS, rule, self.af.rel, lineno, msg, scope=self.func))

    def check_module(self) -> None:
        for node in self.af.tree.body:
            self._visit(node)

    def _scan_assignments(self, fn: ast.AST) -> None:
        """Pre-scan a function body for set-typed locals so uses before the
        textual assignment (loops) still resolve."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_set_expr(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.set_names[-1].add(t.id)

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.def_lines.append(node.lineno)
            prev_func, self.func = self.func, node.name
            self.set_names.append(set(self.set_names[-1]))
            self._scan_assignments(node)
            for child in node.body:
                self._visit(child)
            self.set_names.pop()
            self.func = prev_func
            self.def_lines.pop()
            return

        if isinstance(node, ast.Call):
            name = _call_name(node)
            if WALLCLOCK_RE.match(name):
                self._emit(
                    "det:wallclock", node.lineno,
                    f"{self.func} calls {name}() — wall-clock/entropy in a "
                    f"replay-critical module; if this only feeds stats, say "
                    f"so with an allow() pragma")
            draw = _draw_name(node)
            if draw is not None and not _has_generator(node):
                self._emit(
                    "det:unkeyed-prng", node.lineno,
                    f"{self.func} draws {draw}() from the default generator — "
                    f"replay requires an explicit generator= (or the "
                    f"sampler's position-keyed threefry bits)")

        iters: List[ast.expr] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
        for it in iters:
            bare_set = _is_set_expr(it) or (
                isinstance(it, ast.Name) and it.id in self.set_names[-1])
            if bare_set:
                try:
                    src = ast.unparse(it)
                except Exception:  # pragma: no cover
                    src = "<set>"
                self._emit(
                    "det:bare-set-iter", it.lineno,
                    f"{self.func} iterates bare set {src!r} — per-process "
                    f"hash salt makes the order nondeterministic; sorted() "
                    f"it before it can feed scheduling or sampling")

        for child in ast.iter_child_nodes(node):
            self._visit(child)


def run(root: Path, subset: Optional[Sequence[str]] = None) -> List[Finding]:
    if subset is None:
        paths = iter_python_files(root, DEFAULT_SUBSET)
        if not paths:
            paths = iter_python_files(root)
    else:
        paths = iter_python_files(root, subset)
    findings: List[Finding] = []
    for p in paths:
        af = AnalyzedFile(p, root)
        findings.extend(af.pragma_findings)
        _Checker(af, findings).check_module()
    return findings
