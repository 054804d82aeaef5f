"""Shared machinery of the port's analysis passes (the JAX package's
``repro.analysis.common``, without its migration path for baselines
written before fingerprints held the scope).

Every pass produces :class:`Finding` records.  Three escape hatches exist,
in decreasing order of preference:

* **fix it** — the default;
* **pragma** — a trailing ``# analysis: allow(<rule>[,<rule>]) — <reason>``
  comment waives the named rules on that line (or, when the pragma is the
  whole line, on the next line; on a ``def`` line, for the entire function
  body).  The reason is mandatory: a pragma without one is itself a
  finding (``analysis:pragma-no-reason``);
* **baseline** — a checked-in file of fingerprints that grandfathers
  pre-existing findings.  Each line must carry a justification; baselines
  are for debt, pragmas are for audited intent.

Fingerprints hash (pass, rule, relative path, enclosing-def scope,
message) — not the line number — so unrelated edits above a finding do not
churn the baseline, while two identical-message findings in different
functions of one file stay distinct.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(
    r"#\s*analysis:\s*allow\(\s*([^)]*?)\s*\)\s*(?:[—–]|--|-)?\s*(.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str  # "lock" | "determinism" | "kernel" | "program" | "analysis"
    rule: str  # e.g. "lock:unguarded", "det:wallclock"
    path: str  # path as reported (relative to the analysis root)
    line: int  # 1-indexed
    message: str
    scope: str = ""  # enclosing def qualname (or program/case label)

    @property
    def fingerprint(self) -> str:
        raw = (f"{self.pass_name}|{self.rule}|{self.path}|{self.scope}|"
               f"{self.message}")
        return hashlib.sha1(raw.encode()).hexdigest()[:12]

    def render(self) -> str:
        where = f" ({self.scope})" if self.scope else ""
        return (f"{self.path}:{self.line}:{where} [{self.rule}] "
                f"{self.message}  [{self.fingerprint}]")


def parse_pragmas(
    text: str, rel: str,
) -> Tuple[Dict[int, Set[str]], Dict[int, Set[str]], List[Finding]]:
    """Extract ``# analysis: allow(...)`` pragmas from source text.

    Returns ``(line_waivers, def_waivers, findings)`` where
    ``line_waivers[lineno]`` is the set of waived rules effective on that
    line, ``def_waivers`` maps a ``def`` line's number to rules waived for
    the whole function body, and ``findings`` reports pragmas missing
    their mandatory reason.
    """
    line_waivers: Dict[int, Set[str]] = {}
    def_waivers: Dict[int, Set[str]] = {}
    findings: List[Finding] = []
    lines = text.splitlines()
    for i, line in enumerate(lines, start=1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2).strip()
        if not reason:
            findings.append(Finding(
                "analysis", "analysis:pragma-no-reason", rel, i,
                "allow() pragma without a reason — every waiver must say why"))
            continue
        code = line[: m.start()].rstrip()
        if not code:
            # comment-only pragma: applies to the statement it precedes —
            # skip over the rest of the comment block to the first code line
            j = i
            while j < len(lines) and (not lines[j].strip()
                                      or lines[j].lstrip().startswith("#")):
                j += 1
            target = j + 1
            line_waivers.setdefault(target, set()).update(rules)
            if j < len(lines) and re.match(r"\s*(async\s+)?def\b", lines[j]):
                def_waivers.setdefault(target, set()).update(rules)
        elif re.match(r"\s*(async\s+)?def\b", code):
            def_waivers.setdefault(i, set()).update(rules)
        line_waivers.setdefault(i, set()).update(rules)
    return line_waivers, def_waivers, findings


class AnalyzedFile:
    """One parsed source file plus its pragma maps."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.tree = ast.parse(self.text, filename=str(path))
        self.lines = self.text.splitlines()
        (self.line_waivers, self.def_waivers,
         self.pragma_findings) = parse_pragmas(self.text, self.rel)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def waived(self, rule: str, lineno: int,
               def_lines: Sequence[int] = ()) -> bool:
        """Is ``rule`` waived at ``lineno``?  ``def_lines`` are the ``def``
        line numbers of the enclosing function(s), checked for body-wide
        waivers."""
        rules = self.line_waivers.get(lineno, set())
        if rule in rules or "*" in rules:
            return True
        for dl in def_lines:
            drules = self.def_waivers.get(dl, set())
            if rule in drules or "*" in drules:
                return True
        return False


def iter_python_files(root: Path,
                      subset: Optional[Sequence[str]] = None) -> List[Path]:
    """Python files under ``root``; ``subset`` restricts to the given
    root-relative paths (silently skipping ones that do not exist, so a
    fixture tree need not mirror the whole layout)."""
    if subset is not None:
        return [root / s for s in subset if (root / s).exists()]
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


# ------------------------------------------------------------------ baseline --

def load_baseline(path: Optional[Path]) -> Tuple[Set[str], List[str]]:
    """Read a baseline file: one ``<fingerprint> <pass:rule> <path> — reason``
    per line.  Returns ``(fingerprints, errors)``; a line without a reason
    is an error (the baseline must justify every entry)."""
    fps: Set[str] = set()
    errors: List[str] = []
    if path is None or not path.exists():
        return fps, errors
    for i, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        fp = parts[0]
        rest = parts[1] if len(parts) > 1 else ""
        if not re.fullmatch(r"[0-9a-f]{12}", fp):
            errors.append(f"{path}:{i}: malformed fingerprint {fp!r}")
            continue
        if not re.search(r"(?:[—–]|--|-)\s*\S", rest):
            errors.append(
                f"{path}:{i}: baseline entry {fp} has no reason — every "
                f"grandfathered finding must say why it is not fixed")
            continue
        fps.add(fp)
    return fps, errors


def split_baselined(
    findings: Sequence[Finding], baseline: Set[str],
) -> Tuple[List[Finding], List[Finding]]:
    """Partition into (active, suppressed): a finding is suppressed by its
    fingerprint."""
    active, suppressed = [], []
    for f in findings:
        if f.fingerprint in baseline:
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed

