"""The port's analysis passes: lock discipline, determinism, the CUDA
kernels' invariants, and the program-level auditor.

The port of the JAX package's ``repro.analysis``.  Run as::

    PYTHONPATH=src python -m repro_torch.analysis [--all | --pass NAME] \\
        [--baseline FILE] [--root DIR] [--device cpu|cuda]

The ``lock`` and ``determinism`` passes read source and are the JAX
package's; ``kernel`` checks the CUDA kernels (``kernels.costs`` against
the card's limits and the plain versions' contracts on the CPU; with
``--device cuda`` every launch inside guard bands on the card); ``program``
runs every serving program once on the CPU at its signature.  The pragma
and baseline workflow is the JAX package's (``analysis.common``); the
port's baseline is ``baseline.txt`` beside this file.  Programmatic use::

    from repro_torch.analysis import run_passes
    findings = run_passes(["lock", "determinism"], root=Path("src/repro_torch"))
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.common import (  # noqa: F401  (public API)
    Finding, load_baseline, split_baselined)

PASSES = ("lock", "kernel", "determinism", "program")
DEVICES = ("cpu", "cuda")


def repo_root() -> Path:
    """The repository root (two levels above ``src/repro_torch``)."""
    return Path(__file__).resolve().parents[3]


def default_root() -> Path:
    """The analyzed tree: ``src/repro_torch``."""
    return Path(__file__).resolve().parents[1]


def default_baseline() -> Path:
    return Path(__file__).resolve().parent / "baseline.txt"


def run_passes(names: Sequence[str], root: Optional[Path] = None,
               device: str = "cpu") -> Dict[str, List[Finding]]:
    """Run the named passes; returns ``{pass_name: [findings...]}`` with
    duplicate findings (same fingerprint + line) collapsed.  ``device``
    ``cuda`` adds the kernel pass's half on the card."""
    if device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    root = root or default_root()
    out: Dict[str, List[Finding]] = {}
    for name in names:
        if name == "lock":
            from repro_torch.analysis import locklint
            found = locklint.run(root)
        elif name == "determinism":
            from repro_torch.analysis import determinism
            found = determinism.run(root)
        elif name == "kernel":
            from repro_torch.analysis import kernel_check
            found = kernel_check.run(root, device=device)
        elif name == "program":
            from repro_torch.analysis import progcheck
            found = progcheck.run(root)
        else:
            raise ValueError(f"unknown pass {name!r}; choose from {PASSES}")
        seen = set()
        deduped = []
        for f in found:
            key = (f.fingerprint, f.line)
            if key not in seen:
                seen.add(key)
                deduped.append(f)
        out[name] = deduped
    return out
