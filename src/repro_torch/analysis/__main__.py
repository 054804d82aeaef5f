"""The command line: ``python -m repro_torch.analysis [--all|--pass NAME] [...]``.

Exit codes: 0 clean (baselined findings allowed), 1 non-baselined findings
or a malformed baseline, 2 a usage error (argparse).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import (
    DEVICES, PASSES, default_baseline, default_root, load_baseline, run_passes,
    split_baselined)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lock-discipline, kernel-invariant, determinism and "
                    "program-level analysis over src/repro_torch")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when no --pass is given)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=list(PASSES), metavar="NAME",
                    help=f"run one pass (repeatable): {', '.join(PASSES)}")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file of grandfathered fingerprints "
                         "(default: baseline.txt in the analysis package)")
    ap.add_argument("--root", type=Path, default=None,
                    help="tree to analyze (default: the installed src/repro_torch)")
    ap.add_argument("--device", choices=list(DEVICES), default="cpu",
                    help="cuda also runs the kernel pass's launches on the card")
    args = ap.parse_args(argv)

    names = list(PASSES) if (args.all or not args.passes) else args.passes
    baseline_path = args.baseline or default_baseline()
    baseline, errors = load_baseline(baseline_path)
    root = (args.root or default_root()).resolve()

    results = run_passes(names, root=root, device=args.device)
    exit_code = 0
    total_active = 0
    for name in names:
        active, suppressed = split_baselined(results[name], baseline)
        extra = f"  ({len(suppressed)} baselined)" if suppressed else ""
        print(f"[{name}] {len(active)} finding(s){extra}")
        for f in sorted(active, key=lambda f: (f.path, f.line, f.rule)):
            print(f"  {f.render()}")
        total_active += len(active)
    for e in errors:
        print(f"[baseline] ERROR: {e}")
    if errors or total_active:
        exit_code = 1
        print(f"\nFAIL: {total_active} non-baselined finding(s)"
              + (f", {len(errors)} baseline error(s)" if errors else ""))
        print("Fix the code, add an '# analysis: allow(<rule>) — <reason>' "
              "pragma, or baseline with a reason (README: the port's analysis "
              "passes).")
    else:
        print("\nOK: no non-baselined findings")
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
