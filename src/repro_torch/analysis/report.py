"""Per-pass finding counts of the port's analysis — informational, exits 0.

The port of the JAX package's ``scripts/analysis_report.py``.  The
enforcing gate is ``python -m repro_torch.analysis --all``; this is the
summary for a reader: per-pass totals, how many are baselined vs active,
the rule histogram, and the ``program`` pass's static-cost-vs-roofline
residual table.  ``--json`` emits the same data as one machine-readable
object.

    PYTHONPATH=src python -m repro_torch.analysis.report [--root DIR] [--baseline FILE] [--json]
"""
import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis import PASSES, default_baseline, default_root, run_passes
from repro_torch.analysis.common import load_baseline, split_baselined


def report_data(root: Path, baseline_path: Path) -> dict:
    """The full report as one JSON-serializable object."""
    from repro_torch.analysis import progcheck

    fps, errors = load_baseline(baseline_path)
    results = run_passes(list(PASSES), root=root)
    passes = {}
    total_active = 0
    for name in PASSES:
        active, suppressed = split_baselined(results[name], fps)
        total_active += len(active)
        passes[name] = {
            "total": len(results[name]),
            "active": len(active),
            "baselined": len(suppressed),
            "rules": dict(sorted(Counter(
                f.rule for f in results[name]).items())),
            "findings": [f.render() for f in active],
        }
    return {
        "root": str(root),
        "baseline": str(baseline_path),
        "baseline_entries": len(fps),
        "baseline_errors": list(errors),
        "passes": passes,
        "cost_table": progcheck.cost_table(root),
        "total_active": total_active,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", type=Path, default=None,
                    help="tree to analyze (default: src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file (default: baseline.txt in the analysis package)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object instead of "
                         "the human-facing text")
    args = ap.parse_args()

    root = args.root or default_root()
    baseline_path = args.baseline or default_baseline()
    if args.json:
        print(json.dumps(report_data(root, baseline_path), indent=2))
        return 0
    fps, errors = load_baseline(baseline_path)
    results = run_passes(list(PASSES), root=root)

    print(f"repro_torch.analysis report — root={root}")
    print(f"baseline: {baseline_path} "
          f"({len(fps)} entr{'y' if len(fps) == 1 else 'ies'})")
    total_active = 0
    for name in PASSES:
        found = results[name]
        active, suppressed = split_baselined(found, fps)
        total_active += len(active)
        print(f"\n[{name}] {len(found)} finding(s)"
              f" — {len(active)} active, {len(suppressed)} baselined")
        hist = Counter(f.rule for f in found)
        for rule, n in sorted(hist.items()):
            print(f"    {rule:<28} {n}")
        for f in active:
            print(f"    {f.render()}")
    from repro_torch.analysis import progcheck

    rows = progcheck.cost_table(root)
    if rows:
        print("\n[program] static cost vs roofline "
              "(counted / bound, per audited program):")
        for r in rows:
            flag = "" if r["tol_lo"] <= r["ratio"] <= r["tol_hi"] \
                else "  <-- OUT OF BAND"
            print(f"    {r['layout']:<11} {r['kv_dtype']:<5} "
                  f"{r['program']:<34} {r['kind']:<16} "
                  f"ratio={r['ratio']:.3f} "
                  f"[{r['tol_lo']}, {r['tol_hi']}]{flag}")
    for e in errors:
        print(f"\nbaseline error: {e}")
    print(f"\ntotal active findings: {total_active}"
          + (" (gate would FAIL)" if total_active or errors else ""))
    return 0  # informational by contract; the gate is `-m repro_torch.analysis`


if __name__ == "__main__":
    sys.exit(main())
