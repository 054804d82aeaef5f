"""Design-space exploration walkthrough (the paper's Eq. 2-6).

Runs the roofline-guided DSE for the paper's BitNet 0.73B and one other
arch on a chip, printing the best points of the space and the chosen
phase-module configuration, and the static-baseline comparison the paper's
Fig. 6 quantifies.  Analytic: nothing runs on a device.

    PYTHONPATH=src python -m repro_torch.examples.dse_explore [--arch qwen2.5-14b] [--chip h100-sxm]
"""
from __future__ import annotations

import argparse

from repro_torch.common.hardware import DEFAULT_CHIP, H100_SXM, TPU_V5E, ChipSpec
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.dse import run_dse

CHIPS = {c.name: c for c in (H100_SXM, TPU_V5E)}


def explore(arch: str, top: int = 5, chip: ChipSpec = DEFAULT_CHIP) -> None:
    cfg = get_config(arch)
    if cfg.attention_free:
        print(f"{arch}: attention-free — no attention RM to size (phase split still applies)")
        return
    print(f"\n=== {arch} ===")
    pts = run_dse(cfg, chip=chip)
    print(f"{'feas':4s} {'blk':>5s} {'bk':>5s} {'tlmm':>13s} {'vmem KiB':>9s} "
          f"{'T_pre':>8s} {'T_dec(2k)':>9s} {'Eq6 obj':>8s}")
    for pt in pts[:top]:
        c = pt.config
        print(f"{'y' if pt.feasible else 'n':4s} {c.prefill_blk:5d} {c.decode_bk:5d} "
              f"{c.tlmm_bm}x{c.tlmm_bk}x{c.tlmm_bn:>4d} {pt.vmem_bytes/1024:9.0f} "
              f"{pt.t_pre:8.3f} {pt.t_dec_long:9.4f} {pt.objective:8.3f}")
    static = run_dse(cfg, static_baseline=True, chip=chip)
    sbest = next((x for x in static if x.feasible), static[0])
    best = next((x for x in pts if x.feasible), pts[0])
    print(f"swap objective {best.objective:.3f}s vs static-best {sbest.objective:.3f}s "
          f"-> logic swapping wins {sbest.objective/best.objective:.2f}x (Eq. 6, alpha=0.7)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ALL_ARCHS, default="qwen2.5-14b")
    p.add_argument("--chip", choices=sorted(CHIPS), default=DEFAULT_CHIP.name,
                   help="the chip whose rates and on-chip budget the model takes "
                        "(default: the port's card)")
    args = p.parse_args(argv)
    chip = CHIPS[args.chip]
    explore("bitnet-730m", chip=chip)
    explore(args.arch, chip=chip)


if __name__ == "__main__":
    main()
