"""Roofline-guided design space exploration (the paper's §3.3, Eq. 2-6; C4).

The port of the JAX package's ``repro.core.dse``, the paper's model kept as
it is.  The paper splits the FPGA's resources between the static
projection engine and the two attention modules under

    r_proj + max(r_atten_pre, r_atten_dec) <= R_total            (Eq. 2)

and picks the configuration that minimizes

    T_pre + alpha*T_dec(L_long) + (1-alpha)*T_dec(L_short)       (Eq. 6)
    s.t. T_pre <= T_pre_max,   alpha = 0.7

Here the shared resource is the chip's on-chip store, ``ChipSpec.vmem_bytes``
(the TPU's VMEM; on ``H100_SXM``, the default chip, the 50 MB L2 that
``common.hardware`` names): the TLMM tiles of the static region and the
working set of whichever attention module is loaded time-share it.  The
tunables are block shapes — the prefill attention block ``blk``, the decode
KV block ``bk`` and the TLMM tile — and the latency models are rooflines
with block-dependent efficiency ramps:

  * compute efficiency grows with the tile: eff_c(b) = b / (b + 64);
  * streaming efficiency grows with the transfer:
    eff_m(bytes) = bytes / (bytes + 96 KiB).

T_pre(L) = P_proj*L / f_pre + P_attn*L^2 / g_pre(blk) + T_weights   (Eq. 3)
T_dec(L) = D_proj / f_dec + D_attn*L / g_dec(bk) + T_weights        (Eq. 5)

with the P/D coefficients from the architecture's operations and bytes a
token.  The model tunes no kernel of the port (the CUDA kernels' tiles are
fixed in ``csrc/``, their costs in ``kernels.costs``); ``best_config`` is
what the example ``examples/dse_explore.py`` prints.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

from repro_torch.common.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DseConfig:
    prefill_blk: int
    decode_bk: int
    tlmm_bm: int
    tlmm_bk: int
    tlmm_bn: int

    def vmem_prefill(self, cfg: ModelConfig) -> int:
        d = cfg.head_dim
        b = self.prefill_blk
        # q, k, v tiles (bf16, double-buffered k/v) + m/l/acc scratch (f32)
        return 2 * (b * d) + 2 * 2 * (2 * b * d) + 4 * (2 * b * 128 + b * d)

    def vmem_decode(self, cfg: ModelConfig) -> int:
        d = cfg.head_dim
        g = max(cfg.q_group, 1)
        # q pinned + double-buffered K and V streams + scratch
        return 2 * (g * d) + 2 * 2 * (2 * self.decode_bk * d) + 4 * (2 * g * 128 + g * d)

    def vmem_static(self) -> int:
        # TLMM tiles: x (int8) + packed w (uint8/4) + acc (int32), dbl-buffered
        return 2 * (self.tlmm_bm * self.tlmm_bk) + 2 * (self.tlmm_bk // 4 * self.tlmm_bn) + 4 * self.tlmm_bm * self.tlmm_bn


@dataclasses.dataclass
class DsePoint:
    config: DseConfig
    t_pre: float
    t_dec_short: float
    t_dec_long: float
    objective: float
    vmem_bytes: int
    feasible: bool
    note: str = ""


def _eff_compute(block: int) -> float:
    return block / (block + 64.0)


def _eff_mem(bytes_per_transfer: float) -> float:
    return bytes_per_transfer / (bytes_per_transfer + 96 * 1024.0)


@dataclasses.dataclass
class ArchCoefficients:
    """P_proj/P_attn/D_proj/D_attn of Eq. (3)/(5), per token (per chip)."""

    proj_flops_per_tok: float  # dense projection+FFN flops per token
    attn_flops_per_tok_per_ctx: float  # attention flops per token per context token
    proj_bytes_per_tok_dec: float  # weight bytes streamed per decode token
    kv_bytes_per_tok_per_ctx: float  # KV bytes per decode token per context token
    weights_bytes: float  # resident weights (T_weights analogue: one full stream)

    @staticmethod
    def from_config(cfg: ModelConfig, chips: int = 1, kv_dtype: str = "fp") -> "ArchCoefficients":
        from repro_torch.core.roofline import kv_bytes_per_ctx_token

        n_active = cfg.active_param_count()
        wbytes = 0.25 if cfg.quant.ternary else 2.0
        # Eq. (5) KV coefficient, parameterized by cache precision: int8/int4
        # payload + fp32 scale rows (core.roofline owns the arithmetic)
        kv_per_tok = kv_bytes_per_ctx_token(cfg, kv_dtype)
        attn_flops = 0 if cfg.attention_free else 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim
        return ArchCoefficients(
            proj_flops_per_tok=2 * n_active / chips,
            attn_flops_per_tok_per_ctx=attn_flops / chips,
            proj_bytes_per_tok_dec=n_active * wbytes / chips,
            kv_bytes_per_tok_per_ctx=kv_per_tok / chips,
            weights_bytes=n_active * wbytes / chips,
        )


def t_prefill(co: ArchCoefficients, cfg_p: DseConfig, length: int, chip: ChipSpec = DEFAULT_CHIP) -> float:
    d = 128
    f_pre = chip.peak_flops_int8 * _eff_compute(cfg_p.tlmm_bm)  # int8 TLMM
    g_pre = chip.peak_flops_bf16 * _eff_compute(cfg_p.prefill_blk)
    t_w = co.weights_bytes / chip.hbm_bw  # one pass over resident weights
    return co.proj_flops_per_tok * length / f_pre + co.attn_flops_per_tok_per_ctx * length**2 / g_pre + t_w


def t_decode(co: ArchCoefficients, cfg_p: DseConfig, context: int, chip: ChipSpec = DEFAULT_CHIP,
             tokens_per_round: float = 1.0) -> float:
    """Per-token decode latency at a given context (Eq. 5).

    ``tokens_per_round`` amortizes the weight + KV stream over a
    speculative verify round's expected emitted tokens
    (``core.roofline.expected_accept_length``): the round streams
    weights and cache ONCE whatever the draft depth — the verify FLOPs for
    the extra k positions ride in the bandwidth shadow on a memory-bound
    fabric — so the per-token bound divides by the expected acceptance
    length.  1.0 (the default) is plain decode."""
    d = 128
    f_dec = chip.hbm_bw * _eff_mem(256 * 1024)  # weight streaming, big transfers
    kv_transfer = cfg_p.decode_bk * d * 2
    g_dec = chip.hbm_bw * _eff_mem(kv_transfer)
    per_round = co.proj_bytes_per_tok_dec / f_dec + co.kv_bytes_per_tok_per_ctx * context / g_dec
    return per_round / max(tokens_per_round, 1.0)


def run_dse(
    cfg: ModelConfig,
    *,
    chips: int = 1,
    alpha: float = 0.7,
    l_short: int = 128,
    l_long: int = 2048,
    prefill_len: int = 512,
    t_pre_max: Optional[float] = None,
    chip: ChipSpec = DEFAULT_CHIP,
    static_baseline: bool = False,
    kv_dtype: str = "fp",
    spec_k: int = 0,
    spec_accept_rate: float = 0.0,
) -> List[DsePoint]:
    """Enumerate the space; returns points sorted by Eq. (6) objective.

    static_baseline=True models the paper's static-accelerator comparison:
    ONE attention configuration serves both phases, so the constraint
    becomes r_proj + r_pre + r_dec <= R (both RMs resident) and blk == bk.
    ``kv_dtype`` shifts the Eq. (5) KV coefficient (quantized cache);
    ``spec_k``/``spec_accept_rate`` amortize the decode terms over the
    expected speculative acceptance length (prompt-lookup verify rounds) —
    the two levers compose multiplicatively.
    """
    co = ArchCoefficients.from_config(cfg, chips, kv_dtype)
    from repro_torch.core.roofline import expected_accept_length

    tokens_per_round = expected_accept_length(spec_k, spec_accept_rate)
    points: List[DsePoint] = []
    blks = [128, 256, 512]
    bks = [128, 256, 512, 1024, 2048]
    tlmms = [(128, 512, 128), (256, 512, 256), (128, 1024, 256)]
    for blk, bk, (tm, tk, tn) in itertools.product(blks, bks, tlmms):
        if static_baseline and blk != bk:
            continue
        p = DseConfig(blk, bk, tm, tk, tn)
        if static_baseline:
            vmem = p.vmem_static() + p.vmem_prefill(cfg) + p.vmem_decode(cfg)  # both resident
        else:
            vmem = p.vmem_static() + max(p.vmem_prefill(cfg), p.vmem_decode(cfg))  # Eq. (2)
        feasible = vmem <= chip.vmem_bytes
        tp = t_prefill(co, p, prefill_len, chip)
        td_s = t_decode(co, p, l_short, chip, tokens_per_round)
        td_l = t_decode(co, p, l_long, chip, tokens_per_round)
        if t_pre_max is not None and tp > t_pre_max:
            feasible = False
        obj = tp + alpha * td_l + (1 - alpha) * td_s  # Eq. (6)
        points.append(DsePoint(p, tp, td_s, td_l, obj, vmem, feasible))
    points.sort(key=lambda x: (not x.feasible, x.objective))
    return points


def best_config(cfg: ModelConfig, **kw) -> DseConfig:
    pts = run_dse(cfg, **kw)
    for p in pts:
        if p.feasible:
            return p.config
    return pts[0].config
