"""Analytic roofline bounds of the serving phases.

The port of the analytic half of the JAX package's ``repro.core.roofline``:
the paper's Eq. (5) decode bound (KV bytes streamed a token over device
memory bandwidth), the prefill compute bound (2N operations a token over
peak), the speculative bound (decode's divided by the expected accepted
length), and the phase predictions ``obs.drift`` turns into residency
ratios.  The bit widths come from the port's storage formats
(``quant.kv_quant``).  Every function takes the chip; the default is the
port's card (``common.hardware.DEFAULT_CHIP``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.quant.kv_quant import KV_DTYPE_BITS, SCALE_BITS as KV_SCALE_BITS


def kv_bytes_per_ctx_token(cfg, kv_dtype: str = "fp", *, include_scales: bool = True) -> float:
    """Bytes of one cached token (K and V, every layer) streamed a decode
    step: the Eq. (5) coefficient.  Quantized formats add the f32 scale of
    each (layer, head, token) row unless ``include_scales=False``."""
    if kv_dtype not in KV_DTYPE_BITS:
        raise ValueError(f"kv_dtype must be one of {sorted(KV_DTYPE_BITS)}, got {kv_dtype!r}")
    kv_heads = 0 if getattr(cfg, "attention_free", False) else cfg.num_kv_heads
    payload = 2 * cfg.num_layers * kv_heads * cfg.head_dim * KV_DTYPE_BITS[kv_dtype] / 8
    scales = 0.0
    if kv_dtype != "fp" and include_scales:
        scales = 2 * cfg.num_layers * kv_heads * KV_SCALE_BITS / 8
    return payload + scales


def decode_kv_stream_time(cfg, context: int, kv_dtype: str = "fp",
                          chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Eq. (5): seconds a decoded token spends streaming a ``context``-token
    cache at the given precision."""
    return predict_phase("decode", cfg, context=context, kv_dtype=kv_dtype,
                         chip=chip).t_per_token


def expected_accept_length(k: int, accept_rate: float) -> float:
    """Expected tokens a speculative verify round emits at draft depth ``k``
    and acceptance probability ``accept_rate`` (i.i.d.):
    ``(1 - p^{k+1}) / (1 - p)``, from 1 (p = 0) to ``k + 1`` (p = 1)."""
    if k <= 0:
        return 1.0
    p = min(max(float(accept_rate), 0.0), 1.0)
    if p >= 1.0:
        return float(k + 1)
    return (1.0 - p ** (k + 1)) / (1.0 - p)


@dataclasses.dataclass(frozen=True)
class PhasePrediction:
    """The roofline prediction of one serving phase: ``flops`` a prefill
    token (2N; 0 for the KV-bound phases), ``hbm_bytes`` of KV streamed a
    round (0 for prefill), ``t_per_token`` the bound in seconds an emitted
    token."""

    phase: str  # "prefill" | "decode" | "spec_verify"
    flops: float
    hbm_bytes: float
    t_per_token: float
    kv_dtype: str = "fp"


def predict_phase(phase: str, cfg=None, *, n_params: float = 0.0, context: float = 0.0,
                  kv_dtype: str = "fp", batch: int = 1, k: int = 0, accept_rate: float = 0.0,
                  chip: ChipSpec = DEFAULT_CHIP) -> PhasePrediction:
    """* ``prefill``: compute-bound, ``flops = 2 * n_params`` a token over
      the bf16 peak (``cfg`` unused);
    * ``decode``: KV-bound, ``batch * context * kv_bytes_per_ctx_token``
      bytes a round, ``t`` one slot's stream over the memory bandwidth;
    * ``spec_verify``: decode's bytes, ``t`` divided by
      ``expected_accept_length(k, accept_rate)``."""
    if phase == "prefill":
        flops = 2.0 * float(n_params)
        return PhasePrediction(phase, flops, 0.0, flops / chip.peak_flops_bf16, kv_dtype)
    if phase not in ("decode", "spec_verify"):
        raise ValueError(f"phase must be prefill | decode | spec_verify, got {phase!r}")
    stream = kv_bytes_per_ctx_token(cfg, kv_dtype) * float(context)
    t = stream / chip.hbm_bw
    if phase == "spec_verify":
        t /= expected_accept_length(k, accept_rate)
    return PhasePrediction(phase, 0.0, batch * stream, t, kv_dtype)


def decode_kv_stream_time_speculative(cfg, context: int, k: int, accept_rate: float,
                                      kv_dtype: str = "fp",
                                      chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Eq. (5) amortized by speculation: a verify round streams the cache
    once and emits ``expected_accept_length(k, accept_rate)`` tokens."""
    return predict_phase("spec_verify", cfg, context=context, k=k, accept_rate=accept_rate,
                         kv_dtype=kv_dtype, chip=chip).t_per_token


def prefill_compute_time(n_params: float, chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Seconds a prefill token at the compute roof: 2 operations a
    parameter a token (the forward pass) over the peak."""
    return predict_phase("prefill", n_params=n_params, chip=chip).t_per_token


def roofline_residency(bound_s: float, measured_s: float) -> float:
    """bound / measured: the fraction of the phase's roofline reached (1.0 at
    the bound); 0.0 when nothing was measured."""
    if measured_s <= 0.0:
        return 0.0
    return float(bound_s) / float(measured_s)


def decode_arithmetic_intensity(cfg, kv_dtype: str = "fp") -> float:
    """Attention operations a KV byte streamed in decode: 2 (QK^T) + 2 (PV)
    a query head, head_dim element and layer, over the Eq. (5)
    coefficient."""
    kv_heads = 0 if getattr(cfg, "attention_free", False) else cfg.num_kv_heads
    if kv_heads == 0:
        return 0.0
    flops = 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim
    return flops / kv_bytes_per_ctx_token(cfg, kv_dtype)
