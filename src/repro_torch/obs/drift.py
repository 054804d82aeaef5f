"""Roofline drift: the measured time a token of each serving phase against
its analytic bound, as a metric.

The port of the JAX package's ``repro.obs.drift``.  ``roofline_drift()``
compares what the engine measured (``EngineStats`` time sums and its
streamed-context counter) with what ``core.roofline`` predicts for the same
work on ``chip`` (the port's card by default):

* ``prefill``: measured seconds a prefill token against the 2N compute
  bound (N the model's parameter count);
* ``decode``: measured seconds a decoded token against Eq. (5) at the mean
  streamed context, divided by the measured tokens a slot-round (1.0
  without speculation);
* ``spec_verify``, when verify rounds ran: the same measured number against
  the speculative bound at the measured acceptance rate.

``residency_ratio = bound / measured``, the fraction of the roofline the
engine reaches (1.0 at the bound).  Host arithmetic over counters the engine
keeps and tensor shapes: safe to compute at every scrape, from any thread.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.common.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.core.roofline import predict_phase, roofline_residency
from repro_torch.quant.ternary import TernaryWeight

PHASES = ("prefill", "decode", "spec_verify")


def _count(node) -> int:
    if isinstance(node, dict):
        return sum(_count(v) for v in node.values())
    if isinstance(node, TernaryWeight):
        # (L, K/4, N) packed words hold L x K x N ternary weights; beta is
        # a scale of the weights, not a parameter of the model
        return node.packed.numel() * 4
    return node.numel()


def _n_params(runner) -> int:
    """The loaded model's parameter count, from tensor shapes only, cached
    on the runner.  Latent weights count their elements; a packed ternary
    linear counts its K x N weights."""
    cached = getattr(runner, "_obs_n_params", None)
    if cached is None:
        cached = runner._obs_n_params = _count(runner.params)
    return cached


def _entry(measured: float, bound: float, **extra) -> Dict[str, Any]:
    out = {"measured_s_per_token": measured, "bound_s_per_token": bound,
           "residency_ratio": roofline_residency(bound, measured)}
    out.update(extra)
    return out


def roofline_drift(core, chip: ChipSpec = DEFAULT_CHIP) -> Dict[str, Dict[str, Any]]:
    """Per phase ``{measured_s_per_token, bound_s_per_token,
    residency_ratio, ...}`` for the engine's accumulated stats; a phase
    with no tokens yet is left out."""
    stats = core.stats
    runner = core.runner
    cfg, kv_dtype = runner.cfg, runner.kv_dtype
    out: Dict[str, Dict[str, Any]] = {}
    if stats.prefill_tokens and stats.t_prefill > 0.0:
        n = _n_params(runner)
        out["prefill"] = _entry(stats.t_prefill / stats.prefill_tokens,
                                predict_phase("prefill", n_params=n, chip=chip).t_per_token,
                                n_params=n)
    if stats.decode_tokens and stats.t_decode > 0.0:
        # the mean context streamed a decode pass: each round streams every
        # active slot's cache once
        ctx = stats.decode_ctx_tokens / stats.slot_rounds if stats.slot_rounds else 0.0
        measured = stats.t_decode / stats.decode_tokens
        tpr = max(stats.tokens_per_round(), 1.0)
        out["decode"] = _entry(
            measured,
            predict_phase("decode", cfg, context=ctx, kv_dtype=kv_dtype,
                          chip=chip).t_per_token / tpr,
            context_mean=ctx, kv_dtype=kv_dtype, tokens_per_round=tpr)
        if stats.verify_rounds and runner.spec_decode:
            out["spec_verify"] = _entry(
                measured,
                predict_phase("spec_verify", cfg, context=ctx, k=runner.spec_decode,
                              accept_rate=stats.acceptance_rate(), kv_dtype=kv_dtype,
                              chip=chip).t_per_token,
                context_mean=ctx, kv_dtype=kv_dtype, accept_rate=stats.acceptance_rate(),
                k=runner.spec_decode)
    return out
