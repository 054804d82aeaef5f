"""Mixture-of-Experts FFN with sort-based capacity routing: the JAX
package's ``repro.layers.moe`` on one device.

Every expert is local (the JAX package's expert- and tensor-parallel
distribution is mesh tooling, ROADMAP A.10).  Routing is sort-based
(argsort + per-expert rank), never materializing the (T, E, C) one-hot
dispatch tensor.  The expert products are batched matmuls, as the JAX
package's are einsums outside any Pallas kernel.

The layer runs inside the captured decode, chunk and verify programs, so:

* nothing reads a value back to the host: the per-expert counts are a
  ``scatter_add_`` over ``num_experts`` (``bincount`` would size its output
  from the data), and no ``nonzero`` or boolean indexing appears;
* the capacity ``C = max(8, int(T * k / E * factor))`` depends only on the
  row count T, padding rows included, so the port routes exactly the rows
  the JAX programs route (a prefill bucket, every decode slot, B x W verify
  rows, a padded chunk);
* the combine is deterministic: each token's k contributions are summed one
  after another in top-k order in the output dtype, which is also the
  order in which the JAX scatter-add rounds them (``index_add_`` on a card
  adds with atomics in no fixed order);
* a dropped assignment goes to the spare row ``E * C`` of the dispatch
  buffer and is weighted 0 in the combine, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.ternary import ternary_quantize, ternary_quantize_ste

# Token-chunk size for the dispatch buffer (the JAX package's): bounds the
# (E, C, d) working set of a long prompt.
MOE_TOKEN_CHUNK = 8192


def moe_init(cfg: ModelConfig, gen: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's draws: router N(0, 1/d) kept f32, expert stacks
    w_gate / w_up (E, d, f) N(0, 1/d) and w_down (E, f, d) N(0, 1/f) in
    ``dtype``, each drawn in f32 and cast."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / d**0.5, 1.0 / f**0.5

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    return {
        "router": torch.randn((d, e), generator=gen, device=device) * s_in,
        "w_gate": draw((e, d, f), s_in),
        "w_up": draw((e, d, f), s_in),
        "w_down": draw((e, f, d), s_out),
    }


def _maybe_ternary(w: torch.Tensor, cfg: ModelConfig, training: bool = False) -> torch.Tensor:
    """Under ``quant_mode="ternary"``: one layer's whole (E, ·, ·) stack
    fake-quantized with one absmean (not one per expert), as the JAX
    package's ``_maybe_ternary``; in training through the straight-through
    quantizer (f32); bf16 configs pass through."""
    if not cfg.quant.ternary:
        return w
    if training:
        return ternary_quantize_ste(w.float())[0]
    w_q, beta = ternary_quantize(w.float())
    return (w_q.float() * beta).to(w.dtype)


def _route(gate_logits: torch.Tensor, k: int, capacity: int, num_experts: int):
    """Sort-based top-k routing.  gate_logits: (T, E) f32.

    Returns (token_idx (T*k,), dest (T*k,) into the E*C flat buffer, or
    E*C when dropped, combine weights (T*k,) f32, probs (T, E))."""
    t = gate_logits.shape[0]
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)  # (T, k), descending
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(num_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix sum
    ranks_sorted = torch.arange(t * k, device=dev) - offsets[sorted_e]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    dest = torch.where(ranks < capacity, flat_e * capacity + ranks,
                       torch.full_like(ranks, num_experts * capacity))
    token_idx = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    return token_idx, dest, topv.reshape(-1), probs


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down.to(buf.dtype))


def _dispatch(x_flat, token_idx, dest, e: int, c: int) -> torch.Tensor:
    """Each kept assignment's token row into its expert slot of an
    (E*C + 1, d) buffer (dropped ones add into the spare last row, which is
    cut off): (E, C, d)."""
    buf = torch.zeros((e * c + 1, x_flat.shape[-1]), dtype=x_flat.dtype, device=x_flat.device)
    buf.index_add_(0, dest, x_flat[token_idx])
    return buf[: e * c].reshape(e, c, -1)


def _combine(y_buf, dest, weights, t: int, k: int) -> torch.Tensor:
    """Sum each token's k weighted expert outputs (T*k rows, token-major),
    one after another in top-k order in the buffer's dtype; a dropped
    assignment reads a real row and is weighted 0."""
    e_c = y_buf.shape[0] * y_buf.shape[1]
    y_flat = y_buf.reshape(e_c, -1)
    safe = torch.clamp(dest, max=e_c - 1)
    w = (weights * (dest < e_c)).to(y_flat.dtype)
    contrib = (y_flat[safe] * w[:, None]).reshape(t, k, -1)
    out = torch.zeros((t, y_flat.shape[-1]), dtype=y_flat.dtype, device=y_flat.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_tokens(x_flat: torch.Tensor, gate_logits: torch.Tensor, params: dict,
                cfg: ModelConfig, training: bool = False) -> torch.Tensor:
    """The MoE over T token rows: route, dispatch, expert FFNs, combine."""
    t = x_flat.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = max(8, int(t * k / e * cfg.moe_capacity_factor))
    w_gate = _maybe_ternary(params["w_gate"], cfg, training)
    w_up = _maybe_ternary(params["w_up"], cfg, training)
    w_down = _maybe_ternary(params["w_down"], cfg, training)
    token_idx, dest, comb_w, _ = _route(gate_logits, k, cap, e)
    buf = _dispatch(x_flat, token_idx, dest, e, cap)
    y_buf = _expert_ffn(buf, w_gate, w_up, w_down)
    return _combine(y_buf, dest, comb_w, t, k)


def _moe_tokens_chunked(x_flat: torch.Tensor, gate_logits: torch.Tensor, params: dict,
                        cfg: ModelConfig, chunk: int = MOE_TOKEN_CHUNK,
                        training: bool = False) -> torch.Tensor:
    """``_moe_tokens`` over chunks of ``chunk`` rows (the last one padded
    with zero rows, which route and claim capacity as in the JAX scan)."""
    t, d = x_flat.shape
    if t <= chunk:
        return _moe_tokens(x_flat, gate_logits, params, cfg, training)
    pad = (-t) % chunk
    if pad:
        x_flat = F.pad(x_flat, (0, 0, 0, pad))
        gate_logits = F.pad(gate_logits, (0, 0, 0, pad))
    ys = [_moe_tokens(x_flat[i:i + chunk], gate_logits[i:i + chunk], params, cfg, training)
          for i in range(0, t + pad, chunk)]
    return torch.cat(ys)[:t]


def load_balance_loss(gate_logits: torch.Tensor, k: int, num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (f: token fraction, p: prob mass)."""
    probs = torch.softmax(gate_logits.float(), dim=-1).reshape(-1, num_experts)
    _, topi = torch.topk(probs, k, dim=-1)
    f = F.one_hot(topi, num_experts).float().sum(dim=-2).mean(dim=0) / k
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def _gate_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["router"].float()


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                training: bool = False) -> torch.Tensor:
    """The MoE FFN of x (B, S, d) -> (B, S, d) in x's dtype, without the
    aux loss (the serving programs discard it, as the JAX ones do)."""
    b, s, d = x.shape
    gl = _gate_logits(params, x)
    y = _moe_tokens_chunked(x.reshape(b * s, d), gl.reshape(b * s, -1), params, cfg,
                            training=training)
    return y.reshape(b, s, d).to(x.dtype)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d), aux loss scalar), as the JAX ``moe_apply``."""
    aux = load_balance_loss(_gate_logits(params, x), cfg.top_k, cfg.num_experts)
    return moe_forward(params, x, cfg, training=training), aux
