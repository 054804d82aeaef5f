"""Weights drawn as the JAX package draws them.

``init_like_jax(cfg, seed)`` gives the latent f32 weights of
``transformer.init(cfg, PRNGKey(seed), float32)`` of the JAX package, in the
port's layout: threefry keys and bits bit for bit (``core.sampling``), the
normal through the polynomial inverse error function XLA evaluates, equal
to float rounding.  The quickstart and the serving CLI draw their weights
with it, so that a CPU run of either prints the JAX one's tokens.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core.sampling import MASK32, random_bits, threefry2x32
from repro_torch.models import transformer as T

# Giles's single-precision erf_inv polynomial (the one XLA evaluates), in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _split(key, n: int):
    """``jax.random.split(key, n)`` (threefry, partitionable): key i is the
    threefry of the counter (0, i)."""
    k0, k1 = key
    x1 = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return [(y0[i], y1[i]) for i in range(n)]


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = torch.where(small, torch.tensor(a, device=x.device),
                        torch.tensor(b, device=x.device)) + p * w
    return p * x


def _normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: uniform on
    [nextafter(-1, 0), 1) from the key's bits, times sqrt(2), through the
    inverse error function."""
    n = math.prod(shape)
    bits = random_bits((key[0].reshape(1), key[1].reshape(1)), n)[0]
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).to(bits.device)
    u = torch.maximum(floats * 2.0 + lo, lo)  # (1 - lo) rounds to 2.0 in f32
    return (_erf_inv(u) * math.sqrt(2)).reshape(shape)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_like_jax(cfg, seed: int = 0, device=None, *, draw_device="cpu") -> dict:
    """The latent f32 weights of the JAX package's
    ``transformer.init(cfg, PRNGKey(seed), float32)`` (its key-split tree,
    layer by layer) on ``device`` (CUDA by default): QKV biases as zeros, an
    untied ``lm_head`` from the third key of the root split, an MoE layer
    from ``moe_init``'s four-way split of the layer's FFN key.  They are
    drawn on ``draw_device``: the CPU by default, whose float ops round as
    the JAX package's on the CPU do; a card draws a full-width model in
    seconds where the CPU takes minutes, its ``log1p`` possibly an ulp
    away."""
    dev = resolve_device(device)
    draw = torch.device(draw_device)
    k_emb, k_layers, k_head = _split((torch.tensor(0, device=draw),
                                      torch.tensor(seed & MASK32, device=draw)), 3)
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(key, k, n, scale=None, bias=False):
        p = {"w": _normal(key, (k, n)) * (1.0 / k ** 0.5 if scale is None else scale)}
        if bias:
            p["b"] = torch.zeros(n)
        return p

    def ffn(kf):
        if cfg.moe:
            e, fe = cfg.num_experts, cfg.moe_d_ff
            r, g, u, w = _split(kf, 4)
            s_in, s_out = 1.0 / d ** 0.5, 1.0 / fe ** 0.5
            return "moe", {"router": _normal(r, (d, e)) * s_in,
                           "w_gate": _normal(g, (e, d, fe)) * s_in,
                           "w_up": _normal(u, (e, d, fe)) * s_in,
                           "w_down": _normal(w, (e, fe, d)) * s_out}
        m1, m2, m3 = _split(kf, 3)
        return "mlp", {"w_gate": lin(m1, d, f), "w_up": lin(m2, d, f),
                       "w_down": lin(m3, f, d, 1.0 / f ** 0.5)}

    layers = []
    for kl in _split(k_layers, cfg.num_layers):
        ka, kf = _split(kl, 2)
        k1, k2, k3, k4 = _split(ka, 4)
        bias = cfg.qkv_bias
        name, sub = ffn(kf)
        layers.append(_to({
            "attn": {"wq": lin(k1, d, h * hd, bias=bias), "wk": lin(k2, d, hkv * hd, bias=bias),
                     "wv": lin(k3, d, hkv * hd, bias=bias),
                     "wo": lin(k4, h * hd, d, 1.0 / (h * hd) ** 0.5)},
            "ln1": {"scale": torch.ones(d)}, "ln2": {"scale": torch.ones(d)}, name: sub,
        }, dev))
    params = {"emb": _to(_normal(k_emb, (cfg.padded_vocab(), d)) * 0.02, dev),
              "layers": T._stack(layers), "ln_f": {"scale": torch.ones(d, device=dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = _to(_normal(k_head, (d, cfg.padded_vocab())) * 0.02, dev)
    return params
