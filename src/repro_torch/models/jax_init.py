"""Weights drawn as the JAX package draws them.

``init_like_jax(cfg, seed)`` gives the latent f32 weights of the JAX
package's ``init(cfg, PRNGKey(seed), float32)`` of the config's family
(transformer, hymba, xlstm or encdec), in the port's layout: threefry keys
and bits bit for bit (``core.sampling``), each family's key-split tree,
the normal through the polynomial inverse error function XLA evaluates,
equal to float rounding.  The quickstart and the serving CLI draw their
weights with it, so that a CPU run of either prints the JAX one's tokens.
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


def _lin(key, k, n, dtype, scale=None, bias=False):
    """``linear_init``: N(0, 1) * (1/sqrt(K) or ``scale``) and a zero bias,
    in ``dtype``."""
    p = {"w": (_normal(key, (k, n)) * (1.0 / k ** 0.5 if scale is None else scale)).to(dtype)}
    if bias:
        p["b"] = torch.zeros(n, dtype=dtype)
    return p


def _attn(cfg, key, dtype, bias: bool = False) -> dict:
    """``attention_init``: four linears from a four-way split."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k1, k2, k3, k4 = _split(key, 4)
    return {"wq": _lin(k1, d, h * hd, dtype, bias=bias), "wk": _lin(k2, d, hkv * hd, dtype, bias=bias),
            "wv": _lin(k3, d, hkv * hd, dtype, bias=bias),
            "wo": _lin(k4, h * hd, d, dtype, 1.0 / (h * hd) ** 0.5)}


def _mlp(cfg, key, dtype) -> dict:
    """``mlp_init``: SwiGLU from a three-way split, the GELU MLP (biased)
    from a two-way one."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        m1, m2, m3 = _split(key, 3)
        return {"w_gate": _lin(m1, d, f, dtype), "w_up": _lin(m2, d, f, dtype),
                "w_down": _lin(m3, f, d, dtype, 1.0 / f ** 0.5)}
    m1, m2 = _split(key, 2)
    return {"w_in": _lin(m1, d, f, dtype, bias=True),
            "w_out": _lin(m2, f, d, dtype, 1.0 / f ** 0.5, bias=True)}


def _rms(d):
    return {"scale": torch.ones(d)}


def _layernorm(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_like_jax(cfg, seed: int = 0, device=None, *, draw_device="cpu",
                  dtype: torch.dtype = torch.float32) -> dict:
    """The weights of the JAX package's ``init(cfg, PRNGKey(seed), dtype)``
    for the config's family (its key-split tree, layer by layer) on
    ``device`` (CUDA by default): latent f32 by default, or the matrices in
    ``dtype`` with the norms and constants f32, as the JAX ``init`` keeps
    them.  They are drawn on ``draw_device``: the CPU by default, whose
    float ops round as the JAX package's on the CPU do; a card draws a
    full-width model in seconds where the CPU takes minutes, its ``log1p``
    possibly an ulp away."""
    dev = resolve_device(device)
    draw = torch.device(draw_device)
    root = (torch.tensor(0, device=draw), torch.tensor(seed & MASK32, device=draw))
    family = {"transformer": _transformer, "hymba": _hymba, "xlstm": _xlstm,
              "encdec": _encdec}[cfg.family]
    return family(cfg, root, dev, dtype)


def _transformer(cfg, root, dev, dtype) -> dict:
    """``transformer.init``: QKV biases as zeros, an untied ``lm_head`` from
    the third key of the root split, an MoE layer from ``moe_init``'s
    four-way split of the layer's FFN key (its router f32)."""
    k_emb, k_layers, k_head = _split(root, 3)
    d = cfg.d_model

    def ffn(kf):
        if cfg.moe:
            e, fe = cfg.num_experts, cfg.moe_d_ff
            r, g, u, w = _split(kf, 4)
            s_in, s_out = 1.0 / d ** 0.5, 1.0 / fe ** 0.5
            return "moe", {"router": _normal(r, (d, e)) * s_in,
                           "w_gate": (_normal(g, (e, d, fe)) * s_in).to(dtype),
                           "w_up": (_normal(u, (e, d, fe)) * s_in).to(dtype),
                           "w_down": (_normal(w, (e, fe, d)) * s_out).to(dtype)}
        return "mlp", _mlp(cfg, kf, dtype)

    layers = []
    for kl in _split(k_layers, cfg.num_layers):
        ka, kf = _split(kl, 2)
        name, sub = ffn(kf)
        layers.append(_to({"attn": _attn(cfg, ka, dtype, cfg.qkv_bias), "ln1": _rms(d),
                           "ln2": _rms(d), name: sub}, dev))
    params = {"emb": _to((_normal(k_emb, (cfg.padded_vocab(), d)) * 0.02).to(dtype), dev),
              "layers": T._stack(layers), "ln_f": _to(_rms(d), dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _to((_normal(k_head, (d, cfg.padded_vocab())) * 0.02).to(dtype), dev)
    return params


def _hymba(cfg, root, dev, dtype) -> dict:
    """``hymba.init``: a two-way root split (embedding, layers), each
    layer's key split three ways (attention, SSM, SwiGLU); the SSM's
    ``ssm_init`` six-way split and its f32 constants (``dt_bias`` -4.6,
    ``a_log`` log 1..N, ``d_skip`` 1); the gates 1, 0-d f32 leaves."""
    k_emb, k_layers = _split(root, 2)
    d, n = cfg.d_model, cfg.ssm_state
    s = 1.0 / d**0.5
    layers = []
    for kl in _split(k_layers, cfg.num_layers):
        ka, ks, kf = _split(kl, 3)
        k0, k1, k2, k3, k4, _ = _split(ks, 6)
        ssm = {"w_in": (_normal(k0, (d, 2 * d)) * s).to(dtype),
               "conv": (_normal(k1, (cfg.ssm_conv, d)) * 0.2).to(dtype),
               "w_bc": (_normal(k2, (d, 2 * n)) * s).to(dtype),
               "w_dt": (_normal(k3, (d, 1)) * s).to(dtype),
               "dt_bias": torch.full((d,), -4.6),
               "a_log": torch.log(torch.arange(1.0, n + 1)).expand(d, n).clone(),
               "d_skip": torch.ones(d), "w_out": (_normal(k4, (d, d)) * s).to(dtype)}
        layers.append(_to({"attn": _attn(cfg, ka, dtype), "ssm": ssm, "ln1": _rms(d),
                           "ln2": _rms(d), "attn_norm": _rms(d), "ssm_norm": _rms(d),
                           "gate_a": torch.ones(()), "gate_s": torch.ones(()),
                           "mlp": _mlp(cfg, kf, dtype)}, dev))
    return {"emb": _to((_normal(k_emb, (cfg.padded_vocab(), d)) * 0.02).to(dtype), dev),
            "layers": T._stack(layers), "ln_f": _to(_rms(d), dev)}


def _xlstm(cfg, root, dev, dtype) -> dict:
    """``xlstm.init``: a four-way root split (embedding, groups, unused,
    head); each group's key split two ways, the first into the group's
    mLSTM keys (each split five ways), the second the sLSTM's (three); the
    sLSTM bias f32 zeros."""
    from repro_torch.models.xlstm import _group_counts

    ng, nm = _group_counts(cfg)
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    s = 1.0 / d**0.5
    mat = lambda key, shape, scale: (_normal(key, shape) * scale).to(dtype)
    k_emb, k_groups, _, k_head = _split(root, 4)
    mlstm, slstm = [], []
    for kg in _split(k_groups, ng):
        k1, k2 = _split(kg, 2)
        blocks = []
        for km in _split(k1, nm):
            q, i, o, w, _ = _split(km, 5)
            blocks.append(_to({"ln": _rms(d), "w_qkv": mat(q, (d, 3 * d), s),
                               "w_if": mat(i, (d, 2 * h), s), "w_og": mat(o, (d, d), s),
                               "w_out": mat(w, (d, d), s), "hnorm": _rms(d)}, dev))
        mlstm.append(T._stack(blocks))
        w, r, o = _split(k2, 3)
        slstm.append(_to({"ln": _rms(d), "w": mat(w, (d, 4 * d), s),
                          "r": mat(r, (h, hd, 4 * hd), 1.0 / hd**0.5),
                          "b": torch.zeros(4 * d), "w_out": mat(o, (d, d), s),
                          "hnorm": _rms(d)}, dev))
    vp = cfg.padded_vocab()
    return {"emb": _to(mat(k_emb, (vp, d), 0.02), dev),
            "groups": {"mlstm": T._stack(mlstm), "slstm": T._stack(slstm)},
            "ln_f": _to(_rms(d), dev), "lm_head": _to(mat(k_head, (d, vp), 0.02), dev)}


def _encdec(cfg, root, dev, dtype) -> dict:
    """``encdec.init``: a four-way root split (embedding, encoder, decoder,
    decoder positions); encoder layers split two ways (attention, GELU
    MLP), decoder layers three (self, cross, MLP); LayerNorms 1 and 0."""
    k_emb, k_enc, k_dec, k_pos = _split(root, 4)
    d = cfg.d_model
    enc = []
    for kl in _split(k_enc, cfg.encoder_layers):
        ka, kf = _split(kl, 2)
        enc.append(_to({"attn": _attn(cfg, ka, dtype), "ln1": _layernorm(d),
                        "mlp": _mlp(cfg, kf, dtype), "ln2": _layernorm(d)}, dev))
    dec = []
    for kl in _split(k_dec, cfg.num_layers):
        ka, kx, kf = _split(kl, 3)
        dec.append(_to({"attn": _attn(cfg, ka, dtype), "cross": _attn(cfg, kx, dtype),
                        "ln1": _layernorm(d), "lnx": _layernorm(d), "ln2": _layernorm(d),
                        "mlp": _mlp(cfg, kf, dtype)}, dev))
    draw = lambda key, shape: _to((_normal(key, shape) * 0.02).to(dtype), dev)
    return {"emb": draw(k_emb, (cfg.padded_vocab(), d)),
            "pos_dec": draw(k_pos, (cfg.max_position_embeddings, d)),
            "enc_layers": T._stack(enc), "dec_layers": T._stack(dec),
            "ln_enc": _to(_layernorm(d), dev), "ln_f": _to(_layernorm(d), dev)}
