"""xLSTM (arXiv:2405.04517): mLSTM + sLSTM blocks at a 7:1 ratio — the port
of ``repro.models.xlstm``.

Attention-free: it reaches no kernel.  The prefill program is the
chunkwise-parallel mLSTM (the matrix-memory linear recurrence evaluated
block-parallel within chunks of 64, sequential across chunks) and the
sLSTM's sequential scan, one step a token (it has no parallel form); the
decode program is the O(1) recurrent update of both.  Plain torch on every
device, as the JAX package computes it outside Pallas, with its stabilizer
arithmetic unchanged: the ``-inf`` upper triangle, ``m = -1e30`` in a fresh
state, padded steps with input gate ``-1e30``, ``max(|den|, exp(-m))``.

Layers come in groups of ``slstm_every``: ``slstm_every - 1`` mLSTM blocks,
then one sLSTM block.  The states are grouped as in the JAX package
(``XLSTMCache``), and the steps update them in place.  The training pass
(``forward_hidden``, ``loss_fn``) runs the prefill's blocks from fresh
states, which it discards, each group under ``cfg.remat``; the head is the
untied ``lm_head``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.layers.norm import apply_norm
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.transformer import layer_params, remat, unbind_layers
from repro_torch.train.losses import chunked_ce_loss

STATE_INIT_M = -1e30
CHUNK = 64  # the mLSTM prefill's steps a chunk


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dk, dv) matrix memory
    n: torch.Tensor  # (B, H, dk) normalizer
    m: torch.Tensor  # (B, H) stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


class XLSTMCache(NamedTuple):
    """Grouped states: mlstm leaves (G, n_m, B, H, ...), slstm (G, B, H, hd)."""

    mlstm: MLSTMState
    slstm: SLSTMState


# ---------------------------------------------------------------- mLSTM ----


def _mlstm_chunk(q, k, v, it, ft, state: MLSTMState):
    """One chunk, batch-parallel.  q/k/v (B, H, c, hd) in the stream dtype,
    upcast here; it/ft (B, H, c) f32.  Returns (h (B, H, c, hd) f32, the
    state at the chunk's end)."""
    q, k, v = q.float(), k.float(), v.float()
    c = q.shape[2]
    f_cum = torch.cumsum(ft, dim=-1)  # F_t
    a = f_cum + state.m[..., None]  # (B, H, c) initial-state branch
    # D[t, s] = F_t - F_s + i_s for s <= t
    dmat = f_cum[..., :, None] - f_cum[..., None, :] + it[..., None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri, dmat, torch.full_like(dmat, float("-inf")))
    m_t = torch.maximum(a, dmat.amax(dim=-1))  # (B, H, c)
    init_w = torch.exp(a - m_t)
    inner_w = torch.exp(dmat - m_t[..., None])  # (B, H, c, c)
    qk = torch.einsum("bhtd,bhsd->bhts", q, k)
    wqk = inner_w * qk
    num = init_w[..., None] * torch.einsum("bhtd,bhdv->bhtv", q, state.c) + torch.einsum(
        "bhts,bhsv->bhtv", wqk, v)
    den = init_w * torch.einsum("bhtd,bhd->bht", q, state.n) + wqk.sum(dim=-1)
    h_out = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the state at the chunk's end
    f_tot = f_cum[..., -1]  # (B, H)
    m_new = torch.maximum(f_tot + state.m, (f_tot[..., None] - f_cum + it).amax(dim=-1))
    w_init = torch.exp(f_tot + state.m - m_new)
    w_s = torch.exp(f_tot[..., None] - f_cum + it - m_new[..., None])  # (B, H, c)
    c_new = w_init[..., None, None] * state.c + torch.einsum("bhsd,bhsv->bhdv", w_s[..., None] * k, v)
    n_new = w_init[..., None] * state.n + torch.einsum("bhs,bhsd->bhd", w_s, k)
    return h_out, MLSTMState(c_new, n_new, m_new)


def _mlstm_step(q, k, v, it, ft, state: MLSTMState):
    """The single-token recurrent update.  q/k/v (B, H, hd) in the stream
    dtype; it/ft (B, H) and the state f32.  The outer product k v^T is
    formed in the stream dtype, as the JAX package's promotion forms it,
    and everything after it in f32."""
    m_new = torch.maximum(ft + state.m, it)
    w_f = torch.exp(ft + state.m - m_new)[..., None]
    w_i = torch.exp(it - m_new)[..., None]
    kv = (k[..., :, None] * v[..., None, :]).float()
    q, k = q.float(), k.float()
    c_new = w_f[..., None] * state.c + w_i[..., None] * kv
    n_new = w_f * state.n + w_i * k
    num = torch.einsum("bhd,bhdv->bhv", q, c_new)
    den = (q * n_new).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, MLSTMState(c_new, n_new, m_new)


def _mlstm_project(p, x, cfg: ModelConfig):
    """The projections in the weight dtype (the (B, S, d) streams stay
    bf16 under bf16 weights); the (B, H, S) gate pre-activations in f32."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w_qkv"].dtype)
    q, k, v = (xn @ p["w_qkv"]).chunk(3, dim=-1)
    heads = lambda t: t.reshape(b, s, h, hd).transpose(1, 2)
    q, k, v = heads(q), heads(k / hd**0.5), heads(v)
    gates = (xn @ p["w_if"]).float()  # (B, S, 2H)
    it = gates[..., :h].transpose(1, 2)  # (B, H, S) input gate (exp)
    ft = F.logsigmoid(gates[..., h:]).transpose(1, 2)  # log f in (-inf, 0)
    og = torch.sigmoid((xn @ p["w_og"]).float()).to(xn.dtype)  # (B, S, d)
    return q, k, v, it, ft, og


def _mlstm_finish(p, x, h_seq, og, cfg: ModelConfig):
    """h_seq (B, H, S, hd) -> the block's residual output."""
    b, _, s, _ = h_seq.shape
    h_flat = h_seq.transpose(1, 2).reshape(b, s, cfg.d_model)
    h_flat = apply_norm(p["hnorm"], h_flat.to(x.dtype), "rmsnorm", cfg.norm_eps)
    out = (og.to(h_flat.dtype) * h_flat) @ p["w_out"]
    return x + out.to(x.dtype)


def mlstm_prefill(p, x, state: MLSTMState, cfg: ModelConfig):
    s = x.shape[1]
    q, k, v, it, ft, og = _mlstm_project(p, x, cfg)
    c = min(CHUNK, s)
    pad = (-s) % c
    if pad:  # padded steps: input gate -1e30 (no write), forget gate log 1 = 0
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        it = F.pad(it, (0, pad), value=-1e30)
        ft = F.pad(ft, (0, pad))
    hs = []
    for c0 in range(0, s + pad, c):
        sl = slice(c0, c0 + c)
        h_out, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl], it[..., sl],
                                    ft[..., sl], state)
        hs.append(h_out.to(x.dtype))  # the output stream in the activation dtype
    h_seq = torch.cat(hs, dim=2)[:, :, :s]
    return _mlstm_finish(p, x, h_seq, og, cfg), state


def mlstm_decode(p, x, state: MLSTMState, cfg: ModelConfig):
    q, k, v, it, ft, og = _mlstm_project(p, x, cfg)  # S = 1
    h, state = _mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], it[:, :, 0], ft[:, :, 0], state)
    return _mlstm_finish(p, x, h[:, :, None, :], og, cfg), state


# ---------------------------------------------------------------- sLSTM ----


def _slstm_step(p, wx_t, state: SLSTMState, cfg: ModelConfig) -> SLSTMState:
    """wx_t: the precomputed W x_t (B, 4d) f32; R h_{t-1} is added here."""
    b = wx_t.shape[0]
    h_, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    rh = torch.einsum("bhd,hde->bhe", state.h.float(), p["r"].float())
    pre = wx_t.reshape(b, h_, 4 * hd) + rh + p["b"].reshape(h_, 4 * hd)
    zt, it, ft, ot = pre.chunk(4, dim=-1)  # (B, H, hd) each
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    ft = F.logsigmoid(ft)
    m_new = torch.maximum(ft + state.m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + state.m - m_new)
    c_new = f_p * state.c + i_p * z
    n_new = f_p * state.n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new)


def slstm_forward(p, x, state: SLSTMState, cfg: ModelConfig):
    """Sequential over S, one ``_slstm_step`` a token (the sLSTM has no
    parallel form).  The (B, S, 4d) pre-activation stream and the stacked h
    outputs stay in the weight dtype; each step's gate and state math runs
    in f32."""
    b, s, d = x.shape
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w"].dtype)
    wx = xn @ p["w"]  # (B, S, 4d)
    hs = []
    for t in range(s):
        state = _slstm_step(p, wx[:, t].float(), state, cfg)
        hs.append(state.h.to(x.dtype))
    h_seq = torch.stack(hs, dim=1).reshape(b, s, d)
    h_seq = apply_norm(p["hnorm"], h_seq, "rmsnorm", cfg.norm_eps)
    out = h_seq @ p["w_out"].to(h_seq.dtype)
    return x + out.to(x.dtype), state


# ---------------------------------------------------------------- model ----


def _group_counts(cfg: ModelConfig) -> Tuple[int, int]:
    g = cfg.slstm_every
    if cfg.num_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not group by {g}")
    return cfg.num_layers // g, g - 1  # (n_groups, mLSTM blocks a group)


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX ``init``'s weights (``init_like_jax``), drawn on the target
    device: the matrices and the untied ``lm_head`` in ``dtype`` (bf16 by
    default), norms and the sLSTM bias f32."""
    dev = resolve_device(device)
    return init_like_jax(cfg, seed, dev, draw_device=dev, dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=torch.float32,
               device=None) -> XLSTMCache:
    """The fresh recurrent state (no KV at all; ``max_len`` is unused):
    zeros, stabilizers at -1e30."""
    dev = resolve_device(device)
    ng, nm = _group_counts(cfg)
    h = cfg.num_heads
    hd = cfg.d_model // h
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    m = MLSTMState(z(ng, nm, batch, h, hd, hd), z(ng, nm, batch, h, hd),
                   torch.full((ng, nm, batch, h), STATE_INIT_M, dtype=dtype, device=dev))
    s = SLSTMState(z(ng, batch, h, hd), z(ng, batch, h, hd), z(ng, batch, h, hd),
                   torch.full((ng, batch, h, hd), STATE_INIT_M, dtype=dtype, device=dev))
    return XLSTMCache(m, s)


def _put_state(dst: NamedTuple, idx, src: NamedTuple) -> None:
    for d, s in zip(dst, src):
        d[idx] = s


def _forward(params, tokens, cfg: ModelConfig, cache: XLSTMCache, *, decode: bool,
             last_only: bool = False):
    """The layer walk over tokens (B, S), the states in ``cache`` updated in
    place.  Returns (logits (B, S or 1, Vp), cache)."""
    x = params["emb"][tokens]
    ng, nm = _group_counts(cfg)
    groups = params["groups"]
    for g in range(ng):
        for j in range(nm):
            mp = layer_params(layer_params(groups["mlstm"], g), j)
            st = MLSTMState(*(t[g, j] for t in cache.mlstm))
            if decode:
                x, st = mlstm_decode(mp, x, st, cfg)
            else:
                x, st = mlstm_prefill(mp, x, st, cfg)
            _put_state(cache.mlstm, (g, j), st)
        sst = SLSTMState(*(t[g] for t in cache.slstm))
        x, sst = slstm_forward(layer_params(groups["slstm"], g), x, sst, cfg)
        _put_state(cache.slstm, g, sst)
    x = apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    return x.float() @ params["lm_head"].float(), cache


def _group_train(x, gp: dict, mstates, sstate: SLSTMState, cfg: ModelConfig):
    """One group of the training pass from the fresh states ``mstates``
    (one a block) and ``sstate``: its mLSTM blocks, then its sLSTM block."""
    for mp, st in zip(unbind_layers(gp["mlstm"]), mstates):
        x, _ = mlstm_prefill(mp, x, st, cfg)
    return slstm_forward(gp["slstm"], x, sstate, cfg)[0]


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final normed hidden state (B, S, d) of tokens (B, S) for the
    chunked loss, each group under ``cfg.remat``."""
    x = params["emb"][tokens]
    fresh = init_cache(cfg, tokens.shape[0], device=tokens.device)
    body = remat(_group_train, cfg.remat)
    for g, gp in enumerate(unbind_layers(params["groups"])):
        mstates = [MLSTMState(*(t[g, j] for t in fresh.mlstm))
                   for j in range(fresh.mlstm.c.shape[1])]
        x = body(x, gp, mstates, SLSTMState(*(t[g] for t in fresh.slstm)), cfg)
    return apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The full logits (B, S, Vp) f32 and a zero aux loss."""
    x = forward_hidden(params, tokens, cfg)
    return x.float() @ params["lm_head"].float(), torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.0):
    """The chunked loss over ``lm_head``: (nll, {"nll", "aux": 0})."""
    x = forward_hidden(params, batch["tokens"], cfg)
    loss = chunked_ce_loss(x, params["lm_head"], batch["targets"], batch["mask"])
    return loss, {"nll": loss, "aux": torch.zeros((), device=x.device)}


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The prefill program from a fresh state: tokens (B, S).  Returns
    (last-position logits (B, Vp), XLSTMCache)."""
    cache = init_cache(cfg, tokens.shape[0], device=tokens.device)
    logits, cache = _forward(params, tokens, cfg, cache, decode=False, last_only=True)
    return logits[:, -1, :], cache


def decode_step(params: dict, token: torch.Tensor, cache: XLSTMCache, lengths: torch.Tensor,
                cfg: ModelConfig):
    """One recurrent step for every sequence: token (B,); ``lengths`` is
    unused (the state carries the position).  Returns (logits (B, Vp),
    cache), the states updated in place."""
    logits, cache = _forward(params, token[:, None], cfg, cache, decode=True)
    return logits[:, 0, :], cache
