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

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import MeshInstall
from repro_torch.layers import collectives as C
from repro_torch.layers.linear import train_weight
from repro_torch.layers.norm import apply_norm
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx, cache_block
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.transformer import (
    _embed,
    _gather_rows,
    _train_top,
    batch_rows,
    check_mesh_model,
    layer_params,
    remat,
    unbind_layers,
    vocab_parallel_loss,
)

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


# ---- the training pass on a mesh: each model rank runs its H / tp heads,
# and the (B, S, d) streams after the heads hold its d / tp channels (the
# heads' own, head-major).  ``w_og``, ``w_out`` and the sLSTM's ``w`` and
# ``b`` align with the heads as the rules cut them; ``w_qkv`` (q | k | v),
# ``w_if`` (i | f) and the sLSTM's ``r`` (the gates inside each head) do
# not, and are gathered whole inside the step, each rank cutting its heads'
# columns (the summing reduce-scatter backward: the ranks' parts differ).


def _heads_of(pctx: PartitionCtx, h: int):
    """[lo, hi) of this model rank's heads of ``h``; all of them off a mesh."""
    if pctx.mesh is None:
        return 0, h
    per = h // pctx.tp_size
    lo = pctx.index(pctx.axes.tp) * per
    return lo, lo + per


def _cut(w: torch.Tensor, parts: int, lo: int, hi: int, n: int) -> torch.Tensor:
    """Columns [lo, hi) of each of the ``parts`` contiguous n-column parts
    of ``w`` (..., parts * n), side by side; ``w`` itself where that is all
    of it."""
    if hi - lo == n:
        return w
    return torch.cat([w[..., i * n + lo:i * n + hi] for i in range(parts)], dim=-1)


def _tp_in(x: torch.Tensor, pctx: PartitionCtx) -> torch.Tensor:
    """A whole stream into the ranks' own heads (``copy_to_tp``)."""
    return x if pctx.mesh is None else C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))


def _whole_cols(w: torch.Tensor, pctx: PartitionCtx, shape) -> torch.Tensor:
    """A (d, n) weight under the (data, model) rule, gathered whole on a
    mesh (each rank then cutting its own heads' columns)."""
    if pctx.mesh is None:
        return w
    return train_weight(w, pctx, shape, fsdp_dim=0, tp_dim=1, tp="sum")


def _own_cols(w: torch.Tensor, pctx: PartitionCtx, shape) -> torch.Tensor:
    """A (d, n) weight under the (data, model) rule whose columns align
    with the heads: this rank's columns, gathered over data."""
    return w if pctx.mesh is None else train_weight(w, pctx, shape, fsdp_dim=0)


def _row_out(y: torch.Tensor, w: torch.Tensor, pctx: PartitionCtx, shape) -> torch.Tensor:
    """``y @ w`` for a (d, d) weight under the (model, data) rule: on a mesh
    row-parallel over this rank's channels, the partial products summed
    (serving: in f32, rounded once to y's dtype, as the transformer's
    row-parallel linears; a group of one takes the plain product)."""
    if pctx.mesh is None:
        return y @ w.to(y.dtype)
    w = train_weight(w, pctx, shape, fsdp_dim=1)
    group = pctx.mesh.group(pctx.axes.tp)
    if pctx.fsdp_axis is None and not C._trivial(group):
        return C.all_reduce(y.float() @ w.float(), group).to(y.dtype)
    return C.reduce_from_tp(y @ w.to(y.dtype), group)


def _mean_square(xf: torch.Tensor, d: int, pctx: PartitionCtx) -> torch.Tensor:
    """The mean of squares over all d channels of a stream whose last dim
    holds this rank's d / tp of them: the ranks' partial sums summed
    (``sum_shared``: each rank normalizes its own channels with it)."""
    return C.sum_shared((xf * xf).sum(dim=-1, keepdim=True), pctx.mesh.group(pctx.axes.tp)) / d


def _head_norm(scale: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
               pctx: PartitionCtx) -> torch.Tensor:
    """``hnorm``, the RMSNorm over all of d across the heads, of x (B, S,
    d or this rank's d / tp channels).  On a mesh the statistic is summed
    over the model axis and the scale (whole on every rank) is cut to this
    rank's channels (``slice_replicated``: its gradient gathered back
    whole)."""
    if pctx.mesh is None or pctx.tp_size == 1:
        return apply_norm({"scale": scale}, x, "rmsnorm", cfg.norm_eps)
    xf = x.float()
    own = C.slice_replicated(scale, pctx.mesh.group(pctx.axes.tp), dim=-1)
    y = xf * torch.rsqrt(_mean_square(xf, cfg.d_model, pctx) + cfg.norm_eps) * own.float()
    return y.to(x.dtype)


def _mlstm_project(p, x, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """The projections in the weight dtype (the (B, S, d) streams stay
    bf16 under bf16 weights); the (B, H, S) gate pre-activations in f32.
    On a training mesh this rank's heads of q, k, v, i, f and its channels
    of the output gate."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, d // cfg.num_heads
    h0, h1 = _heads_of(pctx, h)
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w_qkv"].dtype)
    xt = _tp_in(xn, pctx)
    w_qkv = _cut(_whole_cols(p["w_qkv"], pctx, (d, 3 * d)), 3, h0 * hd, h1 * hd, d)
    q, k, v = (xt @ w_qkv).chunk(3, dim=-1)
    heads = lambda t: t.reshape(b, s, h1 - h0, hd).transpose(1, 2)
    q, k, v = heads(q), heads(k / hd**0.5), heads(v)
    w_if = _cut(_whole_cols(p["w_if"], pctx, (d, 2 * h)), 2, h0, h1, h)
    gates = (xt @ w_if).float()  # (B, S, 2H)
    it = gates[..., :h1 - h0].transpose(1, 2)  # (B, H, S) input gate (exp)
    ft = F.logsigmoid(gates[..., h1 - h0:]).transpose(1, 2)  # log f in (-inf, 0)
    og = torch.sigmoid((xt @ _own_cols(p["w_og"], pctx, (d, d))).float()).to(xn.dtype)  # (B, S, d)
    return q, k, v, it, ft, og


def _mlstm_finish(p, x, h_seq, og, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """h_seq (B, H, S, hd) -> the block's residual output."""
    b, _, s, _ = h_seq.shape
    h_flat = h_seq.transpose(1, 2).reshape(b, s, -1)
    h_flat = _head_norm(p["hnorm"]["scale"], h_flat.to(x.dtype), cfg, pctx)
    out = _row_out(og.to(h_flat.dtype) * h_flat, p["w_out"], pctx, (cfg.d_model, cfg.d_model))
    return x + out.to(x.dtype)


def mlstm_prefill(p, x, state: MLSTMState, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    s = x.shape[1]
    q, k, v, it, ft, og = _mlstm_project(p, x, cfg, pctx)
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
    return _mlstm_finish(p, x, h_seq, og, cfg, pctx), state


def _gather_cols(pctx: PartitionCtx, parts, wholes):
    """Column-parallel products' local outputs (..., n_i / tp) made whole
    (..., n_i) on every model rank, in one all-gather; a part whose weight
    the rules left whole (sanitized: ``n_i`` wide already) as it is."""
    if pctx.mesh is None or pctx.tp_size == 1:
        return list(parts)
    cut = [i for i, (t, n) in enumerate(zip(parts, wholes)) if t.shape[-1] != n]
    out = list(parts)
    if cut:
        every = C.all_gather(torch.cat([parts[i] for i in cut], dim=-1)[None],
                             pctx.mesh.group(pctx.axes.tp), dim=0)
        widths = [parts[i].shape[-1] for i in cut]
        for i, ranks in zip(cut, every.split(widths, dim=-1)):
            out[i] = torch.cat(ranks.unbind(0), dim=-1)
    return out


def _row_out_whole(y: torch.Tensor, w: torch.Tensor, pctx: PartitionCtx) -> torch.Tensor:
    """``y @ w`` for a (d, d) weight whose rows the serving rules split over
    the model axis, ``y`` (..., d) whole on every rank: this rank's slice
    of y against its rows (``_row_out``)."""
    if pctx.mesh is None or w.shape[0] == y.shape[-1]:
        return y @ w.to(y.dtype)
    return _row_out(pctx.axis_slice(y, -1, pctx.axes.tp), w, pctx, (y.shape[-1],) * 2)


def mlstm_decode(p, x, state: MLSTMState, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One token (x (B, 1, d)) through an mLSTM block, its state (every
    head) updated.  On a serving mesh (``pctx``, the decode rules) every
    model rank runs every head: the column-parallel projections' outputs
    are gathered (one all-gather), the step updates the whole state, which
    the decode rules keep whole on every model rank, and ``w_out`` is
    row-parallel.  Off a mesh (or on a model axis of one) the gather and
    the row split pass straight through."""
    b, d, nh = x.shape[0], cfg.d_model, cfg.num_heads
    hd = d // nh
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w_qkv"].dtype)
    qkv, gates, og = _gather_cols(pctx, [xn @ p[n] for n in ("w_qkv", "w_if", "w_og")],
                                  (3 * d, 2 * nh, d))
    q, k, v = qkv.chunk(3, dim=-1)
    heads = lambda t: t.reshape(b, nh, hd)  # noqa: E731  (S = 1)
    gates = gates.float()
    h, state = _mlstm_step(heads(q), heads(k / hd**0.5), heads(v), gates[:, 0, :nh],
                           F.logsigmoid(gates[:, 0, nh:]), state)
    og = torch.sigmoid(og.float()).to(xn.dtype)
    h_flat = apply_norm(p["hnorm"], h.reshape(b, 1, d).to(x.dtype), "rmsnorm", cfg.norm_eps)
    return x + _row_out_whole(og.to(h_flat.dtype) * h_flat, p["w_out"], pctx).to(x.dtype), state


# ---------------------------------------------------------------- sLSTM ----


def _slstm_step(p, wx_t, state: SLSTMState, cfg: ModelConfig,
                rh: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None
                ) -> SLSTMState:
    """wx_t: the precomputed W x_t (B, 4d) f32; R h_{t-1} is added here
    (``rh`` (B, H, 4hd) where the caller has it: a serving mesh's decode
    step gathers it).  ``p["r"]`` (H, hd, 4hd) and ``p["b"]`` (4d) hold the
    heads the step runs (on a training mesh this rank's, with wx_t's);
    ``bias`` takes b's place where given."""
    b = wx_t.shape[0]
    hd = cfg.d_model // cfg.num_heads
    h_ = wx_t.shape[1] // (4 * hd)
    if rh is None:
        rh = torch.einsum("bhd,hde->bhe", state.h.float(), p["r"].float())
    bias = p["b"] if bias is None else bias
    pre = wx_t.reshape(b, h_, 4 * hd) + rh + bias.reshape(h_, 4 * hd)
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


def _slstm_heads(p, cfg: ModelConfig, pctx: PartitionCtx) -> dict:
    """The sLSTM weights of this rank's heads on a training mesh: ``w``
    and ``b`` as the rules cut them (head-major, so they align), ``r``
    (H, hd, 4hd), whose rule cuts the gates inside each head, gathered
    whole over the model axis and cut to this rank's heads."""
    if pctx.mesh is None:
        return p
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    h0, h1 = _heads_of(pctx, h)
    r = train_weight(p["r"], pctx, (h, hd, 4 * hd), tp_dim=2, tp="sum")
    return {**p, "w": _own_cols(p["w"], pctx, (d, 4 * d)), "r": r[h0:h1]}


def slstm_decode(p, x, state: SLSTMState, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One token through an sLSTM block, its state (every head) updated.
    On a serving mesh (``pctx``, the decode rules) every model rank runs
    every head: W x (``w``'s columns: this rank's heads), R h (``r``'s
    columns inside each head) and the bias are this rank's columns,
    gathered whole in one all-gather; the step and ``hnorm`` run on the
    whole heads, ``w_out`` row-parallel.  Off a mesh the gather and the
    row split pass straight through."""
    b, d, nh = x.shape[0], cfg.d_model, cfg.num_heads
    hd = d // nh
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w"].dtype)
    rh = torch.einsum("bhd,hde->bhe", state.h.float(), p["r"].float())
    wx, rh, bias = _gather_cols(
        pctx, [(xn @ p["w"])[:, 0].float(), rh.reshape(b, -1),
               p["b"].float().expand(b, p["b"].shape[-1])], (4 * d, 4 * d, 4 * d))
    if p["r"].shape[-1] != 4 * hd:  # r's columns were cut inside each head: rank-major
        k = 4 * hd // p["r"].shape[-1]
        rh = rh.reshape(b, k, nh, 4 * hd // k).transpose(1, 2)
    state = _slstm_step(p, wx, state, cfg, rh=rh.reshape(b, nh, 4 * hd), bias=bias[0])
    h_seq = apply_norm(p["hnorm"], state.h.to(x.dtype).reshape(b, 1, d), "rmsnorm", cfg.norm_eps)
    return x + _row_out_whole(h_seq, p["w_out"], pctx).to(x.dtype), state


def slstm_forward(p, x, state: SLSTMState, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """Sequential over S, one ``_slstm_step`` a token (the sLSTM has no
    parallel form).  The (B, S, 4d) pre-activation stream and the stacked h
    outputs stay in the weight dtype; each step's gate and state math runs
    in f32.  On a training mesh each rank runs its heads (no collective a
    token: R is whole per head), ``hnorm``'s statistic summed over the
    model axis and ``w_out`` row-parallel."""
    b, s, d = x.shape
    p = _slstm_heads(p, cfg, pctx)
    xn = apply_norm(p["ln"], x, "rmsnorm", cfg.norm_eps).to(p["w"].dtype)
    wx = _tp_in(xn, pctx) @ p["w"]  # (B, S, 4d)
    hs = []
    for t in range(s):
        state = _slstm_step(p, wx[:, t].float(), state, cfg)
        hs.append(state.h.to(x.dtype))
    h_seq = torch.stack(hs, dim=1).reshape(b, s, -1)
    h_seq = _head_norm(p["hnorm"]["scale"], h_seq, cfg, pctx)
    out = _row_out(h_seq, p["w_out"], pctx, (d, d))
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
               device=None, heads: Optional[int] = None,
               pctx: PartitionCtx = NULL_CTX) -> XLSTMCache:
    """The fresh recurrent state (no KV at all; ``max_len`` is unused):
    zeros, stabilizers at -1e30; of ``heads`` heads (a training mesh
    rank's), all of them by default.  On a serving mesh (``pctx``, the
    decode rules) this rank's block of each leaf
    (``layers.sharding.cache_block``: its rows of the batch)."""
    dev = resolve_device(device)
    ng, nm = _group_counts(cfg)
    h = cfg.num_heads if heads is None else heads
    hd = cfg.d_model // cfg.num_heads

    def leaf(name, *shape, fill=0.0):
        return torch.full(cache_block(pctx, name, shape), fill, dtype=dtype, device=dev)

    m = MLSTMState(leaf("mlstm/c", ng, nm, batch, h, hd, hd), leaf("mlstm/n", ng, nm, batch, h, hd),
                   leaf("mlstm/m", ng, nm, batch, h, fill=STATE_INIT_M))
    s = SLSTMState(*(leaf(f"slstm/{n}", ng, batch, h, hd) for n in "cnh"),
                   leaf("slstm/m", ng, batch, h, hd, fill=STATE_INIT_M))
    return XLSTMCache(m, s)


def _put_state(dst: NamedTuple, idx, src: NamedTuple) -> None:
    for d, s in zip(dst, src):
        d[idx] = s


def _forward(params, tokens, cfg: ModelConfig, cache: XLSTMCache, *, decode: bool,
             last_only: bool = False, pctx: PartitionCtx = NULL_CTX):
    """The layer walk over tokens (B, S), the states in ``cache`` updated in
    place.  Returns (logits (B, S or 1, Vp), cache).  On a serving mesh
    (``pctx``) a prefill runs this rank's heads (the training pass's
    head-parallel blocks) from a cache of those heads, a decode step every
    head (``mlstm_decode``, ``slstm_decode``) on the whole state; the
    vocabulary columns of ``lm_head`` are gathered."""
    x = _embed(params["emb"], tokens, pctx)
    ng, nm = _group_counts(cfg)
    groups = params["groups"]
    for g in range(ng):
        for j in range(nm):
            mp = layer_params(layer_params(groups["mlstm"], g), j)
            st = MLSTMState(*(t[g, j] for t in cache.mlstm))
            if decode:
                x, st = mlstm_decode(mp, x, st, cfg, pctx)
            else:
                x, st = mlstm_prefill(mp, x, st, cfg, pctx)
            _put_state(cache.mlstm, (g, j), st)
        sp = layer_params(groups["slstm"], g)
        sst = SLSTMState(*(t[g] for t in cache.slstm))
        if decode:
            x, sst = slstm_decode(sp, x, sst, cfg, pctx)
        else:
            x, sst = slstm_forward(sp, x, sst, cfg, pctx)
        _put_state(cache.slstm, g, sst)
    x = apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    logits = x.float() @ params["lm_head"].float()
    if pctx.mesh is not None:
        logits = C.all_gather(logits, pctx.mesh.group(pctx.axes.tp), dim=-1)
    return logits, cache


def _group_train(x, gp: dict, mstates, sstate: SLSTMState, cfg: ModelConfig,
                 pctx: PartitionCtx = NULL_CTX):
    """One group of the training pass from the fresh states ``mstates``
    (one a block) and ``sstate``: its mLSTM blocks, then its sLSTM block."""
    for mp, st in zip(unbind_layers(gp["mlstm"]), mstates):
        x, _ = mlstm_prefill(mp, x, st, cfg, pctx)
    return slstm_forward(gp["slstm"], x, sstate, cfg, pctx)[0]


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   pctx: PartitionCtx = NULL_CTX, *, emb=None) -> torch.Tensor:
    """The final normed hidden state (B, S, d) of tokens (B, S) for the
    chunked loss, each group under ``cfg.remat``.  On a mesh (``pctx``,
    the train rules; ``tokens`` this data rank's rows) each model rank runs
    its H / tp heads from fresh states of its heads; ``emb`` is the
    gathered embedding shard (``_train_top``), where given."""
    check_mesh_model(cfg, pctx, train=True)
    if emb is None:
        emb = _train_top(params, cfg, pctx)[0]
    x = _embed(emb, tokens, pctx)
    h0, h1 = _heads_of(pctx, cfg.num_heads)
    fresh = init_cache(cfg, tokens.shape[0], device=tokens.device, heads=h1 - h0)
    body = remat(_group_train, cfg.remat)
    for g, gp in enumerate(unbind_layers(params["groups"])):
        mstates = [MLSTMState(*(t[g, j] for t in fresh.mlstm))
                   for j in range(fresh.mlstm.c.shape[1])]
        x = body(x, gp, mstates, SLSTMState(*(t[g] for t in fresh.slstm)), cfg, pctx)
    return apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The full logits (B, S, Vp) f32 and a zero aux loss."""
    x = forward_hidden(params, tokens, cfg)
    return x.float() @ params["lm_head"].float(), torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.0,
            pctx: PartitionCtx = NULL_CTX):
    """The chunked loss over ``lm_head``: (nll, {"nll", "aux": 0}).  On a
    mesh vocab-parallel over this rank's ``lm_head`` columns (``P(data,
    model)``, gathered over data)."""
    emb, head = _train_top(params, cfg, pctx)
    x = forward_hidden(params, batch["tokens"], cfg, pctx, emb=emb)
    loss = vocab_parallel_loss(x, head, batch, pctx)
    return loss, {"nll": loss, "aux": torch.zeros((), device=x.device)}


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    pctx: PartitionCtx = NULL_CTX):
    """The prefill program from a fresh state: tokens (B, S).  Returns
    (last-position logits (B, Vp), XLSTMCache).  On a serving mesh
    (``pctx``, the prefill rules) every rank takes the whole ``tokens``,
    runs its rows of the batch on its H / tp heads and returns the whole
    batch's logits and its rows' states of its heads."""
    check_mesh_model(cfg, pctx)
    b = tokens.shape[0]
    lo, hi = batch_rows(pctx, b)
    h0, h1 = _heads_of(pctx, cfg.num_heads)
    cache = init_cache(cfg, hi - lo, device=tokens.device, heads=h1 - h0)
    logits, cache = _forward(params, tokens[lo:hi], cfg, cache, decode=False, last_only=True,
                             pctx=pctx)
    return _gather_rows(logits[:, -1, :], pctx, b), cache


# the head dim of each state leaf: mLSTM (G, nm, B, H, ...), sLSTM (G, B, H, hd)
_HEAD_DIM = {"mlstm": 3, "slstm": 2}


def install_prefill(cache: XLSTMCache, prefilled: XLSTMCache, slots=None,
                    mesh: Optional[MeshInstall] = None) -> XLSTMCache:
    """The logic swap: each prompt's states into its slot of the decode
    cache (prompt i into ``slots[i]``, slot i by default), in place.  On a
    mesh (``mesh``) ``cache`` is this rank's block (its rows of the batch,
    every head: the decode rules) and ``prefilled`` its prefill's rows of
    its heads, gathered whole over the model axis (one all-gather a
    leaf); each prompt goes to the data rank whose rows hold its slot."""
    rows = (list(enumerate(range(prefilled.slstm.h.shape[1]) if slots is None else slots))
            if mesh is None else mesh.rows())
    for part, (dst_part, src_part) in zip(_HEAD_DIM, zip(cache, prefilled)):
        bdim = _HEAD_DIM[part] - 1
        for dst, src in zip(dst_part, src_part):
            if mesh is not None:
                src = mesh.state(src, _HEAD_DIM[part], dst.shape[_HEAD_DIM[part]])
            for i, slot in rows:
                dst.select(bdim, slot).copy_(src.select(bdim, i))
    return cache


def decode_step(params: dict, token: torch.Tensor, cache: XLSTMCache, lengths: torch.Tensor,
                cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One recurrent step for every sequence: token (B,); ``lengths`` is
    unused (the state carries the position).  Returns (logits (B, Vp),
    cache), the states updated in place.  On a serving mesh (``pctx``, the
    decode rules) ``token`` is the whole batch's and ``cache`` this rank's
    rows of it (every head); the logits are the whole batch's."""
    check_mesh_model(cfg, pctx)
    bg = token.shape[0]
    lo, hi = batch_rows(pctx, bg)
    logits, cache = _forward(params, token[lo:hi, None], cfg, cache, decode=True, pctx=pctx)
    return _gather_rows(logits[:, 0, :], pctx, bg), cache
