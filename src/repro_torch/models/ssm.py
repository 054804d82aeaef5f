"""Selective SSM (Mamba-style) branch of hymba's parallel heads: the port of
``repro.models.ssm``.

Prefill: the linear recurrence ``h_t = a_t h_{t-1} + u_t`` over chunks of
128 steps, with the carry passed from chunk to chunk.  Within a chunk it is
a log-step (Hillis-Steele) scan in f32: seven doubling passes for 128
steps, each combining a step with the one ``2^i`` before it, the JAX
package's ``associative_scan`` combine.  The two round apart (another tree
of the same products), so they agree to f32 rounding.  Decode: the O(1)
state update.  Plain torch on every device, as the JAX package computes it
outside Pallas.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import collectives as C
from repro_torch.layers.linear import train_weight
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx

CHUNK = 128  # prefill steps a chunk: the scan's working set is (B, CHUNK, d_in, N)


def _in_proj(p, x, cfg: ModelConfig, pctx: PartitionCtx):
    """(x_in, z) (B, S, d_in) f32.  On a training mesh each model rank
    takes its d_in / tp channels of both: the rule cuts ``w_in``'s columns
    x | z contiguously (at tp 2 one rank holds all of x, the other all of
    z), so the weight is gathered whole over data and model and this
    rank's channels of each half are cut from it; each rank uses its own,
    so the gather's backward is the summing reduce-scatter."""
    if pctx.mesh is None:
        return (x.float() @ p["w_in"].float()).chunk(2, dim=-1)
    d_in = cfg.d_model
    w = train_weight(p["w_in"], pctx, (cfg.d_model, 2 * d_in), fsdp_dim=0, tp_dim=1, tp="sum")
    if pctx.tp_size > 1:
        lo, hi = _channels(cfg, pctx)
        w = torch.cat([w[:, lo:hi], w[:, d_in + lo:d_in + hi]], dim=1)
    x = C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))
    return (x.float() @ w.float()).chunk(2, dim=-1)


def _channels(cfg: ModelConfig, pctx: PartitionCtx):
    """[lo, hi) of this model rank's SSM channels."""
    per = cfg.d_model // pctx.tp_size
    lo = pctx.index(pctx.axes.tp) * per
    return lo, lo + per


def _channel_sum(partial: torch.Tensor, pctx: PartitionCtx) -> torch.Tensor:
    """A contraction over the SSM's channels, from this rank's partial
    product over its own: summed over the model axis, and each rank uses
    the sum for its own channels (``sum_shared``)."""
    if pctx.mesh is None:
        return partial
    return C.sum_shared(partial, pctx.mesh.group(pctx.axes.tp))


def _dt_in(xc: torch.Tensor, w_dt: torch.Tensor, pctx: PartitionCtx) -> torch.Tensor:
    """``xc @ w_dt`` (B, S, 1) over every channel."""
    return _channel_sum(xc @ w_dt.float(), pctx)


def _bc(xc: torch.Tensor, w_bc: torch.Tensor, pctx: PartitionCtx) -> torch.Tensor:
    """``xc @ w_bc`` (B, S, 2N) over every channel: B and C."""
    return _channel_sum(xc @ w_bc.float(), pctx)


def _out_proj(p, y: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx) -> torch.Tensor:
    """``y @ w_out`` (B, S, d) f32: on a training mesh row-parallel over
    this rank's channels (``w_out`` gathered over data), the ranks' partial
    products summed."""
    if pctx.mesh is None:
        return y @ p["w_out"].float()
    w = train_weight(p["w_out"], pctx, (cfg.d_model, cfg.d_model), fsdp_dim=1)
    return C.reduce_from_tp(y @ w.float(), pctx.mesh.group(pctx.axes.tp))


def _ssm_inputs(p, x, cfg: ModelConfig, conv_state: Optional[torch.Tensor] = None,
                pctx: PartitionCtx = NULL_CTX):
    """x (B, S, d) -> (xc, z, dt, b_mat, c_mat, new_conv_state), all f32;
    the conv state is the last ``ssm_conv - 1`` inputs of the depthwise
    causal conv, for streaming decode.  On a training mesh (``pctx``) the
    d_in tensors hold this rank's channels, as the rules cut ``conv``,
    ``a_log``, ``dt_bias``, ``d_skip`` and the rows of ``w_bc``, ``w_dt``
    and ``w_out``; the contractions over the channels are summed."""
    s = x.shape[1]
    x_in, z = _in_proj(p, x, cfg, pctx)  # (B, S, d_in)
    w = cfg.ssm_conv
    if conv_state is None:
        ctx = F.pad(x_in, (0, 0, w - 1, 0))
    else:
        ctx = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    conv = p["conv"].float()
    # depthwise causal conv via stacked shifts (w is tiny: 4), in the JAX order
    xc = sum(ctx[:, i:i + s, :] * conv[i] for i in range(w))
    new_conv_state = ctx[:, -(w - 1):, :] if w > 1 else None
    xc = F.silu(xc)
    dt = F.softplus(_dt_in(xc, p["w_dt"], pctx) + p["dt_bias"])  # (B, S, d_in)
    dt = dt.expand(xc.shape)
    b_mat, c_mat = _bc(xc, p["w_bc"], pctx).chunk(2, dim=-1)  # (B, S, N)
    return xc, z, dt, b_mat, c_mat, new_conv_state


def _scan_chunk(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + u_t`` along dim 1 (from h 0):
    returns (A_t, U_t) with h_t = A_t h_{-1} + U_t, by log-step doubling."""
    c = a.shape[1]
    off = 1
    while off < c:
        a_prev, u_prev = a[:, :-off], u[:, :-off]
        u = torch.cat([u[:, :off], a[:, off:] * u_prev + u[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a_prev * a[:, off:]], dim=1)
        off *= 2
    return a, u


def ssm_prefill(p, x, cfg: ModelConfig, h0: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None, pctx: PartitionCtx = NULL_CTX):
    """Returns (y (B, S, d) in x's dtype, (h_last (B, d_in, N) f32, conv
    state (B, ssm_conv - 1, d_in) f32)).  On a training mesh (``pctx``)
    channel-parallel: the states are this rank's channels, y is whole."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    xc, z, dt, b_mat, c_mat, conv_state = _ssm_inputs(p, x, cfg, conv_state, pctx)
    a_cont = -torch.exp(p["a_log"].float())  # (d_in, N)
    h = torch.zeros((b, xc.shape[-1], n), device=x.device) if h0 is None else h0.float()
    c = min(CHUNK, s)
    pad = (-s) % c
    if pad:  # padded steps have dt 0: a = 1, u = 0, so they carry h unchanged
        xc_p, dt_p, b_p, c_p = (F.pad(t, (0, 0, 0, pad)) for t in (xc, dt, b_mat, c_mat))
    else:
        xc_p, dt_p, b_p, c_p = xc, dt, b_mat, c_mat
    ys = []
    for c0 in range(0, s + pad, c):
        xci, dti, bi, ci = (t[:, c0:c0 + c] for t in (xc_p, dt_p, b_p, c_p))
        a = torch.exp(dti[..., None] * a_cont)  # (B, c, d_in, N)
        u = (dti * xci)[..., None] * bi[:, :, None, :]
        a_s, u_s = _scan_chunk(a, u)
        h_all = a_s * h[:, None] + u_s
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, ci))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + p["d_skip"] * xc
    y = y * F.silu(z)
    out = _out_proj(p, y, cfg, pctx)
    return out.to(x.dtype), (h, conv_state)


def ssm_decode(p, x, cfg: ModelConfig, h_prev: torch.Tensor, conv_state: torch.Tensor):
    """x (B, 1, d); h_prev (B, d_in, N); conv_state (B, ssm_conv - 1, d_in).
    Returns (y (B, 1, d), (h_new, conv_state))."""
    xc, z, dt, b_mat, c_mat, conv_state = _ssm_inputs(p, x, cfg, conv_state)
    a_cont = -torch.exp(p["a_log"].float())
    a = torch.exp(dt[:, 0, :, None] * a_cont)  # (B, d_in, N)
    u = (dt[:, 0] * xc[:, 0])[..., None] * b_mat[:, 0, None, :]
    h_new = a * h_prev + u
    y = torch.einsum("bdn,bn->bd", h_new, c_mat[:, 0])[:, None, :]
    y = y + p["d_skip"] * xc
    y = y * F.silu(z)
    out = y @ p["w_out"].float()
    return out.to(x.dtype), (h_new, conv_state)
