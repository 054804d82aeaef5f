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

CHUNK = 128  # prefill steps a chunk: the scan's working set is (B, CHUNK, d_in, N)


def _ssm_inputs(p, x, cfg: ModelConfig, conv_state: Optional[torch.Tensor] = None):
    """x (B, S, d) -> (xc, z, dt, b_mat, c_mat, new_conv_state), all f32;
    the conv state is the last ``ssm_conv - 1`` inputs of the depthwise
    causal conv, for streaming decode."""
    s = x.shape[1]
    xz = x.float() @ p["w_in"].float()
    x_in, z = xz.chunk(2, dim=-1)  # (B, S, d_in)
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
    dt = F.softplus(xc @ p["w_dt"].float() + p["dt_bias"])  # (B, S, d_in)
    dt = dt.expand(xc.shape)
    b_mat, c_mat = (xc @ p["w_bc"].float()).chunk(2, dim=-1)  # (B, S, N)
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
                conv_state: Optional[torch.Tensor] = None):
    """Returns (y (B, S, d) in x's dtype, (h_last (B, d_in, N) f32, conv
    state (B, ssm_conv - 1, d_in) f32))."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    xc, z, dt, b_mat, c_mat, conv_state = _ssm_inputs(p, x, cfg, conv_state)
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
    out = y @ p["w_out"].float()
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
