"""Cross-entropy without materializing (B, S, V) logits: the port of
``repro.train.losses``.

The loss walks the sequence in chunks; each chunk's (B, chunk, Vp) f32
logits live only inside a ``torch.utils.checkpoint`` (recomputed in
backward), so the live set is one chunk's logits, as under the JAX
package's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.layers import collectives as C
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx


def _chunk_nll(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor, tp=None) -> torch.Tensor:
    """sum((logsumexp - target logit) * mask) over one chunk, in f32.  The
    logsumexp runs over every column of the padded vocab, as in the JAX
    package (the pad columns are not masked).  ``head`` may be this rank's
    vocabulary columns, the ranks of ``tp`` holding the others: the chunk's
    logits are then gathered whole (``gather_replicated``), so every rank
    sums them in the single device's order."""
    logits = xc.float() @ head.float()  # (B, chunk, Vp); TF32 is off (see repro_torch)
    if tp is not None:
        logits = C.gather_replicated(logits, tp, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tc.long()[..., None])[..., 0]
    return ((lse - tgt) * mc).sum()


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, chunk: int = 256,
                    pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """x (B, S, d) final hidden states, head (d, Vp), targets (B, S) int,
    mask (B, S) -> the masked mean negative log-likelihood, f32.  S is padded
    to a multiple of ``chunk`` (pad rows masked out); the chunks' sums are
    added in order, then divided by max(sum(mask), 1).

    On a mesh (``pctx``) ``head`` is this rank's (d, Vp/tp) vocabulary
    columns, and the rows are this data rank's: the sum is divided by the
    mask summed over the batch axis, so the ranks' losses add up to the
    global mean.  Of the two ways to take a loss over vocabulary shards,
    this one gathers each chunk's logits whole rather than reducing the
    logsumexp by MAX and SUM over the model axis: every rank then sums in
    the single device's order, which the tests hold to JAX, and the live
    set stays one chunk's logits (now whole, (B/dp, chunk, Vp))."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    tp = dp = None
    if pctx.mesh is not None:
        tp = pctx.mesh.group(pctx.axes.tp) if pctx.tp_size > 1 else None
        dp = pctx.mesh.group(pctx.axes.dp) if pctx.size(pctx.axes.dp) > 1 else None
    grad = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s + pad, chunk):
        args = (x[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk], mask[:, c0:c0 + chunk], tp)
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
                         else _chunk_nll(*args))
    count = mask.sum()
    if dp is not None:
        count = C.all_reduce(count, dp)
    return total / torch.clamp(count, min=1)
