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


def _chunk_nll(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor) -> torch.Tensor:
    """sum((logsumexp - target logit) * mask) over one chunk, in f32.  The
    logsumexp runs over every column of the padded vocab, as in the JAX
    package (the pad columns are not masked)."""
    logits = xc.float() @ head.float()  # (B, chunk, Vp); TF32 is off (see repro_torch)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tc.long()[..., None])[..., 0]
    return ((lse - tgt) * mc).sum()


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x (B, S, d) final hidden states, head (d, Vp), targets (B, S) int,
    mask (B, S) -> the masked mean negative log-likelihood, f32.  S is padded
    to a multiple of ``chunk`` (pad rows masked out); the chunks' sums are
    added in order, then divided by max(sum(mask), 1)."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    grad = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s + pad, chunk):
        args = (x[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
                         else _chunk_nll(*args))
    return total / torch.clamp(mask.sum(), min=1)
