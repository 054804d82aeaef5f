"""Vectorized token sampling on the engine's device — the decode epilogue.

The port of the JAX package's ``repro.core.sampling``, held to it token for
token: token ``i`` of a request is drawn with ``fold_in(PRNGKey(seed), i)``
of JAX's default threefry-2x32 generator, whose keys and random bits this
module reproduces bit for bit.  The key stream is a pure function of
``(seed, token index)`` — there is no generator object and no state on the
host — so a preempted request that re-prefills and teacher-forces its
recorded tokens draws its next token with exactly the key it would have used
had it never been evicted.

Everything is tensor in, tensor out, on the caller's device, with no host
sync.  The 32-bit words live in int64 tensors masked to 32 bits: PyTorch's
``uint32`` lacks shifts and adds on some backends.  The Gumbel noise uses
``torch.log``, which may differ from XLA's ``log`` by an ulp, so a draw can
differ from JAX's only where the top two perturbed scores lie within a few
ulp of each other.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]  # the two 32-bit words, int64 tensors


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> Key:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as JAX runs it)
    on broadcastable int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of non-negative int32 seeds: the words (0, seed)."""
    seeds = seeds.long() & MASK32
    return torch.zeros_like(seeds), seeds


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in``: threefry of the counter (0, data) under ``key``."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(k0), data.long() & MASK32)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for a batch of keys (B,) -> (B, n) int64:
    the two words of threefry over the counters (0, i), XORed (JAX's
    partitionable threefry, its default)."""
    k0, k1 = key[0][:, None], key[1][:, None]
    counts = torch.arange(n, device=k0.device, dtype=torch.int64)[None, :]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform`` on [tiny, 1) in f32 from 32 random bits: the
    top 23 bits as the mantissa of a float in [1, 2), minus one."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * (1.0 - _F32_TINY) + _F32_TINY, _F32_TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") from 32 random bits."""
    return -torch.log(-torch.log(uniform(bits)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of (B, V) logits with one key a row: the
    argmax of logits + Gumbel noise, the first index on ties."""
    return torch.argmax(logits + gumbel(random_bits(key, logits.shape[-1])), dim=-1)


def filter_logits(logits, temps, top_ks, top_ps) -> torch.Tensor:
    """Scale by temperature and truncate: (B, V) logits -> (B, V) f32 with
    -inf outside each row's top-k ∩ nucleus support.  The nucleus keeps
    position i of the sorted row iff the mass before it is < top_p; the top
    token always survives."""
    scaled = logits.float() / torch.clamp_min(temps, 1e-6)[:, None]
    vocab = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, torch.clamp_max(top_ks, vocab), vocab).long()
    kth = desc.gather(1, (k_eff - 1)[:, None])
    e = torch.exp(desc - desc[:, :1])  # jax.nn.softmax: exp(x - max) / sum
    probs = e / e.sum(dim=-1, keepdim=True)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    n_keep = torch.clamp_min((mass_before < top_ps[:, None]).sum(dim=-1), 1)
    pth = desc.gather(1, (n_keep - 1)[:, None])
    cut = torch.maximum(kth, pth)
    return torch.where(scaled >= cut, scaled, torch.full_like(scaled, float("-inf")))


def sample_tokens(logits, seeds, steps, temps, top_ks, top_ps) -> torch.Tensor:
    """One token per row, (B,) int32.  ``logits`` (B, V); ``seeds`` (B,)
    int32 (``SamplingParams.seed32``); ``steps`` (B,) the index of the token
    being drawn, the fold_in counter; ``temps``/``top_ks``/``top_ps`` (B,)
    per-row knobs, ``temp <= 0`` taking the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    masked = filter_logits(logits, temps, top_ks, top_ps)
    sampled = categorical(fold_in(prng_key(seeds), steps), masked)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


def sample_block_tokens(logits, seeds, step0s, temps, top_ks, top_ps) -> torch.Tensor:
    """Targets for every position of a speculative verify block: ``logits``
    (B, W, V) -> (B, W) int32, position i of row b drawn with
    ``fold_in(PRNGKey(seeds[b]), step0s[b] + i)`` — the keys sequential
    decode would use."""
    b, w, v = logits.shape
    offs = torch.arange(w, device=logits.device, dtype=step0s.dtype)
    rep = lambda t: t[:, None].expand(b, w).reshape(-1)  # noqa: E731
    steps = (step0s[:, None] + offs[None, :]).reshape(-1)
    return sample_tokens(logits.reshape(b * w, v), rep(seeds), steps, rep(temps), rep(top_ks),
                         rep(top_ps)).reshape(b, w)


def accept_length(draft: Sequence[int], targets: Sequence[int]) -> int:
    """The speculative accept rule: the length of the longest draft prefix
    the verify targets confirm."""
    a = 0
    for d, t in zip(draft, targets):
        if int(d) != int(t):
            break
        a += 1
    return a
