"""Prompt-lookup (n-gram) drafting for self-speculative decoding.

Decode streams the whole KV cache and weight set for one token a slot.
Speculative decoding drafts ``k`` cheap candidate tokens and scores all
``k + 1`` positions in one verify pass, so the stream is paid once a round
and every accepted draft token rides on bandwidth the round already spent.

The drafter is self-speculative prompt lookup, with no draft model: match
the sequence's own trailing n-gram against its prompt and generated
history and propose the tokens that followed the match.  It is host-side
numpy (no device work, no extra weights), and it pays where the context
repeats itself: summarization, code edits, retrieval over the prompt.

The drafter only proposes; the verify pass decides acceptance against the
slot's own ``SamplingParams`` (``repro_torch.core.sampling``), so a bad
draft costs a wasted verify column, never a wrong token.  The port of the
JAX package's ``repro.serving.spec_decode``.
"""
from __future__ import annotations

import numpy as np


def find_draft(context: np.ndarray, max_k: int, ngram: int) -> np.ndarray:
    """Propose up to ``max_k`` draft tokens by prompt lookup.

    Tries n-gram sizes from ``ngram`` down to 1: for each size, the
    context's trailing n-gram is matched against every earlier position.
    Among the matches, prefer the most recent one whose continuation can
    supply a full ``max_k`` tokens; with no full continuation available,
    fall back to the most recent match (recency tracks the local pattern
    best: a period-p loop's rightmost match predicts the next period).

    Returns an int32 array of length in ``[0, max_k]``, empty when the
    trailing n-gram never occurred before (the engine then runs the slot as
    plain decode: one real verify column, no drafts).

    Deterministic and a pure function of ``(context, max_k, ngram)``, so a
    preemption restart that replays the same history derives the same
    drafts: speculation adds no scheduler state that replay would have to
    keep.
    """
    context = np.asarray(context, np.int32)
    n = len(context)
    if max_k <= 0 or n < 2:
        return np.zeros((0,), np.int32)
    for size in range(min(ngram, n - 1), 0, -1):
        suffix = context[n - size:]
        # candidate starts 0 .. n-1-size: the match must end before the last
        # position, so that at least one continuation token exists
        windows = np.lib.stride_tricks.sliding_window_view(context[: n - 1], size)
        starts = np.flatnonzero((windows == suffix[None, :]).all(axis=1))
        if len(starts) == 0:
            continue
        full = starts[starts + size + max_k <= n]
        start = int(full[-1]) if len(full) else int(starts[-1])
        return context[start + size: start + size + max_k].astype(np.int32)
    return np.zeros((0,), np.int32)
