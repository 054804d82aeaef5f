"""Phase-specialized programs — the GPU analogue of the paper's
reconfigurable modules (contribution C1).

``PhaseEngine`` hands out, for one architecture, plain callables keyed as
the JAX package keys its compiled programs:

  * ``prefill_varlen:{B}x{S}``        — full prefill for a right-padded bucket
  * ``prefill_split_varlen:{B}x{S}``  — prefill through the LAST layer's attention
    (``...:tail`` — last FFN + norm + logits, run during the swap)
  * ``relayout:{B}x{S}->{max_len}``   — the swap itself: prefill-layout KV
    into the decode cache (layout move + cast or quantization + padding)
  * ``page_write:{S}@{bs}``           — the paged swap: prefill-layout KV
    into the prompt's pages (quantized on write under int8/int4)
  * ``decode:{B}x{max_len}``          — the KV-streaming decode step
  * ``decode_paged:{B}x{P}``          — the same over the paged pool
  * ``prefill_chunk:{C}+{W}@{B}x{max_len}`` — one C-token prompt chunk over a
    W-wide prefix, installed into the decode cache (chunked prefill)
  * ``prefill_chunk_paged:{C}+{W}@{P}x{bs}`` — the same into the prompt's pages
  * ``sampler:{B}``                   — the per-slot token sampler

Weights are never touched by the swap: both phases use the same tensors.
The port runs the callables eagerly; capturing them as CUDA graphs is
later work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import insert_prefill_kv
from repro_torch.core.sampling import sample_tokens
from repro_torch.layers.attention import KVCache, write_prefill_pages_q
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import assert_kv_dtype


@dataclasses.dataclass
class PhaseProgram:
    name: str
    fn: Callable


class PhaseEngine:
    """Builds and caches the phase programs for one architecture."""

    def __init__(self, cfg: ModelConfig, *, cache_layout: str = "contiguous",
                 kv_dtype: str = "fp"):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout must be 'contiguous' or 'paged', got {cache_layout!r}")
        assert_kv_dtype(kv_dtype)
        self.cfg = cfg
        self._programs: Dict[str, PhaseProgram] = {}

    def _program(self, key: str, fn: Callable) -> PhaseProgram:
        if key not in self._programs:
            self._programs[key] = PhaseProgram(key, fn)
        return self._programs[key]

    def prefill_program_varlen(self, batch: int, seq: int) -> PhaseProgram:
        """``fn(params, tokens, last_pos) -> (logits, kv)`` for right-padded
        prompts at bucket length ``seq``."""
        cfg = self.cfg

        def fn(params, tokens, last_pos):
            return T.forward_prefill(params, tokens, cfg, last_pos=last_pos)

        return self._program(f"prefill_varlen:{batch}x{seq}", fn)

    def prefill_split_programs_varlen(self, batch: int, seq: int) -> Tuple[PhaseProgram, PhaseProgram]:
        """(body, tail): the overlap split, the tail taking ``last_pos``."""
        cfg = self.cfg
        key = f"prefill_split_varlen:{batch}x{seq}"

        def body_fn(params, tokens):
            return T.forward_prefill(params, tokens, cfg, split_tail=True)

        def tail_fn(params, x_mid, last_pos):
            return T.prefill_tail(params, x_mid, cfg, last_pos=last_pos)

        return self._program(key, body_fn), self._program(key + ":tail", tail_fn)

    def prefill_split_programs(self, batch: int, seq: int) -> Tuple[PhaseProgram, PhaseProgram]:
        """(body, tail): the overlap split at the last layer's attention."""
        cfg = self.cfg

        def body_fn(params, tokens):
            return T.forward_prefill(params, tokens, cfg, split_tail=True)

        def tail_fn(params, x_mid):
            return T.prefill_tail(params, x_mid, cfg)

        return (self._program(f"prefill_body:{batch}x{seq}", body_fn),
                self._program(f"prefill_tail:{batch}x{seq}", tail_fn))

    def relayout_program(self, batch: int, seq: int, max_len: int) -> PhaseProgram:
        """The swap: ``fn(kv, cache, slot)`` moves one prompt's prefill-layout
        KV (L, 1, Hkv, seq, D) into slot ``slot`` of the batch-leading decode
        cache in place — layer-major to batch-leading, cast to the cache
        dtype or quantized from f32, rows [seq, max_len) padded — and
        returns the cache."""
        if batch != 1:
            raise NotImplementedError("the relayout installs one prompt at a time")

        def fn(kv, cache, slot):
            return insert_prefill_kv(cache, kv, slot)

        return self._program(f"relayout:{batch}x{seq}->{max_len}", fn)

    def decode_program(self, batch: int, max_len: int) -> PhaseProgram:
        """``fn(params, token, cache, lengths) -> (logits, cache)``; the cache
        is updated in place (the JAX program donates it)."""
        cfg = self.cfg

        def fn(params, token, cache, lengths):
            return T.decode_step(params, token, cache, lengths, cfg)

        return self._program(f"decode:{batch}x{max_len}", fn)

    def paged_decode_program(self, n_slots: int, max_pages: int) -> PhaseProgram:
        """``fn(params, token, pages, block_tables, lengths) -> (logits,
        pages)``; the pool is updated in place."""
        cfg = self.cfg

        def fn(params, token, pages, block_tables, lengths):
            return T.decode_step_paged(params, token, pages, block_tables, lengths, cfg)

        return self._program(f"decode_paged:{n_slots}x{max_pages}", fn)

    def page_write_program(self, seq: int, block_size: int) -> PhaseProgram:
        """The paged swap: ``fn(pages, kv, page_ids)`` scatters prefill-layout
        KV (L, 1, Hkv, seq, D) into the pages ``page_ids`` (ids >= N skipped)
        in place, quantizing on write under int8/int4, and returns the pool."""

        def fn(pages, kv, page_ids):
            return KVCache(write_prefill_pages_q(pages.k, kv.k, page_ids, block_size=block_size),
                           write_prefill_pages_q(pages.v, kv.v, page_ids, block_size=block_size))

        return self._program(f"page_write:{seq}@{block_size}", fn)

    def prefill_chunk_program(self, chunk: int, n_slots: int, max_len: int,
                              prefix_width: int) -> PhaseProgram:
        """Chunked prefill against the contiguous cache: ``fn(params, tokens
        (1, C), cache, prefix, slot, prefix_len, last_pos) -> (logits, cache,
        prefix)``, cache and f32 prefix mirror updated in place.  The install
        is part of the program: the fabric can flip back to decode after
        every chunk."""
        cfg = self.cfg

        def fn(params, tokens, cache, prefix, slot, prefix_len, last_pos):
            return T.prefill_chunk(params, tokens, cache, prefix, slot, prefix_len, last_pos, cfg,
                                   prefix_width=prefix_width)

        return self._program(f"prefill_chunk:{chunk}+{prefix_width}@{n_slots}x{max_len}", fn)

    def paged_prefill_chunk_program(self, chunk: int, max_pages: int, block_size: int,
                                    prefix_width: int) -> PhaseProgram:
        """Chunked prefill against the paged pool: ``fn(params, tokens (1, C),
        pages, prefix, page_ids (C/bs,), prefix_len, last_pos) -> (logits,
        pages, prefix)``; C must be whole pages."""
        if chunk % block_size:
            raise ValueError(f"a chunk of {chunk} tokens is not whole pages of {block_size}")
        cfg = self.cfg

        def fn(params, tokens, pages, prefix, page_ids, prefix_len, last_pos):
            return T.prefill_chunk_paged(params, tokens, pages, prefix, page_ids, prefix_len,
                                         last_pos, cfg, prefix_width=prefix_width)

        return self._program(f"prefill_chunk_paged:{chunk}+{prefix_width}@{max_pages}x{block_size}",
                             fn)

    def sampler_program(self, batch: int) -> PhaseProgram:
        """The per-slot sampler, the decode epilogue: ``fn(logits, seeds,
        steps, temps, top_ks, top_ps) -> tokens`` on the logits' device; slot
        i draws with ``fold_in(PRNGKey(seeds[i]), steps[i])``."""
        return self._program(f"sampler:{batch}", sample_tokens)
