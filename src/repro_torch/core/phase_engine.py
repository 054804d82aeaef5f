"""Phase-specialized programs — the GPU analogue of the paper's
reconfigurable modules (contribution C1).

``PhaseEngine`` hands out, for one architecture, the phase programs keyed
as the JAX package keys its compiled programs:

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
  * ``prefill_chunk_kv:{C}+{W}``      — the chunk with no install, its f32 KV
    returned (the disaggregated prefill pool's chunk program)
  * ``chunk_write:{C}``               — the decode pool's install of such a
    chunk into the contiguous cache (quantized on write)
  * ``relay:{S}->{max_len}``          — the prefill pool's half of the
    contiguous swap: one prompt's KV as a decode-layout segment
  * ``sampler:{B}``                   — the per-slot token sampler
  * ``verify:{B}x{W}@{max_len}``      — speculative decoding's verify pass: a
    W = k + 1 token block a slot against the decode cache
  * ``verify_paged:{B}x{W}@{P}``      — the same over the paged pool
  * ``block_sampler:{B}x{W}``         — the verify targets' sampler

Weights are never touched by the swap: both phases use the same tensors.

Where the JAX package compiles a program into one executable at its first
call, the port captures the decode, verify, chunk and sampler programs as one CUDA
graph each (``PhaseProgram``): on a card the first call runs the program
eagerly (the warm-up: it builds the kernels and makes their one-time
settings) and then captures it on a side stream into a memory pool shared
by the engine's graphs; every later call copies its varying inputs into the
graph's static ones and replays it.  What a graph returns lies outside the
shared pool (the pool holds scratch only), so the graphs may replay in any
order.  The monolithic prefill programs (one
shape a bucket, compute-bound at long prompts) run eagerly.  On the CPU
every program runs eagerly.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import insert_prefill_kv, relay_prefill_kv
from repro_torch.core.sampling import sample_block_tokens, sample_tokens
from repro_torch.kernels import COUNTS
from repro_torch.layers.attention import KVCache, write_chunk_kv_q, write_prefill_pages_q
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import assert_kv_dtype


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a program argument — a tensor, or dicts, tuples,
    lists and dataclasses (``TernaryWeight``) of them — in a fixed order.
    Any other leaf raises: a captured program would bake its value in."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensor_leaves(getattr(tree, f.name))]
    raise TypeError(f"a captured program takes tensors only, got {type(tree).__name__}")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _storages(args) -> set:
    return {_storage(t) for a in args for t in tensor_leaves(a)}


def _rebuild(tree, leaves):
    """``tree`` with its tensors taken in order from the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_rebuild(x, leaves) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                        for f in dataclasses.fields(tree)})


@dataclasses.dataclass(eq=False)
class GraphResources:
    """The side stream one engine's graphs are captured on and the memory
    pool they share (they replay one at a time, in one stream, in any order:
    the pool holds their scratch, never what they return)."""

    stream: Optional["torch.cuda.Stream"] = None
    pool: object = None
    # called before each capture: a capture must not overlap another
    # thread's launches (the disaggregated engine waits for its prefill pool)
    before_capture: Optional[Callable[[], None]] = None

    def get(self, device: torch.device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
        return self.stream, self.pool


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]  # the static copies of the varying arguments' tensors
    outputs: object  # what a replay returns: argument tensors, or buffers outside the pool
    launches: Dict[str, int]  # what one replay adds to kernels.COUNTS


@dataclasses.dataclass(eq=False)
class PhaseProgram:
    """One phase program.  ``fn`` is the eager callable.  Calling the
    program runs ``fn`` — except on a card when ``capturable``: the first
    call runs ``fn`` (the warm-up, whose result it returns) and captures it
    as a CUDA graph, and every later call replays the graph.

    The arguments at ``pinned`` (params, cache, pages, the f32 prefix
    mirror: what the JAX program donates) must be the very tensors of the
    first call, checked by ``data_ptr`` on every call and on every device;
    another tensor raises.  The tensors of every other argument are copied
    into the graph's static inputs before each replay, so they may change
    between calls but not in shape or dtype.  A replay returns the graph's
    static outputs: the tensors ``fn`` makes are copied, at the end of the
    graph, into buffers of their own outside the shared pool, so they stay
    valid until this program is called again, whatever other graph of the
    engine replays meanwhile (a graph captured later may take this one's
    scratch in the pool, and this one's replay writes that scratch).
    ``kernels.COUNTS`` goes on counting launches: the capture records what
    the wrappers counted on its thread while it ran (into the capture's own
    record, since capturing launches nothing), and each replay adds it."""

    name: str
    fn: Callable
    capturable: bool = False
    pinned: Tuple[int, ...] = ()
    graphs: GraphResources = dataclasses.field(default_factory=GraphResources)
    pins: Optional[List[List[int]]] = None  # data_ptr of each pinned argument's tensors
    captured: Optional[_Graph] = None

    def __call__(self, *args):
        if not self.capturable:
            return self.fn(*args)
        pins = [[t.data_ptr() for t in tensor_leaves(args[i])] for i in self.pinned]
        if self.pins is None:
            self.pins = pins
        elif pins != self.pins:
            bad = next(i for i, a, b in zip(self.pinned, pins, self.pins) if a != b)
            raise ValueError(f"{self.name}: argument {bad} is not the tensor of the first call "
                             "(params, cache, pages and prefix mirror keep their address)")
        device = tensor_leaves(args[0])[0].device  # the params, or the sampler's logits
        if device.type != "cuda":
            return self.fn(*args)
        if self.captured is None:
            out = self.fn(*args)  # the warm-up
            self._capture(args, device, out)
            return out
        return self._replay(args)

    def _capture(self, args, device: torch.device, warm) -> None:
        """Capture ``fn`` on ``args``'s shapes (a failed capture raises);
        ``warm`` is the warm-up's result, which sizes the output buffers."""
        if self.graphs.before_capture is not None:
            self.graphs.before_capture()
        inputs = []
        static_args = []
        for i, a in enumerate(args):
            if i in self.pinned:
                static_args.append(a)
                continue
            mine = [torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)
                    for t in tensor_leaves(a)]
            inputs.extend(mine)
            static_args.append(_rebuild(a, iter(mine)))
        # buffers (made before the capture, so outside the pool) for every
        # result that is none of the arguments' tensors
        held = _storages(args)
        made = [t for t in tensor_leaves(warm) if _storage(t) not in held]
        buffers = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in made]
        held = _storages(static_args)
        graph = torch.cuda.CUDAGraph()
        stream, pool = self.graphs.get(device)
        collecting = gc.isenabled()
        # a collection inside the capture could free another program's graph
        # (one left in a reference cycle), which CUDA refuses while a
        # stream captures: no collection runs until the capture ends
        gc.disable()
        try:
            with COUNTS.recording() as launches, torch.cuda.graph(graph, pool=pool,
                                                                    stream=stream):
                outputs = self.fn(*static_args)
                leaves = tensor_leaves(outputs)
                if sum(_storage(t) not in held for t in leaves) != len(buffers):
                    raise RuntimeError(f"{self.name}: the capture made other results than "
                                       "the warm-up")
                fresh = iter(buffers)
                outputs = _rebuild(outputs, iter([t if _storage(t) in held else next(fresh).copy_(t)
                                                  for t in leaves]))
        finally:
            if collecting:
                gc.enable()
        self.captured = _Graph(graph, inputs, outputs, launches)

    def _replay(self, args):
        g = self.captured
        leaves = [t for i, a in enumerate(args) if i not in self.pinned for t in tensor_leaves(a)]
        if len(leaves) != len(g.inputs):
            raise ValueError(f"{self.name}: {len(leaves)} input tensors, captured with "
                             f"{len(g.inputs)}")
        for src, dst in zip(leaves, g.inputs):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{self.name}: an input of {tuple(src.shape)} {src.dtype}, "
                                 f"captured with {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
        g.graph.replay()
        COUNTS.add_all(g.launches)
        return g.outputs


class PhaseEngine:
    """Builds and caches the phase programs for one architecture."""

    def __init__(self, cfg: ModelConfig, *, cache_layout: str = "contiguous",
                 kv_dtype: str = "fp"):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout must be 'contiguous' or 'paged', got {cache_layout!r}")
        assert_kv_dtype(kv_dtype)
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self._programs: Dict[str, PhaseProgram] = {}
        self._graphs = GraphResources()

    def _program(self, key: str, fn: Callable, *, capturable: bool = False,
                 pinned: Tuple[int, ...] = ()) -> PhaseProgram:
        if key not in self._programs:
            self._programs[key] = PhaseProgram(key, fn, capturable, pinned, self._graphs)
        return self._programs[key]

    def before_capture(self, hook: Callable[[], None]) -> None:
        """Call ``hook`` before each capture of this engine's graphs."""
        self._graphs.before_capture = hook

    @property
    def programs(self) -> Dict[str, PhaseProgram]:
        """Every program built so far, by key (a copy)."""
        return dict(self._programs)

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the allocator holds for the graphs' shared pool (0
        before any capture; None where the allocator's snapshot does not
        name each segment's pool)."""
        pool = self._graphs.pool
        if pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if any("segment_pool_id" not in seg for seg in segments):
            return None
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg["segment_pool_id"]) == tuple(pool))

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

        return self._program(f"decode:{batch}x{max_len}", fn, capturable=True, pinned=(0, 2))

    def paged_decode_program(self, n_slots: int, max_pages: int) -> PhaseProgram:
        """``fn(params, token, pages, block_tables, lengths) -> (logits,
        pages)``; the pool is updated in place."""
        cfg = self.cfg

        def fn(params, token, pages, block_tables, lengths):
            return T.decode_step_paged(params, token, pages, block_tables, lengths, cfg)

        return self._program(f"decode_paged:{n_slots}x{max_pages}", fn, capturable=True,
                             pinned=(0, 2))

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
        prefix)``, cache and f32 prefix mirror updated in place; ``slot``,
        ``prefix_len`` and ``last_pos`` are 0-d int32 device tensors (the JAX
        program's traced scalars), so one graph serves every chunk of the
        shape.  The install is part of the program: the fabric can flip
        back to decode after every chunk."""
        cfg = self.cfg

        def fn(params, tokens, cache, prefix, slot, prefix_len, last_pos):
            return T.prefill_chunk(params, tokens, cache, prefix, slot, prefix_len, last_pos, cfg,
                                   prefix_width=prefix_width)

        return self._program(f"prefill_chunk:{chunk}+{prefix_width}@{n_slots}x{max_len}", fn,
                             capturable=True, pinned=(0, 2, 3))

    def paged_prefill_chunk_program(self, chunk: int, max_pages: int, block_size: int,
                                    prefix_width: int) -> PhaseProgram:
        """Chunked prefill against the paged pool: ``fn(params, tokens (1, C),
        pages, prefix, page_ids (C/bs,), prefix_len, last_pos) -> (logits,
        pages, prefix)``, page ids and scalars on the device; C must be whole
        pages."""
        if chunk % block_size:
            raise ValueError(f"a chunk of {chunk} tokens is not whole pages of {block_size}")
        cfg = self.cfg

        def fn(params, tokens, pages, prefix, page_ids, prefix_len, last_pos):
            return T.prefill_chunk_paged(params, tokens, pages, prefix, page_ids, prefix_len,
                                         last_pos, cfg, prefix_width=prefix_width)

        return self._program(f"prefill_chunk_paged:{chunk}+{prefix_width}@{max_pages}x{block_size}",
                             fn, capturable=True, pinned=(0, 2, 3))

    def prefill_chunk_kv_program(self, chunk: int, prefix_width: int) -> PhaseProgram:
        """Chunked prefill with no install, the disaggregated prefill pool's
        chunk program: ``fn(params, tokens (1, C), prefix, prefix_len,
        last_pos) -> (logits, chunk KV (L, 1, Hkv, C, D) f32, prefix)``, the
        f32 mirror updated in place, ``prefix_len`` and ``last_pos`` 0-d
        device tensors.  The fused chunk programs' math; the decode pool
        installs the returned KV with their writers (``chunk_write`` or
        ``page_write``).  A replay returns the graph's output buffers, which
        its next replay overwrites: a caller that keeps the KV longer copies
        it out."""
        cfg = self.cfg

        def fn(params, tokens, prefix, prefix_len, last_pos):
            return T.prefill_chunk_kv(params, tokens, prefix, prefix_len, last_pos, cfg,
                                      prefix_width=prefix_width)

        return self._program(f"prefill_chunk_kv:{chunk}+{prefix_width}", fn, capturable=True,
                             pinned=(0, 2))

    def chunk_write_program(self, chunk: int) -> PhaseProgram:
        """The decode pool's install of one shipped chunk into the contiguous
        cache: ``fn(cache, kv (L, 1, Hkv, C, D), slot, prefix_len) ->
        cache``, in place, quantized on write under int8/int4: the
        ``write_chunk_kv_q`` scatter the fused ``prefill_chunk`` program
        runs, so the two pools store the colocated engine's bytes.  The
        paged counterpart is ``page_write``."""

        def fn(cache, kv, slot, prefix_len):
            return KVCache(write_chunk_kv_q(cache.k, kv.k, slot, prefix_len),
                           write_chunk_kv_q(cache.v, kv.v, slot, prefix_len))

        return self._program(f"chunk_write:{chunk}", fn)

    def relay_program(self, seq: int, max_len: int) -> PhaseProgram:
        """The prefill pool's half of the contiguous swap: ``fn(kv) ->
        segment``, one prompt's KV (L, 1, Hkv, seq, D) f32 as a decode-layout
        segment (1, L, Hkv, max_len, D), padded and quantized on write
        (``core.kv_cache.relay_prefill_kv``).  The decode pool copies it into
        the slot (``install_relayed_kv``); the two halves store what
        ``relayout`` stores."""
        kv_dtype = self.kv_dtype

        def fn(kv):
            return relay_prefill_kv(kv, max_len, kv_dtype)

        return self._program(f"relay:{seq}->{max_len}", fn)

    def verify_program(self, batch: int, max_len: int, width: int) -> PhaseProgram:
        """Speculative verify over the contiguous cache: ``fn(params, tokens
        (B, W), cache, lengths, n_tokens) -> (logits (B, W, Vp), cache)``,
        the block's rows installed in place.  A decode-phase program like
        ``decode``, streaming the cache once a round but scoring W = k + 1
        positions a slot; per-slot draft depth varies through the device
        tensor ``n_tokens``, so one graph serves every round."""
        cfg = self.cfg

        def fn(params, tokens, cache, lengths, n_tokens):
            return T.verify(params, tokens, cache, lengths, n_tokens, cfg)

        return self._program(f"verify:{batch}x{width}@{max_len}", fn, capturable=True,
                             pinned=(0, 2))

    def paged_verify_program(self, n_slots: int, max_pages: int, width: int) -> PhaseProgram:
        """Speculative verify over the paged pool: ``fn(params, tokens (B,
        W), pages, block_tables, lengths, n_tokens) -> (logits (B, W, Vp),
        pages)``; see ``verify_program``."""
        cfg = self.cfg

        def fn(params, tokens, pages, block_tables, lengths, n_tokens):
            return T.verify_paged(params, tokens, pages, block_tables, lengths, n_tokens, cfg)

        return self._program(f"verify_paged:{n_slots}x{width}@{max_pages}", fn, capturable=True,
                             pinned=(0, 2))

    def block_sampler_program(self, batch: int, width: int) -> PhaseProgram:
        """The verify targets' sampler: ``fn(logits (B, W, V), seeds, step0s,
        temps, top_ks, top_ps) -> (B, W) tokens``; position i of slot b draws
        with ``fold_in(PRNGKey(seeds[b]), step0s[b] + i)``, the key sequential
        decode uses, so speculation keeps sampled streams unchanged."""
        return self._program(f"block_sampler:{batch}x{width}", sample_block_tokens,
                             capturable=True)

    def sampler_program(self, batch: int) -> PhaseProgram:
        """The per-slot sampler, the decode epilogue: ``fn(logits, seeds,
        steps, temps, top_ks, top_ps) -> tokens`` on the logits' device; slot
        i draws with ``fold_in(PRNGKey(seeds[i]), steps[i])``."""
        return self._program(f"sampler:{batch}", sample_tokens, capturable=True)
