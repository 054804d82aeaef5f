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
  * ``prefill:{B}x{S}``               — any family's registry prefill (whisper
    with its encoder's frames), the hymba, xlstm and encdec families' too
  * ``install:{B}x{S}->{max_len}``    — such a family's swap: a prefill's
    cache into the slots of ``init_cache``'s (its ``install_prefill``)

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

On a mesh (``PhaseEngine(cfg, mesh)``, one process a rank) every program
runs under the rules of ``make_pctx``: prefill with the heads over the
model axis, decode with the batch over data and the KV sequence over
model (with ``long_context`` the sequence over data x model and the
states' channels over model).  A hymba, xlstm or encdec cache is cut by
``layers.sharding.cache_spec`` (each family's ``init_cache`` cutting its
own leaves), as the JAX ``_cache_shardings`` lays it out; those families'
programs run eagerly.  The relayout is then the exchange from
heads-sharded prefill KV to sequence-sharded decode KV, one all-to-all
over the model axis: the counterpart of the paper's bitstream load.  The programs capture as graphs
only where the mesh's collectives can be captured (NCCL,
``Mesh.capturable``); on a gloo mesh they run eagerly.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import (
    MeshInstall,
    heads_to_rows,
    insert_prefill_kv,
    relay_prefill_kv,
)
from repro_torch.core.sampling import sample_block_tokens, sample_tokens
from repro_torch.kernels import COUNTS
from repro_torch.layers import collectives as C
from repro_torch.layers.attention import (
    KVCache,
    write_chunk_kv_q,
    write_chunk_kv_seq_shard_q,
    write_prefill_pages_q,
)
from repro_torch.common.tree import named_leaves
from repro_torch.layers.sharding import (
    DECODE_RULES,
    LONG_DECODE_RULES,
    PREFILL_RULES,
    MeshAxes,
    PartitionCtx,
    cache_spec,
    local_shape,
)
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.quant.kv_quant import QuantKV, assert_kv_dtype


def _mesh_axes(mesh) -> MeshAxes:
    if mesh is None:
        return MeshAxes()
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data")) or (None,)
    dp = dp[0] if len(dp) == 1 else dp
    return MeshAxes(dp=dp, tp="model" if "model" in names else None,
                    fsdp="data" if "data" in names else None)


def make_pctx(mesh, phase: str) -> PartitionCtx:
    rules = {"prefill": PREFILL_RULES, "decode": DECODE_RULES,
             "long_decode": LONG_DECODE_RULES}.get(phase, PREFILL_RULES)
    return PartitionCtx(mesh=mesh, axes=_mesh_axes(mesh), rules=rules)


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
    mirror: what the JAX program donates; a cache a program returns comes
    back as the same storage, updated in place) must be the very tensors of
    the first call, checked by ``data_ptr`` on every call of a capturable
    program and on every device; another tensor raises.  ``phase`` names
    the serving phase (``prefill``, ``decode``, ``swap`` or ``sampler``),
    as the JAX registry does; the ``program`` analysis pass reads both.  The tensors of every other argument are copied
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
    phase: str = ""

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


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one tensor a program is dispatched with (the
    counterpart of ``jax.ShapeDtypeStruct``); ``host`` for a tensor that
    stays on the CPU (the page write's destination ids)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    host: bool = False

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device="cpu" if self.host else device)


def spec_of(tree):
    """``tree`` with every tensor replaced by its ``TensorSpec``."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    return _rebuild(tree, iter([TensorSpec(tuple(t.shape), t.dtype) for t in tensor_leaves(tree)]))


def _materialize(tree, device):
    if isinstance(tree, TensorSpec):
        return tree.zeros(device)
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialize(x, device) for x in tree)
    return tree


@dataclasses.dataclass(eq=False)
class ProgramSignature:
    """What ``EngineCore.step`` dispatches one program with: ``args`` holds,
    at each index of ``own``, the runner's own tensors (params, cache,
    pages, prefix mirror: the pinned arguments), and elsewhere
    ``TensorSpec`` trees or the Python ints the program takes."""

    key: str
    program: PhaseProgram
    args: tuple
    own: Tuple[int, ...]

    @property
    def phase(self) -> str:
        return self.program.phase

    def inputs(self, device) -> tuple:
        """The arguments to call the program with: the runner's own tensors
        where ``own`` says, zeros of each spec on ``device`` elsewhere."""
        return tuple(a if i in self.own else _materialize(a, device)
                     for i, a in enumerate(self.args))


class PhaseEngine:
    """Builds and caches the phase programs for one architecture."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, cache_layout: str = "contiguous",
                 kv_dtype: str = "fp", long_context: bool = False):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout must be 'contiguous' or 'paged', got {cache_layout!r}")
        assert_kv_dtype(kv_dtype)
        if long_context and cache_layout == "paged":
            raise NotImplementedError("long-context decode walks the contiguous cache")
        if cfg.family != "transformer" and (cache_layout != "contiguous" or kv_dtype != "fp"):
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family's programs take the "
                                      "contiguous fp cache, as the JAX package's")
        self.cfg = cfg
        self.mesh = mesh
        self.api = get_model(cfg)
        self.kv_dtype = kv_dtype
        self.decode_phase = "long_decode" if long_context else "decode"
        self.prefill_ctx = make_pctx(mesh, "prefill")
        self.decode_ctx = make_pctx(mesh, self.decode_phase)
        T.check_mesh_model(cfg, self.prefill_ctx)
        T.check_mesh_model(cfg, self.decode_ctx)
        # bytes the swap's exchange (relayout or page write) sent from this
        # rank, and its calls
        self.exchange_bytes = 0
        self.exchanges = 0
        self.n_slots: Optional[int] = None  # the whole batch of the cache init_cache made
        self._programs: Dict[str, PhaseProgram] = {}
        self._graphs = GraphResources()

    def _program(self, key: str, fn: Callable, *, phase: str, capturable: bool = False,
                 pinned: Tuple[int, ...] = ()) -> PhaseProgram:
        if key not in self._programs:
            # a mesh whose collectives a graph cannot capture (gloo) runs eagerly
            capturable = capturable and (self.mesh is None or self.mesh.capturable)
            self._programs[key] = PhaseProgram(key, fn, capturable, pinned, self._graphs,
                                               phase=phase)
        return self._programs[key]

    # ------------------------------------------------------ mesh shards --

    def init_cache(self, batch: int, max_len: int, device=None, dtype=None):
        """This rank's block of the decode cache of ``batch`` slots: its rows
        of the batch and max_len / k rows of the sequence, k the ranks of
        the sequence axis (the whole cache without a mesh).  The
        transformer family's is the (batch, L, Hkv, max_len, D) KV in
        ``kv_dtype``; another family's is its registry cache cut by the
        decode rules (``cache_blocks``), in ``dtype`` where given (the
        family's own default otherwise)."""
        k = self.decode_ctx.size(self.decode_ctx.resolve(["kv_seq"])[0])
        if max_len % k:
            raise ValueError(f"max_len {max_len} does not split over {k} sequence shards")
        self.n_slots = batch
        if self.cfg.family == "transformer":
            lo, hi = T.batch_rows(self.decode_ctx, batch)
            return T.init_cache(self.cfg, hi - lo, max_len // k, kv_dtype=self.kv_dtype,
                                device=device)
        kw = {} if dtype is None else {"dtype": dtype}
        return self.api.init_cache(self.cfg, batch, max_len, device=device, pctx=self.decode_ctx,
                                   **kw)

    def cache_blocks(self, batch: int, max_len: int) -> Dict[str, tuple]:
        """{leaf name: (its spec, this rank's block shape)} of a family's
        decode cache of ``batch`` slots under the decode rules: each leaf of
        the whole cache (the registry's ``init_cache``, on no device) cut by
        ``layers.sharding.cache_spec``, as the JAX ``_cache_shardings``
        lays it out."""
        whole = self.api.init_cache(self.cfg, batch, max_len, device="meta")
        out = {}
        for name, leaf in named_leaves(whole):
            spec = cache_spec(self.decode_ctx, name, tuple(leaf.shape))
            out[name] = (spec, local_shape(self.decode_ctx, spec, tuple(leaf.shape)))
        return out

    def _exchange(self, kv: KVCache, sl: int) -> KVCache:
        """The swap on a mesh: one prompt's prefill KV (L, 1, Hkv / tp, S,
        D) of this rank's heads becomes this rank's rows of every head
        (``core.kv_cache.heads_to_rows``), counted in the exchange's bytes
        and calls."""
        rows, nbytes = heads_to_rows(kv, sl, self.decode_ctx)
        self.count_head_gather(nbytes)
        return rows

    def _gather_kv_heads(self, kv: KVCache) -> KVCache:
        """Prefill KV of this rank's heads made whole over the model axis
        (the paged pool holds every head on every rank)."""
        self.count_head_gather(2 * kv.k.numel() * kv.k.element_size())
        return T.gather_kv_heads(kv, self.cfg, self.prefill_ctx)

    def count_head_gather(self, nbytes: int) -> None:
        """Count one gather of a prompt's or chunk's heads (``nbytes`` of
        this rank's K and V) in the exchange's bytes and calls.  A mesh
        chunk program's gather is counted by its caller on every call,
        since a captured graph's replay runs no Python."""
        self.exchange_bytes += nbytes
        self.exchanges += 1

    def _heads_to_rows(self, seg):
        """A relayed segment of this rank's heads (1, L, Hkv / tp, max_len,
        ·) as this rank's block of the sequence (1, L, Hkv, max_len / tp, ·),
        every leaf exchanged over the model axis."""
        tp = self.prefill_ctx.axes.tp
        group = self.mesh.group(tp)
        k = self.prefill_ctx.size(tp)
        out = []
        for leaf in seg:
            parts = (leaf.q, leaf.scale) if isinstance(leaf, QuantKV) else (leaf,)
            moved = []
            for t in parts:
                moved.append(C.all_to_all(t, group, split_dim=3, cat_dim=2))
                self.exchange_bytes += t.numel() * t.element_size() * (k - 1) // k
            out.append(QuantKV(*moved) if isinstance(leaf, QuantKV) else moved[0])
        self.exchanges += 1
        return type(seg)(*out)

    def _write_chunk_rows(self, cache: KVCache, kv: KVCache, slot, start) -> KVCache:
        """Write the rows of a whole-heads chunk (L, 1, Hkv, C, D) at [start,
        start + C) of slot ``slot`` that fall in this rank's block of the
        sequence, on the data rank whose rows of the batch hold the slot
        (``write_chunk_kv_seq_shard_q``; ints or 0-d device tensors)."""
        write = self._chunk_rows_writer(self.n_slots)
        return KVCache(write(cache.k, kv.k, slot, start), write(cache.v, kv.v, slot, start))

    def _chunk_rows_writer(self, n_slots: int):
        """``write(leaf, kv, slot, start)`` into this rank's block of a cache
        of ``n_slots`` slots (its rows of the batch and of the sequence)."""
        lo, _ = T.batch_rows(self.decode_ctx, n_slots)
        r = self.decode_ctx.index(self.decode_ctx.resolve(["kv_seq"])[0])

        def write(leaf, kv, slot, start):
            return write_chunk_kv_seq_shard_q(leaf, kv, slot, start, r, lo)

        return write

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
        cfg, pctx = self.cfg, self.prefill_ctx

        def fn(params, tokens, last_pos):
            return T.forward_prefill(params, tokens, cfg, last_pos=last_pos, pctx=pctx)

        return self._program(f"prefill_varlen:{batch}x{seq}", fn, phase="prefill")

    def prefill_split_programs_varlen(self, batch: int, seq: int) -> Tuple[PhaseProgram, PhaseProgram]:
        """(body, tail): the overlap split, the tail taking ``last_pos``."""
        cfg, pctx = self.cfg, self.prefill_ctx
        key = f"prefill_split_varlen:{batch}x{seq}"

        def body_fn(params, tokens):
            return T.forward_prefill(params, tokens, cfg, split_tail=True, pctx=pctx)

        def tail_fn(params, x_mid, last_pos):
            return T.prefill_tail(params, x_mid, cfg, last_pos=last_pos, pctx=pctx, batch=batch)

        return (self._program(key, body_fn, phase="prefill"),
                self._program(key + ":tail", tail_fn, phase="prefill"))

    def prefill_split_programs(self, batch: int, seq: int) -> Tuple[PhaseProgram, PhaseProgram]:
        """(body, tail): the overlap split at the last layer's attention."""
        cfg, pctx = self.cfg, self.prefill_ctx

        def body_fn(params, tokens):
            return T.forward_prefill(params, tokens, cfg, split_tail=True, pctx=pctx)

        def tail_fn(params, x_mid):
            return T.prefill_tail(params, x_mid, cfg, pctx=pctx, batch=batch)

        return (self._program(f"prefill_body:{batch}x{seq}", body_fn, phase="prefill"),
                self._program(f"prefill_tail:{batch}x{seq}", tail_fn, phase="prefill"))

    def relayout_program(self, batch: int, seq: int, max_len: int) -> PhaseProgram:
        """The swap: ``fn(kv, cache, slot)`` moves one prompt's prefill-layout
        KV (L, 1, Hkv, seq, D) into slot ``slot`` of the batch-leading decode
        cache in place — layer-major to batch-leading, cast to the cache
        dtype or quantized from f32, rows [seq, max_len) padded — and
        returns the cache.

        On a mesh ``cache`` is this rank's block and ``slot`` a slot of the
        whole batch: the ranks of the data row that holds the slot exchange
        the prompt's KV from heads to sequence (``_exchange``) and install
        their rows into their block; the other rows do nothing."""
        if batch != 1:
            raise NotImplementedError("the relayout installs one prompt at a time")

        def fn(kv, cache, slot):
            if self.mesh is None:
                return insert_prefill_kv(cache, kv, slot)
            if self.n_slots is None:
                raise RuntimeError("on a mesh the relayout installs into PhaseEngine.init_cache's "
                                   "cache")
            leaf = cache.k.q if isinstance(cache.k, QuantKV) else cache.k
            lo, hi = T.batch_rows(self.decode_ctx, self.n_slots)
            if not lo <= slot < hi:
                return cache
            return insert_prefill_kv(cache, self._exchange(kv, leaf.shape[3]), slot - lo)

        return self._program(f"relayout:{batch}x{seq}->{max_len}", fn, phase="swap", pinned=(1,))

    def decode_program(self, batch: int, max_len: int) -> PhaseProgram:
        """``fn(params, token, cache, lengths) -> (logits, cache)``; the cache
        is updated in place (the JAX program donates it).  Another family's
        is its registry ``decode_step`` on its cache (``init_cache``), run
        eagerly."""
        cfg, pctx, api = self.cfg, self.decode_ctx, self.api

        def fn(params, token, cache, lengths):
            return api.decode_step(params, token, cache, lengths, cfg, pctx)

        family = cfg.family != "transformer"
        return self._program(f"decode:{batch}x{max_len}", fn, phase="decode",
                             capturable=not family, pinned=(0, 2))

    def prefill_program(self, batch: int, seq: int, *, frames: bool = False) -> PhaseProgram:
        """The registry's prefill of any family: ``fn(params, tokens (B, S)
        [, frames (B, Senc, d)]) -> (logits (B, Vp), the family's prefill
        cache)``, eager; whisper takes its encoder's ``frames``.  On a mesh
        (the prefill rules) every rank takes the whole batch and returns
        its rows' cache (``forward_prefill``'s mesh contract)."""
        cfg, pctx, api = self.cfg, self.prefill_ctx, self.api

        if frames:
            def fn(params, tokens, frame_emb):
                return api.forward_prefill(params, tokens, cfg, pctx, frames=frame_emb)
        else:
            def fn(params, tokens):
                return api.forward_prefill(params, tokens, cfg, pctx=pctx)

        return self._program(f"prefill:{batch}x{seq}", fn, phase="prefill")

    def install_program(self, batch: int, seq: int, max_len: int) -> PhaseProgram:
        """A family's swap: ``fn(prefilled, cache, slots) -> cache`` puts
        prompt i of a ``prefill_program`` result into slot ``slots[i]`` of
        ``init_cache``'s cache, in place (the family's
        ``install_prefill``).  On a mesh each rank installs into its block
        (``core.kv_cache.MeshInstall``): the data rank whose rows hold a
        slot takes its prompt, the KV moves from heads to rows, the states
        are gathered whole over the model axis where the decode rules keep
        them whole; every exchange and gather is counted in the exchange's
        bytes and calls."""
        install = self.api.module.install_prefill

        def fn(prefilled, cache, slots):
            if self.mesh is None:
                return install(cache, prefilled, slots)
            if self.n_slots is None:
                raise RuntimeError("on a mesh the install writes into PhaseEngine.init_cache's "
                                   "cache")
            mesh = MeshInstall(self.cfg.num_kv_heads, self.prefill_ctx, self.decode_ctx,
                               self.n_slots, list(slots), self.count_head_gather)
            return install(cache, prefilled, mesh=mesh)

        return self._program(f"install:{batch}x{seq}->{max_len}", fn, phase="swap", pinned=(1,))

    def paged_decode_program(self, n_slots: int, max_pages: int) -> PhaseProgram:
        """``fn(params, token, pages, block_tables, lengths) -> (logits,
        pages)``; the pool is updated in place."""
        cfg, pctx = self.cfg, self.decode_ctx

        def fn(params, token, pages, block_tables, lengths):
            return T.decode_step_paged(params, token, pages, block_tables, lengths, cfg, pctx)

        return self._program(f"decode_paged:{n_slots}x{max_pages}", fn, phase="decode",
                             capturable=True,
                             pinned=(0, 2))

    def page_write_program(self, seq: int, block_size: int) -> PhaseProgram:
        """The paged swap: ``fn(pages, kv, page_ids)`` scatters prefill-layout
        KV (L, 1, Hkv, seq, D) into the pages ``page_ids`` (ids >= N skipped)
        in place, quantizing on write under int8/int4, and returns the pool.
        On a mesh the ranks first gather the prompt's heads: every rank's
        pool holds every page whole."""

        def fn(pages, kv, page_ids):
            if self.mesh is not None:
                kv = self._gather_kv_heads(kv)
            return KVCache(write_prefill_pages_q(pages.k, kv.k, page_ids, block_size=block_size),
                           write_prefill_pages_q(pages.v, kv.v, page_ids, block_size=block_size))

        return self._program(f"page_write:{seq}@{block_size}", fn, phase="swap", pinned=(0,))

    def prefill_chunk_program(self, chunk: int, n_slots: int, max_len: int,
                              prefix_width: int) -> PhaseProgram:
        """Chunked prefill against the contiguous cache: ``fn(params, tokens
        (1, C), cache, prefix, slot, prefix_len, last_pos) -> (logits, cache,
        prefix)``, cache and f32 prefix mirror updated in place; ``slot``,
        ``prefix_len`` and ``last_pos`` are 0-d int32 device tensors (the JAX
        program's traced scalars), so one graph serves every chunk of the
        shape.  The install is part of the program: the fabric can flip
        back to decode after every chunk.

        On a mesh the chunk runs on this rank's heads under the prefill
        rules (the mirror holds them: (L, 1, Hkv / tp, Cap, D)), the install
        gathers the chunk's heads over the model axis, and each rank writes
        the chunk's rows that fall in its block of the cache, on the data
        rank that holds the slot; the caller counts the gather
        (``count_head_gather``)."""
        cfg, pctx = self.cfg, self.prefill_ctx
        write = write_chunk_kv_q if self.mesh is None else self._chunk_rows_writer(n_slots)

        def fn(params, tokens, cache, prefix, slot, prefix_len, last_pos):
            return T.prefill_chunk(params, tokens, cache, prefix, slot, prefix_len, last_pos, cfg,
                                   prefix_width=prefix_width, pctx=pctx, write=write)

        return self._program(f"prefill_chunk:{chunk}+{prefix_width}@{n_slots}x{max_len}", fn,
                             phase="prefill", capturable=True, pinned=(0, 2, 3))

    def paged_prefill_chunk_program(self, chunk: int, max_pages: int, block_size: int,
                                    prefix_width: int) -> PhaseProgram:
        """Chunked prefill against the paged pool: ``fn(params, tokens (1, C),
        pages, prefix, page_ids (C/bs,), prefix_len, last_pos) -> (logits,
        pages, prefix)``, page ids and scalars on the device; C must be whole
        pages.  On a mesh every rank gathers the chunk's heads and writes
        the pages into its whole pool."""
        if chunk % block_size:
            raise ValueError(f"a chunk of {chunk} tokens is not whole pages of {block_size}")
        cfg, pctx = self.cfg, self.prefill_ctx

        def fn(params, tokens, pages, prefix, page_ids, prefix_len, last_pos):
            return T.prefill_chunk_paged(params, tokens, pages, prefix, page_ids, prefix_len,
                                         last_pos, cfg, prefix_width=prefix_width, pctx=pctx)

        return self._program(f"prefill_chunk_paged:{chunk}+{prefix_width}@{max_pages}x{block_size}",
                             fn, phase="prefill", capturable=True, pinned=(0, 2, 3))

    def prefill_chunk_kv_program(self, chunk: int, prefix_width: int) -> PhaseProgram:
        """Chunked prefill with no install, the disaggregated prefill pool's
        chunk program: ``fn(params, tokens (1, C), prefix, prefix_len,
        last_pos) -> (logits, chunk KV (L, 1, Hkv, C, D) f32, prefix)``, the
        f32 mirror updated in place, ``prefix_len`` and ``last_pos`` 0-d
        device tensors.  The fused chunk programs' math; the decode pool
        installs the returned KV with their writers (``chunk_write`` or
        ``page_write``).  A replay returns the graph's output buffers, which
        its next replay overwrites: a caller that keeps the KV longer copies
        it out.

        On a mesh (the prefill pod of the split) the chunk runs on this
        rank's heads under the prefill rules: the mirror ``prefix`` holds
        those heads (L, 1, Hkv / tp, Cap, D), so a chunk attends its prefix
        head by head with no merge, and the KV returned is those heads."""
        cfg, pctx = self.cfg, self.prefill_ctx

        def fn(params, tokens, prefix, prefix_len, last_pos):
            return T.prefill_chunk_kv(params, tokens, prefix, prefix_len, last_pos, cfg,
                                      prefix_width=prefix_width, pctx=pctx)

        return self._program(f"prefill_chunk_kv:{chunk}+{prefix_width}", fn, phase="prefill",
                             capturable=True,
                             pinned=(0, 2))

    def chunk_write_program(self, chunk: int) -> PhaseProgram:
        """The decode pool's install of one shipped chunk into the contiguous
        cache: ``fn(cache, kv (L, 1, Hkv, C, D), slot, prefix_len) ->
        cache``, in place, quantized on write under int8/int4: the
        ``write_chunk_kv_q`` scatter the fused ``prefill_chunk`` program
        runs, so the two pools store the colocated engine's bytes.  The
        paged counterpart is ``page_write``.

        On a mesh (the decode pod of the split) ``kv`` holds this rank's
        heads: the ranks gather every head over the model axis, and each
        writes the chunk's rows that fall in its block of the sequence
        (``slot`` and ``prefix_len`` host ints there)."""

        def fn(cache, kv, slot, prefix_len):
            if self.mesh is None:
                return KVCache(write_chunk_kv_q(cache.k, kv.k, slot, prefix_len),
                               write_chunk_kv_q(cache.v, kv.v, slot, prefix_len))
            return self._write_chunk_rows(cache, self._gather_kv_heads(kv), slot, prefix_len)

        return self._program(f"chunk_write:{chunk}", fn, phase="swap", pinned=(0,))

    def relay_program(self, seq: int, max_len: int) -> PhaseProgram:
        """The prefill pool's half of the contiguous swap: ``fn(kv) ->
        segment``, one prompt's KV (L, 1, Hkv, seq, D) f32 as a decode-layout
        segment (1, L, Hkv, max_len, D), padded and quantized on write
        (``core.kv_cache.relay_prefill_kv``).  The decode pool copies it into
        the slot (``install_relayed_kv``); the two halves store what
        ``relayout`` stores."""
        kv_dtype = self.kv_dtype

        def fn(kv):
            seg = relay_prefill_kv(kv, max_len, kv_dtype)
            return seg if self.mesh is None else self._heads_to_rows(seg)

        return self._program(f"relay:{seq}->{max_len}", fn, phase="swap")

    def verify_program(self, batch: int, max_len: int, width: int) -> PhaseProgram:
        """Speculative verify over the contiguous cache: ``fn(params, tokens
        (B, W), cache, lengths, n_tokens) -> (logits (B, W, Vp), cache)``,
        the block's rows installed in place.  A decode-phase program like
        ``decode``, streaming the cache once a round but scoring W = k + 1
        positions a slot; per-slot draft depth varies through the device
        tensor ``n_tokens``, so one graph serves every round.  On a mesh it
        runs under the decode rules, as ``decode`` (``transformer.verify``)."""
        cfg, pctx = self.cfg, self.decode_ctx

        def fn(params, tokens, cache, lengths, n_tokens):
            return T.verify(params, tokens, cache, lengths, n_tokens, cfg, pctx)

        return self._program(f"verify:{batch}x{width}@{max_len}", fn, phase="decode",
                             capturable=True,
                             pinned=(0, 2))

    def paged_verify_program(self, n_slots: int, max_pages: int, width: int) -> PhaseProgram:
        """Speculative verify over the paged pool: ``fn(params, tokens (B,
        W), pages, block_tables, lengths, n_tokens) -> (logits (B, W, Vp),
        pages)``; see ``verify_program``."""
        cfg, pctx = self.cfg, self.decode_ctx

        def fn(params, tokens, pages, block_tables, lengths, n_tokens):
            return T.verify_paged(params, tokens, pages, block_tables, lengths, n_tokens, cfg,
                                  pctx)

        return self._program(f"verify_paged:{n_slots}x{width}@{max_pages}", fn, phase="decode",
                             capturable=True,
                             pinned=(0, 2))

    def block_sampler_program(self, batch: int, width: int) -> PhaseProgram:
        """The verify targets' sampler: ``fn(logits (B, W, V), seeds, step0s,
        temps, top_ks, top_ps) -> (B, W) tokens``; position i of slot b draws
        with ``fold_in(PRNGKey(seeds[b]), step0s[b] + i)``, the key sequential
        decode uses, so speculation keeps sampled streams unchanged."""
        return self._program(f"block_sampler:{batch}x{width}", sample_block_tokens,
                             phase="sampler", capturable=True)

    def sampler_program(self, batch: int) -> PhaseProgram:
        """The per-slot sampler, the decode epilogue: ``fn(logits, seeds,
        steps, temps, top_ks, top_ps) -> tokens`` on the logits' device; slot
        i draws with ``fold_in(PRNGKey(seeds[i]), steps[i])``."""
        return self._program(f"sampler:{batch}", sample_tokens, phase="sampler", capturable=True)
