"""Step-driven serving core: ``EngineCore.step() -> list[RequestOutput]``.

The port of the JAX package's ``repro.serving.core``: prefill monolithic
(one prompt per swap) or chunked (``prefill_chunk=N``: at most one N-token
chunk of pending prefill a step, then a decode round, so a long prompt no
longer stalls every active stream for its whole prefill), per-request
sampling (temperature, top-k, top-p, with keys ``fold_in(PRNGKey(seed),
token index)`` drawn on the device), abort, the two cache layouts —
``cache_layout="contiguous"`` (the batch-leading cache, one slot per
request) or ``"paged"`` (a block pool with prefix caching, copy-on-write
and preemption by eviction, restarted requests replaying their recorded
tokens) — each stored as bf16 or quantized to int8/int4 (``kv_dtype``),
and the two modes —

* ``mode="pdswap"``: prefill split after the last layer's attention, the KV
  relayout overlapped with the prefill tail on a second CUDA stream
  (``overlap=True``) or run after it (``overlap=False``);
* ``mode="static"``: the unsplit prefill, then the KV install (quantized on
  write too: storage precision belongs to the cache, not to the phase).

Three layers, as in the JAX package: ``Scheduler`` (the wait queue,
weighted fair over tenants and exactly FIFO with one, admission validation,
the swap decision through a ``SwapPolicy``), ``ModelRunner`` (phase
programs, prompt and chunk buckets, the cache and slot manager, per-slot
sampling state in device tensors, prefill with the swap, decode rounds, the
sampler), and ``OutputProcessor`` (streaming deltas and finish semantics).
The policy's ``should_shed`` (true only in the SLO-aware one) drops queue
heads that can no longer meet their TTFT target, and its ``prefill_quanta``
may grant several chunks a step.

The engine drives the transformer family, as the JAX engine does; the
other families run through the registry API (``models.registry``).

The tracer (``obs.trace.TRACER``) records the request lifecycle and the
engine's spans with host clocks taken where the engine already waits for the
device (a chunk's synchronize, a prefill's end, a round's token read), so
tracing adds no device operation.

Replay after preemption is exact under sampling too: the key of a draw
depends only on the seed and the token's index, and a restart rebuilds the
cache by teacher-forcing its recorded tokens.  Chunk boundaries depend only
on the prompt length and the chunk size, so a restart re-prefills through
the same chunks.

Speculative decoding (``spec_decode=k``): each decode round drafts up to k
tokens a slot by prompt lookup on the host (``serving.spec_decode``), scores
every slot's [last token, drafts] block in one verify pass, emits the
longest confirmed draft prefix plus one target token, and rolls the
rejected rows back (the slot length; paged, the overshoot pages).  Targets
are what sequential decode would draw at each position (greedy argmax, or
the same keys), so the streams are those of plain decode.  A round in
which no slot drafted runs the plain decode program.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import KVSlotManager, insert_prefill_kv
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.core.sampling import accept_length
from repro_torch.core.staging import StagedTensor
from repro_torch.core.swap import SwapAggregates, SwapController, SwapTiming
from repro_torch.models import transformer as T
from repro_torch.obs.engine import engine_registry, engine_snapshot, snapshot_v2
from repro_torch.obs.trace import TRACER
from repro_torch.quant.kv_quant import QuantKV, payload_bytes, total_nbytes
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.layers.attention import KVCache
from repro_torch.serving.fair_queue import WeightedFairQueue
from repro_torch.serving.paging import PagedKVCache, PoolExhausted, PrefixMatch, cdiv
from repro_torch.serving.policy import DrainPolicy, SchedulerView, SwapPolicy, make_policy
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.slo import LatencyStat
from repro_torch.serving.spec_decode import find_draft

SWAP_TIMING_WINDOW = 64


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: np.ndarray  # (S,) int32 — any length with S + max_new <= max_len
    max_new: int
    priority: int = 0  # larger = more important; the lowest is preempted first
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # the wait queue drains per-tenant FIFO lanes in weighted deficit round
    # robin (serving.fair_queue): one tenant's burst cannot starve the others
    tenant: str = "default"
    weight: float = 1.0  # fair-queue share relative to the other tenants
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_time_s: float = 0.0  # first submit, never overwritten (TTFT origin)
    enqueue_t: float = 0.0  # scheduler-queue entry
    first_token_t: float = 0.0
    last_emit_t: float = 0.0  # the previous delta's emit time (ITL)
    queue_wait_s: Optional[float] = None  # arrival to first successful admission
    done_t: float = 0.0
    finish_reason: Optional[str] = None  # "stop" | "length" | "abort" once finished
    # Set on preemption: the restart re-prefills the prompt and replays the
    # recorded out_tokens through the decode program, which rebuilds the
    # evicted cache state exactly, so the continuation is unchanged.
    preempted: bool = False


@dataclasses.dataclass
class PrefillProgress:
    """One partially prefilled request (chunked prefill).  ``sizes`` (the
    real chunk sizes, in order) depend only on the prompt length and the
    chunk size.  A paged prompt holds all its pages from admission on
    (``match``); each chunk writes its own span of them."""

    req: Request
    slot: int
    resuming: bool  # a restart with recorded tokens: replay them after prefill
    restarted: bool  # any restart (even mid-prefill, with no tokens yet): its
    # prefill is recompute (t_replay), never offered load
    sizes: List[int]
    ci: int = 0  # next chunk
    pos: int = 0  # tokens already prefilled
    match: Optional[PrefixMatch] = None

    @property
    def remaining_chunks(self) -> int:
        return len(self.sizes) - self.ci


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_rounds: int = 0
    swaps: int = 0
    prefill_bursts: int = 0  # prefill phases entered (fabric flips, not swaps)
    prefill_chunks: int = 0  # chunks run (0 when prefill is monolithic)
    swap_timings: Deque[SwapTiming] = dataclasses.field(
        default_factory=lambda: deque(maxlen=SWAP_TIMING_WINDOW))
    swap_agg: SwapAggregates = dataclasses.field(default_factory=SwapAggregates)
    t_prefill: float = 0.0
    t_decode: float = 0.0
    # paged layout
    prefix_hits: int = 0  # prompt pages served from the prefix cache
    prefix_misses: int = 0  # full prompt pages that had to be written
    prefix_hit_tokens: int = 0
    preemptions: int = 0  # requests evicted to free pool capacity
    admission_blocks: int = 0  # admissions deferred on pool pressure
    replayed_tokens: int = 0  # decode steps re-run by preemption restarts
    t_replay: float = 0.0  # wall time of restarts (kept out of t_prefill/t_decode)
    # speculative decoding
    draft_tokens: int = 0
    accepted_tokens: int = 0
    verify_rounds: int = 0
    slot_rounds: int = 0  # active slots summed over decode rounds
    decode_ctx_tokens: int = 0  # context tokens attended, summed over slot-rounds
    # client-visible latency (bounded windows): arrival to first admission,
    # arrival to first token, the gap between a request's deltas
    queue_wait: LatencyStat = dataclasses.field(default_factory=LatencyStat)
    ttft: LatencyStat = dataclasses.field(default_factory=LatencyStat)
    itl: LatencyStat = dataclasses.field(default_factory=LatencyStat)
    # queue wait a tenant (the same windows), beside the fair queue's lane
    # depths in EngineCore.snapshot()["tenants"]
    tenant_queue_wait: Dict[str, LatencyStat] = dataclasses.field(default_factory=dict)
    aborts: int = 0  # requests cancelled while queued or in flight
    sheds: int = 0  # queue heads dropped by SLO admission control

    def decode_tput(self) -> float:
        return self.decode_tokens / self.t_decode if self.t_decode else 0.0

    def acceptance_rate(self) -> float:
        return self.accepted_tokens / self.draft_tokens if self.draft_tokens else 0.0

    def tokens_per_round(self) -> float:
        """Tokens emitted a slot a decode round (1.0 without speculation)."""
        return self.decode_tokens / self.slot_rounds if self.slot_rounds else 0.0

    def decode_round_cost(self) -> float:
        return self.t_decode / self.decode_rounds if self.decode_rounds else 0.0

    def record_swap(self, timing: SwapTiming) -> None:
        self.swaps += 1
        self.swap_timings.append(timing)
        self.swap_agg.update(timing)

    def snapshot(self) -> dict:
        """One JSON-serializable stats block with the JAX package's keys:
        the counters, the derived rates and the latency summaries."""
        counters = (
            "prefill_tokens", "decode_tokens", "decode_rounds", "swaps",
            "prefill_bursts", "prefill_chunks", "t_prefill", "t_decode",
            "prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "preemptions", "admission_blocks", "replayed_tokens", "t_replay",
            "draft_tokens", "accepted_tokens", "verify_rounds", "slot_rounds",
            "decode_ctx_tokens", "aborts", "sheds",
        )
        snap = {k: getattr(self, k) for k in counters}
        snap.update(
            decode_tput=self.decode_tput(),
            decode_round_cost=self.decode_round_cost(),
            spec_acceptance_rate=self.acceptance_rate(),
            spec_tokens_per_round=self.tokens_per_round(),
            swap_agg={"count": self.swap_agg.count,
                      "mean_exposed_cost_s": self.swap_agg.mean_cost,
                      "mean_hidden_fraction": self.swap_agg.mean_hidden_fraction},
            queue_wait_s=self.queue_wait.snapshot(),
            ttft_s=self.ttft.snapshot(),
            itl_s=self.itl.snapshot(),
        )
        return snap


def _sync(device: torch.device) -> None:
    """Wait for the work enqueued on the caller's current stream (the
    engine's), and for no other stream: on the disaggregated path the
    prefill pool's chunk computes on its own stream meanwhile."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def check_served_family(cfg: ModelConfig) -> None:
    """The JAX engine's refusal of a model of another family."""
    if cfg.family != "transformer":
        raise ValueError(f"{cfg.name} ({cfg.family}): serving engine drives the transformer family")


class ModelRunner:
    """Owns the phase programs, prompt buckets, the decode cache and slots."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        prompt_len: int = 32,
        mode: str = "pdswap",
        cache_layout: str = "contiguous",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        kv_dtype: str = "fp",
        overlap: bool = True,
        prefill_chunk: Optional[int] = None,
        spec_decode: Optional[int] = None,
        spec_ngram: int = 3,
        device=None,
    ):
        check_served_family(cfg)
        if mode not in ("pdswap", "static"):
            raise ValueError(f"mode must be 'pdswap' or 'static', got {mode!r}")
        if spec_decode == 0:
            spec_decode = None  # 0 = off, as the JAX package spells it
        if spec_decode is not None and spec_decode < 1:
            raise ValueError(f"spec_decode must be >= 1 (or 0/None = off), got {spec_decode}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if cache_layout == "paged" and prefill_chunk % block_size:
                raise ValueError(f"prefill_chunk ({prefill_chunk}) must be a multiple of "
                                 f"block_size ({block_size}): each chunk writes whole pages")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.mode = mode
        self.overlap = overlap and mode == "pdswap"
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.kv_dtype = kv_dtype
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.spec_decode = spec_decode
        self.spec_ngram = spec_ngram
        self.slots = KVSlotManager(n_slots, self.device)
        self.engine = PhaseEngine(cfg, cache_layout=cache_layout, kv_dtype=kv_dtype)
        self._bucket_progs: Dict[int, dict] = {}
        self._chunk_progs: Dict[tuple, object] = {}
        if cache_layout == "paged":
            if num_blocks is None:  # full provisioning: every slot can grow to max_len
                num_blocks = n_slots * cdiv(max_len, block_size)
            pool = T.init_paged_pool(cfg, num_blocks, block_size, kv_dtype=kv_dtype,
                                     device=self.device)
            self.paged: Optional[PagedKVCache] = PagedKVCache(
                pool, n_slots=n_slots, max_len=max_len, block_size=block_size)
            self.decode_prog = self.engine.paged_decode_program(n_slots, self.paged.max_pages)
            self.cache = None
        else:
            self.paged = None
            self.decode_prog = self.engine.decode_program(n_slots, max_len)
            self.cache = T.init_cache(cfg, n_slots, max_len, kv_dtype=kv_dtype, device=self.device)
        # the inputs of the captured programs, static and written in place
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._replay_in = StagedTensor((2, n_slots), torch.int32, self.device)  # tokens, lengths
        # Speculative decoding: one verify program of shape (n_slots, k + 1)
        # serves every round, the draft depth of each slot given by n_tokens.
        self.verify_prog = None
        if spec_decode is not None:
            w = spec_decode + 1
            self.verify_prog = (
                self.engine.paged_verify_program(n_slots, self.paged.max_pages, w)
                if self.paged is not None else self.engine.verify_program(n_slots, max_len, w))
            # a round's (B, W) block tokens, then its n_tokens column
            self._verify_in = StagedTensor((n_slots, w + 1), torch.int32, self.device)
            self._last_in = StagedTensor((n_slots,), torch.int32, self.device)
        self._side_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # Chunked prefill keeps an f32 mirror (L, 1, Hkv, Cap, D) of the
        # in-flight prompt's KV, so every chunk attends the values the
        # whole-prompt prefill would (see transformer._prefill_chunk_body);
        # one buffer, since one chunked prefill runs at a time.
        self.chunk_prefix: Optional[KVCache] = None
        self.chunk_cap = None
        if prefill_chunk is not None:
            self.chunk_cap = (cdiv(max_len, block_size) * block_size
                              if cache_layout == "paged" else max_len)
            shape = (cfg.num_layers, 1, cfg.num_kv_heads, self.chunk_cap, cfg.head_dim)
            self.chunk_prefix = KVCache(torch.zeros(shape, device=self.device),
                                        torch.zeros(shape, device=self.device))
            # a chunk's tokens, its page ids and (slot, prefix_len, last_pos)
            self._chunk_tokens = StagedTensor((1, self.chunk_cap), torch.int64, self.device)
            self._chunk_pages = StagedTensor((cdiv(self.chunk_cap, block_size),), torch.int32,
                                             self.device)
            self._chunk_scalars = StagedTensor((3,), torch.int32, self.device)
        # Per-slot sampling state on the device, written in place: set at
        # admission, and the step (the token index) before each sampled round.
        dev = self.device
        self._seeds = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._temps = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._top_ps = torch.ones((n_slots,), dtype=torch.float32, device=dev)
        self._steps_in = StagedTensor((n_slots,), torch.int32, dev)
        self._steps = self._steps_in.dev

    def bucket(self, n: int) -> int:
        """Prompt bucket for an n-token prompt (right-padded), the JAX
        package's: one quantum (``prompt_len``, or ``block_size`` when
        paged) steps up to 4 quanta, then quantum x powers of two.  Paged, it
        is clamped to max_len rounded up to whole pages (the page write
        needs whole pages); contiguous, to the largest quantum-aligned
        length <= max_len, a longer prompt taking max_len itself."""
        paged = self.paged is not None
        q = self.block_size if paged else self.prompt_len
        b = cdiv(n, q) * q
        if b > 4 * q:
            g = 4 * q
            while g < b:
                g *= 2
            b = g
        if paged:
            b = min(b, cdiv(self.max_len, q) * q)
        else:
            cap = self.max_len - self.max_len % q
            b = min(b, cap) if n <= cap else self.max_len
        return max(b, q)

    def progs(self, bucket: int) -> dict:
        """Phase programs for one prompt bucket, built once and cached."""
        if bucket not in self._bucket_progs:
            p: dict = {}
            if self.mode == "pdswap":
                p["body"], p["tail"] = self.engine.prefill_split_programs_varlen(1, bucket)
            else:
                p["full"] = self.engine.prefill_program_varlen(1, bucket)
            if self.paged is not None:
                p["write"] = self.engine.page_write_program(bucket, self.block_size)
            elif self.mode == "pdswap":
                p["relayout"] = self.engine.relayout_program(1, bucket, self.max_len)
            self._bucket_progs[bucket] = p
        return self._bucket_progs[bucket]

    def chunk_sizes(self, n: int) -> List[int]:
        """Real chunk sizes of an n-token prompt: full chunks, then the rest."""
        c = self.prefill_chunk
        return [c] * (n // c) + ([n % c] if n % c else [])

    def chunk_bucket(self, size: int, start: int) -> int:
        """A chunk's padded length: every full chunk shares one shape; the
        tail rounds up to the layout's quantum (a page, or ``prompt_len``
        capped by the chunk), clamped contiguous to ``max_len - start`` so
        that the install stays inside the cache."""
        c = self.prefill_chunk
        if size == c:
            return c
        if self.paged is not None:
            return cdiv(size, self.block_size) * self.block_size
        q = max(1, min(self.prompt_len, c))
        return max(min(cdiv(size, q) * q, self.max_len - start), size)

    def prefix_width(self, start: int) -> int:
        """The prefix a chunk starting at ``start`` attends: 0 for the first
        chunk, else the chunk size doubled until it covers ``start``,
        clamped to the mirror's capacity."""
        if start == 0:
            return 0
        g = self.prefill_chunk
        while g < start:
            g *= 2
        return min(g, self.chunk_cap)

    def chunk_prog(self, padded: int, prefix_width: int):
        key = (padded, prefix_width)
        if key not in self._chunk_progs:
            if self.paged is not None:
                prog = self.engine.paged_prefill_chunk_program(
                    padded, self.paged.max_pages, self.block_size, prefix_width)
            else:
                prog = self.engine.prefill_chunk_program(
                    padded, len(self.slots.slots), self.max_len, prefix_width)
            self._chunk_progs[key] = prog
        return self._chunk_progs[key]

    def run_prefill_chunk(self, req: Request, slot: int, start: int, size: int,
                          match: Optional[PrefixMatch], restarted: bool,
                          stats: EngineStats) -> torch.Tensor:
        """Run one chunk [start, start + size) of a request's prefill and
        install its KV (quantized on write).  Returns the chunk's
        last-token logits (1, Vp), which only the final chunk's caller uses
        (valid until the next chunk).  A restart's chunks are charged to
        ``t_replay``.  The chunk's tokens, pages and scalars go into static
        device tensors; its rows are checked here, since the program writes
        them at a device position."""
        padded = self.chunk_bucket(size, start)
        if start + padded > self.chunk_cap:
            raise ValueError(f"chunk rows [{start}, {start + padded}) overflow the cache's "
                             f"{self.chunk_cap} rows")
        prog = self.chunk_prog(padded, self.prefix_width(start))
        buf = np.zeros((1, self.chunk_cap), np.int64)
        buf[0, :size] = req.prompt[start:start + size]
        tokens = self._chunk_tokens.upload(buf)[:, :padded]
        scalars = self._chunk_scalars.upload([slot, start, size - 1])
        t0 = time.perf_counter()
        if self.paged is not None:
            # start is page-aligned; prefix-cache hits and padding pages
            # carry the skip id and are left out
            n_ids = padded // self.block_size
            ids = np.full(self._chunk_pages.dev.shape, self.paged.num_blocks, np.int32)
            ids[:n_ids] = self.paged.page_ids_for_write(
                match, n_ids, first_page=start // self.block_size).numpy()
            ids = self._chunk_pages.upload(ids)[:n_ids]
            logits, _, _ = prog(self.params, tokens, self.paged.kv, self.chunk_prefix, ids,
                                scalars[1], scalars[2])
        else:
            logits, _, _ = prog(self.params, tokens, self.cache, self.chunk_prefix, scalars[0],
                                scalars[1], scalars[2])
        _sync(self.device)
        t1 = time.perf_counter()
        if restarted:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
        stats.prefill_chunks += 1
        if TRACER.enabled:
            TRACER.complete("prefill.chunk", t0, t1, request_id=req.request_id, start=start,
                            size=size)
        return logits

    # ---------------------------------------------------- the serving grid --

    def reachable_buckets(self) -> List[int]:
        """Every prompt bucket a prompt of 1..max_len tokens can take."""
        return sorted({self.bucket(n) for n in range(1, self.max_len + 1)})

    def reachable_chunk_shapes(self) -> List[tuple]:
        """Every (padded chunk length, prefix width) pair chunked prefill
        can ask for, over prompts of 1..max_len tokens."""
        if self.prefill_chunk is None:
            return []
        shapes = set()
        for n in range(1, self.max_len + 1):
            start = 0
            for size in self.chunk_sizes(n):
                shapes.add((self.chunk_bucket(size, start), self.prefix_width(start)))
                start += size
        return sorted(shapes)

    def build_serving_grid(self) -> None:
        """Build every program the serving grid can reach: each bucket's
        prefill and swap programs, each chunk shape's program, the samplers
        (the decode and verify programs exist from the start).  On a card, also run
        each capturable program once on idle inputs, which warms it up and
        captures its graph, so that no capture lands inside a served
        request.  Call it before serving: the idle runs write rows no live
        request owns only while there is none."""
        if self.slots.active_slots():
            raise RuntimeError("build the serving grid before any request is admitted")
        for b in self.reachable_buckets():
            self.progs(b)
        shapes = self.reachable_chunk_shapes()
        for padded, pw in shapes:
            self.chunk_prog(padded, pw)
        self._build_decode_grid()
        if self.device.type == "cuda":
            self._capture_chunk_programs(shapes)
        _sync(self.device)

    def _build_decode_grid(self) -> None:
        """The samplers built and, on a card, the decode, sampler and verify
        programs run once on idle inputs (warm-up and capture)."""
        n = len(self.slots.slots)
        samplers = [self.engine.sampler_program(n), self.engine.sampler_program(1)]
        if self.spec_decode is not None:
            block_sampler = self.engine.block_sampler_program(n, self.spec_decode + 1)
        if self.device.type != "cuda":
            return
        idle = self.slots.lengths_array({s: 0 for s in range(n)})
        logits = self._decode(self.last_tokens, idle)  # contiguous: row 0 of every free slot
        for prog, b in zip(samplers, (n, 1)):
            prog(torch.zeros_like(logits[:b]), self._seeds[:b], self._steps[:b], self._temps[:b],
                 self._top_ks[:b], self._top_ps[:b])
        if self.spec_decode is not None:  # n_tokens all 0: no row is written
            logits = self._verify(np.zeros((n, self.spec_decode + 1), np.int32),
                                  np.zeros((n,), np.int32), idle)
            block_sampler(torch.zeros_like(logits), self._seeds, self._steps, self._temps,
                          self._top_ks, self._top_ps)

    def _capture_chunk_programs(self, shapes) -> None:
        """Each chunk shape's program run once on idle inputs (a card only)."""
        if shapes:
            scalars = self._chunk_scalars.upload([0, 0, 0])
            if self.paged is not None:  # every page id the skip id: no page is written
                self._chunk_pages.upload(self.paged.num_blocks)
        for padded, pw in shapes:  # slot 0's rows [0, padded): no live request reads them
            tokens = self._chunk_tokens.dev[:, :padded]
            if self.paged is not None:
                ids = self._chunk_pages.dev[:padded // self.block_size]
                self.chunk_prog(padded, pw)(self.params, tokens, self.paged.kv, self.chunk_prefix,
                                            ids, scalars[1], scalars[2])
            else:
                self.chunk_prog(padded, pw)(self.params, tokens, self.cache, self.chunk_prefix,
                                            scalars[0], scalars[1], scalars[2])

    def restart_headroom_ok(self, req: Request) -> bool:
        """Admit a restart only when the pool can hold its whole replayed
        state (prompt + tokens already generated); otherwise two restarts
        can evict each other during replay for ever."""
        need = cdiv(len(req.prompt) + len(req.out_tokens) - 1, self.block_size)
        return self.paged.pool.num_free >= need

    def prefill(self, req: Request, slot: int, stats: EngineStats,
                resuming: bool = False) -> torch.Tensor:
        """Prefill one admitted request and install its KV into the decode
        cache or its pages (the swap, overlapped in pdswap mode).  Returns
        the prompt's last-token logits (1, Vp).  Raises ``PoolExhausted``,
        with the pool rolled back, when the pages do not fit.  A restart
        (``resuming``) is charged to ``t_replay``, not to the offered load."""
        n = len(req.prompt)
        bucket = self.bucket(n)
        progs = self.progs(bucket)
        match = None
        if self.paged is not None:
            match = self.paged.allocate_prompt(slot, np.asarray(req.prompt, np.int32))
            if not resuming:
                n_full = n // self.block_size
                stats.prefix_hits += match.cached_pages
                stats.prefix_misses += n_full - match.cached_pages
                stats.prefix_hit_tokens += match.cached_pages * self.block_size
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        tokens = torch.from_numpy(padded).to(self.device)
        last_pos = n - 1

        def swap_write(kv):
            if self.paged is not None:
                ids = self.paged.page_ids_for_write(match, bucket // self.block_size)
                return progs["write"].fn(self.paged.kv, kv, ids)
            if self.mode == "pdswap":
                return progs["relayout"].fn(kv, self.cache, slot)
            return insert_prefill_kv(self.cache, kv, slot)

        t0 = time.perf_counter()
        if self.mode == "pdswap":
            ctl = SwapController(progs["body"].fn,
                                 lambda p, x: progs["tail"].fn(p, x, last_pos),
                                 swap_write, side_stream=self._side_stream)
            logits, _, timing = ctl.prefill_and_swap(self.params, tokens, overlap=self.overlap)
            if not resuming:
                stats.record_swap(timing)
            if TRACER.enabled:
                TRACER.instant("swap", request_id=req.request_id, t_relayout=timing.t_relayout,
                               hidden_fraction=timing.hidden_fraction)
        else:
            logits, kv = progs["full"].fn(self.params, tokens, last_pos)
            swap_write(kv)
            _sync(self.device)
        t1 = time.perf_counter()
        if resuming:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
            stats.prefill_tokens += n
        if TRACER.enabled:
            TRACER.complete("prefill", t0, t1, request_id=req.request_id, tokens=n,
                            resuming=resuming)
        if match is not None:
            self.paged.register_prompt_pages(match)
        return logits

    def decode_logits(self, lengths: torch.Tensor) -> torch.Tensor:
        """One decode round of ``last_tokens``; updates the cache in place,
        returns (B, Vp) logits (valid until the next round)."""
        return self._decode(self.last_tokens, lengths)

    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.paged is not None:
            logits, _ = self.decode_prog(self.params, tokens, self.paged.kv,
                                         self.paged.block_tables_array(), lengths)
        else:
            logits, _ = self.decode_prog(self.params, tokens, self.cache, lengths)
        return logits

    # ------------------------------------------------ speculative decoding --

    def draft_for(self, req: Request, slot: int) -> np.ndarray:
        """The prompt-lookup draft of one decoding slot, its depth
        ``spec_decode`` clamped to the slot's headroom: at most ``max_new -
        generated - 1`` drafts are useful (the round's last emitted token
        never becomes an input, so its KV is never needed), and live verify
        rows stay at or below ``max_len - 2``, since row ``max_len - 1`` is
        the parked-write row that live KV never occupies.  With the budget
        clamp the deepest paged write is position ``prompt + max_new - 2``,
        inside the pages the admission check reserved."""
        s = self.slots.slots[slot]
        k = min(self.spec_decode, req.max_new - s.generated - 1, self.max_len - 2 - s.length)
        if k <= 0:
            return np.zeros((0,), np.int32)
        ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                              np.asarray(req.out_tokens, np.int32)])
        return find_draft(ctx, k, self.spec_ngram)

    def _verify(self, tokens: np.ndarray, n_tokens: np.ndarray,
                lengths: torch.Tensor) -> torch.Tensor:
        w = tokens.shape[1]
        staged = self._verify_in.upload(np.concatenate([tokens, n_tokens[:, None]], axis=1))
        if self.paged is not None:
            logits, _ = self.verify_prog(self.params, staged[:, :w], self.paged.kv,
                                         self.paged.block_tables_array(), lengths, staged[:, w])
        else:
            logits, _ = self.verify_prog(self.params, staged[:, :w], self.cache, lengths,
                                         staged[:, w])
        return logits

    def run_verify(self, tokens: np.ndarray, n_tokens: np.ndarray) -> torch.Tensor:
        """One verify pass: score every slot's block ``tokens`` (B, W) in one
        forward and install its rows ``i < n_tokens[b]`` in place (quantized
        on write).  Returns the (B, W, Vp) logits, the per-position targets'
        (valid until the next round)."""
        return self._verify(tokens, n_tokens, self.slots.lengths_array())

    def rollback_overshoot(self, slot: int, length: int) -> None:
        """Roll rejected verify rows back.  Contiguous: nothing to do, the
        rows past the slot length are never read and are rewritten before
        the length passes them.  Paged: the overshoot pages go home, so a
        rejection holds no pool capacity (or copy-on-write fork) across
        rounds."""
        if self.paged is not None:
            self.paged.truncate_slot(slot, length)

    def select_targets(self, logits: torch.Tensor, inflight: Dict[int, Request]) -> torch.Tensor:
        """The verify targets, (B, W) on the device: what sequential decode
        would draw at each block position.  An all-greedy batch takes the
        argmax; otherwise the block sampler, position i of slot s drawing
        token ``len(out_tokens) + i`` with the sequential stream's key."""
        if all(r.params.greedy for r in inflight.values()):
            return torch.argmax(logits, dim=-1)
        steps = np.zeros((len(self.slots.slots),), np.int32)
        for s, r in inflight.items():
            steps[s] = len(r.out_tokens)
        self._steps_in.upload(steps)
        prog = self.engine.block_sampler_program(len(self.slots.slots), logits.shape[1])
        return prog(logits, self._seeds, self._steps, self._temps, self._top_ks, self._top_ps)

    def set_last_tokens(self, tokens: np.ndarray) -> None:
        """Write every slot's last token (the next round's input) in place."""
        self.last_tokens.copy_(self._last_in.upload(tokens))

    def append_page(self, slot: int, length: int) -> None:
        """Make position ``length`` writable, forking a shared page.  The
        fork copies every plane of the page, the scale rows included.
        Raises ``PoolExhausted`` when the pool cannot grow."""
        copy = self.paged.ensure_append_page(slot, length)
        if copy is not None:
            dst, src = copy
            for leaf in self.paged.kv:
                for t in (leaf if isinstance(leaf, QuantKV) else (leaf,)):
                    t[dst].copy_(t[src])

    def replay(self, slot: int, req: Request, stats: EngineStats) -> bool:
        """Teacher-force a restart's recorded tokens through the decode
        program, every other slot at length 0 (its pages untouched), which
        rebuilds the evicted cache bytes.  Returns False if the pool is
        short anyway (the admission headroom check reserved the pages); the
        caller backs off."""
        p = len(req.prompt)
        n_slots = len(self.slots.slots)
        t0 = time.perf_counter()
        for j, tok in enumerate(req.out_tokens[:-1]):
            pos = p + j
            try:
                copy = self.paged.ensure_append_page(slot, pos)
            except PoolExhausted:
                return False
            assert copy is None  # replay appends past the prompt: no fork
            step = np.zeros((2, n_slots), np.int32)
            step[:, slot] = tok, pos
            inputs = self._replay_in.upload(step)
            self._decode(inputs[0], inputs[1])
            stats.replayed_tokens += 1
        _sync(self.device)
        t1 = time.perf_counter()
        stats.t_replay += t1 - t0
        if TRACER.enabled:
            TRACER.complete("replay", t0, t1, request_id=req.request_id,
                            tokens=max(len(req.out_tokens) - 1, 0))
        return True

    def release(self, slot: int) -> None:
        self.slots.release(slot)
        if self.paged is not None:
            self.paged.release_slot(slot)

    def kv_bytes(self) -> dict:
        """KV memory: bytes reserved up front, the peak backing live tokens,
        and the packed payload alone (scale planes excluded)."""
        if self.paged is not None:
            return {"allocated": self.paged.pool_bytes(),
                    "peak_in_use": self.paged.peak_live_pages * self.paged.page_bytes(),
                    "page_bytes": self.paged.page_bytes(),
                    "payload": self.paged.num_blocks * self.paged.page_payload_bytes(),
                    "kv_dtype": self.kv_dtype}
        nbytes = total_nbytes(self.cache)
        return {"allocated": nbytes, "peak_in_use": nbytes, "page_bytes": 0,
                "payload": payload_bytes(self.cache), "kv_dtype": self.kv_dtype}

    def set_slot_sampling(self, slot: int, req: Request) -> None:
        p = req.params
        self._seeds[slot] = p.seed32
        self._temps[slot] = p.temperature
        self._top_ks[slot] = p.top_k
        self._top_ps[slot] = p.top_p

    def sample_batch(self, logits: torch.Tensor, inflight: Dict[int, Request]) -> torch.Tensor:
        """Next token for every slot, (B,) int32, on the device.  An
        all-greedy batch takes the argmax (first max on ties); otherwise the
        whole batch goes through the sampler program, greedy slots taking
        the argmax inside it, slot i drawing its token ``len(out_tokens)``."""
        if all(r.params.greedy for r in inflight.values()):
            return torch.argmax(logits, dim=-1)  # one launch after the decode program
        steps = np.zeros((len(self.slots.slots),), np.int32)
        for s, r in inflight.items():
            steps[s] = len(r.out_tokens)
        self._steps_in.upload(steps)
        prog = self.engine.sampler_program(len(self.slots.slots))
        return prog(logits, self._seeds, self._steps, self._temps, self._top_ks, self._top_ps)

    def sample_first(self, logits: torch.Tensor, slot: int, req: Request) -> int:
        """The prompt's first generated token, from the prefill logits,
        drawn with the slot's sampling state (``sampler:1`` on views of the
        per-slot tensors)."""
        if req.params.greedy:
            return int(torch.argmax(logits[0]))
        one = slice(slot, slot + 1)
        self._steps[one].fill_(len(req.out_tokens))
        tok = self.engine.sampler_program(1)(logits[:1], self._seeds[one], self._steps[one],
                                             self._temps[one], self._top_ks[one], self._top_ps[one])
        return int(tok[0])


class Scheduler:
    """Admission, the wait queue, and the swap decision."""

    def __init__(self, runner: ModelRunner, policy: SwapPolicy):
        self.runner = runner
        self.policy = policy
        # weighted fair over tenants; with one tenant exactly FIFO, a
        # requeued request (blocked, preempted) going back to the head
        self.queue = WeightedFairQueue()
        self.inflight: Dict[int, Request] = {}

    def validate(self, request: Request) -> None:
        if request.params.max_tokens is not None:
            request.max_new = request.params.max_tokens
        n = int(len(request.prompt))
        if n < 1:
            raise ValueError(f"{request.request_id}: empty prompt")
        if n + request.max_new > self.runner.max_len:
            raise ValueError(
                f"{request.request_id}: prompt ({n} tokens) + max_new ({request.max_new}) "
                f"exceeds max_len={self.runner.max_len}; prompts are never truncated")
        paged = self.runner.paged
        if paged is not None:
            traj = cdiv(n + request.max_new - 1, self.runner.block_size)
            if traj > paged.num_blocks:
                raise ValueError(
                    f"{request.request_id}: needs {traj} KV pages over its lifetime but the "
                    f"pool holds {paged.num_blocks}; raise num_blocks or lower max_new")

    def submit(self, request: Request) -> None:
        self.validate(request)
        now = time.perf_counter()
        if request.arrival_time_s == 0.0:
            request.arrival_time_s = now
        request.enqueue_t = now
        self.queue.append(request)
        if TRACER.enabled:
            TRACER.instant("req.submit", request_id=request.request_id, tenant=request.tenant)

    def requeue_head(self, request: Request) -> None:
        self.queue.appendleft(request)

    def remove_queued(self, request_id: str) -> Optional[Request]:
        """Take a request out of the wait queue (abort); None if not queued."""
        return self.queue.remove(request_id)

    def enter_prefill_phase(self, stats: EngineStats, *, pending_chunks: int = 0) -> bool:
        """The swap decision; an empty decoding set always flips.  Under
        chunked prefill ``pending_chunks`` tells the policy how many chunks
        the partially prefilled request still owes."""
        active = len(self.inflight)
        if active == 0:
            return True
        head = self.queue.peek()
        view = SchedulerView(
            queue_depth=len(self.queue),
            free_slots=len(self.runner.slots.free_slots()),
            active_slots=active,
            swap_cost=stats.swap_agg.mean_cost,
            decode_round_cost=stats.decode_round_cost(),
            pending_chunks=pending_chunks,
            oldest_wait_s=(time.perf_counter() - head.arrival_time_s
                           if head is not None and head.arrival_time_s else 0.0),
        )
        return self.policy.should_prefill(view)

    def pick_victim(self) -> Optional[int]:
        """The lowest-priority decoding slot, ties broken youngest first."""
        if not self.inflight:
            return None
        return min(self.inflight,
                   key=lambda s: (self.inflight[s].priority, -self.inflight[s].enqueue_t))

    def preempt(self, slot: int, stats: EngineStats) -> None:
        """Evict one request: free its pages and requeue it at the head for a
        restart (re-prefill the prompt, replay the generated tokens)."""
        req = self.inflight.pop(slot)
        req.preempted = True
        self.runner.release(slot)
        stats.preemptions += 1
        self.queue.appendleft(req)
        if TRACER.enabled:
            TRACER.instant("req.preempt", request_id=req.request_id, slot=slot)


class EngineCore:
    """The incremental serving core; one ``step()`` = one scheduling quantum.
    Runs on CUDA unless ``device`` says otherwise; params must lie on that
    device (``models.transformer.init`` + ``convert_for_inference``, or
    ``interop.params_from_numpy``)."""

    # The runner to build: the one seam a subclass changes to move what is
    # built and where it runs while keeping every scheduling, preemption,
    # chunking and speculative path (the disaggregated engine's runner
    # prefills on a separate pool: serving.disagg).
    runner_cls = ModelRunner

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        prompt_len: int = 32,
        mode: str = "pdswap",
        cache_layout: str = "contiguous",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        kv_dtype: str = "fp",
        overlap: bool = True,
        swap_policy: Union[SwapPolicy, str, None] = None,
        prefill_chunk: Optional[int] = None,
        spec_decode: Optional[int] = None,  # draft depth k (None/0: speculation off)
        spec_ngram: int = 3,  # the drafter's n-gram size
        device=None,
    ):
        self.cfg = cfg
        self.runner = self.runner_cls(
            cfg, params, n_slots=n_slots, max_len=max_len, prompt_len=prompt_len,
            mode=mode, cache_layout=cache_layout, block_size=block_size, num_blocks=num_blocks,
            kv_dtype=kv_dtype, overlap=overlap, prefill_chunk=prefill_chunk,
            spec_decode=spec_decode, spec_ngram=spec_ngram, device=device)
        # slot -> the partially prefilled request (chunked prefill); in
        # admission order
        self._prefilling: Dict[int, PrefillProgress] = {}
        if swap_policy is None:
            swap_policy = DrainPolicy()
        elif isinstance(swap_policy, str):
            swap_policy = make_policy(swap_policy)
        self.scheduler = Scheduler(self.runner, swap_policy)
        self.stats = EngineStats()
        # a policy that observes the latencies (slo-aware) reads these stats
        swap_policy.bind(self.stats)
        self.out_proc = OutputProcessor(stats=self.stats)
        self.finished: Dict[str, Request] = {}
        self._metrics_registry = None
        self._gen_seq = 0

    @property
    def device(self) -> torch.device:
        return self.runner.device

    def submit(self, request: Request) -> None:
        self.scheduler.submit(request)

    def has_unfinished(self) -> bool:
        return bool(self.scheduler.queue or self.runner.slots.active_slots())

    def abort(self, request_id: str) -> Optional[RequestOutput]:
        """Cancel a request wherever it is — queued, part-way through a
        chunked prefill, or decoding — and release its slot and pages
        (shared prefix pages only lose a reference).  Returns the terminal
        zero-delta output (``finish_reason="abort"``), or None when the id
        is unknown or already finished.  Call between steps."""
        req = self.scheduler.remove_queued(request_id)
        if req is None:
            for slot, prog in list(self._prefilling.items()):
                if prog.req.request_id == request_id:
                    del self._prefilling[slot]
                    self.runner.release(slot)
                    req = prog.req
                    break
        if req is None:
            for slot, r in list(self.scheduler.inflight.items()):
                if r.request_id == request_id:
                    self.scheduler.inflight.pop(slot)
                    self.runner.release(slot)
                    req = r
                    break
        if req is None:
            return None
        self.stats.aborts += 1
        if TRACER.enabled:
            TRACER.instant("req.abort", request_id=request_id)
        out = self.out_proc.finalize_aborted(req)
        self.finished[req.request_id] = req
        return out

    def snapshot(self) -> dict:
        """The stats block the benchmarks and ``GET /stats`` report
        (``obs.engine.engine_snapshot``): ``EngineStats.snapshot()``, KV
        accounting, the tenants' lanes, roofline drift on the port's card,
        and ``snapshot_sections()``.  Host state and tensor shapes only."""
        return engine_snapshot(self)

    def snapshot_sections(self) -> dict:
        """Extra top-level sections of ``snapshot()`` for a subclass to add."""
        return {}

    def metrics_registry(self):
        """The typed metrics registry over this engine, built once (every
        metric is a live view: ``obs.engine.engine_registry``)."""
        if self._metrics_registry is None:
            self._metrics_registry = engine_registry(self)
        return self._metrics_registry

    def snapshot_v2(self) -> dict:
        """``{"schema": "v2", counters, gauges, histograms}``: the numbers
        ``GET /metrics`` serves."""
        return snapshot_v2(self, registry=self.metrics_registry())

    def reset_stats(self) -> None:
        """Fresh ``EngineStats`` (e.g. after a warm-up pass), bound to the
        output processor and to a policy that observes them."""
        self.stats = EngineStats()
        self.out_proc = OutputProcessor(stats=self.stats)
        policy = self.scheduler.policy
        policy.bind(self.stats)
        policy.reset()

    def kv_bytes(self) -> dict:
        return self.runner.kv_bytes()

    def build_serving_grid(self) -> None:
        """``ModelRunner.build_serving_grid``: every reachable program built
        and, on a card, captured; the stats are reset after it."""
        self.runner.build_serving_grid()
        self.reset_stats()

    def step(self) -> List[RequestOutput]:
        """Advance one scheduling quantum, then run one decode round over
        the decoding slots.  Monolithic prefill: a policy-gated burst
        admitting queued requests into free slots, one swap each (paged, an
        admission the pool cannot hold stops the burst).  Chunked prefill:
        at most one chunk — the partially prefilled request's next, else the
        queue head's first — so decode rounds run between the chunks; the
        policy's ``prefill_quanta`` may grant several back to back.  First
        the policy's ``should_shed`` drops the queue heads that can no
        longer meet their TTFT target (``finish_reason="shed"``)."""
        t_step0 = time.perf_counter() if TRACER.enabled else 0.0
        outs: List[RequestOutput] = []
        sched, runner = self.scheduler, self.runner
        now = time.perf_counter()
        while sched.queue:
            head = sched.queue[0]  # the request popleft returns (fair_queue.peek)
            if head.out_tokens or head.preempted:
                break  # a restart awaiting replay is no new admission
            wait = (now - head.arrival_time_s) if head.arrival_time_s else 0.0
            if not sched.policy.should_shed(wait):
                break
            sched.queue.popleft()
            self.stats.sheds += 1
            if TRACER.enabled:
                TRACER.instant("req.shed", request_id=head.request_id, wait_s=wait)
            outs.append(self.out_proc.finalize_dropped(head, "shed"))
            self.finished[head.request_id] = head
        if runner.prefill_chunk is not None:
            ran = 0
            while True:
                before = self.stats.prefill_chunks
                outs.extend(self._chunked_prefill_quantum())
                if self.stats.prefill_chunks == before:
                    break  # deferred, blocked, or no prefill pending
                ran += 1
                # asked after each chunk: that chunk's should_prefill saw the
                # current decode set
                if ran >= max(1, int(sched.policy.prefill_quanta())):
                    break
        elif sched.queue and runner.slots.free_slots() and sched.enter_prefill_phase(self.stats):
            admitted = 0
            while sched.queue and runner.slots.free_slots():
                ok, out = self._admit_one(sched.queue.popleft())
                if out is not None:
                    outs.append(out)
                if not ok:
                    if not runner.slots.active_slots():
                        self._unblock_admission_or_raise()
                    break  # decode to drain capacity, then retry admission
                admitted += 1
            if admitted:
                self.stats.prefill_bursts += 1
        if sched.inflight:
            outs.extend(self._decode_round())
        if not self.has_unfinished():
            sched.policy.reset()
        if TRACER.enabled and t_step0:
            TRACER.complete("engine.step", t_step0, time.perf_counter(), outputs=len(outs))
        return outs

    def run(self, max_rounds: int = 10_000) -> EngineStats:
        """Step until every submitted request has finished."""
        rounds = 0
        while self.has_unfinished() and rounds < max_rounds:
            rounds += 1
            self.step()
        return self.stats

    def generate(self, prompt, params: Optional[SamplingParams] = None, *,
                 request_id: Optional[str] = None, max_new: Optional[int] = None,
                 priority: int = 0, max_steps: int = 10_000) -> Iterator[RequestOutput]:
        """Submit one request and stream its outputs as they are produced.

        Unbudgeted (no ``max_new``, no ``params.max_tokens``), the request
        gets its slot's headroom, clamped under the paged layout to what
        the pool can hold over its lifetime, as the JAX ``generate``: an
        unbudgeted request degrades to a shorter stream, it does not raise."""
        if params is None:
            params = SamplingParams()
        prompt = np.asarray(prompt, np.int32)
        if max_new is None:
            if params.max_tokens is not None:
                max_new = params.max_tokens  # submit() applies the override
            else:
                max_new = self.runner.max_len - len(prompt)
                if self.runner.paged is not None:
                    pool_tokens = self.runner.paged.num_blocks * self.runner.block_size
                    max_new = min(max_new, pool_tokens - len(prompt) + 1)
                max_new = max(1, max_new)
        self._gen_seq += 1
        rid = request_id or f"gen-{self._gen_seq}"
        self.submit(Request(rid, prompt, max_new=max_new, priority=priority, params=params))
        for _ in range(max_steps):
            for out in self.step():
                if out.request_id == rid:
                    yield out
                    if out.finished:
                        return
        raise RuntimeError(f"{rid} did not finish within {max_steps} steps")

    def _unblock_admission_or_raise(self) -> None:
        """The queue head failed admission with no slot decoding, so no
        capacity drains on its own: shed every cached refcount-0 page and
        let the next step retry, or raise when there is none to shed."""
        runner = self.runner
        if runner.paged is not None and runner.paged.pool.evict_all_cached():
            return
        head = self.scheduler.queue[0]
        raise RuntimeError(f"{head.request_id} can never be admitted: needs more pages than the "
                           f"pool holds ({runner.paged.num_blocks} blocks x "
                           f"{runner.block_size} tokens)")

    # ------------------------------------------------------ chunked prefill --

    def _pending_chunks(self) -> int:
        return sum(p.remaining_chunks for p in self._prefilling.values())

    def _chunked_prefill_quantum(self) -> List[RequestOutput]:
        """At most one chunk, policy-gated: continue the partially prefilled
        request, or, with none, admit the queue head and run its first
        chunk.  Each chunk is one fabric flip (``prefill_bursts``)."""
        sched, runner = self.scheduler, self.runner
        if self._prefilling:
            if not sched.enter_prefill_phase(self.stats, pending_chunks=self._pending_chunks()):
                return []
            return self._advance_chunk(next(iter(self._prefilling.values())))
        if not (sched.queue and runner.slots.free_slots()):
            return []
        if not sched.enter_prefill_phase(self.stats):
            return []
        ok, outs = self._admit_one_chunked(sched.queue.popleft())
        if not ok and not sched.inflight:
            self._unblock_admission_or_raise()
        return outs

    def _admit_one_chunked(self, req: Request):
        """Take a slot (and, paged, every page of the prompt, so that the
        chunks write into a fixed plan), then run the first chunk.  Returns
        ``(ok, outputs)`` with ``_admit_one``'s contract."""
        runner, stats = self.runner, self.stats
        out = self._finish_resumed_at_budget(req)
        if out is not None:
            return True, [out]
        resuming = req.preempted and bool(req.out_tokens)
        restarted = req.preempted  # a mid-prefill eviction restarts with no tokens
        if runner.paged is not None and resuming and not runner.restart_headroom_ok(req):
            self._block_admission(req)
            return False, []
        slot = runner.slots.assign(req.request_id, len(req.prompt))
        runner.set_slot_sampling(slot, req)
        match = None
        if runner.paged is not None:
            try:
                match = runner.paged.allocate_prompt(slot, np.asarray(req.prompt, np.int32))
            except PoolExhausted:
                self._block_admission(req, slot)
                return False, []
            if not restarted:
                n_full = len(req.prompt) // runner.block_size
                stats.prefix_hits += match.cached_pages
                stats.prefix_misses += n_full - match.cached_pages
                stats.prefix_hit_tokens += match.cached_pages * runner.block_size
        if not restarted:  # offered load, charged once: one logical swap a request
            stats.prefill_tokens += len(req.prompt)
            stats.swaps += 1
        self._record_admission(req)
        # the f32 mirror holds one prompt: one chunked prefill at a time
        if self._prefilling:
            raise RuntimeError("a second chunked prefill while one is in flight")
        prog = PrefillProgress(req, slot, resuming, restarted,
                               sizes=runner.chunk_sizes(len(req.prompt)), match=match)
        self._prefilling[slot] = prog
        return True, self._advance_chunk(prog)

    def _advance_chunk(self, prog: PrefillProgress) -> List[RequestOutput]:
        """Run one chunk; after the last, finish the prefill (first token or
        replay) and hand the slot to the decode rounds."""
        size = prog.sizes[prog.ci]
        logits = self.runner.run_prefill_chunk(prog.req, prog.slot, prog.pos, size, prog.match,
                                               prog.restarted, self.stats)
        prog.ci += 1
        prog.pos += size
        self.stats.prefill_bursts += 1
        if prog.ci < len(prog.sizes):
            return []
        del self._prefilling[prog.slot]
        if self.runner.paged is not None:
            self.runner.paged.register_prompt_pages(prog.match)
        _, out = self._finish_prefill(prog.req, prog.slot, logits, prog.resuming)
        return [out] if out is not None else []

    def _preempt_prefilling(self, slot: int) -> None:
        """Evict a partially prefilled request (decode growth exhausted the
        pool with no decoding request left to evict): requeue it for a
        restart through the same chunks."""
        prog = self._prefilling.pop(slot)
        prog.req.preempted = True
        self.runner.release(slot)
        self.stats.preemptions += 1
        self.scheduler.queue.appendleft(prog.req)
        if TRACER.enabled:
            TRACER.instant("req.preempt", request_id=prog.req.request_id, slot=slot,
                           mid_prefill=True)

    # ----------------------------------------------------------- admission --

    def _finish_resumed_at_budget(self, req: Request) -> Optional[RequestOutput]:
        """A restart whose recorded tokens already fill its budget has
        nothing left to generate: finish it before it takes a slot."""
        if not (req.preempted and req.out_tokens and len(req.out_tokens) >= req.max_new):
            return None
        req.preempted = False
        out = self.out_proc.finalize_resumed(req)
        self.finished[req.request_id] = req
        return out

    def _admit_one(self, req: Request):
        """Admit one request into a slot.  Returns ``(ok, output)``;
        ``ok=False`` means the pool could not hold it: it went back to the
        queue head and the engine decodes to drain capacity first."""
        runner = self.runner
        out = self._finish_resumed_at_budget(req)
        if out is not None:
            return True, out
        resuming = req.preempted and bool(req.out_tokens)
        if runner.paged is not None and resuming and not runner.restart_headroom_ok(req):
            self._block_admission(req)
            return False, None
        slot = runner.slots.assign(req.request_id, len(req.prompt))
        runner.set_slot_sampling(slot, req)
        try:
            logits = runner.prefill(req, slot, self.stats, resuming=resuming)
        except PoolExhausted:
            self._block_admission(req, slot)
            return False, None
        self._record_admission(req)
        return self._finish_prefill(req, slot, logits, resuming)

    def _record_admission(self, req: Request) -> None:
        """Stamp the queue wait (arrival to first successful admission) once
        a request: a restart keeps its first stamp."""
        if req.queue_wait_s is None and req.arrival_time_s:
            req.queue_wait_s = time.perf_counter() - req.arrival_time_s
            self.stats.queue_wait.record(req.queue_wait_s)
            self.stats.tenant_queue_wait.setdefault(req.tenant, LatencyStat()).record(
                req.queue_wait_s)
            if TRACER.enabled:
                TRACER.instant("req.admit", request_id=req.request_id,
                               queue_wait_s=req.queue_wait_s)

    def _block_admission(self, req: Request, slot: Optional[int] = None) -> None:
        """An admission blocked on pool pressure: give the slot back (if one
        was taken), count the block, requeue the request at the head."""
        if slot is not None:
            self.runner.release(slot)
        self.stats.admission_blocks += 1
        self.scheduler.requeue_head(req)

    def _finish_prefill(self, req: Request, slot: int, logits, resuming: bool = False):
        """After the prefill: a restart replays its recorded tokens; a new
        request (or one evicted mid-prefill) draws its first token.  Then
        the request either finishes or its slot joins the decode rounds.
        Returns ``(ok, output)``."""
        runner = self.runner
        out = None
        if resuming:
            if not runner.replay(slot, req, self.stats):
                self._block_admission(req, slot)
                return False, None
            req.preempted = False
            tok = req.out_tokens[-1]
            runner.slots.slots[slot].length = len(req.prompt) + len(req.out_tokens) - 1
            runner.slots.slots[slot].generated = len(req.out_tokens)
        else:
            req.preempted = False
            tok = runner.sample_first(logits, slot, req)
            out = self.out_proc.process_token(req, tok)
            runner.slots.slots[slot].generated = 1
        finished = out.finished if out is not None else (
            runner.slots.slots[slot].generated >= req.max_new)
        if finished:
            if out is None:
                out = self.out_proc.finalize_resumed(req)
            self.finished[req.request_id] = req
            runner.release(slot)
            return True, out
        runner.last_tokens[slot] = tok
        self.scheduler.inflight[slot] = req
        return True, out

    # --------------------------------------------------------------- decode --

    def _grow_slot_page(self, slot: int, length: int) -> None:
        """Make position ``length`` writable, preempting under pool
        pressure: the lowest-priority decoding request, else a partially
        prefilled one."""
        while True:
            try:
                self.runner.append_page(slot, length)
                return
            except PoolExhausted:
                victim = self.scheduler.pick_victim()
                if victim is None:
                    if self._prefilling:
                        self._preempt_prefilling(min(self._prefilling, key=lambda s: (
                            self._prefilling[s].req.priority, -self._prefilling[s].req.enqueue_t)))
                        continue
                    raise RuntimeError(
                        "paged KV pool exhausted with nothing left to preempt; "
                        f"raise num_blocks (have {self.runner.paged.num_blocks})")
                self.scheduler.preempt(victim, self.stats)
                if victim == slot:
                    return  # this very slot was evicted; the round skips it

    def _ensure_append_pages(self) -> None:
        """Before a decode round, make every decoding slot's next position
        writable: grow tables at page boundaries and fork shared pages,
        preempting when the pool cannot.  Mid-prefill slots hold their
        pages already and sit the round out."""
        for slot in self.runner.slots.active_slots():
            s = self.runner.slots.slots[slot]
            if s.request_id is None or slot in self._prefilling:
                continue
            self._grow_slot_page(slot, s.length)

    def _decode_round(self) -> List[RequestOutput]:
        runner, stats, sched = self.runner, self.stats, self.scheduler
        if runner.spec_decode is not None:
            # the host's prompt lookup first: with a draft anywhere the round
            # is a verify pass; with none, plain decode emits the same one
            # token a slot for a k + 1-th of the work
            drafts = {slot: runner.draft_for(sched.inflight[slot], slot)
                      for slot in sorted(sched.inflight)}
            if any(len(d) for d in drafts.values()):
                return self._verify_round(drafts)
        if runner.paged is not None:
            self._ensure_append_pages()
        active = sorted(sched.inflight)
        if not active:
            return []
        # A mid-prefill slot sits the round out, but the batched program
        # still writes a row for it: park that write where nothing reads it.
        # Paged, length 0 writes nothing; contiguous, the write clamps to row
        # max_len - 1, which live KV never reaches (n + max_new <= max_len).
        park = 0 if runner.paged is not None else runner.max_len
        lengths = runner.slots.lengths_array({slot: park for slot in self._prefilling})
        t0 = time.perf_counter()
        logits = runner.decode_logits(lengths)
        next_tokens = runner.sample_batch(logits, sched.inflight)
        next_np = next_tokens.cpu().numpy()  # waits for the round
        t1 = time.perf_counter()
        stats.t_decode += t1 - t0
        stats.decode_rounds += 1
        stats.decode_tokens += len(active)
        stats.slot_rounds += len(active)
        stats.decode_ctx_tokens += sum(runner.slots.slots[i].length for i in active)
        if TRACER.enabled:
            TRACER.complete("decode.round", t0, t1, batch=len(active))
        outs: List[RequestOutput] = []
        for i in active:
            req = sched.inflight[i]
            out = self.out_proc.process_token(req, int(next_np[i]))
            s = runner.slots.slots[i]
            s.length += 1
            s.generated += 1
            if out.finished:
                sched.inflight.pop(i)
                self.finished[req.request_id] = req
                runner.release(i)
            outs.append(out)
        runner.last_tokens.copy_(next_tokens)
        return outs

    def _grow_slot_span(self, slot: int, start: int, count: int) -> None:
        """Make positions [start, start + count) writable for one slot before
        a verify round: page growth and copy-on-write forks, preempting under
        pool pressure as a decode round does.  Stops if the slot itself is
        evicted."""
        for pos in range(start, start + count):
            self._grow_slot_page(slot, pos)
            if self.runner.slots.slots[slot].request_id is None:
                return

    def _verify_round(self, drafts: Dict[int, np.ndarray]) -> List[RequestOutput]:
        """One decode quantum under speculative decoding: the drafts (from
        ``_decode_round``, which ran plain decode when no slot drafted), one
        verify pass over every slot's [last token, drafts] block, then each
        slot accepts its longest confirmed draft prefix plus one target
        token, and the rejected rows roll back.  Every emitted token is the
        one sequential decode would give at its position, so replay after
        preemption needs no speculative state.  The targets are read back
        once, as a decode round reads back its tokens."""
        runner, stats, sched = self.runner, self.stats, self.scheduler
        n_slots = len(runner.slots.slots)
        w = runner.spec_decode + 1
        if runner.paged is not None:  # each block's span writable (may preempt)
            for slot, d in drafts.items():
                if slot in sched.inflight:
                    self._grow_slot_span(slot, runner.slots.slots[slot].length, len(d) + 1)
        active = sorted(sched.inflight)
        if not active:
            return []
        tokens = np.zeros((n_slots, w), np.int32)
        n_tokens = np.zeros((n_slots,), np.int32)  # mid-prefill and free slots sit out: 0
        for slot in active:
            d = drafts[slot]
            tokens[slot, 0] = sched.inflight[slot].out_tokens[-1]  # the slot's last token
            tokens[slot, 1:1 + len(d)] = d
            n_tokens[slot] = 1 + len(d)
            length = runner.slots.slots[slot].length
            # live rows stay clear of the parked-write row max_len - 1
            # (draft_for clamps; this guards the clamp)
            assert length + n_tokens[slot] - 1 <= runner.max_len - 2, (
                slot, length, int(n_tokens[slot]), runner.max_len)
        t0 = time.perf_counter()
        logits = runner.run_verify(tokens, n_tokens)
        targets = runner.select_targets(logits, sched.inflight)
        targets_np = targets.cpu().numpy()  # waits for the round
        t1 = time.perf_counter()
        stats.t_decode += t1 - t0
        stats.decode_rounds += 1
        stats.verify_rounds += 1
        stats.slot_rounds += len(active)
        stats.decode_ctx_tokens += sum(runner.slots.slots[i].length for i in active)
        if TRACER.enabled:
            TRACER.complete("decode.verify", t0, t1, batch=len(active),
                            drafted=int(sum(len(drafts[s]) for s in active)))
        outs: List[RequestOutput] = []
        last = np.zeros((n_slots,), np.int32)
        for slot in active:
            req = sched.inflight[slot]
            d = drafts[slot]
            a = accept_length(d, targets_np[slot, :len(d)])
            stats.draft_tokens += len(d)
            stats.accepted_tokens += a
            # the confirmed prefix and the next target; the output processor
            # cuts the delta at a stop token or the budget
            out = self.out_proc.process_tokens(req, [int(t) for t in targets_np[slot, :a + 1]])
            e = len(out.new_token_ids)
            s = runner.slots.slots[slot]
            s.length += e
            s.generated += e
            stats.decode_tokens += e
            last[slot] = out.new_token_ids[-1]
            if out.finished:
                sched.inflight.pop(slot)
                self.finished[req.request_id] = req
                runner.release(slot)
            else:
                runner.rollback_overshoot(slot, s.length)
            outs.append(out)
        runner.set_last_tokens(last)
        return outs
