"""Step-driven serving core: ``EngineCore.step() -> list[RequestOutput]``.

The port of the JAX package's ``repro.serving.core``: monolithic prefill
(one prompt per swap), greedy decoding, the two cache layouts —
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

Three layers, as in the JAX package: ``Scheduler`` (FIFO wait queue,
admission validation, the swap decision through a ``SwapPolicy``),
``ModelRunner`` (phase programs, prompt buckets, the cache and slot
manager, prefill with the swap, decode rounds, argmax), and
``OutputProcessor`` (streaming deltas and finish semantics).  The JAX
package's weighted fair queue with one tenant is exactly FIFO, so a plain
``deque`` gives the same order, a preempted request going back to its head.

Arguments outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
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
from repro_torch.core.swap import SwapAggregates, SwapController, SwapTiming
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import QuantKV, payload_bytes, total_nbytes
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.serving.paging import PagedKVCache, PoolExhausted, cdiv
from repro_torch.serving.policy import DrainPolicy, SchedulerView, SwapPolicy, make_policy
from repro_torch.serving.sampling import SamplingParams

SWAP_TIMING_WINDOW = 64
LATENCY_WINDOW = 1024


class LatencyStat:
    """Bounded-window latency aggregate: count/sum forever, percentiles over
    the last ``window`` samples (seconds)."""

    def __init__(self, window: int = LATENCY_WINDOW):
        self.count = 0
        self.total = 0.0
        self._win: Deque[float] = deque(maxlen=window)

    def record(self, v: float) -> None:
        self.count += 1
        self.total += v
        self._win.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        return float(np.percentile(np.asarray(self._win), q)) if self._win else 0.0


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: np.ndarray  # (S,) int32 — any length with S + max_new <= max_len
    max_new: int
    priority: int = 0  # larger = more important; the lowest is preempted first
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_time_s: float = 0.0  # first submit, never overwritten (TTFT origin)
    enqueue_t: float = 0.0  # scheduler-queue entry
    first_token_t: float = 0.0
    finish_reason: Optional[str] = None  # "stop" | "length" once finished
    # Set on preemption: the restart re-prefills the prompt and replays the
    # recorded out_tokens through the decode program, which rebuilds the
    # evicted cache state exactly, so the continuation is unchanged.
    preempted: bool = False


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_rounds: int = 0
    swaps: int = 0
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
    ttft: LatencyStat = dataclasses.field(default_factory=LatencyStat)

    def decode_tput(self) -> float:
        return self.decode_tokens / self.t_decode if self.t_decode else 0.0

    def decode_round_cost(self) -> float:
        return self.t_decode / self.decode_rounds if self.decode_rounds else 0.0

    def record_swap(self, timing: SwapTiming) -> None:
        self.swaps += 1
        self.swap_timings.append(timing)
        self.swap_agg.update(timing)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        device=None,
    ):
        if mode not in ("pdswap", "static"):
            raise ValueError(f"mode must be 'pdswap' or 'static', got {mode!r}")
        if prefill_chunk is not None:
            raise NotImplementedError("prefill_chunk: chunked prefill is ROADMAP A9")
        if spec_decode:
            raise NotImplementedError("spec_decode: speculative decoding is ROADMAP A9")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.mode = mode
        self.overlap = overlap and mode == "pdswap"
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.kv_dtype = kv_dtype
        self.block_size = block_size
        self.slots = KVSlotManager(n_slots)
        self.engine = PhaseEngine(cfg, cache_layout=cache_layout, kv_dtype=kv_dtype)
        self._bucket_progs: Dict[int, dict] = {}
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
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._side_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

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
        else:
            logits, kv = progs["full"].fn(self.params, tokens, last_pos)
            swap_write(kv)
            _sync(self.device)
        if resuming:
            stats.t_replay += time.perf_counter() - t0
        else:
            stats.t_prefill += time.perf_counter() - t0
            stats.prefill_tokens += n
        if match is not None:
            self.paged.register_prompt_pages(match)
        return logits

    def decode_logits(self, lengths: torch.Tensor) -> torch.Tensor:
        """One decode round; updates the cache in place, returns (B, Vp) logits."""
        if self.paged is not None:
            logits, self.paged.kv = self.decode_prog.fn(
                self.params, self.last_tokens, self.paged.kv, self.paged.block_tables_array(),
                lengths)
        else:
            logits, self.cache = self.decode_prog.fn(self.params, self.last_tokens, self.cache,
                                                     lengths)
        return logits

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
            tokens = torch.zeros((n_slots,), dtype=torch.int32)
            tokens[slot] = tok
            lengths = torch.zeros((n_slots,), dtype=torch.int32)
            lengths[slot] = pos
            _, self.paged.kv = self.decode_prog.fn(
                self.params, tokens.to(self.device), self.paged.kv,
                self.paged.block_tables_array(), lengths.to(self.device))
            stats.replayed_tokens += 1
        _sync(self.device)
        stats.t_replay += time.perf_counter() - t0
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

    @staticmethod
    def sample_batch(logits: torch.Tensor) -> torch.Tensor:
        """Greedy next token for every slot, (B,) int32 (first max on ties)."""
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @staticmethod
    def sample_first(logits: torch.Tensor) -> int:
        """The prompt's first generated token, from the prefill logits."""
        return int(torch.argmax(logits[0]))


class Scheduler:
    """Admission, the FIFO wait queue, and the swap decision."""

    def __init__(self, runner: ModelRunner, policy: SwapPolicy):
        self.runner = runner
        self.policy = policy
        self.queue: Deque[Request] = deque()
        self.inflight: Dict[int, Request] = {}

    def validate(self, request: Request) -> None:
        p = request.params
        if not p.greedy or p.top_k or p.top_p < 1.0:
            raise NotImplementedError(
                f"{request.request_id}: sampled decoding (temperature/top-k/top-p) is ROADMAP A7")
        if p.max_tokens is not None:
            request.max_new = p.max_tokens
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

    def requeue_head(self, request: Request) -> None:
        self.queue.appendleft(request)

    def enter_prefill_phase(self, stats: EngineStats) -> bool:
        """The swap decision; an empty decoding set always flips."""
        active = len(self.inflight)
        if active == 0:
            return True
        head = self.queue[0] if self.queue else None
        view = SchedulerView(
            queue_depth=len(self.queue),
            free_slots=len(self.runner.slots.free_slots()),
            active_slots=active,
            swap_cost=stats.swap_agg.mean_cost,
            decode_round_cost=stats.decode_round_cost(),
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


class EngineCore:
    """The incremental serving core; one ``step()`` = one scheduling quantum.
    Runs on CUDA unless ``device`` says otherwise; params must lie on that
    device (``models.transformer.init`` + ``convert_for_inference``, or
    ``interop.params_from_numpy``)."""

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
        spec_decode: Optional[int] = None,
        device=None,
    ):
        self.cfg = cfg
        self.runner = ModelRunner(
            cfg, params, n_slots=n_slots, max_len=max_len, prompt_len=prompt_len,
            mode=mode, cache_layout=cache_layout, block_size=block_size, num_blocks=num_blocks,
            kv_dtype=kv_dtype, overlap=overlap, prefill_chunk=prefill_chunk,
            spec_decode=spec_decode, device=device)
        if swap_policy is None:
            swap_policy = DrainPolicy()
        elif isinstance(swap_policy, str):
            swap_policy = make_policy(swap_policy)
        self.scheduler = Scheduler(self.runner, swap_policy)
        self.stats = EngineStats()
        self.out_proc = OutputProcessor(stats=self.stats)
        self.finished: Dict[str, Request] = {}
        self._gen_seq = 0

    @property
    def device(self) -> torch.device:
        return self.runner.device

    def submit(self, request: Request) -> None:
        self.scheduler.submit(request)

    def has_unfinished(self) -> bool:
        return bool(self.scheduler.queue or self.runner.slots.active_slots())

    def reset_stats(self) -> None:
        """Fresh ``EngineStats`` (e.g. after a warm-up pass)."""
        self.stats = EngineStats()
        self.out_proc = OutputProcessor(stats=self.stats)

    def kv_bytes(self) -> dict:
        return self.runner.kv_bytes()

    def step(self) -> List[RequestOutput]:
        """Advance one scheduling quantum: a policy-gated prefill burst
        (admitting queued requests into free slots, one swap each; paged,
        an admission the pool cannot hold stops the burst), then one decode
        round over the active slots."""
        outs: List[RequestOutput] = []
        sched, runner = self.scheduler, self.runner
        if sched.queue and runner.slots.free_slots() and sched.enter_prefill_phase(self.stats):
            while sched.queue and runner.slots.free_slots():
                ok, out = self._admit_one(sched.queue.popleft())
                if out is not None:
                    outs.append(out)
                if not ok:
                    if not runner.slots.active_slots():
                        self._unblock_admission_or_raise()
                    break  # decode to drain capacity, then retry admission
        if sched.inflight:
            outs.extend(self._decode_round())
        if not self.has_unfinished():
            sched.policy.reset()
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
                 max_steps: int = 10_000) -> Iterator[RequestOutput]:
        """Submit one request and stream its outputs as they are produced."""
        if params is None:
            params = SamplingParams()
        prompt = np.asarray(prompt, np.int32)
        if max_new is None:
            max_new = params.max_tokens or max(1, self.runner.max_len - len(prompt))
        self._gen_seq += 1
        rid = request_id or f"gen-{self._gen_seq}"
        self.submit(Request(rid, prompt, max_new=max_new, params=params))
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
        try:
            logits = runner.prefill(req, slot, self.stats, resuming=resuming)
        except PoolExhausted:
            self._block_admission(req, slot)
            return False, None
        return self._finish_prefill(req, slot, logits, resuming)

    def _block_admission(self, req: Request, slot: Optional[int] = None) -> None:
        """An admission blocked on pool pressure: give the slot back (if one
        was taken), count the block, requeue the request at the head."""
        if slot is not None:
            self.runner.release(slot)
        self.stats.admission_blocks += 1
        self.scheduler.requeue_head(req)

    def _finish_prefill(self, req: Request, slot: int, logits, resuming: bool = False):
        """After the prefill: a restart replays its recorded tokens; a new
        request emits its first token.  Then the request either finishes or
        its slot joins the decode rounds.  Returns ``(ok, output)``."""
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
            tok = runner.sample_first(logits)
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

    def _grow_slot_page(self, slot: int, length: int) -> None:
        """Make position ``length`` writable, preempting under pool pressure."""
        while True:
            try:
                self.runner.append_page(slot, length)
                return
            except PoolExhausted:
                victim = self.scheduler.pick_victim()
                if victim is None:
                    raise RuntimeError(
                        "paged KV pool exhausted with nothing left to preempt; "
                        f"raise num_blocks (have {self.runner.paged.num_blocks})")
                self.scheduler.preempt(victim, self.stats)
                if victim == slot:
                    return  # this very slot was evicted; the round skips it

    def _ensure_append_pages(self) -> None:
        """Before a decode round, make every active slot's next position
        writable: grow tables at page boundaries and fork shared pages,
        preempting the lowest-priority request when the pool cannot."""
        for slot in self.runner.slots.active_slots():
            s = self.runner.slots.slots[slot]
            if s.request_id is None:  # preempted earlier in this loop
                continue
            self._grow_slot_page(slot, s.length)

    def _decode_round(self) -> List[RequestOutput]:
        runner, stats, sched = self.runner, self.stats, self.scheduler
        if runner.paged is not None:
            self._ensure_append_pages()
        active = sorted(sched.inflight)
        if not active:
            return []
        lengths = runner.slots.lengths_array(runner.device)
        t0 = time.perf_counter()
        logits = runner.decode_logits(lengths)
        next_tokens = runner.sample_batch(logits)
        next_np = next_tokens.cpu().numpy()  # waits for the round
        stats.t_decode += time.perf_counter() - t0
        stats.decode_rounds += 1
        stats.decode_tokens += len(active)
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
        runner.last_tokens = next_tokens
        return outs
