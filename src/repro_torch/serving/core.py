"""Step-driven serving core: ``EngineCore.step() -> list[RequestOutput]``.

The port of the JAX package's ``repro.serving.core`` on its main path: the
contiguous batch-leading KV cache in the cache dtype, monolithic prefill
(one prompt per swap), greedy decoding, and the two modes —

* ``mode="pdswap"``: prefill split after the last layer's attention, the KV
  relayout overlapped with the prefill tail on a second CUDA stream
  (``overlap=True``) or run after it (``overlap=False``);
* ``mode="static"``: the unsplit prefill, then the KV install.

Three layers, as in the JAX package: ``Scheduler`` (FIFO wait queue,
admission validation, the swap decision through a ``SwapPolicy``),
``ModelRunner`` (phase programs, prompt buckets, the cache and slot
manager, prefill with the swap, decode rounds, argmax), and
``OutputProcessor`` (streaming deltas and finish semantics).  The JAX
package's weighted fair queue with one tenant is exactly FIFO, so a plain
``deque`` gives the same order.

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
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.serving.policy import DrainPolicy, SchedulerView, SwapPolicy, make_policy
from repro_torch.serving.sampling import SamplingParams

SWAP_TIMING_WINDOW = 64
LATENCY_WINDOW = 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_time_s: float = 0.0  # first submit, never overwritten (TTFT origin)
    first_token_t: float = 0.0
    finish_reason: Optional[str] = None  # "stop" | "length" once finished


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
        self.slots = KVSlotManager(n_slots)
        self.engine = PhaseEngine(cfg, cache_layout=cache_layout, kv_dtype=kv_dtype)
        self._bucket_progs: Dict[int, dict] = {}
        self.decode_prog = self.engine.decode_program(n_slots, max_len)
        self.cache = T.init_cache(cfg, n_slots, max_len, device=self.device)
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._side_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def bucket(self, n: int) -> int:
        """Prompt bucket for an n-token prompt (right-padded): one quantum
        steps up to 4 quanta, then quantum x powers of two, clamped to the
        largest quantum-aligned length <= max_len (a longer prompt takes
        max_len itself) — the JAX package's contiguous buckets."""
        q = self.prompt_len
        b = cdiv(n, q) * q
        if b > 4 * q:
            g = 4 * q
            while g < b:
                g *= 2
            b = g
        cap = self.max_len - self.max_len % q
        b = min(b, cap) if n <= cap else self.max_len
        return max(b, q)

    def progs(self, bucket: int) -> dict:
        """Phase programs for one prompt bucket, built once and cached."""
        if bucket not in self._bucket_progs:
            p: dict = {}
            if self.mode == "pdswap":
                p["body"], p["tail"] = self.engine.prefill_split_programs_varlen(1, bucket)
                p["relayout"] = self.engine.relayout_program(1, bucket, self.max_len)
            else:
                p["full"] = self.engine.prefill_program_varlen(1, bucket)
            self._bucket_progs[bucket] = p
        return self._bucket_progs[bucket]

    def prefill(self, req: Request, slot: int, stats: EngineStats) -> torch.Tensor:
        """Prefill one admitted request and install its KV into the decode
        cache (the swap, overlapped in pdswap mode).  Returns the prompt's
        last-token logits (1, Vp)."""
        n = len(req.prompt)
        bucket = self.bucket(n)
        progs = self.progs(bucket)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        tokens = torch.from_numpy(padded).to(self.device)
        last_pos = n - 1

        def swap_write(kv):
            if self.mode == "pdswap":
                return progs["relayout"].fn(kv, self.cache, slot)
            return insert_prefill_kv(self.cache, kv, slot)

        t0 = time.perf_counter()
        if self.mode == "pdswap":
            ctl = SwapController(progs["body"].fn,
                                 lambda p, x: progs["tail"].fn(p, x, last_pos),
                                 swap_write, side_stream=self._side_stream)
            logits, _, timing = ctl.prefill_and_swap(self.params, tokens, overlap=self.overlap)
            stats.record_swap(timing)
        else:
            logits, kv = progs["full"].fn(self.params, tokens, last_pos)
            swap_write(kv)
            _sync(self.device)
        stats.t_prefill += time.perf_counter() - t0
        stats.prefill_tokens += n
        return logits

    def decode_logits(self, lengths: torch.Tensor) -> torch.Tensor:
        """One decode round; updates the cache in place, returns (B, Vp) logits."""
        logits, self.cache = self.decode_prog.fn(self.params, self.last_tokens, self.cache, lengths)
        return logits

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

    def submit(self, request: Request) -> None:
        self.validate(request)
        if request.arrival_time_s == 0.0:
            request.arrival_time_s = time.perf_counter()
        self.queue.append(request)

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
            mode=mode, cache_layout=cache_layout, kv_dtype=kv_dtype, overlap=overlap,
            prefill_chunk=prefill_chunk, spec_decode=spec_decode, device=device)
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

    def step(self) -> List[RequestOutput]:
        """Advance one scheduling quantum: a policy-gated prefill burst
        (admitting queued requests into free slots, one swap each), then one
        decode round over the active slots."""
        outs: List[RequestOutput] = []
        sched, runner = self.scheduler, self.runner
        if sched.queue and runner.slots.free_slots() and sched.enter_prefill_phase(self.stats):
            while sched.queue and runner.slots.free_slots():
                outs.append(self._admit_one(sched.queue.popleft()))
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

    def _admit_one(self, req: Request) -> RequestOutput:
        runner = self.runner
        slot = runner.slots.assign(req.request_id, len(req.prompt))
        logits = runner.prefill(req, slot, self.stats)
        return self._finish_prefill(req, slot, logits)

    def _finish_prefill(self, req: Request, slot: int, logits) -> RequestOutput:
        """The prefill produced the first new token: emit it, then either
        finish the request or hand its slot to the decode rounds."""
        runner = self.runner
        tok = runner.sample_first(logits)
        out = self.out_proc.process_token(req, tok)
        runner.slots.slots[slot].generated = 1
        if out.finished:
            self.finished[req.request_id] = req
            runner.slots.release(slot)
            return out
        runner.last_tokens[slot] = tok
        self.scheduler.inflight[slot] = req
        return out

    def _decode_round(self) -> List[RequestOutput]:
        runner, stats, sched = self.runner, self.stats, self.scheduler
        active = sorted(sched.inflight)
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
                runner.slots.release(i)
            outs.append(out)
        runner.last_tokens = next_tokens
        return outs
