"""Latency-overlapped logic swap (paper §3.4, Fig. 5 — contribution C5).

The prefill attention engine is idle once the *last layer's* attention has
run, while the rest of the prefill (last FFN + norm + logits) still has to.
The swap here is the KV relayout: prefill-layout KV (L, B, Hkv, S, D) into
the batch-leading decode cache.  On a GPU it runs on a second CUDA stream:
the stream waits for an event recorded at the end of the prefill body, the
tail runs meanwhile on the current stream, and decode waits on both (the
current stream waits for the relayout's end event: the paper's
conservative rule).

Timings come from the device's own clock: CUDA events on a GPU (so the
relayout's own time is known even when it overlaps the tail), the host
clock on the CPU, where nothing overlaps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass
class SwapTiming:
    t_body: float = 0.0
    t_tail: float = 0.0
    t_relayout: float = 0.0
    t_total_overlapped: float = 0.0
    t_total_serialized: float = 0.0

    @property
    def hidden_fraction(self) -> float:
        """Fraction of the swap latency hidden by the tail (paper: ~75 %)."""
        exposed = max(self.t_total_overlapped - self.t_body - self.t_tail, 0.0)
        if self.t_relayout <= 0:
            return 0.0
        return max(0.0, 1.0 - exposed / self.t_relayout)


@dataclasses.dataclass
class SwapAggregates:
    """Running aggregates over every ``SwapTiming`` recorded."""

    count: int = 0
    sum_cost: float = 0.0  # exposed (decode-visible) swap latency
    sum_hidden_fraction: float = 0.0

    @staticmethod
    def exposed_cost(t: SwapTiming) -> float:
        if t.t_total_overlapped:
            return max(t.t_total_overlapped - t.t_body - t.t_tail, 0.0)
        return t.t_relayout

    def update(self, t: SwapTiming) -> None:
        self.count += 1
        self.sum_cost += self.exposed_cost(t)
        self.sum_hidden_fraction += t.hidden_fraction

    @property
    def mean_cost(self) -> float:
        return self.sum_cost / self.count if self.count else 0.0

    @property
    def mean_hidden_fraction(self) -> float:
        return self.sum_hidden_fraction / self.count if self.count else 0.0


class _Clock:
    """Time marks on the device's clock: CUDA events recorded on a stream,
    or host ``perf_counter`` stamps on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self, stream=None):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()


class SwapController:
    """Temporal PD swap for one engine (the paper's single-RP mode)."""

    def __init__(self, prefill_body: Callable, prefill_tail: Callable, kv_relayout: Callable,
                 *, side_stream: Optional["torch.cuda.Stream"] = None):
        self.prefill_body = prefill_body
        self.prefill_tail = prefill_tail
        self.kv_relayout = kv_relayout
        self.side_stream = side_stream

    def prefill_and_swap(self, params, tokens: torch.Tensor, *,
                         overlap: bool = True) -> Tuple[Any, Any, SwapTiming]:
        """Returns (last_logits, decode_cache, timing), with the device
        synchronized.  overlap=False runs the relayout after the tail on the
        current stream (the ablation)."""
        clock = _Clock(tokens.device)
        timing = SwapTiming()
        t0 = clock.mark()
        x_mid, kv = self.prefill_body(params, tokens)
        t_body = clock.mark()
        if not overlap:
            logits = self.prefill_tail(params, x_mid)
            t_tail = clock.mark()
            cache = self.kv_relayout(kv)
            t_end = clock.mark()
            clock.wait(t_end)
            timing.t_body = clock.seconds(t0, t_body)
            timing.t_tail = clock.seconds(t_body, t_tail)
            timing.t_relayout = clock.seconds(t_tail, t_end)
            timing.t_total_serialized = clock.seconds(t0, t_end)
            return logits, cache, timing

        if clock.cuda:
            side = self.side_stream or torch.cuda.Stream(tokens.device)
            side.wait_event(t_body)
            with torch.cuda.stream(side):
                r0 = clock.mark(side)
                cache = self.kv_relayout(kv)
                r1 = clock.mark(side)
            for t in kv:  # the caching allocator must not recycle it under `side`
                t.record_stream(side)
            logits = self.prefill_tail(params, x_mid)
            t_tail = clock.mark()
            torch.cuda.current_stream(tokens.device).wait_event(r1)  # decode waits for both
            tail_start = t_body
        else:  # one host thread: the relayout, then the tail
            r0 = clock.mark()
            cache = self.kv_relayout(kv)
            r1 = tail_start = clock.mark()
            logits = self.prefill_tail(params, x_mid)
            t_tail = clock.mark()
        t_end = clock.mark()
        clock.wait(t_end)
        timing.t_body = clock.seconds(t0, t_body)
        timing.t_tail = clock.seconds(tail_start, t_tail)
        timing.t_relayout = clock.seconds(r0, r1)
        timing.t_total_overlapped = clock.seconds(t0, t_end)
        return logits, cache, timing
