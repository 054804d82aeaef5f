"""SLO-aware serving: latency targets, per-request latency, and a swap
policy steered by the observed TTFT and ITL percentiles.

The port of the JAX package's ``repro.serving.slo``.  Two client-visible
latencies define an interactive serving SLO:

* **TTFT**, time to first token: from the request's *arrival* (stamped at
  submit, so the queueing delay is inside it) to its first emitted token;
* **ITL**, inter-token latency: the gap between two streamed deltas of one
  request.

``LatencyStat`` is the aggregate the engine keeps for queue wait, TTFT and
ITL: a running count and sum, and a bounded window of samples for the
percentiles (a long serving run must not grow a list a token).

``SLOAwareSwapPolicy`` reads the engine's observed p95 ITL and its queue's
age each step and steers both halves of the prefill decision:
``should_prefill`` (flip into prefill when the queue head's age threatens
the TTFT target or ITL has slack; defer, bounded, while ITL is violated and
TTFT is safe) and ``prefill_quanta`` (under chunked prefill, how many chunks
the engine may run back to back before the next decode round).  Chunking
never changes greedy tokens, so the second knob moves latency only.  Its
``should_shed`` drops a queue head that can no longer meet its TTFT target.
The policy observes through ``bind(stats)``: ``EngineCore`` binds its own
``EngineStats``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

import numpy as np

from repro_torch.serving.policy import POLICIES, SchedulerView, SwapPolicy

LATENCY_WINDOW = 2048  # samples kept for the percentiles


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency targets of one deployment (seconds)."""

    ttft_target_s: float = 0.5
    itl_target_s: float = 0.05
    # should_prefill: the queue head is at risk once it has waited
    # ttft_risk x target (prefill must start well before the deadline);
    # ITL has slack below itl_slack x target
    ttft_risk: float = 0.4
    itl_slack: float = 0.6

    def __post_init__(self):
        if self.ttft_target_s <= 0.0 or self.itl_target_s <= 0.0:
            raise ValueError("SLO targets must be > 0")
        if not 0.0 < self.ttft_risk <= 1.0 or not 0.0 < self.itl_slack <= 1.0:
            raise ValueError("ttft_risk and itl_slack must be in (0, 1]")


class LatencyStat:
    """Bounded-window latency aggregate: count and sum forever, percentiles
    over the last ``window`` samples (seconds)."""

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

    def percentile(self, q: float, last: Optional[int] = None) -> float:
        """The q-th percentile of the window; ``last`` keeps only its most
        recent samples (a controller reacts to current conditions, not to a
        spike long past)."""
        if not self._win:
            return 0.0
        data = self._win if last is None else list(self._win)[-last:]
        return float(np.percentile(np.asarray(data), q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    def snapshot(self) -> dict:
        """JSON-serializable summary (seconds)."""
        return {"count": self.count, "mean": self.mean, "p50": self.p50, "p95": self.p95}


def request_latency(req) -> dict:
    """Client-visible latency of one finished request from the engine's
    stamps (seconds; 0.0 where a stamp is missing, e.g. the TTFT of a
    request that produced no token)."""
    arrival = getattr(req, "arrival_time_s", 0.0) or getattr(req, "enqueue_t", 0.0)
    ttft = (req.first_token_t - arrival) if req.first_token_t and arrival else 0.0
    qw = getattr(req, "queue_wait_s", None)
    return {
        "request_id": req.request_id,
        "ttft_s": ttft,
        "queue_wait_s": 0.0 if qw is None else qw,
        "e2e_s": (req.done_t - arrival) if req.done_t and arrival else 0.0,
        "tokens": len(req.out_tokens),
        "finish_reason": req.finish_reason,
    }


class SLOAwareSwapPolicy(SwapPolicy):
    """Steer the prefill<->decode flip (and the chunk width) from the
    observed p95 TTFT and ITL against an ``SLOConfig``.

    Decision order (an empty decode set and the defer cap both force
    admission, as in the other policies):

    1. nothing decoding -> prefill;
    2. a chunked prefill in flight -> continue it;
    3. the queue head older than ``ttft_risk x ttft_target`` -> prefill (a
       missed TTFT cannot be repaired; ITL can recover);
    4. observed p95 ITL over target and the queue still shallow -> defer,
       bounded (a deep queue is sustained overload, where deferring starves
       TTFT without recovering ITL);
    5. observed p95 ITL under ``itl_slack x`` target -> prefill;
    6. otherwise amortize as the swap-cost policy does: admit once the
       queue is at least as deep as the decode rounds one swap costs.
    """

    name = "slo-aware"

    def __init__(self, slo: Optional[SLOConfig] = None, *, max_defer_rounds: int = 8,
                 max_quanta: int = 4, recent: int = 64):
        if max_defer_rounds < 1 or max_quanta < 1 or recent < 1:
            raise ValueError("max_defer_rounds, max_quanta and recent must be >= 1")
        self.slo = slo or SLOConfig()
        self.max_defer_rounds = max_defer_rounds
        self.max_quanta = max_quanta
        self.recent = recent  # steer from the last N samples, not all time
        self._stats = None  # the engine's EngineStats, bound by the engine
        self._deferred = 0
        self._last_active = 0  # decode-set size at the last should_prefill
        self._last_queue = 0  # queue depth at the last should_prefill

    def bind(self, stats) -> None:
        """Attach the engine's ``EngineStats``: its ttft/itl ``LatencyStat``
        are what the policy observes."""
        self._stats = stats

    def _itl_p95(self) -> float:
        if self._stats is None:
            return 0.0
        return self._stats.itl.percentile(95, last=self.recent)

    def should_prefill(self, view: SchedulerView) -> bool:
        self._last_active = view.active_slots
        self._last_queue = view.queue_depth
        if view.active_slots == 0 or view.pending_chunks > 0:
            self._deferred = 0
            return True
        slo = self.slo
        if view.oldest_wait_s >= slo.ttft_risk * slo.ttft_target_s:
            self._deferred = 0
            return True
        itl = self._itl_p95()
        if (itl > slo.itl_target_s
                and view.queue_depth <= max(1, 2 * view.active_slots)
                and self._deferred < self.max_defer_rounds):
            self._deferred += 1
            return False
        if itl <= slo.itl_slack * slo.itl_target_s:
            self._deferred = 0
            return True
        # between slack and target: batch admissions until the queue is
        # worth one swap, which keeps chunks out of busy decode windows
        if view.decode_round_cost > 0.0 and view.swap_cost > 0.0:
            need = max(1, int(np.ceil(view.swap_cost / view.decode_round_cost)))
        else:
            need = 1
        if view.queue_depth >= need or self._deferred >= self.max_defer_rounds:
            self._deferred = 0
            return True
        self._deferred += 1
        return False

    def prefill_quanta(self) -> int:
        """Chunks the engine may run back to back this step (chunked prefill
        only): 1 while ITL is tight or unobserved, or while the queue is no
        deeper than the decode set; the full ``max_quanta`` when nothing
        decodes; otherwise the ITL budget left over the observed median gap,
        in units of the engine's measured cost a chunk."""
        if self._stats is None:
            return 1
        if self._last_active == 0:
            return self.max_quanta
        if self._last_queue <= self._last_active:
            return 1
        slo = self.slo
        itl = self._itl_p95()
        if itl <= 0.0 or itl > slo.itl_slack * slo.itl_target_s:
            return 1
        stats = self._stats
        chunk_cost = stats.t_prefill / stats.prefill_chunks if stats.prefill_chunks else 0.0
        if chunk_cost <= 0.0:
            return 1
        base_gap = stats.itl.percentile(50, last=self.recent) or stats.decode_round_cost()
        budget = slo.itl_target_s - base_gap
        return int(max(1, min(self.max_quanta, budget / chunk_cost)))

    def should_shed(self, wait_s: float) -> bool:
        """Deadline admission control: drop a queue head that can no longer
        meet its TTFT target.  The head is doomed once ``wait`` plus the
        observed time from admission to first token (the gap between the
        TTFT and queue-wait medians) crosses the target, but never before
        half the target (two medians over different requests can spike
        under churn).  Only this policy sheds."""
        serve = 0.0
        if self._stats is not None:
            serve = max(0.0, self._stats.ttft.percentile(50, last=self.recent)
                        - self._stats.queue_wait.percentile(50, last=self.recent))
        line = max(0.5 * self.slo.ttft_target_s, self.slo.ttft_target_s - serve)
        return wait_s >= line

    def reset(self) -> None:
        self._deferred = 0
        self._last_active = 0


POLICIES.setdefault(SLOAwareSwapPolicy.name, SLOAwareSwapPolicy)
