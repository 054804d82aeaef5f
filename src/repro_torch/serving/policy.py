"""Prefill<->decode transition policy (paper §3.4 scheduling).

Policies see an immutable ``SchedulerView`` and decide whether to flip into
the prefill phase this step: ``DrainPolicy`` (the paper's, the default),
``SwapCostAwarePolicy`` (defer the flip while the queue is shallow against
the measured swap cost) or ``serving.slo.SLOAwareSwapPolicy`` (steered by the
observed latencies, with deadline shedding).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SchedulerView:
    """Snapshot handed to a policy when a request is queued and a slot is free."""

    queue_depth: int
    free_slots: int
    active_slots: int  # slots currently decoding (mid-prefill slots excluded)
    swap_cost: float  # mean exposed swap latency, seconds (0 until measured)
    decode_round_cost: float  # mean decode-round latency, seconds
    pending_chunks: int = 0  # chunks owed to a partially prefilled request
    oldest_wait_s: float = 0.0  # age of the queue head, seconds


class SwapPolicy:
    """Decides, once per step, whether to flip into the prefill phase."""

    name = "base"

    def should_prefill(self, view: SchedulerView) -> bool:
        raise NotImplementedError

    def bind(self, stats) -> None:
        """Given the engine's ``EngineStats`` (anew after ``reset_stats``);
        a policy that reads measured latencies keeps them."""

    def prefill_quanta(self) -> int:
        """Prefill chunks to run back to back this step (chunked prefill)."""
        return 1

    def should_shed(self, wait_s: float) -> bool:
        """Whether a queue head that has waited ``wait_s`` is dropped."""
        return False

    def reset(self) -> None:
        """Called when the engine goes idle (no queue, no active slots)."""


class DrainPolicy(SwapPolicy):
    """Paper scheduling: always prefill when work is queued and a slot is
    free (the engine drains the queue, then decodes)."""

    name = "drain"

    def should_prefill(self, view: SchedulerView) -> bool:
        return True


class SwapCostAwarePolicy(SwapPolicy):
    """Defer the swap while the queue is shallow relative to its cost: admit
    when ``queue_depth >= ceil(cost_ratio * swap_cost / decode_round_cost)``
    (``min_queue`` pins the threshold; ``swap_cost_override`` stands in for
    the measured cost).  Always admits when nothing decodes, when chunks of
    an admitted prompt are pending, and after ``max_defer_rounds``
    deferrals in a row."""

    name = "swap-aware"

    def __init__(self, *, cost_ratio: float = 1.0, max_defer_rounds: int = 8,
                 min_queue: Optional[int] = None, swap_cost_override: Optional[float] = None):
        if max_defer_rounds < 1:
            raise ValueError("max_defer_rounds must be >= 1")
        self.cost_ratio = cost_ratio
        self.max_defer_rounds = max_defer_rounds
        self.min_queue = min_queue
        self.swap_cost_override = swap_cost_override
        self._deferred = 0

    def threshold(self, view: SchedulerView) -> int:
        if self.min_queue is not None:
            return self.min_queue
        cost = self.swap_cost_override if self.swap_cost_override is not None else view.swap_cost
        if view.decode_round_cost <= 0.0:
            return 1  # no history yet: drain while warming up
        return max(1, math.ceil(self.cost_ratio * cost / view.decode_round_cost))

    def should_prefill(self, view: SchedulerView) -> bool:
        # a partially prefilled request holds its slot (and pages) while it
        # produces nothing: its remaining chunks always continue
        if (view.pending_chunks > 0 or view.active_slots == 0
                or self._deferred >= self.max_defer_rounds
                or view.queue_depth >= self.threshold(view)):
            self._deferred = 0
            return True
        self._deferred += 1
        return False

    def reset(self) -> None:
        self._deferred = 0


POLICIES = {DrainPolicy.name: DrainPolicy, SwapCostAwarePolicy.name: SwapCostAwarePolicy}


def make_policy(name: str, **kwargs) -> SwapPolicy:
    if name not in POLICIES:
        # serving.slo registers its policy when imported; imported here, not
        # at the top, since it imports this module
        import repro_torch.serving.slo  # noqa: F401
    if name not in POLICIES:
        raise ValueError(f"unknown swap policy {name!r}; choose from {sorted(POLICIES)}")
    return POLICIES[name](**kwargs)
