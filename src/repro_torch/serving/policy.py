"""Prefill<->decode transition policy (paper §3.4 scheduling).

Policies see an immutable ``SchedulerView`` and decide whether to flip into
the prefill phase this step.  The port has the paper's own policy,
``DrainPolicy``; the swap-cost-aware and SLO-aware policies of the JAX
package are ROADMAP A7/A10.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SchedulerView:
    """Snapshot handed to a policy when a request is queued and a slot is free."""

    queue_depth: int
    free_slots: int
    active_slots: int  # slots currently decoding
    swap_cost: float  # mean exposed swap latency, seconds (0 until measured)
    decode_round_cost: float  # mean decode-round latency, seconds
    pending_chunks: int = 0
    oldest_wait_s: float = 0.0


class SwapPolicy:
    """Decides, once per step, whether to flip into the prefill phase."""

    name = "base"

    def should_prefill(self, view: SchedulerView) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        """Called when the engine goes idle (no queue, no active slots)."""


class DrainPolicy(SwapPolicy):
    """Paper scheduling: always prefill when work is queued and a slot is
    free (the engine drains the queue, then decodes)."""

    name = "drain"

    def should_prefill(self, view: SchedulerView) -> bool:
        return True


def make_policy(name: str) -> SwapPolicy:
    if name == DrainPolicy.name:
        return DrainPolicy()
    raise NotImplementedError(
        f"swap policy {name!r}: the port has 'drain'; the others are ROADMAP A7/A10")
