"""Per-tenant weighted fair queueing for the scheduler's wait queue.

The port of the JAX package's ``repro.serving.fair_queue``.  One global FIFO
lets a single tenant's burst starve every other tenant for the burst's whole
service time.  ``WeightedFairQueue`` keeps one FIFO lane a tenant and drains
the lanes in deficit-round-robin (DRR) order: each visit to a tenant adds its
weight to a deficit counter and the tenant is served while the deficit lasts
(one unit a request), so over any busy window tenant ``i`` receives service
in proportion to ``weight_i``, however deep any one lane is.

The interface is the deque's that the scheduler uses — ``append``,
``appendleft``, ``popleft``, ``len``, truthiness, ``[0]``:

* with a single tenant (the default) DRR is exactly FIFO, so the engine's
  order, and its greedy streams, are those of a plain deque;
* ``appendleft`` requeues at the head (a blocked admission, a preemption):
  the request goes onto a head lane served before any DRR pick, whatever
  its tenant.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional


class WeightedFairQueue:
    """Deficit round robin over per-tenant FIFO lanes (cost 1 a request)."""

    def __init__(self):
        self._lanes: Dict[str, Deque] = {}
        self._order: List[str] = []  # tenant visit order (first seen)
        self._deficit: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}
        self._head: Deque = deque()  # requeued-at-head requests, any tenant
        self._ptr = 0  # DRR cursor into _order
        self._len = 0

    @staticmethod
    def _tenant(req) -> str:
        return getattr(req, "tenant", "default") or "default"

    def _lane(self, tenant: str, weight: float) -> Deque:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = deque()
            self._order.append(tenant)
            self._deficit[tenant] = 0.0
        if weight > 0.0:
            self._weights[tenant] = weight  # the latest request's weight wins
        return lane

    def set_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0.0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self._lane(tenant, weight)

    def append(self, req) -> None:
        self._lane(self._tenant(req), float(getattr(req, "weight", 1.0))).append(req)
        self._len += 1

    def appendleft(self, req) -> None:
        """Requeue at the global head: the next ``popleft`` returns it.  A
        blocked admission or a preemption restart won arbitration once
        already, and was charged for it then."""
        self._head.appendleft(req)
        self._len += 1

    def _drr_lane(self, commit: bool) -> Deque:
        """The lane DRR serves next.  ``commit`` spends the visit (the
        cursor moves, the deficit is charged one request); without it the
        walk runs on copies, so ``peek`` sees exactly what ``popleft``
        will pop, a tenant of weight < 1 accruing over several cycles
        included."""
        # DRR: visit tenants in a fixed order; a visit grants `weight` of
        # deficit; serve while the deficit is >= 1, then move on.  An empty
        # lane forfeits its deficit (an idle tenant banks no credit).
        ptr = self._ptr
        deficit = self._deficit if commit else dict(self._deficit)
        while True:
            if ptr >= len(self._order):
                ptr = 0
            tenant = self._order[ptr]
            lane = self._lanes[tenant]
            if not lane:
                deficit[tenant] = 0.0
                ptr += 1
                continue
            if deficit[tenant] < 1.0:
                deficit[tenant] += self._weights.get(tenant, 1.0)
                if deficit[tenant] < 1.0:
                    ptr += 1  # weight < 1 accrues over several cycles
                    continue
            break
        if commit:
            deficit[tenant] -= 1.0
            # lane about to drain or deficit spent: the next tenant
            self._ptr = ptr + 1 if len(lane) == 1 or deficit[tenant] < 1.0 else ptr
        return lane

    def popleft(self):
        if self._head:
            self._len -= 1
            return self._head.popleft()
        if self._len == 0:
            raise IndexError("pop from an empty WeightedFairQueue")
        lane = self._drr_lane(commit=True)
        self._len -= 1
        return lane.popleft()

    def remove(self, request_id: str):
        """Remove and return a queued request by id (abort); None if the id
        is not queued."""
        for lane in (self._head, *self._lanes.values()):
            for req in lane:
                if req.request_id == request_id:
                    lane.remove(req)
                    self._len -= 1
                    return req
        return None

    def lane_depths(self) -> Dict[str, int]:
        """Queued depth a tenant: the DRR lanes, with requeues on the head
        lane counted under their own tenant (``snapshot()["tenants"]``)."""
        depths = {t: len(lane) for t, lane in self._lanes.items() if lane}
        for req in self._head:
            t = self._tenant(req)
            depths[t] = depths.get(t, 0) + 1
        return depths

    def peek(self) -> Optional[object]:
        """The request the next ``popleft`` returns (no deficit spent)."""
        if self._head:
            return self._head[0]
        if self._len == 0:
            return None
        return self._drr_lane(commit=False)[0]

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError("WeightedFairQueue only exposes the head ([0])")
        head = self.peek()
        if head is None:
            raise IndexError("empty WeightedFairQueue")
        return head

    def __iter__(self):
        yield from self._head
        for tenant in self._order:
            yield from self._lanes[tenant]

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0
