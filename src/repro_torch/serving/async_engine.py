"""Async multi-tenant serving front end over ``EngineCore``.

The port of the JAX package's ``repro.serving.async_engine``.
``EngineCore.step()`` is one synchronous scheduling quantum; ``AsyncEngine``
serves it to many clients at once:

* a **background step loop**: one task runs ``step()`` on a one-worker
  thread executor whenever there is work (so the event loop keeps streaming
  and accepting connections while a quantum runs on the card), and waits on
  an event when idle;
* **a stream a request**: ``submit()`` returns a ``RequestStream``, and
  ``async for out in stream`` yields each ``RequestOutput`` delta up to the
  terminal ``finished`` one; ``generate()`` does both;
* **abort**: ``stream.abort()`` / ``AsyncEngine.abort(request_id)`` cancels
  a request wherever it is (the front end's pending queue, the wait queue,
  mid-prefill, decoding, mid-verify); aborts are applied between quanta, and
  the stream receives a terminal ``finish_reason="abort"`` delta;
* **backpressure**: once ``max_queue`` requests wait (pending plus the
  scheduler's queue) ``submit()`` raises ``AdmissionRejected("queue_full:
  ...")``; a request that can never be served is refused at submit with the
  scheduler's reason (``"invalid: ..."``), a reused id with
  ``"duplicate_id: ..."``, and a tenant beyond the first ``max_tenants``
  distinct ones with ``"tenant_limit: ..."`` (each tenant keeps a queue
  lane, a latency window and a metric label set for the engine's life, so
  client-chosen names must not grow them without bound).

Threads: the event loop owns the front end's state, and the executor's
thread only ever runs ``core.step()`` (the ``# owned-by: event-loop`` and
``# thread: event-loop`` annotations, which the ``lock`` analysis pass
checks).  Submissions wait in ``_pending`` and
aborts in ``_aborts``, both applied by the loop task between quanta, so no
engine state changes while a step runs.  Admission reads loop-owned
mirrors only (the scheduler queue's length taken between quanta, every id
and tenant ever admitted).  ``snapshot()`` and the metrics registry may be
read while a quantum runs, so ``GET /stats`` can see counters part-way
through a step; they read host state and tensor shapes only, so the event
loop's thread never touches the device.  Build the engine's serving grid
(``EngineCore.build_serving_grid``) before the loop starts, so that every
CUDA graph is captured on the caller's thread with no other thread running.
Since the engine is the same ``EngineCore`` stepped the same way, greedy
streams through ``AsyncEngine`` equal the synchronous engine's.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Deque, Dict, Optional

import numpy as np

from repro_torch.obs.engine import engine_registry, engine_snapshot, snapshot_v2
from repro_torch.obs.trace import TRACER
from repro_torch.serving.core import EngineCore, Request
from repro_torch.serving.outputs import RequestOutput
from repro_torch.serving.sampling import SamplingParams


class AdmissionRejected(RuntimeError):
    """A submit refused outright (backpressure or an impossible request);
    ``reason`` starts with a machine-readable key (``queue_full``,
    ``duplicate_id``, ``invalid``, ``shutdown``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass
class _Stream:
    queue: "asyncio.Queue[RequestOutput]"
    request: Request


class RequestStream:
    """One request's output stream: iterate to the terminal delta."""

    def __init__(self, engine: "AsyncEngine", request_id: str,
                 queue: "asyncio.Queue[RequestOutput]"):
        self.engine = engine
        self.request_id = request_id
        self._q = queue
        self._done = False

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self) -> RequestOutput:
        if self._done:
            raise StopAsyncIteration
        out = await self._q.get()
        if out.finished:
            self._done = True
        return out

    async def abort(self) -> None:
        await self.engine.abort(self.request_id)


class AsyncEngine:
    """Async front end: a background step loop and one output stream a request."""

    def __init__(self, core: EngineCore, *, max_queue: int = 64, max_tenants: int = 64):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        self.core = core
        self.max_queue = max_queue
        self.max_tenants = max_tenants
        self._pending: Deque[Request] = deque()  # owned-by: event-loop
        self._streams: Dict[str, _Stream] = {}  # owned-by: event-loop
        self._aborts: Deque[str] = deque()  # owned-by: event-loop
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False  # owned-by: event-loop
        self._exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-step")
        self._seq = 0  # owned-by: event-loop
        # loop-owned mirrors of engine state: the scheduler queue's length
        # (taken between quanta), every id and every tenant ever admitted
        self._core_backlog = 0  # owned-by: event-loop
        self._ids: set = set()  # owned-by: event-loop
        self._tenants: set = set()  # owned-by: event-loop
        self.accepted = 0  # owned-by: event-loop
        self.rejected = 0  # owned-by: event-loop
        self.reject_reasons: Dict[str, int] = {}  # owned-by: event-loop
        self._metrics_registry = None

    # ------------------------------------------------------------ lifecycle --

    def start(self) -> "AsyncEngine":
        """Start the step loop on the running event loop (idempotent)."""
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def __aenter__(self) -> "AsyncEngine":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()

    async def shutdown(self) -> None:  # thread: event-loop
        """Stop the loop once the running quantum ends.  Every open stream
        receives a terminal abort delta, so no reader hangs."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        for rid in list(self._streams):
            out = self.core.abort(rid)
            if out is None:  # still in the front end's pending queue
                out = self.core.out_proc.finalize_aborted(self._streams[rid].request)
            self._route(out)
        self._exec.shutdown(wait=True)

    # ------------------------------------------------------------ admission --

    def _reject(self, reason: str) -> None:  # thread: event-loop
        self.rejected += 1
        key = reason.split(":", 1)[0]
        self.reject_reasons[key] = self.reject_reasons.get(key, 0) + 1
        raise AdmissionRejected(reason)

    def _backlog(self) -> int:  # thread: event-loop
        return len(self._pending) + self._core_backlog

    async def submit(self, prompt, params: Optional[SamplingParams] = None, *,
                     request_id: Optional[str] = None, max_new: Optional[int] = None,
                     tenant: str = "default", weight: float = 1.0,
                     priority: int = 0) -> RequestStream:  # thread: event-loop
        """Admit one request and return its output stream, or raise
        ``AdmissionRejected`` when the backlog is at ``max_queue`` or the
        request can never be served."""
        if self._closed:
            raise AdmissionRejected("shutdown: engine is closed")
        if self._backlog() >= self.max_queue:
            self._reject(f"queue_full: {self._backlog()} requests already waiting "
                         f"(max_queue={self.max_queue}); retry with backoff")
        self._seq += 1
        rid = request_id or f"areq-{self._seq}"
        if rid in self._ids:
            self._reject(f"duplicate_id: request id {rid!r} already in use")
        if tenant not in self._tenants and len(self._tenants) >= self.max_tenants:
            self._reject(f"tenant_limit: {len(self._tenants)} tenants already served "
                         f"(max_tenants={self.max_tenants})")
        if not (weight > 0.0 and math.isfinite(weight)):
            self._reject(f"invalid: tenant weight must be finite and > 0, got {weight}")
        prompt = np.asarray(prompt, np.int32)
        if max_new is None:
            if params is not None and params.max_tokens is not None:
                max_new = params.max_tokens
            else:
                # EngineCore.generate's default: the slot's headroom, clamped
                # to what the paged pool can hold
                runner = self.core.runner
                max_new = runner.max_len - len(prompt)
                if runner.paged is not None:
                    pool_tokens = runner.paged.num_blocks * runner.block_size
                    max_new = min(max_new, pool_tokens - len(prompt) + 1)
                max_new = max(1, max_new)
        req = Request(rid, prompt, max_new=max_new, priority=priority,
                      params=params or SamplingParams(), tenant=tenant, weight=weight)
        req.arrival_time_s = time.perf_counter()  # TTFT counts every wait from here
        try:
            # host arithmetic over engine constants: safe while a step runs
            self.core.scheduler.validate(req)
        except ValueError as e:
            self._reject(f"invalid: {e}")
        q: asyncio.Queue = asyncio.Queue()
        self._ids.add(rid)
        self._tenants.add(tenant)
        self._streams[rid] = _Stream(q, req)
        self._pending.append(req)
        if TRACER.enabled:
            TRACER.instant("req.enqueue", request_id=rid, tenant=tenant)
        self._wake.set()
        return RequestStream(self, rid, q)

    async def generate(self, prompt, params: Optional[SamplingParams] = None,
                       **kwargs) -> AsyncIterator[RequestOutput]:
        """Submit and stream: ``async for out in eng.generate(...)``."""
        stream = await self.submit(prompt, params, **kwargs)
        async for out in stream:
            yield out

    async def abort(self, request_id: str) -> None:  # thread: event-loop
        """Cancel a request; applied by the loop between quanta, which routes
        the stream its terminal abort delta."""
        self._aborts.append(request_id)
        self._wake.set()

    # ------------------------------------------------------------ step loop --

    def _route(self, out: RequestOutput) -> None:  # thread: event-loop
        stream = self._streams.get(out.request_id)
        if stream is not None:
            stream.queue.put_nowait(out)
            if out.finished:
                del self._streams[out.request_id]

    def _drain_control(self) -> None:  # thread: event-loop
        """Apply the aborts and admissions queued since the last quantum
        (never during one)."""
        while self._aborts:
            rid = self._aborts.popleft()
            stream = self._streams.get(rid)
            if stream is not None and stream.request in self._pending:
                # never reached the engine: finish it here
                self._pending.remove(stream.request)
                self.core.stats.aborts += 1
                self._route(self.core.out_proc.finalize_aborted(stream.request))
                continue
            out = self.core.abort(rid)
            if out is not None:
                self._route(out)
        while self._pending:
            req = self._pending.popleft()
            try:
                self.core.submit(req)
                self.accepted += 1
            except ValueError as e:  # validated at submit; a terminal refusal
                self.core.stats.aborts += 1
                out = self.core.out_proc.finalize_aborted(req)
                out.finish_reason = req.finish_reason = f"rejected: {e}"
                self._route(out)
        self._core_backlog = len(self.core.scheduler.queue)

    async def _run(self) -> None:  # thread: event-loop
        loop = asyncio.get_running_loop()
        while not self._closed:
            self._drain_control()
            if self.core.has_unfinished():
                outs = await loop.run_in_executor(self._exec, self.core.step)
                for out in outs:
                    self._route(out)
                self._core_backlog = len(self.core.scheduler.queue)
                await asyncio.sleep(0)  # let streams, submits and aborts in
            else:
                self._wake.clear()
                if self._aborts or self._pending or self.core.has_unfinished():
                    continue  # came in while clearing
                await self._wake.wait()
        self._drain_control()  # the last aborts, so that no reader hangs

    # -------------------------------------------------------------- metrics --

    @property
    def open_streams(self) -> int:  # thread: event-loop
        """Streams that have not had their terminal delta yet."""
        return len(self._streams)

    def snapshot(self) -> dict:  # thread: event-loop
        """The engine's stats block with the front end's admission counters."""
        return engine_snapshot(self.core, extra={"frontend": {
            "accepted": self.accepted,
            "rejected": self.rejected,
            "reject_reasons": dict(self.reject_reasons),
            "pending": len(self._pending),
            "open_streams": self.open_streams,
            "max_queue": self.max_queue,
        }})

    def metrics_registry(self):
        """The engine's registry with the front end's admission metrics,
        built once."""
        if self._metrics_registry is None:
            self._metrics_registry = engine_registry(self.core, frontend=self)
        return self._metrics_registry

    def snapshot_v2(self) -> dict:
        return snapshot_v2(self.core, registry=self.metrics_registry())
