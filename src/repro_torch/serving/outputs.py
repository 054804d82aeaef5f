"""Output side of the serving core: incremental ``RequestOutput`` deltas and
finish semantics — a stop token (``"stop"``), the token budget
(``"length"``), or a request removed before it completed (``"abort"``).
Every emission feeds the engine's client-visible latency aggregates: TTFT on
a request's first token, the inter-token latency (ITL) on every later one.
Every finish goes through ``_finish``, which records the tracer's
exactly-once finish event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from repro_torch.obs.trace import TRACER


def _finish(req, reason: str, now: Optional[float] = None) -> None:
    """Set the finish reason, stamp ``done_t`` once (a request reaching a
    second finish path keeps its first stamp), and record the tracer's
    finish event, which raises on a second finish while tracing."""
    req.finish_reason = reason
    if req.done_t == 0.0:
        req.done_t = time.perf_counter() if now is None else now
    TRACER.finish(req.request_id, reason)


@dataclasses.dataclass
class RequestOutput:
    """One streaming increment for one request: ``new_token_ids`` is the
    delta this step produced; ``token_ids`` is a live view of the request's
    whole generated sequence."""

    request_id: str
    new_token_ids: List[int]
    token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[str] = None


class OutputProcessor:
    """Turns sampled tokens into RequestOutputs; owns finish semantics.
    With ``stats`` (an ``EngineStats``), a request's first token feeds TTFT
    (arrival to first token, queueing included) and every later one ITL
    (the gap since the request's previous delta)."""

    def __init__(self, stats=None):
        self._stats = stats

    def _observe(self, req, now: float) -> None:
        if req.first_token_t == 0.0:
            if self._stats is not None and req.arrival_time_s:
                self._stats.ttft.record(now - req.arrival_time_s)
        elif self._stats is not None and req.last_emit_t:
            self._stats.itl.record(now - req.last_emit_t)
        req.last_emit_t = now

    def process_token(self, req, tok: int) -> RequestOutput:
        return self.process_tokens(req, [tok])

    def process_tokens(self, req, toks) -> RequestOutput:
        """Append a (possibly multi-token) delta and decide the finish state.
        A speculative verify round yields up to k + 1 tokens at once, scored
        before either cut was known, so the delta is cut here: first to the
        budget's headroom, then at the first stop token within it (the stop
        token itself kept).  A stop token on the budget's last place reports
        ``"stop"``: stop takes precedence over ``"length"``."""
        kept = []
        reason = None
        for tok in list(toks)[:max(req.max_new - len(req.out_tokens), 0)]:
            kept.append(int(tok))
            if tok in req.params.stop_tokens:
                reason = "stop"
                break
        req.out_tokens.extend(kept)
        now = time.perf_counter()
        if kept:
            self._observe(req, now)
            if req.first_token_t == 0.0:
                req.first_token_t = now
        if reason is None and len(req.out_tokens) >= req.max_new:
            reason = "length"
        if reason is not None:
            _finish(req, reason, now)
        return RequestOutput(
            request_id=req.request_id,
            new_token_ids=kept,
            token_ids=req.out_tokens,
            finished=reason is not None,
            finish_reason=reason,
        )

    @staticmethod
    def finalize_resumed(req) -> RequestOutput:
        """Terminal output for a restart that resumes exactly at its budget:
        every token was streamed before the eviction, so the stream is owed
        only a zero-delta ``finished`` output and a reason, rebuilt from the
        recorded tail ("stop" if the last token is a stop token)."""
        reason = req.finish_reason or (
            "stop" if req.out_tokens and req.out_tokens[-1] in req.params.stop_tokens
            else "length")
        _finish(req, reason)
        return RequestOutput(
            request_id=req.request_id,
            new_token_ids=[],
            token_ids=req.out_tokens,
            finished=True,
            finish_reason=req.finish_reason,
        )

    @staticmethod
    def finalize_dropped(req, reason: str) -> RequestOutput:
        """Terminal output for a request removed before it completed: a
        zero delta, finished, with ``reason``.  Tokens already streamed stand."""
        req.preempted = False
        _finish(req, reason)
        return RequestOutput(
            request_id=req.request_id,
            new_token_ids=[],
            token_ids=req.out_tokens,
            finished=True,
            finish_reason=reason,
        )

    @staticmethod
    def finalize_aborted(req) -> RequestOutput:
        """Terminal output for a cancelled request (``finish_reason="abort"``)."""
        return OutputProcessor.finalize_dropped(req, "abort")

    @staticmethod
    def resume_output(req) -> Optional[RequestOutput]:
        """Nothing to emit on a restart: the recorded tokens were streamed
        before the eviction, and the replay rebuilds the state exactly.  A
        hook for processors that surface resume events."""
        return None
