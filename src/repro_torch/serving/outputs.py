"""Output side of the serving core: incremental ``RequestOutput`` deltas and
finish-reason detection (stop token -> ``"stop"``, token budget ->
``"length"``), TTFT stamping included.  The JAX package's tracer
calls are not ported yet (observability is ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


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
    With ``stats`` (an ``EngineStats``), the first token of a request feeds
    TTFT (arrival to first token)."""

    def __init__(self, stats=None):
        self._stats = stats

    def process_token(self, req, tok: int) -> RequestOutput:
        """Append one token (unless the budget is spent), then decide the
        finish state: a stop token takes precedence over the budget."""
        kept = []
        reason = None
        if len(req.out_tokens) < req.max_new:
            kept.append(int(tok))
            if tok in req.params.stop_tokens:
                reason = "stop"
        req.out_tokens.extend(kept)
        if kept and req.first_token_t == 0.0:
            req.first_token_t = time.perf_counter()
            if self._stats is not None and req.arrival_time_s:
                self._stats.ttft.record(req.first_token_t - req.arrival_time_s)
        if reason is None and len(req.out_tokens) >= req.max_new:
            reason = "length"
        if reason is not None:
            req.finish_reason = reason
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
        if req.finish_reason is None:
            stopped = req.out_tokens and req.out_tokens[-1] in req.params.stop_tokens
            req.finish_reason = "stop" if stopped else "length"
        return RequestOutput(
            request_id=req.request_id,
            new_token_ids=[],
            token_ids=req.out_tokens,
            finished=True,
            finish_reason=req.finish_reason,
        )
