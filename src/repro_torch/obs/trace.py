"""Process-wide tracer: a bounded ring buffer of spans and a Chrome trace
export.

The port of the JAX package's ``repro.obs.trace``.  The serving stack
records request lifecycle events (submit, admit, prefill chunk, decode
round, verify, preempt, replay, shed, abort, finish) and engine spans
(step, prefill, swap) into the module's ``TRACER``.  Disabled, every call
is one attribute check (hot sites guard with ``if TRACER.enabled``).

Spans are stamped with host clocks that the caller took where the engine
already waits for the device (a chunk's synchronize, the end of a prefill,
a round's token read), so tracing adds no device operation and no sync: a
captured round replays the same graph with it on or off.

Events land in a ``deque(maxlen=capacity)``: a long run keeps the most
recent window, and ``dropped`` counts the evicted events.
``export_chrome_trace()`` writes the Chrome trace-event JSON format
(chrome://tracing, Perfetto): complete events (``ph: "X"``) and instants
(``ph: "i"``), one lane (``tid``) a thread by default, so the event loop,
the engine's step thread and named lanes render as separate tracks.

``finish()`` is the one funnel for terminal lifecycle events.  While the
tracer records, a request that finishes twice raises.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """The no-op context manager ``span()`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_lane", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, lane: Optional[str], args):
        self._tr = tr
        self._name = name
        self._lane = lane
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tr.complete(self._name, self._t0, time.perf_counter(), lane=self._lane,
                          **(self._args or {}))
        return False


class Tracer:
    """Ring-buffer event recorder with a Chrome trace export.

    An event is a tuple, ``("X", name, t0, dur, lane, args)`` for a span and
    ``("i", name, t, lane, args)`` for an instant, appended to a
    ``deque(maxlen=...)``; ``deque.append`` is atomic under the interpreter
    lock, so the engine's thread and the event loop record without a lock.
    """

    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._lock = threading.Lock()
        self._configure(capacity)

    # analysis: allow(lock:unguarded) — callers hold self._lock (enable, clear);
    # __init__ calls it on an object no other thread holds yet
    def _configure(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = capacity  # guarded-by: self._lock
        self._events: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        self._emitted = 0  # guarded-by: self._lock
        self._finished: set = set()  # guarded-by: self._lock
        self._t0 = time.perf_counter()  # guarded-by: self._lock

    def enable(self, capacity: Optional[int] = None) -> None:
        """Start recording into a fresh buffer of ``capacity`` events."""
        with self._lock:
            self._configure(capacity or self.capacity)
            self.enabled = True

    def disable(self) -> None:
        """Stop recording; the buffered events stay exportable."""
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._configure(self.capacity)

    @property
    # analysis: allow(lock:unguarded) — a monitoring read: a torn emitted/len
    # pair can misreport dropped by one scrape, never corrupt it
    def dropped(self) -> int:
        """Events evicted by the ring bound (emitted minus retained)."""
        return self._emitted - len(self._events)

    # analysis: allow(lock:unguarded) — list(deque) copies under the
    # interpreter lock; tests and benchmarks read it, not the export
    def events(self) -> List[tuple]:
        return list(self._events)

    # analysis: allow(lock:unguarded) — the lock-free hot path (class
    # docstring): deque.append and an int add are atomic enough for metering,
    # and a lock here would serialize the engine's and the pool's threads
    def complete(self, name: str, t0: float, t1: float, lane: Optional[str] = None,
                 **args) -> None:
        """Record a span from ``perf_counter`` stamps the caller took."""
        if not self.enabled:
            return
        self._emitted += 1
        self._events.append(("X", name, t0, max(t1 - t0, 0.0),
                             lane or threading.current_thread().name, args or None))

    def span(self, name: str, lane: Optional[str] = None, **args):
        """A context-manager span, for cold paths."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, lane, args)

    # analysis: allow(lock:unguarded) — the lock-free hot path, as complete()
    def instant(self, name: str, lane: Optional[str] = None, **args) -> None:
        if not self.enabled:
            return
        self._emitted += 1
        self._events.append(("i", name, time.perf_counter(),
                             lane or threading.current_thread().name, args or None))

    # analysis: allow(lock:unguarded) — _finished is touched by the finish
    # paths only, which all run on the engine's step thread (the funnel this
    # method asserts); set.add is atomic under the interpreter lock besides
    def finish(self, request_id: str, reason: Optional[str]) -> None:
        """The terminal lifecycle event, exactly once a request: every finish
        path (stop and length, a resume at its budget, shed, abort) comes
        through here, and a second finish of one id while recording raises."""
        if not self.enabled:
            return
        if request_id in self._finished:
            raise RuntimeError(
                f"duplicate finish event for request {request_id!r} (reason={reason!r}): "
                "a request must finish exactly once")
        self._finished.add(request_id)
        self.instant("req.finish", request_id=request_id, reason=reason)

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON dict: one ``tid`` a lane in first-seen
        order, named by ``"M"`` thread_name metadata; timestamps in
        microseconds since the last ``enable()`` or ``clear()``."""
        with self._lock:
            events = list(self._events)
            t0 = self._t0
        lanes: Dict[str, int] = {}

        def tid(lane: str) -> int:
            if lane not in lanes:
                lanes[lane] = len(lanes) + 1
            return lanes[lane]

        out: List[Dict[str, Any]] = []
        for ev in events:
            if ev[0] == "X":
                _, name, ts, dur, lane, args = ev
                rec: Dict[str, Any] = {"name": name, "ph": "X", "pid": 1, "tid": tid(lane),
                                       "ts": (ts - t0) * 1e6, "dur": dur * 1e6}
            else:
                _, name, ts, lane, args = ev
                rec = {"name": name, "ph": "i", "s": "t", "pid": 1, "tid": tid(lane),
                       "ts": (ts - t0) * 1e6}
            if args:
                rec["args"] = dict(args)
            out.append(rec)
        meta: List[Dict[str, Any]] = []
        for lane, lane_tid in lanes.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": lane_tid,
                         "args": {"name": lane}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 1, "tid": lane_tid,
                         "args": {"sort_index": lane_tid}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> Dict[str, Any]:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


# The process-wide tracer every site records into (sites hold it directly,
# so it is never rebound: declared shared, so the ``lock`` analysis pass
# flags a rebind).  Tests that run several engines call ``clear()`` between
# them, so that the exactly-once finish set does not span runs.
# analysis: shared-global(TRACER)
TRACER = Tracer()
