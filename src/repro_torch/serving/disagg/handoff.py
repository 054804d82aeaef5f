"""The KV handoff channel: finished prefill KV from the prefill pool to the
decode pool.

The disaggregated counterpart of the temporal engine's swap: where one
engine relayouts its KV into the decode cache between the phases, the two
pools hand a KV segment over — a monolithic prompt's relayed segment
(decode layout, quantized payload and scales under int8/int4), its raw
prefill-layout KV for a page write, or one chunk's f32 KV.  Both pools share
one card here, each on its own CUDA stream, so a segment does not move:
``ship()`` records an event on the producing stream (the segment's last
write) and marks the segment's memory as used by the consuming stream
(``record_stream``), so that the caching allocator does not hand it out
again before the decode stream has read it.  It makes no stream wait: a
chunk shipped eagerly lets the decode stream run on.

On the pod split of a mesh (``pod``, this rank's ``launch.mesh.PodMesh``,
and its ``role``) the pools are processes of their own, and a segment does
cross: ``ship()`` on a prefill rank sends its part over the pod axis's
group to the decode rank at its coordinates (``core.disagg.kv_transfer``),
and on that decode rank, called at the same point of the same step,
receives it.  Both sides count what the JAX
channel counts (``bytes_shipped`` the whole segment's bytes, every prefill
rank's part), and ``pod_bytes`` what crossed to or from this rank.

The channel also keeps the decode-side installs.  Installing a segment
means scattering it into the decode pool's cache, and the install must first
make the decode stream wait for the segment's event; a decode round after it
would then wait for the whole prefill chunk.  So installs are deferred until
the request joins the decode set (``drain()`` on its final chunk): the decode
rounds between chunks carry no dependency on the prefill in flight.  The
installed bytes are what the colocated engine writes, since a request's rows
and pages are its own until its first token is sampled and its installs
commute with the other slots' decode writes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.disagg import kv_transfer
from repro_torch.core.phase_engine import tensor_leaves
from repro_torch.obs.trace import TRACER

# Trace lane of the transfers: ship() runs on the prefill pool's thread
# (chunks) and on the engine's (monolithic swaps), but the transfers are one
# resource, so they share one track.
TRACE_LANE = "kv-handoff"


@dataclasses.dataclass(eq=False)
class Segment:
    """One shipped KV segment: the tensors, and the event recorded on the
    producing stream after their last write (None on the CPU)."""

    kv: Any
    ready: Optional["torch.cuda.Event"] = None

    def wait(self):
        """Make the current stream wait for the producer; returns the KV."""
        if self.ready is not None:
            torch.cuda.current_stream(self.ready.device).wait_event(self.ready)
        return self.kv


class KVHandoffChannel:
    """The handoff between the pools and the deferred decode-side installs.

    Threads: ``ship()`` runs on the engine's thread (monolithic swaps) and on
    the prefill pool's (chunks), so its counters are kept under a lock.  The
    install queue is the engine thread's alone: ``defer_install``,
    ``drain`` and ``discard`` run between quanta on it.
    """

    def __init__(self, pod=None, role: Optional[str] = None):
        # the split: this rank's pod mesh and pool, the prefill rank at this
        # rank's coordinates (the sender) and how many prefill ranks each
        # send a part of a segment
        self.pod, self.role = pod, role
        if pod is not None:
            from repro_torch.launch.mesh import pods

            prefill_pod = pods(pod.parent)[0]
            self._src = prefill_pod.ranks[pod.pod.ranks.index(pod.rank)]
            self._senders = prefill_pod.size
        # (slot, install thunk): installs run in ship order, and a slot's are
        # dropped before its pages can be reused (DisaggRunner.release)
        self._pending: List[Tuple[int, Callable[[], None]]] = []  # owned-by: engine-step
        self._lock = threading.Lock()
        self.segments = 0  # guarded-by: self._lock
        self.eager_segments = 0  # guarded-by: self._lock
        self.bytes_shipped = 0  # guarded-by: self._lock
        self.installs = 0  # guarded-by: self._lock
        self.discarded = 0  # guarded-by: self._lock
        self.t_dispatch = 0.0  # guarded-by: self._lock
        self.pod_bytes = 0  # guarded-by: self._lock

    # ------------------------------------------------------------ transfer --

    def _cross(self, tree, like):
        """The split: send ``tree`` (a prefill rank) or receive a tree
        shaped as ``like`` (a decode rank); returns it and the bytes
        moved."""
        if self.role == "prefill":
            return kv_transfer(tree, self.pod.pod_group, src=self._src)
        return kv_transfer(None, self.pod.pod_group, src=self._src, like=like,
                           device=self.pod.device)

    def ship(self, kv, *, eager: bool = False,
             consumer: Optional["torch.cuda.Stream"] = None, like=None) -> Segment:
        """Hand one KV segment, made on the current stream, to the decode
        pool, whose stream ``consumer`` will read it.  Returns the
        ``Segment``; ``eager`` marks a mid-prefill chunk, shipped while the
        rest of its prompt still computes.  On the split a prefill rank
        passes its part ``kv`` and a decode rank ``like`` (its shapes and
        dtypes, as ``meta`` tensors will do), and the decode rank's
        ``Segment`` holds what it received."""
        t0 = time.perf_counter()
        ready, moved, senders = None, 0, 1
        if self.pod is not None:
            kv, moved = self._cross(kv, like)
            senders = self._senders
        elif tensor_leaves(kv)[0].is_cuda:
            ready = torch.cuda.Event()
            ready.record()
            if consumer is not None:
                for t in tensor_leaves(kv):
                    t.record_stream(consumer)
        t1 = time.perf_counter()
        nbytes = sum(t.nbytes for t in tensor_leaves(kv)) * senders
        with self._lock:
            self.t_dispatch += t1 - t0
            self.segments += 1
            if eager:
                self.eager_segments += 1
            self.bytes_shipped += nbytes
            self.pod_bytes += moved
        if TRACER.enabled:
            TRACER.complete("handoff.ship", t0, t1, lane=TRACE_LANE, bytes=nbytes, eager=eager)
        return Segment(kv, ready)

    def ship_aux(self, tree, producer: Optional["torch.cuda.Stream"] = None, like=None):
        """Hand a small non-KV tree (a prompt's first-token logits) to the
        current stream, not counted as a segment: the current stream waits
        for everything enqueued on ``producer`` so far.  On the split it
        crosses as ``ship`` does (``like`` on a decode rank), its bytes in
        ``pod_bytes``."""
        if self.pod is not None:
            tree, moved = self._cross(tree, like)
            with self._lock:
                self.pod_bytes += moved
            return tree
        if producer is not None:
            torch.cuda.current_stream(producer.device).wait_stream(producer)
            for t in tensor_leaves(tree):
                t.record_stream(torch.cuda.current_stream(producer.device))
        return tree

    # ------------------------------------------------------------ installs --

    def defer_install(self, slot: int, install: Callable[[], None]) -> None:  # thread: engine-step
        """Queue one shipped segment's install (a thunk that waits for the
        segment on the current stream and scatters it into the cache the
        runner holds when it runs)."""
        self._pending.append((slot, install))

    def drain(self, slot: Optional[int] = None) -> int:  # thread: engine-step
        """Run the queued installs (one slot's, or all) in ship order, on
        the caller's stream; called when a request's prefill completes,
        before its first token is sampled.  Returns how many ran."""
        if slot is None:
            run, self._pending = self._pending, []
        else:
            run = [(s, f) for s, f in self._pending if s == slot]
            self._pending = [(s, f) for s, f in self._pending if s != slot]
        # on the caller's lane (the engine's thread): an install waits for
        # its segment's future, so it can overlap a ship still under way
        with TRACER.span("handoff.install", slot=slot, segments=len(run)):
            for _, install in run:
                install()
        with self._lock:
            self.installs += len(run)
        return len(run)

    def discard(self, slot: int) -> int:  # thread: engine-step
        """Drop a slot's queued installs (preemption, abort): its pages are
        about to be freed, and a late install would write into their next
        owner's."""
        keep = [(s, f) for s, f in self._pending if s != slot]
        n = len(self._pending) - len(keep)
        self._pending = keep
        with self._lock:
            self.discarded += n
        return n

    @property
    def pending(self) -> int:  # thread: engine-step
        return len(self._pending)

    # ------------------------------------------------------------- metrics --

    def snapshot(self) -> dict:  # thread: engine-step
        with self._lock:
            return {
                "segments": self.segments,
                "eager_segments": self.eager_segments,
                "bytes_shipped": self.bytes_shipped,
                "installs": self.installs,
                "discarded": self.discarded,
                "pending": self.pending,
                "t_dispatch_s": self.t_dispatch,
                "pod_bytes": self.pod_bytes,
            }
