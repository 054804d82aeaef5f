"""Hand-written CUDA kernels of the port and their launch counters.

``COUNTS[name]`` is an integer that a kernel's wrapper raises by one
(``COUNTS.add(name)``) where it launches the kernel, and nowhere else: a run
that set the counts to 0 first shows afterwards which kernels its path went
through.  Wrappers given CPU tensors run the plain PyTorch version and leave
the count alone.

Two host threads launch kernels at once on the disaggregated path (the
prefill pool's dispatch thread and the engine's), so an increment is one
locked add, never a read and a store that another thread's add can fall
between.  A CUDA graph's capture records what its own thread counts into
the capture (``COUNTS.recording()``), launches nothing, and leaves the
totals alone: another thread's launches during the capture still count.
Each launch outside a capture is also counted by its shape
(``COUNTS.shapes()``: the shard shapes a mesh rank launches at); a replay
adds to the totals only.

A kernel has no backward: autograd cannot see through a launch, so its
output would silently cut the graph.  Every launcher refuses a tensor that
requires grad while grad is enabled (``refuse_autograd``); training runs
the plain paths, as the JAX training step does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, MutableMapping

import torch

_NAMES = ("act_quant", "tlmm", "prefill_attention", "decode_attention", "decode_attention_quant",
          "paged_decode_attention", "paged_decode_attention_quant")


class LaunchCounts(MutableMapping):
    """The launch counters: a mapping of kernel name to launches, whose
    ``add`` is atomic across threads."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(names, 0)  # guarded-by: self._lock
        self._shapes: Dict[tuple, int] = {}  # guarded-by: self._lock
        self._local = threading.local()  # .record: the dict a capture on this thread fills

    def add(self, name: str, n: int = 1, shape: tuple = ()) -> None:
        """Count ``n`` launches of ``name`` at ``shape`` (into the capture
        under way on this thread, if there is one)."""
        record = getattr(self._local, "record", None)
        if record is not None:
            record[name] += n
            return
        with self._lock:
            self._counts[name] += n
            self._shapes[(name, shape)] = self._shapes.get((name, shape), 0) + n

    def shapes(self) -> Dict[tuple, int]:
        """{(name, shape): launches} of the launches outside captures since
        the last ``reset_counts``."""
        with self._lock:
            return dict(self._shapes)

    def clear_shapes(self) -> None:
        with self._lock:
            self._shapes.clear()

    def add_all(self, launches: Dict[str, int]) -> None:
        """Count a graph replay's launches, all under one lock."""
        with self._lock:
            for name, n in launches.items():
                self._counts[name] += n

    @contextlib.contextmanager
    def recording(self) -> Iterator[Dict[str, int]]:
        """Within the block, this thread's launches go into the yielded dict
        (a capture's) and not into the counts."""
        with self._lock:
            record = dict.fromkeys(self._counts, 0)
        self._local.record = record
        try:
            yield record
        finally:
            self._local.record = None

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def __setitem__(self, name: str, value: int) -> None:
        with self._lock:
            self._counts[name] = value

    def __delitem__(self, name: str) -> None:
        raise TypeError("a launch counter cannot be removed")

    def __iter__(self):
        with self._lock:
            return iter(list(self._counts))

    def __len__(self) -> int:
        with self._lock:
            return len(self._counts)

    def __repr__(self) -> str:
        with self._lock:
            return repr(self._counts)


COUNTS = LaunchCounts(_NAMES)


def refuse_autograd(what: str, *tensors) -> None:
    """Raises when grad is enabled and any of ``tensors`` requires grad:
    the launch of ``what`` would give an output with no gradient."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: a hand-written kernel has no backward; run it under "
                           "torch.no_grad() or on tensors that do not require grad "
                           "(training takes the plain paths)")


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    COUNTS.clear_shapes()
