"""The prefill pool: the prefill phase's programs on their own stream and
dispatch thread.

One ``PrefillPool`` holds what the prefill phase needs and nothing the
decode phase does: its own ``PhaseEngine`` (so its CUDA graphs have a memory
pool of their own, replaying beside the decode pool's), its own CUDA stream,
a single dispatch thread (``prefill-pool``) for chunks, the per-bucket body,
tail, full and relay programs, the compute-only chunk program, the f32
chunk-prefix mirror, and pinned staging for a chunk's tokens and scalars.
On one card it shares the decode pool's weights: the static region is one
set of tensors, as the JAX pool's without a mesh.

On the pod split of a mesh (``mesh``, this rank's ``PodMesh`` of the
prefill pod) the pool is its own processes: each rank holds its slice of
the weights and runs the programs on its heads, with no dispatch thread
and no second stream (a chunk runs on the caller's thread, between the
decode pod's rounds), and keeps the mirror of its heads.

The decode pool (``DisaggRunner``) calls in here for every prefill and
ships what comes out through the ``KVHandoffChannel``.  The tokens equal
the colocated engine's because the programs are the same bodies on the same
inputs: ``prefill_split_programs_varlen``, ``prefill_program_varlen`` and
``prefill_chunk_kv_program`` share their math with the fused programs, and
the relay stores what the fused relayout stores.
"""
from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.phase_engine import PhaseEngine, PhaseProgram
from repro_torch.core.staging import StagedTensor
from repro_torch.layers.attention import KVCache
from repro_torch.serving.paging import cdiv


def on_stream(stream):
    """A context in which work is enqueued on ``stream`` (None, on the CPU:
    nothing to switch)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _deprioritize() -> None:
    """Drop the pool's dispatch thread to the lowest scheduling priority:
    decode is the latency-critical phase, and where both pools' host work
    competes for the same cores, prefill should take only what decode leaves.
    ``SCHED_IDLE`` first (an idle-class thread yields at once to any
    normal-class wakeup, where a nice-19 one keeps the core for a slice),
    else nice 19.

    It is the executor's initializer, and an initializer that raises breaks
    the executor for good, so it never raises: a host that forbids either
    (no such call, no permission) leaves the thread at normal priority."""
    try:
        os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
        return
    except (AttributeError, OSError, ValueError):
        pass
    try:
        get_native_id = getattr(threading, "get_native_id", None)
        if get_native_id is not None:
            os.setpriority(os.PRIO_PROCESS, get_native_id(), 19)
    except (AttributeError, OSError, ValueError):
        pass


class PrefillPool:
    """The prefill phase's engine for one device."""

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device, max_len: int,
                 mode: str = "pdswap", cache_layout: str = "contiguous", block_size: int = 16,
                 kv_dtype: str = "fp", prefill_chunk: Optional[int] = None, mesh=None):
        if mode not in ("pdswap", "static"):
            raise ValueError(f"mode must be 'pdswap' or 'static', got {mode!r}")
        self.cfg = cfg
        self.device = device
        self.mode = mode
        self.cache_layout = cache_layout
        self.kv_dtype = kv_dtype
        self.max_len = max_len
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        # one device: the decode pool's tensors, one copy of the weights; the
        # split: this rank's slice
        self.params = params
        self.mesh = mesh
        self.engine = PhaseEngine(cfg, mesh, cache_layout=cache_layout, kv_dtype=kv_dtype)
        # Its own stream, at the lowest priority (0, which the default stream
        # has too: it yields nothing to decode work on the default stream,
        # and takes nothing from a decode stream of higher priority).
        self.stream = (torch.cuda.Stream(device, priority=0)
                       if device.type == "cuda" and mesh is None else None)
        # the chunks' dispatch thread: a chunk enters from here, so the
        # engine's thread is free to dispatch decode rounds meanwhile
        self._exec = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefill-pool",
                                         initializer=_deprioritize) if mesh is None else None)
        # The f32 chunk-prefix mirror lives where the chunks compute; only
        # the dispatch thread touches it after construction (one worker keeps
        # the chunks in order through it).
        self.chunk_prefix: Optional[KVCache] = None  # owned-by: prefill-pool
        self.chunk_cap = None
        if prefill_chunk is not None:
            self.chunk_cap = (cdiv(max_len, block_size) * block_size
                              if cache_layout == "paged" else max_len)
            heads = cfg.num_kv_heads // self.engine.prefill_ctx.tp_size  # the split: its heads
            shape = (cfg.num_layers, 1, heads, self.chunk_cap, cfg.head_dim)
            self.chunk_prefix = KVCache(torch.zeros(shape, device=device),
                                        torch.zeros(shape, device=device))
            # a chunk's tokens and (prefix_len, last_pos), staged on this
            # pool's stream (the runner's staging is fenced for the engine's)
            self._tokens = StagedTensor((1, self.chunk_cap), torch.int64, device)
            self._scalars = StagedTensor((2,), torch.int32, device)

    # ------------------------------------------------------------ dispatch --

    def on_stream(self):
        """A context in which work is enqueued on the pool's stream."""
        return on_stream(self.stream)

    def submit(self, fn: Callable) -> Future:
        """Run ``fn`` (a chunk's compute and ship) on the pool's dispatch
        thread, on the pool's stream.  One worker keeps the chunks in order.
        On the split it runs here and now (a finished ``Future``)."""
        if self._exec is None:
            fut: Future = Future()
            fut.set_result(fn())
            return fut

        def run():  # thread: prefill-pool
            with self.on_stream():
                return fn()

        return self._exec.submit(run)

    def quiesce(self) -> None:
        """Wait until the dispatch thread has run everything submitted so
        far: a graph captured on another thread may not overlap its
        launches (the capture then waits for the card itself)."""
        if self._exec is not None and not threading.current_thread().name.startswith(
                "prefill-pool"):
            self._exec.submit(int).result()

    def stage_chunk(self, tokens: np.ndarray, prefix_len: int,
                    last_pos: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A chunk's tokens (1, C) and its 0-d scalars, written into the
        pool's static device tensors on the current (the pool's) stream;
        called on the dispatch thread."""
        c = len(tokens)
        buf = np.zeros((1, self.chunk_cap), np.int64)
        buf[0, :c] = tokens
        dev = self._tokens.upload(buf)[:, :c]
        scalars = self._scalars.upload([prefix_len, last_pos])
        return dev, scalars[0], scalars[1]

    # ------------------------------------------------------------ programs --

    def progs(self, bucket: int) -> dict:
        """The prefill programs for one prompt bucket (the engine keeps them
        by key): body and tail, or the full prefill, and, contiguous in
        pdswap mode, the relay, so that the segment crosses already in
        decode layout (the static mode's is ``relay_static``)."""
        p: dict = {}
        if self.mode == "pdswap":
            p["body"], p["tail"] = self.engine.prefill_split_programs_varlen(1, bucket)
        else:
            p["full"] = self.engine.prefill_program_varlen(1, bucket)
        if self.cache_layout != "paged" and self.mode == "pdswap":
            p["relay"] = self.engine.relay_program(bucket, self.max_len)
        return p

    def relay_static(self, kv):
        """The static mode's relay: the relay program of the KV's bucket."""
        return self.engine.relay_program(kv.k.shape[3], self.max_len).fn(kv)

    def chunk_kv_prog(self, padded: int, prefix_width: int) -> PhaseProgram:
        """The compute-only chunk program for one (padded chunk length,
        prefix width) pair."""
        return self.engine.prefill_chunk_kv_program(padded, prefix_width)

    def build_grid(self, buckets: Sequence[int], chunk_shapes: Sequence[tuple]) -> None:
        """Build every bucket's and chunk shape's program and, on a card,
        run each chunk program once on the dispatch thread (its warm-up and
        its capture as a CUDA graph), waiting for it: nothing else may
        launch while a graph captures.  The idle runs write mirror rows no
        prompt holds while none is in flight."""
        for b in buckets:
            self.progs(b)
        progs = [self.chunk_kv_prog(padded, pw) for padded, pw in chunk_shapes]
        if self.device.type != "cuda" or not progs:
            return

        def warm():  # thread: prefill-pool
            _, start, last = self.stage_chunk(np.zeros((0,), np.int64), 0, 0)
            for prog, (padded, _) in zip(progs, chunk_shapes):
                prog(self.params, self._tokens.dev[:, :padded], self.chunk_prefix, start, last)
            torch.cuda.synchronize(self.device)

        self.submit(warm).result()
