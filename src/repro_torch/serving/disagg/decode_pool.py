"""The decode pool: a ``ModelRunner`` whose prefill computes on the prefill
pool.

``DisaggRunner`` keeps every decode-phase duty of the base runner — the
decode and verify programs, the paged pool or contiguous cache, the slots
and their sampling state, preemption replay — on the engine's stream (the
caller's current stream).  It overrides the prefill seam only:

* ``prefill``: the body and tail (or the full prefill) run on the attached
  ``PrefillPool``'s stream; the swap payload (contiguous: the relayed,
  possibly quantized, decode-layout segment made on the prefill side; paged:
  the raw f32 prefill-layout KV) crosses the ``KVHandoffChannel`` inside
  ``swap_write``, which the ``SwapController`` still overlaps with the tail,
  and is installed on the engine's stream by the colocated engine's writers
  (``install_relayed_kv``, the ``page_write`` program).

* ``run_prefill_chunk``: a chunk computes on the pool's dispatch thread and
  stream through ``prefill_chunk_kv`` and ships at once (eagerly), while its
  install (``page_write`` or ``chunk_write``: the fused chunk programs'
  writers) is deferred on the channel until the final chunk, so the decode
  rounds between chunks never wait for the prefill in flight.  A non-final
  chunk takes no host sync: the engine's thread only dispatches it, so
  ``t_prefill`` holds dispatch time and the final chunk's wait.

* ``release``: a slot's queued installs are dropped before its pages go
  home.

Every install writes the bytes the colocated engine writes, from the same f32
values, before the request's first token is sampled: greedy and sampled
streams equal the colocated ``EngineCore``'s on every layout and KV format.

On a card the pools' CUDA graphs are all captured by ``build_serving_grid``
before serving: a capture must not run while the other thread launches.  A
program first called later still captures safely: a chunk program's first
call waits for its own result, and a decode-side capture first waits for
the pool to go idle.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kv_cache import install_relayed_kv
from repro_torch.core.swap import SwapController
from repro_torch.layers.attention import KVCache
from repro_torch.obs.trace import TRACER
from repro_torch.serving.core import EngineStats, ModelRunner, Request, _sync
from repro_torch.serving.disagg.handoff import KVHandoffChannel
from repro_torch.serving.disagg.prefill_pool import PrefillPool, on_stream
from repro_torch.serving.paging import PrefixMatch


class DisaggRunner(ModelRunner):
    """A ``ModelRunner`` with its prefill on an attached ``PrefillPool``."""

    prefill_pool: Optional[PrefillPool] = None
    handoff: Optional[KVHandoffChannel] = None

    def attach(self, prefill_pool: PrefillPool, handoff: KVHandoffChannel) -> None:
        """Wire the pools together (``DisaggEngine`` calls it right after
        construction, before any request can prefill)."""
        layout = "paged" if self.paged is not None else "contiguous"
        for name, mine in (("mode", self.mode), ("cache_layout", layout),
                           ("kv_dtype", self.kv_dtype), ("prefill_chunk", self.prefill_chunk),
                           ("max_len", self.max_len), ("device", self.device)):
            if getattr(prefill_pool, name) != mine:
                raise ValueError(f"the prefill pool's {name} {getattr(prefill_pool, name)!r} "
                                 f"is not the decode pool's {mine!r}")
        self.prefill_pool = prefill_pool
        self.handoff = handoff
        # The f32 chunk-prefix mirror lives on the prefill pool: drop the one
        # the base constructor made (prefix_width reads chunk_cap, not it).
        self.chunk_prefix = None
        # a capture on the engine's thread first waits for the pool to go idle
        self.engine.before_capture(prefill_pool.quiesce)

    def _stream(self) -> Optional["torch.cuda.Stream"]:
        """The engine's stream: the caller's current one (None on the CPU)."""
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------ programs --

    def progs(self, bucket: int) -> dict:
        """The decode side of one prompt bucket (paged: its page write; the
        contiguous install is ``install_relayed_kv``); the prefill pool's
        programs for the bucket are built beside them."""
        self.prefill_pool.progs(bucket)
        if self.paged is not None:
            return {"write": self.engine.page_write_program(bucket, self.block_size)}
        return {}

    def chunk_prog(self, padded: int, prefix_width: int):
        """The decode side of one chunk shape: its install program (the
        prefill pool's compute program is ``pool.chunk_kv_prog``)."""
        self.prefill_pool.chunk_kv_prog(padded, prefix_width)
        if self.paged is not None:
            return self.engine.page_write_program(padded, self.block_size)
        return self.engine.chunk_write_program(padded)

    def _capture_chunk_programs(self, shapes) -> None:
        self.prefill_pool.build_grid(self.reachable_buckets(), shapes)

    # ------------------------------------------------------------- prefill --

    def prefill(self, req: Request, slot: int, stats: EngineStats,
                resuming: bool = False) -> torch.Tensor:
        """Monolithic prefill on the prefill pool, the handoff and the
        decode-side install: ``ModelRunner.prefill`` across two pools (the
        same allocation order, the same install writers, the same stats)."""
        pool, handoff = self.prefill_pool, self.handoff
        n = len(req.prompt)
        bucket = self.bucket(n)
        pprogs = pool.progs(bucket)
        match = None
        if self.paged is not None:
            match = self.paged.allocate_prompt(slot, np.asarray(req.prompt, np.int32))
            if not resuming:
                n_full = n // self.block_size
                stats.prefix_hits += match.cached_pages
                stats.prefix_misses += n_full - match.cached_pages
                stats.prefix_hit_tokens += match.cached_pages * self.block_size
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        last_pos = n - 1
        decode_stream = self._stream()

        def swap_write(kv):
            """The payload crosses the pools here, before the tail (the
            SwapController), so the relay and the install hide behind the
            tail's compute as the colocated relayout does."""
            if self.paged is not None:  # f32 pages; page_write quantizes on write
                seg = handoff.ship(kv, consumer=decode_stream)
                ids = self.paged.page_ids_for_write(match, bucket // self.block_size)
                with on_stream(decode_stream):
                    self.engine.page_write_program(bucket, self.block_size).fn(
                        self.paged.kv, seg.wait(), ids)
                return self.paged.kv
            relayed = (pprogs["relay"].fn(kv) if self.mode == "pdswap"
                       else pool.relay_static(kv))
            seg = handoff.ship(relayed, consumer=decode_stream)
            with on_stream(decode_stream):
                install_relayed_kv(self.cache, seg.wait(), slot)
            return self.cache

        t0 = time.perf_counter()
        with pool.on_stream():
            tokens = torch.from_numpy(padded).to(self.device)
            if self.mode == "pdswap":
                ctl = SwapController(pprogs["body"].fn,
                                     lambda p, x: pprogs["tail"].fn(p, x, last_pos),
                                     swap_write, side_stream=self._side_stream)
                logits, _, timing = ctl.prefill_and_swap(pool.params, tokens,
                                                         overlap=self.overlap)
                if not resuming:
                    stats.record_swap(timing)
                if TRACER.enabled:
                    TRACER.instant("swap", request_id=req.request_id,
                                   t_relayout=timing.t_relayout,
                                   hidden_fraction=timing.hidden_fraction)
            else:
                logits, kv = pprogs["full"].fn(pool.params, tokens, last_pos)
                swap_write(kv)
                _sync(self.device)
        # the first-token logits cross as well: the sampler reads them on the
        # engine's stream
        logits = handoff.ship_aux(logits, producer=pool.stream)
        t1 = time.perf_counter()
        if resuming:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
            stats.prefill_tokens += n
        if TRACER.enabled:
            TRACER.complete("prefill", t0, t1, request_id=req.request_id, tokens=n,
                            resuming=resuming)
        if match is not None:
            self.paged.register_prompt_pages(match)
        return logits

    # ------------------------------------------------------ chunked prefill --

    def run_prefill_chunk(self, req: Request, slot: int, start: int, size: int,
                          match: Optional[PrefixMatch], restarted: bool,
                          stats: EngineStats) -> Optional[torch.Tensor]:
        """One chunk computed on the prefill pool, shipped at once, its
        install deferred (the module's docstring says why).  Returns the
        final chunk's logits (1, Vp), None before."""
        pool, handoff = self.prefill_pool, self.handoff
        padded = self.chunk_bucket(size, start)
        if start + padded > self.chunk_cap:
            raise ValueError(f"chunk rows [{start}, {start + padded}) overflow the cache's "
                             f"{self.chunk_cap} rows")
        prog = pool.chunk_kv_prog(padded, self.prefix_width(start))
        tokens = np.zeros((padded,), np.int64)
        tokens[:size] = req.prompt[start:start + size]
        final = start + size == len(req.prompt)
        decode_stream = self._stream()
        t0 = time.perf_counter()

        def compute():  # thread: prefill-pool
            """The chunk's token upload, compute and ship, all on the pool's
            thread: the engine's thread dispatches no piece of the chunk,
            so its next decode round is queued behind none of it."""
            tc0 = time.perf_counter()
            toks, prefix_len, last_pos = pool.stage_chunk(tokens, start, size - 1)
            logits, chunk_kv, _ = prog(pool.params, toks, pool.chunk_prefix, prefix_len, last_pos)
            if prog.captured is not None and not final:
                # a replay returns the graph's buffers, which the program's
                # next replay (a later chunk of this shape) overwrites before
                # this install runs: keep a copy
                chunk_kv = KVCache(chunk_kv.k.clone(), chunk_kv.v.clone())
            shipped = handoff.ship(chunk_kv, eager=not final, consumer=decode_stream)
            if TRACER.enabled:  # on the pool's lane, beside the decode rounds
                TRACER.complete("prefill.chunk.compute", tc0, time.perf_counter(),
                                request_id=req.request_id, start=start, size=size)
            return logits, shipped

        fut = pool.submit(compute)
        if not prog.captured and self.device.type == "cuda":
            fut.result()  # a first call captures: nothing else may launch meanwhile
        if self.paged is not None:
            bs = self.block_size
            ids = self.paged.page_ids_for_write(match, padded // bs, first_page=start // bs)
            wprog = self.engine.page_write_program(padded, bs)

            def install():
                wprog.fn(self.paged.kv, fut.result()[1].wait(), ids)
        else:
            wprog = self.engine.chunk_write_program(padded)

            def install():
                wprog.fn(self.cache, fut.result()[1].wait(), slot, start)

        handoff.defer_install(slot, install)
        logits = None
        if final:
            # the request joins the decode set: land its segments in ship
            # order, then wait for them and for the logits its first token
            # is drawn from
            handoff.drain(slot)
            logits = handoff.ship_aux(fut.result()[0], producer=pool.stream)
            _sync(self.device)
        t1 = time.perf_counter()
        if restarted:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
        stats.prefill_chunks += 1
        if TRACER.enabled:  # the engine's side: dispatch, and the final chunk's wait
            TRACER.complete("prefill.chunk.dispatch", t0, t1, request_id=req.request_id,
                            start=start, size=size, final=final)
        return logits

    # ------------------------------------------------------------- release --

    def release(self, slot: int) -> None:
        """Finish, preemption or abort: drop the slot's queued installs
        first, since its pages go home now and a late install would write
        into their next owner's."""
        if self.handoff is not None:
            self.handoff.discard(slot)
        super().release(slot)
