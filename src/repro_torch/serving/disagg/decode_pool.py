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

On the pod split of a mesh (``role``, with this rank's pod mesh as the
runner's ``mesh``: a ``launch.mesh.PodMesh``) each rank is one pool's: every
rank keeps the engine's host state (slots, pages, sampling state) in
lockstep, rank 0 admitting, but a prefill rank holds no cache (its cache
and pages lie on the ``meta`` device: bookkeeping only) and a decode rank
no prefill program.  A prefill rank prefills and ships; a decode rank
receives at the same point of the same step, installs into its rows, and
runs the decode rounds, whose tokens it broadcasts to the prefill pod.
Both sample the first token from the same logits.  Under speculative
decoding the decode pod runs the verify rounds and broadcasts their
targets the same way; every rank drafts from its host state (the prompts
and the tokens so far), which is the same on every rank.

On a card the pools' CUDA graphs are all captured by ``build_serving_grid``
before serving: a capture must not run while the other thread launches.  A
program first called later still captures safely: a chunk program's first
call waits for its own result, and a decode-side capture first waits for
the pool to go idle.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.kv_cache import install_relayed_kv
from repro_torch.core.swap import SwapController, SwapTiming
from repro_torch.layers.attention import KVCache
from repro_torch.obs.trace import TRACER
from repro_torch.quant.kv_quant import QuantKV
from repro_torch.serving.core import EngineStats, ModelRunner, Request, _sync
from repro_torch.serving.disagg.handoff import KVHandoffChannel
from repro_torch.serving.disagg.prefill_pool import PrefillPool, on_stream
from repro_torch.serving.paging import PrefixMatch


class DisaggRunner(ModelRunner):
    """A ``ModelRunner`` with its prefill on an attached ``PrefillPool``
    (``role``: on the pod split of a mesh, this rank's pool, "prefill" or
    "decode", its pod's mesh the runner's ``mesh``; None with both pools in
    this process)."""

    prefill_pool: Optional[PrefillPool] = None
    handoff: Optional[KVHandoffChannel] = None

    def __init__(self, *args, role: Optional[str] = None, **kw):
        self.role = role
        super().__init__(*args, **kw)

    def _kv_device(self, mirror: bool = False) -> torch.device:
        """A prefill rank of the split keeps the cache's bookkeeping only (its
        tensors on ``meta``); the runner's mirror is never used there (the
        prefill pool keeps its own)."""
        if self.role is not None and (mirror or self.role == "prefill"):
            return torch.device("meta")
        return self.device

    def attach(self, prefill_pool: Optional[PrefillPool], handoff: KVHandoffChannel) -> None:
        """Wire the pools together (``DisaggEngine`` calls it right after
        construction, before any request can prefill).  A decode rank of the
        split has no prefill pool."""
        layout = "paged" if self.paged is not None else "contiguous"
        if prefill_pool is not None:
            for name, mine in (("mode", self.mode), ("cache_layout", layout),
                               ("kv_dtype", self.kv_dtype), ("prefill_chunk", self.prefill_chunk),
                               ("max_len", self.max_len), ("device", self.device)):
                if getattr(prefill_pool, name) != mine:
                    raise ValueError(f"the prefill pool's {name} {getattr(prefill_pool, name)!r} "
                                     f"is not the decode pool's {mine!r}")
            # a capture on the engine's thread first waits for the pool to go idle
            self.engine.before_capture(prefill_pool.quiesce)
        self.prefill_pool = prefill_pool
        self.handoff = handoff
        # The f32 chunk-prefix mirror lives on the prefill pool: drop the one
        # the base constructor made (prefix_width reads chunk_cap, not it).
        self.chunk_prefix = None

    def _stream(self) -> Optional["torch.cuda.Stream"]:
        """The engine's stream: the caller's current one (None on the CPU)."""
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------ programs --

    def progs(self, bucket: int) -> dict:
        """The decode side of one prompt bucket (paged: its page write; the
        contiguous install is ``install_relayed_kv``); the prefill pool's
        programs for the bucket are built beside them (on the split, each
        pool's on its own ranks)."""
        if self.role != "decode":
            self.prefill_pool.progs(bucket)
        if self.role == "prefill":
            return {}
        if self.paged is not None:
            return {"write": self.engine.page_write_program(bucket, self.block_size)}
        return {}

    def chunk_prog(self, padded: int, prefix_width: int):
        """The decode side of one chunk shape: its install program (the
        prefill pool's compute program is ``pool.chunk_kv_prog``)."""
        if self.role != "decode":
            self.prefill_pool.chunk_kv_prog(padded, prefix_width)
        if self.role == "prefill":
            return None
        if self.paged is not None:
            return self.engine.page_write_program(padded, self.block_size)
        return self.engine.chunk_write_program(padded)

    def _capture_chunk_programs(self, shapes) -> None:
        if self.role != "decode":
            self.prefill_pool.build_grid(self.reachable_buckets(), shapes)

    def _build_decode_grid(self) -> None:
        """A prefill rank of the split decodes nothing: its samplers only
        (the first token is drawn on both pods)."""
        if self.role != "prefill":
            super()._build_decode_grid()
            return
        self.engine.sampler_program(len(self.slots.slots))
        self.engine.sampler_program(1)

    # -------------------------------------------------------------- decode --

    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """The decode program, on the decode pool's ranks only (a prefill
        rank of the split replays a restart's pages as bookkeeping)."""
        if self.role == "prefill":
            return None
        return super()._decode(tokens, lengths)

    def decode_tokens(self, lengths: torch.Tensor, inflight: Dict[int, Request]):
        """One decode round.  On the split the decode pod runs it and the
        first decode rank broadcasts the tokens to every rank (the host
        group), so that both pods' host state moves on together."""
        if self.role is None:
            return super().decode_tokens(lengths, inflight)
        if self.role == "decode":
            next_tokens, next_np = super().decode_tokens(lengths, inflight)
            self._from_decode_pod(next_np)
            return next_tokens, next_np
        host = self._from_decode_pod(np.zeros((len(self.slots.slots),), np.int64))
        return torch.from_numpy(host), host

    def verify_tokens(self, tokens: np.ndarray, n_tokens: np.ndarray,
                      inflight: Dict[int, Request]) -> np.ndarray:
        """One verify round.  On the split the decode pod runs the verify
        pass and the first decode rank broadcasts its targets (B, W) to
        every rank, as ``decode_tokens`` its tokens: the drafts of the next
        round come from host state (the prompts and the tokens so far),
        which every rank then holds equal."""
        if self.role is None:
            return super().verify_tokens(tokens, n_tokens, inflight)
        if self.role == "decode":
            return self._from_decode_pod(super().verify_tokens(tokens, n_tokens, inflight))
        return self._from_decode_pod(np.zeros(tokens.shape, np.int64))

    def _from_decode_pod(self, host: np.ndarray) -> np.ndarray:
        """``host`` (int) as the first decode rank holds it, on every rank of
        the split (one broadcast over the world's host group)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import pods

        box = torch.from_numpy(np.ascontiguousarray(host, np.int64))
        world = self.mesh.parent
        dist.broadcast(box, src=pods(world)[1].ranks[0], group=world.host_group)
        return box.numpy()

    # ------------------------------------------------------------ the split --

    def _segment_like(self, rows: Optional[int] = None) -> KVCache:
        """The shapes and dtypes of a segment a decode rank of the split
        receives, as ``meta`` tensors: with ``rows``, that many rows of a
        prefill rank's heads, f32 (L, 1, Hkv / tp, rows, D) (a chunk, or a
        paged prompt's prefill KV); else a contiguous prompt's relayed
        segment, one slot of this rank's cache (f32 under "fp": the install
        casts)."""
        if rows is None:
            return KVCache(*(QuantKV(torch.empty_like(buf.q[:1], device="meta"),
                                     torch.empty_like(buf.scale[:1], device="meta"))
                             if isinstance(buf, QuantKV) else
                             torch.empty(buf[:1].shape, device="meta") for buf in self.cache))
        cfg = self.cfg
        shape = (cfg.num_layers, 1, cfg.num_kv_heads // self.engine.prefill_ctx.tp_size, rows,
                 cfg.head_dim)
        return KVCache(torch.empty(shape, device="meta"), torch.empty(shape, device="meta"))

    def _logits_like(self) -> torch.Tensor:
        """A prompt's first-token logits (1, Vp) f32, as ``meta``."""
        return torch.empty((1, self.cfg.padded_vocab()), device="meta")

    # ------------------------------------------------------------- prefill --

    def prefill(self, req: Request, slot: int, stats: EngineStats,
                resuming: bool = False) -> torch.Tensor:
        """Monolithic prefill on the prefill pool, the handoff and the
        decode-side install: ``ModelRunner.prefill`` across two pools (the
        same allocation order, the same install writers, the same stats)."""
        if self.role is not None:
            return self._split_prefill(req, slot, stats, resuming)
        pool, handoff = self.prefill_pool, self.handoff
        n = len(req.prompt)
        bucket = self.bucket(n)
        pprogs = pool.progs(bucket)
        match = self._allocate(req, slot, stats, resuming)
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
        self._charge_prefill(req, stats, t0, resuming, match)
        return logits

    def _charge_prefill(self, req: Request, stats: EngineStats, t0: float, resuming: bool,
                        match: Optional[PrefixMatch]) -> None:
        """A monolithic prefill's time and tokens in the stats (a restart's
        in ``t_replay``), its trace span, and its pages in the prefix
        cache."""
        t1 = time.perf_counter()
        if resuming:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
            stats.prefill_tokens += len(req.prompt)
        if TRACER.enabled:
            TRACER.complete("prefill", t0, t1, request_id=req.request_id,
                            tokens=len(req.prompt), resuming=resuming)
        if match is not None:
            self.paged.register_prompt_pages(match)

    @staticmethod
    def _charge_chunk(stats: EngineStats, t0: float, restarted: bool) -> float:
        """A chunk's time in the stats (a restart's in ``t_replay``); returns
        its end."""
        t1 = time.perf_counter()
        if restarted:
            stats.t_replay += t1 - t0
        else:
            stats.t_prefill += t1 - t0
        stats.prefill_chunks += 1
        return t1

    def _allocate(self, req: Request, slot: int, stats: EngineStats, resuming: bool):
        """Paged: the prompt's pages and the prefix-cache counts (None
        contiguous)."""
        if self.paged is None:
            return None
        match = self.paged.allocate_prompt(slot, np.asarray(req.prompt, np.int32))
        if not resuming:
            n_full = len(req.prompt) // self.block_size
            stats.prefix_hits += match.cached_pages
            stats.prefix_misses += n_full - match.cached_pages
            stats.prefix_hit_tokens += match.cached_pages * self.block_size
        return match

    def _split_prefill(self, req: Request, slot: int, stats: EngineStats,
                       resuming: bool) -> torch.Tensor:
        """Monolithic prefill on the split.  A prefill rank runs the body and
        tail on its heads and ships, inside the swap: contiguous, its rows of
        the relayed segment (the relay exchanges heads to rows); paged, its
        heads' prefill KV.  A decode rank receives at the same point and
        installs (paged: the page write gathers the heads).  Then the
        first-token logits cross.  Both record the same counts; a decode
        rank's swap time is its receive and install."""
        handoff = self.handoff
        n = len(req.prompt)
        bucket = self.bucket(n)
        match = self._allocate(req, slot, stats, resuming)
        t0 = time.perf_counter()
        if self.role == "prefill":
            pool = self.prefill_pool
            pprogs = pool.progs(bucket)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = req.prompt
            last_pos = n - 1

            def swap_write(kv):
                if self.paged is None:
                    kv = pprogs["relay"].fn(kv) if self.mode == "pdswap" else pool.relay_static(kv)
                handoff.ship(kv)

            tokens = torch.from_numpy(padded).to(self.device)
            if self.mode == "pdswap":
                ctl = SwapController(pprogs["body"].fn,
                                     lambda p, x: pprogs["tail"].fn(p, x, last_pos),
                                     swap_write, side_stream=self._side_stream)
                logits, _, timing = ctl.prefill_and_swap(pool.params, tokens,
                                                         overlap=self.overlap)
            else:
                logits, kv = pprogs["full"].fn(pool.params, tokens, last_pos)
                swap_write(kv)
            logits = handoff.ship_aux(logits)
        else:
            seg = handoff.ship(None, like=self._segment_like(bucket if self.paged is not None
                                                             else None))
            if self.paged is not None:
                ids = self.paged.page_ids_for_write(match, bucket // self.block_size)
                self.engine.page_write_program(bucket, self.block_size).fn(self.paged.kv, seg.kv,
                                                                           ids)
            else:
                install_relayed_kv(self.cache, seg.kv, slot)
            logits = handoff.ship_aux(None, like=self._logits_like())
            _sync(self.device)
            timing = SwapTiming(t_relayout=time.perf_counter() - t0)
        if self.mode == "pdswap" and not resuming:
            stats.record_swap(timing)
        self._charge_prefill(req, stats, t0, resuming, match)
        return logits

    # ------------------------------------------------------ chunked prefill --

    def run_prefill_chunk(self, req: Request, slot: int, start: int, size: int,
                          match: Optional[PrefixMatch], restarted: bool,
                          stats: EngineStats) -> Optional[torch.Tensor]:
        """One chunk computed on the prefill pool, shipped at once, its
        install deferred (the module's docstring says why).  Returns the
        final chunk's logits (1, Vp), None before."""
        if self.role is not None:
            return self._split_chunk(req, slot, start, size, match, restarted, stats)
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
        t1 = self._charge_chunk(stats, t0, restarted)
        if TRACER.enabled:  # the engine's side: dispatch, and the final chunk's wait
            TRACER.complete("prefill.chunk.dispatch", t0, t1, request_id=req.request_id,
                            start=start, size=size, final=final)
        return logits

    def _split_chunk(self, req: Request, slot: int, start: int, size: int,
                     match: Optional[PrefixMatch], restarted: bool,
                     stats: EngineStats) -> Optional[torch.Tensor]:
        """One chunk on the split: a prefill rank computes it on its heads
        against its heads' mirror and ships that KV; a decode rank receives
        it and defers its install (the page write or the chunk writer, each
        gathering the heads), and a prefill rank defers none (it counts
        one, so that the ranks' counters agree).  The final chunk drains the
        slot's installs, and its logits cross."""
        handoff = self.handoff
        padded = self.chunk_bucket(size, start)
        if start + padded > self.chunk_cap:
            raise ValueError(f"chunk rows [{start}, {start + padded}) overflow the cache's "
                             f"{self.chunk_cap} rows")
        final = start + size == len(req.prompt)
        t0 = time.perf_counter()
        logits = None
        if self.role == "prefill":
            pool = self.prefill_pool
            prog = pool.chunk_kv_prog(padded, self.prefix_width(start))
            tokens = np.zeros((padded,), np.int64)
            tokens[:size] = req.prompt[start:start + size]
            toks, prefix_len, last_pos = pool.stage_chunk(tokens, start, size - 1)
            logits, chunk_kv, _ = prog(pool.params, toks, pool.chunk_prefix, prefix_len, last_pos)
            handoff.ship(chunk_kv, eager=not final)

            def install():
                pass
        else:
            seg = handoff.ship(None, eager=not final, like=self._segment_like(padded))
            if self.paged is not None:
                bs = self.block_size
                ids = self.paged.page_ids_for_write(match, padded // bs, first_page=start // bs)
                wprog = self.engine.page_write_program(padded, bs)

                def install():
                    wprog.fn(self.paged.kv, seg.kv, ids)
            else:
                wprog = self.engine.chunk_write_program(padded)

                def install():
                    wprog.fn(self.cache, seg.kv, slot, start)

        handoff.defer_install(slot, install)
        if final:
            handoff.drain(slot)
            logits = handoff.ship_aux(logits, like=self._logits_like())
            _sync(self.device)
        t1 = self._charge_chunk(stats, t0, restarted)
        if TRACER.enabled:
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
