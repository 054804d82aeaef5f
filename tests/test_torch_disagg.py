"""The port's disaggregated prefill and decode pools against the JAX package's,
on the CPU.

The config is the JAX package's own ``tests/test_disagg_serving.py`` one (3
layers, d_model 128, vocab 512, 4 heads over 2 KV heads); the same packed
weights, made with numpy from a seed, go into both packages.  The JAX
``DisaggEngine`` runs its two pools colocated on the CPU and its Pallas
kernels in interpret mode (``use_pallas=True``); the port's pools share the
CPU too, the prefill pool's chunks on its own dispatch thread.  Greedy and
sampled streams are compared token for token with the JAX engine's and with
the port's colocated ``EngineCore``'s, the handoff counters with the JAX
channel's, the writers the decode pool installs with byte for byte against
the jitted JAX programs, and the chunk program's logits and KV within 1e-4
(f32 sums in another order than XLA's).
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.common.hardware import TPU_V5E as J_TPU_V5E
from repro.core.disagg import DisaggCostModel as JDisaggCostModel
from repro.core.kv_cache import insert_prefill_kv as j_insert_prefill_kv
from repro.core.phase_engine import PhaseEngine as JPhaseEngine
from repro.layers import attention as JA
from repro.models import transformer as JT
from repro.quant.kv_quant import QuantKV as JQuantKV
from repro.serving import AsyncEngine as JAsyncEngine
from repro.serving import DisaggEngine as JDisaggEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams

from repro_torch.common.hardware import TPU_V5E
from repro_torch.configs import reduced_config
from repro_torch.core.disagg import DisaggCostModel, pool_devices
from repro_torch.core.kv_cache import install_relayed_kv, insert_prefill_kv
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import COUNTS, reset_counts
from repro_torch.launch import serve
from repro_torch.layers.attention import KVCache
from repro_torch.models import transformer as T
from repro_torch.obs.trace import TRACER
from repro_torch.quant.kv_quant import QuantKV
from repro_torch.serving import AsyncEngine, DisaggEngine, EngineCore, Request, SamplingParams
from repro_torch.serving.disagg import prefill_pool as P
from test_torch_frontend import _async_tokens, _jax_kernel_path_main, _printed
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)
MODEL_TOL = 1e-4  # f32 logits and KV, summed in another order than XLA's
HANDOFF_KEYS = ("segments", "eager_segments", "installs", "discarded", "bytes_shipped", "pending")


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _prompts(n=3, lo=5, hi=12, seed=0):
    """The JAX disaggregation tests' prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(n)]


def _serve(cls, request_cls, cfg, params, prompts, *, max_new=6, params_of=None, **kw):
    eng = cls(cfg, params, **kw)
    for i, p in enumerate(prompts):
        extra = {} if params_of is None else dict(params=params_of(request_cls, i))
        eng.submit(request_cls(f"r{i}", p.copy(), max_new=max_new, **extra))
    eng.run()
    toks = {rid: list(r.out_tokens) for rid, r in eng.finished.items()}
    assert len(toks) == len(prompts) and all(toks.values())
    return eng, toks


def _three(tiny, prompts, **kw):
    """The port's DisaggEngine, the JAX DisaggEngine and the port's
    colocated EngineCore on the same requests."""
    cfg_j, params_j, cfg_t, params_t = tiny
    ours = _serve(DisaggEngine, Request, cfg_t, params_t, prompts, device="cpu", **kw)
    jax_ = _serve(JDisaggEngine, JRequest, cfg_j, params_j, prompts, **kw)
    colo = _serve(EngineCore, Request, cfg_t, params_t, prompts, device="cpu", **kw)
    return ours, jax_, colo


def _handoff(eng):
    ho = eng.snapshot()["disagg"]["handoff"]
    return {k: ho[k] for k in HANDOFF_KEYS}


# ----------------------------------------- the engine: tokens and counters --


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_disagg_greedy_equals_jax_and_colocated(tiny, layout, kv_dtype):
    """Monolithic prefill: the two pools (the prefill pool's body, tail and
    relay, the handoff, the decode pool's install) give the JAX
    DisaggEngine's and the colocated engine's tokens on every layout x KV
    format, and the channel counts what the JAX channel counts."""
    kw = dict(n_slots=2, max_len=40, prompt_len=12, cache_layout=layout, kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(block_size=8, num_blocks=16)
    (eng, got), (jeng, want), (_, colo) = _three(tiny, _prompts(), **kw)
    assert got == want == colo
    assert _handoff(eng) == _handoff(jeng)
    assert _handoff(eng)["segments"] == 3 and _handoff(eng)["bytes_shipped"] > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_disagg_chunked_equals_jax_and_colocated(tiny, layout):
    """Chunked prefill: every chunk ships as it finishes (the non-final ones
    eagerly), the installs wait for the final chunk, and the tokens and
    counters are the JAX engine's; the chunks computed on the pool's
    dispatch thread."""
    kw = dict(n_slots=2, max_len=48, prompt_len=24, cache_layout=layout, prefill_chunk=8,
              kv_dtype="int8")
    if layout == "paged":
        kw.update(block_size=8, num_blocks=24)
    (eng, got), (jeng, want), (colo_eng, colo) = _three(tiny, _prompts(lo=12, hi=24, seed=1),
                                                        **kw)
    assert got == want == colo
    ho = _handoff(eng)
    assert ho == _handoff(jeng)
    assert ho["eager_segments"] > 0 and ho["installs"] == ho["segments"] and ho["pending"] == 0
    assert eng.stats.prefill_chunks == colo_eng.stats.prefill_chunks == ho["segments"]
    assert eng.runner.chunk_prefix is None and eng.prefill_pool.chunk_prefix is not None


def test_disagg_static_mode_equals_jax_and_colocated(tiny):
    kw = dict(n_slots=2, max_len=40, prompt_len=12, mode="static", kv_dtype="int4")
    (eng, got), (jeng, want), (_, colo) = _three(tiny, _prompts(seed=2), **kw)
    assert got == want == colo
    assert _handoff(eng) == _handoff(jeng)


def test_disagg_preemption_equals_jax_and_colocated(tiny):
    """An undersized paged pool preempts alike in all three engines (one
    scheduler, one step loop), and the restarts, re-prefilled on the
    prefill pool and replayed on the decode pool, give the same tokens."""
    kw = dict(n_slots=3, max_len=48, prompt_len=16, cache_layout="paged", block_size=8,
              num_blocks=7, mode="static")
    prompts = _prompts(n=4, lo=14, hi=14, seed=4)
    (eng, got), (jeng, want), (colo_eng, colo) = _three(tiny, prompts, max_new=10, **kw)
    assert got == want == colo
    assert colo_eng.stats.preemptions > 0
    assert (eng.stats.preemptions == jeng.stats.preemptions == colo_eng.stats.preemptions)
    assert eng.stats.replayed_tokens == jeng.stats.replayed_tokens
    assert _handoff(eng) == _handoff(jeng)


def _odd_sampled(request_cls, i):
    sp = JSamplingParams if request_cls is JRequest else SamplingParams
    return sp() if i % 2 == 0 else sp(temperature=0.8, top_k=50, top_p=0.9, seed=100 + i)


def test_disagg_sampled_chunked_equals_jax_and_colocated(tiny):
    """Sampled streams (keys by token index, drawn on the decode pool from
    the first-token logits the channel hands over) equal the JAX engine's
    and the colocated engine's."""
    kw = dict(n_slots=2, max_len=48, prompt_len=24, cache_layout="paged", block_size=8,
              num_blocks=24, prefill_chunk=8, kv_dtype="int8")
    prompts = _prompts(n=4, lo=6, hi=24, seed=3)
    (eng, got), (jeng, want), (_, colo) = _three(tiny, prompts, params_of=_odd_sampled, **kw)
    assert got == want == colo
    assert got["r1"] != _serve(EngineCore, Request, tiny[2], tiny[3], prompts, device="cpu",
                               **kw)[1]["r1"]
    assert _handoff(eng) == _handoff(jeng)


def test_disagg_speculative_equals_jax_and_colocated(tiny):
    """Speculative decoding runs on the decode pool unchanged: the streams
    and the draft counters equal the JAX engine's."""
    kw = dict(n_slots=2, max_len=48, prompt_len=16, kv_dtype="int8", spec_decode=2)
    base = np.arange(8, dtype=np.int32) % 5 + 3
    prompts = [np.tile(base, 2), np.tile(base[::-1], 2), base]
    (eng, got), (jeng, want), (_, colo) = _three(tiny, prompts, max_new=10, **kw)
    assert got == want == colo
    assert eng.stats.verify_rounds > 0
    assert (eng.stats.draft_tokens, eng.stats.accepted_tokens) == (
        jeng.stats.draft_tokens, jeng.stats.accepted_tokens)


def test_abort_mid_chunked_prefill_discards_pending_installs(tiny):
    """Aborting between chunks releases the slot and drops its queued
    install (a late one would write into the pages' next owner); every
    page comes home and the engine serves on."""
    _, _, cfg_t, params_t = tiny
    eng = DisaggEngine(cfg_t, params_t, n_slots=2, max_len=48, prompt_len=24,
                       cache_layout="paged", block_size=8, num_blocks=24, prefill_chunk=8,
                       device="cpu")
    free0 = eng.runner.paged.pool.num_free
    eng.submit(Request("long", np.arange(24, dtype=np.int32) % 64, max_new=4))
    eng.step()  # one chunk: its install is deferred
    assert eng._prefilling and eng.handoff.pending == 1
    out = eng.abort("long")
    assert out is not None and out.finish_reason == "abort"
    ho = eng.snapshot()["disagg"]["handoff"]
    assert (ho["pending"], ho["discarded"], ho["installs"]) == (0, 1, 0)
    assert eng.runner.paged.pool.num_free == free0
    eng.submit(Request("after", np.arange(20, dtype=np.int32), max_new=3))
    eng.run()
    assert eng.finished["after"].finish_reason == "length"
    assert eng.snapshot()["disagg"]["handoff"]["pending"] == 0
    assert eng.runner.paged.pool.num_free == free0


# ------------------------------------------ the programs the pools split --


def test_prefill_chunk_kv_matches_jitted_jax(tiny):
    """Two chunks (16 tokens, then 9 padded to 16 at prefix width 16)
    through the compute-only chunk program of both packages: logits, the
    returned chunk KV and the f32 mirror within 1e-4 of ``jax.jit`` of the
    JAX ``prefill_chunk_kv``; and exactly what the fused ``prefill_chunk``
    computes."""
    cfg_j, params_j, cfg_t, params_t = tiny
    tokens = np.random.default_rng(9).integers(0, 512, 25).astype(np.int32)
    shape = (3, 1, 2, 64, 32)
    jprefix = JA.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    prefix = KVCache(torch.zeros(shape), torch.zeros(shape))
    fused_prefix = KVCache(torch.zeros(shape), torch.zeros(shape))
    cache = T.init_cache(cfg_t, 2, 64, dtype=torch.float32, device="cpu")
    eng = PhaseEngine(cfg_t)
    for start, size, width in ((0, 16, 0), (16, 9, 16)):
        buf = np.zeros((1, 16), np.int32)
        buf[0, :size] = tokens[start:start + size]
        jfn = jax.jit(lambda p, t, pre, s, lp, w=width: JT.prefill_chunk_kv(
            p, t, pre, s, lp, cfg_j, prefix_width=w))
        jl, jkv, jprefix = jfn(params_j, jnp.asarray(buf), jprefix, start, size - 1)
        scalar = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        prog = eng.prefill_chunk_kv_program(16, width)
        assert prog.name == f"prefill_chunk_kv:16+{width}"
        tl, kv, _ = prog(params_t, torch.from_numpy(buf).long(), prefix, scalar(start),
                         scalar(size - 1))
        fl, _, _ = T.prefill_chunk(params_t, torch.from_numpy(buf).long(), cache, fused_prefix,
                                   1, start, size - 1, cfg_t, prefix_width=width)
        assert torch.equal(tl, fl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=0)
        real = slice(0, size)  # the padding rows are never read
        for t, j in zip(kv, jkv):
            assert t.shape == (3, 1, 2, 16, 32) and t.dtype == torch.float32
            np.testing.assert_allclose(t[:, :, :, real].numpy(), np.asarray(j)[:, :, :, real],
                                       atol=MODEL_TOL, rtol=0)
        for c, t in zip(cache, kv):  # the fused program stored these rows
            assert torch.equal(c[1, :, :, start:start + size].float(),
                               t[:, 0, :, real].float())
    for t, j in zip(prefix, jprefix):
        np.testing.assert_allclose(t[:, :, :, :25].numpy(), np.asarray(j)[:, :, :, :25],
                                   atol=MODEL_TOL, rtol=0)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).contiguous().numpy().tobytes()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return np.ascontiguousarray(x).tobytes()


def _planes(leaf):
    return [leaf.q, leaf.scale] if isinstance(leaf, (QuantKV, JQuantKV)) else [leaf]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_chunk_write_program_byte_equal_jitted_jax(tiny, kv_dtype):
    """The decode pool's chunk install: a shipped f32 chunk written into
    slot 1 at rows [20, 36) by ``chunk_write:16``, byte for byte against
    the JAX ``chunk_write`` program (jitted) and the fused writer's rows."""
    cfg_j, _, cfg_t, _ = tiny
    new = (np.random.default_rng(3).normal(size=(3, 1, 2, 16, 32)) * 2).astype(np.float32)
    jeng = JPhaseEngine(cfg_j, mesh=None, max_len=64, kv_dtype=kv_dtype)
    jkv = JA.KVCache(jnp.asarray(new), jnp.asarray(new * 0.5))
    want = jeng.chunk_write_program(16).fn(JT.init_cache(cfg_j, 3, 64, kv_dtype=kv_dtype), jkv,
                                           1, 20)
    prog = PhaseEngine(cfg_t, kv_dtype=kv_dtype).chunk_write_program(16)
    assert prog.name == "chunk_write:16"
    cache = T.init_cache(cfg_t, 3, 64, kv_dtype=kv_dtype, device="cpu")
    kv = KVCache(torch.from_numpy(new), torch.from_numpy(new * 0.5))
    got = prog.fn(cache, kv, 1, 20)
    for leaf, jleaf in zip(got, want):
        for t, j in zip(_planes(leaf), _planes(jleaf)):
            assert _bytes(t) == _bytes(j)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_split_relay_and_install_byte_equal_jax_and_fused(tiny, kv_dtype):
    """The contiguous swap split across the pools: the prefill pool's relay
    (a (1, L, Hkv, max_len, ·) segment, padded, quantized on write) equals
    the jitted JAX relayout program's segment byte for byte, and the decode
    pool's install of it stores, padding rows included (payload 0, scale
    1.0), the bytes of the port's fused relayout and of the JAX install."""
    cfg_j, _, cfg_t, _ = tiny
    rng = np.random.default_rng(4)
    kvs = [(rng.normal(size=(3, 1, 2, 24, 32)) * 3).astype(np.float32) for _ in "kv"]
    jeng = JPhaseEngine(cfg_j, mesh=None, max_len=64, kv_dtype=kv_dtype)
    jseg = jeng.relayout_program(1, 24, 64).fn(JA.KVCache(*map(jnp.asarray, kvs)))
    jcache = jax.jit(j_insert_prefill_kv, static_argnums=(2, 3))(
        JT.init_cache(cfg_j, 3, 64, kv_dtype=kv_dtype), jseg, 2, 24)
    eng = PhaseEngine(cfg_t, kv_dtype=kv_dtype)
    relay = eng.relay_program(24, 64)
    assert relay.name == "relay:24->64"
    seg = relay.fn(KVCache(*map(torch.from_numpy, kvs)))
    for leaf, jleaf in zip(seg, jseg):
        for t, j in zip(_planes(leaf), _planes(jleaf)):
            assert t.shape[:2] == (1, 3) and _bytes(t) == _bytes(j)
    split = install_relayed_kv(T.init_cache(cfg_t, 3, 64, kv_dtype=kv_dtype, device="cpu"),
                               seg, 2)
    fused = insert_prefill_kv(T.init_cache(cfg_t, 3, 64, kv_dtype=kv_dtype, device="cpu"),
                              KVCache(*map(torch.from_numpy, kvs)), 2)
    for a, b, j in zip(split, fused, jcache):
        for ta, tb, tj in zip(_planes(a), _planes(b), _planes(j)):
            assert _bytes(ta) == _bytes(tb) == _bytes(tj)
    if kv_dtype != "fp":
        assert bool((split.k.scale[2, :, :, 24:] == 1.0).all())
        assert bool((split.k.q[2, :, :, 24:] == 0).all())


def test_cost_model_matches_jax_on_tpu_v5e():
    """``DisaggCostModel`` on the port's ``ChipSpec`` copy of the TPU v5e
    gives the JAX model's bytes, latencies and verdicts."""
    cfg_t = reduced_config("bitnet-730m")
    cfg_j = jcfgs.reduced_config("bitnet-730m")
    assert TPU_V5E.dcn_bw == J_TPU_V5E.dcn_bw and TPU_V5E.hbm_bw == J_TPU_V5E.hbm_bw
    for kv_dtype in ("fp", "int8", "int4"):
        for chips in (1, 2, 8):
            ours = DisaggCostModel(cfg_t, chips_per_pod=chips, chip=TPU_V5E, kv_dtype=kv_dtype)
            theirs = JDisaggCostModel(cfg_j, chips_per_pod=chips, chip=J_TPU_V5E,
                                      kv_dtype=kv_dtype)
            for batch, seq, steps in ((1, 128, 32), (4, 2048, 256), (16, 512, 65)):
                assert ours.kv_bytes(batch, seq) == theirs.kv_bytes(batch, seq)
                assert ours.temporal_swap_latency(batch, seq) == pytest.approx(
                    theirs.temporal_swap_latency(batch, seq), rel=1e-12)
                assert ours.spatial_transfer_latency(batch, seq) == pytest.approx(
                    theirs.spatial_transfer_latency(batch, seq), rel=1e-12)
                assert ours.better_mode(batch, seq, steps) == theirs.better_mode(
                    batch, seq, steps)


def test_pools_take_one_device():
    assert pool_devices("cpu", "cpu") == (torch.device("cpu"), torch.device("cpu"))
    assert pool_devices(None, "cpu") == (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        pool_devices("meta", "cpu")


# --------------------------------------------------- threads, trace, front --


def test_trace_lanes_of_a_disaggregated_run(tiny):
    """``handoff.ship`` lies on the ``kv-handoff`` lane, the chunks'
    compute on the prefill pool's thread, the installs on the engine's
    (the caller's) lane, and each request finishes once."""
    _, _, cfg_t, params_t = tiny
    eng = DisaggEngine(cfg_t, params_t, n_slots=2, max_len=48, prompt_len=24, prefill_chunk=8,
                       device="cpu")
    TRACER.enable()
    try:
        for i, p in enumerate(_prompts(lo=12, hi=24, seed=1)):
            eng.submit(Request(f"r{i}", p.copy(), max_new=4))
        eng.run()
        events = TRACER.events()
    finally:
        TRACER.disable()
        TRACER.clear()
    lanes = {}
    for ev in events:
        lanes.setdefault(ev[1], set()).add(ev[4] if ev[0] == "X" else ev[3])
    assert lanes["handoff.ship"] == {"kv-handoff"}
    assert all(lane.startswith("prefill-pool") for lane in lanes["prefill.chunk.compute"])
    here = threading.current_thread().name
    assert lanes["handoff.install"] == {here} and lanes["prefill.chunk.dispatch"] == {here}
    finishes = [ev[4]["request_id"] for ev in events if ev[1] == "req.finish"]
    assert sorted(finishes) == ["r0", "r1", "r2"]
    shipped = [ev for ev in events if ev[1] == "handoff.ship"]
    assert len(shipped) == eng.stats.prefill_chunks == eng.handoff.segments


def test_async_engine_over_disagg_gives_the_sync_and_jax_streams(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    kw = dict(n_slots=2, max_len=48, prompt_len=24, cache_layout="paged", block_size=8,
              num_blocks=24, prefill_chunk=8)
    rng = np.random.default_rng(1)
    reqs = [(f"r{i}", rng.integers(0, 512, n).astype(np.int32), 6)
            for i, n in enumerate((13, 22, 9))]
    got = _async_tokens(DisaggEngine(cfg_t, params_t, device="cpu", **kw), AsyncEngine, reqs)
    assert got == _async_tokens(JDisaggEngine(cfg_j, params_j, **kw), JAsyncEngine, reqs)
    sync = DisaggEngine(cfg_t, params_t, device="cpu", **kw)
    for rid, prompt, max_new in reqs:
        sync.submit(Request(rid, prompt.copy(), max_new=max_new))
    sync.run()
    assert got == {rid: list(sync.finished[rid].out_tokens) for rid, _, _ in reqs}


def test_cli_disagg_prints_the_jax_clis_tokens_and_handoff():
    """``--disagg``: the port's CLI prints the JAX CLI's tokens (on its
    kernel path) and the same ``KV handoff`` line."""
    args = ["--arch", "bitnet-730m", "--reduced", "--requests", "4", "--prompt-len", "16",
            "--max-new", "5", "--max-len", "64", "--disagg", "--cache-layout", "paged",
            "--block-size", "8", "--prefill-chunk", "8", "--kv-dtype", "int8"]
    got, text = _printed(serve.main, args + ["--device", "cpu"])
    want, jtext = _printed(_jax_kernel_path_main, args)
    assert got == want and len(got) == 3
    handoff = [ln.strip() for ln in text.splitlines() if "KV handoff" in ln]
    assert handoff == [ln.strip() for ln in jtext.splitlines() if "KV handoff" in ln]
    assert handoff[0].startswith("KV handoff        : 8 segments (4 eager)")
    assert "colocating both pools" in text and "requests finished : 4/4" in text


def test_launch_counts_lose_no_concurrent_increment():
    """Two threads counting launches at once lose none (the interpreter
    switches every microsecond); a capture recording on one thread keeps
    its thread's launches out of the totals and the other's in."""
    reset_counts()
    n, old = 20_000, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    recorded = {}
    try:
        def count(name):
            for _ in range(n):
                COUNTS.add(name)

        def capture():
            with COUNTS.recording() as rec:
                for _ in range(n):
                    COUNTS.add("tlmm")
            recorded.update(rec)

        threads = [threading.Thread(target=count, args=("tlmm",)) for _ in range(3)]
        threads.append(threading.Thread(target=capture))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert COUNTS["tlmm"] == 3 * n and recorded["tlmm"] == n
    assert dict(COUNTS) == {**{k: 0 for k in COUNTS}, "tlmm": 3 * n}
    reset_counts()
    assert all(v == 0 for v in COUNTS.values())


def test_deprioritize_never_raises(monkeypatch):
    """The pool executor's initializer must not raise whatever the host
    forbids (an initializer that raises breaks the executor)."""
    def refuse(*args):
        raise PermissionError("not permitted")

    monkeypatch.setattr(P.os, "sched_setscheduler", refuse)
    monkeypatch.setattr(P.os, "setpriority", refuse)
    P._deprioritize()
    monkeypatch.delattr(P.os, "sched_setscheduler")
    P._deprioritize()


def test_grid_builds_the_pool_programs(tiny):
    """``build_serving_grid`` builds the prefill pool's bucket programs and
    one compute-only program per chunk shape, the decode pool the installs,
    and none of the fused chunk programs the disaggregated runner never
    runs."""
    _, _, cfg_t, params_t = tiny
    eng = DisaggEngine(cfg_t, params_t, n_slots=2, max_len=48, prompt_len=24, prefill_chunk=8,
                       device="cpu")
    eng.build_serving_grid()
    shapes = eng.runner.reachable_chunk_shapes()
    pool_keys = set(eng.prefill_pool.engine.programs)
    assert {f"prefill_chunk_kv:{c}+{w}" for c, w in shapes} <= pool_keys
    assert {f"prefill_split_varlen:1x{b}" for b in eng.runner.reachable_buckets()} <= pool_keys
    decode_keys = set(eng.runner.engine.programs)
    assert {f"chunk_write:{c}" for c, _ in shapes} <= decode_keys
    assert not any(k.startswith(("prefill_chunk", "prefill_split")) for k in decode_keys)
