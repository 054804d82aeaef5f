"""The port's chunked prefill against the JAX package's, on the CPU.

The config is the one the JAX package's own ``tests/test_chunked_prefill.py``
uses (3 layers, d_model 128, vocab 512); the same packed weights, made with
numpy from a seed, go into both packages.  The JAX package runs its Pallas
kernels in interpret mode (``use_pallas=True``); the port runs the plain
PyTorch versions, since these tensors lie on the CPU.  Greedy streams are
compared token for token, quantized cache bytes byte for byte, and chunk
logits and KV within 1e-4: f32 sums in another order than XLA's.
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.layers import attention as JA
from repro.models import transformer as JT
from repro.quant.kv_quant import QuantKV as JQuantKV
from repro.serving import EngineCore as JEngineCore, Request as JRequest
from repro.serving import SamplingParams as JSamplingParams

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.layers.attention import KVCache, write_chunk_kv_q
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import QuantKV
from repro_torch.serving import (
    DrainPolicy,
    EngineCore,
    Request,
    SamplingParams,
    SchedulerView,
    SwapCostAwarePolicy,
)
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)
MODEL_TOL = 1e-4  # f32 logits and KV, summed in another order than XLA's


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _prompts(lengths=(7, 12, 20, 33), seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lengths]


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_new=6, params_of=None, **kw):
    kw = {**dict(n_slots=3, max_len=64, prompt_len=12, block_size=8), **kw}
    eng = engine_cls(cfg, params, **kw)
    for i, p in enumerate(prompts):
        extra = {} if params_of is None else dict(params=params_of(i), priority=i)
        eng.submit(request_cls(f"r{i}", p.copy(), max_new=max_new, **extra))
    stats = eng.run()
    assert len(eng.finished) == len(prompts)
    return eng, stats, {k: v.out_tokens for k, v in eng.finished.items()}


def _port(tiny, prompts, **kw):
    _, _, cfg_t, params_t = tiny
    return _serve(EngineCore, Request, cfg_t, params_t, prompts, device="cpu", **kw)


def _jax(tiny, prompts, **kw):
    cfg_j, params_j, _, _ = tiny
    return _serve(JEngineCore, JRequest, cfg_j, params_j, prompts, **kw)


# --------------------------------------------------------------- the engine --


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_greedy_equals_jax_and_monolithic(tiny, layout, kv_dtype):
    """Chunked greedy streams equal a live JAX chunked engine's and the
    port's own monolithic ones; prompts of 7, 12, 20 and 33 tokens in
    chunks of 16 are 1 + 1 + 2 + 3 chunks, one logical swap each.  Every
    token the port picks clears its runner-up by more than the tolerance,
    so the equality is not decided by float noise."""
    _, _, cfg_t, params_t = tiny
    kw = dict(cache_layout=layout, kv_dtype=kv_dtype)
    _, jstats, want = _jax(tiny, _prompts(), prefill_chunk=16, **kw)
    eng = EngineCore(cfg_t, params_t, n_slots=3, max_len=64, prompt_len=12, block_size=8,
                     prefill_chunk=16, device="cpu", **kw)
    margins = []
    chunk, decode = eng.runner.run_prefill_chunk, eng.runner.decode_logits

    def record(logits, rows):
        top2 = torch.topk(logits[rows].float(), 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        return logits

    def last_chunk(req, slot, start, size, *rest):  # only the last chunk's logits are used
        logits = chunk(req, slot, start, size, *rest)
        return record(logits, [0]) if start + size == len(req.prompt) else logits

    eng.runner.run_prefill_chunk = last_chunk
    eng.runner.decode_logits = lambda lengths: record(decode(lengths),
                                                      sorted(eng.scheduler.inflight))
    for i, p in enumerate(_prompts()):
        eng.submit(Request(f"r{i}", p.copy(), max_new=6))
    stats = eng.run()
    got = {k: v.out_tokens for k, v in eng.finished.items()}
    assert min(margins) > MODEL_TOL
    assert got == want
    _, _, mono = _port(tiny, _prompts(), **kw)
    assert got == mono
    assert stats.prefill_chunks == 7 and stats.swaps == 4
    for name in ("prefill_chunks", "prefill_bursts", "swaps", "prefill_tokens", "decode_rounds",
                 "decode_tokens", "prefix_hits", "prefix_misses", "slot_rounds",
                 "decode_ctx_tokens"):
        assert getattr(stats, name) == getattr(jstats, name), name


def test_unaligned_chunk_and_clamped_tail_contiguous(tiny):
    """The contiguous cache takes any chunk size: chunks of 7 give the
    monolithic stream.  A 60-token prompt in chunks of 16 ends in a 12-token
    tail at row 48, whose bucket (prompt_len 12) is clamped to the 16 rows
    left to max_len 64; a tail at row 56 of max_len 63 is clamped to 7."""
    _, _, mono = _port(tiny, _prompts(), cache_layout="contiguous")
    _, _, got = _port(tiny, _prompts(), cache_layout="contiguous", prefill_chunk=7)
    assert got == mono
    eng, _, _ = _port(tiny, _prompts((4,)), cache_layout="contiguous", prefill_chunk=16,
                      max_len=63)
    assert eng.runner.chunk_bucket(7, 56) == 7 and eng.runner.chunk_bucket(3, 48) == 12
    long = _prompts((60,), seed=5)
    kw = dict(cache_layout="contiguous", max_new=3, prompt_len=16)
    _, _, want = _jax(tiny, long, prefill_chunk=16, **kw)
    _, _, got = _port(tiny, long, prefill_chunk=16, **kw)
    _, _, mono = _port(tiny, long, **kw)
    assert got == want == mono


def test_chunked_validation(tiny):
    _, _, cfg_t, params_t = tiny
    with pytest.raises(ValueError, match="prefill_chunk"):
        EngineCore(cfg_t, params_t, cache_layout="paged", block_size=8, prefill_chunk=12,
                   device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        EngineCore(cfg_t, params_t, prefill_chunk=0, device="cpu")
    cache = T.init_cache(cfg_t, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        write_chunk_kv_q(cache.k, torch.zeros((3, 1, 2, 8, 32)), 1, 9)


# ------------------------------------------------------- the chunk programs --


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_write_chunk_kv_q_byte_equal_jitted_jax(tiny, kv_dtype):
    """The same f32 chunk written into the same cache at slot 1, rows
    [20, 36): payload and scale plane byte for byte against ``jax.jit`` of
    the JAX writer, every other row untouched."""
    cfg_j, _, cfg_t, _ = tiny
    rng = np.random.default_rng(3)
    new = (rng.normal(size=(3, 1, 2, 16, 32)) * 2).astype(np.float32)
    jcache = JT.init_cache(cfg_j, 3, 64, kv_dtype=kv_dtype)
    want = jax.jit(JA.write_chunk_kv_q)(jcache.k, jnp.asarray(new), 1, 20)
    cache = T.init_cache(cfg_t, 3, 64, kv_dtype=kv_dtype, device="cpu")
    got = write_chunk_kv_q(cache.k, torch.from_numpy(new), 1, 20)
    pairs = ([(got.q, want.q), (got.scale, want.scale)] if isinstance(got, QuantKV)
             else [(got, want)])
    for t, j in pairs:
        jn = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
        tn = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert tn.tobytes() == jn.tobytes()
    assert isinstance(want, JQuantKV) == (kv_dtype != "fp")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_chunk_logits_and_kv_match_jax(tiny, layout):
    """Two chunks (16 real tokens, then 9 padded to 16 at prefix width 16)
    through ``prefill_chunk`` / ``prefill_chunk_paged`` of both packages:
    logits, the f32 mirror and the installed f32 cache within 1e-4 on the
    prompt's positions."""
    cfg_j, params_j, cfg_t, params_t = tiny
    tokens = _prompts((25,), seed=9)[0]
    shape = (3, 1, 2, 64, 32)
    jprefix = JA.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    prefix = KVCache(torch.zeros(shape), torch.zeros(shape))
    if layout == "paged":
        jcache = JT.init_paged_pool(cfg_j, 8, 8, dtype=jnp.float32)
        cache = T.init_paged_pool(cfg_t, 8, 8, dtype=torch.float32, device="cpu")
    else:
        jcache = JT.init_cache(cfg_j, 2, 64, dtype=jnp.float32)
        cache = T.init_cache(cfg_t, 2, 64, dtype=torch.float32, device="cpu")
    for start, size, width, ids in ((0, 16, 0, [5, 2]), (16, 9, 16, [7, 8])):
        buf = np.zeros((1, 16), np.int32)
        buf[0, :size] = tokens[start:start + size]
        if layout == "paged":  # id 8 = N: the padding page, skipped
            jl, jcache, jprefix = JT.prefill_chunk_paged(
                params_j, jnp.asarray(buf), jcache, jprefix, jnp.asarray(ids, jnp.int32),
                start, size - 1, cfg_j, prefix_width=width)
            tl, cache, prefix = T.prefill_chunk_paged(
                params_t, torch.from_numpy(buf).long(), cache, prefix,
                torch.tensor(ids, dtype=torch.int32), start, size - 1, cfg_t, prefix_width=width)
        else:
            jl, jcache, jprefix = JT.prefill_chunk(params_j, jnp.asarray(buf), jcache, jprefix, 1,
                                                   start, size - 1, cfg_j, prefix_width=width)
            tl, cache, prefix = T.prefill_chunk(params_t, torch.from_numpy(buf).long(), cache,
                                                prefix, 1, start, size - 1, cfg_t,
                                                prefix_width=width)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=0)
    # positions [0, 25); the padding rows past them are never read (and an
    # ulp there can flip an act-quant rounding in a later layer).  The pool
    # holds real positions only: page 8 = N, positions 24-31, was skipped.
    pairs = list(zip(prefix, jprefix)) + ([] if layout == "paged" else list(zip(cache, jcache)))
    for t, j in pairs:
        np.testing.assert_allclose(t[:, :, :, :25].numpy(), np.asarray(j)[:, :, :, :25],
                                   atol=MODEL_TOL, rtol=0)
    if layout == "paged":
        for t, j in zip(cache, jcache):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL, rtol=0)


# ------------------------------------------------- interleaving and restarts --


def test_decode_interleaves_between_chunks(tiny):
    """While a 96-token prompt prefills in chunks of 16, the decoding stream
    gets rounds between the chunks; monolithic prefill gives it none."""
    rng = np.random.default_rng(7)
    short = rng.integers(0, 512, 8).astype(np.int32)
    long = rng.integers(0, 512, 96).astype(np.int32)
    _, _, cfg_t, params_t = tiny

    def window_rounds(chunk):
        eng = EngineCore(cfg_t, params_t, n_slots=2, max_len=128, prompt_len=12,
                         cache_layout="paged", block_size=8, prefill_chunk=chunk, device="cpu")
        eng.submit(Request("short", short.copy(), max_new=60))
        while not eng.scheduler.inflight:
            eng.step()
        eng.submit(Request("long", long.copy(), max_new=4))
        d0, first = eng.stats.decode_rounds, None
        while eng.has_unfinished():
            outs = eng.step()
            if first is None and any(o.request_id == "long" for o in outs):
                first = eng.stats.decode_rounds
        assert set(eng.finished) == {"short", "long"}
        return first - d0 - 1

    assert window_rounds(None) == 0
    assert window_rounds(16) == 96 // 16 - 1


def test_policy_sees_pending_chunks(tiny):
    """The swap-cost-aware policy never defers the next chunk of an admitted
    prompt; the view it gets carries the pending chunks; a chunked engine
    under it gives the drain policy's tokens."""
    view = dict(queue_depth=1, free_slots=1, active_slots=2, swap_cost=0.04,
                decode_round_cost=0.01)
    pol = SwapCostAwarePolicy(max_defer_rounds=100)
    assert not pol.should_prefill(SchedulerView(**view))
    assert pol.should_prefill(SchedulerView(**view, pending_chunks=3))
    _, _, cfg_t, params_t = tiny
    eng = EngineCore(cfg_t, params_t, n_slots=2, max_len=64, cache_layout="paged", block_size=8,
                     prefill_chunk=8, device="cpu")
    seen = []
    enter = eng.scheduler.enter_prefill_phase

    def spy(stats, *, pending_chunks=0):
        seen.append(pending_chunks)
        return enter(stats, pending_chunks=pending_chunks)

    eng.scheduler.enter_prefill_phase = spy
    eng.submit(Request("a", _prompts((5,))[0], max_new=8))
    eng.step()
    eng.submit(Request("b", _prompts((30,), seed=2)[0], max_new=2))
    eng.run()
    assert seen[:4] == [0, 0, 3, 2]  # b's admission, then its 3 remaining chunks
    prompts = _prompts((7, 20), seed=3)
    _, _, drain = _port(tiny, prompts, prefill_chunk=16, cache_layout="paged",
                        swap_policy=DrainPolicy())
    _, _, aware = _port(tiny, prompts, prefill_chunk=16, cache_layout="paged",
                        swap_policy=SwapCostAwarePolicy(min_queue=2, max_defer_rounds=4))
    assert aware == drain


def test_chunked_preemption_replays_like_jax(tiny):
    """Four sampled requests of 14 tokens in chunks of 8 on a pool of 7
    pages: requests evicted mid-generation re-prefill through the same
    chunks and replay their tokens, and every stream equals the unpreempted
    contiguous run's and the JAX engine's on the same pool.  (The engine
    evicts a decoding request first, the growing one included, so this
    workload evicts none mid-prefill; the next test does.)"""
    prompts = _prompts((14, 14, 14, 14), seed=4)
    knobs = dict(temperature=0.8, top_k=64, top_p=0.95)
    kw = dict(mode="static", prefill_chunk=8, max_new=10)
    mine = lambda i: SamplingParams(seed=100 + i, **knobs)  # noqa: E731
    _, _, ref = _port(tiny, prompts, cache_layout="contiguous", params_of=mine, **kw)
    eng, stats, got = _port(tiny, prompts, cache_layout="paged", num_blocks=7, params_of=mine, **kw)
    _, jstats, want = _jax(tiny, prompts, cache_layout="paged", num_blocks=7,
                           params_of=lambda i: JSamplingParams(seed=100 + i, **knobs), **kw)
    assert stats.preemptions > 0 and stats.replayed_tokens > 0
    assert got == ref == want
    for name in ("preemptions", "replayed_tokens", "prefill_chunks", "admission_blocks"):
        assert getattr(stats, name) == getattr(jstats, name), name
    assert eng.runner.paged.pool.num_live == 0


def _restart_mid_prefill(engine_cls, request_cls, cfg, params, prompts, evict, **kw):
    """``a`` decodes while ``b`` (30 tokens, sampled) prefills in chunks of
    8; with ``evict``, ``b`` is evicted after its second chunk (the engine's
    own mid-prefill preemption) and restarts from its first chunk."""
    eng = engine_cls(cfg, params, n_slots=2, max_len=64, prompt_len=12, cache_layout="paged",
                     block_size=8, kv_dtype="int8", prefill_chunk=8, **kw)
    eng.submit(request_cls("a", prompts[0].copy(), max_new=12))
    while not eng.scheduler.inflight:
        eng.step()
    sp = (SamplingParams if engine_cls is EngineCore else JSamplingParams)(
        temperature=0.8, top_k=64, top_p=0.95, seed=7)
    eng.submit(request_cls("b", prompts[1].copy(), max_new=8, params=sp))
    eng.step()
    eng.step()
    if evict:
        (slot, prog), = eng._prefilling.items()
        assert prog.ci == 2
        eng._preempt_prefilling(slot)
    stats = eng.run()
    return stats, {k: v.out_tokens for k, v in eng.finished.items()}


def test_mid_prefill_restart_replays_like_jax(tiny):
    """A request evicted part-way through its chunked prefill restarts with
    no tokens through the same chunks, its recompute charged to t_replay
    and not to the offered load, and draws from token index 0: the streams
    equal an unevicted run's and the JAX engine's."""
    cfg_j, params_j, cfg_t, params_t = tiny
    prompts = _prompts((9, 30), seed=12)
    _, ref = _restart_mid_prefill(EngineCore, Request, cfg_t, params_t, prompts, False,
                                  device="cpu")
    stats, got = _restart_mid_prefill(EngineCore, Request, cfg_t, params_t, prompts, True,
                                      device="cpu")
    jstats, want = _restart_mid_prefill(JEngineCore, JRequest, cfg_j, params_j, prompts, True)
    assert got == ref == want
    assert stats.preemptions == 1 and stats.prefill_chunks == 2 + 4 + 2 and stats.swaps == 2
    assert stats.prefill_tokens == 39 and stats.t_replay > 0.0
    for name in ("preemptions", "prefill_chunks", "swaps", "prefill_tokens", "decode_rounds"):
        assert getattr(stats, name) == getattr(jstats, name), name
