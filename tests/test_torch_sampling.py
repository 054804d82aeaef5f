"""The port's sampler, abort, swap-cost-aware policy and stats surface
against the JAX package, on the CPU.

Keys and random bits are compared bit for bit with ``jax.random``; the
filter and the sampler with ``jax.jit`` of the JAX functions (the serving
engine runs them jitted, and XLA's fused arithmetic differs from an
op-by-op call); engine streams token for token with a live JAX
``EngineCore`` on the same packed weights, made with numpy from a seed (the
config of the JAX package's ``tests/test_chunked_prefill.py``).
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import sampling as JS
from repro.serving import EngineCore as JEngineCore, EngineStats as JEngineStats
from repro.serving import Request as JRequest, SamplingParams as JSamplingParams
from repro.serving import SchedulerView as JSchedulerView
from repro.serving import SwapCostAwarePolicy as JSwapCostAwarePolicy
from repro.serving import make_policy as j_make_policy

from repro_torch.configs import reduced_config
from repro_torch.core import sampling as S
from repro_torch.interop import params_from_numpy
from repro_torch.serving import (
    EngineCore,
    EngineStats,
    Request,
    SamplingParams,
    SchedulerView,
    ServingEngine,
    SwapCostAwarePolicy,
    make_policy,
)
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)
VOCAB = 32256  # bitnet-730m's padded vocabulary
KEY_CASES = [(0, 0), (1, 5), (123456, 77), (2**31 - 1, 4000), (1003, 31)]


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _jit(fn, *arrays):
    return np.asarray(jax.jit(fn)(*map(jnp.asarray, arrays)))


def _rows(seed, b=64, v=VOCAB):
    """Seeded sampler inputs: every 4th row greedy, the rest at temperatures
    0.3-1.5 with top-k in {off, 1, 5, 50, 1000} and top-p in {1, 0.9, 0.5,
    0.95}."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    temps = np.where(np.arange(b) % 4 == 0, 0.0, rng.uniform(0.3, 1.5, b)).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 50, 1000], b).astype(np.int32)
    top_ps = rng.choice([1.0, 0.9, 0.5, 0.95], b).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, b).astype(np.int32)
    steps = rng.integers(0, 3000, b).astype(np.int32)
    return logits, seeds, steps, temps, top_ks, top_ps


# ------------------------------------------------------------- the sampler --


@pytest.mark.parametrize("seed,step", KEY_CASES)
def test_keys_and_bits_bit_exact(seed, step):
    """``PRNGKey``, ``fold_in`` and ``random.bits`` of jax 0.9 (threefry,
    partitionable) bit for bit; the uniform floats too."""
    key = jax.random.PRNGKey(seed)
    jkey = jax.random.fold_in(key, step)
    k = S.prng_key(torch.tensor([seed]))
    assert [int(k[0][0]), int(k[1][0])] == np.asarray(jax.random.key_data(key)).tolist()
    k = S.fold_in(k, torch.tensor([step]))
    assert [int(k[0][0]), int(k[1][0])] == np.asarray(jax.random.key_data(jkey)).tolist()
    for n in (7, VOCAB):
        bits = S.random_bits(k, n)[0].numpy()
        np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jkey, (n,))).astype(np.int64))
    want = np.asarray(jax.jit(lambda kk: jax.random.uniform(
        kk, (VOCAB,), minval=np.finfo(np.float32).tiny, maxval=1.0))(jkey))
    np.testing.assert_array_equal(S.uniform(S.random_bits(k, VOCAB))[0].numpy(), want)


def _boundary_entries(logits, temp, top_p, differ):
    """The f64 mass before each differing sorted position of one row."""
    desc = np.sort(logits.astype(np.float64) / max(temp, 1e-6))[::-1]
    p = np.exp(desc - desc[0])
    p /= p.sum()
    before = np.cumsum(p) - p
    return before[differ]


def test_filter_logits_support_matches_jitted_jax():
    """Same kept values, and the same support on every row but where an ulp
    decides.  The nucleus keeps a sorted position iff the f32 mass before it
    is < top_p; XLA's exp, sum and cumsum round in another order than
    PyTorch's, so an entry whose mass lies within an ulp of top_p can be cut
    in one package and kept in the other.  Of these 64 rows one differs:
    with top_p = 1, XLA's cumsum reaches 1.0 half-way through the
    vocabulary (at 16,128 of 32,256) and cuts the rest, which holds 2.6e-7
    of the row's mass (in f64), while the port's cumsum stays below 1.0
    and keeps it: a draw lands there with probability under 3e-7."""
    logits, _, _, temps, top_ks, top_ps = _rows(0)
    want = _jit(JS.filter_logits, logits, temps, top_ks, top_ps)
    got = S.filter_logits(*map(torch.from_numpy, (logits, temps, top_ks, top_ps))).numpy()
    both = ~np.isinf(want) & ~np.isinf(got)
    np.testing.assert_array_equal(got[both], want[both])
    rows = np.nonzero((np.isinf(want) != np.isinf(got)).any(axis=1))[0]
    assert len(rows) == 1
    r = rows[0]
    kept_t, kept_j = (~np.isinf(got[r])).sum(), (~np.isinf(want[r])).sum()
    assert top_ps[r] == 1.0 and top_ks[r] == 0 and kept_t == VOCAB and kept_j < VOCAB
    # the entries XLA cut: the tail past the point where its f32 cumsum hit 1.0
    desc_idx = np.argsort(-(logits[r] / temps[r]), kind="stable")
    cut = desc_idx[kept_j:]
    assert np.isinf(want[r, cut]).all()
    assert kept_j == VOCAB // 2
    assert 1.0 - _boundary_entries(logits[r], temps[r], 1.0, slice(kept_j, None)).min() < 3e-7


def test_filter_logits_top_p_boundary_row():
    """Rows whose top_p is the exact mass before sorted position j (the f32
    of the f64 value): each package keeps position j or not by the last
    bits of its own f32 sums.  For j = 10 and 1000 the port keeps it and
    XLA does not; for j = 100 both cut it.  The one entry that differs is
    the boundary entry, and a draw differs only if it lands on it."""
    logits = _rows(0)[0][:1]
    before = _boundary_entries(logits[0], 1.0, 1.0, slice(None))
    for j, port_keeps in ((10, True), (100, False), (1000, True)):
        args = (logits, np.ones(1, np.float32), np.zeros(1, np.int32),
                np.array([before[j]], np.float32))
        want = _jit(JS.filter_logits, *args)
        got = S.filter_logits(*map(torch.from_numpy, args)).numpy()
        assert (~np.isinf(want)).sum() == j
        assert (~np.isinf(got)).sum() == j + port_keeps
        differ = np.nonzero(np.isinf(want[0]) != np.isinf(got[0]))[0]
        assert list(differ) == ([int(np.argsort(-logits[0], kind="stable")[j])]
                                if port_keeps else [])


def test_sample_tokens_matches_jitted_jax():
    """64 rows of vocab 32,256, greedy and sampled mixed: the same token as
    ``jax.jit(sample_tokens)`` on every row.  On every sampled row the port's
    winning score (logit / T + Gumbel noise) clears its runner-up by more
    than 1e-5, so no row is decided by an ulp of ``log``."""
    args = _rows(1)
    want = _jit(JS.sample_tokens, *args)
    targs = [torch.from_numpy(a) for a in args]
    got = S.sample_tokens(*targs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    logits, seeds, steps, temps, top_ks, top_ps = targs
    scores = S.filter_logits(logits, temps, top_ks, top_ps) + S.gumbel(
        S.random_bits(S.fold_in(S.prng_key(seeds), steps), VOCAB))
    top2 = torch.topk(scores[temps > 0], 2, dim=-1).values
    assert ((top2[:, 0] - top2[:, 1]) > 1e-5).all()


def test_sample_block_tokens_and_accept_length_match_jax():
    logits, seeds, steps, temps, top_ks, top_ps = _rows(2, b=12, v=512)
    block = logits.reshape(4, 3, 512)
    args = (block, seeds[:4], steps[:4], temps[:4], top_ks[:4], top_ps[:4])
    want = _jit(JS.sample_block_tokens, *args)
    got = S.sample_block_tokens(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)
    for draft, targets in (([], [3]), ([1, 2, 3], [1, 2, 4, 9]), ([5, 6], [5, 6, 7]),
                           ([7], [8, 7])):
        assert S.accept_length(draft, targets) == JS.accept_length(draft, targets)


# -------------------------------------------------------------- the engine --


def _sampled_params(mod):
    return [mod(temperature=0.8, top_k=64, top_p=0.95, seed=100 + i) for i in range(4)]


def _serve(engine_cls, request_cls, cfg, params, prompts, sps, **kw):
    eng = engine_cls(cfg, params, n_slots=3, max_len=64, prompt_len=12, mode="static",
                     block_size=8, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(f"r{i}", p.copy(), max_new=10, priority=i, params=sps[i]))
    stats = eng.run()
    assert len(eng.finished) == len(prompts)
    return eng, stats, {k: v.out_tokens for k, v in eng.finished.items()}


@pytest.mark.parametrize("chunk", [None, 8])
def test_sampled_streams_and_replay_match_jax(tiny, chunk):
    """The JAX package's sampled-preemption case (4 requests of 14 tokens,
    temperature 0.8, top-k 64, top-p 0.95, seeds 100-103): the port's
    streams on the contiguous cache, and on a paged pool of 7 pages that
    evicts and replays, equal each other and the live JAX engine's on the
    same pool; a restart reports a real TTFT."""
    cfg_j, params_j, cfg_t, params_t = tiny
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, 14).astype(np.int32) for _ in range(4)]
    kw = dict(prefill_chunk=chunk)
    _, _, ref = _serve(EngineCore, Request, cfg_t, params_t, prompts,
                       _sampled_params(SamplingParams), cache_layout="contiguous", device="cpu",
                       **kw)
    eng, stats, got = _serve(EngineCore, Request, cfg_t, params_t, prompts,
                             _sampled_params(SamplingParams), cache_layout="paged", num_blocks=7,
                             device="cpu", **kw)
    _, jstats, want = _serve(JEngineCore, JRequest, cfg_j, params_j, prompts,
                             _sampled_params(JSamplingParams), cache_layout="paged",
                             num_blocks=7, **kw)
    assert stats.preemptions > 0 and stats.replayed_tokens > 0
    assert got == ref == want
    assert (stats.preemptions, stats.replayed_tokens) == (jstats.preemptions,
                                                          jstats.replayed_tokens)
    assert all(r.first_token_t > 0.0 for r in eng.finished.values())
    assert any(t != r for t, r in zip(got["r0"], _greedy_stream(tiny, prompts[0])))


def _greedy_stream(tiny, prompt):
    _, _, cfg_t, params_t = tiny
    eng = EngineCore(cfg_t, params_t, n_slots=1, max_len=64, device="cpu")
    return list(eng.generate(prompt, max_new=10))[-1].token_ids


def _abort_run(engine_cls, request_cls, cfg, params, prompts, **kw):
    """Three requests on a paged int8 chunked engine with 2 slots: ``a``
    decoding, ``b`` part-way through its chunked prefill, ``c`` queued;
    each is aborted.  Returns (engine, the abort outputs, a later request's
    tokens)."""
    eng = engine_cls(cfg, params, n_slots=2, max_len=64, prompt_len=12, cache_layout="paged",
                     block_size=8, kv_dtype="int8", prefill_chunk=8, **kw)
    eng.submit(request_cls("a", prompts[0].copy(), max_new=20))
    while not eng.scheduler.inflight:
        eng.step()
    eng.submit(request_cls("b", prompts[1].copy(), max_new=4))
    eng.submit(request_cls("c", prompts[2].copy(), max_new=4))
    eng.step()  # b's first chunk of three, then a decode round
    assert [p.req.request_id for p in eng._prefilling.values()] == ["b"]
    outs = [eng.abort(rid) for rid in ("b", "a", "c")]
    assert eng.abort("c") is None and eng.abort("nope") is None
    assert not eng.has_unfinished()
    eng.submit(request_cls("d", prompts[3].copy(), max_new=5))
    eng.run()
    return eng, outs, eng.finished["d"].out_tokens


def test_abort_queued_mid_chunk_and_decoding_like_jax(tiny):
    """Abort from the queue, mid-chunked-prefill and mid-decode: the same
    terminal outputs as the JAX engine's, no live page left, and a request
    served afterwards gives the tokens it gives in a fresh engine."""
    cfg_j, params_j, cfg_t, params_t = tiny
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (9, 20, 5, 11)]
    eng, outs, after = _abort_run(EngineCore, Request, cfg_t, params_t, prompts, device="cpu")
    jeng, jouts, jafter = _abort_run(JEngineCore, JRequest, cfg_j, params_j, prompts)
    for o, j in zip(outs, jouts):
        assert (o.request_id, o.finished, o.finish_reason, o.new_token_ids, list(o.token_ids)) == (
            j.request_id, j.finished, j.finish_reason, j.new_token_ids, list(j.token_ids))
        assert o.finish_reason == "abort" and eng.finished[o.request_id].done_t > 0.0
    assert len(outs[1].token_ids) > 0 and not outs[0].token_ids and not outs[2].token_ids
    assert eng.stats.aborts == jeng.stats.aborts == 3
    assert after == jafter
    fresh = EngineCore(cfg_t, params_t, n_slots=2, max_len=64, prompt_len=12,
                       cache_layout="paged", block_size=8, kv_dtype="int8", prefill_chunk=8,
                       device="cpu")
    assert list(fresh.generate(prompts[3], max_new=5))[-1].token_ids == after
    assert eng.runner.paged.pool.num_live == 0 == jeng.runner.paged.pool.num_live


# ------------------------------------------------------- policy and surface --


def test_swap_cost_aware_policy_decisions_match_jax():
    """A scripted run of views through both packages' policy, under four
    settings: the same decision at every step."""
    rng = np.random.default_rng(8)
    views = [dict(queue_depth=int(rng.integers(0, 6)), free_slots=int(rng.integers(0, 3)),
                  active_slots=int(rng.integers(0, 4)), swap_cost=float(rng.choice([0.0, 0.04])),
                  decode_round_cost=float(rng.choice([0.0, 0.01, 0.03])),
                  pending_chunks=int(rng.choice([0, 0, 0, 2])),
                  oldest_wait_s=float(rng.uniform(0, 1))) for _ in range(200)]
    for kw in (dict(), dict(max_defer_rounds=3), dict(min_queue=2, max_defer_rounds=4),
               dict(cost_ratio=2.0, swap_cost_override=0.05)):
        pol, jpol = SwapCostAwarePolicy(**kw), JSwapCostAwarePolicy(**kw)
        for i, v in enumerate(views):
            assert pol.should_prefill(SchedulerView(**v)) == jpol.should_prefill(
                JSchedulerView(**v)), (kw, i)
            if i % 50 == 49:
                pol.reset()
                jpol.reset()
    assert isinstance(make_policy("swap-aware", min_queue=3), SwapCostAwarePolicy)
    for fn in (make_policy, j_make_policy):
        with pytest.raises(ValueError, match="unknown swap policy"):
            fn("nope")
    assert make_policy("slo-aware").name == j_make_policy("slo-aware").name == "slo-aware"
    with pytest.raises(ValueError, match="max_defer_rounds"):
        SwapCostAwarePolicy(max_defer_rounds=0)


def test_swap_aware_engine_gives_drain_tokens_and_the_alias_serves(tiny):
    _, _, cfg_t, params_t = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (7, 20, 12, 5, 9)]

    def serve(engine_cls, policy):
        eng = engine_cls(cfg_t, params_t, n_slots=2, max_len=64, prompt_len=12,
                         swap_policy=policy, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p.copy(), max_new=6))
        eng.run()
        return {k: v.out_tokens for k, v in eng.finished.items()}

    drain = serve(EngineCore, None)
    assert serve(EngineCore, SwapCostAwarePolicy(min_queue=2, max_defer_rounds=4)) == drain
    assert serve(EngineCore, "swap-aware") == drain
    assert issubclass(ServingEngine, EngineCore) and serve(ServingEngine, "drain") == drain


def test_engine_stats_snapshot_has_the_jax_keys(tiny):
    """``EngineStats.snapshot()`` has the JAX package's keys, nested ones
    included, and after a run counts one queue wait and one TTFT a request
    and one ITL for every later token."""

    def keys(d, prefix=""):
        return {prefix + k for k in d} | {x for k, v in d.items() if isinstance(v, dict)
                                          for x in keys(v, prefix + k + ".")}

    assert keys(EngineStats().snapshot()) == keys(JEngineStats().snapshot())
    _, _, cfg_t, params_t = tiny
    eng = EngineCore(cfg_t, params_t, n_slots=2, max_len=64, prompt_len=12, device="cpu")
    for i, n in enumerate((5, 9, 7)):
        eng.submit(Request(f"r{i}", np.arange(n, dtype=np.int32), max_new=4))
    snap = eng.run().snapshot()
    assert snap["queue_wait_s"]["count"] == snap["ttft_s"]["count"] == 3
    assert snap["itl_s"]["count"] == 3 * 3 and snap["prefill_bursts"] >= 1
    assert snap["spec_tokens_per_round"] == 1.0 and snap["aborts"] == 0
