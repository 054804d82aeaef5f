"""Speculative decoding in the port against the JAX package, on the CPU.

The drafter, the multi-token output processor, the rollback of a slot's
pages and the six verify writers are held to the JAX package exactly (the
writers byte for byte against ``jax.jit`` of the JAX writers, which drop
rows with ``mode="drop"``; the port's repeat the first kept row's write and
read nothing back).  The verify pass is held to the jitted JAX pass (logits
within ``MODEL_TOL``, the written rows as the chunk programs' are) and to
the port's own sequential decode steps, which it stands in for.  Engine
streams and the speculative counters are held to a live JAX ``EngineCore``
with ``spec_decode`` on the same packed weights, made with numpy from a
seed, on the config of the JAX package's ``tests/test_spec_decode.py``; the
greedy ones also to the port's own plain decode.  That file's two tests
that pin literal acceptance rates and stop tokens fail on the JAX package
itself (its tiny model's greedy stream repeats one token), so they are not
copied: the port's counters are held to the JAX engine's instead.
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import sampling as JS
from repro.layers import attention as JA
from repro.models import transformer as JT
from repro.quant.kv_quant import QuantKV as JQuantKV
from repro.serving import EngineCore as JEngineCore, Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.outputs import OutputProcessor as JOutputProcessor
from repro.serving.paging import PagedKVCache as JPagedKVCache
from repro.serving.spec_decode import find_draft as j_find_draft

from repro_torch.configs import reduced_config
from repro_torch.core import sampling as S
from repro_torch.interop import params_from_numpy
from repro_torch.layers import attention as A
from repro_torch.layers.norm import apply_norm_blocks
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import QuantKV, unpack_int4
from repro_torch.serving import EngineCore, Request, SamplingParams, ServingEngine
from repro_torch.serving.outputs import OutputProcessor
from repro_torch.serving.paging import PagedKVCache
from repro_torch.serving.spec_decode import find_draft
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)
MODEL_TOL = 1e-4  # f32 logits, summed in another order than XLA's
STEP_TOL = 1e-5  # the verify pass against the port's own decode steps: batch shapes differ
# JAX's verify pass over a bf16 cache rounds q and the probabilities to bf16
# (2^-9 relative) where decode keeps them f32: measured up to 0.021 here
BF16_CAST_TOL = 0.05
L, HKV, D, W = 3, 2, 32, 5  # the writers' caches; W = k + 1 block rows, k = 4


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).contiguous().numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(t))
    return (a.view(np.uint16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _planes(leaf):
    return list(leaf) if isinstance(leaf, (QuantKV, JQuantKV)) else [leaf]


def _assert_same_bytes(got, want):
    for t, j in zip(_planes(got), _planes(want)):
        assert _bytes(t) == _bytes(j)


def _leaf(rng, kind, shape):
    """The same random cache or pool leaf for both packages: bf16 values, an
    f32 scale plane (``shape`` without its last dim), or random payload
    bytes with positive scales."""
    if kind in ("fp", "scales"):
        a = rng.normal(size=shape if kind == "fp" else shape[:-1]).astype(np.float32)
        if kind == "scales":
            return jnp.asarray(a), torch.from_numpy(a.copy())
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    d = shape[-1] // 2 if kind == "int4" else shape[-1]
    q = rng.integers(0 if kind == "int4" else -127, 255 if kind == "int4" else 128,
                     shape[:-1] + (d,)).astype(np.uint8 if kind == "int4" else np.int8)
    s = rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32)
    return (JQuantKV(jnp.asarray(q), jnp.asarray(s)),
            QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))


# ---------------------------------------------------------------- the drafter --


def _contexts(n_cases=200):
    """Seeded contexts: random over a small or a full vocabulary, and tiled
    patterns, some broken by one stray token; each with a draft depth 0-5
    and an n-gram size 1-4."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n_cases):
        n = int(rng.integers(1, 40))
        if i % 2:
            pat = rng.integers(0, 512, int(rng.integers(1, 7)))
            ctx = np.tile(pat, n // len(pat) + 1)[:n]
            if i % 8 == 3:
                ctx[int(rng.integers(0, n))] = 7
        else:
            ctx = rng.integers(0, 4 if i % 4 == 0 else 512, n)
        out.append((ctx.astype(np.int32), int(rng.integers(0, 6)), int(rng.integers(1, 5))))
    return out


def test_find_draft_equals_jax_on_random_and_tiled_contexts():
    drafted = 0
    for ctx, k, n in _contexts():
        got = find_draft(ctx, k, n)
        assert got.dtype == np.int32 and len(got) <= k
        np.testing.assert_array_equal(got, j_find_draft(ctx, k, n))
        drafted += bool(len(got))
    assert drafted > 50  # the tiled contexts draft


# ------------------------------------------------------- multi-token outputs --

OUTPUT_CASES = [  # max_new, stop tokens, recorded tokens, the delta
    (10, (7,), [], [3, 7, 5, 6]),  # cut after the first stop token
    (4, (), [1, 2], [3, 4, 5, 6]),  # cut at the budget's headroom
    (2, (9,), [1], [9, 5]),  # a stop on the budget's last place: "stop"
    (2, (), [], [5]),  # one token: process_token's path
    (3, (), [1, 2, 3], [4]),  # no headroom left
    (6, (4,), [], [4, 4, 4]),  # the first token stops
    (8, (), [1], [2, 3, 4]),  # the whole delta kept, not finished
]


@pytest.mark.parametrize("max_new,stop,out,toks", OUTPUT_CASES)
def test_process_tokens_equals_jax(max_new, stop, out, toks):
    got_req = Request("t", np.arange(3, dtype=np.int32), max_new=max_new,
                      params=SamplingParams(stop_tokens=stop))
    want_req = JRequest("t", np.arange(3, dtype=np.int32), max_new=max_new,
                        params=JSamplingParams(stop_tokens=stop))
    got_req.out_tokens, want_req.out_tokens = list(out), list(out)
    if len(toks) == 1:
        got = OutputProcessor().process_token(got_req, toks[0])
        want = JOutputProcessor().process_token(want_req, toks[0])
    else:
        got = OutputProcessor().process_tokens(got_req, toks)
        want = JOutputProcessor().process_tokens(want_req, toks)
    assert (got.new_token_ids, got.token_ids, got.finished, got.finish_reason) == (
        want.new_token_ids, want.token_ids, want.finished, want.finish_reason)
    assert (got_req.first_token_t > 0.0) == bool(got.new_token_ids)
    assert OutputProcessor.resume_output(got_req) is None is JOutputProcessor.resume_output(want_req)


# ------------------------------------------------------------------ rollback --


def test_truncate_slot_leaves_pool_and_tables_as_jax():
    """A verify span grown past a prompt (through a page boundary, over a
    shared prefix with a copy-on-write fork), then rolled back at several
    lengths: the released counts, tables, free lists and refcounts equal
    the JAX package's."""
    shape = (10, 2, 2, 4, 8)
    jkv = JA.KVCache(jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
    tkv = T.KVCache(torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16))
    pair = (JPagedKVCache(jkv, n_slots=2, max_len=40, block_size=4),
            PagedKVCache(tkv, n_slots=2, max_len=40, block_size=4))
    toks = np.arange(9, dtype=np.int32)
    for cache in pair:
        m = cache.allocate_prompt(0, toks)
        cache.register_prompt_pages(m)
        cache.allocate_prompt(1, toks[:8])  # shares slot 0's two full pages
    released = []
    for cache in pair:
        got = []
        for slot, start, count, keep in ((0, 9, 7, 11), (1, 6, 5, 9), (1, 9, 4, 6), (0, 11, 3, 11)):
            for pos in range(start, start + count):
                cache.ensure_append_page(slot, pos)
            got.append(cache.truncate_slot(slot, keep))
            got.append(cache.truncate_slot(slot, keep))  # idempotent: 0
            got.append([list(t) for t in cache.tables])
            got.append((sorted(cache.pool.free_list), list(cache.pool.evictable),
                        [cache.pool.refcount(p) for p in range(cache.pool.num_blocks)]))
        released.append(got)
    assert released[0] == released[1]
    assert any(isinstance(x, int) and x > 0 for x in released[1])


# ------------------------------------------------------------ verify writers --

N_TOKENS = {"ragged": [2, 5, 0, 3], "last-only": [0, 0, 0, 3], "none": [0, 0, 0, 0]}
TABLES = np.array([[3, 9, 0, 0, 0], [7, 0, 4, 0, 0], [0, 0, 0, 0, 0], [2, 5, 11, 6, 0]], np.int32)


@pytest.mark.parametrize("n_tokens", list(N_TOKENS), ids=list(N_TOKENS))
@pytest.mark.parametrize("kind", ["fp", "scales", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_writers_byte_equal_jitted_jax(layout, kind, n_tokens):
    """A verify block (W = 5 rows a slot) into the cache or pool: the same
    bytes as the jitted JAX writer.  Rows past n_tokens are dropped, a slot
    of length 0 writes nothing, and (contiguous) a row past Smax is dropped
    (slot 3's third row at 24); paged, slot 3's third row lands in page 0,
    the table's unused entry, as in the JAX package.  ``fp`` and ``scales``
    call ``scatter_verify_tokens``/``scatter_verify_scales`` (and their
    paged versions) themselves, int8/int4 the quantizing ``_q`` writers."""
    rng = np.random.default_rng(len(kind) * 11 + len(n_tokens) + len(layout))
    n_tok = np.asarray(N_TOKENS[n_tokens], np.int32)
    if layout == "paged":
        shape, lengths = (12, L, HKV, 8, D), np.array([5, 17, 0, 30], np.int32)
    else:
        shape, lengths = (4, L, HKV, 24, D), np.array([5, 17, 0, 22], np.int32)
    jbuf, buf = _leaf(rng, kind, shape)
    new = rng.normal(size=(L, 4, HKV, W, D) if kind != "scales" else (L, 4, HKV, W))
    new = new.astype(np.float32)
    name = {"fp": "scatter_verify_tokens", "scales": "scatter_verify_scales"}.get(
        kind, "scatter_verify_tokens_q") + ("_paged" if layout == "paged" else "")
    if layout == "paged":
        name = name.replace("_q_paged", "_paged_q")
        args = (TABLES, lengths, n_tok)
    else:
        args = (lengths, n_tok)
    want = jax.jit(getattr(JA, name))(jbuf, jnp.asarray(new), *map(jnp.asarray, args))
    got = getattr(A, name)(buf, torch.from_numpy(new), *map(torch.from_numpy, args))
    _assert_same_bytes(got, want)


# ---------------------------------------------------------- the verify pass --


def _verify_case(tiny, layout, kv_dtype, seed=5):
    """A cache (or pool) of random contents, one free slot and ragged
    blocks: lengths [13, 0, 20, 7], n_tokens [5, 0, 3, 1], for both
    packages.  Paged: 16 pages of 8, each live slot's table covering its
    block."""
    cfg_j, _, cfg_t, _ = tiny
    rng = np.random.default_rng(seed)
    kind = "fp" if kv_dtype == "fp" else kv_dtype
    if layout == "paged":
        shape = (16, cfg_t.num_layers, cfg_t.num_kv_heads, 8, cfg_t.head_dim)
    else:
        shape = (4, cfg_t.num_layers, cfg_t.num_kv_heads, 32, cfg_t.head_dim)
    (jk, tk), (jv, tv) = (_leaf(rng, kind, shape) for _ in range(2))
    tokens = rng.integers(0, 512, (4, W)).astype(np.int32)
    lengths = np.array([13, 0, 20, 7], np.int32)
    n_tokens = np.array([5, 0, 3, 1], np.int32)
    tables = np.array([[3, 9, 12, 0], [0, 0, 0, 0], [7, 1, 4, 0], [2, 0, 0, 0]], np.int32)
    return (JA.KVCache(jk, jv), T.KVCache(tk, tv)), tokens, lengths, n_tokens, tables


def _live_rows(layout, lengths, n_tokens):
    """The (slot, row, position) of every row the pass writes."""
    return [(b, i, int(lengths[b]) + i) for b in range(4) for i in range(int(n_tokens[b]))
            if layout == "contiguous" or lengths[b] > 0]


def _written(layout, leaf, b, pos, tables):
    """Slot b's row at ``pos`` in every layer of a cache or pool plane."""
    if layout == "paged":
        return leaf[tables[b, pos // 8], :, :, pos % 8]
    return leaf[b, :, :, pos]


def _held_rows(layout, got, want, tables, rows):
    """The rows held to the reference's: an int4 row whose payload parts
    from the reference's by a step (float rounding of K/V moved a nibble)
    is read by the slot's later rows, whose values then move too, so a
    slot's rows after its first parted row are left out.  Returns them as
    [(slot, row, position)]."""
    first = {}
    for leaf, jleaf in zip(got, want):
        if isinstance(leaf, QuantKV) and leaf.q.dtype == torch.uint8:
            jq = torch.from_numpy(np.array(jleaf.q))
            for b, i, pos in rows:
                tr, jr = _written(layout, leaf.q, b, pos, tables), _written(layout, jq, b, pos, tables)
                if not torch.equal(tr, jr):
                    first[b] = min(first.get(b, i), i)
    return [(b, i, pos) for b, i, pos in rows if b not in first or i <= first[b]]


def _assert_rows_like(layout, got, want, tables, rows):
    """The written rows against the reference's: bf16 rows and int8
    payloads byte for byte; K/V differ from XLA's by float rounding
    (RMSNorm's sum, RoPE's sin and cos), so an f32 scale plane is held
    within 1e-6 relative and an int4 payload, whose steps are coarse, to at
    most one step, as the chunk programs' rows are."""
    for leaf, jleaf in zip(got, want):
        for t, j in zip(_planes(leaf), _planes(jleaf)):
            j = torch.from_numpy(np.array(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j))
            for b, i, pos in rows:
                tr, jr = _written(layout, t, b, pos, tables), _written(layout, j, b, pos, tables)
                if t.dtype == torch.bfloat16:
                    assert torch.equal(tr.float(), jr)
                elif t.dtype == torch.float32:
                    np.testing.assert_allclose(tr.numpy(), jr.numpy(), rtol=1e-6, atol=0)
                elif t.dtype == torch.uint8:  # int4 nibble pairs
                    assert (unpack_int4(tr).int() - unpack_int4(jr).int()).abs().max() <= 1
                else:
                    assert torch.equal(tr, jr)


def _steps_jax(cfg_j, params_j, jcache, tokens, lengths, tables, layout):
    """The JAX package's jitted decode step (its Pallas decode kernel)
    teacher-forced through the block's tokens: ((B, W, Vp) logits, the
    cache it leaves)."""
    if layout == "paged":
        step = jax.jit(functools.partial(JT.decode_step_paged, cfg=cfg_j))
        extra = (jnp.asarray(tables),)
    else:
        step = jax.jit(functools.partial(JT.decode_step, cfg=cfg_j))
        extra = ()
    out = []
    for i in range(tokens.shape[1]):
        jl, jcache = step(params_j, jnp.asarray(tokens[:, i]), jcache, *extra,
                          jnp.asarray(lengths + i))
        out.append(np.asarray(jl))
    return np.stack(out, axis=1), jcache


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_pass_matches_jitted_jax(tiny, layout, kv_dtype):
    """``T.verify`` / ``T.verify_paged`` against ``jax.jit`` of the JAX pass
    (a dense pass over the cache extended by the storage-rounded block
    rows): every byte the port must not write (other slots, rows past
    n_tokens, other pages) untouched; the written rows as the JAX pass
    writes them; the logits of the real rows within MODEL_TOL.  Two
    reference traits bound this.  Over an fp (bf16) cache the JAX pass
    rounds q and the probabilities to bf16 (its jnp streaming math), where
    its decode kernel, and the port, keep them f32, which moves the logits
    and the later layers' K/V: there the rows and logits are held to the
    jitted JAX decode steps they stand for, and the logits within
    BF16_CAST_TOL to the JAX pass.  An int4 row that parts from JAX's by a
    step moves the rows that read it: those are left out (``_held_rows``)."""
    cfg_j, params_j, cfg_t, params_t = tiny
    (jcache, cache), tokens, lengths, n_tokens, tables = _verify_case(tiny, layout, kv_dtype)
    before = [t.clone() for leaf in cache for t in _planes(leaf)]
    if kv_dtype == "fp":
        steps, jsteps = _steps_jax(cfg_j, params_j, jcache, tokens, lengths, tables, layout)
    if layout == "paged":
        fn = jax.jit(functools.partial(JT.verify_paged, cfg=cfg_j))
        jl, jcache = fn(params_j, jnp.asarray(tokens), jcache, jnp.asarray(tables),
                        jnp.asarray(lengths), jnp.asarray(n_tokens))
        tl, cache = T.verify_paged(params_t, torch.from_numpy(tokens), cache,
                                   torch.from_numpy(tables), torch.from_numpy(lengths),
                                   torch.from_numpy(n_tokens), cfg_t)
    else:
        fn = jax.jit(functools.partial(JT.verify, cfg=cfg_j))
        jl, jcache = fn(params_j, jnp.asarray(tokens), jcache, jnp.asarray(lengths),
                        jnp.asarray(n_tokens))
        tl, cache = T.verify(params_t, torch.from_numpy(tokens), cache, torch.from_numpy(lengths),
                             torch.from_numpy(n_tokens), cfg_t)
    rows = _live_rows(layout, lengths, n_tokens)
    assert tl.shape == (4, W, cfg_t.padded_vocab())
    ref_cache, ref_logits = (jsteps, steps) if kv_dtype == "fp" else (jcache, np.asarray(jl))
    held = _held_rows(layout, cache, ref_cache, tables, rows)
    assert any(i > 0 for _, i, _ in held)  # rows that read block rows are held
    _assert_rows_like(layout, cache, ref_cache, tables, held)
    for b, i, _ in held:
        np.testing.assert_allclose(tl[b, i].numpy(), ref_logits[b, i], atol=MODEL_TOL, rtol=0)
        if kv_dtype == "fp":
            np.testing.assert_allclose(tl[b, i].numpy(), np.asarray(jl)[b, i], atol=BF16_CAST_TOL,
                                       rtol=0)
    # everything the pass must not write keeps its bytes
    after = [t for leaf in cache for t in _planes(leaf)]
    allowed = ({(int(tables[b, p // 8]), p % 8) for b, _, p in rows} if layout == "paged"
               else {(b, p) for b, _, p in rows})
    for t0, t1 in zip(before, after):
        changed = (t0 != t1).reshape(*t0.shape[:4], -1).any(-1)
        assert {tuple(x) for x in changed.nonzero()[:, [0, 3]].tolist()} <= allowed


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_pass_is_sequential_decode(tiny, layout, kv_dtype):
    """The pass stands in for W decode steps: on the same cache, teacher
    forcing the block's tokens one step at a time through ``decode_step``
    (every slot live) gives each row's logits within STEP_TOL and the same
    cache bytes."""
    _, _, cfg_t, params_t = tiny
    (_, cache), tokens, _, _, _ = _verify_case(tiny, layout, kv_dtype, seed=6)
    lengths = np.array([13, 9, 20, 7], np.int32)
    n_tokens = np.full((4,), W, np.int32)
    tables = np.array([[3, 9, 12, 0], [5, 6, 0, 0], [7, 1, 4, 0], [2, 8, 0, 0]], np.int32)
    steps = T.KVCache(*(QuantKV(*(t.clone() for t in leaf)) if isinstance(leaf, QuantKV)
                        else leaf.clone() for leaf in cache))
    tok, lens, tab = (torch.from_numpy(a) for a in (tokens, lengths, tables))
    if layout == "paged":
        logits, _ = T.verify_paged(params_t, tok, cache, tab, lens, torch.from_numpy(n_tokens),
                                   cfg_t)
        seq = [T.decode_step_paged(params_t, tok[:, i], steps, tab, lens + i, cfg_t)[0]
               for i in range(W)]
    else:
        logits, _ = T.verify(params_t, tok, cache, lens, torch.from_numpy(n_tokens), cfg_t)
        seq = [T.decode_step(params_t, tok[:, i], steps, lens + i, cfg_t)[0] for i in range(W)]
    torch.testing.assert_close(logits, torch.stack(seq, dim=1), atol=STEP_TOL, rtol=0)
    for a, b in zip(cache, steps):
        _assert_same_bytes(a, b)


def test_block_sampler_equals_jitted_jax():
    """The block sampler program on (4, 5, 32256) logits, one slot greedy,
    against ``jax.jit(sample_block_tokens)``: the same (4, 5) tokens."""
    from repro_torch.core.phase_engine import PhaseEngine

    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(4, W, 32256)) * 3).astype(np.float32)
    seeds = np.array([11, 2**31 - 1, 0, 4242], np.int32)
    step0s = np.array([0, 17, 5, 300], np.int32)
    temps = np.array([0.8, 0.0, 1.3, 0.6], np.float32)
    top_ks = np.array([50, 0, 0, 7], np.int32)
    top_ps = np.array([0.9, 1.0, 1.0, 0.95], np.float32)
    args = (logits, seeds, step0s, temps, top_ks, top_ps)
    want = np.asarray(jax.jit(JS.sample_block_tokens)(*map(jnp.asarray, args)))
    cfg = reduced_config("bitnet-730m", **TINY)
    prog = PhaseEngine(cfg).block_sampler_program(4, W)
    assert prog.name == f"block_sampler:4x{W}" and prog.capturable
    got = prog(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), logits[1].argmax(-1))


# ---------------------------------------------------------------- the engine --


def _prompts(seed=3):
    """The JAX spec tests' workload: one self-repetitive prompt (the
    drafter's regime) and two random ones."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 512, 6).astype(np.int32)
    return [np.tile(pat, 4), rng.integers(0, 512, 14).astype(np.int32),
            rng.integers(0, 512, 9).astype(np.int32)]


def _serve(engine_cls, request_cls, cfg, params, prompts, *, max_new=12, max_len=64, sps=None,
           n_slots=3, **kw):
    eng = engine_cls(cfg, params, n_slots=n_slots, max_len=max_len, prompt_len=12,
                     block_size=8, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(f"r{i}", p.copy(), max_new=max_new,
                               **({} if sps is None else dict(params=sps[i]))))
    stats = eng.run()
    assert len(eng.finished) == len(prompts)
    return eng, stats, {k: v.out_tokens for k, v in eng.finished.items()}


SPEC_COUNTERS = ("draft_tokens", "accepted_tokens", "verify_rounds", "decode_rounds",
                 "decode_tokens", "slot_rounds", "decode_ctx_tokens", "preemptions",
                 "replayed_tokens")


def _both(tiny, prompts, *, sampled=(), **kw):
    """The port's and the live JAX engine's run of the same requests
    (requests ``sampled`` at temperature 0.9, top-k 20, top-p 0.9)."""
    cfg_j, params_j, cfg_t, params_t = tiny

    def sps(mod):
        return [mod(temperature=0.9, top_k=20, top_p=0.9, seed=11 + i) if i in sampled
                else mod() for i in range(len(prompts))]

    got = _serve(EngineCore, Request, cfg_t, params_t, prompts, sps=sps(SamplingParams),
                 device="cpu", **kw)
    want = _serve(JEngineCore, JRequest, cfg_j, params_j, prompts, sps=sps(JSamplingParams), **kw)
    assert got[2] == want[2]
    assert [getattr(got[1], c) for c in SPEC_COUNTERS] == [getattr(want[1], c)
                                                            for c in SPEC_COUNTERS]
    return got


ENGINE_CASES = [  # layout, kv_dtype, mode, the sampled requests
    ("contiguous", "fp", "static", ()),
    ("contiguous", "int8", "pdswap", ()),
    ("contiguous", "int4", "static", (1,)),
    ("paged", "fp", "pdswap", ()),
    ("paged", "int8", "static", (2,)),
    ("paged", "int4", "static", ()),
]


@pytest.mark.parametrize("layout,kv_dtype,mode,sampled", ENGINE_CASES)
def test_spec_streams_and_counters_equal_jax(tiny, layout, kv_dtype, mode, sampled):
    """Every layout x KV format, both modes, greedy and sampled requests:
    the port's speculative streams and counters equal the live JAX spec
    engine's, and the streams equal the port's plain decode."""
    _, _, cfg_t, params_t = tiny
    prompts = _prompts()
    kw = dict(cache_layout=layout, kv_dtype=kv_dtype, mode=mode)
    eng, stats, got = _both(tiny, prompts, sampled=sampled, spec_decode=4, **kw)
    sps = [SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=11 + i) if i in sampled
           else SamplingParams() for i in range(len(prompts))]
    _, plain, ref = _serve(EngineCore, Request, cfg_t, params_t, prompts, sps=sps, device="cpu",
                           **kw)
    assert got == ref
    assert stats.verify_rounds > 0 and stats.accepted_tokens > 0
    assert stats.decode_rounds < plain.decode_rounds or sampled  # a sampled slot drafts poorly
    assert eng.runner.verify_prog.name == (
        f"verify_paged:3x{W}@8" if layout == "paged" else f"verify:3x{W}@64")


@pytest.mark.parametrize("kv_dtype", ["fp", "int4"])
def test_spec_preemption_replay_mid_speculation_equals_jax(tiny, kv_dtype):
    """A pool of 7 pages evicts and replays requests mid-speculation: the
    streams, the counters and the evictions equal the JAX engine's and the
    port's unpreempted contiguous plain stream, and every page comes home."""
    _, _, cfg_t, params_t = tiny
    rng = np.random.default_rng(4)
    pat = rng.integers(0, 512, 7).astype(np.int32)
    prompts = [np.tile(pat, 2)] + [rng.integers(0, 512, 14).astype(np.int32) for _ in range(3)]
    eng, stats, got = _both(tiny, prompts, max_new=10, cache_layout="paged", kv_dtype=kv_dtype,
                            mode="static", spec_decode=4, num_blocks=7)
    _, _, ref = _serve(EngineCore, Request, cfg_t, params_t, prompts, max_new=10,
                       cache_layout="contiguous", kv_dtype=kv_dtype, mode="static", device="cpu")
    assert stats.preemptions > 0 and stats.replayed_tokens > 0 and stats.verify_rounds > 0
    assert got == ref
    pool = eng.runner.paged.pool
    assert pool.num_live == 0 and len(pool.free_list) + len(pool.evictable) == pool.num_blocks


def test_spec_draft_clamped_at_cache_headroom_equals_jax(tiny):
    """prompt + max_new == max_len with k = 8: the last rounds' drafts are
    clamped so live rows stay at or below max_len - 2 (asserted each
    round); the stream and counters equal the JAX engine's."""
    _, _, cfg_t, params_t = tiny
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, 512, 5).astype(np.int32), 4)]
    _, stats, got = _both(tiny, prompts, max_len=32, cache_layout="contiguous", mode="static",
                          spec_decode=8)
    _, _, ref = _serve(EngineCore, Request, cfg_t, params_t, prompts, max_len=32,
                       cache_layout="contiguous", mode="static", device="cpu")
    assert got == ref and stats.accepted_tokens > 0


def test_spec_unclamped_draft_trips_the_assertion(tiny):
    """A draft that would write live KV into row max_len - 1 (the draft
    clamp bypassed) is caught by the verify round's assertion."""
    _, _, cfg_t, params_t = tiny
    eng = EngineCore(cfg_t, params_t, n_slots=1, max_len=32, prompt_len=12, mode="static",
                     spec_decode=16, device="cpu")
    prompt = np.random.default_rng(0).integers(0, 512, 20).astype(np.int32)
    eng.submit(Request("r0", prompt, max_new=12))
    eng.runner.draft_for = lambda req, slot: np.zeros((11,), np.int32)  # rows to 20 + 11
    with pytest.raises(AssertionError):
        eng.run(max_rounds=4)


def test_generate_streams_multi_token_deltas_like_jax(tiny):
    """``generate`` on a paged spec engine streams the JAX engine's deltas,
    some of several tokens; ``ServingEngine`` takes ``spec_ngram``."""
    cfg_j, params_j, cfg_t, params_t = tiny
    prompt = _prompts()[0]
    kw = dict(n_slots=2, max_len=64, prompt_len=12, mode="static", cache_layout="paged",
              block_size=8, spec_decode=4, spec_ngram=2)
    got = [list(o.new_token_ids) for o in
           ServingEngine(cfg_t, params_t, device="cpu", **kw).generate(prompt, max_new=12,
                                                                      request_id="g")]
    want = [list(o.new_token_ids) for o in
            JEngineCore(cfg_j, params_j, **kw).generate(prompt, max_new=12, request_id="g")]
    assert got == want
    assert sum(map(len, got)) == 12 and max(map(len, got)) > 1


def test_spec_arguments_are_checked_like_jax(tiny):
    _, _, cfg_t, params_t = tiny
    kw = dict(n_slots=1, max_len=64, device="cpu")
    assert EngineCore(cfg_t, params_t, spec_decode=0, **kw).runner.spec_decode is None
    for bad in (dict(spec_decode=-1), dict(spec_decode=2, spec_ngram=0)):
        with pytest.raises(ValueError):
            EngineCore(cfg_t, params_t, **bad, **kw)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serving_grid_with_spec_equals_jax(tiny, layout):
    """With ``spec_decode=4`` the serving grid's program keys (the verify
    program and the block sampler among them) equal the JAX engine's."""
    cfg_j, params_j, cfg_t, params_t = tiny
    kw = dict(n_slots=3, max_len=96, prompt_len=12, block_size=8, cache_layout=layout,
              spec_decode=4)
    jeng = JEngineCore(cfg_j, params_j, **kw)
    eng = EngineCore(cfg_t, params_t, device="cpu", **kw)
    jeng.runner.build_serving_grid()
    eng.build_serving_grid()
    keys = set(eng.runner.engine.programs)
    assert keys == set(jeng.runner.engine.programs)
    assert f"block_sampler:3x{W}" in keys and any(k.startswith("verify") for k in keys)


def test_verify_programs_hold_no_host_sync():
    """What the verify and block-sampler programs run on top of the decode
    path reads nothing back to the host and builds no tensor from host
    values (the graph a card captures them into could not)."""
    import inspect

    fns = [T.verify, T.verify_paged, T._layer_view, T._decode_layers, A._block_rows,
           A._targets, A.verify_targets, A.verify_page_targets, A.write_verify_rows,
           A.write_verify_rows_q, A.verify_plan, A._verify_rows, A._layer0, A.attention_verify,
           A.attention_verify_paged, A._decode_new_token, A.scatter_verify_tokens,
           A.scatter_verify_scales, A.scatter_verify_tokens_q, A.scatter_verify_tokens_paged,
           A.scatter_verify_scales_paged, A.scatter_verify_tokens_paged_q, S.sample_block_tokens,
           apply_norm_blocks]
    for fn in fns:
        src = inspect.getsource(fn)
        for bad in ("nonzero", ".item(", ".cpu(", ".tolist(", "torch.tensor(", "repeat_interleave"):
            assert bad not in src, (fn.__qualname__, bad)
