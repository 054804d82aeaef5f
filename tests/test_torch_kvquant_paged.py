"""The port's quantized KV and paged cache against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernels in interpret mode, ``use_pallas=True``, on weights packed
by ``jax.vmap(quantize_and_pack)``) and through the port's counterpart (the
plain PyTorch versions, since these tensors lie on the CPU).  Quantized
payloads, scale planes, page writes and pool decisions are compared byte
for byte, attention within 1e-5, and greedy streams token for token.
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core.kv_cache import insert_prefill_kv as j_insert_prefill_kv
from repro.core.phase_engine import PhaseEngine as JPhaseEngine
from repro.kernels.decode_attention.kernel import (
    decode_attention_pallas,
    decode_attention_quant_pallas,
)
from repro.kernels.paged_attention.kernel import (
    paged_decode_attention_pallas,
    paged_decode_attention_quant_pallas,
)
from repro.layers.attention import KVCache as JKVCache
from repro.quant import kv_quant as J
from repro.serving import EngineCore as JEngineCore, Request as JRequest
from repro.serving.paging import BlockPool as JBlockPool, PagedKVCache as JPagedKVCache

from repro_torch.configs import reduced_config
from repro_torch.core.kv_cache import insert_prefill_kv
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.interop import kv_from_numpy, params_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_split_reference, rank_ranges
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_split_reference
from repro_torch.models import transformer as T
from repro_torch.quant import kv_quant as K
from repro_torch.serving import EngineCore, Request
from repro_torch.serving.paging import BlockPool, PagedKVCache, PoolExhausted
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

# f32 attention summed in another order than the Pallas kernels' blocked
# online softmax: a few ulp of O(1) values
ATTN_TOL = 1e-5
MODEL_TOL = 1e-4


# ------------------------------------------------------------ quantization --


def _rows_with_ties(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, 4, 9, 64)) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1.0, payload 0
    x[0, 1, :] = 0.0
    x[1, 1, 1] = np.linspace(-7, 7, 64).astype(np.float32) * 3.0  # x/scale = k/9*... ties
    x[1, 2, 2] = np.arange(64, dtype=np.float32) - 31.5  # int4: scale 31.5/7 = 4.5, .5 ties
    x[2, 0, 3, :8] = [127.0, 0.5, 1.5, -2.5, 63.5, -63.5, 0.0, 3.5]  # int8: scale 1.0, exact ties
    x[2, 0, 3, 8:] = 0.0
    return x


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantize_kv_and_int4_packing_byte_equal_jax(kv_dtype):
    """Against ``quantize_kv`` as the JAX package's serving programs run it:
    jitted (XLA multiplies by the f32 reciprocal of qmax for the scale)."""
    x = _rows_with_ties(0)
    jq, js = jax.jit(J.quantize_kv, static_argnums=1)(jnp.asarray(x), kv_dtype)
    tq, ts = K.quantize_kv(torch.from_numpy(x), kv_dtype)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 1.0 and (ts[0, 1] == 1.0).all()
    np.testing.assert_array_equal(K.dequantize_kv(tq, ts, kv_dtype).numpy(),
                                  np.asarray(J.dequantize_kv(jq, js, kv_dtype)))
    jt = jax.jit(J.quantize_kv_tree, static_argnums=1)(JKVCache(jnp.asarray(x), jnp.asarray(-x)),
                                                       kv_dtype)
    tt = K.quantize_kv_tree(T.KVCache(torch.from_numpy(x), torch.from_numpy(-x)), kv_dtype)
    _assert_same_bytes(tt, jt)
    assert K.payload_bytes(tt) == J.payload_bytes(jt)
    assert K.total_nbytes(tt) == J.total_nbytes(jt)
    if kv_dtype == "int4":
        vals = np.random.default_rng(1).integers(-8, 8, size=(5, 7, 32)).astype(np.int8)
        jp = np.asarray(J.pack_int4(jnp.asarray(vals)))
        np.testing.assert_array_equal(K.pack_int4(torch.from_numpy(vals)).numpy(), jp)
        np.testing.assert_array_equal(K.unpack_int4(torch.from_numpy(jp.copy())).numpy(), vals)


# ------------------------------------------------------- decode walks B4-B6 --


def _quant_cache(rng, shape, kv_dtype):
    """Payload and scales of a quantized cache, made with the JAX package."""
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    q, s = jax.jit(J.quantize_kv, static_argnums=1)(x, kv_dtype)
    return np.asarray(q), np.asarray(s)


def _check_stats(got, want, b, h, d):
    out_t, l_t, m_t = got
    out_j, l_j, m_j = (np.asarray(a) for a in want)
    np.testing.assert_allclose(out_t.numpy(), out_j.reshape(b, h, d), atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(l_t.numpy()[..., 0], l_j[..., 0].reshape(b, h),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(m_t.numpy()[..., 0], m_j[..., 0].reshape(b, h), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_attention_quant_plain_vs_pallas(kv_dtype, g):
    """B4's plain version: (out, l, m) over a packed cache with ragged
    lengths, one of them 0, against the fused-dequant Pallas kernel."""
    rng = np.random.default_rng(10 + g)
    b, hkv, s, d = 4, 2, 96, 32
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    kq, ks = _quant_cache(rng, (b, hkv, s, d), kv_dtype)
    vq, vs = _quant_cache(rng, (b, hkv, s, d), kv_dtype)
    lengths = np.array([0, 1, 50, 96], np.int32)
    want = decode_attention_quant_pallas(
        jnp.asarray(q).reshape(b, hkv, g, d), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(lengths), kv_dtype=kv_dtype, bk=32, interpret=True)
    t = torch.from_numpy
    got = decode_attention(t(q), t(kq), t(vq), t(lengths), return_stats=True,
                           k_scales=t(ks), v_scales=t(vs), kv_dtype=kv_dtype)
    _check_stats(got, want, b, hkv * g, d)
    assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and (got[2][0] == -1e30).all()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_decode_attention_plain_vs_pallas(kv_dtype, g):
    """B5's (fp) and B6's (int8/int4) plain versions against the paged
    Pallas kernels: shuffled tables, unused entries 0, ragged lengths with
    partial pages and a 0, on a strided layer slice of a layer-stacked pool."""
    rng = np.random.default_rng(20 + g)
    b, hkv, d, bs, n_pages, n_layers = 3, 2, 32, 8, 4, 2
    n = b * n_pages + 3
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    tables = np.zeros((b, n_pages), np.int32)
    lengths = np.array([0, 13, 32], np.int32)
    perm = rng.permutation(n)
    for i, length in enumerate(lengths):
        used = -(-int(length) // bs)
        tables[i, :used] = perm[i * n_pages:i * n_pages + used]
    t = torch.from_numpy
    qg = jnp.asarray(q).reshape(b, hkv, g, d)
    if kv_dtype == "fp":
        pool = [jnp.asarray(rng.normal(size=(n, n_layers, hkv, bs, d)), jnp.bfloat16)
                for _ in range(2)]
        kp, vp = (p[:, 1] for p in pool)
        want = paged_decode_attention_pallas(qg, kp, vp, jnp.asarray(tables),
                                             jnp.asarray(lengths), interpret=True)
        tk, tv = (kv_from_numpy({"k": np.asarray(p), "v": np.asarray(p)}, "cpu").k for p in pool)
        got = paged_decode_attention(t(q), tk[:, 1], tv[:, 1], t(tables), t(lengths),
                                     return_stats=True)
    else:
        (kq, ks), (vq, vs) = (_quant_cache(rng, (n, n_layers, hkv, bs, d), kv_dtype)
                              for _ in range(2))
        want = paged_decode_attention_quant_pallas(
            qg, jnp.asarray(kq[:, 1]), jnp.asarray(ks[:, 1]), jnp.asarray(vq[:, 1]),
            jnp.asarray(vs[:, 1]), jnp.asarray(tables), jnp.asarray(lengths),
            kv_dtype=kv_dtype, interpret=True)
        got = paged_decode_attention(t(q), t(kq)[:, 1], t(vq)[:, 1], t(tables), t(lengths),
                                     return_stats=True, k_scales=t(ks)[:, 1],
                                     v_scales=t(vs)[:, 1], kv_dtype=kv_dtype)
    _check_stats(got, want, b, hkv * g, d)


@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_paged_decode_attention_split_reference_vs_pallas(kv_dtype, ranks):
    """The walk as the CUDA kernels split it (each rank's softmax state over
    its whole pages of [start, length), merged in rank order) against the
    paged Pallas kernels: a zero length, a partial page, and starts that
    leave ranks with nothing to walk."""
    rng = np.random.default_rng(30 + ranks)
    b, hkv, g, d, bs, n_pages, n_layers = 4, 2, 2, 32, 8, 8, 2
    n = b * n_pages + 3
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    lengths = np.array([0, 13, 45, 64], np.int32)
    starts = np.array([0, 0, 40, 9], np.int32)
    tables = np.zeros((b, n_pages), np.int32)
    perm = rng.permutation(n)
    for i, length in enumerate(lengths):
        used = -(-int(length) // bs)
        tables[i, :used] = perm[i * n_pages:i * n_pages + used]
    t = torch.from_numpy
    lo, hi = rank_ranges(t(starts), t(lengths), bs, ranks, n_pages * bs)
    assert ranks == 1 or (hi[:, 2] <= lo[:, 2]).any()  # sequence 2 leaves ranks empty
    args = (jnp.asarray(q), jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(starts))
    if kv_dtype == "fp":
        pool = [jnp.asarray(rng.normal(size=(n, n_layers, hkv, bs, d)), jnp.bfloat16)
                for _ in range(2)]
        kp, vp = (p[:, 1] for p in pool)
        want = paged_decode_attention_pallas(args[0], kp, vp, *args[1:], interpret=True)
        tk, tv = (kv_from_numpy({"k": np.asarray(p), "v": np.asarray(p)}, "cpu").k for p in pool)
        got = paged_decode_attention_split_reference(t(q), tk[:, 1], tv[:, 1], t(tables),
                                                     t(lengths), t(starts), ranks=ranks)
    else:
        (kq, ks), (vq, vs) = (_quant_cache(rng, (n, n_layers, hkv, bs, d), kv_dtype)
                              for _ in range(2))
        want = paged_decode_attention_quant_pallas(
            args[0], jnp.asarray(kq[:, 1]), jnp.asarray(ks[:, 1]), jnp.asarray(vq[:, 1]),
            jnp.asarray(vs[:, 1]), *args[1:], kv_dtype=kv_dtype, interpret=True)
        got = paged_decode_attention_split_reference(
            t(q), t(kq)[:, 1], t(vq)[:, 1], t(tables), t(lengths), t(starts), ranks=ranks,
            k_scales=t(ks)[:, 1], v_scales=t(vs)[:, 1], kv_dtype=kv_dtype)
    out, l, m = got
    h = hkv * g
    _check_stats((out.reshape(b, h, d), l.reshape(b, h, 1), m.reshape(b, h, 1)), want, b, h, d)
    assert (out[0] == 0).all() and (l[0] == 0).all() and (m[0] == -1e30).all()


@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_decode_attention_split_reference_vs_pallas(kv_dtype, ranks):
    """The contiguous walk as the CUDA kernels split it (16-row virtual
    pages of the slot, each rank's softmax state, merged in rank order)
    against the contiguous Pallas kernels, on a layer slice of a
    layer-stacked cache whose S = 150 is not whole pages: a zero length, a
    length that ends in the last partial page, and starts that leave ranks
    with nothing to walk."""
    rng = np.random.default_rng(40 + ranks)
    b, hkv, g, d, s, n_layers = 4, 2, 2, 32, 150, 2
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    lengths = np.array([0, 13, 150, 97], np.int32)
    starts = np.array([0, 0, 140, 9], np.int32)
    t = torch.from_numpy
    lo, hi = rank_ranges(t(starts), t(lengths), 16, ranks, s)
    assert ranks == 1 or (hi[:, 2] <= lo[:, 2]).any()  # sequence 2 leaves ranks empty
    args = (jnp.asarray(q), jnp.asarray(lengths), jnp.asarray(starts))
    if kv_dtype == "fp":
        cache = [jnp.asarray(rng.normal(size=(b, n_layers, hkv, s, d)), jnp.bfloat16)
                 for _ in range(2)]
        want = decode_attention_pallas(args[0], cache[0][:, 1], cache[1][:, 1], *args[1:], bk=32,
                                       interpret=True)
        tk, tv = (t(np.asarray(c.astype(jnp.float32))).to(torch.bfloat16) for c in cache)
        got = decode_attention_split_reference(t(q), tk[:, 1], tv[:, 1], t(lengths), t(starts),
                                               ranks=ranks)
    else:
        (kq, ks), (vq, vs) = (_quant_cache(rng, (b, n_layers, hkv, s, d), kv_dtype)
                              for _ in range(2))
        want = decode_attention_quant_pallas(
            args[0], jnp.asarray(kq[:, 1]), jnp.asarray(ks[:, 1]), jnp.asarray(vq[:, 1]),
            jnp.asarray(vs[:, 1]), *args[1:], kv_dtype=kv_dtype, bk=32, interpret=True)
        got = decode_attention_split_reference(
            t(q), t(kq)[:, 1], t(vq)[:, 1], t(lengths), t(starts), ranks=ranks,
            k_scales=t(ks)[:, 1], v_scales=t(vs)[:, 1], kv_dtype=kv_dtype)
    out, l, m = got
    h = hkv * g
    _check_stats((out.reshape(b, h, d), l.reshape(b, h, 1), m.reshape(b, h, 1)), want, b, h, d)
    assert (out[0] == 0).all() and (l[0] == 0).all() and (m[0] == -1e30).all()


@pytest.mark.parametrize("bs,cap", [(16, 150), (16, 15), (8, 301)])
def test_rank_ranges_stop_at_a_capacity_that_is_not_whole_pages(bs, cap):
    """A contiguous slot's S need not be whole pages: the ranks still cover
    [start, min(length, S)) once, in whole pages but the last, and no rank's
    range reaches S (the kernel's last partial page stops within the slot)."""
    rng = np.random.default_rng(cap)
    lengths = torch.from_numpy(rng.integers(-2, cap + 40, 64).astype(np.int32))
    lengths[:4] = torch.tensor([cap, cap + 1, cap - 1, 0], dtype=torch.int32)
    starts = torch.from_numpy(rng.integers(-3, cap, 64).astype(np.int32))
    starts[:4] = 0
    for ranks in (1, 3, 8):
        lo, hi = rank_ranges(starts, lengths, bs, ranks, cap)
        assert (hi <= cap).all()
        for i in range(64):
            start, length = max(int(starts[i]), 0), min(int(lengths[i]), cap)
            live = [(int(a), int(z)) for a, z in zip(lo[:, i], hi[:, i]) if z > a]
            if length <= start:
                assert not live
                continue
            assert live[0][0] == start and live[-1][1] == length
            for (_, z), (a, _) in zip(live, live[1:]):
                assert z == a and a % bs == 0


@pytest.mark.parametrize("bs", [1, 8, 16])
def test_rank_ranges_tile_the_window_in_whole_pages(bs):
    """Each sequence's ranks cover [start, length) once, in rank order; every
    boundary between two ranks is a page boundary; the ranks that walk
    nothing come last; no rank takes more than its even share of pages."""
    rng = np.random.default_rng(bs)
    n_pages = 12
    cap = n_pages * bs
    lengths = torch.from_numpy(rng.integers(-2, cap + 6, 64).astype(np.int32))
    starts = torch.from_numpy(rng.integers(-3, cap, 64).astype(np.int32))
    for ranks in (1, 3, 8):
        lo, hi = rank_ranges(starts, lengths, bs, ranks, cap)
        for i in range(64):
            start, length = max(int(starts[i]), 0), min(int(lengths[i]), cap)
            live = [(int(a), int(z)) for a, z in zip(lo[:, i], hi[:, i]) if z > a]
            assert all(z <= a for a, z in zip(lo[len(live):, i], hi[len(live):, i]))
            if length <= start:
                assert not live
                continue
            assert live[0][0] == start and live[-1][1] == length
            for (_, z), (a, _) in zip(live, live[1:]):
                assert z == a and a % bs == 0
            n = -(-length // bs) - start // bs
            assert all(-(-z // bs) - a // bs <= -(-n // ranks) for a, z in live)


# ------------------------------------------------ the swap writes, by bytes --


def _planes(tree):
    return [a for leaf in tree for a in (leaf if isinstance(leaf, (tuple, list)) else (leaf,))]


def _assert_same_bytes(tree_t, tree_j):
    got, want = _planes(tree_t), _planes(tree_j)
    assert len(got) == len(want)
    for a_t, a_j in zip(got, want):
        a_j = np.asarray(a_j)
        if a_t.dtype == torch.bfloat16:  # compare the bits
            a_t, a_j = a_t.view(torch.int16), a_j.view(np.int16)
        np.testing.assert_array_equal(a_t.numpy(), a_j)


def _random_quant_tree(rng, shape, kv_dtype):
    """A cache or pool holding random bytes (so untouched rows can be told
    apart), as numpy for both packages."""
    dp = shape[-1] // 2 if kv_dtype == "int4" else shape[-1]
    dtype = np.uint8 if kv_dtype == "int4" else np.int8
    info = np.iinfo(dtype)

    def leaf():
        return {"q": rng.integers(info.min, info.max + 1, size=shape[:-1] + (dp,)).astype(dtype),
                "scale": rng.uniform(0.5, 2.0, size=shape[:-1]).astype(np.float32)}

    return {"k": leaf(), "v": leaf()}


def _jax_tree(tree):
    return JKVCache(*(J.QuantKV(jnp.asarray(tree[n]["q"]), jnp.asarray(tree[n]["scale"]))
                      for n in ("k", "v")))


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_relayout_quantizes_like_jax(kv_dtype):
    """The contiguous swap: prefill KV into slot 1 of a quantized cache.
    Payload and scale planes are byte-equal to the JAX relayout + slot
    insert (padding rows: payload 0, scale 1.0); the other slots are kept."""
    cfg = reduced_config("bitnet-730m")
    rng = np.random.default_rng(30)
    b, smax, s = 3, 64, 24
    kv = [rng.normal(size=(cfg.num_layers, 1, cfg.num_kv_heads, s, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    kv[0][:, :, :, 5] = 0.0  # all-zero rows inside the prompt too
    tree = _random_quant_tree(rng, (b, cfg.num_layers, cfg.num_kv_heads, smax, cfg.head_dim),
                              kv_dtype)
    jcfg = jcfgs.reduced_config("bitnet-730m")
    jeng = JPhaseEngine(jcfg, max_len=smax, kv_dtype=kv_dtype)
    relayed = jeng.relayout_program(1, s, smax).fn(JKVCache(*(jnp.asarray(a) for a in kv)))
    want = j_insert_prefill_kv(_jax_tree(tree), relayed, 1, s)
    got = PhaseEngine(cfg, kv_dtype=kv_dtype).relayout_program(1, s, smax).fn(
        T.KVCache(*(torch.from_numpy(a) for a in kv)), kv_from_numpy(tree, "cpu"), 1)
    _assert_same_bytes(got, want)
    assert (got.k.scale[1, :, :, s:] == 1.0).all() and (got.k.q[1, :, :, s:] == 0).all()
    # the static swap installs the same bytes
    static = insert_prefill_kv(kv_from_numpy(tree, "cpu"),
                               T.KVCache(*(torch.from_numpy(a) for a in kv)), 1)
    _assert_same_bytes(static, want)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_page_write_like_jax_and_leaves_skipped_pages(kv_dtype):
    """The paged swap: a 4-page prompt bucket whose first page is a
    prefix-cache hit and whose last is padding (both skip id N).  The pool
    after the write is byte-equal to the JAX page write's."""
    cfg = reduced_config("bitnet-730m")
    rng = np.random.default_rng(31)
    n, bs, s = 9, 8, 32
    shape = (n, cfg.num_layers, cfg.num_kv_heads, bs, cfg.head_dim)
    kv = [rng.normal(size=(cfg.num_layers, 1, cfg.num_kv_heads, s, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    if kv_dtype == "fp":
        tree = {k: np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)) for k in "kv"}
        jpool = JKVCache(jnp.asarray(tree["k"]), jnp.asarray(tree["v"]))
    else:
        tree = _random_quant_tree(rng, shape, kv_dtype)
        jpool = _jax_tree(tree)
    ids = np.array([n, 6, 2, n], np.int32)
    jcfg = jcfgs.reduced_config("bitnet-730m")
    want = JPhaseEngine(jcfg, max_len=64, cache_layout="paged", kv_dtype=kv_dtype) \
        .page_write_program(s, bs).fn(jpool, JKVCache(*(jnp.asarray(a) for a in kv)),
                                      jnp.asarray(ids))
    before = kv_from_numpy(tree, "cpu")
    untouched = [t.clone() for t in _planes(before)]
    got = PhaseEngine(cfg, cache_layout="paged", kv_dtype=kv_dtype).page_write_program(s, bs).fn(
        before, T.KVCache(*(torch.from_numpy(a) for a in kv)), torch.from_numpy(ids))
    _assert_same_bytes(got, want)
    keep = [i for i in range(n) if i not in (6, 2)]
    for a, a0 in zip(_planes(got), untouched):
        assert torch.equal(a[keep], a0[keep])


# ------------------------------------------------------------- the engines --


@pytest.fixture(scope="module")
def model():
    cfg_t = reduced_config("bitnet-730m")
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _prompts(shared_prefix: bool):
    rng = np.random.default_rng(12)
    if not shared_prefix:
        return [rng.integers(0, 256, size=n).astype(np.int32) for n in (5, 17, 9, 30)]
    base = rng.integers(0, 256, size=24).astype(np.int32)
    return [rng.integers(0, 256, size=12).astype(np.int32), base.copy(),
            rng.integers(0, 256, size=7).astype(np.int32),
            np.concatenate([base[:16], rng.integers(0, 256, size=5).astype(np.int32)])]


ENGINE_CASES = [
    # (layout, kv_dtype, mode, overlap, num_blocks): the paged cases with a
    # shared 2-page prompt prefix; num_blocks=7 forces preemption
    ("contiguous", "int8", "pdswap", True, None),
    ("contiguous", "int8", "static", True, None),
    ("contiguous", "int4", "pdswap", False, None),
    ("contiguous", "int4", "static", True, None),
    ("paged", "fp", "pdswap", True, None),
    ("paged", "fp", "static", True, None),
    ("paged", "int8", "pdswap", False, None),
    ("paged", "int8", "static", True, None),
    ("paged", "int4", "static", True, 7),
    ("paged", "int4", "pdswap", True, 7),
]


@pytest.mark.parametrize("layout,kv_dtype,mode,overlap,num_blocks", ENGINE_CASES)
def test_engine_greedy_tokens_match_jax(model, layout, kv_dtype, mode, overlap, num_blocks):
    """The port's EngineCore (CPU) emits the JAX EngineCore's greedy tokens
    on each cache layout and KV precision.  Every token the port picks
    first clears its runner-up by more than the model tolerance, so the
    equality is not decided by float noise."""
    cfg_j, params_j, cfg_t, params_t = model
    preempting = num_blocks is not None
    if preempting:  # test_paging's preemption workload: 3 slots, priorities 0..3
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 256, 14).astype(np.int32) for _ in range(4)]
        kw = dict(n_slots=3, max_len=64, prompt_len=12, max_new=10)
    else:
        prompts = _prompts(shared_prefix=layout == "paged")
        kw = dict(n_slots=2, max_len=64, prompt_len=16, max_new=6)
    max_new = kw.pop("max_new")
    kw.update(mode=mode, overlap=overlap, cache_layout=layout, kv_dtype=kv_dtype,
              block_size=8, num_blocks=num_blocks)
    jeng = JEngineCore(cfg_j, params_j, **kw)
    teng = EngineCore(cfg_t, params_t, device="cpu", **kw)
    margins = []

    def record(logits, rows):
        top2 = torch.topk(logits[rows].float(), 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())

    prefill, decode_logits = teng.runner.prefill, teng.runner.decode_logits

    def prefill_rec(req, slot, stats, resuming=False):
        logits = prefill(req, slot, stats, resuming)
        if not resuming:
            record(logits, [0])
        return logits

    def decode_rec(lengths):
        logits = decode_logits(lengths)
        record(logits, sorted(teng.scheduler.inflight))
        return logits

    teng.runner.prefill, teng.runner.decode_logits = prefill_rec, decode_rec
    for i, p in enumerate(prompts):
        prio = i if preempting else 0
        jeng.submit(JRequest(f"r{i}", p, max_new=max_new, priority=prio))
        teng.submit(Request(f"r{i}", p, max_new=max_new, priority=prio))
    jstats = jeng.run()
    stats = teng.run()
    assert min(margins) > MODEL_TOL
    for i in range(len(prompts)):
        rid = f"r{i}"
        assert teng.finished[rid].finish_reason == "length"
        assert teng.finished[rid].out_tokens == jeng.finished[rid].out_tokens, rid
    for name in ("prefix_hits", "prefix_misses", "preemptions", "replayed_tokens",
                 "admission_blocks", "decode_rounds", "decode_tokens", "swaps"):
        assert getattr(stats, name) == getattr(jstats, name), name
    if layout == "paged" and not preempting:
        assert stats.prefix_hits > 0
    if preempting:
        assert stats.preemptions > 0 and stats.replayed_tokens > 0
    assert teng.kv_bytes() == jeng.kv_bytes()


# ------------------------------------------------------- the block pool --


def _pool_invariant(pool):
    assert len(pool.free_list) + len(pool.evictable) + pool.num_live == pool.num_blocks
    for pid in pool.evictable:
        assert pool.meta[pid].refcount == 0 and pool.meta[pid].hash is not None


def test_blockpool_alloc_free_refcount():
    pool = BlockPool(4, 8)
    a, b = pool.alloc(), pool.alloc()
    assert a != b and pool.refcount(a) == pool.refcount(b) == 1
    assert pool.num_free == 2
    pool.incref(a)
    assert pool.refcount(a) == 2
    assert pool.decref(a) == 1
    assert pool.decref(a) == 0  # unregistered: straight back to the free list
    assert pool.num_free == 3 and pool.num_live == 1
    _pool_invariant(pool)
    pool.decref(b)
    assert pool.num_free == 4 and pool.num_live == 0


def test_blockpool_exhaustion_and_copy_on_write():
    pool = BlockPool(3, 8)
    p = pool.alloc()
    assert pool.copy_on_write(p) == (p, False)  # uniquely held: in place
    pool.incref(p)
    new, copied = pool.copy_on_write(p)
    assert copied and new != p
    assert pool.refcount(p) == 1 and pool.refcount(new) == 1 and pool.stats.cow_copies == 1
    pool.alloc()
    with pytest.raises(PoolExhausted):
        pool.alloc()
    _pool_invariant(pool)


def test_blockpool_prefix_hashes_and_lru_eviction():
    pool = BlockPool(2, 4)
    toks = np.arange(8, dtype=np.int32)
    h0 = hash((None, (0, 1, 2, 3)))
    h1 = hash((h0, (4, 5, 6, 7)))
    assert BlockPool.chain_hash(None, toks[:4]) == h0 == JBlockPool.chain_hash(None, toks[:4])
    assert BlockPool.chain_hash(h0, toks[4:]) == h1
    p0, p1 = pool.alloc(), pool.alloc()
    pool.register(h0, p0, toks[:4])
    pool.register(h1, p1, toks[4:])
    assert pool.lookup(h0, (9, 9, 9, 9)) is None  # a collision with other tokens misses
    pool.decref(p0)  # registered: evictable, contents kept
    pool.decref(p1)
    assert pool.num_free == 2 and len(pool.evictable) == 2
    assert pool.lookup(h0, toks[:4]) == p0 and pool.refcount(p0) == 1  # revived
    assert pool.alloc() == p1 and pool.meta[p1].hash is None  # the LRU page is evicted
    assert pool.lookup(h1) is None
    assert pool.evict_all_cached() == 0
    _pool_invariant(pool)


def _paged_pair(n_blocks, bs, n_slots, max_len=32):
    shape = (n_blocks, 2, 2, bs, 8)
    jkv = JKVCache(jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
    tkv = T.KVCache(torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16))
    return (JPagedKVCache(jkv, n_slots=n_slots, max_len=max_len, block_size=bs),
            PagedKVCache(tkv, n_slots=n_slots, max_len=max_len, block_size=bs))


def test_allocate_prompt_sharing_rollback_growth_cow_and_tables():
    _, cache = _paged_pair(6, 4, 3)
    toks = np.arange(10, dtype=np.int32)  # 2 full pages + 1 partial
    m0 = cache.allocate_prompt(0, toks)
    assert len(m0.pages) == 3 and m0.cached_pages == 0
    cache.register_prompt_pages(m0)
    m1 = cache.allocate_prompt(1, toks)
    assert m1.cached_pages == 2 and m1.pages[:2] == m0.pages[:2] and m1.pages[2] != m0.pages[2]
    ids = cache.page_ids_for_write(m1, 4)
    assert ids.tolist() == [6, 6, m1.pages[2], 6]  # hits and padding skip (id N)
    live = cache.pool.num_live
    with pytest.raises(PoolExhausted):  # 3 fresh pages do not fit: full rollback
        cache.allocate_prompt(2, np.full(12, 77, np.int32))
    assert cache.pool.num_live == live and not cache.tables[2]
    arr = cache.block_tables_array()
    assert arr.dtype == torch.int32 and arr.shape == (3, cache.max_pages)
    assert arr[1, :3].tolist() == m1.pages and (arr[2] == 0).all()
    # slot 1 writes into its shared page 1: copy-on-write
    dst, src = cache.ensure_append_page(1, 6)
    assert src == m0.pages[1] and cache.tables[1][1] == dst != src
    assert cache.block_tables_array()[1, 1] == dst  # rebuilt after the change
    cache.release_slot(1)
    assert cache.ensure_append_page(0, 12) is None and len(cache.tables[0]) == 4


def test_paged_cache_decisions_equal_jax_under_random_traffic():
    """The same random admissions, appends and releases on both packages'
    paged caches give the same tables, free lists and counters."""
    rng = np.random.default_rng(40)
    jc, tc = _paged_pair(12, 4, 3, max_len=40)
    base = rng.integers(0, 50, 16)
    lengths = [0, 0, 0]
    for _ in range(120):
        slot = int(rng.integers(3))
        if not tc.tables[slot]:
            n = int(rng.integers(3, 14))
            toks = (base[:n] if rng.random() < 0.5 else rng.integers(0, 50, n)).astype(np.int32)
            results = []
            for c in (jc, tc):
                try:
                    m = c.allocate_prompt(slot, toks)
                    c.register_prompt_pages(m)
                    results.append((m.pages, m.cached_pages))
                except Exception as e:  # noqa: BLE001 — both must raise the same way
                    results.append(type(e).__name__)
            assert results[0] == results[1]
            if isinstance(results[1], tuple):
                lengths[slot] = n
        elif rng.random() < 0.2 or lengths[slot] >= 39:
            jc.release_slot(slot)
            tc.release_slot(slot)
            lengths[slot] = 0
        else:
            results = []
            for c in (jc, tc):
                try:
                    results.append(c.ensure_append_page(slot, lengths[slot]))
                except Exception as e:  # noqa: BLE001
                    results.append(type(e).__name__)
            assert results[0] == results[1]
            if results[1] != "PoolExhausted":
                lengths[slot] += 1
        assert jc.tables == tc.tables
        assert list(jc.pool.free_list) == list(tc.pool.free_list)
        assert list(jc.pool.evictable) == list(tc.pool.evictable)
        assert vars(jc.pool.stats) == vars(tc.pool.stats)
        np.testing.assert_array_equal(tc.block_tables_array().numpy(),
                                      np.asarray(jc.block_tables_array()))


# ----------------------------------------------------------------- the build --


def test_library_hash_follows_the_included_headers(tmp_path):
    """An edited header must rebuild every source that includes it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {name: build.source_digest(name, csrc) for name in build.SOURCES}
    assert "decode_walk.cuh" in [p.name for p in build.sources_of("paged_attention", csrc)]
    header = csrc / "decode_walk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.source_digest(name, csrc) for name in build.SOURCES}
    assert after["decode_attention"] != before["decode_attention"]
    assert after["paged_attention"] != before["paged_attention"]
    assert after["tlmm"] == before["tlmm"]
    assert after["prefill_attention"] == before["prefill_attention"]
    # the walk's own header, which both decode sources launch, rebuilds the
    # decode kernels alone
    for name in ("decode_attention", "paged_attention"):
        assert "paged_walk.cuh" in [p.name for p in build.sources_of(name, csrc)]
    header = csrc / "paged_walk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {name: build.source_digest(name, csrc) for name in build.SOURCES}
    for name in ("decode_attention", "paged_attention"):
        assert again[name] != after[name]
    for name in ("tlmm", "prefill_attention"):
        assert again[name] == after[name]
