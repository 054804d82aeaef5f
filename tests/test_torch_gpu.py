"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips where there is none.  Run them on a machine with a card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import COUNTS, build, reset_counts
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_kernel,
    decode_attention_quant_kernel,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_quant_reference,
    decode_attention_reference,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention_kernel,
    paged_decode_attention_quant_kernel,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_quant_reference,
    paged_decode_attention_reference,
)
from repro_torch.kernels.prefill_attention.ops import prefill_attention_kernel
from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference
from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.models import transformer as T
from repro_torch.quant.act_quant import quantize_activations_int8, quantize_and_fold
from repro_torch.quant.kv_quant import quantize_kv
from repro_torch.core import sampling as S
from repro_torch.core.kv_cache import insert_prefill_kv
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.layers.attention import KVCache, write_prefill_pages_q
from repro_torch.serving import EngineCore, Request, SamplingParams

pytestmark = pytest.mark.gpu

# f32 attention in another summation order than the plain version
ATTN_TOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [128, 1536, 4096])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 1024])
def test_act_quant_kernel_bit_exact(m, k, dtype):
    """x_q and the folded scale bit for bit against the plain version, with
    row scales over four decades, an all-zero row and exact half-way values."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m * 13 + k)
    x = torch.randn((m, k), generator=g, device=dev)
    x *= 10.0 ** (torch.rand((m, 1), generator=g, device=dev) * 4 - 2)
    x = x.to(dtype).float()
    x[0, :] = 0.0
    if m > 1:
        _, s = quantize_activations_int8(x[1:2])
        x[1, 3], x[1, 4] = 0.5 * s[0, 0], -2.5 * s[0, 0]  # exact halves of the row's scale
    x = x.to(dtype)
    beta = torch.tensor(0.037, device=dev)
    x_q, scale = act_quant_kernel(x, beta)
    torch.cuda.synchronize()
    x_r, scale_r = quantize_and_fold(x, beta)
    assert torch.equal(x_q, x_r) and torch.equal(scale, scale_r)
    assert (x_q[0] == 0).all()


@pytest.mark.parametrize("m,k,n",
                         [(m, 4096, 1536) for m in range(1, 9)]
                         + [(1, 1536, 1536), (4, 1536, 4096), (8, 1536, 4096), (3, 256, 100), (9, 256, 100),
                            (16, 1536, 1536), (17, 1536, 1536), (37, 1536, 1536), (200, 1536, 1536),
                            (300, 4096, 1536), (1024, 1536, 1536), (1024, 1536, 4096),
                            (2048, 4096, 1536), (5, 132, 40), (70, 132, 136), (40, 272, 256),
                            (8, 8256, 64)])
def test_tlmm_kernel_bit_exact(m, k, n):
    """M <= 8: the cluster split-K kernel; above, the int8 tensor-core
    kernel, with 64-row tiles (M = 1024, N = 1536) and 128-row tiles
    (M = 1024, N = 4096).  K = 132 leaves a K tail that fills no MMA step,
    N = 40 or 100 a ragged column edge; M = 8 at K = 8256 holds more x_q
    than a split-K block stages and goes to the tensor-core kernel."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    x_q = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    w = torch.randint(0, 256, (k // 4, n), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-2
    y = tlmm_kernel(x_q, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(y, tlmm_reference(x_q, w, scale))


@pytest.mark.parametrize("h,hkv,s,d", [(4, 4, 1, 64), (4, 2, 65, 32), (24, 24, 200, 64),
                                       (2, 1, 130, 128), (24, 24, 256, 64), (24, 24, 2048, 64)])
def test_prefill_attention_kernel(h, hkv, s, d):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s + d)
    b = 2
    # strided (B, S, H, D) -> (B, H, S, D) views, as the attention layer passes them
    q = torch.randn((b, s, h, d), generator=g, device=dev).transpose(1, 2)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).transpose(1, 2)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).transpose(1, 2)
    out = prefill_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    ref = prefill_attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= ATTN_TOL


def _outside(lengths, starts, smax):
    """(B, smax) bool: the positions outside each sequence's [start, length)."""
    pos = torch.arange(smax, device=lengths.device)[None, :]
    lo = torch.zeros_like(lengths) if starts is None else starts
    return (pos < lo[:, None]) | (pos >= lengths[:, None])


def _poisoned(t, outside, gen):
    """``t`` (B, Hkv, S, ...) with the rows of positions ``outside`` (B, S)
    replaced by NaN (floats) or random bytes (payloads)."""
    mask = outside[:, None, :, None] if t.dim() == 4 else outside[:, None, :]
    if t.dtype in (torch.int8, torch.uint8):
        lo, hi = (-128, 128) if t.dtype == torch.int8 else (0, 256)
        junk = torch.randint(lo, hi, t.shape, generator=gen, device=t.device,
                             dtype=torch.int32).to(t.dtype)
    else:
        junk = torch.full_like(t, float("nan"))
    return torch.where(mask, junk, t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (3, 128), (8, 128)])
def test_decode_attention_kernel_on_strided_cache(dtype, g, d):
    """B3 on the last layer slice of two (B, L, Hkv, S, D) caches, so that
    the last slot walked ends where its tensor ends, with S = 300 not a
    multiple of the walk's 16-row pages, NaN in every row outside
    [start, length), with and without window starts."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d)
    b, layers, hkv, smax = 4, 3, 2, 300
    clean = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev).to(dtype)
             for _ in range(2)]
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    lengths = torch.tensor([0, 1, 257, smax], dtype=torch.int32, device=dev)
    for starts in (None, torch.tensor([0, 0, 40, 290], dtype=torch.int32, device=dev)):
        caches = [c.clone() for c in clean]
        for c in caches:  # strided layer slices, never copied
            c[:, layers - 1] = _poisoned(c[:, layers - 1], _outside(lengths, starts, smax), gen)
        k, v = (c[:, layers - 1] for c in caches)
        out, l, m = decode_attention_kernel(q, k, v, lengths, starts)
        torch.cuda.synchronize()
        out_r, l_r, m_r = decode_attention_reference(q, clean[0][:, layers - 1],
                                                     clean[1][:, layers - 1], lengths, starts)
        assert torch.isfinite(out).all() and torch.isfinite(l).all() and torch.isfinite(m).all()
        assert (out - out_r).abs().max().item() <= ATTN_TOL
        assert torch.allclose(l, l_r, rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.allclose(m, m_r, rtol=0, atol=ATTN_TOL)
        assert (out[0] == 0).all() and (l[0] == 0).all() and (m[0] == -1e30).all()


def _assert_stats_close(got, want):
    out, l, m = got
    out_r, l_r, m_r = want
    assert (out - out_r).abs().max().item() <= ATTN_TOL
    assert torch.allclose(l, l_r, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.allclose(m, m_r, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (3, 128), (8, 128)])
def test_decode_attention_quant_kernel_on_strided_cache(kv_dtype, g, d):
    """B4 on the last layer slice of quantized (B, L, Hkv, S, Dp) caches and
    their (B, L, Hkv, S) scale planes (the last slot walked ends where its
    tensor ends; S = 300), random bytes and NaN scales in every row outside
    [start, length), with and without window starts."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d + 1)
    b, layers, hkv, smax = 4, 3, 2, 300
    clean = [t for _ in range(2) for t in
             quantize_kv(torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev), kv_dtype)]
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    lengths = torch.tensor([0, 1, 257, smax], dtype=torch.int32, device=dev)
    for starts in (None, torch.tensor([0, 0, 40, 290], dtype=torch.int32, device=dev)):
        planes = [t.clone() for t in clean]
        for t in planes:
            t[:, layers - 1] = _poisoned(t[:, layers - 1], _outside(lengths, starts, smax), gen)
        kq, ks, vq, vs = (t[:, layers - 1] for t in planes)
        got = decode_attention_quant_kernel(q, kq, ks, vq, vs, lengths, starts, kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in got)
        _assert_stats_close(got, decode_attention_quant_reference(
            q, *(t[:, layers - 1] for t in clean), lengths, starts, kv_dtype=kv_dtype))
        assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and (got[2][0] == -1e30).all()


PAGED_FORMATS = {"bf16": torch.bfloat16, "f32": torch.float32}


def _page_contents(gen, dev, kv_dtype, b, n_pages, hkv, bs, d):
    """Each sequence's pages, dense: the planes [K, V] (B, P, Hkv, bs, Dp),
    then, quantized, their scale planes [K, V] (B, P, Hkv, bs)."""
    x = [torch.randn((b, n_pages, hkv, bs, d), generator=gen, device=dev) for _ in range(2)]
    if kv_dtype in PAGED_FORMATS:
        return [t.to(PAGED_FORMATS[kv_dtype]) for t in x]
    pairs = [quantize_kv(t, kv_dtype) for t in x]
    return [pairs[0][0], pairs[1][0], pairs[0][1], pairs[1][1]]


def _garbage(gen, like, nan):
    """Bits of no meaning shaped as ``like``: NaN (float planes, with
    ``nan``), else random bytes, or random floats in [0.01, 0.03) (of the
    order of a scale, so that a clipped table entry that reads them gives
    values of order 1)."""
    if like.dtype in (torch.int8, torch.uint8):
        lo, hi = (-128, 128) if like.dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, like.shape, generator=gen, device=like.device,
                             dtype=torch.int32).to(like.dtype)
    if nan:
        return torch.full_like(like, float("nan"))
    return (torch.rand(like.shape, generator=gen, device=like.device) * 0.02 + 0.01).to(like.dtype)


def _place(gen, planes, lens, bs, n, nan):
    """A layer-stacked pool of ``n`` pages per plane, (n, 2, ...), whose layer
    1 holds each sequence's live pages under shuffled distinct ids; the
    other pages, layer 0 and the table entries past each sequence's live
    pages hold garbage (table ids from -n to 2n).  Returns the layer-1
    slices, as the engine passes them, and the (B, P) tables."""
    b, p = planes[0].shape[:2]
    dev = planes[0].device
    pools = [_garbage(gen, torch.empty((n, 2) + t.shape[2:], dtype=t.dtype, device=dev), nan)
             for t in planes]
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    tables = torch.randint(-n, 2 * n, (b, p), generator=gen, device=dev, dtype=torch.int32)
    k = 0
    for i, length in enumerate(lens):
        used = -(-length // bs)
        tables[i, :used] = perm[k:k + used]
        for pool, t in zip(pools, planes):
            pool[perm[k:k + used].long(), 1] = t[i, :used]
        k += used
    return [pool[:, 1] for pool in pools], tables


def _paged_walk(kv_dtype, q, pages, tables, lengths, starts, kernel=True):
    if kv_dtype in PAGED_FORMATS:
        fn = paged_decode_attention_kernel if kernel else paged_decode_attention_reference
        return fn(q, *pages, tables, lengths, starts)
    fn = paged_decode_attention_quant_kernel if kernel else paged_decode_attention_quant_reference
    kp, vp, ks, vs = pages
    return fn(q, kp, ks, vp, vs, tables, lengths, starts, kv_dtype=kv_dtype)


def _slot_contents(gen, dev, kv_dtype, b, hkv, smax, d):
    """A layer's contiguous contents: [K, V] (B, Hkv, S, Dp), then, quantized,
    their scale planes [K, V] (B, Hkv, S)."""
    x = [torch.randn((b, hkv, smax, d), generator=gen, device=dev) for _ in range(2)]
    if kv_dtype in PAGED_FORMATS:
        return [t.to(PAGED_FORMATS[kv_dtype]) for t in x]
    pairs = [quantize_kv(t, kv_dtype) for t in x]
    return [pairs[0][0], pairs[1][0], pairs[0][1], pairs[1][1]]


def _slot_walk(kv_dtype, q, planes, lengths, starts, kernel=True, rows_per_slot=1):
    if kv_dtype in PAGED_FORMATS:
        if not kernel:
            return decode_attention_reference(q, *planes, lengths, starts)
        return decode_attention_kernel(q, *planes, lengths, starts, rows_per_slot=rows_per_slot)
    kq, vq, ks, vs = planes
    if not kernel:
        return decode_attention_quant_reference(q, kq, ks, vq, vs, lengths, starts,
                                                kv_dtype=kv_dtype)
    return decode_attention_quant_kernel(q, kq, ks, vq, vs, lengths, starts, kv_dtype=kv_dtype,
                                         rows_per_slot=rows_per_slot)


def _in_cache(gen, planes, batch, layers, layer, smax, every=1, offset=0):
    """``planes`` placed at layer ``layer`` of (batch, layers, Hkv, smax, ·)
    caches holding NaN or random bytes elsewhere, sequence i at batch index
    offset + every * i; returns the strided views the engine would pass."""
    out = []
    for t in planes:
        shape = (batch, layers) + t.shape[1:2] + (smax,) + t.shape[3:]
        cache = _garbage(gen, torch.empty(shape, dtype=t.dtype, device=t.device), nan=True)
        view = cache[offset::every][:t.shape[0], layer]
        view[:, :, :t.shape[2]] = t
        out.append(view)
    return out


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (8, 128)])
def test_decode_attention_kernels_give_the_same_bits_wherever_the_slot_lies(kv_dtype, g, d):
    """B3 (bf16/f32) and B4 (int8/int4): the same rows at another batch
    index, another layer and a larger Smax, with NaN or random bytes in
    every other row (and in the slots' rows outside [start, length)), give
    the same bits."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d + 2)
    b, hkv, smax = 5, 2, 300
    lengths = torch.tensor([0, 1, 150, smax, 233], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 0, 9, 50, 0], dtype=torch.int32, device=dev)
    planes = [_poisoned(t, _outside(lengths, starts, smax), gen)
              for t in _slot_contents(gen, dev, kv_dtype, b, hkv, smax, d)]
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    first = _slot_walk(kv_dtype, q, _in_cache(gen, planes, b, 2, 1, smax), lengths, starts)
    second = _slot_walk(kv_dtype, q, _in_cache(gen, planes, 2 * b + 1, 3, 0, smax + 37, every=2,
                                               offset=1), lengths, starts)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert all(torch.isfinite(t).all() for t in first)


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (8, 128)])
def test_contiguous_and_paged_walks_give_the_same_bits(kv_dtype, g, d):
    """The same rows in a contiguous slot (S = 300, not whole pages) and in
    shuffled 16-row pages of a pool give the same bits: B3 against B5 and
    B4 against B6, one walk split the same way over both."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d + 3)
    b, hkv, smax, bs = 5, 2, 300, 16
    n_pages = -(-smax // bs)
    lengths = torch.tensor([0, 1, 150, smax, 233], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 0, 9, 50, 0], dtype=torch.int32, device=dev)
    planes = _slot_contents(gen, dev, kv_dtype, b, hkv, smax, d)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    slot = _slot_walk(kv_dtype, q, planes, lengths, starts)
    # the slot's rows as (B, P, Hkv, bs, ·) pages, the last one padded
    paged = []
    for t in planes:
        pad = _garbage(gen, torch.empty(t.shape[:2] + (n_pages * bs - smax,) + t.shape[3:],
                                        dtype=t.dtype, device=dev), nan=True)
        full = torch.cat([t, pad], dim=2)
        paged.append(full.reshape(t.shape[:2] + (n_pages, bs) + t.shape[3:]).transpose(1, 2))
    pages, tables = _place(gen, paged, [n_pages * bs] * b, bs, b * n_pages + 7, nan=True)
    pool = _paged_walk(kv_dtype, q, pages, tables, lengths, starts)
    torch.cuda.synchronize()
    for a, c in zip(slot, pool):
        assert torch.equal(a, c)
    assert all(torch.isfinite(t).all() for t in slot)


def test_decode_attention_kernels_refuse_rows_that_are_not_contiguous():
    """B3 and B4 stage a slot's rows in runs: a cache whose position stride
    is not its row length (the prefill layout (B, S, Hkv, D) seen as
    (B, Hkv, S, D)), or scale planes whose position stride is not 1, raise
    before any launch; the C entry point refuses such strides too."""
    dev = _cuda()
    b, hkv, smax, d = 2, 2, 64, 64
    q = torch.randn((b, hkv, 1, d), device=dev)
    lengths = torch.tensor([5, 64], dtype=torch.int32, device=dev)
    k = torch.randn((b, smax, hkv, d), device=dev).transpose(1, 2)
    v = torch.randn((b, hkv, smax, d), device=dev)
    with pytest.raises(ValueError, match="row stride"):
        decode_attention_kernel(q, k, v, lengths)
    with pytest.raises(ValueError, match="row stride"):
        decode_attention_kernel(q, v, k, lengths)
    kq, ks = quantize_kv(v, "int8")
    ks_t = ks.transpose(1, 2).contiguous().transpose(1, 2)  # (B, Hkv, S), position stride Hkv
    with pytest.raises(ValueError, match="row stride"):
        decode_attention_quant_kernel(q, kq, ks_t, kq, ks, lengths, kv_dtype="int8")
    with pytest.raises(ValueError, match="row stride"):
        decode_attention_quant_kernel(q, k.to(torch.int8), ks, kq, ks, lengths, kv_dtype="int8")
    out = torch.empty((b, hkv, 1, d), device=dev)
    l, m = torch.empty((b, hkv, 1), device=dev), torch.empty((b, hkv, 1), device=dev)
    fn = build.function("decode_attention", "decode_attention_launch", decode_ops._ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), None, out.data_ptr(),
            l.data_ptr(), m.data_ptr(), b, hkv, 1, smax, d, 0, *k.stride()[:3], *v.stride()[:3],
            1, 0.125, build.stream_ptr(dev))  # one query row a slot
    assert rc == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()


PAGED_CASES = [(1, 64, 16), (2, 32, 8), (4, 128, 16), (8, 32, 16), (8, 64, 8), (8, 128, 8)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("g,d,bs", PAGED_CASES)
def test_paged_decode_attention_kernels_on_strided_pool(kv_dtype, g, d, bs):
    """B5 (bf16/f32) and B6 (int8/int4) on a layer slice of an (N, L, Hkv,
    bs, ·) pool walked through shuffled tables, against the plain versions:
    lengths 0, 1 and mid-page, one that gives every rank of the cluster
    pages, starts that leave ranks with nothing to walk, table entries
    >= N and negative (clipped), and an all-empty batch."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d + bs)
    b, hkv, n_pages = 6, 2, 24
    cap = n_pages * bs
    n = b * n_pages + 5
    lens = [0, 1, 150, cap, cap - 2 * bs - 3, 37]
    pages, tables = _place(gen, _page_contents(gen, dev, kv_dtype, b, n_pages, hkv, bs, d),
                           lens, bs, n, nan=False)
    tables[2, 1], tables[2, 3] = n + 7, -3  # clipped to N - 1 and 0
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for starts in (None, torch.tensor([0, 0, 140, 3 * bs + 2, cap - 3 * bs - 1, 36],
                                      dtype=torch.int32, device=dev)):
        got = _paged_walk(kv_dtype, q, pages, tables, lengths, starts)
        torch.cuda.synchronize()
        _assert_stats_close(got, _paged_walk(kv_dtype, q, pages, tables, lengths, starts,
                                             kernel=False))
        assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and (got[2][0] == -1e30).all()
    for lengths, starts in ((torch.zeros_like(lengths), None), (lengths, lengths)):
        out, l, m = _paged_walk(kv_dtype, q, pages, tables, lengths, starts)
        torch.cuda.synchronize()
        assert (out == 0).all() and (l == 0).all() and (m == -1e30).all()


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("g,d,bs", [(1, 64, 16), (2, 32, 8), (8, 128, 16)])
def test_paged_decode_attention_kernels_give_the_same_bits_wherever_pages_lie(kv_dtype, g, d, bs):
    """The same contents under a second shuffle of pages, in a pool of
    another size, with NaN or random bytes in unused pages, in the slots of
    live pages outside [start, length) and in table entries past the
    length, give the same bits: the property preemption replay and prefix
    sharing rely on."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d + bs + 1)
    b, hkv, n_pages = 5, 2, 24
    cap = n_pages * bs
    lens = [0, 1, 150, cap, cap - 2 * bs - 3]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 0, 9, 3 * bs + 2, 0], dtype=torch.int32, device=dev)
    planes = _page_contents(gen, dev, kv_dtype, b, n_pages, hkv, bs, d)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    pos = torch.arange(cap, device=dev).reshape(1, n_pages, bs)
    outside = (pos < starts[:, None, None]) | (pos >= lengths[:, None, None])  # (B, P, bs)
    poisoned = []
    for t in planes:
        mask = outside[:, :, None, :, None] if t.dim() == 5 else outside[:, :, None, :]
        poisoned.append(torch.where(mask, _garbage(gen, t, nan=True), t))
    first = _paged_walk(kv_dtype, q, *_place(gen, planes, lens, bs, b * n_pages + 5, nan=False),
                        lengths, starts)
    second = _paged_walk(kv_dtype, q, *_place(gen, poisoned, lens, bs, 3 * b * n_pages + 11,
                                              nan=True), lengths, starts)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert torch.isfinite(first[0]).all()


@pytest.mark.parametrize("layout,kv_dtype,mode,num_blocks",
                         [("contiguous", "int8", "pdswap", None), ("contiguous", "int4", "static", None),
                          ("paged", "fp", "pdswap", None), ("paged", "int8", "static", 7)])
def test_quantized_and_paged_engines_on_cuda_match_cpu(layout, kv_dtype, mode, num_blocks):
    """Each cache option on the card emits the CPU plain path's tokens, and
    the decode rounds (replays included) went through that option's kernel."""
    dev = _cuda()
    cfg = reduced_config("bitnet-730m", num_layers=3)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 14, 14, 14)]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = EngineCore(cfg, params, n_slots=3, max_len=64, prompt_len=16, mode=mode,
                         cache_layout=layout, kv_dtype=kv_dtype, block_size=8,
                         num_blocks=num_blocks, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=10, priority=i))
        reset_counts()
        st = eng.run()
        streams[device] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert streams["cuda"] == streams["cpu"]
    kernel = ("paged_" if layout == "paged" else "") + "decode_attention" + (
        "" if kv_dtype == "fp" else "_quant")
    rounds = st.decode_rounds + st.replayed_tokens
    assert COUNTS[kernel] == cfg.num_layers * rounds
    assert COUNTS["act_quant"] == COUNTS["tlmm"]
    assert sum(COUNTS.values()) - COUNTS[kernel] - 2 * COUNTS["tlmm"] - COUNTS["prefill_attention"] == 0
    if num_blocks is not None:
        assert st.preemptions > 0


@pytest.mark.parametrize("mode,overlap", [("pdswap", True), ("pdswap", False), ("static", True)])
def test_engine_on_cuda_matches_cpu_and_goes_through_the_kernels(mode, overlap):
    dev = _cuda()
    cfg = reduced_config("bitnet-730m", num_layers=3)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 17, 9, 30)]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = EngineCore(cfg, params, n_slots=2, max_len=64, prompt_len=16, mode=mode,
                         overlap=overlap, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=6))
        reset_counts()
        st = eng.run()
        streams[device] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert streams["cuda"] == streams["cpu"]
    assert COUNTS["tlmm"] == 7 * cfg.num_layers * (len(prompts) + st.decode_rounds)
    assert COUNTS["act_quant"] == COUNTS["tlmm"]
    assert COUNTS["prefill_attention"] == cfg.num_layers * len(prompts)
    assert COUNTS["decode_attention"] == cfg.num_layers * st.decode_rounds


def test_sampler_on_cuda_matches_cpu():
    """Keys and random bits on the card bit for bit as on the CPU, and the
    same tokens on 64 seeded rows of vocab 32,256 (greedy and sampled)."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    b, v = 64, 32256
    logits = torch.from_numpy((rng.normal(size=(b, v)) * 3).astype(np.float32))
    temps = torch.from_numpy(np.where(np.arange(b) % 4 == 0, 0.0,
                                      rng.uniform(0.3, 1.5, b)).astype(np.float32))
    top_ks = torch.from_numpy(rng.choice([0, 1, 5, 50, 1000], b).astype(np.int32))
    top_ps = torch.from_numpy(rng.choice([1.0, 0.9, 0.5, 0.95], b).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, b).astype(np.int32))
    steps = torch.from_numpy(rng.integers(0, 3000, b).astype(np.int32))
    key = S.fold_in(S.prng_key(seeds), steps)
    key_gpu = S.fold_in(S.prng_key(seeds.to(dev)), steps.to(dev))
    for a, g in zip(key, key_gpu):
        assert torch.equal(a, g.cpu())
    assert torch.equal(S.random_bits(key, v), S.random_bits(key_gpu, v).cpu())
    args = (logits, seeds, steps, temps, top_ks, top_ps)
    want = S.sample_tokens(*args)
    got = S.sample_tokens(*(a.to(dev) for a in args))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_sampled_chunked_engine_on_cuda_matches_cpu():
    """Sampled requests through chunked prefill on a paged int8 pool small
    enough to preempt: the card's streams equal the CPU's; the chunks and
    the decode rounds went through B1 and B6, and B2 never ran."""
    dev = _cuda()
    cfg = reduced_config("bitnet-730m", num_layers=3)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, 14).astype(np.int32) for _ in range(4)]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = EngineCore(cfg, params, n_slots=3, max_len=64, prompt_len=12, mode="static",
                         cache_layout="paged", kv_dtype="int8", block_size=8, num_blocks=7,
                         prefill_chunk=8, device=device)
        for i, p in enumerate(prompts):
            sp = SamplingParams(temperature=0.8, top_k=64, top_p=0.95, seed=100 + i)
            eng.submit(Request(f"r{i}", p, max_new=10, priority=i, params=sp))
        reset_counts()
        st = eng.run()
        streams[device] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert streams["cuda"] == streams["cpu"]
    assert st.preemptions > 0 and st.prefill_chunks > len(prompts)
    steps = st.prefill_chunks + st.decode_rounds + st.replayed_tokens
    assert COUNTS["tlmm"] == COUNTS["act_quant"] == 7 * cfg.num_layers * steps
    assert COUNTS["paged_decode_attention_quant"] == cfg.num_layers * (
        st.decode_rounds + st.replayed_tokens)
    assert COUNTS["prefill_attention"] == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(tree.packed.to(dev), tree.scale.to(dev))


# ------------------------------------------------ the phase programs as graphs --

GRAPH_CFG = dict(num_layers=3)


def _same(a, b) -> bool:
    """Bit equality of two tensors or two (possibly quantized) cache trees."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.dim() else a,
                                                  b.view(torch.uint8) if b.dim() else b)
    return all(_same(x, y) for x, y in zip(a, b))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


def _graph_model(dev):
    cfg = reduced_config("bitnet-730m", **GRAPH_CFG)
    return cfg, _to(T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg), dev)


def _filled_cache(cfg, layout, kv_dtype, dev, gen):
    """Three slots' worth of random prompt KV (32 positions each) in a
    contiguous cache of 64 rows, or in 12 pages of 8 with the slots' tables."""
    kv = KVCache(*(torch.randn((cfg.num_layers, 1, cfg.num_kv_heads, 32, cfg.head_dim),
                               generator=gen, device=dev) for _ in range(2)))
    if layout == "contiguous":
        cache = T.init_cache(cfg, 3, 64, kv_dtype=kv_dtype, device=dev)
        for slot in range(3):
            insert_prefill_kv(cache, kv, slot)
        return cache, None
    pool = T.init_paged_pool(cfg, 16, 8, kv_dtype=kv_dtype, device=dev)
    tables = torch.tensor([[3, 9, 0, 14, 6, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0],
                           [2, 5, 11, 1, 15, 0, 0, 0]], dtype=torch.int32, device=dev)
    for row in (0, 2):
        ids = tables[row, :4]
        pool = KVCache(*(write_prefill_pages_q(p, a, ids, block_size=8) for p, a in zip(pool, kv)))
    return pool, tables


def _launches_per_replay(prog, n, run):
    """COUNTS after ``n`` replays equal n times the captured delta."""
    reset_counts()
    for i in range(n):
        run(i)
    torch.cuda.synchronize()
    assert COUNTS == {k: n * v for k, v in prog.captured.launches.items()}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_graph_replays_the_eager_program_bit_for_bit(layout, kv_dtype):
    """``decode:{B}x{max_len}`` / ``decode_paged:{B}x{P}``: the capturing
    call, a replay and replays after the inputs change in place give the
    eager program's logits and cache bytes bit for bit (one slot inactive);
    each replay adds the captured launches to COUNTS."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    cache, tables = _filled_cache(cfg, layout, kv_dtype, dev, gen)
    mirror = _clone(cache)
    eng = PhaseEngine(cfg, cache_layout=layout, kv_dtype=kv_dtype)
    prog = (eng.decode_program(3, 64) if layout == "contiguous"
            else eng.paged_decode_program(3, 8))
    tokens = torch.tensor([11, 0, 200], dtype=torch.int32, device=dev)
    lengths = torch.tensor([32, 0, 32], dtype=torch.int32, device=dev)
    extra = () if tables is None else (tables,)

    def step(fn, kv):
        return fn(params, tokens, kv, *extra, lengths)[0].clone()

    for i in range(4):  # the capture, a replay, then replays on new inputs
        got, want = step(prog, cache), step(prog.fn, mirror)
        torch.cuda.synchronize()
        assert _same(got, want) and _same(cache, mirror), f"call {i}"
        tokens.copy_((tokens * 7 + 3) % cfg.vocab_size)
        lengths.add_(torch.tensor([1, 0, 1], dtype=torch.int32, device=dev))
    kernel = ("paged_" if layout == "paged" else "") + "decode_attention" + (
        "" if kv_dtype == "fp" else "_quant")
    per_pass = 7 * cfg.num_layers
    assert {k: v for k, v in prog.captured.launches.items() if v} == {
        "tlmm": per_pass, "act_quant": per_pass, kernel: cfg.num_layers}
    _launches_per_replay(prog, 3, lambda i: prog(params, tokens, cache, *extra, lengths))


def test_sampler_graph_replays_the_eager_program_bit_for_bit():
    """``sampler:{B}``: replays on logits and steps changed in place give
    ``sample_tokens``'s tokens; it launches no kernel of the port."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    b, v = 4, 32256
    logits = torch.randn((b, v), generator=gen, device=dev) * 3
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=dev)
    steps = torch.tensor([0, 5, 9, 100], dtype=torch.int32, device=dev)
    temps = torch.tensor([0.0, 0.8, 1.2, 0.5], device=dev)
    top_ks = torch.tensor([0, 50, 0, 5], dtype=torch.int32, device=dev)
    top_ps = torch.tensor([1.0, 0.9, 0.95, 1.0], device=dev)
    prog = PhaseEngine(reduced_config("bitnet-730m")).sampler_program(b)
    args = (logits, seeds, steps, temps, top_ks, top_ps)
    for i in range(4):
        got = prog(*args).clone()
        want = S.sample_tokens(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"call {i}"
        logits.copy_(torch.randn((b, v), generator=gen, device=dev) * 3)
        steps.add_(1)
    assert not any(prog.captured.launches.values())
    _launches_per_replay(prog, 3, lambda i: prog(*args))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunk_graph_replays_the_eager_program_bit_for_bit(layout, kv_dtype):
    """``prefill_chunk`` / ``prefill_chunk_paged`` with 0-d device scalars:
    the capturing call and replays at other slots, starts, last positions
    and pages give the eager program's logits, cache and mirror bytes bit
    for bit; each replay adds its 7 x L linears' launches to COUNTS."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    cache, _ = _filled_cache(cfg, layout, kv_dtype, dev, gen)
    shape = (cfg.num_layers, 1, cfg.num_kv_heads, 64, cfg.head_dim)
    prefix = KVCache(*(torch.randn(shape, generator=gen, device=dev) for _ in range(2)))
    mirror, prefix_m = _clone(cache), _clone(prefix)
    eng = PhaseEngine(cfg, cache_layout=layout, kv_dtype=kv_dtype)
    prog = (eng.prefill_chunk_program(16, 3, 64, 32) if layout == "contiguous"
            else eng.paged_prefill_chunk_program(16, 8, 8, 32))
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device=dev)
    scalars = torch.zeros((3,), dtype=torch.int32, device=dev)  # slot, prefix_len, last_pos
    ids = torch.zeros((2,), dtype=torch.int32, device=dev)
    # (slot, start, last_pos, page ids): 16 is N, the skip id
    calls = [(1, 16, 15, (7, 16)), (2, 32, 8, (4, 10)), (0, 0, 3, (16, 16)), (1, 32, 15, (8, 12))]
    for i, (slot, start, last, pages) in enumerate(calls):
        scalars.copy_(torch.tensor([slot, start, last], dtype=torch.int32))
        ids.copy_(torch.tensor(pages, dtype=torch.int32))
        tokens.copy_(torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device=dev))
        first = ids if layout == "paged" else scalars[0]
        got = prog(params, tokens, cache, prefix, first, scalars[1], scalars[2])[0].clone()
        want = prog.fn(params, tokens, mirror, prefix_m, first, scalars[1], scalars[2])[0]
        torch.cuda.synchronize()
        assert _same(got, want) and _same(cache, mirror) and _same(prefix, prefix_m), f"call {i}"
    per_pass = 7 * cfg.num_layers
    assert {k: v for k, v in prog.captured.launches.items() if v} == {
        "tlmm": per_pass, "act_quant": per_pass}
    first = ids if layout == "paged" else scalars[0]
    _launches_per_replay(prog, 3, lambda i: prog(params, tokens, cache, prefix, first,
                                                 scalars[1], scalars[2]))


def test_no_collection_inside_a_capture_frees_another_graph():
    """A captured program left in a reference cycle is freed by the
    collector; a collection inside another program's capture would free
    its graph, which CUDA refuses while a stream captures.  Here the
    cycle becomes garbage during the capture, with the collector made to
    run at nearly every allocation: the capture holds."""
    import gc

    from repro_torch.core.phase_engine import PhaseProgram

    dev = _cuda()
    x = torch.arange(8.0, device=dev)
    old = PhaseProgram("old", lambda t: t + 1, capturable=True)
    old(x)
    cycle = [old]
    cycle.append(cycle)
    del old
    calls = []

    def fn(t):  # the second call is the capture: the cycle's last reference goes there
        nonlocal cycle
        calls.append(1)
        if len(calls) == 2:
            cycle = None
        return (t * 2).sum(dim=0, keepdim=True)

    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        prog = PhaseProgram("p", fn, capturable=True)
        prog(x)
        got = prog(x).clone()
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert len(calls) == 2 and prog.captured is not None and got.item() == 56.0


@pytest.mark.parametrize("layout,chunk", [("contiguous", None), ("paged", 8)])
def test_serving_grid_on_cuda_captures_and_serves_the_cpu_tokens(layout, chunk):
    """``build_serving_grid`` captures every capturable program; the engine
    then serves the CPU's tokens (sampled and greedy), its launches those of
    the stats."""
    dev = _cuda()
    cfg, params_gpu = _graph_model(dev)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 30, 9, 21)]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = EngineCore(cfg, params, n_slots=3, max_len=64, prompt_len=16, block_size=8,
                         cache_layout=layout, kv_dtype="int8", prefill_chunk=chunk, device=device)
        eng.build_serving_grid()
        if device == "cuda":
            progs = eng.runner.engine.programs
            assert all(p.captured is not None for p in progs.values() if p.capturable)
            assert {k.split(":")[0] for k, p in progs.items() if p.capturable} >= {
                "sampler", "decode_paged" if layout == "paged" else "decode"}
        for i, p in enumerate(prompts):
            sp = SamplingParams(temperature=0.8, top_k=50, seed=i) if i % 2 else SamplingParams()
            eng.submit(Request(f"r{i}", p, max_new=8, params=sp))
        reset_counts()
        st = eng.run()
        streams[device] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert streams["cuda"] == streams["cpu"]
    passes = st.prefill_chunks + st.decode_rounds + st.replayed_tokens + (
        0 if chunk else len(prompts))
    assert COUNTS["tlmm"] == COUNTS["act_quant"] == 7 * cfg.num_layers * passes


def test_graph_results_outlive_other_graphs_replays():
    """Two programs share one pool, the second captured after the first
    and free to take the first's scratch there.  A replay of either leaves
    the other's last results intact, in both orders: what a graph returns
    lies outside the shared pool."""
    from repro_torch.core.phase_engine import GraphResources, PhaseProgram

    dev = _cuda()
    shared = GraphResources()

    def scratchy(x):  # two (n,) intermediates, freed at the end of its capture
        t = x + 1
        u = t * 2
        return (u - t).sum(dim=0, keepdim=True)

    first = PhaseProgram("first", scratchy, capturable=True, graphs=shared)
    second = PhaseProgram("second", lambda y: y * 5, capturable=True, graphs=shared)
    n = 1 << 20
    x = torch.ones(n, device=dev)
    y = torch.full((n,), 3.0, device=dev)
    first(x)
    second(y)  # both captured
    for order in ("second, first", "first, second"):
        if order == "second, first":
            b = second(y)
            a = first(x)
        else:
            a = first(x)
            b = second(y)
        torch.cuda.synchronize()
        assert a.tolist() == [2.0 * n] and bool((b == 15.0).all()), order


def test_quickstart_on_cuda_holds_the_cpu_port_logits():
    """The quickstart's greedy decode on the card (latent weights: act_quant
    with a unit scale, TLMM, beta after, in a captured decode graph): each
    step's logits lie within ``LOGIT_TOL`` of the CPU port's on the card's
    tokens, and the quickstart's own check passes.  Prints where the card's
    tokens part from the JAX quickstart's and both sides' margins there."""
    from repro_torch.examples import quickstart as Q

    dev = _cuda()
    cfg = Q.quickstart_config()
    card, cpu = [], []
    quiet = lambda *a: None  # noqa: E731
    toks = Q.run(Q.init_like_jax(cfg, 0, dev), cfg, device=dev, overlap=True, log=quiet,
                 logits_out=card)
    want = Q.run(Q.init_like_jax(cfg, 0, "cpu"), cfg, device=torch.device("cpu"),
                 overlap=True, log=quiet, feed=toks, logits_out=cpu)
    errs = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
    part = Q.parting(toks, card)
    where = "none" if part is None else (
        f"step {part[0]}: card margin {part[1]:.6f}, CPU margin "
        f"{float(cpu[part[0]][Q.JAX_QUICKSTART_TOKENS[part[0]]] - cpu[part[0]][toks[part[0]]]):.6f}")
    print(f"quickstart on the card: tokens {toks}, the CPU port's on them {want}; logits "
          f"max abs error a step {['%.3g' % e for e in errs]}; parting from the JAX "
          f"quickstart's tokens: {where}")
    assert max(errs) <= Q.LOGIT_TOL
    assert Q.main([]) == 0


# ------------------------------------------------------ speculative decoding --

VERIFY_W = 5  # k + 1 block rows a slot, k = 4


@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 4096), (4096, 1536)])
def test_tlmm_kernel_bit_exact_at_verify_rows(k, n):
    """B1 at the verify pass's M = n_slots x (k + 1) = 20 rows (the
    tensor-core branch), each linear's K x N, bit for bit."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(k + n)
    x_q = torch.randint(-127, 128, (20, k), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    w = torch.randint(0, 256, (k // 4, n), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    scale = torch.rand((20, 1), generator=g, device=dev) * 1e-2
    y = tlmm_kernel(x_q, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(y, tlmm_reference(x_q, w, scale))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_decode_walks_take_a_verify_block_in_one_launch(kv_dtype):
    """B3/B4 with ``rows_per_slot`` W: row b reads slot b // W over its own
    length, giving the bits of the same walk over a cache with each slot
    repeated W times, and of B5/B6 over the slot's rows as 16-row pages
    with each table row repeated; the plain version within ATTN_TOL."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(21)
    b, hkv, smax, d, w = 4, 4, 256, 64, VERIFY_W
    planes = _slot_contents(gen, dev, kv_dtype, b, hkv, smax, d)
    q = torch.randn((b * w, hkv, 1, d), generator=gen, device=dev)
    base = torch.tensor([9, 100, 0, 250], dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(w, device=dev, dtype=torch.int32)).reshape(-1)
    lengths = lengths.clamp(max=smax).to(torch.int32)
    got = _slot_walk(kv_dtype, q, planes, lengths, None, rows_per_slot=w)
    repeated = [t.repeat_interleave(w, 0) for t in planes]
    assert all(torch.equal(x, y) for x, y in zip(got, _slot_walk(kv_dtype, q, repeated, lengths,
                                                                  None)))
    pages = [t.reshape(b, hkv, smax // 16, 16, *t.shape[3:]).transpose(1, 2)
             .reshape(b * smax // 16, hkv, 16, *t.shape[3:]).contiguous() for t in planes]
    tables = torch.arange(b * smax // 16, dtype=torch.int32, device=dev).reshape(b, -1)
    tables = tables.repeat_interleave(w, 0)
    assert all(torch.equal(x, y) for x, y in zip(got, _paged_walk(kv_dtype, q, pages, tables,
                                                                   lengths, None)))
    want = _slot_walk(kv_dtype, q, repeated, lengths, None, kernel=False)
    _assert_stats_close(got, want)


def _verify_inputs(cfg, layout, kv_dtype, dev, gen):
    cache, tables = _filled_cache(cfg, layout, kv_dtype, dev, gen)
    tokens = torch.randint(0, cfg.vocab_size, (3, VERIFY_W), generator=gen, device=dev,
                           dtype=torch.int32)
    lengths = torch.tensor([32, 0, 30], dtype=torch.int32, device=dev)
    n_tokens = torch.tensor([VERIFY_W, 0, 2], dtype=torch.int32, device=dev)
    return cache, tables, tokens, lengths, n_tokens


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_graph_replays_the_eager_program_bit_for_bit(layout, kv_dtype):
    """``verify:{B}x{W}@{max_len}`` / ``verify_paged:{B}x{W}@{P}``: the
    capturing call, a replay and replays after the inputs change in place
    (tokens, lengths, draft depths) give the eager program's logits and
    cache bytes bit for bit; a replay adds the captured launches: B1 and
    act-quant 7 a layer, the option's walk one a layer over all B x W rows."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    cache, tables, tokens, lengths, n_tokens = _verify_inputs(cfg, layout, kv_dtype, dev, gen)
    mirror = _clone(cache)
    eng = PhaseEngine(cfg, cache_layout=layout, kv_dtype=kv_dtype)
    prog = (eng.verify_program(3, 64, VERIFY_W) if layout == "contiguous"
            else eng.paged_verify_program(3, 8, VERIFY_W))
    extra = () if tables is None else (tables,)

    def step(fn, kv):
        return fn(params, tokens, kv, *extra, lengths, n_tokens)[0].clone()

    for i in range(4):
        got, want = step(prog, cache), step(prog.fn, mirror)
        torch.cuda.synchronize()
        assert got.shape == (3, VERIFY_W, cfg.padded_vocab())
        assert _same(got, want) and _same(cache, mirror), f"call {i}"
        tokens.copy_((tokens * 7 + 3) % cfg.vocab_size)
        # other lengths and depths, every block inside its slot's pages
        lengths.sub_(torch.tensor([3, 0, 2], dtype=torch.int32, device=dev))
        n_tokens.copy_(torch.tensor([2, 0, VERIFY_W - i], dtype=torch.int32, device=dev))
    kernel = ("paged_" if layout == "paged" else "") + "decode_attention" + (
        "" if kv_dtype == "fp" else "_quant")
    per_pass = 7 * cfg.num_layers
    assert {k: v for k, v in prog.captured.launches.items() if v} == {
        "tlmm": per_pass, "act_quant": per_pass, kernel: cfg.num_layers}
    _launches_per_replay(prog, 2, lambda i: prog(params, tokens, cache, *extra, lengths, n_tokens))


def _tree_to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*(_tree_to(x, dev) for x in tree))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_on_cuda_holds_the_cpu_port_and_its_decode_steps(layout, kv_dtype):
    """A verify pass on the card: its logits within the decode tolerance
    (1e-3 of the largest logit) of the CPU port's on the same weights, cache
    and tokens; and against W decode steps on the card teacher-forcing the
    block's tokens (every row real), the same cache bytes and each row's
    logits within that tolerance (the logits product runs at M = B x W,
    not B)."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    gen = torch.Generator(device=dev).manual_seed(8)
    cache, tables, tokens, lengths, n_tokens = _verify_inputs(cfg, layout, kv_dtype, dev, gen)
    start = _clone(cache)
    extra = () if tables is None else (tables,)
    fn = T.verify_paged if layout == "paged" else T.verify
    got = fn(params, tokens, cache, *extra, lengths, n_tokens, cfg)[0]
    want = fn(params_cpu, tokens.cpu(), _tree_to(start, "cpu"), *(t.cpu() for t in extra),
              lengths.cpu(), n_tokens.cpu(), cfg)[0]
    tol = 1e-3 * max(want.abs().max().item(), 1.0)
    for b in range(3):
        for i in range(int(n_tokens[b])):
            assert (got[b, i].cpu() - want[b, i]).abs().max().item() <= tol, (b, i)
    # every row real; paged, slot 1 gets pages of its own (4 and 7 are free)
    lengths = torch.tensor([32, 9, 30], dtype=torch.int32, device=dev)
    if tables is not None:
        extra = (tables.clone(),)
        extra[0][1] = torch.tensor([4, 7, 8, 10, 12, 13, 0, 0], dtype=torch.int32)
    mine, steps = _clone(start), _clone(start)
    logits = fn(params, tokens, mine, *extra, lengths, torch.full_like(n_tokens, VERIFY_W), cfg)[0]
    step_fn = T.decode_step_paged if layout == "paged" else T.decode_step
    seq = [step_fn(params, tokens[:, i], steps, *extra, lengths + i, cfg)[0]
           for i in range(VERIFY_W)]
    torch.cuda.synchronize()
    assert _same(mine, steps)
    assert (logits - torch.stack(seq, 1)).abs().max().item() <= tol


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_engine_on_cuda_gives_the_plain_engines_tokens(layout):
    """A greedy int8 engine with ``spec_decode=4`` on the card, its grid
    (the verify program and the block sampler among the graphs) built
    first, against the same engine without speculation: the same tokens,
    or streams parting only at a near tie (the two tokens' logits within
    ``chip_smoke.TIE_TOL`` on both sides; the logits product runs at M = 20
    on a verify round, 4 on a decode round)."""
    import chip_smoke as C

    dev = _cuda()
    cfg, params = _graph_model(dev)
    rng = np.random.default_rng(9)
    pattern = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.tile(pattern, n // 16) for n in (64, 96)] + [
        rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 70)]
    streams, recorders = {}, {}
    for spec in (None, 4):
        eng = EngineCore(cfg, params, n_slots=3, max_len=192, block_size=16, cache_layout=layout,
                         kv_dtype="int8", spec_decode=spec, device=dev)
        eng.build_serving_grid()
        progs = eng.runner.engine.programs
        assert all(p.captured is not None for p in progs.values() if p.capturable)
        recorders[spec] = C.TargetRecorder(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=24))
        st = eng.run()
        streams[spec] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert f"block_sampler:3x{VERIFY_W}" in progs
    assert st.verify_rounds > 0 and st.accepted_tokens > 0
    C.check_near_ties(torch, f"{layout} spec against plain", streams[4], streams[None],
                      recorders[4], recorders[None], lambda rid: SamplingParams())


# ------------------------------------------------------ the front end on the card --


def _grid_engine(cfg, params, layout, chunk):
    eng = EngineCore(cfg, params, n_slots=3, max_len=64, prompt_len=16, block_size=8,
                     cache_layout=layout, kv_dtype="int8", prefill_chunk=chunk, device="cuda")
    eng.build_serving_grid()  # on this thread, before any other thread runs
    return eng


@pytest.mark.parametrize("layout,chunk", [("contiguous", None), ("paged", 8)])
def test_async_engine_on_cuda_gives_the_sync_engines_tokens(layout, chunk):
    """``AsyncEngine`` steps the engine on its worker thread, replaying the
    graphs captured on this one: the streams (two tenants, one sampled) are
    the synchronous engine's, and the launches those the stats imply."""
    import asyncio

    from repro_torch.serving import AsyncEngine

    dev = _cuda()
    cfg, params = _graph_model(dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 30, 9, 21, 17)]
    sps = [SamplingParams(temperature=0.8, top_k=50, seed=i) if i == 3 else SamplingParams()
           for i in range(len(prompts))]
    sync = _grid_engine(cfg, params, layout, chunk)
    for i, p in enumerate(prompts):
        sync.submit(Request(f"r{i}", p, max_new=8, params=sps[i]))
    sync.run()
    want = {r: q.out_tokens for r, q in sync.finished.items()}

    core = _grid_engine(cfg, params, layout, chunk)
    reset_counts()

    async def go():
        got = {}
        async with AsyncEngine(core) as eng:
            streams = {f"r{i}": await eng.submit(p, sps[i], request_id=f"r{i}", max_new=8,
                                                 tenant="ab"[i % 2], weight=1.0 + 2 * (i % 2))
                       for i, p in enumerate(prompts)}
            for rid, stream in streams.items():
                got[rid] = [t async for out in stream for t in out.new_token_ids]
        return got

    assert asyncio.run(go()) == want
    st = core.stats
    passes = st.prefill_chunks + st.decode_rounds + (0 if chunk else len(prompts))
    assert COUNTS["tlmm"] == COUNTS["act_quant"] == 7 * cfg.num_layers * passes


def test_tracer_on_leaves_graph_launches_unchanged():
    """The same requests with the tracer off and on, on one grid-built
    engine: the same tokens and the same kernel launches, and the trace
    finishes each request once."""
    from repro_torch.obs.trace import TRACER

    dev = _cuda()
    cfg, params = _graph_model(dev)
    eng = _grid_engine(cfg, params, "paged", 8)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 30, 9)]
    runs = []
    for on in (False, True):
        if on:
            TRACER.enable()
        try:
            for i, p in enumerate(prompts):
                eng.submit(Request(f"t{int(on)}.{i}", p, max_new=8))
            reset_counts()
            eng.run()
            launches = dict(COUNTS)
            trace = TRACER.chrome_trace()
        finally:
            TRACER.disable()
            TRACER.clear()
        runs.append(([eng.finished[f"t{int(on)}.{i}"].out_tokens for i in range(3)], launches))
    assert runs[0] == runs[1]
    fins = [e["args"]["request_id"] for e in trace["traceEvents"] if e["name"] == "req.finish"]
    assert sorted(fins) == [f"t1.{i}" for i in range(3)]


# ------------------------------------------- the disaggregated pools on the card --


def _disagg_pair(cfg, params, layout, chunk, kv_dtype):
    """A grid-built DisaggEngine and a grid-built EngineCore of one config."""
    from repro_torch.serving import DisaggEngine

    kw = dict(n_slots=3, max_len=64, prompt_len=16, block_size=8, cache_layout=layout,
              kv_dtype=kv_dtype, prefill_chunk=chunk, device="cuda")
    engines = (DisaggEngine(cfg, params, **kw), EngineCore(cfg, params, **kw))
    for eng in engines:
        eng.build_serving_grid()  # on this thread, before the pool's thread runs
    return engines


@pytest.mark.parametrize("layout,chunk,kv_dtype", [("paged", 8, "int8"),
                                                   ("contiguous", None, "fp")])
def test_disagg_on_cuda_gives_the_colocated_tokens(layout, chunk, kv_dtype):
    """Chunked paged int8 and monolithic contiguous bf16 on the card: the
    two pools serve the colocated engine's tokens (one sampled stream), the
    launches are those the stats imply (the pool thread's B1 included), and
    every shipped segment is installed."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 44, 9, 21)]
    sps = [SamplingParams(temperature=0.8, top_k=50, seed=i) if i == 1 else SamplingParams()
           for i in range(len(prompts))]
    disagg, colo = _disagg_pair(cfg, params, layout, chunk, kv_dtype)
    streams, launches = [], []
    for eng in (disagg, colo):
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=8, params=sps[i]))
        reset_counts()
        st = eng.run()
        torch.cuda.synchronize()
        streams.append({r: q.out_tokens for r, q in eng.finished.items()})
        launches.append(dict(COUNTS))
    assert streams[0] == streams[1]
    st = disagg.stats
    prefills = 0 if chunk else len(prompts)
    passes = st.prefill_chunks + st.decode_rounds + prefills
    assert launches[0]["tlmm"] == launches[0]["act_quant"] == 7 * cfg.num_layers * passes
    assert launches[0]["prefill_attention"] == cfg.num_layers * prefills
    walk = "paged_decode_attention_quant" if layout == "paged" else "decode_attention"
    assert launches[0][walk] == cfg.num_layers * st.decode_rounds
    ho = disagg.snapshot()["disagg"]["handoff"]
    assert ho["pending"] == ho["discarded"] == 0 and ho["installs"] == (
        ho["segments"] if chunk else 0)
    assert ho["segments"] == (st.prefill_chunks if chunk else len(prompts))


def test_disagg_decode_round_completes_while_a_chunk_computes():
    """A decode round dispatched while a chunk computes on the prefill
    pool's stream (held there behind a long spin) completes before the
    chunk does: the round carries no dependency on the prefill in flight."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    disagg, colo = _disagg_pair(cfg, params, "paged", 8, "int8")
    short, long_ = np.arange(8, dtype=np.int32) + 3, np.arange(24, dtype=np.int32) % 50 + 7
    for eng in (disagg, colo):
        eng.submit(Request("a", short, max_new=12))
        while eng.scheduler.queue or eng._prefilling:
            eng.step()
    pool = disagg.prefill_pool
    pool.submit(lambda: torch.cuda._sleep(int(1e9))).result()  # about half a second busy
    disagg.submit(Request("b", long_, max_new=4))
    before = len(disagg.scheduler.inflight[0].out_tokens)
    disagg.step()  # b's first chunk (queued behind the spin) and a decode round of a
    assert len(disagg.scheduler.inflight[0].out_tokens) == before + 1
    assert not pool.stream.query(), "the chunk finished before the decode round returned"
    assert disagg.handoff.pending == 1
    disagg.run()
    colo.submit(Request("b", long_, max_new=4))
    colo.run()
    assert {r: q.out_tokens for r, q in disagg.finished.items()} == {
        r: q.out_tokens for r, q in colo.finished.items()}


def test_one_pools_graph_is_not_disturbed_by_the_other_pools_replays():
    """Each pool has its own graph memory pool.  The prefill pool's chunk
    graph and the decode pool's decode graph, replayed in turns and at once
    on their two streams, give the bits of their first replays."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    disagg, _ = _disagg_pair(cfg, params, "contiguous", 8, "fp")
    pool, runner = disagg.prefill_pool, disagg.runner
    assert pool.engine._graphs.pool != runner.engine._graphs.pool
    prog = pool.chunk_kv_prog(8, 0)
    assert prog.captured is not None and runner.decode_prog.captured is not None
    tokens = torch.arange(8, device=dev).reshape(1, 8) + 11
    lengths = runner.slots.lengths_array({0: 5, 1: 5, 2: 5})

    def chunk():
        with pool.on_stream():
            logits, kv, _ = prog(params, tokens, pool.chunk_prefix, pool._scalars.dev[0],
                                 pool._scalars.dev[1])
            out = (logits.clone(), _clone(kv))
        pool.stream.synchronize()
        return out

    def decode():
        out = runner.decode_logits(lengths).clone()
        torch.cuda.current_stream().synchronize()
        return out

    first_chunk, first_decode = chunk(), decode()
    for _ in range(3):
        with pool.on_stream():  # the chunk on the pool's stream while decode replays
            prog(params, tokens, pool.chunk_prefix, pool._scalars.dev[0], pool._scalars.dev[1])
        runner.decode_logits(lengths)
        torch.cuda.synchronize()
        assert _same(decode(), first_decode)
        assert _same(chunk(), first_chunk)


def test_shipped_chunk_kv_survives_the_next_replay_until_installed():
    """A 48-token prompt in chunks of 8: the chunks at 24 and 32 both run
    ``prefill_chunk_kv:8+32``, so the second replays the graph whose
    output buffers the first shipped.  Each eager segment still holds, when
    its install runs, the bytes it held when shipped (it was copied out of
    the graph's buffers), and the tokens are the colocated engine's."""
    dev = _cuda()
    cfg, params = _graph_model(dev)
    disagg, colo = _disagg_pair(cfg, params, "contiguous", 8, "int8")
    runner = disagg.runner
    assert runner.prefix_width(24) == runner.prefix_width(32) == 32
    handoff, kept = disagg.handoff, []
    ship = handoff.ship

    def recording_ship(kv, *, eager=False, consumer=None):
        seg = ship(kv, eager=eager, consumer=consumer)
        if eager:  # on the pool's thread and stream, ordered after the chunk
            kept.append((seg, _clone(kv)))
        return seg

    handoff.ship = recording_ship
    installs = []
    drain = handoff.drain

    def checking_drain(slot=None):
        torch.cuda.synchronize()
        installs.append(all(_same(seg.kv, snap) for seg, snap in kept))
        return drain(slot)

    handoff.drain = checking_drain
    prompt = np.arange(48, dtype=np.int32) * 7 % 256
    for eng in (disagg, colo):
        eng.submit(Request("r", prompt, max_new=6))
        eng.run()
    assert len(kept) == 5 and installs == [True]
    assert disagg.finished["r"].out_tokens == colo.finished["r"].out_tokens


# ------------------------------------------------ the transformer family --


@pytest.mark.parametrize("g,d", [(5, 128), (3, 64)])
def test_prefill_and_walks_at_the_family_serving_shapes(g, d):
    """B2 and the four walks at qwen2.5-14b's (G = 5, D = 128) and
    granite's (G = 3, D = 64) heads over 8 KV heads, at phase 3's shapes:
    B2 at S = 256 and 2048; B3/B4 int8 on a layer slice of a (4, L, 8,
    2048, D) cache, B5/B6 int8 on 512 pages of 16 through shuffled tables,
    lengths 0 / 517 / 1300 / 2048; each against its plain version."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d)
    hkv = 8
    for s in (256, 2048):
        q = torch.randn((1, hkv * g, s, d), generator=gen, device=dev)
        k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev) for _ in range(2))
        out = prefill_attention_kernel(q, k, v)
        torch.cuda.synchronize()
        assert (out - prefill_attention_reference(q, k, v)).abs().max().item() <= ATTN_TOL
    b, layers, smax, bs, n = 4, 4, 2048, 16, 512
    lengths = torch.tensor([0, 517, 1300, 2048], dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    tables = perm[:b * smax // bs].reshape(b, smax // bs).contiguous()
    slot = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev) for _ in range(2)]
    pool = [torch.randn((n, layers, hkv, bs, d), generator=gen, device=dev) for _ in range(2)]
    for kernel, ref, planes, extra in (
            (decode_attention_kernel, decode_attention_reference,
             [t.to(torch.bfloat16)[:, 2] for t in slot], ()),
            (paged_decode_attention_kernel, paged_decode_attention_reference,
             [t.to(torch.bfloat16)[:, 2] for t in pool], (tables,))):
        _assert_stats_close(kernel(q, *planes, *extra, lengths),
                            ref(q, *planes, *extra, lengths))
    for kernel, ref, planes, extra in (
            (decode_attention_quant_kernel, decode_attention_quant_reference, slot, ()),
            (paged_decode_attention_quant_kernel, paged_decode_attention_quant_reference, pool,
             (tables,))):
        (kq, ks), (vq, vs) = (quantize_kv(t[:, 2].contiguous(), "int8") for t in planes)
        args = (q, kq, ks, vq, vs, *extra, lengths)
        _assert_stats_close(kernel(*args, kv_dtype="int8"), ref(*args, kv_dtype="int8"))


def _moe_case(seed):
    """A granite MoE layer at reduced width (8 experts, top-2) on the CPU,
    its router biased towards expert 0 so that assignments drop."""
    from repro_torch.layers.moe import moe_init

    cfg = reduced_config("granite-moe-3b-a800m", d_model=256, num_experts=8, moe_d_ff=128)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    p = moe_init(cfg, gen, "cpu")
    p["router"][:, 0] += 0.2
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    return cfg, p, x


def test_moe_on_cuda_holds_its_cpu_run_with_drops_and_no_host_sync():
    """``moe_apply`` on the card against its CPU run (f32, TF32 off): the
    same routing (dropped assignments included) and outputs within 1e-4;
    ``moe_forward`` issues no host synchronization (the counts are a
    scatter, nothing is read back)."""
    from repro_torch.layers import moe as M

    dev = _cuda()
    cfg, p, x = _moe_case(0)
    pc = {k: t.to(dev) for k, t in p.items()}
    gl = x.reshape(-1, cfg.d_model) @ p["router"]
    cap = max(8, int(gl.shape[0] * cfg.top_k / cfg.num_experts * 1.25))
    want = M._route(gl, cfg.top_k, cap, cfg.num_experts)
    got = M._route(gl.to(dev), cfg.top_k, cap, cfg.num_experts)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert (want[1] == cfg.num_experts * cap).any()  # some assignments dropped
    y, aux = M.moe_apply(pc, x.to(dev), cfg)
    y_r, aux_r = M.moe_apply(p, x, cfg)
    assert (y.cpu() - y_r).abs().max().item() <= 1e-4
    assert abs(float(aux) - float(aux_r)) <= 1e-5
    xb = x.to(dev, torch.bfloat16)
    pb = {k: (t if k == "router" else t.to(torch.bfloat16)) for k, t in pc.items()}
    M.moe_forward(pb, xb, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        M.moe_forward(pb, xb, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_moe_decode_graph_replays_the_eager_program_bit_for_bit():
    """The decode program of a reduced granite-moe-3b-a800m on bf16
    weights: the capturing call, a replay and replays on changed inputs
    give the eager program's logits and cache bytes bit for bit (one slot
    inactive), so the combine is deterministic; B3 a layer a replay."""
    dev = _cuda()
    cfg = reduced_config("granite-moe-3b-a800m", vocab_size=512)
    params = T.init(cfg, 5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    cache, _ = _filled_cache(cfg, "contiguous", "fp", dev, gen)
    mirror = _clone(cache)
    prog = PhaseEngine(cfg).decode_program(3, 64)
    tokens = torch.tensor([11, 0, 200], dtype=torch.int32, device=dev)
    lengths = torch.tensor([32, 0, 32], dtype=torch.int32, device=dev)
    for i in range(4):
        got = prog(params, tokens, cache, lengths)[0].clone()
        want = prog.fn(params, tokens, mirror, lengths)[0].clone()
        torch.cuda.synchronize()
        assert _same(got, want) and _same(cache, mirror), f"call {i}"
        tokens.copy_((tokens * 7 + 3) % cfg.vocab_size)
        lengths.add_(torch.tensor([1, 0, 1], dtype=torch.int32, device=dev))
    assert {k: v for k, v in prog.captured.launches.items() if v} == {
        "decode_attention": cfg.num_layers}
    _launches_per_replay(prog, 3, lambda i: prog(params, tokens, cache, lengths))


# ---------------------------------------------------- the other families --


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_hymba_decode_on_cuda_holds_its_cpu_run():
    """A reduced hymba (window 32, layer 0 global) on f32 weights: a
    48-token prefill, the swap into the decode cache and 8 greedy decode
    steps on the card against the same run on the CPU (logits within 1e-4
    of max |logit|, the CPU's tokens fed to both); B3 runs a layer a step,
    with starts past 0 on the windowed layer, and no B2 (every layer takes
    the windowed plain path)."""
    from repro_torch.models import hymba as H
    from repro_torch.models.jax_init import init_like_jax

    dev = _cuda()
    cfg = reduced_config("hymba-1.5b")
    p_cpu = init_like_jax(cfg, 2, "cpu")
    p_gpu = _to_dev(p_cpu, dev)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 48))).long()
    reset_counts()
    runs = []
    for d, params in (("cpu", p_cpu), (dev, p_gpu)):
        lg, pre = H.forward_prefill(params, tokens.to(d), cfg)
        cache = H.install_prefill(H.init_cache(cfg, 2, 64, dtype=torch.float32, device=d), pre)
        runs.append([lg.cpu()])
        for t in range(8):
            tok = runs[0][t].argmax(-1)
            lengths = torch.full((2,), 48 + t, dtype=torch.int32, device=d)
            lg, cache = H.decode_step(params, tok.to(d), cache, lengths, cfg)
            runs[-1].append(lg.cpu())
    torch.cuda.synchronize()
    for t, (a, b) in enumerate(zip(*runs)):
        scale = a.abs().max().item()
        assert (b - a).abs().max().item() <= 1e-4 * scale, f"step {t}"
    assert COUNTS["decode_attention"] == 8 * cfg.num_layers
    assert COUNTS["prefill_attention"] == 0


def test_whisper_cross_walk_over_a_padded_cache_equals_its_plain_version():
    """The cross walk of whisper's decode: B3 at G = 1, D = 64 over the
    first 1,500 rows of a 1,536-row layer slice of the batch-leading cross
    cache, NaN in the pad rows it must not read, against the plain version
    over the 1,500 rows."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(15)
    b, layers, hkv, rows, d, enc = 4, 3, 20, 1536, 64, 1500
    cache = [torch.randn((b, layers, hkv, rows, d), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2)]
    for t in cache:
        t[:, :, :, enc:] = float("nan")
    q = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    lengths = torch.full((b,), enc, dtype=torch.int32, device=dev)
    got = decode_attention_kernel(q, cache[0][:, 1], cache[1][:, 1], lengths)
    want = decode_attention_reference(q, cache[0][:, 1, :, :enc], cache[1][:, 1, :, :enc],
                                      lengths)
    assert all(torch.isfinite(t).all() for t in got)
    _assert_stats_close(got, want)


# ------------------------------------------------------------- training ----

# a training step's loss and gradient norm on the card against the CPU
# port, as a share of the CPU's: f32 products (TF32 off) summed in other
# orders.  QAT (bitnet) also rounds activations to int8 codes, and a code
# flips where an input lies an ulp from a rounding boundary: the JAX parity
# tests' QAT tolerance.
TRAIN_TOL = {"smollm-135m": 1e-5, "granite-moe-3b-a800m": 1e-5, "bitnet-730m": 5e-3}
# each weight's change over the run, card against CPU, as a share of the
# CPU's change (L2 over the leaf): Adam turns a rounding of a gradient that
# nearly cancels into a step of up to lr, so single coordinates may part;
# a skipped or botched update parts the whole leaf (share 1 or more).
# Measured on one H100 80GB HBM3 (700 W): at most 5.7e-6 (smollm), 1.7e-5
# (granite), 3.7e-5 (bitnet); losses and gradient norms within 2.6e-6.
DELTA_TOL = {"smollm-135m": 1e-3, "granite-moe-3b-a800m": 1e-3, "bitnet-730m": 5e-3}


@pytest.mark.parametrize("arch", ["smollm-135m", "bitnet-730m", "granite-moe-3b-a800m"])
def test_training_step_on_cuda_holds_the_cpu_port(arch):
    """Three steps of ``make_train_step`` on a reduced config (bitnet: QAT,
    granite: the MoE's aux) on the card and on the CPU from the same
    weights and batches.  WSD with one warmup step: step 0 runs at lr 0, so
    steps 1 and 2 move the weights and step 2's loss is taken after an
    update.  Losses, gradient norms and each weight's change over the run;
    no kernel is launched (training takes the plain paths)."""
    from repro_torch.common.tree import named_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

    dev = _cuda()
    cfg = reduced_config(arch)
    step_fn = make_train_step(cfg, TrainConfig(schedule="wsd", warmup=1, total_steps=4))
    source = make_source(DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size, seed=3))
    state0 = init_train_state(cfg, 1, "cpu")
    before = {n: w.clone() for n, w in named_leaves(state0[0])}
    runs = []
    reset_counts()
    for d in ("cpu", dev):  # the step updates in place: each device takes a copy
        params, opt = (tree_map(lambda t: t.to(d, copy=True), x) for x in state0)
        metrics = []
        for s in range(3):
            batch = {k: torch.from_numpy(v).to(d) for k, v in source.batch(s).items()}
            params, opt, m = step_fn(params, opt, batch, s)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, {n: w.cpu() - before[n] for n, w in named_leaves(params)}))
    assert all(n == 0 for n in COUNTS.values()), dict(COUNTS)
    assert metrics[1]["lr"] > 0 and metrics[0]["lr"] == 0
    for s, (mc, mg) in enumerate(zip(runs[0][0], runs[1][0])):
        for k in ("loss", "grad_norm"):
            err = abs(mg[k] - mc[k]) / abs(mc[k])
            print(f"{arch} step {s} {k}: relative error {err:.3g}")
            assert err <= TRAIN_TOL[arch], (s, k, mg[k], mc[k])
    worst = 0.0
    for name, dc in runs[0][1].items():
        dg, scale = runs[1][1][name], dc.norm().item()
        assert scale > 0, f"{name} did not move on the CPU"
        err = (dg - dc).norm().item() / scale
        worst = max(worst, err)
        assert err <= DELTA_TOL[arch], (name, err)
    print(f"{arch}: worst weight change error {worst:.3g}")


def test_kernel_wrappers_refuse_grad_requiring_inputs_on_cuda():
    """Each wrapper (and so each of the seven launches under it) raises on a
    CUDA input that requires grad while grad is enabled, and launches
    nothing; under no_grad the same call runs its kernel."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.tlmm.ops import tlmm_matmul
    from repro_torch.quant.ternary import quantize_and_pack

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(16)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    w = quantize_and_pack(r(128, 64))
    lengths = torch.tensor([5, 30], dtype=torch.int32, device=dev)
    tables = torch.arange(4, dtype=torch.int32, device=dev).reshape(2, 2)
    q8 = lambda *shape: torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
    x, q, q3 = r(4, 128), r(1, 4, 32, 64), r(2, 4, 64)
    calls = {
        "act_quant_kernel": lambda x: tlmm_matmul(x, w),
        "prefill_attention_kernel": lambda q: prefill_attention(q, r(1, 2, 32, 64), r(1, 2, 32, 64)),
        "decode_attention_kernel": lambda q: decode_attention(q, r(2, 2, 32, 64).bfloat16(),
                                                              r(2, 2, 32, 64).bfloat16(), lengths),
        "decode_attention_quant_kernel": lambda q: decode_attention(
            q, q8(2, 2, 32, 64), q8(2, 2, 32, 64), lengths, k_scales=r(2, 2, 32).abs(),
            v_scales=r(2, 2, 32).abs(), kv_dtype="int8"),
        "paged_decode_attention_kernel": lambda q: paged_decode_attention(
            q, r(4, 2, 16, 64).bfloat16(), r(4, 2, 16, 64).bfloat16(), tables, lengths),
        "paged_decode_attention_quant_kernel": lambda q: paged_decode_attention(
            q, q8(4, 2, 16, 64), q8(4, 2, 16, 64), tables, lengths,
            k_scales=r(4, 2, 16).abs(), v_scales=r(4, 2, 16).abs(), kv_dtype="int8"),
    }
    args = {"act_quant_kernel": x, "prefill_attention_kernel": q}
    for name, call in calls.items():
        a = args.get(name, q3).clone().requires_grad_()
        reset_counts()
        with pytest.raises(RuntimeError, match=f"{name}: a hand-written kernel has no backward"):
            call(a)
        assert sum(COUNTS.values()) == 0, name
        with torch.no_grad():
            call(a)
        torch.cuda.synchronize()
        assert sum(COUNTS.values()) >= 1, name
    reset_counts()
    x_q = torch.zeros((4, 128), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError, match="tlmm_kernel: a hand-written kernel has no backward"):
        tlmm_kernel(x_q, w.packed, torch.ones((4, 1), device=dev, requires_grad=True))
    assert sum(COUNTS.values()) == 0


def test_bf16_serving_is_unchanged_by_the_autograd_refusal():
    """A bf16 ``init`` model served by the engine: its weights require no
    grad, so the kernels launch with grad enabled as under no_grad, to the
    same tokens, B2 and B3 as often as the stats imply."""
    dev = _cuda()
    cfg = reduced_config("qwen2.5-14b")
    params = T.init(cfg, 5, device=dev)
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, 20 + 7 * i) for i in range(3)]
    outs = []
    for ctx in (torch.enable_grad, torch.no_grad):
        with ctx():
            eng = EngineCore(cfg, params, n_slots=2, max_len=64, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(f"r{i}", p, max_new=6))
            reset_counts()
            stats = eng.run()
            outs.append({k: r.out_tokens for k, r in eng.finished.items()})
            assert COUNTS["prefill_attention"] == cfg.num_layers * stats.swaps
            assert COUNTS["decode_attention"] == cfg.num_layers * stats.decode_rounds
    assert outs[0] == outs[1]
