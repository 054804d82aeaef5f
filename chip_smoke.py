"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once), with the ``-Xptxas -v`` register
   and spill lines;
3. each kernel against its plain PyTorch version at the shapes the serving
   path gives it, from seeded random inputs: the largest difference, and
   times (CUDA events around each launch with the card kept busy while the
   host enqueues it, the 50 MB L2 flushed before each, median of the runs)
   of the kernel, the plain version and one PyTorch call
   computing the same function as a yardstick, beside the least time the
   card could take (the larger of bytes over 3.35 TB/s and operations over
   the peak rate for their type).  The act-quant kernel bit for bit (an
   all-zero row, an exact half-way value) at M 4/1024, K 1536/4096; B1 bit
   for bit, with ``tlmm_matmul`` from f32 activations timed end to end
   (act-quant + B1); B2 within 1e-4, bound by the 3xTF32 tensor-core rate
   (its f32-FMA bound beside it); the four decode walks, all one cluster
   split walk: B3 (bf16) and B4 (int8, int4) on a strided layer slice of a
   (4,24,24,2048,·) cache, B5 on a bf16 pool of 512 pages of 16 and B6
   (int8, int4) on the same pool, walked through shuffled block tables,
   each run again on the same contents placed elsewhere (B3/B4: another
   batch index and layer of a cache with a larger Smax; B5/B6: another page
   shuffle in a larger pool; NaN or random bytes in every other row) and
   held to the same bits, B3/B4 also on the same rows as shuffled 16-row
   pages through B5/B6 and held to the same bits, and each timed once more
   with every length 0 (the launch's fixed cost, ``empty_ms``);
4. the main path: bitnet-730m at full width (24 layers, random weights
   from a seed, packed to 2 bits) served by
   ``EngineCore(device="cuda", mode="pdswap", overlap=True)`` to 8 greedy
   requests, after ``build_serving_grid`` (every reachable program built,
   the decode, chunk and sampler programs captured as CUDA graphs: its
   seconds and the pool the graphs reserved are printed); the launch
   counters, set to 0 just before, must equal what the engine's stats imply
   (act-quant as often as B1), the graphs' replays adding what their
   captures counted; the decode profile (device-side events only: device
   time a round, busy share, operations a round); the served model's logits
   are held against the plain versions on the CPU at full width and cut
   depth; then the main path's and (d)'s configurations decode the same 4
   requests in runs eager, graph, graph, eager (eager: the decode
   program's ``fn`` in its place), which must give the same tokens, each
   printing decode ms a round, device ms and operations a round, busy share
   and peak device memory;
5. the other cache options at full width, each serving the same 8 requests
   (and each driven with the counts set to 0 just before and read just
   after): (a) contiguous int8, pdswap; (b) contiguous int4, static;
   (c) paged bf16, 16-token pages, four prompts sharing a 256-token prefix
   (prefix hits asserted); (d) paged int8; (e) paged int8 on a pool of 150
   pages, which forces preemption (asserted) and must give (d)'s tokens;
   (f) the main path's configuration again, so that the paths' times
   compare with it late in the run as they are; (g) (d) with the odd
   requests sampled (temperature 0.8, top-k 50, top-p 0.9, seed 1000 + i),
   whose greedy requests must give (d)'s tokens and at least one sampled
   stream another; (h) (g) on 150 pages, preempting, which must give (g)'s
   tokens, the sampled ones included; (i) (d) with chunked prefill in
   256-token chunks, one chunk a prompt's 256 tokens and decode rounds
   between the chunks of the 1536-token prompt asserted, TTFT and the
   largest inter-token gap printed beside (d)'s, and one 256-token chunk
   profiled alone (its device time); (j) (i) on 150 pages,
   preempting, which must give (i)'s tokens.  B1 runs 168 times a prefill,
   chunk, decode round and replayed token, B2 24 times a monolithic
   prefill (never on (i)/(j)), the path's decode kernel 24 times a decode
   round (replay rounds included), the other decode kernels never; each
   path's decode is profiled (sampled requests on (g)/(h), their device
   operations a round beside (d)'s); the quantized and paged decode steps
   and a chunked prefill in two chunks are held against the CPU plain
   versions at full width and cut depth;
6. abort on a chunked paged int8 engine with 2 slots: a request decoding,
   one part-way through its chunked prefill and one queued, each ending
   ``"abort"``, no live page left, and a later request's tokens equal to a
   fresh engine's;
7. the results as JSON, the card again, and ``{"ok": true, ...}`` last.

Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"int8": 1979e12, "f32": 67e12, "tf32": 495e12}  # dense int8 / f32 non-tensor / tf32 tensor
TLMM_SHAPES = ((1536, 1536), (1536, 4096), (4096, 1536))
DECODE_LENGTHS = [0, 517, 1300, 2048]
PROMPT_LENS = [64, 1536, 300, 900, 128, 1200, 700, 480]
SHARED = (1, 2, 3, 5)  # the prompts of the paged paths that share a 256-token prefix
SMALL_POOL = 150  # pages: too few for 4 slots of these prompts, so (e) preempts
CHUNK = 256  # prefill chunk of paths (i), (j) and the abort phase


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, kind: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timed_ms(torch, fn, flush, reps: int = 15, busy: bool = True) -> float:
    """Median time of one call between CUDA events, warmed up, with the L2
    flushed before each call.  With ``busy`` the card is kept busy
    (``torch.cuda._sleep``) while the host enqueues the events and the call,
    so the time is the device's alone; without, it includes the host's
    Python overhead of the call whenever that is longer."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if busy:
            torch.cuda._sleep(1_000_000)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_checks(torch, ops, refs):
    """Phase 3.  Returns {kernel: entry without launches}."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # act-quant — x (M,K) f32 -> x_q int8 and act_scale * beta, bit for bit
    from repro_torch.quant.act_quant import quantize_activations_int8

    aq = {}
    beta = torch.tensor(0.037, device=dev)
    for m in (4, 1024):
        for k in (1536, 4096):
            x = torch.randn((m, k), generator=gen, device=dev)
            x *= 10.0 ** (torch.rand((m, 1), generator=gen, device=dev) * 4 - 2)
            x[0] = 0.0  # an all-zero row
            s1 = quantize_activations_int8(x[1:2])[1]  # the row's own scale
            x[1, 5] = 2.5 * s1[0, 0]  # an exact half-way value
            got, want = ops["act_quant"](x, beta), refs["act_quant"](x, beta)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"act-quant kernel differs from its plain version at M={m} K={k}")
            aq[(m, k)] = timed_ms(torch, lambda: ops["act_quant"](x, beta), flush)
            print(f"kernel act_quant M={m} K={k}: bit-equal, {aq[(m, k)]:.4f} ms")

    # B1 — TLMM at decode (M = 4 slots) and prefill (M = 1024 tokens) rows
    cases = []
    for m in (4, 1024):
        for k, n in TLMM_SHAPES:
            x_q = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
            w = torch.randint(0, 256, (k // 4, n), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
            scale = torch.rand((m, 1), generator=gen, device=dev) * 1e-3
            y = ops["tlmm"](x_q, w, scale)
            y_ref = refs["tlmm"](x_q, w, scale)
            torch.cuda.synchronize()
            if not torch.equal(y, y_ref):
                raise AssertionError(f"TLMM kernel differs from its plain version at M={m} K={k} N={n}")
            w_unpacked = refs["unpack"](w)
            if m > 16:  # torch._int_mm takes M > 16
                lib = lambda: torch._int_mm(x_q, w_unpacked)  # noqa: E731
            else:
                xb, wb = x_q.to(torch.bfloat16), w_unpacked.to(torch.bfloat16)
                lib = lambda: xb @ wb  # noqa: E731
            # tlmm_matmul end to end from f32 activations: act-quant, then B1
            tw = refs["ternary"](w, torch.tensor(0.037, device=dev))
            x = torch.randn((m, k), generator=gen, device=dev)
            b_ms, b_by = bound(m * k + k * n / 4 + m * 4 + m * n * 4, 2.0 * m * k * n, "int8")
            case = {
                "shape": f"M={m} K={k} N={n}", "max_abs_err": 0.0,
                "ms": timed_ms(torch, lambda: ops["tlmm"](x_q, w, scale), flush),
                "kernel_call_ms": timed_ms(torch, lambda: ops["tlmm"](x_q, w, scale), flush, busy=False),
                "act_quant_ms": aq[(m, k)],
                "matmul_ms": timed_ms(torch, lambda: ops["matmul"](x, tw), flush),
                "call_ms": timed_ms(torch, lambda: ops["matmul"](x, tw), flush, busy=False),
                "plain_ms": timed_ms(torch, lambda: refs["tlmm"](x_q, w, scale), flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": timed_ms(torch, lib, flush),
            }
            cases.append(case)
    results["tlmm"] = dict(cases[4], cases=cases)  # headline: prefill w_gate/w_up shape

    # B2 — prefill attention, (1, 24, S, 64) f32, causal
    cases = []
    for s in (256, 2048):
        q, k, v = (torch.randn((1, 24, s, 64), generator=gen, device=dev) for _ in range(3))
        out = ops["prefill"](q, k, v)
        err = (out - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at S={s}")
        ops_causal = 4.0 * 64 * 24 * s * (s + 1) / 2
        # the kernel's products: three TF32 tensor-core passes (3xTF32) a product
        b_ms, b_by = bound(4 * q.numel() * 4, 3 * ops_causal, "tf32")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        cases.append({
            "shape": f"(1,24,{s},64)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            # the same work on the f32 FMA units
            "bound_f32_fma_ms": bound(4 * q.numel() * 4, ops_causal, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True), flush),
        })
    results["prefill_attention"] = dict(cases[1], max_abs_err=max(c["max_abs_err"] for c in cases),
                                        cases=cases)

    results.update(decode_walk_checks(torch, ops, refs, flush, gen))
    return results


def _random_payload(torch, gen, dev, shape, kv_dtype):
    """A quantized cache's payload and scale plane, made of random bytes and
    scales in [0.01, 0.03) (dequantized values of order 1)."""
    d = shape[-1]
    if kv_dtype == "int4":
        q = torch.randint(0, 256, shape[:-1] + (d // 2,), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    else:
        q = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    return q, torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01


def _check_err(name, got, want):
    out, l, m = got
    out_r, l_r, m_r = want
    err = max((out - out_r).abs().max().item(), (m - m_r).abs().max().item(),
              ((l - l_r).abs() / l_r.clamp(min=1.0)).max().item())
    if not err <= 1e-4:
        raise AssertionError(f"{name} kernel off by {err}")
    return err


def _junk(torch, gen, shape, like):
    """A tensor of ``like``'s dtype and device holding NaN (floats) or random
    bytes (payloads)."""
    if like.dtype.is_floating_point:
        return torch.full(shape, float("nan"), dtype=like.dtype, device=like.device)
    return torch.randint(0, 100, shape, generator=gen, device=like.device,
                         dtype=torch.int32).to(like.dtype)


def _moved(torch, gen, planes, tables):
    """The same contents under another page shuffle, in a pool of another
    size: each (N, ...) layer slice's pages moved to new ids of an
    (N + 88)-page pool whose other pages hold NaN or random bytes, and the
    tables rewritten to match."""
    n = planes[0].shape[0]
    ids = torch.randperm(n + 88, generator=gen, device=tables.device)[:n]
    pools = []
    for t in planes:
        pool = _junk(torch, gen, (n + 88,) + t.shape[1:], t)
        pool[ids] = t
        pools.append(pool)
    return pools, ids[tables.long()].to(torch.int32)


def _moved_slot(torch, gen, planes, lengths):
    """The same contents at another slot placement: each (B, Hkv, S, ...)
    layer slice's rows [0, length) moved to batch index 2i+1, layer 2 of a
    (2B+1, 3, Hkv, S+40, ...) cache whose other rows hold NaN or random
    bytes; returns the strided views the engine would pass."""
    out = []
    for t in planes:
        b, s = t.shape[0], t.shape[2]
        cache = _junk(torch, gen, (2 * b + 1, 3, t.shape[1], s + 40) + t.shape[3:], t)
        view = cache[1::2][:b, 2]
        live = (torch.arange(s, device=t.device)[None, :] < lengths[:, None])[:, None, :]
        dst = view[:, :, :s]
        dst.copy_(torch.where(live if t.dim() == 3 else live[..., None], t, dst))
        out.append(view)
    return out


def _as_pages(torch, gen, planes, bs=16):
    """The same rows as shuffled ``bs``-row pages: each (B, Hkv, S, ...)
    layer slice (S a multiple of bs) cut into pages at shuffled ids of a
    (B*S/bs, Hkv, bs, ...) pool, with the (B, S/bs) tables that find them."""
    b, hkv, s = planes[0].shape[:3]
    perm = torch.randperm(b * s // bs, generator=gen, device=planes[0].device)
    pools = []
    for t in planes:
        pages = t.reshape((b, hkv, s // bs, bs) + t.shape[3:]).transpose(1, 2)
        pool = torch.empty((b * s // bs, hkv, bs) + t.shape[3:], dtype=t.dtype, device=t.device)
        pool[perm] = pages.reshape((b * s // bs, hkv, bs) + t.shape[3:])
        pools.append(pool)
    return pools, perm.to(torch.int32).reshape(b, s // bs)


def _check_same_bits(name, got, again, what="under another page placement in a larger pool"):
    if not all(a.equal(b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} kernel: the same contents {what} give other bits")
    print(f"kernel {name}: the same bits {what}")


def decode_walk_checks(torch, ops, refs, flush, gen):
    """B3-B6 at the serving path's shapes: each kernel against its plain
    version, timed beside its bound and, as a yardstick, SDPA over the dense
    bf16 view (gathered and dequantized beforehand, outside its time); each
    run again on the same contents placed elsewhere (same bits asserted),
    B3/B4 also on the same rows as shuffled 16-row pages through B5/B6 (the
    same walk: same bits asserted), and timed with every length 0."""
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    b, layers, hkv, smax, d = 4, 24, 24, 2048, 64
    n_pages, bs, pool_pages = 128, 16, 512
    q = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    no_lengths = torch.zeros_like(lengths)
    mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    live = sum(DECODE_LENGTHS)
    used = [-(-n // bs) for n in DECODE_LENGTHS]
    qb = q.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    small = q.numel() * 4 * 2 + 2 * b * hkv * 4 + b * 4  # q in, out/l/m out, lengths
    results = {}

    def entry(shape, err, run, plain, lib, nbytes, empty):
        """The kernel's times, and the same launch with every length 0 (the
        fixed cost of the launch, ``empty_ms``)."""
        b_ms, b_by = bound(nbytes, 4.0 * d * hkv * live, "f32")
        return {"shape": shape, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                "call_ms": timed_ms(torch, run, flush, busy=False),
                "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed_ms(torch, lib, flush), "empty_ms": timed_ms(torch, empty, flush)}

    # B3 — decode attention on a strided layer slice of a (4,24,24,2048,64) bf16 cache
    cache_k, cache_v = (torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev)
                        .to(torch.bfloat16) for _ in range(2))
    args = (q, cache_k[:, 7], cache_v[:, 7], lengths)
    got = ops["decode"](*args)
    err = _check_err("B3", got, refs["decode"](*args))
    _check_same_bits("B3", got, ops["decode"](q, *_moved_slot(torch, gen, args[1:3], lengths), lengths),
                     "at another slot placement (batch index, layer, Smax), NaN elsewhere")
    pages, tables = _as_pages(torch, gen, args[1:3])
    _check_same_bits("B3", got, ops["paged"](q, *pages, tables, lengths),
                     "as shuffled 16-row pages through B5")
    del pages
    results["decode_attention"] = entry(
        f"B={b} Hkv={hkv} Smax={smax} D={d} lengths={DECODE_LENGTHS} bf16 layer slice", err,
        lambda: ops["decode"](*args), lambda: refs["decode"](*args),
        lambda: sdpa(qb, args[1], args[2], attn_mask=mask), 2 * live * hkv * d * 2 + small,
        lambda: ops["decode"](*args[:3], no_lengths))
    del cache_k, cache_v, args

    # B4 — quantized decode attention, strided layer slice of (4,24,24,2048,Dp)
    cases = []
    for kv_dtype in ("int8", "int4"):
        (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (b, layers, hkv, smax, d), kv_dtype)
                                for _ in range(2))
        args = (q, kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7], lengths)
        got = ops["decode_quant"](*args, kv_dtype=kv_dtype)
        err = _check_err(f"B4 {kv_dtype}", got, refs["decode_quant"](*args, kv_dtype=kv_dtype))
        _check_same_bits(f"B4 {kv_dtype}", got, ops["decode_quant"](
            q, *_moved_slot(torch, gen, args[1:5], lengths), lengths, kv_dtype=kv_dtype),
            "at another slot placement (batch index, layer, Smax), NaN or random bytes elsewhere")
        (kp, ksp, vp, vsp), tables = _as_pages(torch, gen, args[1:5])
        _check_same_bits(f"B4 {kv_dtype}", got, ops["paged_quant"](
            q, kp, ksp, vp, vsp, tables, lengths, kv_dtype=kv_dtype),
            "as shuffled 16-row pages through B6")
        del kp, ksp, vp, vsp
        kd, vd = (dequantize_kv(p, s_, kv_dtype).to(torch.bfloat16) for p, s_ in
                  ((args[1], args[2]), (args[3], args[4])))
        dp = kc.shape[-1]
        cases.append(entry(
            f"B={b} Hkv={hkv} Smax={smax} D={d} lengths={DECODE_LENGTHS} {kv_dtype} layer slice",
            err, lambda: ops["decode_quant"](*args, kv_dtype=kv_dtype),
            lambda: refs["decode_quant"](*args, kv_dtype=kv_dtype),
            lambda: sdpa(qb, kd, vd, attn_mask=mask), 2 * live * hkv * (dp + 4) + small,
            lambda: ops["decode_quant"](*args[:5], no_lengths, kv_dtype=kv_dtype)))
    results["decode_attention_quant"] = dict(cases[0], max_abs_err=max(c["max_abs_err"] for c in cases),
                                             cases=cases)

    # block tables: shuffled distinct pages for each sequence's live pages, 0 elsewhere
    perm = torch.randperm(pool_pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.zeros((b, n_pages), dtype=torch.int32, device=dev)
    start = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[start:start + u]
        start += u
    small_p = small + sum(used) * 4  # the table entries read

    # B5 — paged decode attention, bf16 pool (512, 24, 24, 16, 64), layer 7
    pool_k, pool_v = (torch.randn((pool_pages, layers, hkv, bs, d), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
    args = (q, pool_k[:, 7], pool_v[:, 7], tables, lengths)
    got = ops["paged"](*args)
    err = _check_err("B5", got, refs["paged"](*args))
    (mk, mv), moved_tables = _moved(torch, gen, (args[1], args[2]), tables)
    _check_same_bits("B5", got, ops["paged"](q, mk, mv, moved_tables, lengths))
    kd, vd = (gather_pages(p, tables) for p in (args[1], args[2]))
    results["paged_decode_attention"] = entry(
        f"B={b} Hkv={hkv} N={pool_pages} bs={bs} P={n_pages} D={d} lengths={DECODE_LENGTHS} "
        "bf16 pool layer slice, shuffled tables", err, lambda: ops["paged"](*args),
        lambda: refs["paged"](*args), lambda: sdpa(qb, kd, vd, attn_mask=mask),
        2 * live * hkv * d * 2 + small_p, lambda: ops["paged"](*args[:4], no_lengths))
    del pool_k, pool_v, kd, vd

    # B6 — quantized paged decode attention on the same pool layout
    cases = []
    for kv_dtype in ("int8", "int4"):
        (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (pool_pages, layers, hkv, bs, d),
                                                kv_dtype) for _ in range(2))
        args = (q, kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7], tables, lengths)
        got = ops["paged_quant"](*args, kv_dtype=kv_dtype)
        err = _check_err(f"B6 {kv_dtype}", got, refs["paged_quant"](*args, kv_dtype=kv_dtype))
        moved, moved_tables = _moved(torch, gen, args[1:5], tables)
        _check_same_bits(f"B6 {kv_dtype}", got, ops["paged_quant"](q, *moved, moved_tables, lengths,
                                                                   kv_dtype=kv_dtype))
        kd, vd = (dequantize_kv(gather_pages(p, tables), gather_scales(s_, tables), kv_dtype)
                  .to(torch.bfloat16) for p, s_ in ((args[1], args[2]), (args[3], args[4])))
        dp = kc.shape[-1]
        cases.append(entry(
            f"B={b} Hkv={hkv} N={pool_pages} bs={bs} P={n_pages} D={d} lengths={DECODE_LENGTHS} "
            f"{kv_dtype} pool layer slice, shuffled tables", err,
            lambda: ops["paged_quant"](*args, kv_dtype=kv_dtype),
            lambda: refs["paged_quant"](*args, kv_dtype=kv_dtype),
            lambda: sdpa(qb, kd, vd, attn_mask=mask), 2 * live * hkv * (dp + 4) + small_p,
            lambda: ops["paged_quant"](*args[:6], no_lengths, kv_dtype=kv_dtype)))
    results["paged_decode_attention_quant"] = dict(
        cases[0], max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases)
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
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
    from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel, tlmm_matmul
    from repro_torch.kernels.tlmm.ref import tlmm_reference
    from repro_torch.models import transformer as T
    from repro_torch.quant.act_quant import quantize_and_fold
    from repro_torch.quant.ternary import TernaryWeight, unpack_ternary

    card = smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(info)} sources")
    for name, rec in info.items():
        print(f"  {name}: {rec['seconds']:.1f} s{' (cached)' if rec['cached'] else ''}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # ---- 3. kernels against their plain versions
    ops = {"act_quant": act_quant_kernel, "tlmm": tlmm_kernel, "matmul": tlmm_matmul,
           "prefill": prefill_attention_kernel,
           "decode": decode_attention_kernel, "decode_quant": decode_attention_quant_kernel,
           "paged": paged_decode_attention_kernel, "paged_quant": paged_decode_attention_quant_kernel}
    refs = {"act_quant": quantize_and_fold, "tlmm": tlmm_reference,
            "prefill": prefill_attention_reference, "ternary": TernaryWeight,
            "decode": decode_attention_reference, "decode_quant": decode_attention_quant_reference,
            "paged": paged_decode_attention_reference,
            "paged_quant": paged_decode_attention_quant_reference,
            "unpack": lambda w: unpack_ternary(w).contiguous()}
    checks = kernel_checks(torch, ops, refs)
    for name, r in checks.items():
        for c in r.get("cases", [r]):
            extra = "".join(f"  {key} {c[key]:.4f}" for key in (
                "act_quant_ms", "matmul_ms", "kernel_call_ms",
                "bound_f32_fma_ms", "empty_ms") if key in c)
            print(f"kernel {name} {c['shape']}: err {c['max_abs_err']:.3g}  kernel {c['ms']:.4f} ms "
                  f"(call with host overhead {c['call_ms']:.4f} ms)  "
                  f"plain {c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}){extra}  [{card}]")

    # ---- 4. the main path at full width
    cfg = get_config("bitnet-730m")
    n_slots, max_len, max_tokens = 4, 2048, 32
    prompt_lens = PROMPT_LENS
    params = T.convert_for_inference(T.init(cfg, seed=0, device="cuda"), cfg)
    prompts = make_prompts(np, cfg, prompt_lens)
    eng, stats, wall, launches, _, _, grid = serve(cfg, params, prompts, max_tokens,
                                                   n_slots=n_slots, max_len=max_len,
                                                   mode="pdswap", overlap=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rng = np.random.default_rng(1)

    check_served(eng, cfg, len(prompt_lens), max_tokens)
    per_pass = 7 * cfg.num_layers
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": per_pass * (stats.swaps + stats.decode_rounds),
                   "act_quant": per_pass * (stats.swaps + stats.decode_rounds),
                   "prefill_attention": cfg.num_layers * stats.swaps,
                   "decode_attention": cfg.num_layers * stats.decode_rounds})
    if stats.swaps != len(prompt_lens) or launches != expect:
        raise AssertionError(f"launches {launches} != expected {expect} "
                             f"({stats.swaps} prefills, {stats.decode_rounds} decode rounds)")
    hidden = [t.hidden_fraction for t in stats.swap_timings]
    print(f"main path: bitnet-730m full width, {len(prompt_lens)} requests x {max_tokens} tokens, "
          f"{n_slots} slots, max_len {max_len}: {stats.swaps} prefills, {stats.decode_rounds} decode "
          f"rounds, {wall:.2f} s wall  [{card}]")
    print(f"  TTFT mean {stats.ttft.mean * 1e3:.1f} ms  p50 {stats.ttft.percentile(50) * 1e3:.1f} ms  "
          f"prefill mean {stats.t_prefill / stats.swaps * 1e3:.1f} ms  [{card}]")
    print(f"  decode {stats.decode_tput():.1f} tok/s, {stats.decode_round_cost() * 1e3:.2f} ms/round  [{card}]")
    print(f"  swap: relayout mean {statistics.mean(t.t_relayout for t in stats.swap_timings) * 1e3:.3f} ms, "
          f"tail mean {statistics.mean(t.t_tail for t in stats.swap_timings) * 1e3:.3f} ms, "
          f"hidden fraction mean {statistics.mean(hidden):.3f} min {min(hidden):.3f}  [{card}]")
    print(f"  peak device memory {peak_gib:.2f} GiB  [{card}]")
    print(f"  {_grid_line(grid)}  [{card}]")
    print(f"  launches {launches}")

    wall_p, dev_p, top, per_round = profile_decode(torch, eng)
    if dev_p is None:
        print("profile: the profiler saw no device time; device busy share not measured")
    else:
        print(f"profile: 4 decode rounds (4 slots, 256-token prompts) under torch.profiler: "
              f"{wall_p * 1e3:.1f} ms wall, {per_round:.1f} device operations (kernels, copies, "
              f"sets) a round, {dev_p * 1e3:.1f} ms of them ({dev_p / 4 * 1e3:.3f} ms device time "
              f"a round), device busy {dev_p / wall_p:.3f}  [{card}]")
        for name, sec, calls in top:
            print(f"    {sec * 1e3:9.3f} ms  {calls:6d} calls  {name[:90]}")

    # the served model against the plain versions on the CPU: full width, 2 layers
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p_gpu = T.convert_for_inference(T.init(cfg2, seed=1, device="cuda"), cfg2)
    p_cpu = _to_cpu(p_gpu)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 96))).long()
    lg, kv_g = T.forward_prefill(p_gpu, tokens.cuda(), cfg2, last_pos=80)
    lc, kv_c = T.forward_prefill(p_cpu, tokens, cfg2, last_pos=80)
    ref_err = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    if not (torch.isfinite(lg).all() and lg.shape == (1, cfg.padded_vocab()) and ref_err <= 1e-3 * max(scale, 1.0)):
        raise AssertionError(f"full-width prefill logits differ from the CPU plain path by {ref_err} (max |logit| {scale})")
    print(f"reference: full-width 2-layer prefill logits vs CPU plain versions: max abs err {ref_err:.3g} "
          f"(max |logit| {scale:.3g})")
    del eng

    # eager against graph decode rounds, in alternation within this run
    eager_vs_graph(torch, np, cfg, params, n_slots, max_len, card)

    # ---- 5. the other cache options at full width
    path_launches = cache_option_paths(torch, np, cfg, params, prompts, max_tokens, n_slots,
                                       max_len, card)
    for name, err, scale in decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng):
        print(f"reference: full-width 2-layer {name} decode logits vs CPU plain versions: "
              f"max abs err {err:.3g} (max |logit| {scale:.3g})")
    err, scale = chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens)
    if not err <= 1e-3 * max(scale, 1.0):
        raise AssertionError(f"full-width chunked prefill logits differ from the CPU plain path by "
                             f"{err} (max |logit| {scale})")
    print(f"reference: full-width 2-layer chunked prefill (2 chunks, int8 cache) logits vs CPU "
          f"plain versions: max abs err {err:.3g} (max |logit| {scale:.3g})")
    abort_launches = abort_phase(torch, np, cfg, params, card)
    if not (abort_launches["tlmm"] and abort_launches["paged_decode_attention_quant"]
            and not abort_launches["prefill_attention"]):
        raise AssertionError(f"abort phase: launches {abort_launches}")
    for part in (path_launches, abort_launches):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n

    kernels = []
    meta = {  # source, the TPU kernel it replaces, the yardstick library call
        "tlmm": ("src/repro_torch/csrc/tlmm.cu", "src/repro/kernels/tlmm/kernel.py:79",
                 "torch._int_mm (M > 16) or a bf16 matmul on the unpacked weights"),
        "prefill_attention": ("src/repro_torch/csrc/prefill_attention.cu",
                              "src/repro/kernels/prefill_attention/kernel.py:84",
                              "causal SDPA, f32"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:107",
                             "masked SDPA, bf16"),
        "decode_attention_quant": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:236",
                                   "masked SDPA over the dequantized bf16 view (made outside the time)"),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:95",
                                   "masked SDPA over the gathered bf16 view (made outside the time)"),
        "paged_decode_attention_quant": ("src/repro_torch/csrc/paged_attention.cu",
                                         "src/repro/kernels/paged_attention/kernel.py:226",
                                         "masked SDPA over the gathered, dequantized bf16 view "
                                         "(made outside the time)"),
    }
    for name, (src, replaces, library) in meta.items():
        r = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "library_call": library, "shape": r["shape"], "cases": r.get("cases", [])})
        if name == "tlmm":  # the act-quant kernel launched before each B1 (replaces no Pallas kernel)
            kernels[-1].update(act_quant_ms=r["act_quant_ms"], act_quant_launches=launches["act_quant"])
        if name == "prefill_attention":
            kernels[-1]["bound_f32_fma_ms"] = r["bound_f32_fma_ms"]
        if "empty_ms" in r:  # the decode walks: the same launch with every length 0
            kernels[-1].update(empty_ms=r["empty_ms"], design=WALK_DESIGN[name])
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def make_prompts(np, cfg, prompt_lens, shared_prefix: int = 0):
    """The greedy requests' prompts, from seed 0; with ``shared_prefix``, the
    prompts ``SHARED`` start with the same tokens."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in prompt_lens]
    if shared_prefix:
        prefix = rng.integers(0, cfg.vocab_size, shared_prefix).astype(np.int32)
        for i in SHARED:
            prompts[i][:shared_prefix] = prefix
    return prompts


def serve(cfg, params, prompts, max_tokens, params_of=None, **engine_kw):
    """Drive ``EngineCore`` on the card over the requests (greedy, or with
    ``params_of(i)`` for request i), after ``build_serving_grid`` (every
    reachable program built, the decode, chunk and sampler programs captured
    as CUDA graphs) and a one-request warm-up; the launch counters and the
    peak-memory statistic are reset just before the run.  Returns (engine,
    stats, wall seconds, launches, monolithic prefill calls with restarts,
    the run's events: ("chunk", request id) for each prefill chunk,
    ("round",) for each decode round, ("evict", request id) for each request
    evicted part-way through its chunked prefill, the grid: its build
    seconds, graphs and the device memory their pool reserved)."""
    import numpy as np
    import torch

    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.serving import EngineCore, Request, SamplingParams

    eng = EngineCore(cfg, params, device="cuda", **engine_kw)
    grid = build_grid(torch, eng)
    list(eng.generate(np.arange(64) % cfg.vocab_size, SamplingParams(max_tokens=2)))  # warm-up
    eng.reset_stats()
    for i, p in enumerate(prompts):
        sp = SamplingParams() if params_of is None else params_of(i)
        eng.submit(Request(f"req{i}", p, max_new=max_tokens, params=sp))
    prefills, events = [], []
    runner = eng.runner
    prefill, chunk, decode = runner.prefill, runner.run_prefill_chunk, runner.decode_logits
    evict = eng._preempt_prefilling

    def counted(*args, **kw):
        logits = prefill(*args, **kw)
        prefills.append(1)
        return logits

    def chunk_logged(req, *args):
        events.append(("chunk", req.request_id))
        return chunk(req, *args)

    def round_logged(lengths):
        events.append(("round",))
        return decode(lengths)

    def evict_logged(slot):
        events.append(("evict", eng._prefilling[slot].req.request_id))
        evict(slot)

    runner.prefill, runner.run_prefill_chunk, runner.decode_logits = counted, chunk_logged, round_logged
    eng._preempt_prefilling = evict_logged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, stats, wall, dict(COUNTS), len(prefills), events, grid


def build_grid(torch, eng):
    """``eng.build_serving_grid()``: its seconds, the graphs it captured,
    and the device bytes the allocator holds for their shared pool."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.build_serving_grid()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    graphs = [k for k, p in eng.runner.engine.programs.items() if p.captured is not None]
    return {"seconds": seconds, "graphs": len(graphs),
            "pool_bytes": eng.runner.engine.graph_pool_bytes()}


def _grid_line(grid):
    pool = ("not measured" if grid["pool_bytes"] is None
            else f"{grid['pool_bytes'] / 2**20:.1f} MiB")
    return (f"serving grid: {grid['graphs']} programs captured as CUDA graphs in "
            f"{grid['seconds']:.2f} s, their shared pool {pool}")


def check_served(eng, cfg, n_requests, max_tokens):
    for i in range(n_requests):
        req = eng.finished[f"req{i}"]
        if req.finish_reason != "length" or len(req.out_tokens) != max_tokens:
            raise AssertionError(f"req{i}: finish {req.finish_reason}, {len(req.out_tokens)} tokens")
        if not all(0 <= t < cfg.padded_vocab() for t in req.out_tokens):
            raise AssertionError(f"req{i}: token out of range")


DECODE_KERNELS = ("decode_attention", "decode_attention_quant", "paged_decode_attention",
                  "paged_decode_attention_quant")
_SPLIT_WALK = ("one launch a layer: csrc/paged_walk.cuh, 8-block clusters splitting each sequence "
               "and KV head by whole pages, merged through distributed shared memory; ")
WALK_DESIGN = {
    "decode_attention": _SPLIT_WALK + "a slot as 16-row virtual pages, chunks by bulk copies",
    "decode_attention_quant": _SPLIT_WALK + "a slot as 16-row virtual pages, chunks by bulk copies",
    "paged_decode_attention": _SPLIT_WALK + "pages through the block table, by cp.async",
    "paged_decode_attention_quant": _SPLIT_WALK + "pages through the block table, by cp.async",
}


def _sampled(i):
    """Paths (g)/(h): the even requests greedy, the odd ones sampled."""
    from repro_torch.serving import SamplingParams

    if i % 2 == 0:
        return SamplingParams()
    return SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i)


def _latency(st):
    """TTFT p50 / p99 and the largest inter-token gap, ms."""
    return (st.ttft.percentile(50) * 1e3, st.ttft.percentile(99) * 1e3,
            st.itl.percentile(100) * 1e3)


def cache_option_paths(torch, np, cfg, params, prompts, max_tokens, n_slots, max_len, card):
    """Phase 5: paths (a)-(j).  Returns the launches summed over them."""
    shared = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256)
    paged8 = dict(cache_layout="paged", kv_dtype="int8", mode="pdswap")
    paths = [
        ("a", "contiguous int8, pdswap", prompts,
         dict(cache_layout="contiguous", kv_dtype="int8", mode="pdswap"), None),
        ("b", "contiguous int4, static", prompts,
         dict(cache_layout="contiguous", kv_dtype="int4", mode="static"), None),
        ("c", "paged bf16, bs 16, full pool, shared prefix, pdswap", shared,
         dict(cache_layout="paged", kv_dtype="fp", mode="pdswap"), None),
        ("d", "paged int8, bs 16, full pool, shared prefix, pdswap", shared, paged8, None),
        ("e", f"paged int8, bs 16, {SMALL_POOL}-page pool, shared prefix, pdswap", shared,
         dict(paged8, num_blocks=SMALL_POOL), None),
        # the main path's configuration once more, so that each path's times
        # compare with it within this run, late in the run as they are
        ("f", "control: contiguous bf16, pdswap (the main path again)", prompts,
         dict(cache_layout="contiguous", kv_dtype="fp", mode="pdswap"), None),
        ("g", "(d) with the odd requests sampled (T 0.8, top-k 50, top-p 0.9)", shared, paged8,
         _sampled),
        ("h", f"(g) on a {SMALL_POOL}-page pool", shared, dict(paged8, num_blocks=SMALL_POOL),
         _sampled),
        ("i", f"(d) with chunked prefill, {CHUNK}-token chunks", shared,
         dict(paged8, prefill_chunk=CHUNK), None),
        ("j", f"(i) on a {SMALL_POOL}-page pool", shared,
         dict(paged8, prefill_chunk=CHUNK, num_blocks=SMALL_POOL), None),
    ]
    total, streams, latency, ops = {}, {}, {}, {}
    for key, what, ps, kw, params_of in paths:
        eng, st, wall, launches, prefills, events, grid = serve(
            cfg, params, ps, max_tokens, params_of, n_slots=n_slots, max_len=max_len,
            block_size=16, **kw)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_served(eng, cfg, len(ps), max_tokens)
        streams[key] = {r: q.out_tokens for r, q in eng.finished.items()}
        latency[key] = _latency(st)  # before the profile adds its requests
        kernel = ("paged_" if kw["cache_layout"] == "paged" else "") + "decode_attention" + (
            "" if kw["kv_dtype"] == "fp" else "_quant")
        steps = st.decode_rounds + st.replayed_tokens
        passes = prefills + st.prefill_chunks + steps  # each runs the 168 linears once
        expect = {name: 0 for name in DECODE_KERNELS}
        expect.update({"tlmm": 7 * cfg.num_layers * passes,
                       "act_quant": 7 * cfg.num_layers * passes,
                       "prefill_attention": cfg.num_layers * prefills,
                       kernel: cfg.num_layers * steps})
        if launches != expect:
            raise AssertionError(f"path ({key}): launches {launches} != expected {expect} "
                                 f"({prefills} prefills, {st.prefill_chunks} chunks, "
                                 f"{st.decode_rounds} decode rounds, {st.replayed_tokens} replayed)")
        hidden = [t.hidden_fraction for t in st.swap_timings]
        hid = (f"{statistics.mean(hidden):.3f}" if hidden
               else "n/a (no overlapped swap: static, or installed by the chunks)")
        kb = eng.kv_bytes()
        print(f"path ({key}) {what}: {len(ps)} requests x {max_tokens} tokens, {prefills} prefills, "
              f"{st.prefill_chunks} chunks, {st.decode_rounds} decode rounds, "
              f"{st.replayed_tokens} replayed, {st.preemptions} preemptions, "
              f"{st.admission_blocks} admission blocks, prefix hits {st.prefix_hits} misses "
              f"{st.prefix_misses}, {wall:.2f} s wall  [{card}]")
        p50, p99, itl_max = latency[key]
        print(f"  TTFT mean {st.ttft.mean * 1e3:.1f} ms p50 {p50:.1f} p99 {p99:.1f}  largest ITL "
              f"{itl_max:.1f} ms  decode {st.decode_tput():.1f} tok/s "
              f"({st.decode_round_cost() * 1e3:.2f} ms/round)  hidden fraction {hid}  "
              f"peak device memory {peak_gib:.2f} GiB  [{card}]")
        print(f"  kv_bytes {kb}")
        print(f"  {_grid_line(grid)}  [{card}]")
        print(f"  launches {launches}")
        if key == "c" and not st.prefix_hits > 0:
            raise AssertionError("path (c): no prefix-cache hits")
        if key in ("e", "h", "j") and not (st.preemptions > 0 and st.replayed_tokens > 0):
            raise AssertionError(f"path ({key}): {st.preemptions} preemptions, "
                                 f"{st.replayed_tokens} replayed tokens")
        if key == "i":
            check_chunked(cfg, ps, st, events)
            c_wall, c_dev, c_ops = profile_chunk(torch, np, eng)
            c_dev_s = ("not measured" if c_dev is None else
                       f"{c_dev * 1e3:.3f} ms of device time, busy {c_dev / c_wall:.3f}")
            print(f"path (i): one {CHUNK}-token chunk (prefix width {CHUNK}, nothing decoding), "
                  f"a graph replay: {c_wall * 1e3:.2f} ms wall, {c_dev_s}, {c_ops} device "
                  f"operations  [{card}]")
        if key == "j":
            evicted = [e for e in events if e[0] == "evict"]
            print(f"path (j): {len(evicted)} requests evicted part-way through their chunked "
                  f"prefill, {st.preemptions} preemptions in all")
        sampled = params_of is not None
        wall_p, dev_p, top, per_round = profile_decode(torch, eng, sampled=sampled)
        ops[key] = per_round
        if dev_p is None:
            print("  profile: the profiler saw no device time; device busy share not measured")
        else:
            beside = f" ((d), greedy: {ops['d']:.1f})" if sampled else ""
            print(f"  profile: 4 decode rounds (4 {'sampled' if sampled else 'greedy'} slots, "
                  f"256-token prompts): {wall_p * 1e3:.1f} ms wall, {per_round:.1f} device "
                  f"operations a round{beside}, {dev_p * 1e3:.1f} ms of them "
                  f"({dev_p / 4 * 1e3:.3f} ms device time a round), "
                  f"device busy {dev_p / wall_p:.3f}  [{card}]")
            for name, sec, calls in top[:4]:
                print(f"    {sec * 1e3:9.3f} ms  {calls:6d} calls  {name[:90]}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    for key, ref in (("e", "d"), ("h", "g"), ("j", "i")):
        if streams[key] != streams[ref]:
            raise AssertionError(f"path ({key}): the preempted run's tokens differ from ({ref})'s")
        print(f"path ({key}): token streams equal ({ref})'s after preemption and replay")
    if any(streams["g"][f"req{i}"] != streams["d"][f"req{i}"] for i in range(0, len(shared), 2)):
        raise AssertionError("path (g): a greedy request's tokens differ from (d)'s")
    moved = sum(streams["g"][f"req{i}"] != streams["d"][f"req{i}"]
                for i in range(1, len(shared), 2))
    if not moved:
        raise AssertionError("path (g): no sampled stream differs from the greedy one")
    print(f"path (g): the greedy requests give (d)'s tokens; {moved} of {len(shared) // 2} "
          "sampled streams differ from the greedy stream of their prompt")
    requests = [f"req{i}" for i in range(len(shared))]
    same = sum(streams["i"][r] == streams["d"][r] for r in requests)
    for key in ("d", "i"):
        p50, p99, itl_max = latency[key]
        print(f"path ({key}) latency: TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms, largest ITL "
              f"{itl_max:.1f} ms  [{card}]")
    print(f"path (i): {same} of {len(requests)} streams equal (d)'s (monolithic prefill runs "
          "B2, chunks f32 matmuls: equal only to float rounding, not asserted)")
    return total


def check_chunked(cfg, prompts, st, events):
    """Path (i): one chunk a ``CHUNK`` tokens of each prompt, and decode
    rounds between two chunks of the longest prompt."""
    want = sum(-(-len(p) // CHUNK) for p in prompts)
    if st.prefill_chunks != want:
        raise AssertionError(f"path (i): {st.prefill_chunks} chunks, expected {want}")
    longest = f"req{max(range(len(prompts)), key=lambda i: len(prompts[i]))}"
    at = [i for i, e in enumerate(events) if e == ("chunk", longest)]
    between = sum(e == ("round",) for e in events[at[0]:at[-1]])
    if not between:
        raise AssertionError(f"path (i): no decode round between the chunks of {longest}")
    print(f"path (i): {st.prefill_chunks} chunks (sum of ceil(n / {CHUNK})); {between} decode "
          f"rounds ran between the {len(at)} chunks of the {len(prompts[int(longest[3:])])}-token "
          "prompt")


def abort_phase(torch, np, cfg, params, card):
    """A paged int8 engine with chunked prefill and 2 slots at full width:
    one request aborted while decoding, one part-way through its chunked
    prefill, one queued; each ends with ``finish_reason == "abort"``, no
    page stays live, and a request served afterwards gives the tokens it
    gives in a fresh engine.  Returns its launches."""
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.serving import EngineCore, Request

    rng = np.random.default_rng(3)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for rid, n in (("a", 300), ("b", 1536), ("c", 128), ("d", 200))}
    kw = dict(n_slots=2, max_len=2048, cache_layout="paged", kv_dtype="int8", block_size=16,
              prefill_chunk=CHUNK, device="cuda")
    eng = EngineCore(cfg, params, **kw)
    reset_counts()
    eng.submit(Request("a", prompts["a"], max_new=64))
    while not eng.scheduler.inflight:
        eng.step()
    eng.submit(Request("b", prompts["b"], max_new=8))
    eng.submit(Request("c", prompts["c"], max_new=8))
    eng.step()  # b's first chunk, then a decode round for a
    if [p.req.request_id for p in eng._prefilling.values()] != ["b"] or len(eng.scheduler.queue) != 1:
        raise AssertionError("abort phase: b is not part-way through its prefill with c queued")
    where = {"b": "mid-chunked-prefill", "a": "decoding", "c": "queued"}
    for rid in ("b", "a", "c"):
        out = eng.abort(rid)
        if out is None or not out.finished or out.finish_reason != "abort":
            raise AssertionError(f"abort phase: {rid} ({where[rid]}) gave {out}")
    live = eng.runner.paged.pool.num_live
    if live or eng.has_unfinished() or eng.stats.aborts != 3:
        raise AssertionError(f"abort phase: {live} live pages, aborts {eng.stats.aborts}")
    after = list(eng.generate(prompts["d"], max_new=16))[-1].token_ids
    launches = dict(COUNTS)
    fresh = list(EngineCore(cfg, params, **kw).generate(prompts["d"], max_new=16))[-1].token_ids
    if after != fresh:
        raise AssertionError("abort phase: a request after the aborts differs from a fresh engine's")
    print(f"abort phase: a ({len(eng.finished['a'].out_tokens)} tokens out) decoding, b after "
          f"1 of 6 chunks, c queued: each finish_reason 'abort'; 0 live pages after; a request "
          f"served after the aborts gives a fresh engine's 16 tokens  [{card}]")
    return launches


def chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens):
    """One chunked prefill of the full-width 2-layer model, in two chunks
    (64 tokens, then 17 padded to 32, at prefix width 64), on the card
    against the CPU plain versions.  Returns (max abs err, max |logit|)."""
    from repro_torch.layers.attention import KVCache

    out = []
    for dev, params in ((p_gpu["emb"].device, p_gpu), ("cpu", p_cpu)):
        shape = (cfg2.num_layers, 1, cfg2.num_kv_heads, 128, cfg2.head_dim)
        prefix = KVCache(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        cache = T.init_cache(cfg2, 1, 128, kv_dtype="int8", device=dev)
        for start, size, padded, width in ((0, 64, 64, 0), (64, 17, 32, 64)):
            chunk = torch.zeros((1, padded), dtype=torch.long)
            chunk[0, :size] = tokens[0, start:start + size]
            logits, cache, prefix = T.prefill_chunk(params, chunk.to(dev), cache, prefix, 0, start,
                                                    size - 1, cfg2, prefix_width=width)
        out.append(logits.float().cpu())
    if not (torch.isfinite(out[0]).all() and out[0].shape == (1, cfg2.padded_vocab())):
        raise AssertionError("chunked prefill logits on the card are not finite")
    return (out[0] - out[1]).abs().max().item(), out[1].abs().max().item()


def decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng):
    """One decode step of the full-width 2-layer model over a quantized
    cache (int8, int4) and a paged pool (bf16, int8, int4) holding the same
    prompt KV, on the card against the CPU plain versions.  Yields (what,
    max abs err, max |logit|)."""
    from repro_torch.core.kv_cache import insert_prefill_kv
    from repro_torch.layers.attention import KVCache, write_prefill_pages_q

    s = kv_c.k.shape[3]  # 96 prompt positions: 6 pages of 16
    token = torch.from_numpy(rng.integers(0, cfg2.vocab_size, (2,))).long()
    lengths = torch.tensor([s, 48], dtype=torch.int32)
    for layout, kv_dtype in (("contiguous", "int8"), ("contiguous", "int4"), ("paged", "fp"),
                             ("paged", "int8"), ("paged", "int4")):
        out = []
        for dev, params in ((p_gpu["emb"].device, p_gpu), ("cpu", p_cpu)):
            kv = KVCache(*(a.to(dev) for a in kv_c))
            if layout == "contiguous":
                cache = T.init_cache(cfg2, 2, 128, kv_dtype=kv_dtype, device=dev)
                for slot in range(2):
                    insert_prefill_kv(cache, kv, slot)
                logits, _ = T.decode_step(params, token.to(dev), cache, lengths.to(dev), cfg2)
            else:
                pool = T.init_paged_pool(cfg2, 16, 16, kv_dtype=kv_dtype, device=dev)
                ids = torch.tensor([9, 3, 14, 0, 7, 11], dtype=torch.int32)
                pool = KVCache(*(write_prefill_pages_q(p, a, ids, block_size=16)
                                 for p, a in zip(pool, kv)))
                # slot 1 shares the prompt's first 3 pages and writes its
                # new token into a page of its own
                tables = torch.tensor([[9, 3, 14, 0, 7, 11, 5, 0], [9, 3, 14, 13, 0, 0, 0, 0]],
                                      dtype=torch.int32, device=dev)
                logits, _ = T.decode_step_paged(params, token.to(dev), pool, tables,
                                                lengths.to(dev), cfg2)
            out.append(logits.float().cpu())
        err = (out[0] - out[1]).abs().max().item()
        scale = out[1].abs().max().item()
        what = f"{layout} {kv_dtype}"
        if not (torch.isfinite(out[0]).all() and err <= 1e-3 * max(scale, 1.0)):
            raise AssertionError(f"full-width {what} decode logits differ from the CPU plain path "
                                 f"by {err} (max |logit| {scale})")
        yield what, err, scale


def _device_rows(prof):
    """Device-side events only (kernels, copies, sets) of a profile: (device
    seconds or None when there were none, device operations, the largest
    [(name, s, calls)])."""
    from torch.autograd import DeviceType

    rows = {}  # name -> [s, count]
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            row = rows.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e6
            row[1] += 1
    top = sorted(((name, sec, n) for name, (sec, n) in rows.items()), key=lambda r: -r[1])
    return (sum(r[1] for r in top) if top else None), sum(r[2] for r in top), top[:8]


def _decoding(eng, prompts, tag, max_new, params_of=None):
    """Submit 4 fresh requests and step until all 4 decode (chunked: one
    prompt a step); returns their ids."""
    from repro_torch.serving import Request, SamplingParams

    ids = [f"{tag}.{i}" for i in range(len(prompts))]
    for i, (rid, p) in enumerate(zip(ids, prompts)):
        sp = SamplingParams() if params_of is None else params_of(i)
        eng.submit(Request(rid, p, max_new=max_new, params=sp))
    eng.step()  # the prefill burst (or the first chunk) and a first decode round
    while eng.scheduler.queue or eng._prefilling:
        eng.step()
    return ids


def profile_decode(torch, eng, rounds: int = 4, sampled: bool = False):
    """Device time under ``torch.profiler`` over ``rounds`` decode rounds of
    4 fresh requests (greedy, or all sampled), once all 4 decode (run after
    the path; its counts are already read).  Returns (wall s, device s, the
    top device operations [(name, s, calls)], device operations (kernels,
    copies, sets) per round), summed over the device-side events only, the
    device time None when the profiler saw none."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(2)
    run = sum(name.startswith("prof") for name in eng.finished) // 4  # fresh request ids
    prompts = [rng.integers(0, 32000, 256).astype(np.int32) for _ in range(4)]
    sp = (lambda i: SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=2000 + i)
          ) if sampled else None
    _decoding(eng, prompts, f"prof{run}", rounds + 8, sp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    dev, ops, top = _device_rows(prof)
    return wall, dev, top, ops / rounds


def profile_chunk(torch, np, eng):
    """One 256-token prefill chunk alone (the second of a 768-token prompt,
    prefix width 256, nothing decoding) under ``torch.profiler``, after the
    path.  Returns (wall s, device s or None, device operations)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    prompt = np.random.default_rng(5).integers(0, 32000, 3 * CHUNK).astype(np.int32)
    eng.submit(Request("chunkprof", prompt, max_new=2))
    eng.step()  # the first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # the second chunk; no request decodes yet
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    dev, ops, _ = _device_rows(prof)
    return wall, dev, ops


class _Eager:
    """A phase program's eager callable in the program's place."""

    def __init__(self, prog):
        self.prog = prog

    def __call__(self, *args):
        return self.prog.fn(*args)


def eager_vs_graph(torch, np, cfg, params, n_slots, max_len, card, rounds: int = 8):
    """The main path's and (d)'s configurations, each one engine with its
    grid built: runs of 4 fresh greedy requests (the same 256-token
    prompts) in the order eager, graph, graph, eager — eager with
    ``prog.fn`` of the decode program in its place — each timing ``rounds``
    decode rounds on the host clock and ``rounds`` more under the profiler.
    The four runs must give the same tokens.  Returns {path: {mode: [runs]}}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EngineCore

    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 256).astype(np.int32) for _ in range(4)]
    out = {}
    for path, kw in (("main", dict(cache_layout="contiguous", kv_dtype="fp")),
                     ("d", dict(cache_layout="paged", kv_dtype="int8", block_size=16))):
        eng = EngineCore(cfg, params, n_slots=n_slots, max_len=max_len, mode="pdswap",
                         device="cuda", **kw)
        grid = build_grid(torch, eng)
        print(f"eager vs graph, path ({path}): {_grid_line(grid)}  [{card}]")
        graph = eng.runner.decode_prog
        runs, streams = {"eager": [], "graph": []}, []
        for i, mode in enumerate(("eager", "graph", "graph", "eager")):
            eng.runner.decode_prog = _Eager(graph) if mode == "eager" else graph
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ids = _decoding(eng, prompts, f"alt{i}", 2 * rounds + 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(rounds):
                eng.step()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / rounds
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for _ in range(rounds):
                    eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            eng.run()
            dev, ops, _ = _device_rows(prof)
            streams.append([eng.finished[r].out_tokens for r in ids])
            r = {"decode_ms": host * 1e3, "device_ms": None if dev is None else dev / rounds * 1e3,
                 "device_ops": ops / rounds, "busy": None if dev is None else dev / wall,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
            runs[mode].append(r)
            dev_s = "not measured" if dev is None else f"{r['device_ms']:.3f} ms"
            busy_s = "not measured" if dev is None else (
                f"{r['busy']:.3f} (device time over wall time of the same profiled rounds; "
                f"estimate across windows, profiled device time over the unprofiled round: "
                f"{r['device_ms'] / r['decode_ms']:.3f})")
            print(f"eager vs graph, path ({path}) run {i + 1} {mode}: decode {r['decode_ms']:.2f} "
                  f"ms a round (host clock, {rounds} unprofiled rounds), device {dev_s} and "
                  f"{r['device_ops']:.1f} device operations a round, busy {busy_s}, peak "
                  f"device memory {r['peak_gib']:.2f} GiB allocated, "
                  f"{r['peak_reserved_gib']:.2f} GiB reserved  [{card}]")
        eng.runner.decode_prog = graph
        if any(s != streams[0] for s in streams):
            raise AssertionError(f"eager vs graph, path ({path}): the runs' tokens differ")
        print(f"eager vs graph, path ({path}): the 4 runs give the same tokens")
        out[path] = runs
        del eng
    return out


def _to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return type(tree)(tree.packed.cpu(), tree.scale.cpu())


if __name__ == "__main__":
    sys.exit(main())
