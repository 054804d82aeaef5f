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
   all-zero row, an exact half-way value) at M 4/20/1024, K 1536/4096; B1
   bit for bit at M 4 (decode), 20 (a verify round: 4 slots x 5 block rows)
   and 1024, with ``tlmm_matmul`` from f32 activations timed end to end
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
   with every length 0 (the launch's fixed cost, ``empty_ms``); B4 and B6
   (int8) also at a verify round's 20 query rows (row (b, i) over its
   slot's first length_b + i positions: B4 with ``rows_per_slot`` 5, B6
   with each table row repeated), the same bits from both; then at the
   transformer family's shapes: B2 at (1, 40, S, 128) over 8 KV heads (S
   256, 2048), B3 and B4 int8 on a (4, 48, 8, 2048, 128) cache and B5 and
   B6 int8 on 512 pages of 16 at G = 5, D = 128 (qwen2.5-14b), B3 and B6
   int8 at G = 8, D = 128 (chameleon-34b) and G = 3, D = 64 (granite),
   the library yardstick SDPA with ``enable_gqa``;
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
   preempting, which must give (i)'s tokens; then speculative decoding,
   8 requests (4 prompts tiling a 16-token pattern to 256-1024 tokens,
   greedy, and 4 of (d)'s, sampled as in (g)): (k0) paged int8 without
   speculation, the control; (k) with ``spec_decode=4``; (l) (k) on 150
   pages, preempting mid-speculation, every page home after; (m)
   contiguous int8 with ``spec_decode=4``, each with its drafts, accepted
   tokens, tokens a slot-round, decode tok/s beside (k0)'s and a profile of
   4 verify rounds; (k) and (m) must give (k0)'s tokens and (l) (k)'s, or
   part only where the two tokens' scores lie within ``TIE_TOL`` in both
   runs (``check_near_ties``, from each round's recorded logits).  B1
   runs 168 times a prefill, chunk, decode round and replayed token, B2
   24 times a monolithic prefill (never on (i)/(j)), the path's decode
   kernel 24 times a decode round (replay rounds included), the other
   decode kernels never; each
   path's decode is profiled (sampled requests on (g)/(h), their device
   operations a round beside (d)'s); the quantized and paged decode steps,
   a verify pass on either layout and a chunked prefill in two chunks are
   held against the CPU plain versions at full width and cut depth;
6. abort on a chunked paged int8 engine with 2 slots: a request decoding,
   one part-way through its chunked prefill and one queued, each ending
   ``"abort"``, no live page left, and a later request's tokens equal to a
   fresh engine's;
7. the front end, (n): (i)'s engine with the SLO-aware policy behind
   ``serve_http`` on 127.0.0.1, its grid built and the tracer on, (d)'s 8
   prompts posted at once over SSE by two tenants (weights 1 and 3); the
   streams must be (i)'s or part only at a near tie, ``/stats`` must hold
   the front end's counters, both tenants and roofline drift on the H100
   ``ChipSpec``, ``/metrics`` the stats' counters, ``/stats/v2`` its
   schema, the Chrome trace (``chiprun_out/trace_frontend.json``) one
   finish a request, the launches those the stats imply; the TTFT a tenant
   at the client and the decode tok/s beside (i)'s, the gaps between the
   engine's steps (the front end's own time) from the trace; then a decode
   profile with the tracer on against one with it off (the same device
   operations a round), a back-dated request shed, and a drain with grace 0
   that must cut an open 1,000-token stream with ``"abort"``;
8. the CLI, (o): ``repro_torch.launch.serve.main`` in batch mode at full
   width (4 requests of 32 tokens, 8 new, max_len 128, contiguous bf16) on
   the JAX CLI's latent weights drawn from seed 0 on the card; its printed
   tokens must equal an ``EngineCore`` run on the same weights, and B1, B2
   and B3 run as often as the run implies;
9. the disaggregated pools (``DisaggEngine``: the prefill pool on its own
   CUDA stream and dispatch thread, the decode pool on the engine's, the
   KV handoff channel between them, both pools' grids built first): (p)
   (i)'s configuration on (d)'s 8 prompts, whose streams must be (i)'s or
   part only at a near tie, every chunk shipped (all but each prompt's last
   eagerly) and installed, none discarded or pending, B1 as often as the
   stats imply (the pool thread's launches counted too) and no B2, its TTFT
   p50 / p99 and largest ITL beside (i)'s; (q) contiguous bf16, pdswap with
   the overlapped swap, monolithic prefill on the pool, whose tokens must
   be the main path's, with B1, B2 and B3 as the stats imply and the relay,
   the ship and the install timed with CUDA events; then the interference
   phase on (i)'s colocated and (p)'s disaggregated configurations with 6
   slots: 4 greedy streams of 64-token prompts decode alone, then while two
   1,536-token prompts prefill in 256-token chunks, printing ITL p50 / p95
   in both phases and their ratio, the decode rounds that completed (by
   CUDA events) while a chunk was in flight on the pool's stream, and the
   device operations a step on the engine's stream and on the others; and
   (o) again with ``--disagg``, whose printed tokens must be (o)'s and
   which must print the ``KV handoff`` line;
10. the transformer family at full width, bf16 weights from seed 0, each
    model's engine and weights freed before the next, each path's launches
    held to its stats (B2 a layer a monolithic prefill, the walk a layer a
    decode round, no B1 or act-quant), its decode profile, TTFT p50 / p99,
    decode tok/s and peak device memory: (r) qwen2.5-14b (48 layers, 40
    heads x 128 over 8, QKV bias, untied head) on the main path's engine
    and 8 requests, 4 requests run eager, graph, graph, eager with the same
    tokens, its 2-layer prefill logits held to the CPU plain version within
    ``FAMILY_TOL`` of max |logit|; (s) its weights on a paged int8 pool of
    512 pages of 16 with 256-token chunks, with one decode step and a
    two-chunk prefill at 2 layers held to the CPU; (t) and (u) the same for
    granite-moe-3b-a800m (40 experts, top-8), (u) printing the experts'
    dropped assignments in the first chunk of the 1,536-token prompt (the
    plain version and the card at 2 layers, the engine's chunk at 32); (v)
    smollm-135m, deepseek-7b and minicpm-2b at full depth, chameleon-34b at
    8 of 48 layers and moonshot-v1-16b-a3b at 12 of 48, one 300-token
    prompt and 8 new tokens each, eager = graph tokens; then (o) again with
    ``--arch smollm-135m``, the JAX CLI's default;
11. the other families at full width, bf16 weights drawn on the card by
    ``init_like_jax`` from seed 0, each freed before the next, each path's
    launches set to 0 just before and held after: (w) hymba-1.5b, 4
    prompts of 2,048 tokens through the windowed plain prefill (no B2), the
    swap into a 4,096-row batch-leading cache, 32 greedy decode steps (B3 a
    layer a step, 29 of 32 walks from the window's start past 0), the
    logits after 8 steps against a fresh prefill of prompt + 8 tokens
    (``FAMILY_TOL``), 2 layers against the CPU port (``FAMILY_CPU_TOL``); (x) xlstm-1.3b, 4 prompts of 512 tokens
    (the sLSTM's share of the prefill timed), 32 decode steps, no kernel,
    one group of 8 layers against the CPU port; (y) whisper-large-v3,
    frames (4, 1,500, 1,280), a 64-token prompt (B2 a decoder layer), 32
    decode steps (B3 twice a layer a step: self, and cross over 1,500 of
    1,536 rows), 2 + 2 layers against the CPU port (``FAMILY_CPU_TOL``);
    (z) the long-context example at full width: hymba at batch 1 over
    random bf16 caches of 4,096, 65,536 and 524,288 rows, after the counted
    run a global and a windowed layer's B3 at 524,288 against the plain
    version, then xlstm at the same contexts;
    each with decode ms a step by CUDA events and device time a step by the
    profiler, and peak memory or state MiB.  Phase 3 also holds B2 at
    (1, 20, S, 64) and B3 at hymba's windowed walk, whisper's cross walk
    and 524,288 rows to their plain versions, with times and bounds;
12. training at full width, f32 weights drawn on the card by
    ``init_like_jax`` from seed 0, each path's launches set to 0 just
    before and read just after (training launches no kernel: it takes the
    plain paths, as the JAX training step does): (T1) smollm-135m at full
    depth through the train CLI's loop, batch 8 x 256, WSD: run A 10 steps
    with a checkpoint at step 10 (under ``chiprun_out/``, removed after),
    run B ``--restore`` to step 20, run C a fresh 20 steps, B's and A's
    losses equal to C's bit for bit, the loss falling from within 1.0 of
    ln(vocab); ms a step (CUDA events), tokens a second, model FLOPs and
    their share of the f32 peak, peak memory, one profiled step, the first
    step at 2 layers against the CPU port (``TRAIN_CPU_TOL``); (T2)
    bitnet-730m QAT at full depth, 5 steps, every latent linear's gradient
    nonzero, then the trained weights packed and served (4 x 256 tokens,
    16 new, B1/B2/B3 as the stats imply) and served again after a
    ``CheckpointManager`` save and restore, to the same tokens; (T3)
    granite-moe-3b-a800m at 4 of 32 layers, 2 steps, aux above 0, every
    expert with rows a nonzero gradient, the dropped assignments; (T4)
    hymba (2 layers), xlstm (one group of 8) and whisper (2 + 2): one loss
    and gradient each against the CPU port (``GRAD_CPU_TOL`` of each
    leaf's max |g|); then each kernel launcher refuses an input that
    requires grad;
13. how many sentinels the profiler windows kept (see ``_profiled``), the
    results as JSON, the card again, and ``{"ok": true, ...}`` last.

Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
SPEC_K = 4  # draft depth of paths (k), (l), (m): verify blocks of W = 5 rows
TILED = (256, 512, 768, 1024)  # lengths of the spec paths' prompts that tile a 16-token pattern
VERIFY_BASE = [5, 517, 1300, 2040]  # slot lengths of the walks' verify-row cases
TIE_TOL = 0.01  # two runs' streams may part only where two tokens' scores lie this close
PROFILE_EDGE_S = 0.1  # idle card at each end of a profiler window (see _profiled)
PROFILE_MARKS = 10  # bursts of sentinel kernels through a window's opening margin
MARKS_EACH = 100  # sentinel kernels a burst
MARK = "spin_kernel"  # the sentinel: torch.cuda._sleep's kernel
WINDOW_MARKS = []  # the sentinels each profiler window kept


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
    for m in (4, 4 * (SPEC_K + 1), 1024):
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

    # B1 — TLMM at decode (M = 4 slots), verify (M = 4 x 5 block rows) and
    # prefill (M = 1024 tokens) rows
    cases = []
    for m in (4, 4 * (SPEC_K + 1), 1024):
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
            if m > 64:  # prefill rows: the int8 library matmul
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
    results["tlmm"] = dict(cases[7], cases=cases)  # headline: prefill w_gate/w_up shape

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
    for name, case in verify_row_checks(torch, ops, refs, flush, gen).items():
        r = results[name]
        r["cases"].append(case)
        r["max_abs_err"] = max(r["max_abs_err"], case["max_abs_err"])
    return results


def verify_row_checks(torch, ops, refs, flush, gen):
    """B4 and B6 (int8) at a verify round's shape: 4 slots x W = 5 block
    rows, row (b, i) walking [0, VERIFY_BASE[b] + i) of its slot (one launch
    over all 20 rows: B4 reads slot b // W, B6 each table row W times),
    against the plain version, B4 and B6 on the same rows as shuffled
    16-row pages giving the same bits, timed beside SDPA over the dense
    bf16 view with the 20 rows' masks.  The bound counts each slot's rows
    read once (its longest row's range) and the operations of every row.
    Returns {kernel: case}."""
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    b, layers, hkv, smax, d, w = 4, 24, 24, 2048, 64, SPEC_K + 1
    q = torch.randn((b * w, hkv, 1, d), generator=gen, device=dev)
    base = torch.tensor(VERIFY_BASE, dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(w, dtype=torch.int32, device=dev)).reshape(-1)
    no_lengths = torch.zeros_like(lengths)
    read = sum(VERIFY_BASE) + b * (w - 1)
    mask = (torch.arange(smax, device=dev)[None, None, :] < lengths.reshape(b, w, 1))[:, None]
    qb = q.reshape(b, w, hkv, d).transpose(1, 2).to(torch.bfloat16)
    small = q.numel() * 4 * 2 + 2 * b * w * hkv * 4 + b * w * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (b, layers, hkv, smax, d), "int8")
                            for _ in range(2))
    planes = (kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7])
    got = ops["decode_quant"](q, *planes, lengths, kv_dtype="int8", rows_per_slot=w)
    repeated = [t.repeat_interleave(w, 0) for t in planes]
    err = _check_err("B4 int8 verify rows", got,
                     refs["decode_quant"](q, *repeated, lengths, kv_dtype="int8"))
    del repeated
    (kp, ksp, vp, vsp), tables = _as_pages(torch, gen, planes)
    tables = tables.repeat_interleave(w, 0)
    got_p = ops["paged_quant"](q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8")
    _check_same_bits("B4 int8", got, got_p, "at 20 verify rows, as shuffled 16-row pages "
                     "through B6 with each table row repeated")
    err_p = _check_err("B6 int8 verify rows", got_p, refs["paged_quant"](
        q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8"))
    kd, vd = (dequantize_kv(p, s_, "int8").to(torch.bfloat16)
              for p, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
    shape = (f"verify rows: B*W={b * w} query rows (4 slots x {w}), lengths {VERIFY_BASE} + "
             f"0..{w - 1}, Hkv={hkv} D={d}, int8")

    def case(run, plain, empty, err, nbytes):
        b_ms, b_by = bound(nbytes, 4.0 * d * hkv * int(lengths.sum()), "f32")
        return {"shape": shape, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                "call_ms": timed_ms(torch, run, flush, busy=False),
                "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed_ms(torch, lambda: sdpa(qb, kd, vd, attn_mask=mask), flush),
                "empty_ms": timed_ms(torch, empty, flush)}

    nbytes = 2 * read * hkv * (d + 4) + small
    out = {
        "decode_attention_quant": case(
            lambda: ops["decode_quant"](q, *planes, lengths, kv_dtype="int8", rows_per_slot=w),
            lambda: refs["decode_quant"](q, *(t.repeat_interleave(w, 0) for t in planes), lengths,
                                         kv_dtype="int8"),
            lambda: ops["decode_quant"](q, *planes, no_lengths, kv_dtype="int8", rows_per_slot=w),
            err, nbytes),
        "paged_decode_attention_quant": case(
            lambda: ops["paged_quant"](q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8"),
            lambda: refs["paged_quant"](q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8"),
            lambda: ops["paged_quant"](q, kp, ksp, vp, vsp, tables, no_lengths, kv_dtype="int8"),
            err_p, nbytes + 4 * sum(-(-(n + w - 1) // 16) for n in VERIFY_BASE)),
    }
    out["decode_attention_quant"]["shape"] += " slot slice (rows_per_slot 5)"
    out["paged_decode_attention_quant"]["shape"] += " pages, each table row repeated 5 times"
    return out


# (architecture, KV heads, query heads a KV head, head_dim, layers, the walks run):
# the transformer family's decode shapes, beside bitnet's 24 heads x 64 with G=1
FAMILY_WALKS = (
    ("qwen2.5-14b", 8, 5, 128, 48, (("slot", "fp"), ("slot", "int8"), ("paged", "fp"),
                                    ("paged", "int8"))),
    ("chameleon-34b", 8, 8, 128, 48, (("slot", "fp"), ("paged", "int8"))),
    ("granite-moe-3b-a800m", 8, 3, 64, 32, (("slot", "fp"), ("paged", "int8"))),
)
FAMILY_PREFILL = (40, 8, 128)  # B2 at qwen2.5-14b's heads: H, Hkv, D


def family_kernel_checks(torch, ops, refs, flush, gen):
    """Phase 3 at the transformer family's shapes: B2 at (1, 40, S, 128)
    with 8 KV heads (S 256 and 2048), and the walks at G = 5, D = 128
    (qwen: B3 and B4 int8 on a layer slice of a (4, 48, 8, 2048, 128)
    cache, B5 and B6 int8 on 512 pages of 16), G = 8, D = 128 (chameleon)
    and G = 3, D = 64 (granite): each against its plain version, timed
    beside its bound and SDPA with ``enable_gqa``.  Returns [(kernel,
    case)]."""
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    h, hkv, d = FAMILY_PREFILL
    for s in (256, 2048):
        q = torch.randn((1, h, s, d), generator=gen, device=dev)
        k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev) for _ in range(2))
        got = ops["prefill"](q, k, v)
        err = (got - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at H={h} Hkv={hkv} "
                                 f"S={s} D={d}")
        ops_causal = 4.0 * d * h * s * (s + 1) / 2
        nbytes = (2 * q.numel() + 2 * k.numel()) * 4
        b_ms, b_by = bound(nbytes, 3 * ops_causal, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) Hkv={hkv} f32 (qwen2.5-14b)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(nbytes, ops_causal, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                                   flush)}))
        del q, k, v
    b, smax, bs, pool_pages = 4, 2048, 16, 512
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    live = sum(DECODE_LENGTHS)
    mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    used = [-(-n // bs) for n in DECODE_LENGTHS]
    perm = torch.randperm(pool_pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.zeros((b, smax // bs), dtype=torch.int32, device=dev)
    start = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[start:start + u]
        start += u
    names = {("slot", "fp"): "decode", ("slot", "int8"): "decode_quant",
             ("paged", "fp"): "paged", ("paged", "int8"): "paged_quant"}
    kernels = {"decode": "decode_attention", "decode_quant": "decode_attention_quant",
               "paged": "paged_decode_attention", "paged_quant": "paged_decode_attention_quant"}
    for arch, hkv, g, d, layers, walks in FAMILY_WALKS:
        q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
        qb = q.reshape(b, hkv * g, 1, d).to(torch.bfloat16)
        small = q.numel() * 4 * 2 + 2 * b * hkv * g * 4 + b * 4
        for layout, kv_dtype in walks:
            name = names[(layout, kv_dtype)]
            rows = (pool_pages if layout == "paged" else b, layers, hkv,
                    bs if layout == "paged" else smax, d)
            if kv_dtype == "fp":
                planes = tuple(torch.randn(rows, generator=gen, device=dev).to(torch.bfloat16)[:, 7]
                               for _ in range(2))
            else:
                (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, rows, kv_dtype)
                                        for _ in range(2))
                planes = (kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7])
                del kc, ksc, vc, vsc
            walk_tables = (tables,) if layout == "paged" else ()
            kw = {} if kv_dtype == "fp" else {"kv_dtype": kv_dtype}
            args = (q, *planes, *walk_tables, lengths)
            got = ops[name](*args, **kw)
            err = _check_err(f"{kernels[name]} G={g} D={d}", got, refs[name](*args, **kw))
            view = ((lambda t: gather_pages(t, tables)) if layout == "paged" else (lambda t: t))
            if kv_dtype == "fp":
                kd, vd = view(planes[0]), view(planes[1])
            else:
                sview = ((lambda t: gather_scales(t, tables)) if layout == "paged"
                         else (lambda t: t))
                kd, vd = (dequantize_kv(view(p_), sview(s_), kv_dtype).to(torch.bfloat16)
                          for p_, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
            row_bytes = d * 2 if kv_dtype == "fp" else d + 4
            nbytes = 2 * live * hkv * row_bytes + small + (sum(used) * 4 if walk_tables else 0)
            b_ms, b_by = bound(nbytes, 4.0 * d * hkv * g * live, "f32")
            no_lengths = torch.zeros_like(lengths)
            out.append((kernels[name], {
                "shape": (f"{arch}: B={b} Hkv={hkv} G={g} D={d} lengths={DECODE_LENGTHS} "
                          f"{'bf16' if kv_dtype == 'fp' else kv_dtype} "
                          + (f"pool of {pool_pages} pages of {bs}, layer 7 of {layers}, "
                             "shuffled tables" if layout == "paged"
                             else f"layer slice of ({b},{layers},{hkv},{smax},{d})")),
                "max_abs_err": err,
                "ms": timed_ms(torch, lambda: ops[name](*args, **kw), flush),
                "call_ms": timed_ms(torch, lambda: ops[name](*args, **kw), flush, busy=False),
                "plain_ms": timed_ms(torch, lambda: refs[name](*args, **kw), flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed_ms(torch, lambda: sdpa(qb, kd, vd, attn_mask=mask,
                                                           enable_gqa=True), flush),
                "empty_ms": timed_ms(torch, lambda: ops[name](*args[:-1], no_lengths, **kw),
                                     flush)}))
            del planes, args, kd, vd
    return out


# the other families' kernel shapes: B2 at whisper's decoder self-attention,
# B3 at hymba's windowed walk, whisper's cross walk and the long_500k cell
WHISPER_PREFILL = (20, 64)  # H = Hkv, D
WHISPER_PREFILL_LENS = (64, 2048)
HYMBA_WALK = (5, 5, 64, 32, 4096, 1024)  # Hkv, G, D, layers, Smax, window
HYMBA_WALK_LENGTHS = [2048, 2100, 3000, 4095]
CROSS_WALK = (20, 1, 64, 32, 1536, 1500)  # Hkv, G, D, layers, rows, encoder_seq
LONG_ROWS = 524288  # the long_500k cell's context


def _walk_case(torch, ops, refs, flush, what, q, k, v, lengths, starts, live_rows, view=None):
    """One B3 case against its plain version: err, kernel / plain / SDPA
    times and the bound.  q (B, Hkv, G, D) f32, k/v (B, Hkv, S, D) bf16
    views the kernel walks; the plain version and the SDPA yardstick (the
    [start, length) mask, ``enable_gqa``) read ``view`` (k, v) where given,
    else k/v.  ``live_rows`` is the rows a slot walks, summed."""
    b, hkv, g, d = q.shape
    kr, vr = (k, v) if view is None else view
    got = ops["decode"](q, k, v, lengths, starts)
    err = _check_err(f"decode_attention {what}", got, refs["decode"](q, kr, vr, lengths, starts))
    pos = torch.arange(kr.shape[2], device=q.device)[None, :]
    lo = torch.zeros_like(lengths) if starts is None else starts
    mask = ((pos < lengths[:, None]) & (pos >= lo[:, None]))[:, None, None, :]
    qb = q.reshape(b, hkv * g, 1, d).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    small = q.numel() * 4 * 2 + 2 * b * hkv * g * 4 + b * 4 * (1 if starts is None else 2)
    b_ms, b_by = bound(2 * live_rows * hkv * d * 2 + small, 4.0 * d * hkv * g * live_rows, "f32")
    return {"shape": what, "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["decode"](q, k, v, lengths, starts), flush),
            "call_ms": timed_ms(torch, lambda: ops["decode"](q, k, v, lengths, starts), flush,
                                busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["decode"](q, kr, vr, lengths, starts), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed_ms(torch, lambda: sdpa(qb, kr, vr, attn_mask=mask,
                                                       enable_gqa=True), flush),
            "empty_ms": timed_ms(torch, lambda: ops["decode"](q, k, v, torch.zeros_like(lengths),
                                                              None), flush)}


def other_family_kernel_checks(torch, ops, refs, flush, gen):
    """Phase 3 at the other families' shapes: B2 at whisper's decoder
    self-attention (1, 20, S, 64), S 64 and 2048; B3 at hymba's heads (Hkv
    5, G 5, D 64) on a layer slice of a (4, 32, 5, 4096, 64) bf16 cache with
    the window's starts (1,024 rows a slot), at whisper's cross walk (Hkv
    20, G 1, D 64, 1,500 of 1,536 rows a slot, NaN in the pad) and over
    524,288 rows of one slot (a hymba global layer at the long_500k cell).
    Each against its plain version, timed beside its bound and SDPA.
    Returns [(kernel, case)]."""
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    h, d = WHISPER_PREFILL
    for s in WHISPER_PREFILL_LENS:
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev) for _ in range(3))
        err = (ops["prefill"](q, k, v) - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at (1,{h},{s},{d})")
        ops_causal = 4.0 * d * h * s * (s + 1) / 2
        nbytes = 4 * q.numel() * 4
        b_ms, b_by = bound(nbytes, 3 * ops_causal, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) f32 (whisper-large-v3 decoder)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(nbytes, ops_causal, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True), flush)}))
        del q, k, v
    hkv, g, d, layers, smax, window = HYMBA_WALK
    b = len(HYMBA_WALK_LENGTHS)
    lengths = torch.tensor(HYMBA_WALK_LENGTHS, dtype=torch.int32, device=dev)
    starts = torch.clamp(lengths + 1 - window, min=0).to(torch.int32)
    planes = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev,
                          dtype=torch.bfloat16)[:, 7] for _ in range(2)]
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    live = int((lengths - starts).sum())
    out.append(("decode_attention", _walk_case(
        torch, ops, refs, flush,
        f"hymba-1.5b: B={b} Hkv={hkv} G={g} D={d} lengths={HYMBA_WALK_LENGTHS} window {window} "
        f"(starts {starts.tolist()}) bf16 layer slice of ({b},{layers},{hkv},{smax},{d})",
        q, *planes, lengths, starts, live)))
    del planes
    hkv, g, d, layers, rows, enc = CROSS_WALK
    planes = [torch.randn((b, layers, hkv, rows, d), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
    for t in planes:
        t[:, :, :, enc:] = float("nan")  # the pad the walk must not read
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    lengths = torch.full((b,), enc, dtype=torch.int32, device=dev)
    planes = [t[:, 5] for t in planes]
    got = ops["decode"](q, *planes, lengths)
    if not all(torch.isfinite(t).all() for t in got):
        raise AssertionError("the cross walk read the NaN pad past encoder_seq")
    out.append(("decode_attention", _walk_case(
        torch, ops, refs, flush,
        f"whisper-large-v3 cross: B={b} Hkv={hkv} G={g} D={d} {enc} of {rows} rows (NaN pad) "
        f"bf16 layer slice of ({b},{layers},{hkv},{rows},{d})",
        q, *planes, lengths, None, b * enc, view=[t[:, :, :enc] for t in planes])))
    del planes
    hkv, g, d = HYMBA_WALK[:3]
    planes = [torch.randn((1, hkv, LONG_ROWS, d), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
    q = torch.randn((1, hkv, g, d), generator=gen, device=dev)
    lengths = torch.full((1,), LONG_ROWS - 1, dtype=torch.int32, device=dev)
    out.append(("decode_attention", _walk_case(
        torch, ops, refs, flush,
        f"hymba-1.5b global layer at long_500k: B=1 Hkv={hkv} G={g} D={d} length "
        f"{LONG_ROWS - 1} of {LONG_ROWS} rows bf16 (grid 8 x {hkv} x 1 = {8 * hkv} blocks)",
        q, *planes, lengths, None, LONG_ROWS - 1)))
    del planes
    return out


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

    from repro_torch.common.hardware import H100_SXM

    card = smi()
    print(f"card: {card}; device memory {torch.cuda.get_device_properties(0).total_memory} bytes "
          f"(the H100_SXM ChipSpec's hbm_bytes: {H100_SXM.hbm_bytes})")
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, case in (family_kernel_checks(torch, ops, refs, flush,
                                            torch.Generator(device="cuda").manual_seed(1))
                       + other_family_kernel_checks(torch, ops, refs, flush,
                                                    torch.Generator(device="cuda").manual_seed(2))):
        r = checks[name]
        r.setdefault("cases", [dict(r)]).append(case)
        r["max_abs_err"] = max(r["max_abs_err"], case["max_abs_err"])
    del flush
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
    main_streams = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}

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
    path_launches, path_i = cache_option_paths(torch, np, cfg, params, prompts, max_tokens,
                                               n_slots, max_len, card)
    spec_launches = spec_paths(torch, np, cfg, params, n_slots, max_len, max_tokens, card)
    for name, err, scale in decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng):
        print(f"reference: full-width 2-layer {name} decode logits vs CPU plain versions: "
              f"max abs err {err:.3g} (max |logit| {scale:.3g})")
    for name, err, scale in verify_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng):
        print(f"reference: full-width 2-layer {name} logits vs the CPU port: max abs err "
              f"{err:.3g} (max |logit| {scale:.3g})")
    err, scale = verify_against_decode(torch, T, cfg, params, rng)
    print(f"reference: full-depth int8 verify pass (W={SPEC_K + 1}) vs {SPEC_K + 1} decode steps "
          f"on the card: the same cache bytes, logits max abs err {err:.3g} (max |logit| "
          f"{scale:.3g})  [{card}]")
    err, scale = chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens)
    print(f"reference: full-width 2-layer chunked prefill (2 chunks, int8 cache) logits vs CPU "
          f"plain versions: max abs err {err:.3g} (max |logit| {scale:.3g})")
    abort_launches = abort_phase(torch, np, cfg, params, card)
    if not (abort_launches["tlmm"] and abort_launches["paged_decode_attention_quant"]
            and not abort_launches["prefill_attention"]):
        raise AssertionError(f"abort phase: launches {abort_launches}")
    front_launches = frontend_phase(torch, np, cfg, params, max_tokens, path_i, card)
    cli_launches, cli_tokens = cli_phase(torch, np, card)
    disagg_launches = disagg_phase(torch, np, cfg, params, max_tokens, path_i, main_streams,
                                   card)
    del path_i
    cli_disagg_launches, _ = cli_phase(torch, np, card, want=cli_tokens)
    del params
    _free(torch)

    # ---- 10. the transformer family at full width
    family_launches = family_phase(torch, np, card)
    cli_smollm_launches, _ = cli_phase(torch, np, card, arch="smollm-135m")

    # ---- 11. the other families at full width, and the long_500k context
    other_launches = other_families_phase(torch, np, card)

    # ---- 12. training
    train_launches = training_phase(torch, np, card, ops)
    for part in (path_launches, spec_launches, abort_launches, front_launches, cli_launches,
                 disagg_launches, cli_disagg_launches, family_launches, cli_smollm_launches,
                 other_launches, train_launches):
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
    kept = WINDOW_MARKS
    print(f"profiler windows: {len(kept)}, each with a sentinel kept before and after its device "
          f"work; opening sentinels kept {min(kept) - 1} to {max(kept) - 1} of "
          f"{PROFILE_MARKS * MARKS_EACH} ({PROFILE_MARKS} bursts "
          f"{PROFILE_EDGE_S / PROFILE_MARKS * 1e3:.0f} ms apart)  [{card}]")
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


def serve(cfg, params, prompts, max_tokens, params_of=None, on_engine=None, engine_cls=None,
          **engine_kw):
    """Drive ``EngineCore`` on the card over the requests (greedy, or with
    ``params_of(i)`` for request i), after ``build_serving_grid`` (every
    reachable program built, the decode, chunk and sampler programs captured
    as CUDA graphs) and a one-request warm-up; the launch counters and the
    peak-memory statistic are reset just before the run.  Returns (engine,
    stats, wall seconds, launches, monolithic prefill calls with restarts,
    the run's events: ("chunk", request id) for each prefill chunk,
    ("round",) for each decode round, ("evict", request id) for each request
    evicted part-way through its chunked prefill, the grid: its build
    seconds, graphs and the device memory their pool reserved).
    ``on_engine(eng)`` runs after the warm-up, before the requests;
    ``engine_cls`` (``EngineCore`` by default) is the engine built."""
    import numpy as np
    import torch

    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.serving import EngineCore, Request, SamplingParams

    eng = (engine_cls or EngineCore)(cfg, params, device="cuda", **engine_kw)
    grid = build_grid(torch, eng)
    list(eng.generate(np.arange(64) % cfg.vocab_size, SamplingParams(max_tokens=2)))  # warm-up
    eng.reset_stats()
    if on_engine is not None:
        on_engine(eng)
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
    and the device bytes the allocator holds for their shared pool (summed
    over both pools' engines of a disaggregated engine)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.build_serving_grid()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    engines = [eng.runner.engine] + ([eng.prefill_pool.engine] if hasattr(eng, "prefill_pool")
                                     else [])
    graphs = [k for e in engines for k, p in e.programs.items() if p.captured is not None]
    pools = [e.graph_pool_bytes() for e in engines]
    return {"seconds": seconds, "graphs": len(graphs),
            "pool_bytes": None if None in pools else sum(pools)}


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
    """Phase 5: paths (a)-(j).  Returns the launches summed over them, and
    path (i)'s streams, its ``TargetRecorder``, its TTFT p50/p99 and its
    decode tok/s (path (n) is held to them)."""
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
    total, streams, latency, ops, rec = {}, {}, {}, {}, []
    for key, what, ps, kw, params_of in paths:
        eng, st, wall, launches, prefills, events, grid = serve(
            cfg, params, ps, max_tokens, params_of,
            on_engine=(lambda e: rec.append(TargetRecorder(e))) if key == "i" else None,
            n_slots=n_slots, max_len=max_len, block_size=16, **kw)
        if key == "i":
            rec[0].stop()  # the profiles below are not recorded
            tput_i = st.decode_tput()
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
    return total, {"streams": {r: t for r, t in streams["i"].items() if r in requests},
                   "recorder": rec[0], "latency": latency["i"], "tput": tput_i}


class TargetRecorder:
    """Keeps, for every decode and verify round of an engine, a copy of
    its logits (on the device) and which request and token index each row
    scores, so that where two runs' streams part the scores behind both
    tokens can be read back (``check_near_ties``)."""

    def __init__(self, eng):
        self.eng = eng
        self.rounds = []  # (logits (B, W, V), {slot: (request id, index of row 0)})
        runner = eng.runner
        decode, verify = runner.decode_logits, runner.run_verify

        def decode_logits(lengths):
            logits = decode(lengths)
            self._keep(logits[:, None])
            return logits

        def run_verify(tokens, n_tokens):
            logits = verify(tokens, n_tokens)
            self._keep(logits)
            return logits

        runner.decode_logits, runner.run_verify = decode_logits, run_verify

    def _keep(self, logits):
        if self.eng is None:  # stopped
            return
        rows = {s: (r.request_id, len(r.out_tokens)) for s, r in self.eng.scheduler.inflight.items()}
        self.rounds.append((logits.clone(), rows))

    def stop(self):
        """Keep nothing more (the rounds kept so far stay readable)."""
        self.eng = None

    def row(self, rid, pos):
        """The logits that token ``pos`` of request ``rid`` was drawn from:
        the last round whose block covered it (None for a prefill's token)."""
        for logits, rows in reversed(self.rounds):
            for slot, (r, first) in rows.items():
                if r == rid and first <= pos < first + logits.shape[1]:
                    return logits[slot, pos - first]
        return None


def _margin(torch, row, sp, pos, mine, other):
    """How far token ``other`` is from being drawn in place of ``mine`` at
    token index ``pos`` on these logits: greedy, the gap of their logits;
    sampled, the gap of their perturbed scores (the filtered, scaled logits
    plus the draw's Gumbel noise), or, where ``other`` lies outside the
    top-k / top-p support, its scaled logit's distance below the support."""
    from repro_torch.core import sampling as S

    row = row.float()
    if sp.greedy:
        return float(row[mine] - row[other]), "logits"
    dev = row.device
    temps = torch.tensor([sp.temperature], device=dev)
    masked = S.filter_logits(row[None], temps, torch.tensor([sp.top_k], dtype=torch.int32,
                                                            device=dev),
                             torch.tensor([sp.top_p], device=dev))[0]
    if not torch.isfinite(masked[other]):
        scaled = row / sp.temperature
        return float(scaled[torch.isfinite(masked)].min() - scaled[other]), "below the support"
    key = S.fold_in(S.prng_key(torch.tensor([sp.seed32], dtype=torch.int32, device=dev)),
                    torch.tensor([pos], dtype=torch.int32, device=dev))
    scores = masked + S.gumbel(S.random_bits(key, row.shape[-1]))[0]
    return float(scores[mine] - scores[other]), "perturbed scores"


def check_near_ties(torch, what, got, want, rec_got, rec_want, params_of):
    """Two runs' streams ({request id: tokens}) must be equal, or part only
    at a near tie.  At the first position where a request's streams part:
    greedy, the two tokens' logits lie within TIE_TOL in both runs; sampled
    (where a draw can also flip at the top-k / top-p edge), the two runs'
    logits rows lie within TIE_TOL of each other, so that the same noise
    decides between nearly equal rows.  The rest of a parted stream is not
    compared.  Prints each parting (position, tokens, each run's margin
    and the rows' largest difference) and the largest difference between
    the two runs' logits on the tokens both gave.  Returns the partings."""
    parted, agree = [], 0.0
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None and len(a) != len(b):
            raise AssertionError(f"{what}: {rid} has {len(a)} tokens against {len(b)}")
        for p in range(1, len(a) if pos is None else pos):  # token 0 is the prefill's
            agree = max(agree, float((rec_got.row(rid, p) - rec_want.row(rid, p)).abs().max()))
        if pos is None:
            continue
        rows = rec_got.row(rid, pos), rec_want.row(rid, pos)
        if rows[0] is None or rows[1] is None:
            raise AssertionError(f"{what}: {rid} parts at its prefill's token {pos}")
        diff = float((rows[0] - rows[1]).abs().max())
        sp = params_of(rid)
        (m0, how), (m1, _) = (_margin(torch, rows[0], sp, pos, a[pos], b[pos]),
                              _margin(torch, rows[1], sp, pos, b[pos], a[pos]))
        print(f"{what}: {rid} parts at token {pos}: {a[pos]} against {b[pos]} "
              f"({'greedy' if sp.greedy else 'sampled'}); margins ({how}) {m0:.6f} and "
              f"{m1:.6f}; the runs' logits there {diff:.6f} apart at most")
        bad = max(m0, m1) > TIE_TOL if sp.greedy else diff > TIE_TOL
        if bad:
            raise AssertionError(f"{what}: {rid} parts at token {pos}, not at a near tie "
                                 f"(margins {m0}, {m1}; logits {diff} apart; limit {TIE_TOL})")
        parted.append((rid, pos))
    print(f"{what}: the two runs' logits on the tokens both gave lie within {agree:.3g}")
    return parted


def spec_prompts(np, cfg):
    """The speculative paths' 8 requests: 4 prompts that each tile a
    16-token pattern to TILED lengths (the drafter's regime: summarization,
    code edits) at the even indices, greedy, and the first 4 of (d)'s
    prompts at the odd, sampled as in (g)."""
    rng = np.random.default_rng(7)
    tiled = [np.tile(rng.integers(0, cfg.vocab_size, 16).astype(np.int32), n // 16)
             for n in TILED]
    shared = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256)[:4]
    return [p for pair in zip(tiled, shared) for p in pair]


def spec_paths(torch, np, cfg, params, n_slots, max_len, max_tokens, card):
    """Paths (k0)-(m): speculative decoding at full width.  (k0) paged int8
    on 512 pages without speculation is the control; (k) the same with
    ``spec_decode=4``; (l) (k) on 150 pages, preempting and replaying
    mid-speculation, every page home after; (m) contiguous int8 with
    ``spec_decode=4`` (B4 on the verify rows).  (k), (m) must give (k0)'s
    tokens and (l) (k)'s, by ``check_near_ties``; each path's launches are
    checked against its stats (a verify round runs B1 168 times at M = 20
    and the walk 24 times over 20 rows), and 4 verify rounds of tiled
    prompts profiled.  Returns the launches summed over the paths."""
    prompts = spec_prompts(np, cfg)
    paged8 = dict(cache_layout="paged", kv_dtype="int8", mode="pdswap")
    paths = [
        ("k0", "paged int8, 512 pages, no speculation (the control)", paged8),
        ("k", f"(k0) with spec_decode={SPEC_K}", dict(paged8, spec_decode=SPEC_K)),
        ("l", f"(k) on a {SMALL_POOL}-page pool", dict(paged8, spec_decode=SPEC_K,
                                                        num_blocks=SMALL_POOL)),
        ("m", f"contiguous int8, spec_decode={SPEC_K}",
         dict(cache_layout="contiguous", kv_dtype="int8", mode="pdswap", spec_decode=SPEC_K)),
    ]
    params_of = {f"req{i}": _sampled(i) for i in range(len(prompts))}
    total, streams, recorders, tput = {}, {}, {}, {}
    for key, what, kw in paths:
        rec = []
        eng, st, wall, launches, prefills, _, grid = serve(
            cfg, params, prompts, max_tokens, _sampled,
            on_engine=lambda e: rec.append(TargetRecorder(e)), n_slots=n_slots,
            max_len=max_len, block_size=16, **kw)
        check_served(eng, cfg, len(prompts), max_tokens)
        streams[key] = {f"req{i}": eng.finished[f"req{i}"].out_tokens
                        for i in range(len(prompts))}  # not the warm-up's
        recorders[key] = rec[0]
        rec[0].stop()  # the profile below is not recorded
        kernel = ("paged_" if kw["cache_layout"] == "paged" else "") + "decode_attention_quant"
        steps = st.decode_rounds + st.replayed_tokens
        expect = {name: 0 for name in DECODE_KERNELS}
        expect.update({"tlmm": 7 * cfg.num_layers * (prefills + steps),
                       "act_quant": 7 * cfg.num_layers * (prefills + steps),
                       "prefill_attention": cfg.num_layers * prefills,
                       kernel: cfg.num_layers * steps})
        if launches != expect:
            raise AssertionError(f"path ({key}): launches {launches} != expected {expect} "
                                 f"({prefills} prefills, {st.decode_rounds} decode rounds of "
                                 f"which {st.verify_rounds} verify, {st.replayed_tokens} replayed)")
        tput[key] = (st.decode_tput(), st.decode_round_cost() * 1e3)
        beside = "" if key == "k0" else (f" (k0: {tput['k0'][0]:.1f} tok/s, "
                                         f"{tput['k0'][1]:.2f} ms a round)")
        print(f"path ({key}) {what}: {len(prompts)} requests x {max_tokens} tokens, {prefills} "
              f"prefills, {st.decode_rounds} decode rounds of which {st.verify_rounds} verify "
              f"rounds (W={SPEC_K + 1} rows a slot), {st.replayed_tokens} replayed, "
              f"{st.preemptions} preemptions, {wall:.2f} s wall  [{card}]")
        print(f"  drafts {st.draft_tokens}, accepted {st.accepted_tokens} "
              f"(rate {st.acceptance_rate():.3f}), {st.tokens_per_round():.3f} tokens a "
              f"slot-round; decode {tput[key][0]:.1f} tok/s, {tput[key][1]:.2f} ms a round"
              f"{beside}  [{card}]")
        print(f"  {_grid_line(grid)}  [{card}]")
        print(f"  launches {launches}: B1 and act-quant 168 a prefill and a round (M = 20 "
              f"on the {st.verify_rounds} verify rounds), {kernel} 24 a round and a replayed "
              "token (20 query rows on a verify round), as the stats imply")
        if key in ("k", "l", "m") and not (st.verify_rounds > 0 and st.accepted_tokens > 0):
            raise AssertionError(f"path ({key}): {st.verify_rounds} verify rounds, "
                                 f"{st.accepted_tokens} accepted tokens")
        if key == "l":
            pool = eng.runner.paged.pool
            home = len(pool.free_list) + len(pool.evictable)
            if not (st.preemptions > 0 and st.replayed_tokens > 0 and pool.num_live == 0
                    and home == pool.num_blocks):
                raise AssertionError(f"path (l): {st.preemptions} preemptions, "
                                     f"{st.replayed_tokens} replayed, {pool.num_live} live pages, "
                                     f"{home} of {pool.num_blocks} home")
            print(f"path (l): {st.preemptions} preemptions, {st.replayed_tokens} replayed "
                  f"tokens; every page home after ({home} of {pool.num_blocks})")
        wall_p, dev_p, ops_p, verify_p, top = profile_verify(torch, np, cfg, eng)
        kind = "verify" if verify_p else "decode"
        if dev_p is None:
            print("  profile: the profiler saw no device time; busy share not measured")
        else:
            print(f"  profile: 4 {kind} rounds ({verify_p} verify) of 4 tiled 256-token prompts: "
                  f"{wall_p * 1e3:.1f} ms wall, {dev_p / 4 * 1e3:.3f} ms device time and "
                  f"{ops_p:.1f} device operations a round, device busy {dev_p / wall_p:.3f}  "
                  f"[{card}]")
            for name, sec, calls in top[:6]:
                print(f"    {sec * 1e3:9.3f} ms  {calls:6d} calls  {name[:90]}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    for key, ref in (("k", "k0"), ("l", "k"), ("m", "k0")):
        parted = check_near_ties(torch, f"path ({key}) against ({ref})", streams[key],
                                 streams[ref], recorders[key], recorders[ref], params_of.get)
        print(f"path ({key}): {len(streams[key]) - len(parted)} of {len(streams[key])} streams "
              f"equal ({ref})'s; {len(parted)} part at a near tie (scores within {TIE_TOL})")
    return total


def profile_verify(torch, np, cfg, eng, rounds: int = 4):
    """``rounds`` decode quanta of 4 fresh greedy requests whose 256-token
    prompts tile a 16-token pattern, once all 4 decode, under
    ``torch.profiler`` (run after the path; its counts are already read).
    Returns (wall s, device s or None, device operations a round, verify
    rounds among them, the top device operations [(name, s, calls)])."""

    rng = np.random.default_rng(8)
    run = sum(name.startswith("vprof") for name in eng.finished) // 4
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, 16).astype(np.int32), 16)
               for _ in range(4)]
    _decoding(eng, prompts, f"vprof{run}", (SPEC_K + 1) * (rounds + 3))
    torch.cuda.synchronize()
    before = eng.stats.verify_rounds
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    verify = eng.stats.verify_rounds - before
    eng.run()
    dev, ops, top = _device_rows(prof)
    return wall, dev, ops / rounds, verify, top


def check_chunked(cfg, prompts, st, events, tag="(i)"):
    """Path (i) (or (p)): one chunk a ``CHUNK`` tokens of each prompt, and
    decode rounds between two chunks of the longest prompt."""
    want = sum(-(-len(p) // CHUNK) for p in prompts)
    if st.prefill_chunks != want:
        raise AssertionError(f"path {tag}: {st.prefill_chunks} chunks, expected {want}")
    longest = f"req{max(range(len(prompts)), key=lambda i: len(prompts[i]))}"
    at = [i for i, e in enumerate(events) if e == ("chunk", longest)]
    between = sum(e == ("round",) for e in events[at[0]:at[-1]])
    if not between:
        raise AssertionError(f"path {tag}: no decode round between the chunks of {longest}")
    print(f"path {tag}: {st.prefill_chunks} chunks (sum of ceil(n / {CHUNK})); {between} decode "
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


SLO_LOOSE = dict(ttft_target_s=600.0, itl_target_s=60.0)  # path (n): loose enough that nothing is shed
TENANTS = (("A", 1.0), ("B", 3.0))  # path (n): request i is sent by TENANTS[i % 2]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _http(port, method, path, body=b""):
    """One HTTP exchange on a fresh connection: (status line, headers, body)."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}\r\n\r\n"
                 .encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    return lines[0], {k.strip().lower(): v.strip() for k, _, v in
                      (ln.partition(":") for ln in lines[1:])}, payload


async def _sse(port, spec):
    """POST /generate and read the stream: (events, seconds from sending to
    the first event, to the last)."""
    import asyncio

    body = json.dumps(spec).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    t0 = time.perf_counter()
    writer.write(f"POST /generate HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}\r\n\r\n"
                 .encode() + body)
    await writer.drain()
    events, first = [], None
    while True:
        line = await asyncio.wait_for(reader.readline(), 600)
        if not line:
            break
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            first = first if first is not None else time.perf_counter() - t0
    last = time.perf_counter() - t0
    writer.close()
    await writer.wait_closed()
    return events, first, last


def frontend_phase(torch, np, cfg, params, max_tokens, path_i, card):
    """Path (n): (i)'s engine (paged int8, 512 pages, 256-token chunks, 4
    slots) with the SLO-aware policy behind ``serve_http`` on 127.0.0.1, its
    grid built and the tracer on.  (d)'s 8 prompts are posted at once over
    SSE by two tenants (weights 1 and 3).  The streams must be (i)'s or part
    only at a near tie; /stats must carry the front end's counters, both
    tenants and roofline drift on the H100 ChipSpec, /metrics the stats'
    counters, /stats/v2 its schema; the Chrome trace (under chiprun_out/)
    finishes each request once; the launches are those the stats imply.
    Then, on the same engine: a decode profile with the tracer on against
    one with it off (the same device operations a round), a back-dated
    request shed, and a drain with grace 0 that cuts a 1,000-token stream
    with "abort".  Returns the session's launches."""
    import asyncio

    from repro_torch.common.hardware import H100_SXM
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch.serve import serve_http
    from repro_torch.obs.drift import roofline_drift
    from repro_torch.obs.engine import _STAT_COUNTERS
    from repro_torch.obs.metrics import PROMETHEUS_CONTENT_TYPE
    from repro_torch.obs.trace import TRACER
    from repro_torch.serving import EngineCore, Request, SamplingParams
    from repro_torch.serving.slo import SLOAwareSwapPolicy, SLOConfig

    eng = EngineCore(cfg, params, n_slots=4, max_len=2048, mode="pdswap", cache_layout="paged",
                     kv_dtype="int8", block_size=16, num_blocks=512, prefill_chunk=CHUNK,
                     swap_policy=SLOAwareSwapPolicy(SLOConfig(**SLO_LOOSE)), device="cuda")
    grid = build_grid(torch, eng)
    list(eng.generate(np.arange(64) % cfg.vocab_size, SamplingParams(max_tokens=2)))  # warm-up
    eng.reset_stats()
    rec = TargetRecorder(eng)
    prompts = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256)

    async def session():
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve_http(eng, SamplingParams(), "127.0.0.1", port,
                                              ready=ready, stop=stop, grace_s=30.0))
        await asyncio.wait_for(ready.wait(), 60)
        t0 = time.perf_counter()
        runs = await asyncio.gather(*(_sse(port, {
            "prompt": p.tolist(), "max_new": max_tokens, "request_id": f"req{i}",
            "tenant": TENANTS[i % 2][0], "weight": TENANTS[i % 2][1]})
            for i, p in enumerate(prompts)))
        wall = time.perf_counter() - t0
        out = {"runs": runs, "wall": wall}
        for path in ("/stats", "/stats/v2", "/metrics"):
            status, headers, payload = await _http(port, "GET", path)
            if not status.startswith("HTTP/1.1 200"):
                raise AssertionError(f"path (n): GET {path} gave {status}")
            out[path] = (headers["content-type"], payload.decode())
        stop.set()
        out["rc"] = await asyncio.wait_for(task, 120)
        return out

    TRACER.enable()
    torch.cuda.synchronize()
    reset_counts()
    res = asyncio.run(session())
    launches = dict(COUNTS)
    st = eng.stats
    rec.stop()
    trace_path = Path("chiprun_out") / "trace_frontend.json"
    trace_path.parent.mkdir(exist_ok=True)
    trace = TRACER.export_chrome_trace(str(trace_path))
    dropped = TRACER.dropped
    TRACER.disable()
    TRACER.clear()

    # the streams: whole, finished by length, and (i)'s or parting at a near tie
    streams, ttft = {}, {t: [] for t, _ in TENANTS}
    for i, (events, first, last) in enumerate(res["runs"]):
        rid = f"req{i}"
        if not events or not events[-1]["finished"] or events[-1]["finish_reason"] != "length":
            raise AssertionError(f"path (n): {rid} ended with {events[-1:]}")
        streams[rid] = [t for e in events for t in e["new_token_ids"]]
        ttft[TENANTS[i % 2][0]].append(first)
    check_served(eng, cfg, len(prompts), max_tokens)
    parted = check_near_ties(torch, "path (n) against (i)", streams, path_i["streams"], rec,
                             path_i["recorder"], lambda rid: SamplingParams())
    print(f"path (n): {len(streams) - len(parted)} of {len(streams)} streams over HTTP equal "
          f"(i)'s; {len(parted)} part at a near tie (scores within {TIE_TOL})")

    # /stats, /metrics, /stats/v2
    stats = json.loads(res["/stats"][1])
    fe = stats["frontend"]
    if not (fe["accepted"] == len(prompts) and fe["rejected"] == 0 and fe["open_streams"] == 0
            and fe["pending"] == 0):
        raise AssertionError(f"path (n): /stats frontend {fe}")
    if sorted(stats["tenants"]) != ["A", "B"] or any(
            stats["tenants"][t]["queue_wait_s"]["count"] != len(prompts) // 2 for t in "AB"):
        raise AssertionError(f"path (n): /stats tenants {stats['tenants']}")
    drift = json.loads(json.dumps(roofline_drift(eng, H100_SXM)))
    if stats["roofline_drift"] != drift or set(drift) != {"prefill", "decode"}:
        raise AssertionError(f"path (n): /stats roofline_drift {stats['roofline_drift']}")
    ctype, text = res["/metrics"]
    metrics = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            metrics[name] = float(value)
    bad = [(name, metrics.get(name), stats[attr]) for attr, name, _ in _STAT_COUNTERS
           if metrics.get(name) != float(stats[attr])]
    if ctype != PROMETHEUS_CONTENT_TYPE or bad or metrics["repro_frontend_accepted_total"] != 8:
        raise AssertionError(f"path (n): /metrics ({ctype}) differs from /stats: {bad}")
    v2 = json.loads(res["/stats/v2"][1])
    if v2.get("schema") != "v2" or v2["counters"]["repro_decode_tokens_total"] != st.decode_tokens:
        raise AssertionError("path (n): /stats/v2 does not parse to the registry")
    fins = {}
    for e in trace["traceEvents"]:
        if e["name"] == "req.finish":
            rid = e["args"]["request_id"]
            fins[rid] = fins.get(rid, 0) + 1
    if fins != {f"req{i}": 1 for i in range(len(prompts))} or res["rc"] != 0:
        raise AssertionError(f"path (n): finishes in the trace {fins}, server rc {res['rc']}")

    # the launches the stats imply: 168 B1 a chunk and a round, the walk 24 a round
    steps = st.decode_rounds + st.replayed_tokens
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": 7 * cfg.num_layers * (st.prefill_chunks + steps),
                   "act_quant": 7 * cfg.num_layers * (st.prefill_chunks + steps),
                   "prefill_attention": 0, "paged_decode_attention_quant": cfg.num_layers * steps})
    if launches != expect:
        raise AssertionError(f"path (n): launches {launches} != expected {expect}")

    i_p50, i_p99, _ = path_i["latency"]
    print(f"path (n) front end: {len(prompts)} SSE streams x {max_tokens} tokens over HTTP, "
          f"two tenants (A weight 1, B weight 3), SLO-aware policy (TTFT target "
          f"{SLO_LOOSE['ttft_target_s']} s, ITL {SLO_LOOSE['itl_target_s']} s), "
          f"{st.prefill_chunks} chunks, {st.decode_rounds} decode rounds, {st.sheds} shed, "
          f"{res['wall']:.2f} s wall  [{card}]")
    print(f"  {_grid_line(grid)}  [{card}]")
    for k, (t, w) in enumerate(TENANTS):
        v = sorted(ttft[t])
        mine = [eng.finished[f"req{i}"] for i in range(k, len(prompts), len(TENANTS))]
        e = sorted(r.first_token_t - r.arrival_time_s for r in mine)
        print(f"  tenant {t} (weight {w}): TTFT at the client p50 {statistics.median(v) * 1e3:.1f} "
              f"ms p99 {float(np.percentile(v, 99)) * 1e3:.1f} ms; the engine's TTFT p50 "
              f"{statistics.median(e) * 1e3:.1f} ms p99 {float(np.percentile(e, 99)) * 1e3:.1f} "
              f"ms, queue wait p50 {stats['tenants'][t]['queue_wait_s']['p50'] * 1e3:.1f} ms  "
              f"[{card}]")
    print(f"  engine TTFT p50 {st.ttft.percentile(50) * 1e3:.1f} ms p99 "
          f"{st.ttft.percentile(99) * 1e3:.1f} ms, decode {st.decode_tput():.1f} tok/s "
          f"({st.decode_round_cost() * 1e3:.2f} ms a round); path (i) in process: TTFT p50 "
          f"{i_p50:.1f} ms p99 {i_p99:.1f} ms, decode {path_i['tput']:.1f} tok/s  [{card}]")
    for phase, d in drift.items():
        print(f"  roofline drift [{phase}] against {H100_SXM.name}: measured "
              f"{d['measured_s_per_token'] * 1e6:.2f} us/token, bound "
              f"{d['bound_s_per_token'] * 1e6:.4f} us/token, residency "
              f"{d['residency_ratio']:.5f}  [{card}]")
    print(f"  /metrics: {len(_STAT_COUNTERS)} stat counters equal /stats; /stats/v2 parses; "
          f"trace: {len(trace['traceEvents'])} events ({dropped} dropped) -> "
          f"{trace_path}, each request finished once")
    # the front end's own time: the gaps between two engine steps (the
    # executor hop, routing the deltas, the SSE writes), from the trace
    steps = sorted((e["ts"], e["dur"]) for e in trace["traceEvents"] if e["name"] == "engine.step")
    gaps = sorted(b[0] - (a[0] + a[1]) for a, b in zip(steps, steps[1:]))
    busy = sum(d for _, d in steps)
    print(f"  front end between steps (trace): {len(steps)} steps, {busy / 1e3:.1f} ms in steps "
          f"of {(steps[-1][0] + steps[-1][1] - steps[0][0]) / 1e3:.1f} ms, gap median "
          f"{statistics.median(gaps) / 1e3:.3f} ms p90 {gaps[int(0.9 * len(gaps))] / 1e3:.3f} ms "
          f"max {gaps[-1] / 1e3:.3f} ms; "
          f"{sum(e['ph'] != 'M' for e in trace['traceEvents']) / len(steps):.1f} "
          f"trace events a step  [{card}]")
    print(f"  launches {launches}")

    # tracing costs no device operation
    prof = {}
    for on in (False, True, False, True):
        if on:
            TRACER.enable()
        try:
            wall_p, dev_p, _, per_round = profile_decode(torch, eng)
        finally:
            TRACER.disable()
            TRACER.clear()
        prof.setdefault(on, []).append((per_round, wall_p / 4 * 1e3,
                                        None if dev_p is None else dev_p / 4 * 1e3))
    if {r[0] for r in prof[True]} != {r[0] for r in prof[False]}:
        raise AssertionError(f"path (n): device operations a round with the tracer {prof[True]} "
                             f"against without {prof[False]}")
    for on in (False, True):
        print(f"  profile, tracer {'on' if on else 'off'}: " + "; ".join(
            f"{ops:.1f} device operations, {wall:.2f} ms wall, "
            + ("device not measured" if dev is None else f"{dev:.3f} ms device") + " a round"
            for ops, wall, dev in prof[on]) + f"  [{card}]")

    # a back-dated request is shed
    rng = np.random.default_rng(9)
    doomed = Request("doomed", rng.integers(0, cfg.vocab_size, 64).astype(np.int32), max_new=4)
    eng.submit(doomed)
    doomed.arrival_time_s -= 1e4
    outs = eng.step()
    if [(o.request_id, o.finish_reason) for o in outs] != [("doomed", "shed")] or st.sheds != 1:
        raise AssertionError(f"path (n): the back-dated request gave {outs}, sheds {st.sheds}")

    # a drain with grace 0 cuts an open stream
    async def drain():
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve_http(eng, SamplingParams(), "127.0.0.1", port,
                                              ready=ready, stop=stop, grace_s=0.0))
        await asyncio.wait_for(ready.wait(), 60)
        reader = asyncio.create_task(_sse(port, {"prompt": list(range(3, 19)), "max_new": 1000,
                                                 "request_id": "long"}))
        while not (eng.scheduler.inflight or reader.done()):
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.2)  # a few rounds of it
        stop.set()
        events, _, _ = await asyncio.wait_for(reader, 120)
        return events, await asyncio.wait_for(task, 120)

    events, rc = asyncio.run(drain())
    n = sum(len(e["new_token_ids"]) for e in events)
    if not (events and events[-1]["finish_reason"] == "abort" and 0 < n < 1000 and rc == 0):
        raise AssertionError(f"path (n): the drain with grace 0 ended the stream with "
                             f"{events[-1:]} after {n} tokens")
    live = eng.runner.paged.pool.num_live
    if live or eng.has_unfinished():
        raise AssertionError(f"path (n): {live} live pages after the drain")
    print(f"path (n): a request back-dated by 1e4 s is shed (finish_reason 'shed'); a drain "
          f"with grace 0 cuts an open 1000-token stream after {n} tokens with 'abort', 0 live "
          f"pages after  [{card}]")
    return launches


def cli_phase(torch, np, card, want=None, arch="bitnet-730m"):
    """Path (o): ``repro_torch.launch.serve.main`` in batch mode at full
    width (``arch``, 4 requests of 32 tokens, 8 new, max_len 128,
    contiguous bf16, pdswap), the JAX CLI's latent weights drawn from
    ``--seed 0`` on the card.  Its printed tokens must equal an
    ``EngineCore`` run on the same weights, and it must run B1 (ternary
    archs), B2 and B3 as often as its run implies.  Given ``want`` ((o)'s
    printed tokens), it runs again with ``--disagg``: the same tokens, the
    same launches (B1 on the prefill pool's stream too), and the ``KV
    handoff`` line.  Returns (its launches, its printed tokens)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch import serve as S
    from repro_torch.models.jax_init import init_like_jax
    from repro_torch.serving import EngineCore, SamplingParams

    argv = ["--arch", arch, "--requests", "4", "--prompt-len", "32", "--max-new", "8",
            "--max-len", "128", "--seed", "0"] + (["--disagg"] if want is not None else [])
    tag = ("(o)" if want is None else "(o) --disagg") + (
        "" if arch == "bitnet-730m" else f" {arch}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = S.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(COUNTS)
    text = buf.getvalue()
    print(f"path {tag}: python -m repro_torch.launch.serve " + " ".join(argv) + f"  ({wall:.2f} "
          f"s wall, weights drawn on the card and the serving grid included)  [{card}]")
    print("\n".join("  | " + ln for ln in text.strip().splitlines()))
    printed = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("req-"):
            rid, _, toks = line.partition(": ")
            printed[rid] = json.loads(toks.rstrip("."))
    if rc != 0 or "requests finished : 4/4" not in text or len(printed) != 3:
        raise AssertionError(f"path {tag}: rc {rc}, printed {printed}")
    cfg = get_config(arch)
    if want is None:
        args = S.parse_args(argv)
        eng = EngineCore(cfg, init_like_jax(cfg, 0, "cuda", draw_device="cuda"), n_slots=4,
                         max_len=128, prompt_len=32, device="cuda")
        for r in S.batch_requests(args, cfg, SamplingParams()):
            eng.submit(r)
        eng.run()
        want = {rid: eng.finished[rid].out_tokens for rid in printed}
        against = "an EngineCore on the same weights"
    else:
        against = "(o)"
        handoff = [ln.strip() for ln in text.splitlines() if "KV handoff" in ln]
        if len(handoff) != 1 or "4 segments (0 eager)" not in handoff[0]:
            raise AssertionError(f"path {tag}: the KV handoff line is {handoff}")
    if printed != want:
        raise AssertionError(f"path {tag}: the CLI printed {printed}, {against} gives {want}")
    # 4 prefills in one burst, 7 decode rounds (the first token is the
    # prefill's), and the serving grid's one idle decode round
    passes, rounds = 4 + 7 + 1, 7 + 1
    linears = 7 * cfg.num_layers if cfg.quant.ternary else 0
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": linears * passes, "act_quant": linears * passes,
                   "prefill_attention": cfg.num_layers * 4,
                   "decode_attention": cfg.num_layers * rounds})
    if launches != expect:
        raise AssertionError(f"path {tag}: launches {launches} != expected {expect}")
    print(f"path {tag}: the CLI's tokens equal {against}'s; launches "
          f"{launches} (B1 {linears} a pass: 4 prefills, 7 decode rounds, the grid's idle round; "
          f"B2 {cfg.num_layers} a prefill; B3 {cfg.num_layers} a round)")
    return launches, printed


# ---- the disaggregated pools: paths (p), (q) and the interference phase --

LONG = 1536  # the interference phase's arriving prompts
SHORT = 64  # its decoding streams' prompts


def disagg_phase(torch, np, cfg, params, max_tokens, path_i, main_streams, card):
    """Paths (p) and (q) and the interference phase, at full width.  (p):
    ``DisaggEngine`` with (i)'s configuration (paged int8, 512 pages,
    256-token chunks) on (d)'s 8 prompts, its grid built first for both
    pools: the streams (i)'s up to near ties, every chunk shipped and
    installed (none discarded or pending), B1 as often as the stats imply
    (on the prefill pool's thread too), no B2, TTFT and the largest ITL
    beside (i)'s.  (q): ``DisaggEngine``, contiguous bf16, pdswap with the
    overlapped swap, monolithic prefill: the main path's tokens exactly, B1,
    B2 and B3 as the stats imply, the relay, the ship and the install timed
    with CUDA events.  Then the interference phase on (i)'s colocated
    engine and on (p)'s.  Returns the launches of (p) and (q)."""
    from repro_torch.serving import DisaggEngine, SamplingParams
    from repro_torch.serving.disagg import decode_pool

    paged8 = dict(cache_layout="paged", kv_dtype="int8", mode="pdswap", block_size=16,
                  n_slots=4, max_len=2048)
    shared = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256)
    rec, ho0 = [], []

    def on_p(e):
        rec.append(TargetRecorder(e))
        ho0.append(e.handoff.snapshot())  # after the warm-up's one chunk

    eng, st, wall, launches, prefills, events, grid = serve(
        cfg, params, shared, max_tokens, on_engine=on_p, engine_cls=DisaggEngine,
        prefill_chunk=CHUNK, **paged8)
    rec[0].stop()
    check_served(eng, cfg, len(shared), max_tokens)
    check_chunked(cfg, shared, st, events, tag="(p)")
    streams = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(shared))}
    parted = check_near_ties(torch, "path (p) against (i)", streams, path_i["streams"], rec[0],
                             path_i["recorder"], lambda rid: SamplingParams())
    steps = st.decode_rounds + st.replayed_tokens
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": 7 * cfg.num_layers * (st.prefill_chunks + steps),
                   "act_quant": 7 * cfg.num_layers * (st.prefill_chunks + steps),
                   "prefill_attention": 0,
                   "paged_decode_attention_quant": cfg.num_layers * steps})
    if prefills or launches != expect:
        raise AssertionError(f"path (p): launches {launches} != expected {expect} ({prefills} "
                             f"monolithic prefills, {st.prefill_chunks} chunks, {steps} rounds)")
    ho = eng.snapshot()["disagg"]["handoff"]
    run = {k: ho[k] - ho0[0][k] for k in ("segments", "eager_segments", "bytes_shipped",
                                          "installs", "discarded")}
    eager = st.prefill_chunks - len(shared)
    if (run["segments"], run["eager_segments"], run["installs"], run["discarded"],
            ho["pending"]) != (st.prefill_chunks, eager, st.prefill_chunks, 0, 0):
        raise AssertionError(f"path (p): handoff {ho} (before the run {ho0[0]})")
    p50, p99, itl_max = _latency(st)
    i50, i99, i_max = path_i["latency"]
    print(f"path (p) DisaggEngine, (i)'s configuration (paged int8, 512 pages, {CHUNK}-token "
          f"chunks on the prefill pool's stream and thread): {len(shared)} requests x "
          f"{max_tokens} tokens, {st.prefill_chunks} chunks, {st.decode_rounds} decode rounds, "
          f"{wall:.2f} s wall  [{card}]")
    print(f"  {len(streams) - len(parted)} of {len(streams)} streams equal (i)'s; {len(parted)} "
          f"part at a near tie (scores within {TIE_TOL})")
    print(f"  handoff: {run['segments']} segments ({run['eager_segments']} eager), "
          f"{run['bytes_shipped'] / 2**20:.1f} MiB shipped, {run['installs']} installs, "
          f"{run['discarded']} discarded, {ho['pending']} pending; ship dispatch "
          f"{ho['t_dispatch_s'] * 1e3:.3f} ms on the host in all  [{card}]")
    print(f"  TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms, largest ITL {itl_max:.1f} ms; (i): TTFT "
          f"p50 {i50:.1f} p99 {i99:.1f}, largest ITL {i_max:.1f} ms; decode "
          f"{st.decode_tput():.1f} tok/s against (i)'s {path_i['tput']:.1f}  [{card}]")
    print(f"  {_grid_line(grid)} (both pools)  [{card}]")
    print(f"  launches {launches}")
    total = dict(launches)

    # (q): contiguous bf16, pdswap, the swap overlapped, monolithic prefill
    prompts = make_prompts(np, cfg, PROMPT_LENS)
    marks = {"relay": [], "ship": [], "install": []}

    def timed(fn, sink):
        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            sink.append((a, b))
            return out
        return run

    install = decode_pool.install_relayed_kv

    def on_q(e):
        for key, prog in e.prefill_pool.engine.programs.items():
            if key.startswith("relay:"):
                prog.fn = timed(prog.fn, marks["relay"])
        e.handoff.ship = timed(e.handoff.ship, marks["ship"])
        decode_pool.install_relayed_kv = timed(install, marks["install"])

    try:
        eng_q, st_q, wall_q, launches_q, prefills_q, _, grid_q = serve(
            cfg, params, prompts, max_tokens, on_engine=on_q, engine_cls=DisaggEngine,
            n_slots=4, max_len=2048, mode="pdswap", overlap=True)
    finally:
        decode_pool.install_relayed_kv = install
    check_served(eng_q, cfg, len(prompts), max_tokens)
    got = {f"req{i}": eng_q.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
    if got != main_streams:
        raise AssertionError("path (q): the tokens differ from the main path's")
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": 7 * cfg.num_layers * (prefills_q + st_q.decode_rounds),
                   "act_quant": 7 * cfg.num_layers * (prefills_q + st_q.decode_rounds),
                   "prefill_attention": cfg.num_layers * prefills_q,
                   "decode_attention": cfg.num_layers * st_q.decode_rounds})
    if prefills_q != len(prompts) or launches_q != expect:
        raise AssertionError(f"path (q): launches {launches_q} != expected {expect}")
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in marks.items()}
    if any(len(v) != len(prompts) for v in ms.values()):
        raise AssertionError(f"path (q): timed {({k: len(v) for k, v in ms.items()})} of "
                             f"{len(prompts)} swaps")
    seg = eng_q.snapshot()["disagg"]["handoff"]
    hidden = [t.hidden_fraction for t in st_q.swap_timings]
    print(f"path (q) DisaggEngine, contiguous bf16, pdswap with the overlapped swap, monolithic "
          f"prefill on the prefill pool's stream: {len(prompts)} requests x {max_tokens} "
          f"tokens, {st_q.decode_rounds} decode rounds, {wall_q:.2f} s wall; the main path's "
          f"tokens exactly  [{card}]")
    print(f"  swap across the pools, a prompt (CUDA events, mean / max over {len(prompts)}): "
          f"relay {statistics.mean(ms['relay']):.3f} / {max(ms['relay']):.3f} ms, ship "
          f"{statistics.mean(ms['ship']):.4f} / {max(ms['ship']):.4f} ms, install "
          f"{statistics.mean(ms['install']):.3f} / {max(ms['install']):.3f} ms; "
          f"{seg['bytes_shipped'] / seg['segments'] / 2**20:.1f} MiB a segment (f32, "
          f"max_len rows); hidden fraction mean {statistics.mean(hidden):.3f}  [{card}]")
    print(f"  TTFT p50 {st_q.ttft.percentile(50) * 1e3:.1f} ms, decode "
          f"{st_q.decode_tput():.1f} tok/s ({st_q.decode_round_cost() * 1e3:.2f} ms/round)  "
          f"[{card}]")
    print(f"  launches {launches_q}")
    for name, n in launches_q.items():
        total[name] += n
    del eng_q

    del eng
    # (i)'s and (p)'s configurations with 6 slots: the 4 streams and the 2 arrivals
    from repro_torch.serving import EngineCore

    for label, cls in (("(i) colocated", EngineCore), ("(p) disaggregated", DisaggEngine)):
        e = cls(cfg, params, device="cuda", prefill_chunk=CHUNK, **dict(paged8, n_slots=6))
        grid = build_grid(torch, e)
        list(e.generate(np.arange(64) % cfg.vocab_size, SamplingParams(max_tokens=2)))
        interference(torch, np, cfg, e, f"{label}, 6 slots", grid, card)
        del e
    return total


def interference(torch, np, cfg, eng, label, grid, card, base_steps: int = 16):
    """4 greedy streams of ``SHORT``-token prompts decode alone (the
    baseline), then while two ``LONG``-token prompts arrive and prefill in
    ``CHUNK``-token chunks.  Prints each phase's ITL p50 / p95 (a step's
    wall: the round's tokens are read at its end) and their ratio, the
    decode rounds that completed, by CUDA events, while a chunk was in
    flight on the prefill pool's stream, and the device operations of a
    round with and without a chunk in flight (profiled again, apart from
    the timed steps)."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(11)
    runner = eng.runner
    for i in range(4):
        eng.submit(Request(f"itf.{label[:3]}.{i}", rng.integers(0, 32000, SHORT).astype(np.int32),
                           max_new=400))
    while eng.scheduler.queue or eng._prefilling:
        eng.step()

    def timed_steps(n=None):
        walls = []
        while (eng.scheduler.queue or eng._prefilling) if n is None else len(walls) < n:
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        return walls

    base = timed_steps(base_steps)
    ops_alone, engine_stream = _stream_ops(torch, eng, 4, f"{label[1]}_alone")

    # CUDA events: each round on the engine's stream, each chunk where it ran
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    rounds, chunks, restore = [], [], []

    def marked(obj, name, sink):
        """Events on the current stream before and after each call."""
        fn = getattr(obj, name)

        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            sink.append((a, b))
            return out

        setattr(obj, name, run)
        restore.append((obj, name))

    marked(runner, "decode_logits", rounds)
    pool = getattr(eng, "prefill_pool", None)
    if pool is None:  # colocated: the chunk runs on the engine's stream
        marked(runner, "run_prefill_chunk", chunks)
    else:  # the chunk's start (after its upload) and end (its ship), on the pool's stream
        starts, ends = [], []
        marked(pool, "stage_chunk", starts)
        marked(eng.handoff, "ship", ends)
    for j in range(2):
        eng.submit(Request(f"itf.{label[:3]}.long{j}",
                           rng.integers(0, 32000, LONG).astype(np.int32), max_new=2))
    loaded = timed_steps()
    torch.cuda.synchronize()
    for obj, name in restore:
        delattr(obj, name)
    if pool is not None:  # the chunk: from its upload's end to its ship's start
        chunks = [(a[1], b[0]) for a, b in zip(starts, ends)]
    at = lambda e: ref.elapsed_time(e)  # noqa: E731
    spans = [(at(a), at(b)) for a, b in chunks]
    inside = sum(any(s < at(b) < e for s, e in spans) for _, b in rounds)
    if len(chunks) != 2 * LONG // CHUNK:
        raise AssertionError(f"interference {label}: {len(chunks)} chunks timed")

    for j in range(2):  # the profile with chunks in flight, apart from the timed steps
        eng.submit(Request(f"itf.{label[:3]}.prof{j}",
                           rng.integers(0, 32000, LONG).astype(np.int32), max_new=2))
    ops_loaded, _ = _stream_ops(torch, eng, 4, f"{label[1]}_loaded", engine_stream)
    while eng.scheduler.queue or eng._prefilling:
        eng.step()
    for slot, req in list(eng.scheduler.inflight.items()):
        eng.abort(req.request_id)

    b50, b95 = (np.percentile(base, 50) * 1e3, np.percentile(base, 95) * 1e3)
    l50, l95 = (np.percentile(loaded, 50) * 1e3, np.percentile(loaded, 95) * 1e3)
    print(f"interference {label}: 4 greedy streams of {SHORT}-token prompts; alone ITL p50 "
          f"{b50:.2f} ms p95 {b95:.2f} ms ({len(base)} rounds); while two {LONG}-token prompts "
          f"prefill in {CHUNK}-token chunks ITL p50 {l50:.2f} ms p95 {l95:.2f} ms ({len(loaded)} "
          f"steps, {len(rounds)} rounds, {len(chunks)} chunks); ratio p50 {l50 / b50:.3f} p95 "
          f"{l95 / b95:.3f}  [{card}]")
    print(f"  decode rounds completed while a chunk was in flight (CUDA events): {inside} of "
          f"{len(rounds)}; chunks' device spans {sum(e - s for s, e in spans):.1f} ms in all  "
          f"[{card}]")
    print(f"  device operations a step on the engine's stream: {ops_alone[0]:.1f} alone (a "
          f"round), {ops_loaded[0]:.1f} with chunks arriving (a round"
          f"{' and a chunk' if pool is None else ''}); on other streams {ops_loaded[1]:.1f} a "
          f"step (the prefill pool's chunks)  [{card}]")
    print(f"  {_grid_line(grid)}  [{card}]")


def _stream_ops(torch, eng, steps, name, engine_stream=None):
    """Device operations (kernels, copies, sets) a step over ``steps`` steps
    under ``torch.profiler``, read from the Chrome trace (its ``stream``
    argument).  Returns ((on the engine's stream, on every other), the
    engine's stream id): ``engine_stream``, or where given none the stream
    with the most operations (run with decode rounds alone)."""

    pool = getattr(eng, "prefill_pool", None)
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
        for _ in range(steps):
            eng.step()
        if pool is not None:  # the chunks these steps dispatched, all launched
            pool.quiesce()
        torch.cuda.synchronize()
    path = Path("build") / f"trace_interference_{name}.json"  # read, then removed
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    by_stream = {}
    for _, _, e in _kept_ops([(e["name"], e["ts"], e) for e in events
                              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]):
        sid = e.get("args", {}).get("stream")
        by_stream[sid] = by_stream.get(sid, 0) + 1
    if not by_stream:
        raise AssertionError(f"interference: the profiler saw no device operation ({name})")
    if engine_stream is None:
        engine_stream = max(by_stream, key=by_stream.get)
    on_engine = by_stream.get(engine_stream, 0)
    return (on_engine / steps, (sum(by_stream.values()) - on_engine) / steps), engine_stream


# ---- the transformer family: paths (r)-(v) --

# the served logits at cut depth against the CPU plain versions, as a share of
# max |logit|: both run bf16 weights and activations, whose products round to
# bf16 after an f32 sum taken in another order on each device (and an MoE
# router can route a near tie the other way); measured at most 0.0244
# (granite's two-chunk prefill) on an H100 80GB HBM3 at 700 W; twice that
FAMILY_TOL = 0.05
FAMILY_V = (("smollm-135m", None), ("deepseek-7b", None), ("minicpm-2b", None),
            ("chameleon-34b", 8), ("moonshot-v1-16b-a3b", 12))  # (arch, depth cut to)
FAMILY_V_PROMPT, FAMILY_V_NEW = 300, 8


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _eager_graph_runs(torch, np, eng, prompts, tag, max_new):
    """The same greedy requests run eager, graph, graph, eager on one engine
    whose grid is built (eager: the decode program's ``fn`` in its place).
    Raises unless the four runs give the same tokens; returns them."""
    from repro_torch.serving import Request

    graph = eng.runner.decode_prog
    streams = []
    for i, mode in enumerate(("eager", "graph", "graph", "eager")):
        eng.runner.decode_prog = _Eager(graph) if mode == "eager" else graph
        ids = [f"{tag}.{i}.{j}" for j in range(len(prompts))]
        for rid, prompt in zip(ids, prompts):
            eng.submit(Request(rid, prompt, max_new=max_new))
        eng.run()
        streams.append([eng.finished[r].out_tokens for r in ids])
    eng.runner.decode_prog = graph
    if any(st != streams[0] for st in streams):
        raise AssertionError(f"path {tag}: eager and graph runs give other tokens: {streams}")
    return streams[0]


def family_path(torch, np, key, what, cfg, params, prompts, max_tokens, card, eager_graph=True,
                **kw):
    """One served path of the family phase: ``serve`` (the grid built
    first), the launches held to the stats (B2 a layer a monolithic
    prefill, the path's walk a layer a decode round and replayed token, no
    B1 and no act-quant on a bf16 arch), a decode profile, TTFT p50 / p99,
    decode tok/s, peak device memory; then, unless told not to, 4 requests
    of 256-token prompts eager, graph, graph, eager with the same tokens.
    Returns (engine, stats, launches)."""
    eng, st, wall, launches, prefills, events, grid = serve(cfg, params, prompts, max_tokens, **kw)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_served(eng, cfg, len(prompts), max_tokens)
    paged, quant = kw.get("cache_layout") == "paged", kw.get("kv_dtype", "fp") != "fp"
    kernel = ("paged_" if paged else "") + "decode_attention" + ("_quant" if quant else "")
    steps = st.decode_rounds + st.replayed_tokens
    linears = 7 * cfg.num_layers * (prefills + st.prefill_chunks + steps) if cfg.quant.ternary else 0
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": linears, "act_quant": linears,
                   "prefill_attention": cfg.num_layers * prefills,
                   kernel: cfg.num_layers * steps})
    if launches != expect:
        raise AssertionError(f"path ({key}): launches {launches} != expected {expect} "
                             f"({prefills} prefills, {st.prefill_chunks} chunks, "
                             f"{st.decode_rounds} decode rounds, {st.replayed_tokens} replayed)")
    if kw.get("prefill_chunk"):
        check_chunked(cfg, prompts, st, events, f"({key})")
    p50, p99, itl_max = _latency(st)
    print(f"path ({key}) {what}: {len(prompts)} requests x {max_tokens} tokens, {prefills} "
          f"prefills, {st.prefill_chunks} chunks, {st.decode_rounds} decode rounds, {wall:.2f} s "
          f"wall  [{card}]")
    print(f"  TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms  largest ITL {itl_max:.1f} ms  decode "
          f"{st.decode_tput():.1f} tok/s ({st.decode_round_cost() * 1e3:.2f} ms/round)  peak "
          f"device memory {peak_gib:.2f} GiB  [{card}]")
    print(f"  {_grid_line(grid)}  [{card}]")
    print(f"  launches {launches} (B2 {cfg.num_layers} a monolithic prefill, {kernel} "
          f"{cfg.num_layers} a decode round)")
    wall_p, dev_p, top, per_round = profile_decode(torch, eng)
    if dev_p is None:
        print("  profile: the profiler saw no device time; device busy share not measured")
    else:
        print(f"  profile: 4 decode rounds (4 greedy slots, 256-token prompts): "
              f"{wall_p * 1e3:.1f} ms wall, {per_round:.1f} device operations a round, "
              f"{dev_p / 4 * 1e3:.3f} ms device time a round, device busy {dev_p / wall_p:.3f}  "
              f"[{card}]")
        for name, sec, calls in top[:6]:
            print(f"    {sec * 1e3:9.3f} ms  {calls:6d} calls  {name[:90]}")
    if eager_graph:
        rng = np.random.default_rng(12)
        eg = [rng.integers(0, cfg.vocab_size, 256).astype(np.int32) for _ in range(4)]
        _eager_graph_runs(torch, np, eng, eg, f"({key})", 8)
        print(f"path ({key}): 4 requests of 256-token prompts run eager, graph, graph, eager give "
              "the same tokens")
    return eng, st, launches


def family_references(torch, T, cfg, key, chunked=False):
    """The served model's logits at full width and cut depth (2 layers, bf16
    weights from seed 1) on the card against the CPU plain versions:
    a monolithic prefill, or (``chunked``) one paged int8 decode step and a
    two-chunk prefill.  Prints each error beside max |logit|."""
    import numpy as np

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p_gpu = T.init(cfg2, seed=1, device="cuda")
    p_cpu = _to_cpu(p_gpu)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 96))).long()
    lg, _ = T.forward_prefill(p_gpu, tokens.cuda(), cfg2, last_pos=80)
    lc, kv_c = T.forward_prefill(p_cpu, tokens, cfg2, last_pos=80)
    err, scale = (lg.float().cpu() - lc.float()).abs().max().item(), lc.float().abs().max().item()
    if not (torch.isfinite(lg).all() and lg.shape == (1, cfg.padded_vocab())
            and err <= FAMILY_TOL * max(scale, 1.0)):
        raise AssertionError(f"path ({key}): 2-layer prefill logits differ from the CPU plain "
                             f"path by {err} (max |logit| {scale})")
    print(f"reference ({key}): full-width 2-layer {cfg.name} prefill logits vs CPU plain versions: "
          f"max abs err {err:.3g} (max |logit| {scale:.3g}, {err / max(scale, 1.0):.3g} of it)")
    if chunked:
        for what, err, scale in decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng,
                                                  cases=(("paged", "int8"),), tol=FAMILY_TOL):
            print(f"reference ({key}): full-width 2-layer {what} decode logits vs CPU plain "
                  f"versions: max abs err {err:.3g} (max |logit| {scale:.3g})")
        err, scale = chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens, tol=FAMILY_TOL)
        print(f"reference ({key}): full-width 2-layer chunked prefill (2 chunks, int8 cache) "
              f"logits vs CPU plain versions: max abs err {err:.3g} (max |logit| {scale:.3g})")
    return p_gpu, p_cpu


def moe_drops(torch, T, cfg, params, tokens, dev):
    """Expert assignments dropped in each layer (capacity of a ``CHUNK``-row
    chunk) while the first ``CHUNK``-token chunk of ``tokens`` runs through
    ``prefill_chunk`` on ``dev``, eagerly, into an int8 cache."""
    from repro_torch.layers import moe as M
    from repro_torch.layers.attention import KVCache

    drops, route = [], M._route

    def counting(gate_logits, k, capacity, num_experts):
        out = route(gate_logits, k, capacity, num_experts)
        drops.append(int((out[1] == num_experts * capacity).sum()))
        return out

    shape = (cfg.num_layers, 1, cfg.num_kv_heads, 2 * CHUNK, cfg.head_dim)
    prefix = KVCache(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
    cache = T.init_cache(cfg, 1, 2 * CHUNK, kv_dtype="int8", device=dev)
    M._route = counting
    try:
        T.prefill_chunk(params, tokens[:, :CHUNK].to(dev), cache, prefix, 0, 0, CHUNK - 1, cfg,
                        prefix_width=CHUNK)
    finally:
        M._route = route
    return drops


def family_phase(torch, np, card):
    """Phase 10, the transformer family at full width on bf16 weights from
    seed 0, each model's engine and weights freed before the next: (r)
    qwen2.5-14b at full depth, contiguous bf16, pdswap, (d)'s 8 prompts,
    32 new tokens; (s) its weights on a paged int8 pool of 512 pages of 16
    with 256-token chunks; (t) granite-moe-3b-a800m as (r) and (u) as (s),
    with the experts' dropped assignments in the first chunk of the
    1,536-token prompt; (v) the other five archs on one 300-token prompt,
    8 new tokens (chameleon-34b and moonshot-v1-16b-a3b at cut depth).
    Returns the launches summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    max_tokens, eng_kw = 32, dict(n_slots=4, max_len=2048, mode="pdswap", overlap=True)
    paged_kw = dict(eng_kw, cache_layout="paged", kv_dtype="int8", block_size=16,
                    prefill_chunk=CHUNK)
    for key, chunk_key, arch in (("r", "s", "qwen2.5-14b"), ("t", "u", "granite-moe-3b-a800m")):
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"path ({key}) {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads x {cfg.head_dim} over {cfg.num_kv_heads} KV heads, "
              + (f"{cfg.num_experts} experts top-{cfg.top_k} of {cfg.moe_d_ff}, " if cfg.moe
                 else f"d_ff {cfg.d_ff}, ") + f"vocab {cfg.vocab_size} (padded "
              f"{cfg.padded_vocab()}); bf16 weights from seed 0: {nbytes / 1e9:.2f} GB, drawn in "
              f"{time.perf_counter() - t0:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB  [{card}]")
        prompts = make_prompts(np, cfg, PROMPT_LENS)
        eng, _, launches = family_path(torch, np, key, f"{arch}, contiguous bf16, pdswap", cfg,
                                       params, prompts, max_tokens, card, **eng_kw)
        add(launches)
        del eng
        _free(torch)
        family_references(torch, T, cfg, key)
        eng, _, launches = family_path(
            torch, np, chunk_key, f"{arch}, paged int8, 512 pages, {CHUNK}-token chunks", cfg,
            params, prompts, max_tokens, card, eager_graph=False, **paged_kw)
        add(launches)
        del eng
        _free(torch)
        p_gpu, p_cpu = family_references(torch, T, cfg, chunk_key, chunked=True)
        if cfg.moe:
            longest = torch.from_numpy(prompts[PROMPT_LENS.index(1536)][None]).long()
            cfg2 = dataclasses.replace(cfg, num_layers=2)
            plain = moe_drops(torch, T, cfg2, p_cpu, longest, "cpu")
            card2 = moe_drops(torch, T, cfg2, p_gpu, longest, "cuda")
            full = moe_drops(torch, T, cfg, params, longest, "cuda")
            cap = max(8, int(CHUNK * cfg.top_k / cfg.num_experts * cfg.moe_capacity_factor))
            print(f"path ({chunk_key}): assignments dropped in the first {CHUNK}-token chunk of the "
                  f"1,536-token prompt ({CHUNK} x top-{cfg.top_k} over {cfg.num_experts} experts of "
                  f"capacity {cap}), by layer: plain version at 2 layers {plain}, the card at 2 "
                  f"layers {card2}; the engine's chunk at {cfg.num_layers} layers on the card "
                  f"{sum(full)} in all ({full})")
        del params, p_gpu, p_cpu
        _free(torch)
    for arch, depth in FAMILY_V:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        params = T.init(cfg, seed=0, device="cuda")
        prompts = make_prompts(np, cfg, [FAMILY_V_PROMPT])
        cut = f"{depth} of {get_config(arch).num_layers} layers" if depth else "full depth"
        eng, st, wall, launches, prefills, _, grid = serve(
            cfg, params, prompts, FAMILY_V_NEW, n_slots=2, max_len=512, mode="pdswap",
            overlap=True)
        check_served(eng, cfg, 1, FAMILY_V_NEW)
        expect = {name: 0 for name in DECODE_KERNELS}
        expect.update({"tlmm": 0, "act_quant": 0, "prefill_attention": cfg.num_layers * prefills,
                       "decode_attention": cfg.num_layers * st.decode_rounds})
        if launches != expect:
            raise AssertionError(f"path (v) {arch}: launches {launches} != expected {expect}")
        graph_tokens = eng.finished["req0"].out_tokens
        eager = _eager_graph_runs(torch, np, eng, prompts, f"(v) {arch}", FAMILY_V_NEW)
        if eager[0] != graph_tokens:
            raise AssertionError(f"path (v) {arch}: eager and graph runs give other tokens")
        print(f"path (v) {arch} at full width, {cut}: one {FAMILY_V_PROMPT}-token prompt, "
              f"{FAMILY_V_NEW} new tokens, {st.decode_rounds} decode rounds, {wall:.2f} s wall; "
              f"eager = graph tokens {graph_tokens}; launches {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        add(launches)
        del eng, params
        _free(torch)
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens, tol=1e-3):
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
    err, scale = (out[0] - out[1]).abs().max().item(), out[1].abs().max().item()
    if not err <= tol * max(scale, 1.0):
        raise AssertionError(f"full-width chunked prefill logits differ from the CPU plain path by "
                             f"{err} (max |logit| {scale})")
    return err, scale


DECODE_REFERENCE_CASES = (("contiguous", "int8"), ("contiguous", "int4"), ("paged", "fp"),
                          ("paged", "int8"), ("paged", "int4"))


def decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng, cases=DECODE_REFERENCE_CASES,
                      tol=1e-3):
    """One decode step of the full-width 2-layer model over a quantized
    cache (int8, int4) and a paged pool (bf16, int8, int4) holding the same
    prompt KV, on the card against the CPU plain versions.  Yields (what,
    max abs err, max |logit|)."""
    from repro_torch.core.kv_cache import insert_prefill_kv
    from repro_torch.layers.attention import KVCache, write_prefill_pages_q

    s = kv_c.k.shape[3]  # 96 prompt positions: 6 pages of 16
    token = torch.from_numpy(rng.integers(0, cfg2.vocab_size, (2,))).long()
    lengths = torch.tensor([s, 48], dtype=torch.int32)
    for layout, kv_dtype in cases:
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
        if not (torch.isfinite(out[0]).all() and err <= tol * max(scale, 1.0)):
            raise AssertionError(f"full-width {what} decode logits differ from the CPU plain path "
                                 f"by {err} (max |logit| {scale})")
        yield what, err, scale


def verify_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng):
    """One verify pass (W = 5) of the full-width 2-layer model over a
    contiguous int8 cache and a paged int8 pool holding the same prompt KV,
    slot 0 with a full block, slot 1 with 3 real rows, on the card against
    the CPU port on the same weights, cache and tokens, held to
    ``decode_references``'s tolerance on the real rows.  Yields (what, max
    abs err, max |logit|)."""
    from repro_torch.core.kv_cache import insert_prefill_kv
    from repro_torch.layers.attention import KVCache, write_prefill_pages_q

    s = kv_c.k.shape[3]
    tokens = torch.from_numpy(rng.integers(0, cfg2.vocab_size, (2, SPEC_K + 1))).int()
    lengths = torch.tensor([s, 48], dtype=torch.int32)
    n_tokens = torch.tensor([SPEC_K + 1, 3], dtype=torch.int32)
    for layout in ("contiguous", "paged"):
        out = []
        for dev, params in ((p_gpu["emb"].device, p_gpu), ("cpu", p_cpu)):
            kv = KVCache(*(a.to(dev) for a in kv_c))
            args = (tokens.to(dev),)
            if layout == "contiguous":
                cache = T.init_cache(cfg2, 2, 128, kv_dtype="int8", device=dev)
                for slot in range(2):
                    insert_prefill_kv(cache, kv, slot)
                logits, _ = T.verify(params, *args, cache, lengths.to(dev), n_tokens.to(dev), cfg2)
            else:
                pool = T.init_paged_pool(cfg2, 16, 16, kv_dtype="int8", device=dev)
                ids = torch.tensor([9, 3, 14, 0, 7, 11], dtype=torch.int32)
                pool = KVCache(*(write_prefill_pages_q(p, a, ids, block_size=16)
                                 for p, a in zip(pool, kv)))
                tables = torch.tensor([[9, 3, 14, 0, 7, 11, 5, 0], [9, 3, 14, 13, 0, 0, 0, 0]],
                                      dtype=torch.int32, device=dev)
                logits, _ = T.verify_paged(params, *args, pool, tables, lengths.to(dev),
                                           n_tokens.to(dev), cfg2)
            out.append(torch.cat([logits[b, :int(n)].float().cpu()
                                  for b, n in enumerate(n_tokens)]))
        err = (out[0] - out[1]).abs().max().item()
        scale = out[1].abs().max().item()
        what = f"{layout} int8 verify (W={SPEC_K + 1})"
        if not (torch.isfinite(out[0]).all() and err <= 1e-3 * max(scale, 1.0)):
            raise AssertionError(f"full-width {what} logits differ from the CPU port by {err} "
                                 f"(max |logit| {scale})")
        yield what, err, scale


def verify_against_decode(torch, T, cfg, params, rng):
    """A verify pass of the full-depth model (W = 5, every row real) over a
    contiguous int8 cache holding 4 prefilled prompts, against 5 decode
    steps teacher-forcing the same tokens on a copy of the cache, on the
    card: the cache bytes equal and each row's logits within 1e-4 (every
    layer's arithmetic gives decode's bits; the logits product alone runs
    at M = 20 against M = 4).  Returns (max abs err, max |logit|)."""
    from repro_torch.core.kv_cache import insert_prefill_kv

    lens = [300, 517, 1300, 900]
    cache = T.init_cache(cfg, 4, 2048, kv_dtype="int8", device="cuda")
    for slot, n in enumerate(lens):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
        insert_prefill_kv(cache, T.forward_prefill(params, toks, cfg)[1], slot)
    steps = type(cache)(*(type(leaf)(*(t.clone() for t in leaf)) for leaf in cache))
    w = SPEC_K + 1
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, w))).int().cuda()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    logits, _ = T.verify(params, tokens, cache, lengths,
                         torch.full((4,), w, dtype=torch.int32, device="cuda"), cfg)
    seq = torch.stack([T.decode_step(params, tokens[:, i], steps, lengths + i, cfg)[0]
                       for i in range(w)], dim=1)
    same = all(torch.equal(a, b) for la, lb in zip(cache, steps) for a, b in zip(la, lb))
    err = float((logits - seq).abs().max())
    if not (same and err <= 1e-4 and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"verify against decode steps: cache bytes equal {same}, logits "
                             f"{err} apart")
    return err, float(seq.abs().max())


@contextlib.contextmanager
def _profiled(torch):
    """``torch.profiler`` (host and device events) over the block.  The
    profiler keeps none of the first device events after it starts, a
    number that grows over this script's run (about ten late in the run on
    an H100), so a round run at once lost its first copies and kernels.
    So the window opens with ``PROFILE_MARKS`` bursts of ``MARKS_EACH``
    sentinel kernels over ``PROFILE_EDGE_S`` and closes with one more after
    the block and as long idle; ``_kept_ops`` holds each profile to a
    sentinel kept on either side of its device work.  The block's own
    synchronize and wall clock stay inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKS):
            for _ in range(MARKS_EACH):
                torch.cuda._sleep(1000)
            time.sleep(PROFILE_EDGE_S / PROFILE_MARKS)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)


def _kept_ops(ops):
    """The device operations ``[(name, start, ...)]`` of a ``_profiled``
    window less its sentinels, once a sentinel kept before the first and
    one after the last show that the profiler dropped none of them."""
    marks = [op[1] for op in ops if MARK in op[0]]
    work = [op for op in ops if MARK not in op[0]]
    if work and not (marks and min(marks) < min(op[1] for op in work)
                     and max(marks) > max(op[1] for op in work)):
        raise AssertionError(f"the profiler dropped device events at its window's edge "
                             f"({len(marks)} of {PROFILE_MARKS * MARKS_EACH + 1} sentinels kept)")
    WINDOW_MARKS.append(len(marks))
    return work


def _device_rows(prof):
    """Device-side events only (kernels, copies, sets) of a ``_profiled``
    window: (device seconds or None when there were none, device
    operations, the largest [(name, s, calls)])."""
    from torch.autograd import DeviceType

    rows = {}  # name -> [s, count]
    for name, _, e in _kept_ops([(e.name, e.time_range.start, e) for e in prof.events()
                                 if e.device_type != DeviceType.CPU]):
        row = rows.setdefault(name, [0.0, 0])
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

    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(2)
    run = sum(name.startswith("prof") for name in eng.finished) // 4  # fresh request ids
    prompts = [rng.integers(0, 32000, 256).astype(np.int32) for _ in range(4)]
    sp = (lambda i: SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=2000 + i)
          ) if sampled else None
    _decoding(eng, prompts, f"prof{run}", rounds + 8, sp)
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
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

    from repro_torch.serving import Request

    prompt = np.random.default_rng(5).integers(0, 32000, 3 * CHUNK).astype(np.int32)
    eng.submit(Request("chunkprof", prompt, max_new=2))
    eng.step()  # the first chunk
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
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
            with _profiled(torch) as prof:
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


# ---- the other families: paths (w)-(z) --

FAMILY_STEPS = 32  # greedy decode steps of paths (w), (x), (y)
HYMBA_BATCH, HYMBA_PROMPT, HYMBA_MAX_LEN = 4, 2048, 4096
HYMBA_CHECK_STEP = 8  # (w): decode logits after this many steps = a fresh prefill's
XLSTM_BATCH, XLSTM_PROMPT = 4, 512
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN = 4, 64, 128
LONG_CONTEXTS = (4096, 65536, LONG_ROWS)  # path (z)
# xlstm's one group (8 layers) on the card against the CPU on bf16 weights:
# cuBLAS and the CPU round the bf16 products' sums apart, and the sLSTM's
# and mLSTM's exponential gates carry each step's rounding into the next
# over 512 steps; measured 0.0292 of max |logit| on one H100 80GB HBM3
# (700 W), about 2.7 times that.  On f32 weights (TF32 off)
# the same code must agree to float rounding.
XLSTM_TOL = 0.08
XLSTM_F32_TOL = 1e-3
# hymba's and whisper's 2-layer (2 + 2) logits on the card against the CPU
# on bf16 weights: measured at most 0.0068 (hymba) and 0.0060 (whisper) of
# max |logit| on one H100 80GB HBM3 (700 W), about 3 times that.  (w)'s
# full-depth decode against a fresh prefill keeps FAMILY_TOL: measured
# 0.0277 of max |logit| there (0.105 of 3.79), the 32 layers' bf16 roundings
FAMILY_CPU_TOL = 0.02


def _first_layers(tree, n):
    """The first ``n`` entries of every layer-stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _step_device_ms(torch, step, n: int = 3, warm: bool = True):
    """Device time a call of ``step()`` under the profiler (device-side
    events only, summed), over ``n`` calls after one unprofiled call (with
    ``warm``): (wall ms a call, device ms a call or None when the profiler
    saw none, device operations a call, the largest [(name, ms a call,
    calls a call)])."""
    if warm:
        step()
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, ops, top = _device_rows(prof)
    return (wall / n * 1e3, (None if dev is None else dev / n * 1e3), ops / n,
            [(name, sec / n * 1e3, calls / n) for name, sec, calls in top])


def _print_top(top, k: int = 6):
    for name, ms, calls in top[:k]:
        print(f"    {ms:9.3f} ms  {calls:8.1f} calls  {name[:90]}")


def _greedy(torch, step, logits, lengths, steps):
    """``steps`` greedy decode steps from ``logits`` at ``lengths``, timed by
    CUDA events.  Returns (tokens (B, steps + 1) fed and last, the logits of
    every step, ms a step)."""
    toks, outs = [logits.argmax(-1)], []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for t in range(steps):
        logits = step(toks[-1], lengths + t)
        outs.append(logits)
        toks.append(logits.argmax(-1))
    e1.record()
    e1.synchronize()
    return torch.stack(toks, dim=1), outs, e0.elapsed_time(e1) / steps


def _held(what, got, want, tol=None):
    """Raises unless ``got`` (card) holds ``want`` (CPU) within ``tol``
    (``FAMILY_TOL``) of max |want|; returns (err, max |want|)."""
    tol = FAMILY_TOL if tol is None else tol
    got, want = got.float().cpu(), want.float().cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not (got.isfinite().all() and err <= tol * max(scale, 1.0)):
        raise AssertionError(f"{what}: the card differs by {err} (max |x| {scale})")
    return err, scale


def _launch_check(what, launches, want):
    expect = {name: 0 for name in launches}
    expect.update(want)
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches} != expected {expect}")


def hymba_path(torch, np, card):
    """(w) hymba-1.5b at full width and depth on bf16 weights drawn on the
    card by ``init_like_jax`` from seed 0: 4 prompts of 2,048 tokens
    prefilled (the windowed plain path on every layer), installed into a
    batch-leading cache of 4,096 rows, 32 greedy decode steps (B3 a layer a
    step, the 29 windowed layers from a start past 0).  The 2-layer logits
    (prefill and 2 decode steps) against the CPU port on prompt 0; the
    logits after 8 steps against a fresh prefill of prompt + 8 tokens.
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.layers import attention as A
    from repro_torch.models import hymba as H
    from repro_torch.models.jax_init import init_like_jax

    cfg = get_config("hymba-1.5b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_like_jax(cfg, 0, "cuda", draw_device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"path (w) hymba-1.5b: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads x {cfg.head_dim} over {cfg.num_kv_heads}, window {cfg.sliding_window} (global "
          f"{cfg.global_attn_layers}), SSM state {cfg.ssm_state}; bf16 weights from seed 0 "
          f"(init_like_jax on the card): {nbytes / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s"
          f"  [{card}]")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (HYMBA_BATCH, HYMBA_PROMPT))).cuda()
    starts_seen = []
    walk = A.decode_attention

    def recording(q, k, v, lengths, starts=None, **kw):
        starts_seen.append(0 if starts is None else int(starts.min()))
        return walk(q, k, v, lengths, starts, **kw)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pre = H.forward_prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = dict(COUNTS)
    cache = H.install_prefill(H.init_cache(cfg, HYMBA_BATCH, HYMBA_MAX_LEN, device="cuda"), pre)
    del pre
    lengths = torch.full((HYMBA_BATCH,), HYMBA_PROMPT, dtype=torch.int32, device="cuda")
    A.decode_attention = recording
    try:
        H.decode_step(params, logits.argmax(-1), _clone_cache(cache), lengths, cfg)
    finally:
        A.decode_attention = walk
    reset_counts()
    toks, outs, ms = _greedy(torch, lambda t, ln: H.decode_step(params, t, cache, ln, cfg)[0],
                             logits, lengths, FAMILY_STEPS)
    launches = dict(COUNTS)
    _launch_check("path (w) prefill", prefill_launches, {})
    _launch_check("path (w) decode", launches, {"decode_attention": cfg.num_layers * FAMILY_STEPS})
    windowed = sum(1 for st in starts_seen if st > 0)
    if windowed != cfg.num_layers - len(cfg.global_attn_layers):
        raise AssertionError(f"path (w): {windowed} walks started past 0 in a step at length "
                             f"{HYMBA_PROMPT} (starts {starts_seen})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall_ms, dev_ms, ops, top = _step_device_ms(
        torch, lambda: H.decode_step(params, toks[:, -1], cache, lengths + FAMILY_STEPS, cfg))
    print(f"path (w): prefill of {HYMBA_BATCH} x {HYMBA_PROMPT} tokens {t_prefill * 1e3:.1f} ms "
          f"(launches {prefill_launches}); {FAMILY_STEPS} decode steps at {ms:.3f} ms a step "
          f"(CUDA events, eager) = {HYMBA_BATCH * 1e3 / ms:.1f} tok/s; device time "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} a step over {ops:.0f} device "
          f"operations (profiler; wall {wall_ms:.3f} ms); peak device memory {peak:.2f} GiB  "
          f"[{card}]")
    print(f"path (w): launches {launches}; one step at length {HYMBA_PROMPT}: {windowed} of "
          f"{cfg.num_layers} walks from a start past 0 (window {cfg.sliding_window}: start "
          f"{HYMBA_PROMPT + 1 - cfg.sliding_window}); a decode step's largest device operations:")
    _print_top(top)
    _, pre_ms, pre_ops, top = _step_device_ms(
        torch, lambda: H.forward_prefill(params, tokens, cfg), n=1, warm=False)
    print(f"path (w): the prefill under the profiler: "
          f"{'not measured' if pre_ms is None else f'{pre_ms:.1f} ms'} of device time over "
          f"{pre_ops:.0f} device operations, the largest:")
    _print_top(top)
    # the decode's logits after 8 steps against a fresh prefill of prompt + 8 tokens
    fresh, _ = H.forward_prefill(params, torch.cat([tokens, toks[:, :HYMBA_CHECK_STEP]], dim=1), cfg)
    err, scale = _held("path (w) decode vs fresh prefill", outs[HYMBA_CHECK_STEP - 1], fresh)
    print(f"path (w): decode logits after {HYMBA_CHECK_STEP} steps vs a fresh prefill of the "
          f"prompt + {HYMBA_CHECK_STEP} tokens on the card: max abs err {err:.3g} (max |logit| "
          f"{scale:.3g})")
    del cache, outs, fresh
    _free(torch)
    # full width at 2 layers (layer 0 global, layer 1 windowed) against the CPU port, prompt 0
    cfg2 = dataclasses.replace(cfg, num_layers=2, global_attn_layers=(0,))
    p2 = {**params, "layers": _first_layers(params["layers"], 2)}
    runs = []
    for dev, p in (("cuda", p2), ("cpu", _to_cpu(p2))):
        lg, pre = H.forward_prefill(p, tokens[:1].to(dev), cfg2)
        c2 = H.install_prefill(H.init_cache(cfg2, 1, HYMBA_PROMPT + 8, device=dev), pre)
        out = [lg]
        for t in range(2):
            ln = torch.full((1,), HYMBA_PROMPT + t, dtype=torch.int32, device=dev)
            out.append(H.decode_step(p, toks[:1, t].to(dev), c2, ln, cfg2)[0])
        runs.append(out)
    for what, got, want in zip(("prefill", "decode step 1", "decode step 2"), *runs):
        err, scale = _held(f"path (w) 2-layer {what}", got, want, FAMILY_CPU_TOL)
        print(f"reference (w): full-width 2-layer hymba {what} logits vs CPU plain versions: max "
              f"abs err {err:.3g} (max |logit| {scale:.3g}, {err / max(scale, 1.0):.3g} of it; "
              f"tolerance {FAMILY_CPU_TOL})")
    del params, p2, runs
    _free(torch)
    return {name: n + prefill_launches[name] for name, n in launches.items()}


def _clone_cache(cache):
    if isinstance(cache, tuple):
        return type(cache)(*(_clone_cache(c) for c in cache))
    return cache.clone()


def xlstm_path(torch, np, card):
    """(x) xlstm-1.3b at full width and depth on bf16 weights drawn on the
    card: 4 prompts of 512 tokens prefilled (the sLSTM's share of the
    wall time timed apart), 32 greedy decode steps; no kernel.  One group
    (8 layers) against the CPU port on prompt 0.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.examples.long_context_decode import state_bytes
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import xlstm as X
    from repro_torch.models.jax_init import init_like_jax

    cfg = get_config("xlstm-1.3b")
    torch.cuda.reset_peak_memory_stats()
    params = init_like_jax(cfg, 0, "cuda", draw_device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (XLSTM_BATCH, XLSTM_PROMPT))).cuda()
    slstm = X.slstm_forward
    slstm_s = []

    def timed_slstm(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = slstm(*args)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t0)
        return out

    X.forward_prefill(params, tokens[:, :64], cfg)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    X.slstm_forward = timed_slstm
    try:
        t0 = time.perf_counter()
        logits, cache = X.forward_prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    finally:
        X.slstm_forward = slstm
    lengths = torch.full((XLSTM_BATCH,), XLSTM_PROMPT, dtype=torch.int32, device="cuda")
    toks, outs, ms = _greedy(torch, lambda t, ln: X.decode_step(params, t, cache, ln, cfg)[0],
                             logits, lengths, FAMILY_STEPS)
    launches = dict(COUNTS)
    _launch_check("path (x)", launches, {})
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("path (x): non-finite decode logits")
    wall_ms, dev_ms, ops, top = _step_device_ms(
        torch, lambda: X.decode_step(params, toks[:, -1], cache, lengths, cfg))
    per_seq = state_bytes(cache) / XLSTM_BATCH
    print(f"path (x) xlstm-1.3b full width and depth ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.d_model // cfg.num_heads}, one sLSTM in "
          f"{cfg.slstm_every}): prefill of {XLSTM_BATCH} x {XLSTM_PROMPT} tokens "
          f"{t_prefill * 1e3:.1f} ms wall, the sLSTM blocks {sum(slstm_s) * 1e3:.1f} ms of it "
          f"({len(slstm_s)} blocks, one step a token: {sum(slstm_s) / t_prefill:.3f} of the "
          f"prefill); {FAMILY_STEPS} decode steps at {ms:.3f} ms a step (CUDA events, eager) = "
          f"{XLSTM_BATCH * 1e3 / ms:.1f} tok/s; device time "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} a step over {ops:.0f} device "
          f"operations (wall {wall_ms:.3f} ms); state {per_seq / 2**20:.1f} MiB a sequence; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}; a decode step's largest device operations:  [{card}]")
    _print_top(top)
    del cache, outs
    _free(torch)
    cfg_g = dataclasses.replace(cfg, num_layers=cfg.slstm_every)
    p_g = {**params, "groups": _first_layers(params["groups"], 1)}
    for dtype, tol in (("bf16", XLSTM_TOL), ("f32", XLSTM_F32_TOL)):
        runs = []
        for dev, p in (("cuda", p_g), ("cpu", _to_cpu(p_g))):
            if dtype == "f32":
                p = _to_f32(p)
            lg, st = X.forward_prefill(p, tokens[:1].to(dev), cfg_g)
            ln = torch.full((1,), XLSTM_PROMPT, dtype=torch.int32, device=dev)
            runs.append([lg, X.decode_step(p, toks[:1, 0].to(dev), st, ln, cfg_g)[0]])
        for what, got, want in zip(("prefill", "decode step"), *runs):
            err, scale = _held(f"path (x) one-group {dtype} {what}", got, want, tol)
            print(f"reference (x): full-width one-group ({cfg_g.num_layers} layers) xlstm {what} "
                  f"logits on {dtype} weights vs CPU plain versions: max abs err {err:.3g} (max "
                  f"|logit| {scale:.3g}, {err / max(scale, 1.0):.3g} of it; tolerance {tol})")
    del params, p_g, runs
    _free(torch)
    return launches


def whisper_path(torch, np, card):
    """(y) whisper-large-v3 at full width and depth on bf16 weights drawn
    on the card: frames (4, 1,500, 1,280) from seed 0, a 64-token decoder
    prompt (B2 a decoder layer), the swap into a batch-leading cache, 32
    greedy decode steps (B3 twice a layer a step: the self walk and the
    cross walk over 1,500 of 1,536 rows).  2 encoder and 2 decoder layers
    against the CPU port on request 0.  Returns the launches of the
    prefill and the decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import encdec as E
    from repro_torch.models.jax_init import init_like_jax

    cfg = get_config("whisper-large-v3")
    torch.cuda.reset_peak_memory_stats()
    params = init_like_jax(cfg, 0, "cuda", draw_device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).cuda().to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT))).cuda()
    E.forward_prefill(params, tokens[:, :16], cfg, frames=frames)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pre = E.forward_prefill(params, tokens, cfg, frames=frames)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = dict(COUNTS)
    cache = E.install_prefill(E.init_cache(cfg, WHISPER_BATCH, WHISPER_MAX_LEN, device="cuda"),
                              pre)
    del pre
    lengths = torch.full((WHISPER_BATCH,), WHISPER_PROMPT, dtype=torch.int32, device="cuda")
    reset_counts()
    toks, outs, ms = _greedy(torch, lambda t, ln: E.decode_step(params, t, cache, ln, cfg)[0],
                             logits, lengths, FAMILY_STEPS)
    launches = dict(COUNTS)
    _launch_check("path (y) prefill", prefill_launches, {"prefill_attention": cfg.num_layers})
    _launch_check("path (y) decode", launches,
                  {"decode_attention": 2 * cfg.num_layers * FAMILY_STEPS})
    wall_ms, dev_ms, ops, top = _step_device_ms(
        torch, lambda: E.decode_step(params, toks[:, -1], cache, lengths + FAMILY_STEPS, cfg))
    print(f"path (y) whisper-large-v3 full width and depth ({cfg.encoder_layers} + {cfg.num_layers}"
          f" layers, d_model {cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}): encode + "
          f"prefill of {WHISPER_BATCH} x ({cfg.encoder_seq} frames, {WHISPER_PROMPT} tokens) "
          f"{t_prefill * 1e3:.1f} ms (launches {prefill_launches}); {FAMILY_STEPS} decode steps at "
          f"{ms:.3f} ms a step (CUDA events, eager) = {WHISPER_BATCH * 1e3 / ms:.1f} tok/s; device "
          f"time {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} a step over {ops:.0f} "
          f"device operations (wall {wall_ms:.3f} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} (B3 "
          f"{2 * cfg.num_layers} a step: self and cross); a decode step's largest device "
          f"operations:  [{card}]")
    _print_top(top)
    del cache, outs
    _free(torch)
    cfg2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
    p2 = {**params, "enc_layers": _first_layers(params["enc_layers"], 2),
          "dec_layers": _first_layers(params["dec_layers"], 2)}
    runs = []
    for dev, p in (("cuda", p2), ("cpu", _to_cpu(p2))):
        lg, pre = E.forward_prefill(p, tokens[:1].to(dev), cfg2, frames=frames[:1].to(dev))
        c2 = E.install_prefill(E.init_cache(cfg2, 1, WHISPER_MAX_LEN, device=dev), pre)
        ln = torch.full((1,), WHISPER_PROMPT, dtype=torch.int32, device=dev)
        runs.append([lg, E.decode_step(p, toks[:1, 0].to(dev), c2, ln, cfg2)[0]])
    for what, got, want in zip(("prefill", "decode step"), *runs):
        err, scale = _held(f"path (y) 2+2-layer {what}", got, want, FAMILY_CPU_TOL)
        print(f"reference (y): full-width 2+2-layer whisper {what} logits vs CPU plain versions: "
              f"max abs err {err:.3g} (max |logit| {scale:.3g}, {err / max(scale, 1.0):.3g} of it; "
              f"tolerance {FAMILY_CPU_TOL})")
    del params, p2, runs, frames
    _free(torch)
    return {name: n + prefill_launches[name] for name, n in launches.items()}


def long_context_path(torch, np, card):
    """(z) the long-context example at full width: hymba-1.5b at batch 1,
    decode steps at contexts 4,096, 65,536 and 524,288 over a cache of
    random bf16 rows (not prefilled), device ms a step by CUDA events and
    by the profiler; after the counted run, one global layer's B3 against
    its plain version on the card over the 524,288-row cache, and a
    windowed layer's with its start.  Then xlstm-1.3b at the same contexts,
    its state fixed.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.examples.long_context_decode import STEPS, decode_rows
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.models.jax_init import init_like_jax

    total = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        cfg = get_config(arch)
        params = init_like_jax(cfg, 0, "cuda", draw_device="cuda", dtype=torch.bfloat16)
        profiled, kept = {}, {}

        def fill(cache):
            if arch == "hymba-1.5b":
                for t in cache.kv:
                    t.normal_(generator=gen)

        def on_cache(ctx, cache, lengths, cfg=cfg, params=params, profiled=profiled, kept=kept):
            from repro_torch.models.registry import get_model

            step = get_model(cfg).decode_step
            tok = torch.zeros((1,), dtype=torch.long, device="cuda")
            profiled[ctx] = _step_device_ms(torch, lambda: step(params, tok, cache, lengths, cfg))
            if arch == "hymba-1.5b" and ctx == LONG_ROWS:
                kept["cache"], kept["lengths"] = cache, lengths

        reset_counts()
        rows = decode_rows(cfg, params, LONG_CONTEXTS, "cuda", fill=fill, on_cache=on_cache)
        launches = dict(COUNTS)
        steps = len(LONG_CONTEXTS) * (STEPS + 1 + 4)  # timed, warm-up, profiled
        walks = 0 if cfg.family == "xlstm" else cfg.num_layers * steps
        _launch_check(f"path (z) {arch}", launches, {"decode_attention": walks})
        if kept:
            cache, lengths = kept.pop("cache"), kept.pop("lengths")
            g = cfg.num_heads // cfg.num_kv_heads
            q = torch.randn((1, cfg.num_kv_heads, g, cfg.head_dim), generator=gen, device="cuda")
            for li in (cfg.global_attn_layers[0], 1):
                k, v = cache.kv.k[:, li], cache.kv.v[:, li]
                starts = (None if li in cfg.global_attn_layers else
                          torch.clamp(lengths + 1 - cfg.sliding_window, min=0).to(torch.int32))
                got = decode_attention(q.reshape(1, -1, cfg.head_dim), k, v, lengths, starts,
                                       return_stats=True)
                want = decode_attention_reference(q, k, v, lengths, starts)
                err = _check_err(f"path (z) layer {li} at {LONG_ROWS} rows",
                                 [t.reshape(w.shape) for t, w in zip(got, want)], want)
                print(f"path (z): layer {li} ({'global' if starts is None else 'windowed'}) B3 over "
                      f"{LONG_ROWS} rows (length {int(lengths[0])}) vs its plain version on the "
                      f"card: max err {err:.3g}")
            del cache, k, v, got, want
        for ctx, ms, nbytes in rows:
            wall_ms, dev_ms, ops, _ = profiled[ctx]
            print(f"path (z) {arch} batch 1, context {ctx}: {ms:.3f} ms a step (CUDA events, "
                  f"eager), device time {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}"
                  f" a step over {ops:.0f} device operations (profiler), state "
                  f"{nbytes / 2**20:.1f} MiB  [{card}]")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del params
        _free(torch)
    return total


def other_families_phase(torch, np, card):
    """Phase 11: paths (w)-(z), each driven with the counts set to 0 just
    before and read just after.  Returns the launches summed."""
    total = {}
    for path in (hymba_path, xlstm_path, whisper_path, long_context_path):
        for name, n in path(torch, np, card).items():
            total[name] = total.get(name, 0) + n
    return total


# ---- training: paths (T1)-(T4) --

TRAIN_ARGS = ["--batch", "8", "--seq", "256", "--lr", "3e-4", "--schedule", "wsd", "--seed", "0",
              "--device", "cuda", "--log-every", "5"]  # the JAX launcher's defaults, WSD
TRAIN_A, TRAIN_B = 10, 20  # (T1): run A's steps; runs B (restored from A) and C end here
TRAIN_BATCH, TRAIN_SEQ = 8, 256
QAT_STEPS = 5  # (T2)
QAT_PROMPTS, QAT_PROMPT_LEN, QAT_NEW = 4, 256, 16
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 2  # (T3)
GRAD_BATCH, GRAD_SEQ = 2, 128  # (T4), whisper's decoder 64 tokens over 1,500 frames
CKPT_DIR = Path("chiprun_out") / "train_ckpt"  # removed at the end of the phase
# A training step on the card against the CPU port, both f32 with TF32 off:
# the loss and gradient norm, and (T4) every gradient leaf as a share of its
# max |g|; products and reductions summed in other orders.  Measured on one
# H100 80GB HBM3 (700 W): at most 8.7e-8 (the losses) and 2.45e-4 (xlstm's
# mLSTM w_qkv, whose exponential gates carry each rounding on).
TRAIN_CPU_TOL = 1e-4
GRAD_CPU_TOL = 1e-3


def _no_launches(what, launches):
    if any(launches.values()):
        raise AssertionError(f"{what}: training launched kernels {launches}")


def _train_flops(cfg, params_n, b, s, remat=True):
    """Model FLOPs of one training step: 6 N T for the parameters' products
    (forward and backward, the tied head's included), the attention's
    score and PV products 4 B S^2 d a layer forward (the dense path computes
    every position) and twice that backward; with remat, the layers'
    forward once more (2 N_layers T and the attention's 4 B S^2 d)."""
    t = b * s
    attn = 4 * b * s * s * cfg.num_heads * cfg.head_dim * cfg.num_layers
    model = 6 * params_n * t + 3 * attn
    layer_n = params_n - cfg.padded_vocab() * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return model, model + (2 * layer_n * t + attn if remat else 0)


def _step_times(history, first=2):
    ms = [h["ms"] for s, h in history.items() if s >= first]
    return statistics.median(ms), min(ms), max(ms)


def smollm_training(torch, np, card):
    """(T1) smollm-135m at full width and depth through the train CLI's
    loop (``launch.train.train``): run A 10 steps with a checkpoint at step
    10, run B ``--restore`` to step 20, run C a fresh 20 steps.  B's losses
    at steps 10-19 must equal C's bit for bit, and A's C's at 0-9; the loss
    must fall, and start within 1.0 of ln(vocab).  Then the first step at 2
    of 30 layers on the card against the CPU port, and one profiled step."""
    import shutil

    from repro_torch.common.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch import train as train_cli
    from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

    base = ["--arch", "smollm-135m", *TRAIN_ARGS, "--ckpt-every", str(TRAIN_A)]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    _free(torch)
    held = torch.cuda.memory_allocated() / 2**30  # by earlier phases, in every run's peak
    reset_counts()
    runs, peaks = {}, {}
    for name, extra in (("A", ["--steps", str(TRAIN_A), "--ckpt-dir", str(CKPT_DIR)]),
                        ("B", ["--steps", str(TRAIN_B), "--ckpt-dir", str(CKPT_DIR), "--restore"]),
                        ("C", ["--steps", str(TRAIN_B)])):
        torch.cuda.reset_peak_memory_stats()
        runs[name] = train_cli.train(train_cli.parse_args(base + extra))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        if name != "C":  # keep the history, not the state: each run's peak is its own
            runs[name] = dataclasses.replace(runs[name], params=None, opt=None)
            _free(torch)
    launches = dict(COUNTS)
    _no_launches("path (T1)", launches)
    peak = peaks["C"]
    a, b, c = (runs[k].history for k in "ABC")
    if runs["B"].start != TRAIN_A or sorted(b) != list(range(TRAIN_A, TRAIN_B)):
        raise AssertionError(f"path (T1): run B resumed at {runs['B'].start}, steps {sorted(b)}")
    for what, got, want in (("A", a, c), ("B", b, c)):
        for s, h in got.items():
            if h["loss"] != want[s]["loss"] or h["grad_norm"] != want[s]["grad_norm"]:
                raise AssertionError(f"path (T1): run {what}'s step {s} (loss {h['loss']}, grad "
                                     f"norm {h['grad_norm']}) differs from run C's "
                                     f"({want[s]['loss']}, {want[s]['grad_norm']})")
    cfg = runs["C"].cfg
    losses = [c[s]["loss"] for s in range(TRAIN_B)]
    if not (abs(losses[0] - math.log(cfg.vocab_size)) < 1.0 and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"path (T1): losses {losses}")
    med, lo, hi = _step_times(c)
    n = cfg.param_count()
    model_flops, step_flops = _train_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    print(f"path (T1) smollm-135m training at full width and depth ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, Vp "
          f"{cfg.padded_vocab()}, {n / 1e6:.1f} M parameters, f32, remat {cfg.remat}), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, WSD lr 3e-4, through launch.train: run A {TRAIN_A} steps "
          f"+ checkpoint, run B --restore to {TRAIN_B}, run C {TRAIN_B} fresh; B's losses at steps "
          f"{TRAIN_A}-{TRAIN_B - 1} and A's at 0-{TRAIN_A - 1} equal C's bit for bit (and the "
          f"gradient norms); loss {losses[0]:.4f} (ln V {math.log(cfg.vocab_size):.4f}) -> "
          f"{losses[-1]:.4f}; {med:.2f} ms a step (CUDA events, median of steps 2-{TRAIN_B - 1}; "
          f"{lo:.2f}-{hi:.2f}) = {TRAIN_BATCH * TRAIN_SEQ * 1e3 / med:,.0f} tokens/s; model FLOPs "
          f"{model_flops / 1e12:.3f} TFLOP a step ({model_flops / (med / 1e3) / PEAK_OPS['f32']:.3f}"
          f" of the f32 peak), {step_flops / 1e12:.3f} with remat's recompute "
          f"({step_flops / (med / 1e3) / PEAK_OPS['f32']:.3f}); f32 bound "
          f"{step_flops / PEAK_OPS['f32'] * 1e3:.1f} ms; peak device memory of run C {peak:.2f} GiB (A "
          f"{peaks['A']:.2f}, B {peaks['B']:.2f}), of which {held:.2f} GiB was held before run A; "
          f"launches {launches}  [{card}]")
    print("  run C losses: " + " ".join(f"{x:.4f}" for x in losses))
    res = runs["C"]
    step_fn = make_train_step(cfg, res.tcfg)
    source = make_source(DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                    vocab_size=cfg.vocab_size, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in source.batch(TRAIN_B).items()}
    params, opt = res.params, res.opt
    wall_ms, dev_ms, ops, top = _step_device_ms(
        torch, lambda: step_fn(params, opt, batch, TRAIN_B), n=1)
    print(f"profile (T1): one training step under torch.profiler: {wall_ms:.2f} ms wall, "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} of device time over "
          f"{ops:.0f} device operations, device busy "
          f"{'not measured' if dev_ms is None else f'{dev_ms / wall_ms:.3f}'}; its largest device "
          f"operations:  [{card}]")
    _print_top(top, 8)
    del runs, res, params, opt
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    _free(torch)
    # the first step at 2 of 30 layers, the same weights and batch on both devices
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    tcfg = TrainConfig(schedule="wsd", warmup=5, total_steps=TRAIN_B)
    batch0 = source.batch(0)
    out = []
    state = init_train_state(cfg2, 0, "cuda")
    for dev in ("cuda", "cpu"):
        p, o = (tree_map(lambda t: t.to(dev, copy=True), x) for x in state)
        _, _, m = make_train_step(cfg2, tcfg)(
            p, o, {k: torch.from_numpy(v).to(dev) for k, v in batch0.items()}, 0)
        out.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm"):
        err = abs(out[0][k] - out[1][k]) / abs(out[1][k])
        if not err <= TRAIN_CPU_TOL:
            raise AssertionError(f"path (T1) 2 layers: {k} {out[0][k]} on the card, {out[1][k]} "
                                 f"on the CPU")
        print(f"reference (T1): full-width 2-layer first step {k} on the card {out[0][k]:.6f} vs "
              f"the CPU port {out[1][k]:.6f}: relative error {err:.3g} (tolerance "
              f"{TRAIN_CPU_TOL})")
    del state
    _free(torch)
    return launches


def _serve_tokens(torch, cfg, params, prompts):
    """The prompts served greedily on ``EngineCore(n_slots=4, max_len=2048)``
    on the card (the programs captured at first use), the counts read over
    the run: (tokens by request, stats, launches)."""
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.serving import EngineCore, Request

    eng = EngineCore(cfg, params, n_slots=QAT_PROMPTS, max_len=2048, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(f"q{i}", p, max_new=QAT_NEW))
    torch.cuda.synchronize()
    reset_counts()
    stats = eng.run()
    torch.cuda.synchronize()
    launches = dict(COUNTS)
    per_pass = 7 * cfg.num_layers
    expect = {name: 0 for name in launches}
    expect.update({"tlmm": per_pass * (stats.swaps + stats.decode_rounds),
                   "act_quant": per_pass * (stats.swaps + stats.decode_rounds),
                   "prefill_attention": cfg.num_layers * stats.swaps,
                   "decode_attention": cfg.num_layers * stats.decode_rounds})
    if stats.swaps != len(prompts) or launches != expect:
        raise AssertionError(f"path (T2) serving: launches {launches} != {expect}")
    tokens = {k: r.out_tokens for k, r in eng.finished.items()}
    if any(len(t) != QAT_NEW for t in tokens.values()):
        raise AssertionError(f"path (T2) serving: {tokens}")
    return tokens, stats, launches


def bitnet_qat(torch, np, card):
    """(T2) bitnet-730m quantization-aware training at full width and
    depth: 5 steps of ``make_train_step`` at 8 x 256 (f32 latent weights
    drawn by ``init_like_jax`` from seed 0), every latent linear's gradient
    nonzero (the straight-through estimators); then the trained weights
    packed (``convert_for_inference``) and served (4 prompts of 256, 16
    new, greedy) through B1/B2/B3, and again after a ``CheckpointManager``
    save and restore, to the same tokens."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    cfg = get_config("bitnet-730m")
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(cfg, 0, "cuda")
    tcfg = TrainConfig(schedule="wsd", warmup=1, total_steps=QAT_STEPS)
    step_fn = make_train_step(cfg, tcfg)
    source = make_source(DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                    vocab_size=cfg.vocab_size, seed=0))
    reset_counts()
    losses, ms = [], []
    for s in range(QAT_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in source.batch(s).items()}
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, m = step_fn(params, opt, batch, s)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
    api = get_model(cfg)
    _, _, grads = loss_and_grads(lambda p, b: api.loss_fn(p, b, cfg), params, batch)
    launches = dict(COUNTS)
    _no_launches("path (T2) training", launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0):
        raise AssertionError(f"path (T2): losses {losses}")
    for group, name in T.LINEARS:
        g = grads["layers"][group][name]["w"]
        per_layer = g.abs().flatten(1).amax(1)
        if not bool((per_layer > 0).all()):
            raise AssertionError(f"path (T2): {group}/{name} has a zero gradient in layers "
                                 f"{(per_layer == 0).nonzero().flatten().tolist()}")
    del grads
    n = cfg.param_count()
    model_flops, step_flops = _train_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    med = statistics.median(ms[1:])
    print(f"path (T2) bitnet-730m QAT at full width and depth ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, Vp {cfg.padded_vocab()}, {n / 1e6:.1f} M latent f32 parameters), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {QAT_STEPS} steps of make_train_step: loss "
          + " ".join(f"{x:.4f}" for x in losses) + f" (ln V {math.log(cfg.vocab_size):.4f}); "
          f"every latent linear's gradient nonzero in every layer (7 x {cfg.num_layers}); "
          f"{med:.1f} ms a step (CUDA events, median of steps 1-{QAT_STEPS - 1}; "
          f"{min(ms[1:]):.1f}-{max(ms[1:]):.1f}) = {TRAIN_BATCH * TRAIN_SEQ * 1e3 / med:,.0f} "
          f"tokens/s; model FLOPs {model_flops / 1e12:.3f} TFLOP a step "
          f"({model_flops / (med / 1e3) / PEAK_OPS['f32']:.3f} of the f32 peak), "
          f"{step_flops / 1e12:.3f} with remat ({step_flops / (med / 1e3) / PEAK_OPS['f32']:.3f})"
          f"; f32 bound {step_flops / PEAK_OPS['f32'] * 1e3:.1f} ms; peak device memory "
          f"{peak:.2f} GiB  [{card}]")
    del opt
    _free(torch)
    prompts = make_prompts(np, cfg, [QAT_PROMPT_LEN] * QAT_PROMPTS)
    tokens, stats, serve_launches = _serve_tokens(torch, cfg, T.convert_for_inference(params, cfg),
                                                  prompts)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(CKPT_DIR))
        t0 = time.perf_counter()
        mgr.save(QAT_STEPS, params)
        t_save = time.perf_counter() - t0
        template = tree_map(torch.empty_like, params)
        del params
        _free(torch)
        t0 = time.perf_counter()
        restored, step = mgr.restore(template)
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del template
    again, _, again_launches = _serve_tokens(torch, cfg, T.convert_for_inference(restored, cfg),
                                             prompts)
    if step != QAT_STEPS or again != tokens:
        raise AssertionError(f"path (T2): after the checkpoint (step {step}) the tokens differ")
    print(f"path (T2) serving the trained weights packed: {QAT_PROMPTS} prompts of "
          f"{QAT_PROMPT_LEN} tokens, {QAT_NEW} new, greedy on EngineCore(n_slots={QAT_PROMPTS}, "
          f"max_len=2048): {stats.swaps} prefills, {stats.decode_rounds} decode rounds, launches "
          f"{serve_launches} as the stats imply; a second engine after a CheckpointManager save "
          f"({t_save:.1f} s) and restore ({t_restore:.1f} s) of the latent weights gives the same "
          f"tokens; first request's {tokens['q0']}  [{card}]")
    del restored
    _free(torch)
    return {k: serve_launches[k] + again_launches[k] for k in serve_launches}


def granite_moe_training(torch, np, card):
    """(T3) granite-moe-3b-a800m at full width, 4 of 32 layers: 2 training
    steps at 8 x 256; the aux loss above 0, and every expert that received
    rows in a layer has a nonzero gradient there; the dropped assignments a
    layer printed."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.layers import moe as M
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(cfg, 0, "cuda")
    step_fn = make_train_step(cfg, TrainConfig(schedule="wsd", warmup=1,
                                               total_steps=MOE_TRAIN_STEPS))
    source = make_source(DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                    vocab_size=cfg.vocab_size, seed=0))
    reset_counts()
    metrics = []
    for s in range(MOE_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in source.batch(s).items()}
        params, opt, m = step_fn(params, opt, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    routed, route = [], M._route

    def recording(gate_logits, k, capacity, num_experts):
        out = route(gate_logits, k, capacity, num_experts)
        routed.append((out[1], capacity))
        return out

    api = get_model(cfg)
    M._route = recording
    try:
        _, lm, grads = loss_and_grads(lambda p, b: api.loss_fn(p, b, cfg), params, batch)
    finally:
        M._route = route
    launches = dict(COUNTS)
    _no_launches("path (T3)", launches)
    e = cfg.num_experts
    drops = []
    for li, (dest, cap) in enumerate(routed[:cfg.num_layers]):  # the forward's, before the recompute
        kept = dest[dest < e * cap] // cap
        drops.append(int((dest == e * cap).sum()))
        got = torch.unique(kept)
        gmax = torch.stack([grads["layers"]["moe"][w][li].flatten(1).abs().amax(1)
                            for w in ("w_gate", "w_up", "w_down")]).amin(0)
        if not bool((gmax[got] > 0).all()):
            raise AssertionError(f"path (T3): layer {li}: an expert with rows has a zero gradient")
    if not (float(lm["aux"]) > 0 and all(m["aux"] > 0 for m in metrics)
            and all(math.isfinite(m["loss"]) for m in metrics)):
        raise AssertionError(f"path (T3): metrics {metrics}")
    print(f"path (T3) granite-moe-3b-a800m training at full width, {cfg.num_layers} of 32 layers "
          f"({e} experts top-{cfg.top_k}, f32), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{MOE_TRAIN_STEPS} steps: loss " + " ".join(f"{m['loss']:.4f}" for m in metrics)
          + ", aux " + " ".join(f"{m['aux']:.4f}" for m in metrics) + f"; every expert that "
          f"received rows has a nonzero gradient; dropped assignments a layer {drops} of "
          f"{TRAIN_BATCH * TRAIN_SEQ * cfg.top_k} (capacity {routed[0][1]}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    del params, opt, grads
    _free(torch)
    return launches


def family_gradients(torch, np, card):
    """(T4) one loss and gradient of hymba-1.5b (2 layers), xlstm-1.3b (one
    group, 8 layers) and whisper-large-v3 (2 + 2 layers) at full width, f32
    ``init_like_jax`` weights, on the card against the CPU port: the loss,
    and every gradient leaf within ``GRAD_CPU_TOL`` of its max |g|."""
    from repro_torch.common.tree import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.models.jax_init import init_like_jax
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import loss_and_grads

    rng = np.random.default_rng(0)
    reset_counts()
    for arch, cut in (("hymba-1.5b", dict(num_layers=2)), ("xlstm-1.3b", dict(num_layers=8)),
                      ("whisper-large-v3", dict(num_layers=2, encoder_layers=2))):
        cfg = dataclasses.replace(get_config(arch), **cut)
        api = get_model(cfg)
        seq = GRAD_SEQ // 2 if cfg.family == "encdec" else GRAD_SEQ
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (GRAD_BATCH, seq)).astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (GRAD_BATCH, seq)).astype(np.int32),
                 "mask": np.ones((GRAD_BATCH, seq), np.float32)}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal((GRAD_BATCH, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
        params = init_like_jax(cfg, 0, "cuda", draw_device="cuda")
        runs = []
        for dev in ("cuda", "cpu"):
            p = params if dev == "cuda" else _to_cpu(params)
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(lambda q, b: api.loss_fn(q, b, cfg), p,
                                             {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            if dev == "cuda":
                torch.cuda.synchronize()
            runs.append((float(loss), dict(named_leaves(grads)), time.perf_counter() - t0))
        (lg, gg, tg), (lc, gc, tc) = runs
        loss_err = abs(lg - lc) / abs(lc)
        worst = max(((gg[k].cpu() - g).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
                    for k, g in gc.items())
        if not (loss_err <= TRAIN_CPU_TOL and worst[0] <= GRAD_CPU_TOL):
            raise AssertionError(f"path (T4) {arch}: loss error {loss_err}, worst gradient leaf "
                                 f"{worst}")
        print(f"path (T4) {arch} at full width, {cut}: one loss and gradient at "
              f"{GRAD_BATCH} x {seq}"
              f"{f' over {cfg.encoder_seq:,} frames' if cfg.family == 'encdec' else ''}: "
              f"loss {lg:.6f} on the card vs {lc:.6f} on the CPU port (relative {loss_err:.3g}, "
              f"tolerance {TRAIN_CPU_TOL}); every gradient leaf within {worst[0]:.3g} of its max "
              f"|g| (worst {worst[1]}; tolerance {GRAD_CPU_TOL}); {tg * 1e3:.0f} ms on the card "
              f"(first call), {tc:.1f} s on the CPU  [{card}]")
        del params, runs, gg, gc
        _free(torch)
    launches = dict(COUNTS)
    _no_launches("path (T4)", launches)
    return launches


def refusal_checks(torch, ops):
    """Each kernel launcher refuses an input that requires grad while grad
    is enabled, and launches nothing."""
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.quant.ternary import quantize_and_pack

    dev = torch.device("cuda")
    r = lambda *shape: torch.randn(shape, device=dev)
    g = lambda *shape: torch.randn(shape, device=dev, requires_grad=True)
    i8 = lambda *shape: torch.zeros(shape, dtype=torch.int8, device=dev)
    lengths = torch.tensor([5, 30], dtype=torch.int32, device=dev)
    tables = torch.arange(4, dtype=torch.int32, device=dev).reshape(2, 2)
    w = quantize_and_pack(r(128, 64))
    calls = {
        "act_quant": lambda: ops["act_quant"](g(4, 128), w.scale),
        "tlmm": lambda: ops["tlmm"](i8(4, 128), w.packed, g(4, 1)),
        "prefill": lambda: ops["prefill"](g(1, 4, 32, 64), r(1, 2, 32, 64), r(1, 2, 32, 64)),
        "decode": lambda: ops["decode"](g(2, 2, 2, 64), r(2, 2, 32, 64), r(2, 2, 32, 64), lengths),
        "decode_quant": lambda: ops["decode_quant"](
            g(2, 2, 2, 64), i8(2, 2, 32, 64), r(2, 2, 32), i8(2, 2, 32, 64), r(2, 2, 32), lengths,
            kv_dtype="int8"),
        "paged": lambda: ops["paged"](g(2, 2, 2, 64), r(4, 2, 16, 64), r(4, 2, 16, 64), tables,
                                      lengths),
        "paged_quant": lambda: ops["paged_quant"](
            g(2, 2, 2, 64), i8(4, 2, 16, 64), r(4, 2, 16), i8(4, 2, 16, 64), r(4, 2, 16), tables,
            lengths, kv_dtype="int8"),
    }
    reset_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as err:
            if "has no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"the {name} kernel launched on an input that requires grad")
    torch.cuda.synchronize()
    if any(COUNTS.values()):
        raise AssertionError(f"a refused call launched: {dict(COUNTS)}")
    print(f"refusal: each of the {len(calls)} kernel launchers raised on an input that requires "
          f"grad, and launched nothing")


def training_phase(torch, np, card, ops):
    """Phase 12: paths (T1)-(T4) (each with the counts set to 0 just before
    and read just after: training launches no kernel, (T2)'s serving B1, B2
    and B3 as its stats imply), then the launchers' refusal of autograd.
    Returns the launches summed."""
    total = {}
    for path in (smollm_training, bitnet_qat, granite_moe_training, family_gradients):
        for name, n in path(torch, np, card).items():
            total[name] = total.get(name, 0) + n
    refusal_checks(torch, ops)
    return total


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float()


def _to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return type(tree)(tree.packed.cpu(), tree.scale.cpu())


if __name__ == "__main__":
    sys.exit(main())
