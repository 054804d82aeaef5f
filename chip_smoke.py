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
   then the analysis phase: the kernel pass on the card (``python -m
   repro_torch.analysis.kernel_check --device cuda`` in-process: every one
   of the seven launches over its case grid inside 4 KiB guard bands, twice
   with two fillings of the pads and dead rows, against its plain version,
   the quantized entry points under a dispatch recorder, and the CPU half:
   the registry's launch limits from ``kernels/costs.py`` and the plain
   versions' contracts), its case and finding counts (any finding fails);
   then, where the CUDA toolkit has ``compute-sanitizer``, the same pass in
   a subprocess under ``--tool memcheck`` and B2 and the walks under
   ``--tool racecheck``, each within ``SANITIZER_TIMEOUT_S`` (any error it
   reports fails; a tool that cannot attach to the card is printed once and
   the others are not started); the phase's
   seconds.  Every bound of phase 3 comes from ``kernels/costs.py``
   (``min_bytes`` and ``flops`` of the shape);
4. the main path: bitnet-730m at full width (24 layers, random weights
   from a seed, packed to 2 bits) served by
   ``EngineCore(device="cuda", mode="pdswap", overlap=True)`` to 8 greedy
   requests, after ``build_serving_grid`` (every reachable program built,
   the decode, chunk and sampler programs captured as CUDA graphs: its
   seconds and the pool the graphs reserved are printed); the launch
   counters, set to 0 just before, must equal what the engine's stats imply
   (act-quant as often as B1), the graphs' replays adding what their
   captures counted; no program registered and no graph captured after
   the grid (the warm-up and the 8 requests included); the decode profile (device-side events only: device
   time a round, busy share, operations a round); the served model's logits
   are held against the plain versions on the CPU at full width and cut
   depth; then the main path's and (d)'s configurations decode the same 4
   requests in runs eager, graph, graph, eager (eager: the decode
   program's ``fn`` in its place), which must give the same tokens, each
   printing decode ms a round, device ms and operations a round, busy share
   and peak device memory;
5. the other cache options at full width, each serving the same 8 requests
   (and each driven with the counts set to 0 just before and read just
   after): (a) contiguous int8, pdswap, then one eager decode round of its
   engine under a dispatch recorder, which must allocate no f32 tensor as
   large as one layer's dequantized cache direction; (b) contiguous int4, static;
   (c) paged bf16, 16-token pages, four prompts sharing a 256-token prefix
   (prefix hits asserted); (d) paged int8, with (4)'s check that the grid
   is closed; (e) paged int8 on a pool of 150
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
(MT) training on a mesh of processes, bitnet-730m QAT at full width and
    depth on T2's batches: (MT1) 3 steps on a (data 1, model 1) NCCL mesh
    in a process of its own, started before the build and run while the
    kernels build (it launches none), equal bit for bit to the single
    card's (losses, grad norms, every leaf of params, mu, nu), its report
    printed with the 4-rank world's reports; in that (data 2, model 2) gloo
    world of 4 processes on this card (``--mesh-worker``, which runs (M2),
    then these, then (ME2) and (ME3)), the model cut to ``MT_LAYERS``
    (4) of its 24 layers: (MT2) 5 steps, each rank's MiB of params and
    moments, ms a step and collectives a step, the losses, grad norms and
    moments after step 3 within ``MT_LIMITS`` of the single card's (the
    params read, unlimited), a planted fault (the data axis's gradient
    reduction dropped; 3 steps) breaking each limit, the step-3 checkpoint
    (gathered, written by rank 0) restored onto a (data 1, model 4) mesh
    and onto one card, each running steps 3-4 within the limits of the
    (2, 2) run's; (MT4) the int8 compressed mean over data of the ranks'
    full-width gradients within its bound, its bytes against f32's, the
    JAX test's toy regression on a (pod 4) mesh; (MT3) the trained weights
    packed and served on the (2, 2) mesh (B1 at its shards, B2 on 12
    heads, B3 over sequence halves, as the stats imply), the single-card
    engine's tokens up to near ties;
(ME) MoE expert parallelism on a mesh, granite-moe-3b-a800m (40 experts
    top-8, EP on a model axis of 2: 20 experts a rank, one exchange out and
    one back a layer): in the 4-rank world, (ME2) (t)'s weights at full
    width and depth, each rank keeping its ``shard_params`` slice, the main
    path's first 4 prompts with 16 new tokens on (ME2a) contiguous bf16
    (pdswap, overlap) and (ME2b) paged int8: each rank's launches by shape
    as its stats imply, KV and weight MiB, the exchanges and their bytes a
    round, each layer's dropped assignments, the ranks' snapshots equal;
    (ME3) granite training at 4 of 32 layers (f32, capacity factor 8, so
    nothing drops), 3 steps on T2's batches: the losses, grad norms, aux
    losses and (after step 3) mu and nu within ``ME_LIMITS`` of one card,
    the planted fault (the exchange's backward left out) breaking each;
    then in phase 10, right after (t), on (t)'s weights: (ME1) (t)'s engine
    on (M1)'s (data 1, model 1) NCCL mesh (the exchanges on groups of one,
    the decode graph captured), (t)'s tokens bit for bit; (E4a), (E4b) each
    (ME2) configuration on one card with every MoE call routed in the ranks'
    dispatch groups (a prefill's sequence halves, a round's data-rank rows),
    which (ME2)'s streams must give up to near ties within the (M2) limits,
    each layer's drops by rank printed beside (ME2)'s; (F2) (E4a) with
    expert shard 1's outputs zeroed, the planted fault, breaking the
    limits; phase 3 and the kernel pass also hold B2, B3 and B6 at
    granite's shard shapes (G = 3);
(MF) training of the other families on a mesh, at full width cut in depth
    as (T4) cuts them (``MF_CUTS``: hymba 2 of 32 layers at 4 x 2,048
    tokens, its window masking and its 25 and 5 heads computed whole on
    every rank; xlstm one group of 8 at 4 x 256; whisper 2 + 2 layers at
    4 x 64 over 1,500 frames), f32: (MF1) one step of each on a (data 1,
    model 1) NCCL mesh in a process of its own, run while the kernels
    build, bit for bit with one card; (MF2) in the 4-rank world, after
    (ME), each family 3 steps on (data 2, model 2), each rank on its
    ``shard_params`` slice, within the family's ``MF_LIMITS`` of one card
    (losses, grad norms, mu and nu after step 3), each rank's MiB of params and moments
    and the gloo collectives a step and their MiB, then 1 step with the
    family's planted fault (hymba: the SSM's ``w_bc`` partial sums not
    summed; xlstm: ``hnorm``'s statistic not summed; whisper: the cross
    K/V from the other rank's heads) breaking each limit; no kernel;
    ``--only-family-mesh`` runs the build, (MF1) and (MF2) alone, with no
    result lines;
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
# (M2) against the single card: a model rank's decode walk covers half the
# sequence and the halves are merged (another order of f32 sums), and a
# data rank runs batches of 2 slots (some op of the round then sums in
# another order too; which one is not traced).  Where either
# moves an activation across an int8 rounding step the W1.58-A8 linears
# carry a whole step on.  Read on one card (``mesh_cause_phase``; H100
# 80GB HBM3, 700 W): the split walk alone parts req1 at token 15 with
# margins 0.0082 and 0.0150 and logits 0.0602 apart; 2-slot batches alone
# part nothing, at 0.0544; both give (M2a)'s logits bit for bit; a dropped
# half (the planted fault) parts at margins 0.1053 and 0.0449 with logits
# 0.767 apart.  The limits lie between: a stream may part where both
# margins are within MESH_TIE_TOL, the logits on common tokens within
# MESH_AGREE_TOL.  A sampled stream draws from both runs' rows with the
# same noise, so it may part where the two rows lie within MESH_DRAW_TOL:
# the reordered sums alone move the rows of the cut model up to 0.074
# ((M2c)'s common tokens; (MSc)'s 0.0673, its sampled partings' rows
# 0.0523, 0.0419 and 0.0163, each given by (ES3), its computation on one
# card with no mesh code, within 8.34e-6), the planted faults 0.767 ((F))
# and more ((FS) 0.985)
MESH_TIE_TOL = 0.04
MESH_DRAW_TOL = 0.1
MESH_AGREE_TOL = 0.2
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
    from repro_torch.kernels import costs

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
            cost = costs.tlmm_cost(m, k, n)
            b_ms, b_by = bound(cost.min_bytes, cost.flops, "int8")
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
        cost = costs.prefill_attention_cost(1, 24, 24, s, 64)
        # the kernel's products: three TF32 tensor-core passes (3xTF32) a product
        b_ms, b_by = bound(cost.min_bytes, 3 * cost.flops, "tf32")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        cases.append({
            "shape": f"(1,24,{s},64)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            # the same work on the f32 FMA units
            "bound_f32_fma_ms": bound(cost.min_bytes, cost.flops, "f32")[0],
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
    from repro_torch.kernels import costs
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    b, layers, hkv, smax, d = 4, 24, 24, 2048, 64
    n_pages, bs, pool_pages = 128, 16, 512
    q = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    no_lengths = torch.zeros_like(lengths)
    mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    used = [-(-n // bs) for n in DECODE_LENGTHS]
    qb = q.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}

    def entry(shape, err, run, plain, lib, cost, empty):
        """The kernel's times, and the same launch with every length 0 (the
        fixed cost of the launch, ``empty_ms``)."""
        b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
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
        lambda: sdpa(qb, args[1], args[2], attn_mask=mask),
        costs.decode_attention_cost(DECODE_LENGTHS, hkv, 1, d, cap=smax),
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
            lambda: sdpa(qb, kd, vd, attn_mask=mask),
            costs.decode_attention_cost(DECODE_LENGTHS, hkv, 1, d, kv_dtype=kv_dtype, cap=smax),
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
        costs.decode_attention_cost(DECODE_LENGTHS, hkv, 1, d, paged=True, bs=bs,
                                    cap=n_pages * bs),
        lambda: ops["paged"](*args[:4], no_lengths))
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
            lambda: sdpa(qb, kd, vd, attn_mask=mask),
            costs.decode_attention_cost(DECODE_LENGTHS, hkv, 1, d, kv_dtype=kv_dtype, paged=True,
                                        bs=bs, cap=n_pages * bs),
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
    from repro_torch.kernels import costs
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    b, layers, hkv, smax, d, w = 4, 24, 24, 2048, 64, SPEC_K + 1
    q = torch.randn((b * w, hkv, 1, d), generator=gen, device=dev)
    base = torch.tensor(VERIFY_BASE, dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(w, dtype=torch.int32, device=dev)).reshape(-1)
    no_lengths = torch.zeros_like(lengths)
    mask = (torch.arange(smax, device=dev)[None, None, :] < lengths.reshape(b, w, 1))[:, None]
    qb = q.reshape(b, w, hkv, d).transpose(1, 2).to(torch.bfloat16)
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

    def case(run, plain, empty, err, cost):
        b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
        return {"shape": shape, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                "call_ms": timed_ms(torch, run, flush, busy=False),
                "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed_ms(torch, lambda: sdpa(qb, kd, vd, attn_mask=mask), flush),
                "empty_ms": timed_ms(torch, empty, flush)}

    rows = lengths.tolist()
    out = {
        "decode_attention_quant": case(
            lambda: ops["decode_quant"](q, *planes, lengths, kv_dtype="int8", rows_per_slot=w),
            lambda: refs["decode_quant"](q, *(t.repeat_interleave(w, 0) for t in planes), lengths,
                                         kv_dtype="int8"),
            lambda: ops["decode_quant"](q, *planes, no_lengths, kv_dtype="int8", rows_per_slot=w),
            err, costs.decode_attention_cost(rows, hkv, 1, d, kv_dtype="int8", cap=smax,
                                             rows_per_slot=w)),
        "paged_decode_attention_quant": case(
            lambda: ops["paged_quant"](q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8"),
            lambda: refs["paged_quant"](q, kp, ksp, vp, vsp, tables, lengths, kv_dtype="int8"),
            lambda: ops["paged_quant"](q, kp, ksp, vp, vsp, tables, no_lengths, kv_dtype="int8"),
            err_p, costs.decode_attention_cost(rows, hkv, 1, d, kv_dtype="int8", paged=True,
                                               bs=16, cap=smax, rows_per_slot=w)),
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
    from repro_torch.kernels import costs
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
        cost = costs.prefill_attention_cost(1, h, hkv, s, d)
        b_ms, b_by = bound(cost.min_bytes, 3 * cost.flops, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) Hkv={hkv} f32 (qwen2.5-14b)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(cost.min_bytes, cost.flops, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                                   flush)}))
        del q, k, v
    b, smax, bs, pool_pages = 4, 2048, 16, 512
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
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
            cost = costs.decode_attention_cost(DECODE_LENGTHS, hkv, g, d, kv_dtype=kv_dtype,
                                               paged=bool(walk_tables), bs=bs, cap=smax)
            b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
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


def _walk_case(torch, ops, refs, flush, what, q, k, v, lengths, starts, view=None):
    """One B3 case against its plain version: err, kernel / plain / SDPA
    times and the bound.  q (B, Hkv, G, D) f32, k/v (B, Hkv, S, D) bf16
    views the kernel walks; the plain version and the SDPA yardstick (the
    [start, length) mask, ``enable_gqa``) read ``view`` (k, v) where given,
    else k/v."""
    from repro_torch.kernels import costs

    b, hkv, g, d = q.shape
    kr, vr = (k, v) if view is None else view
    got = ops["decode"](q, k, v, lengths, starts)
    err = _check_err(f"decode_attention {what}", got, refs["decode"](q, kr, vr, lengths, starts))
    pos = torch.arange(kr.shape[2], device=q.device)[None, :]
    lo = torch.zeros_like(lengths) if starts is None else starts
    mask = ((pos < lengths[:, None]) & (pos >= lo[:, None]))[:, None, None, :]
    qb = q.reshape(b, hkv * g, 1, d).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cost = costs.decode_attention_cost(lengths.tolist(), hkv, g, d, cap=k.shape[2],
                                       starts=None if starts is None else starts.tolist())
    b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
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
    from repro_torch.kernels import costs

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    h, d = WHISPER_PREFILL
    for s in WHISPER_PREFILL_LENS:
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev) for _ in range(3))
        err = (ops["prefill"](q, k, v) - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at (1,{h},{s},{d})")
        cost = costs.prefill_attention_cost(1, h, h, s, d)
        b_ms, b_by = bound(cost.min_bytes, 3 * cost.flops, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) f32 (whisper-large-v3 decoder)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(cost.min_bytes, cost.flops, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True), flush)}))
        del q, k, v
    hkv, g, d, layers, smax, window = HYMBA_WALK
    b = len(HYMBA_WALK_LENGTHS)
    lengths = torch.tensor(HYMBA_WALK_LENGTHS, dtype=torch.int32, device=dev)
    starts = torch.clamp(lengths + 1 - window, min=0).to(torch.int32)
    planes = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev,
                          dtype=torch.bfloat16)[:, 7] for _ in range(2)]
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    out.append(("decode_attention", _walk_case(
        torch, ops, refs, flush,
        f"hymba-1.5b: B={b} Hkv={hkv} G={g} D={d} lengths={HYMBA_WALK_LENGTHS} window {window} "
        f"(starts {starts.tolist()}) bf16 layer slice of ({b},{layers},{hkv},{smax},{d})",
        q, *planes, lengths, starts)))
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
        q, *planes, lengths, None, view=[t[:, :, :enc] for t in planes])))
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
        q, *planes, lengths, None)))
    del planes
    return out


# the shard shapes of phase (M): bitnet-730m on a (data 2, model 2) mesh
MESH_TLMM = ((1536, 768), (1536, 2048), (768, 1536), (2048, 1536))  # (K, N): column / row shards
MESH_PREFILL = (12, 64)  # heads a model rank prefills (24 / 2), D
MESH_LENGTHS = [300, 1300]  # a data rank's 2 slots over max_len 2048: halves of 1,024 rows


def mesh_kernel_checks(torch, ops, refs, flush, gen):
    """Phase 3 at the shard shapes of phase (M): B1 at a model rank's
    column shards (N / 2) and row shards (K / 2), at the decode rows (M =
    2 slots of a data rank) and 1,024 prefill rows; B2 on 12 of 24 heads;
    B3 and B4 on one model rank's half of the sequence (a layer slice of a
    (2, 24, 24, 1024, 64) block, lengths cut to the half: the second half
    holds an empty slot), the two halves' walks merged as the ranks merge
    them against the whole walk; B5 and B6 over a data rank's 2 slots of
    a whole pool (``walk_shard_checks``).  Each against its plain version,
    timed beside its bound and its library yardstick.  Returns [(kernel,
    case)].  Then the verify pass's walks at a data rank's verify rows
    (``verify_shard_checks``), and B1 also at those rows (M = 10) and a
    256-row chunk's."""
    from repro_torch.kernels import costs

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    # decode rows (2 slots), a verify round's rows (2 slots x 5), a chunk's
    # 256 rows, a prefill's 1,024
    for m in (2, MESH_VERIFY_ROWS, CHUNK, 1024):
        for k, n in MESH_TLMM:
            x_q = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
            w = torch.randint(0, 256, (k // 4, n), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
            scale = torch.ones((m, 1), device=dev)  # a row shard's partial sum: a unit scale
            if not torch.equal(ops["tlmm"](x_q, w, scale), refs["tlmm"](x_q, w, scale)):
                raise AssertionError(f"TLMM kernel differs from its plain version at the shard "
                                     f"M={m} K={k} N={n}")
            wu = refs["unpack"](w)
            if m > 64:
                lib = lambda: torch._int_mm(x_q, wu)  # noqa: E731
            else:
                xb, wb = x_q.to(torch.bfloat16), wu.to(torch.bfloat16)
                lib = lambda: xb @ wb  # noqa: E731
            cost = costs.tlmm_cost(m, k, n)
            b_ms, b_by = bound(cost.min_bytes, cost.flops, "int8")
            out.append(("tlmm", {
                "shape": f"M={m} K={k} N={n} (a model rank's "
                         f"{'row' if (k, n) in MESH_TLMM[2:] else 'column'} shard)",
                "max_abs_err": 0.0,
                "ms": timed_ms(torch, lambda: ops["tlmm"](x_q, w, scale), flush),
                "call_ms": timed_ms(torch, lambda: ops["tlmm"](x_q, w, scale), flush, busy=False),
                "plain_ms": timed_ms(torch, lambda: refs["tlmm"](x_q, w, scale), flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": timed_ms(torch, lib, flush)}))
    h, d = MESH_PREFILL
    for s in (256, 1536):
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev) for _ in range(3))
        err = (ops["prefill"](q, k, v) - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at (1,{h},{s},{d})")
        cost = costs.prefill_attention_cost(1, h, h, s, d)
        b_ms, b_by = bound(cost.min_bytes, 3 * cost.flops, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) f32 (12 of bitnet-730m's 24 heads)", "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(cost.min_bytes, cost.flops, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True), flush)}))
        del q, k, v
    return out + walk_shard_checks(
        torch, ops, refs, flush, gen, MESH_LENGTHS, ("int8", "int4"), ("fp", "int8"),
        "model rank {r}'s sequence half", "a data rank's 2 slots") + verify_shard_checks(
        torch, ops, refs, flush, gen, MESH_VERIFY_BASE, ("int8", "fp"), ("fp", "int8"),
        "model rank {r}'s sequence half, a data rank's 2 slots x {w} verify rows",
        "a data rank's 2 slots x {w} verify rows")


MESH_VERIFY_ROWS = 2 * (SPEC_K + 1)  # a data rank's verify rows: 2 slots x W
# a data rank's 2 slots at a verify round of (MSc): slot 0's block of 5
# rows [1,022, 1,027) straddles the two sequence halves of 1,024 rows
MESH_VERIFY_BASE = [1022, 300]
SPLIT_VERIFY_BASE = [80, 1021, 316, 916]  # (MD3)'s 4 slots, one block across the halves


def verify_shard_checks(torch, ops, refs, flush, gen, base, quant, paged_formats, half_what,
                        pool_what):
    """The verify pass's walks at a decode rank's shard shapes of
    bitnet-730m (24 heads of 64, max_len 2,048, 16-token pages),
    ``rows_per_slot`` W = 5: B4 (``quant`` "int8") or B3 ("fp") over each
    model rank's half of the sequence (a layer slice of a (B, 24, 24, 1024,
    64) block), row (b, i) at its local length ``clamp(base[b] + i - r *
    1024, 0, 1024)``; the two halves' walks merged as the ranks merge them
    against the whole walk within the limit of ``verify_row_checks``; B5
    and B6 (``paged_formats``) over B slots' tables, each table row W
    times, into a whole pool of 512 pages.  B = len(base).  Each against
    its plain version, timed beside its bound and its library yardstick.
    Returns [(kernel, case)]."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.layers.attention import combine_partials
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    b, layers, hkv, d, smax, bs, w = len(base), 24, 24, 64, 2048, 16, SPEC_K + 1
    half = smax // 2
    glob = (torch.tensor(base, dtype=torch.int32, device=dev)[:, None]
            + torch.arange(w, dtype=torch.int32, device=dev)).reshape(-1)
    q = torch.randn((b * w, hkv, 1, d), generator=gen, device=dev)
    qb = q.reshape(b, w, hkv, d).transpose(1, 2).to(torch.bfloat16)

    def entry(kernel, what, err, run, plain, lib, cost):
        b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
        out.append((kernel, {"shape": what, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                             "call_ms": timed_ms(torch, run, flush, busy=False),
                             "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": timed_ms(torch, lib, flush)}))

    def rep(t):
        return t.repeat_interleave(w, 0)

    for kv_dtype in quant:
        if kv_dtype == "fp":
            whole = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev,
                                 dtype=torch.bfloat16)[:, 7] for _ in range(2)]
            name, kernel, kw = "decode", "decode_attention", {}
        else:
            (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (b, layers, hkv, smax, d),
                                                    kv_dtype) for _ in range(2))
            whole = [kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7]]
            name, kernel, kw = "decode_quant", "decode_attention_quant", {"kv_dtype": kv_dtype}
        parts = []
        for r in range(2):
            planes = [t[:, :, r * half:(r + 1) * half] for t in whole]
            local = torch.clamp(glob - r * half, 0, half).to(torch.int32)
            got = ops[name](q, *planes, local, rows_per_slot=w, **kw)
            err = _check_err(f"{kernel} verify rows, sequence half {r}", got,
                             refs[name](q, *(rep(t) for t in planes), local, **kw))
            parts.append(got)
            if kv_dtype == "fp":
                kd, vd = planes
            else:
                kd, vd = (dequantize_kv(p_, s_, kv_dtype).to(torch.bfloat16)
                          for p_, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
            mask = (torch.arange(half, device=dev)[None, None, :]
                    < local.reshape(b, w, 1))[:, None]
            fmt = "bf16" if kv_dtype == "fp" else kv_dtype
            entry(kernel, f"{half_what.format(r=r, w=w)}: B*W={b * w} Hkv={hkv} D={d} local "
                  f"lengths {local.tolist()} of {half} rows, {fmt} layer slice, rows_per_slot "
                  f"{w}", err,
                  lambda: ops[name](q, *planes, local, rows_per_slot=w, **kw),
                  lambda: refs[name](q, *(rep(t) for t in planes), local, **kw),
                  lambda: sdpa(qb, kd, vd, attn_mask=mask),
                  costs.decode_attention_cost(local.tolist(), hkv, 1, d, kv_dtype=kv_dtype,
                                              cap=half, rows_per_slot=w))
            del kd, vd
        merged = combine_partials(*(torch.stack([p_[i].reshape(b * w, hkv, -1) for p_ in parts])
                                    for i in range(3)))
        full = refs[name](q, *(rep(t) for t in whole), glob, **kw)
        merr = max((merged[0] - full[0].reshape(b * w, hkv, -1)).abs().max().item(),
                   ((merged[1] - full[1].reshape(b * w, hkv, -1)).abs()
                    / full[1].reshape(b * w, hkv, -1).clamp(min=1.0)).max().item())
        if not merr <= 1e-4:
            raise AssertionError(f"{kernel} verify rows: the two sequence halves' walks merge "
                                 f"{merr} off the whole walk")
        print(f"kernel {kernel}: verify rows of {b} slots x {w} over the two model ranks' "
              f"halves (a block across the boundary) merged = the whole walk within {merr:.3g}")
        del whole, parts
    pool_pages, n_pages = 512, smax // bs
    used = [-(-(n + w) // bs) for n in base]
    perm = torch.randperm(pool_pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.zeros((b, n_pages), dtype=torch.int32, device=dev)
    at = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[at:at + u]
        at += u
    rows = rep(tables)
    mask = (torch.arange(smax, device=dev)[None, None, :] < glob.reshape(b, w, 1))[:, None]
    for kv_dtype in paged_formats:
        name = "paged" if kv_dtype == "fp" else "paged_quant"
        kernel = "paged_decode_attention" + ("" if kv_dtype == "fp" else "_quant")
        kw = {} if kv_dtype == "fp" else {"kv_dtype": kv_dtype}
        if kv_dtype == "fp":
            planes = [torch.randn((pool_pages, layers, hkv, bs, d), generator=gen, device=dev,
                                  dtype=torch.bfloat16)[:, 7] for _ in range(2)]
            kd, vd = (gather_pages(p_, tables) for p_ in planes)
        else:
            (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev,
                                                    (pool_pages, layers, hkv, bs, d), kv_dtype)
                                    for _ in range(2))
            planes = [kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7]]
            kd, vd = (dequantize_kv(gather_pages(p_, tables), gather_scales(s_, tables),
                                    kv_dtype).to(torch.bfloat16)
                      for p_, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
        args = (q, *planes, rows, glob)
        got = ops[name](*args, **kw)
        err = _check_err(f"{kernel} {pool_what.format(w=w)}", got, refs[name](*args, **kw))
        entry(kernel, f"{pool_what.format(w=w)}: B*W={b * w} Hkv={hkv} N={pool_pages} bs={bs} "
              f"lengths {base} + 0..{w - 1}, {'bf16' if kv_dtype == 'fp' else kv_dtype} whole "
              f"pool, each table row {w} times", err, lambda: ops[name](*args, **kw),
              lambda: refs[name](*args, **kw), lambda: sdpa(qb, kd, vd, attn_mask=mask),
              costs.decode_attention_cost(glob.tolist(), hkv, 1, d, kv_dtype=kv_dtype,
                                          paged=True, bs=bs, cap=smax, rows_per_slot=w))
        del planes, args, kd, vd
    return out


def walk_shard_checks(torch, ops, refs, flush, gen, lengths_, quant_half, paged_formats,
                      half_what, pool_what):
    """The walks at a decode rank's shard shapes of bitnet-730m (24 heads of
    64, max_len 2,048, 16-token pages): B3 over each model rank's half of
    the sequence (a layer slice of a (B, 24, 24, 1024, 64) block, the
    lengths cut to the half), the two halves merged as the ranks merge them
    against the whole walk; B4 (``quant_half``) on model rank 1's half; B5
    and B6 (``paged_formats``) over B slots' tables into a whole pool of 512
    pages.  B = len(lengths_).  Each against its plain version, timed beside
    its bound and its library yardstick.  Returns [(kernel, case)]."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.layers.attention import combine_partials
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    b, layers, hkv, d, smax, bs = len(lengths_), 24, 24, 64, 2048, 16
    half = smax // 2
    glob = torch.tensor(lengths_, dtype=torch.int32, device=dev)
    halves = [torch.clamp(glob - r * half, 0, half).to(torch.int32) for r in range(2)]
    q = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    qb = q.to(torch.bfloat16)

    def entry(kernel, what, err, run, plain, lib, cost):
        b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
        out.append((kernel, {"shape": what, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                             "call_ms": timed_ms(torch, run, flush, busy=False),
                             "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": timed_ms(torch, lib, flush)}))

    whole = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2)]
    parts = []
    for r, lengths in enumerate(halves):
        kv = [t[:, 7, :, r * half:(r + 1) * half] for t in whole]
        got = ops["decode"](q, *kv, lengths)
        err = _check_err(f"B3 sequence half {r}", got, refs["decode"](q, *kv, lengths))
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"B3 on sequence half {r}: an empty slot gave a NaN")
        parts.append(got)
        mask = (torch.arange(half, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        entry("decode_attention",
              f"{half_what.format(r=r)}: B={b} Hkv={hkv} D={d} local lengths "
              f"{lengths.tolist()} of {half} rows bf16 layer slice of ({b},{layers},{hkv},{half},{d})",
              err, lambda: ops["decode"](q, *kv, lengths), lambda: refs["decode"](q, *kv, lengths),
              lambda: sdpa(qb, *kv, attn_mask=mask),
              costs.decode_attention_cost(lengths.tolist(), hkv, 1, d, cap=half))
    merged = combine_partials(*(torch.stack([p_[i].reshape(b, hkv, -1) for p_ in parts])
                                for i in range(3)))
    full = refs["decode"](q, whole[0][:, 7], whole[1][:, 7], glob)
    merr = (merged[0] - full[0].reshape(b, hkv, -1)).abs().max().item()
    if not merr <= 1e-4:
        raise AssertionError(f"the two sequence halves' walks merge {merr} off the whole walk")
    print(f"kernel decode_attention: the two model ranks' halves of {b} slots merged = the "
          f"whole walk within {merr:.3g}")
    del whole
    for kv_dtype in quant_half:
        lengths = halves[1]
        (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (b, layers, hkv, half, d),
                                                kv_dtype) for _ in range(2))
        args = (q, kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7], lengths)
        got = ops["decode_quant"](*args, kv_dtype=kv_dtype)
        err = _check_err(f"B4 {kv_dtype} sequence half", got,
                         refs["decode_quant"](*args, kv_dtype=kv_dtype))
        kd, vd = (dequantize_kv(p_, s_, kv_dtype).to(torch.bfloat16)
                  for p_, s_ in ((args[1], args[2]), (args[3], args[4])))
        mask = (torch.arange(half, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        entry("decode_attention_quant",
              f"{half_what.format(r=1)}: B={b} Hkv={hkv} D={d} local lengths "
              f"{lengths.tolist()} of {half} rows {kv_dtype} layer slice",
              err, lambda: ops["decode_quant"](*args, kv_dtype=kv_dtype),
              lambda: refs["decode_quant"](*args, kv_dtype=kv_dtype),
              lambda: sdpa(qb, kd, vd, attn_mask=mask),
              costs.decode_attention_cost(lengths.tolist(), hkv, 1, d, kv_dtype=kv_dtype,
                                          cap=half))
        del kc, ksc, vc, vsc, kd, vd
    pool_pages, n_pages = 512, smax // bs
    used = [-(-n // bs) for n in lengths_]
    perm = torch.randperm(pool_pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.zeros((b, n_pages), dtype=torch.int32, device=dev)
    at = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[at:at + u]
        at += u
    mask = (torch.arange(smax, device=dev)[None, :] < glob[:, None])[:, None, None, :]
    for kv_dtype in paged_formats:
        name = "paged" if kv_dtype == "fp" else "paged_quant"
        kernel = "paged_decode_attention" + ("" if kv_dtype == "fp" else "_quant")
        kw = {} if kv_dtype == "fp" else {"kv_dtype": kv_dtype}
        if kv_dtype == "fp":
            planes = [torch.randn((pool_pages, layers, hkv, bs, d), generator=gen, device=dev,
                                  dtype=torch.bfloat16)[:, 7] for _ in range(2)]
            kd, vd = (gather_pages(p_, tables) for p_ in planes)
        else:
            (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev,
                                                    (pool_pages, layers, hkv, bs, d), kv_dtype)
                                    for _ in range(2))
            planes = [kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7]]
            kd, vd = (dequantize_kv(gather_pages(p_, tables), gather_scales(s_, tables),
                                    kv_dtype).to(torch.bfloat16)
                      for p_, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
        args = (q, *planes, tables, glob)
        got = ops[name](*args, **kw)
        err = _check_err(f"{kernel} {pool_what}", got, refs[name](*args, **kw))
        entry(kernel, f"{pool_what}: B={b} Hkv={hkv} N={pool_pages} bs={bs} "
              f"lengths={lengths_} {'bf16' if kv_dtype == 'fp' else kv_dtype} whole pool",
              err, lambda: ops[name](*args, **kw), lambda: refs[name](*args, **kw),
              lambda: sdpa(qb, kd, vd, attn_mask=mask),
              costs.decode_attention_cost(lengths_, hkv, 1, d, kv_dtype=kv_dtype, paged=True,
                                          bs=bs, cap=smax))
        del planes, args, kd, vd
    return out




SPLIT_LENGTHS = [80, 1552, 316, 916]  # (MD)'s 4 slots after 16 tokens: its prompts + 16


def split_kernel_checks(torch, ops, refs, flush, gen):
    """Phase 3 at a decode rank's shapes on the pod split (MD): B3 over each
    model rank's half of the sequence at the pool's 4 slots (data 1: every
    slot on every rank), B6 over 4 slots of the whole pool of 512 int8
    pages (MD2) (``walk_shard_checks``); B4 over each half and B6 at (MD3)'s
    verify rows, 4 slots x 5 (``verify_shard_checks``)."""
    return walk_shard_checks(torch, ops, refs, flush, gen, SPLIT_LENGTHS, (), ("int8",),
                             "the split's decode rank {r}, 4 slots", "the split's decode rank, "
                             "data 1: 4 slots") + verify_shard_checks(
        torch, ops, refs, flush, gen, SPLIT_VERIFY_BASE, ("int8",), ("int8",),
        "the split's decode rank {r}, 4 slots x {w} verify rows",
        "the split's decode rank, data 1: 4 slots x {w} verify rows")


# the shard shapes of phase (ME): granite-moe-3b-a800m on a (data 2, model 2)
# mesh: 24 heads over 8 KV heads of 64; prefill 12 of them over 4 KV heads,
# decode every head (G = 3) over a sequence half or a data rank's slots
MOE_MESH_PREFILL = (12, 4, 64)  # H, Hkv, D a model rank prefills
MOE_MESH_WALK = (8, 3, 64, 32)  # Hkv, G, D, layers of a decode step


def moe_mesh_kernel_checks(torch, ops, refs, flush, gen):
    """Phase 3 at the shard shapes of phase (ME): B2 on 12 of granite's 24
    heads over 4 of its 8 KV heads (S 256 and 1,536); B3 on each model
    rank's half of the sequence (a layer slice of a (2, 32, 8, 1024, 64)
    block, ``MESH_LENGTHS`` cut to the half) at G = 3; B6 over a data
    rank's 2 slots of a whole int8 pool at G = 3.  Each against its plain
    version, timed beside its bound and SDPA with ``enable_gqa``.  Returns
    [(kernel, case)]."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.paged_attention.ref import gather_pages, gather_scales
    from repro_torch.quant.kv_quant import dequantize_kv

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    h, hkv, d = MOE_MESH_PREFILL
    for s in (256, 1536):
        q = torch.randn((1, h, s, d), generator=gen, device=dev)
        k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev) for _ in range(2))
        err = (ops["prefill"](q, k, v) - refs["prefill"](q, k, v)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"prefill attention kernel off by {err} at granite's shard "
                                 f"(1,{h},{s},{d}) Hkv={hkv}")
        cost = costs.prefill_attention_cost(1, h, hkv, s, d)
        b_ms, b_by = bound(cost.min_bytes, 3 * cost.flops, "tf32")
        out.append(("prefill_attention", {
            "shape": f"(1,{h},{s},{d}) Hkv={hkv} f32 (12 of granite's 24 heads)",
            "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush),
            "call_ms": timed_ms(torch, lambda: ops["prefill"](q, k, v), flush, busy=False),
            "plain_ms": timed_ms(torch, lambda: refs["prefill"](q, k, v), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_fma_ms": bound(cost.min_bytes, cost.flops, "f32")[0],
            "library_ms": timed_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                                   flush)}))
        del q, k, v
    hkv, g, d, layers = MOE_MESH_WALK
    b, smax, bs, pool_pages = 2, 2048, 16, 512
    half = smax // 2
    glob = torch.tensor(MESH_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    qb = q.reshape(b, hkv * g, 1, d).to(torch.bfloat16)

    def entry(kernel, what, err, run, plain, lib, cost):
        b_ms, b_by = bound(cost.min_bytes, cost.flops, "f32")
        out.append((kernel, {"shape": what, "max_abs_err": err, "ms": timed_ms(torch, run, flush),
                             "call_ms": timed_ms(torch, run, flush, busy=False),
                             "plain_ms": timed_ms(torch, plain, flush), "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": timed_ms(torch, lib, flush)}))

    whole = [torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2)]
    for r in range(2):
        lengths = torch.clamp(glob - r * half, 0, half).to(torch.int32)
        kv = [t[:, 7, :, r * half:(r + 1) * half] for t in whole]
        got = ops["decode"](q, *kv, lengths)
        err = _check_err(f"B3 granite sequence half {r}", got, refs["decode"](q, *kv, lengths))
        mask = (torch.arange(half, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        entry("decode_attention",
              f"granite, model rank {r}'s sequence half: B={b} Hkv={hkv} G={g} D={d} local "
              f"lengths {lengths.tolist()} of {half} rows bf16 layer slice of "
              f"({b},{layers},{hkv},{half},{d})",
              err, lambda: ops["decode"](q, *kv, lengths), lambda: refs["decode"](q, *kv, lengths),
              lambda: sdpa(qb, *kv, attn_mask=mask, enable_gqa=True),
              costs.decode_attention_cost(lengths.tolist(), hkv, g, d, cap=half))
    del whole
    used = [-(-n // bs) for n in MESH_LENGTHS]
    perm = torch.randperm(pool_pages, generator=gen, device=dev).to(torch.int32)
    tables = torch.zeros((b, smax // bs), dtype=torch.int32, device=dev)
    tables[0, :used[0]] = perm[:used[0]]
    tables[1, :used[1]] = perm[used[0]:used[0] + used[1]]
    mask = (torch.arange(smax, device=dev)[None, :] < glob[:, None])[:, None, None, :]
    (kc, ksc), (vc, vsc) = (_random_payload(torch, gen, dev, (pool_pages, layers, hkv, bs, d),
                                            "int8") for _ in range(2))
    planes = [kc[:, 7], ksc[:, 7], vc[:, 7], vsc[:, 7]]
    kd, vd = (dequantize_kv(gather_pages(p_, tables), gather_scales(s_, tables),
                            "int8").to(torch.bfloat16)
              for p_, s_ in ((planes[0], planes[1]), (planes[2], planes[3])))
    args = (q, *planes, tables, glob)
    got = ops["paged_quant"](*args, kv_dtype="int8")
    err = _check_err("B6 granite a data rank's slots", got,
                     refs["paged_quant"](*args, kv_dtype="int8"))
    entry("paged_decode_attention_quant",
          f"granite, a data rank's 2 slots: B={b} Hkv={hkv} G={g} D={d} N={pool_pages} bs={bs} "
          f"lengths={MESH_LENGTHS} int8 whole pool",
          err, lambda: ops["paged_quant"](*args, kv_dtype="int8"),
          lambda: refs["paged_quant"](*args, kv_dtype="int8"),
          lambda: sdpa(qb, kd, vd, attn_mask=mask, enable_gqa=True),
          costs.decode_attention_cost(MESH_LENGTHS, hkv, g, d, kv_dtype="int8", paged=True,
                                      bs=bs, cap=smax))
    return out


# ---- the analysis phase --

SANITIZER_TIMEOUT_S = 120  # each compute-sanitizer run of the kernel pass
RACECHECK_KERNELS = ("prefill_attention", "decode_attention", "decode_attention_quant",
                     "paged_decode_attention", "paged_decode_attention_quant")


def _sanitizer() -> str | None:
    import shutil

    found = shutil.which("compute-sanitizer")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/compute-sanitizer")
    return str(cand) if cand.exists() else None


def _sanitized(tool: str, binary: str, kernels=None):
    """The kernel pass on the card in a subprocess under ``compute-sanitizer
    --tool tool``: (ran, errors, seconds, what it said last).  ``ran`` is
    False where the tool reported no summary (it could not run here)."""
    import os
    import re
    import signal

    cmd = [binary, "--tool", tool, sys.executable, "-m", "repro_torch.analysis.kernel_check",
           "--device", "cuda"] + (["--kernels", ",".join(kernels)] if kernels else [])
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=SANITIZER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return False, 0, time.perf_counter() - t0, f"cut at its {SANITIZER_TIMEOUT_S} s limit"
    seconds = time.perf_counter() - t0
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", out)
    refused = re.search(r"Error: (Device not supported[^\n]*)", out)
    tail = " | ".join(line.strip() for line in out.strip().splitlines()[-3:])
    if refused:  # the tool cannot attach to this card here: its "errors" are its own
        return False, 0, seconds, f"exit {proc.returncode}: {refused.group(1).strip()}"
    if not summary:
        return False, 0, seconds, f"exit {proc.returncode}: {tail}"
    return True, sum(int(n) for n in summary), seconds, tail


def analysis_phase(torch, card):
    """Phase 3b: the kernel pass on the card (every launch inside guard
    bands, against its plain version, plus the CPU half), then the same
    pass under compute-sanitizer's memcheck, and racecheck over B2 and the
    walks, where the toolkit has the tool.  Any finding fails the run: no
    baseline waives one here."""
    from repro_torch.analysis import kernel_check

    t0 = time.perf_counter()
    stats = {}
    found = kernel_check.run(Path(__file__).resolve().parent / "src" / "repro_torch",
                             device="cuda", stats=stats)
    for f in found:
        print(f"  {f.render()}")
    print(f"analysis: kernel pass: {stats['cases']} cases on the card over the seven launches "
          f"(guard bands, two fillings, against the plain versions), {stats['contracts']} "
          f"plain-version contract checks, {stats['launches']} launch shapes of the registry "
          f"within 227 KiB and 8-block clusters: {len(found)} findings; largest difference "
          f"from the plain version: "
          + ", ".join(f"{k} {v:.3g}" for k, v in stats["max_err"].items()) + f"  [{card}]")
    if found:
        raise AssertionError(f"the kernel pass found {len(found)} faults")
    binary = _sanitizer()
    if binary is None:
        print("analysis: compute-sanitizer is absent from this CUDA toolkit: not run")
    else:
        for tool, kernels in (("memcheck", None), ("racecheck", RACECHECK_KERNELS)):
            ran, errors, seconds, said = _sanitized(tool, binary, kernels)
            which = "every launch" if kernels is None else "B2 and the walks"
            if not ran:
                print(f"analysis: compute-sanitizer --tool {tool} ({which}) did not run to a "
                      f"summary in {seconds:.1f} s: {said}")
                if "Device not supported" in said:
                    print("analysis: compute-sanitizer cannot attach to this card: its other "
                          "tools not run")
                    break
                continue
            print(f"analysis: compute-sanitizer --tool {tool} ({which}): {errors} errors in "
                  f"{seconds:.1f} s  [{card}]")
            if errors:
                raise AssertionError(f"compute-sanitizer {tool} reported {errors} errors: {said}")
    print(f"analysis: phase {time.perf_counter() - t0:.1f} s  [{card}]")


def grid_closure(eng, grid, what, card):
    """No program registered and no graph captured after
    ``build_serving_grid`` (the warm-up and the served requests included):
    a capture inside a served request is a latency spike."""
    engines = [eng.runner.engine] + ([eng.prefill_pool.engine] if hasattr(eng, "prefill_pool")
                                     else [])
    registered = sum(len(set(e.programs) - grid["programs"]) for e in engines)
    captured = sum(1 for e in engines for k, p in e.programs.items()
                   if p.captured is not None and k not in grid["captured"])
    print(f"analysis: {what} after build_serving_grid, its warm-up and {len(eng.finished) - 1} "
          f"requests: {registered} programs registered, {captured} graphs captured  [{card}]")
    if registered or captured:
        raise AssertionError(f"{what}: {registered} programs registered and {captured} graphs "
                             "captured after the serving grid was built")


def eager_round_f32(torch, eng, cfg, card):
    """One eager decode round of a quantized contiguous engine (its
    program's ``fn``, idle lengths: every slot is free) under the dispatch
    recorder: no f32 allocation as large as one layer's dequantized cache
    direction (a wrapper that fell back to dequantizing its operand)."""
    from repro_torch.analysis.progcheck import OpRecorder

    runner = eng.runner
    n = len(runner.slots.slots)
    threshold = n * cfg.num_kv_heads * runner.max_len * cfg.head_dim
    lengths = runner.slots.lengths_array({s: 0 for s in range(n)})
    args = (runner.params, runner.last_tokens, runner.cache, lengths)
    rec = OpRecorder(args)
    with torch.no_grad(), rec:
        runner.decode_prog.fn(*args)
    torch.cuda.synchronize()
    big = rec.f32_at_least(threshold)
    largest = max((math.prod(sh) for op, sh, dt in rec.ops if dt == torch.float32), default=0)
    print(f"analysis: one eager int8 decode round of (a): {len(rec.ops)} allocations, the "
          f"largest f32 {largest} elements against one layer's dequantized cache direction of "
          f"{threshold}: {len(big)} as large  [{card}]")
    if big:
        raise AssertionError(f"(a)'s eager round allocates f32 {big[0]}: a dequantized layer cache")


_T0 = time.perf_counter()


def _elapsed(what: str) -> None:
    """The script's seconds so far, printed where a phase starts: where the
    1,200 s the smoke may take go."""
    print(f"elapsed {time.perf_counter() - _T0:.1f} s at the start of {what}", flush=True)


class _EarlyRuns:
    """Checks that read nothing a phase before them left, run in this
    process while the 4-rank world runs (this process would only wait on
    it), each with its printout held and printed, and its failure raised,
    where the check stands in the run (``take``)."""

    def __init__(self):
        self.done = {}

    def run(self, key, fn):
        import io

        buf, t0 = io.StringIO(), time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                got = (True, fn())
        except Exception as e:  # noqa: BLE001 — raised by take, where the check stands
            got = (False, e)
        self.done[key] = got + (buf.getvalue(), time.perf_counter() - t0)

    def take(self, key, fn):
        """``fn()``'s result, from the early run where there was one."""
        if key not in self.done:
            return fn()
        ok, got, out, seconds = self.done.pop(key)
        sys.stdout.write(out)
        print(f"  ({key}: run beside the 4-rank world, {seconds:.1f} s)")
        if not ok:
            raise got
        return got


EARLY = _EarlyRuns()


def main(only: str | None = None) -> int:
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

    # ---- 2. build, with (MT1) in a process of its own meanwhile (it launches
    # no kernel, and the card is idle while nvcc runs on the host)
    mt1, mf1 = mesh_train_m1_start(), mesh_train_m1_start("--mesh-family-m1")
    t0 = time.perf_counter()
    try:
        info = build.build_all()
    except BaseException:
        for proc in (mt1, mf1):
            proc.kill()
            proc.wait()
        raise
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(info)} sources")
    for name, rec in info.items():
        print(f"  {name}: {rec['seconds']:.1f} s{' (cached)' if rec['cached'] else ''}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    try:
        mt1_report = mesh_train_m1_wait(mt1)
    finally:
        mf1_report = mesh_train_m1_wait(mf1, "(MF1)")
    if only == "mesh-train":  # a development run of phase (MT) alone: no result line
        mesh_world_phase(torch, card, parts=("MT",), mt1_report=mt1_report)
        return 0
    if only == "family-mesh":  # a development run of phase (MF) alone: no result line
        mesh_world_phase(torch, card, parts=("MF",), mf1_report=mf1_report)
        return 0
    if only == "moe-mesh":  # a development run of phase (ME) alone: no result line
        moe_mesh_only(torch, np, card)
        return 0
    if only in ("disagg-mesh", "spec-mesh"):  # (MD), or (MS) and (MD): no result line
        cfg = get_config("bitnet-730m")
        params = T.convert_for_inference(T.init(cfg, seed=0, device="cuda"), cfg)

        def refs():
            return md_references(torch, np, cfg, params)

        def cut_refs():
            return mesh_spec_references(torch, np)

        parts = ("MD",) if only == "disagg-mesh" else ("MS", "MD")
        mesh_world_phase(torch, card, parts=parts,
                         beside=[("(MD) references", refs), ("(MS) references", cut_refs)],
                         md_refs=lambda: EARLY.take("(MD) references", refs),
                         ms_refs=lambda: EARLY.take("(MS) references", cut_refs))
        return 0

    _elapsed("kernel checks")
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
                                                    torch.Generator(device="cuda").manual_seed(2))
                       + mesh_kernel_checks(torch, ops, refs, flush,
                                            torch.Generator(device="cuda").manual_seed(3))
                       + moe_mesh_kernel_checks(torch, ops, refs, flush,
                                                torch.Generator(device="cuda").manual_seed(4))
                       + split_kernel_checks(torch, ops, refs, flush,
                                             torch.Generator(device="cuda").manual_seed(5))):
        r = checks[name]
        r.setdefault("cases", [dict(r)]).append(case)
        r["max_abs_err"] = max(r["max_abs_err"], case["max_abs_err"])
    del flush
    _elapsed("the analysis phase")
    analysis_phase(torch, card)
    for name, r in checks.items():
        for c in r.get("cases", [r]):
            extra = "".join(f"  {key} {c[key]:.4f}" for key in (
                "act_quant_ms", "matmul_ms", "kernel_call_ms",
                "bound_f32_fma_ms", "empty_ms") if key in c)
            print(f"kernel {name} {c['shape']}: err {c['max_abs_err']:.3g}  kernel {c['ms']:.4f} ms "
                  f"(call with host overhead {c['call_ms']:.4f} ms)  "
                  f"plain {c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}){extra}  [{card}]")

    _elapsed("the main path")
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
    grid_closure(eng, grid, "the main path", card)
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
    main_kv = eng.kv_bytes()["allocated"]
    main_round = (stats.decode_round_cost(), stats.decode_tput())  # before the profile's rounds
    main_rec, rec_round = recorded(cfg, params, prompts, max_tokens, main_streams, "the main path",
                                   n_slots=n_slots, max_len=max_len, mode="pdswap", overlap=True)
    print(f"  the main path served again with its logits recorded (untimed above): decode "
          f"{rec_round * 1e3:.2f} ms/round against {stats.decode_round_cost() * 1e3:.2f}; the "
          f"recorder's own host time {main_rec.seconds / len(main_rec.rounds) * 1e3:.3f} ms a "
          f"round; tokens equal  [{card}]")

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
    _elapsed("eager against graph")
    eager_vs_graph(torch, np, cfg, params, n_slots, max_len, card)

    _elapsed("(M1)")
    # ---- (M1) the main path on a (data 1, model 1) NCCL mesh in this process
    m1_launches, m1_mesh = mesh_m1_phase(torch, np, cfg, params, prompts, max_tokens, n_slots,
                                         max_len, main_streams, main_rec, main_round,
                                         (dev_p, per_round), card)

    _elapsed("paths (a)-(j)")
    # ---- 5. the other cache options at full width
    path_launches, path_i = cache_option_paths(torch, np, cfg, params, prompts, max_tokens,
                                               n_slots, max_len, card)
    _elapsed("(M2), (MT2)-(MT4), (ME2), (ME3), (MF2)")
    # ---- the 4-rank world on this card: (M2) the same model on a (data 2,
    # model 2) gloo mesh; (MT) and (ME3) training; (ME2) granite served.
    # Meanwhile this process runs the CPU references that need no earlier
    # phase's results (printed where they stand)

    def main_references():
        return (list(decode_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng)),
                list(verify_references(torch, T, cfg2, p_gpu, p_cpu, kv_c, rng)),
                chunk_reference(torch, T, cfg2, p_gpu, p_cpu, tokens))

    def md_refs():
        return md_references(torch, np, cfg, params)

    def cut_refs():
        return mesh_cut_references(torch, np)

    def spec_refs():
        return mesh_spec_references(torch, np)

    beside = ([("(MD) references", md_refs), ("(M2) cut references", cut_refs),
               ("(MS) references", spec_refs), ("main references", main_references)]
              + family_reference_jobs(torch)
              + [("(T4)", lambda: family_gradients(torch, np, card))])
    world = mesh_world_phase(torch, card, m2_args=(
        cfg, main_kv, {"a": {"streams": main_streams, "recorder": main_rec}},
        lambda: EARLY.take("(M2) cut references", cut_refs)),
        mt1_report=mt1_report, beside=beside,
        md_refs=lambda: EARLY.take("(MD) references", md_refs),
        ms_refs=lambda: EARLY.take("(MS) references", spec_refs), mf1_report=mf1_report)
    (mesh_launches, m2a), mt_launches, me2 = world["M2"], world["MT"], world["ME"]
    mf_launches = world["MF"]
    ms_launches = world["MS"]
    md_launches, md_parts = world["MD"]
    del world
    _elapsed("(E), (F)")
    mesh_cause_phase(torch, cfg, params, prompts, max_tokens, max_len, main_streams, main_rec,
                     m2a, card, md_parts=md_parts)
    del m2a
    _elapsed("paths (k)-(m)")
    spec_launches, path_k = spec_paths(torch, np, cfg, params, n_slots, max_len, max_tokens,
                                       card)
    _elapsed("(M1s), (M1c)")
    m1s_launches = mesh_m1_spec_phase(torch, np, cfg, params, n_slots, max_len, max_tokens,
                                      m1_mesh, path_k, path_i, card)
    del path_k
    decoded, verified, chunked = EARLY.take("main references", main_references)
    for name, err, scale in decoded:
        print(f"reference: full-width 2-layer {name} decode logits vs CPU plain versions: "
              f"max abs err {err:.3g} (max |logit| {scale:.3g})")
    for name, err, scale in verified:
        print(f"reference: full-width 2-layer {name} logits vs the CPU port: max abs err "
              f"{err:.3g} (max |logit| {scale:.3g})")
    err, scale = verify_against_decode(torch, T, cfg, params, rng)  # rng: after the references
    print(f"reference: full-depth int8 verify pass (W={SPEC_K + 1}) vs {SPEC_K + 1} decode steps "
          f"on the card: the same cache bytes, logits max abs err {err:.3g} (max |logit| "
          f"{scale:.3g})  [{card}]")
    err, scale = chunked
    print(f"reference: full-width 2-layer chunked prefill (2 chunks, int8 cache) logits vs CPU "
          f"plain versions: max abs err {err:.3g} (max |logit| {scale:.3g})")
    _elapsed("the abort phase")
    abort_launches = abort_phase(torch, np, cfg, params, card)
    if not (abort_launches["tlmm"] and abort_launches["paged_decode_attention_quant"]
            and not abort_launches["prefill_attention"]):
        raise AssertionError(f"abort phase: launches {abort_launches}")
    _elapsed("path (n)")
    front_launches = frontend_phase(torch, np, cfg, params, max_tokens, path_i, card)
    _elapsed("path (o)")
    cli_launches, cli_tokens = cli_phase(torch, np, card)
    _elapsed("paths (p), (q)")
    disagg_launches = disagg_phase(torch, np, cfg, params, max_tokens, path_i, main_streams,
                                   card)
    del path_i
    cli_disagg_launches, _ = cli_phase(torch, np, card, want=cli_tokens)
    del params
    _free(torch)

    _elapsed("phase 10")
    # ---- 10. the transformer family at full width; (ME1), (E4), (F2) beside (t)
    try:
        family_launches = family_phase(torch, np, card, me2=me2, m1_mesh=m1_mesh)
    finally:
        close_m1_world()
    me2_launches = {}  # rank 0's, over the (ME2) configurations
    for path in me2.values():
        for name, n in path["launches"].items():
            me2_launches[name] = me2_launches.get(name, 0) + n
    del me2, m1_mesh
    cli_smollm_launches, _ = cli_phase(torch, np, card, arch="smollm-135m")

    _elapsed("phase 11")
    # ---- 11. the other families at full width, and the long_500k context
    other_launches = other_families_phase(torch, np, card)

    _elapsed("phase 12")
    # ---- 12. training
    train_launches = training_phase(torch, np, card, ops)
    for part in (m1_launches, mesh_launches, path_launches, spec_launches, abort_launches,
                 front_launches, cli_launches, disagg_launches, cli_disagg_launches,
                 family_launches, cli_smollm_launches, other_launches, train_launches,
                 mt_launches, me2_launches, md_launches, ms_launches, m1s_launches,
                 mf_launches):
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
        "decode_attention_quant": ("src/repro_torch/csrc/decode_attention_quant.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:236",
                                   "masked SDPA over the dequantized bf16 view (made outside the time)"),
        "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:95",
                                   "masked SDPA over the gathered bf16 view (made outside the time)"),
        "paged_decode_attention_quant": ("src/repro_torch/csrc/paged_attention_quant.cu",
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
    _elapsed("the result lines")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# ---- phase (M): serving on a mesh of processes --

MESH_DIR = Path("chiprun_out") / "mesh"  # the (M) phases' stores and the ranks' results
MESH_WORLD = 4
MESH_PARTS = ("M2", "MS", "MD", "MT", "ME", "MF")  # the world's phases, in the order its ranks run them
MESH_TIMEOUT_S = 900  # the 4-rank world: (M2), (MT2)-(MT4), (ME2), (ME3)
# (M2)'s configurations: key, what, the prompts (shared: (c)'s), the engine's
# options, and the path whose streams it must give
MESH_PATHS = (
    ("M2a", "contiguous bf16, pdswap with the overlapped swap", False,
     dict(cache_layout="contiguous", kv_dtype="fp", mode="pdswap", overlap=True), "a"),
    ("M2b", "paged int8, bs 16, full pool, shared 256-token prefix, pdswap", True,
     dict(cache_layout="paged", kv_dtype="int8", mode="pdswap"), "d"),
    ("M2c", "contiguous int4, static", False,
     dict(cache_layout="contiguous", kv_dtype="int4", mode="static"), "b"),
)
# (M2a) once more with the helpers' native form under gloo (every gather
# and exchange one all_gather / all_to_all_single), against the portable
# form (one broadcast a rank) that ``layers.collectives.form`` picks there
MESH_NATIVE = ("M2a-native", "(M2a) with the native gathers and exchange", False,
               MESH_PATHS[0][3], None)
# (M2b) and (M2c) at a smaller depth: bitnet-730m at full width cut to
# MESH_CUT_LAYERS of its 24 layers (``T.init`` of the cut config, seed 0),
# with every request and new token of the full paths (8 x 32: both data
# ranks serve live requests, and later requests take freed slots and pages
# while others decode).  Each is held to a one-card run of the cut model in
# its configuration (``mesh_cut_references``, beside the world); (Fc), the
# cut model in (M2a)'s configuration with the walk's second half dropped
# (the planted fault), must fail the limits against the sound run of it.
# Read on one H100 80GB HBM3 (700 W): (M2b) and (M2c) no parting, logits
# on common tokens 0.0721 and 0.0738 apart; (Fc) parts at req1's first
# decode token (margins 0.341, 0.254), 0.895 apart: the (M2) limits lie
# between at this depth too
MESH_CUT_LAYERS = 6
MESH_CUT = ("M2b", "M2c")
MESH_CUT_SOUND, MESH_CUT_FAULT = "Fc-sound", "Fc"
MESH_NEW = 32  # new tokens a request of (M2)
# The native rerun keeps (M2a)'s depth, for its tokens must equal the
# portable form's bit for bit: the first 4 requests (one live on each data
# rank), 8 new tokens.  Every slot holds one of them until its 8th token,
# so the batches are (M2a)'s and the tokens (M2a)'s first 8
MESH_NATIVE_RUN = (4, 8)
def _prefix(want, got):
    """``want``'s streams cut to ``got``'s requests and lengths."""
    return {rid: list(want[rid])[:len(got[rid])] for rid in got}


def _mesh_cut(cfg):
    """bitnet-730m at full width, cut to ``MESH_CUT_LAYERS``."""
    return dataclasses.replace(cfg, num_layers=MESH_CUT_LAYERS)


def _mesh_expect(cfg, kw, stats, prefills):
    """One rank's launches on a mesh path: each rank runs every linear
    (its shard; B1 under a ternary config, no kernel on bf16 weights) and
    B2 (its heads) on every prefill, and its walk once a layer a decode
    round, as the single card does."""
    kernel = ("paged_" if kw["cache_layout"] == "paged" else "") + "decode_attention" + (
        "" if kw["kv_dtype"] == "fp" else "_quant")
    passes = prefills + stats["decode_rounds"]
    linears = 7 * cfg.num_layers * passes if cfg.quant.ternary else 0
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": linears, "act_quant": linears,
                   "prefill_attention": cfg.num_layers * prefills,
                   kernel: cfg.num_layers * stats["decode_rounds"]})
    return expect


def _shape_lines(shapes):
    """{"name shape": launches} as one sorted line a kernel."""
    by = {}
    for key, n in shapes.items():
        name, shape = key.split(" ", 1)
        by.setdefault(name, []).append(f"{shape} x{n}")
    return [f"{name}: " + ", ".join(sorted(v)) for name, v in sorted(by.items())]


def mesh_m1_phase(torch, np, cfg, params, prompts, max_tokens, n_slots, max_len, main_streams,
                  main_rec, main_round, main_profile, card):
    """(M1): the main path's engine on a (data 1, model 1) NCCL mesh in
    this process.  Every collective runs on its group of one (but the
    embedding's sum, which a group of one skips), the decode program is
    captured as a CUDA graph with its collectives inside, and
    the tokens must be the main path's.  The timed run keeps no logits
    (a second, untimed run records them); its decode round is printed
    beside the main path's (``main_round``: seconds a round and tok/s),
    and 4 decode rounds are profiled beside the main path's
    (``main_profile``: device seconds and operations a round of its 4
    profiled rounds).  Returns the launches and the mesh, whose world
    stays up for (ME1) (``close_m1_world`` ends it: a second NCCL world in
    this process crashed it)."""
    from repro_torch.serving import SamplingParams

    t0 = time.perf_counter()
    mesh = open_m1_world()
    print(f"(M1) {mesh.describe()}")
    kw = dict(n_slots=n_slots, max_len=max_len, mode="pdswap", overlap=True, mesh=mesh)
    eng, stats, wall, launches, _, _, grid = serve(cfg, params, prompts, max_tokens, **kw)
    decode_key = f"decode:{n_slots}x{max_len}"
    if decode_key not in grid["captured"]:
        raise AssertionError(f"(M1): the decode program was not captured ({grid['captured']})")
    per_pass = 7 * cfg.num_layers
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": per_pass * (stats.swaps + stats.decode_rounds),
                   "act_quant": per_pass * (stats.swaps + stats.decode_rounds),
                   "prefill_attention": cfg.num_layers * stats.swaps,
                   "decode_attention": cfg.num_layers * stats.decode_rounds})
    if launches != expect:
        raise AssertionError(f"(M1): launches {launches} != expected {expect}")
    got = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
    rec, _ = recorded(cfg, params, prompts, max_tokens, got, "(M1)", **kw)
    parted = check_near_ties(torch, "(M1)", got, main_streams, rec, main_rec,
                             lambda rid: SamplingParams())
    print(f"(M1) main path on a (1, 1) NCCL mesh: {stats.swaps} prefills, "
          f"{stats.decode_rounds} decode rounds, {wall:.2f} s wall, decode "
          f"{stats.decode_round_cost() * 1e3:.2f} ms/round ({stats.decode_tput():.1f} tok/s) "
          f"against the main path's {main_round[0] * 1e3:.2f} "
          f"({main_round[1]:.1f} tok/s), neither timed run recording; "
          f"{grid['graphs']} graphs captured, {decode_key} among "
          f"them with its collectives inside; tokens "
          f"{'equal the main path' if not parted else f'part at near ties {parted}'}; "
          f"launches {launches}  [{card}]")
    wall_p, dev_p, top, per_round = profile_decode(torch, eng)
    main_dev, main_ops = main_profile
    if dev_p is None or main_dev is None:
        print("(M1) profile: the profiler saw no device time; not measured")
    else:
        print(f"(M1) profile: 4 decode rounds (4 slots, 256-token prompts): "
              f"{dev_p / 4 * 1e3:.3f} ms device time and {per_round:.1f} device operations "
              f"a round, against the main path's {main_dev / 4 * 1e3:.3f} ms and "
              f"{main_ops:.1f}; {wall_p / 4 * 1e3:.3f} ms wall a round  [{card}]")
        for name, sec, calls in top[:8]:
            print(f"    {sec * 1e3:9.3f} ms  {calls:6d} calls  {name[:90]}")
    print(f"(M1) the phase {time.perf_counter() - t0:.1f} s  [{card}]")
    del eng, rec
    return launches, mesh


M1_STORE = MESH_DIR.parent / "m1_store"  # (M1)'s and (ME1)'s world of one


def open_m1_world():
    """Join a world of one over NCCL in this process: the (data 1, model 1)
    mesh of (M1) and (ME1)."""
    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    M1_STORE.parent.mkdir(parents=True, exist_ok=True)
    M1_STORE.unlink(missing_ok=True)
    join_process_group("nccl", init_method=f"file://{M1_STORE.resolve()}", rank=0, world_size=1)
    return make_host_mesh(data=1, model=1)


def close_m1_world():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    M1_STORE.unlink(missing_ok=True)


class _RowsRecorder:
    """A rank's recorded logits rows read back from its file, with
    ``TargetRecorder.row``'s interface."""

    def __init__(self, rows, device):
        self.rows = {(rid, pos): t.to(device) for (rid, pos), t in rows.items()}

    def row(self, rid, pos):
        return self.rows.get((rid, pos))


def mesh_world_phase(torch, card, parts=MESH_PARTS, m2_args=None, mt1_report=None, beside=(),
                     md_refs=None, ms_refs=None, mf1_report=None):
    """One (data 2, model 2) gloo world of 4 processes on this card
    (``python -m torch.distributed.run --standalone --nproc-per-node 4
    chip_smoke.py --mesh-worker DIR PARTS``; each rank on cuda:0, the
    programs eager) runs ``parts``: (M2) bitnet-730m served in three
    configurations (``MESH_PATHS``) and again with the native collectives;
    (MT2)-(MT4) bitnet-730m trained, checked on rank 0; (ME2) granite
    served (``ME_PATHS``) and (ME3) granite trained, checked on rank 0.
    Then (M2)'s checks against the single card (``m2_args``: cfg, main_kv,
    refs), (MT1)'s report and the ranks' reports are printed.  Returns
    {"M2": (rank 0's launches summed over ``MESH_PATHS``, (M2a)'s streams
    and logits rows), "MD": ranks 0's and 2's launches over (MD1) and (MD2),
    "MT": rank 0's (MT3) launches, "ME": (ME2)'s results (``me2_results``), "MF": rank
    0's launches over (MF2) (none: training), after (MF1)'s report},
    each for the parts run.  ``beside``: [(key, fn)] run in this process
    meanwhile (``EARLY``); ``md_refs()``: (MD)'s one-card references, read
    once the world has ended; ``ms_refs()``: the cut model's one-card runs
    that (MS) and (MD3) are held to (``mesh_spec_references``), with "MS"
    the chunked, speculative and swap-aware paths on the mesh and their
    planted faults, and the result "MS" rank 0's launches over them."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={MESH_WORLD}", str(Path(__file__).resolve()), "--mesh-worker",
           str(MESH_DIR.resolve()), ",".join(parts)]
    out = {}
    log = MESH_DIR.parent / "mesh_world.log"
    try:
        with open(log, "w") as sink:
            proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT, text=True)
            threads = torch.get_num_threads()
            torch.set_num_threads(max(1, threads // 2))  # leave the ranks half the host
            try:
                for key, fn in beside:
                    EARLY.run(key, fn)
                t_beside = time.perf_counter() - t0
                proc.wait(timeout=max(MESH_TIMEOUT_S - t_beside, 1))
            finally:
                torch.set_num_threads(threads)
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"the 4-rank world exited {proc.returncode}:\n"
                                 f"{log.read_text()[-8000:]}")
        print(f"(M) the 4-rank world launched with: {' '.join(cmd[1:])}; its parts' seconds "
              + ", ".join(f"({p}) {json.loads((MESH_DIR / f'{p}_seconds.json').read_text()):.1f}"
                          for p in parts)
              + (f"; beside it in this process, {t_beside:.1f} s: "
                 + ", ".join(f"{k} {EARLY.done[k][3]:.1f} s" for k, _ in beside)
                 if beside else "") + f"  [{card}]")
        if "M2" in parts:
            out["M2"] = _mesh_m2_results(torch, *m2_args, card)
        cfg = m2_args[0] if m2_args else _bitnet()
        cut_refs = ms_refs() if ms_refs is not None and {"MS", "MD"} & set(parts) else {}
        if "MS" in parts:
            out["MS"] = _mesh_ms_results(torch, cfg, cut_refs, card)
        if "MD" in parts:
            refs = dict(md_refs(), **{k: cut_refs[k] for k in MD_CUT})
            out["MD"] = _mesh_md_results(torch, cfg, refs, card)
        if "MT" in parts:
            print(mt1_report)
            result = json.loads((MESH_DIR / "MT_result.json").read_text())
            for line in result["report"]:
                print(f"{line}  [{card}]")
            out["MT"] = result["launches"]
        if "ME" in parts:
            for line in json.loads((MESH_DIR / "ME_result.json").read_text())["report"]:
                print(f"{line}  [{card}]")
            from repro_torch.configs import get_config

            out["ME"] = me2_results(torch, get_config(ME_ARCH), card)
        if "MF" in parts:
            print(mf1_report)
            result = json.loads((MESH_DIR / "MF_result.json").read_text())
            for line in result["report"]:
                print(f"{line}  [{card}]")
            out["MF"] = result["launches"]
    finally:  # the logits rows (about 100 MB) and the checkpoint never stay behind
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"(M) the world's phase {time.perf_counter() - t0:.1f} s  [{card}]")
    return out


def _bitnet():
    from repro_torch.configs import get_config

    return get_config("bitnet-730m")


def _mesh_m2_results(torch, cfg, main_kv, refs, cut_refs, card):
    """(M2)'s checks and printout from the ranks' files: (M2a) against the
    main path, the native rerun against (M2a) bit for bit, the cut paths
    (``MESH_CUT``) against the cut model's one-card runs (``cut_refs()``,
    read once the world has ended), each reading beside the limits, and
    (Fc) failing them."""
    from repro_torch.serving import SamplingParams

    greedy = lambda rid: SamplingParams()  # noqa: E731
    cut = _mesh_cut(cfg)
    cut_refs = cut_refs()
    total, m2a = {}, None
    for key, what, _, kw, ref in MESH_PATHS + (MESH_NATIVE,):
        ranks = [json.loads((MESH_DIR / f"{key}_rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        r0 = ranks[0]
        model = cut if key in MESH_CUT else cfg
        for r, got in enumerate(ranks):
            if got["snapshot"] != r0["snapshot"]:
                raise AssertionError(f"({key}): rank {r}'s host decisions differ from rank 0's")
            shapes = got["shapes"]
            want = _mesh_expect(model, kw, got["stats"], got["stats"]["prefills"])
            if got["launches"] != want or sum(shapes.values()) != sum(want.values()):
                raise AssertionError(f"({key}) rank {r}: launches {got['launches']} != {want}")
            if key == MESH_NATIVE[0]:
                continue
            print(f"({key}) rank {r}: {got['describe']}")
            for line in _shape_lines(shapes):
                print(f"    {line}")
            swap = ("static: installed after the prefill" if kw["mode"] == "static"
                    else f"swap (relayout or page write) mean {got['relayout_ms']:.3f} ms")
            print(f"    KV {got['kv_mib']:.1f} MiB and weights {got['weights_mib']:.1f} MiB "
                  f"(the whole tree's {got['whole_weights_mib']:.1f}, dropped once sliced) on this "
                  f"rank; the swap's exchange {got['exchange_bytes']} bytes sent in "
                  f"{got['exchanges']} swaps; {swap}  [{card}]")
        st = r0["stats"]
        if key == MESH_NATIVE[0]:
            base = json.loads((MESH_DIR / f"{MESH_PATHS[0][0]}_rank0.json").read_text())
            if r0["streams"] != _prefix(base["streams"], r0["streams"]):
                raise AssertionError(f"({key}): the native collectives' tokens differ from "
                                     f"({MESH_PATHS[0][0]})'s")
            n, new = MESH_NATIVE_RUN
            print(f"({key}) {what}: decode {st['decode_round_ms']:.2f} ms/round "
                  f"({st['decode_tput']:.1f} tok/s) against the portable form's "
                  f"{base['stats']['decode_round_ms']:.2f}, swap mean {r0['relayout_ms']:.3f} ms "
                  f"against {base['relayout_ms']:.3f}, TTFT mean {st['ttft_mean_ms']:.1f} ms "
                  f"against {base['stats']['ttft_mean_ms']:.1f} (its first {n} requests, {new} "
                  f"new, at (M2a)'s depth); the same tokens as (M2a)'s first {new}; the 4 ranks' "
                  f"snapshots equal; the rank's seconds {r0['seconds']:.1f}  [{card}]")
            continue
        rows = _RowsRecorder(torch.load(MESH_DIR / f"{key}_rows.pt"), "cuda")
        if key in MESH_CUT:
            one = cut_refs[key]
            reading = compare_streams(torch, f"({key}) against the cut model on one card",
                                      r0["streams"], one["streams"], rows, one["recorder"],
                                      greedy)
            faults = mesh_faults(reading)
            if faults:
                raise AssertionError(f"({key}): " + "; ".join(faults))
            against = ("equal" if not reading["parts"] else "part at near ties from") + (
                " the cut model's one-card run in its configuration")
            _print_reading(key, reading, card)
        else:
            parted = check_near_ties(torch, f"({key})", r0["streams"], refs[ref]["streams"],
                                     rows, refs[ref]["recorder"], greedy, tol=MESH_TIE_TOL,
                                     agree_tol=MESH_AGREE_TOL)
            m2a = {"streams": r0["streams"], "recorder": rows}
            against = (f"{'equal' if not parted else f'part at near ties {parted} from'} path "
                       f"({ref})'s")
        if kw["cache_layout"] == "contiguous" and kw["kv_dtype"] == "fp":
            if r0["kv_bytes"] * 4 != main_kv:
                raise AssertionError(f"({key}): a rank holds {r0['kv_bytes']} KV bytes, not a "
                                     f"quarter of the single card's {main_kv}")
        depth = (f" (cut to {model.num_layers} of {cfg.num_layers} layers)"
                 if key in MESH_CUT else "")
        print(f"({key}) {what}{depth} on the (2, 2) gloo mesh: {st['prefills']} prefills, "
              f"{st['decode_rounds']} decode rounds, {r0['wall']:.2f} s wall, decode "
              f"{st['decode_round_ms']:.2f} ms/round ({st['decode_tput']:.1f} tok/s), TTFT mean "
              f"{st['ttft_mean_ms']:.1f} ms; rank 0's recorder, inside this window, "
              f"{r0['recorder_ms_round']:.3f} ms of host time a round; the 4 ranks' snapshots "
              f"equal; streams {against}; the rank's seconds {r0['seconds']:.1f}  [{card}]")
        for name, n in r0["launches"].items():
            total[name] = total.get(name, 0) + n
    sound, fault = cut_refs[MESH_CUT_SOUND], cut_refs[MESH_CUT_FAULT]
    try:
        reading = compare_streams(torch, f"({MESH_CUT_FAULT}) against its sound run",
                                  fault["streams"], sound["streams"], fault["recorder"],
                                  sound["recorder"], greedy)
        faults = mesh_faults(reading)
    except AssertionError as e:  # a stream parts at its prefill's token: no near tie there
        faults = [str(e)]
    if not faults:
        raise AssertionError(f"({MESH_CUT_FAULT}): the planted fault passes the (M2) limits "
                             f"(tie {MESH_TIE_TOL}, logits {MESH_AGREE_TOL}) at "
                             f"{cut.num_layers} layers")
    print(f"({MESH_CUT_FAULT}) the cut model on one card in ({MESH_PATHS[0][0]})'s "
          f"configuration with the walk's second half dropped (the planted fault) fails the "
          f"(M2) limits against its sound run, as it must: {'; '.join(faults)}  [{card}]")
    return total, m2a


def _print_reading(key, reading, card):
    """A cut path's reading beside the (M2) limits: each parting's two
    margins, and how far the logits on the tokens both gave lie apart."""
    parts = "; ".join(
        f"{p['rid']} parts at token {p['pos']}, " + (
            f"margins {p['margins'][0]:.4f} and {p['margins'][1]:.4f} (limit {MESH_TIE_TOL} "
            "each)" if p["greedy"] else
            f"sampled, rows {p['diff']:.4f} apart (limit {MESH_DRAW_TOL})")
        for p in reading["parts"]) or "no parting"
    print(f"({key}) readings against the limits: {parts}; logits "
          f"on the tokens both gave within {reading['agree']:.4f} (limit {MESH_AGREE_TOL})  "
          f"[{card}]")


def _split_walk(torch, drop: bool = False):
    """The contiguous cache's walk as a model axis of 2 runs it, on one
    card: B3 or B4 over each half of the cache's rows (local lengths
    ``clamp(len - r * S/2, 0, S/2)``, a quantized cache's scale planes
    halved with its payload, a verify round's rows per slot kept), the two
    (out, l, m) stacked in rank order and merged by ``combine_partials``,
    as ``merge_partials`` merges the gathered ones.  With ``drop`` the
    second half's partials are left out: the planted fault of
    ``mesh_cause_phase``.  Returns (the plain function, the walk)."""
    from repro_torch.layers import attention as A

    plain = A.decode_attention

    def walk(q, k, v, lengths, starts=None, *, return_stats=False, **kw):
        if not return_stats or starts is not None:
            raise AssertionError("the split walk takes the serving walk, with its stats")
        half = k.shape[2] // 2

        def part(t, r):
            return t[:, :, r * half:(r + 1) * half]

        def scales(r):
            return {n: part(kw[n], r) for n in ("k_scales", "v_scales")
                    if kw.get(n) is not None}

        parts = [plain(q, part(k, r), part(v, r),
                       torch.clamp(lengths - r * half, 0, half).to(torch.int32),
                       return_stats=True, **{**kw, **scales(r)}) for r in range(2)]
        if drop:
            return parts[0]
        return A.combine_partials(*(torch.stack(t) for t in zip(*parts)))

    return plain, walk


def mesh_cause_phase(torch, cfg, params, prompts, max_tokens, max_len, main_streams, main_rec,
                     m2a, card, md_parts=None):
    """What (M2a)'s logits differ from the single card's by, reproduced on
    this card: the main path served (E1) with the decode walk split into
    two sequence halves merged as the model ranks merge them, (E2) in
    batches of 2 slots (a data rank's), (E3) both (the computation of an
    (M2a) rank, bar the vocabulary halves of the logits), and (F) as (E3)
    with the second half's (out, l, m) dropped: the planted fault.  Each
    is read against the main path, and (E3) against (M2a) itself.  The
    (M2) limits must pass (E1)-(E3) and fail (F)."""
    from repro_torch.layers import attention as A
    from repro_torch.serving import SamplingParams

    t0 = time.perf_counter()
    greedy = lambda rid: SamplingParams()  # noqa: E731
    runs = (("E1", "the walk in two sequence halves, 4 slots", 4, "split"),
            ("E2", "2 slots, the walk whole", 2, None),
            ("E3", "2 slots, the walk in two sequence halves", 2, "split"),
            ("F", "(E3) with the second half's partials dropped (the planted fault)", 2, "drop"))
    for key, what, slots, how in runs:
        plain, walk = _split_walk(torch, drop=how == "drop")
        rec = []
        if how is not None:
            A.decode_attention = walk
        try:
            eng, st, *_ = serve(cfg, params, prompts, max_tokens, n_slots=slots, max_len=max_len,
                                mode="pdswap", overlap=True,
                                on_engine=lambda e: rec.append(TargetRecorder(e)))
        finally:
            A.decode_attention = plain
        rec[0].stop()
        got = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
        del eng
        print(f"({key}) {what}: {st.decode_rounds} decode rounds  [{card}]")
        reading = compare_streams(torch, f"({key}) against the main path", got, main_streams,
                                  rec[0], main_rec, greedy)
        faults = mesh_faults(reading)
        if key == "E1" and md_parts is not None:  # the split's decode pod walks in halves too
            e1 = {(p["rid"], p["pos"]) for p in reading["parts"]}
            for md, parts in md_parts.items():
                if md in ("FD",) + MD_CUT or not parts:
                    continue
                print(f"({md}) parts at {parts}; (E1), the walk in two sequence halves as the "
                      f"split's decode ranks walk it, parts at {sorted(e1)}: "
                      f"{'it reorders the sums as the ranks do' if set(map(tuple, parts)) <= e1 else 'another parting'}")
        if key == "E3":
            same = compare_streams(torch, "(E3) against (M2a)", got, m2a["streams"], rec[0],
                                   m2a["recorder"], greedy)
            if same["parts"] or same["agree"] > 1e-4:
                raise AssertionError(f"(E3) does not reproduce (M2a): {same}")
        if key == "F":
            if not faults:
                raise AssertionError(f"(F): the planted fault passes the (M2) limits (tie "
                                     f"{MESH_TIE_TOL}, logits {MESH_AGREE_TOL})")
            print(f"(F) fails the (M2) limits, as it must: {'; '.join(faults)}")
        elif faults:
            raise AssertionError(f"({key}): " + "; ".join(faults))
        del rec
    print(f"(E) the phase {time.perf_counter() - t0:.1f} s  [{card}]")


def _tree_bytes(tree) -> int:
    """The bytes of a params tree's tensors (a ``TernaryWeight``'s packed
    bytes and scale)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if hasattr(tree, "packed"):
        return _tree_bytes(tree.packed) + _tree_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def mesh_worker(out: Path, parts) -> int:
    """One rank of the 4-rank world, started by ``torch.distributed.run``:
    join the gloo world on this card, build the (2, 2) mesh, and run
    ``parts`` of ``MESH_PARTS`` in turn, each writing its results under
    ``out``: (M2) ``_m2_rank``, (MT2)-(MT4) ``_mt_rank``, (ME2) and (ME3)
    ``_me_rank``, (MF2) ``_mf_rank``."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    t_start = time.perf_counter()
    join_process_group("gloo")
    mesh = make_host_mesh(data=2, model=2)
    runs = {"M2": _m2_rank, "MS": _ms_rank, "MD": _md_rank, "MT": _mt_rank, "ME": _me_rank,
            "MF": _mf_rank}
    for part in parts:
        t0 = time.perf_counter()
        runs[part](mesh, out)
        dist.barrier()
        if mesh.rank == 0:
            (out / f"{part}_seconds.json").write_text(json.dumps(time.perf_counter() - t0))
    rank = mesh.rank
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: {time.perf_counter() - t_start:.1f} s")
    return 0


def _serve_rank(torch, dist, mesh, cfg, params, prompts, max_new, kw, record, phase=None,
                make=None, ids=None, params_of=None):
    """Serve ``prompts`` on this rank's engine over ``mesh`` (rank 0 admits,
    the others follow), the launch counters set to 0 just before; with
    ``record`` this rank keeps its logits rows; ``phase["now"]`` reads
    "prefill" while a prefill runs, else "decode"; ``make()`` builds the
    engine in place of an ``EngineCore`` on ``mesh``.  Request j is
    ``req{ids[j]}`` (``ids`` default 0, 1, ...), greedy or drawn with
    ``params_of(ids[j])``.  Returns (engine, recorder or None, monolithic
    prefill calls, wall seconds)."""
    from repro_torch.kernels import reset_counts
    from repro_torch.serving import EngineCore, Request, SamplingParams

    eng = (make() if make is not None else
           EngineCore(cfg, params, mesh=mesh, n_slots=4, max_len=2048, block_size=16, **kw))
    mesh = eng.mesh
    rec = TargetRecorder(eng) if record else None
    prefills, prefill = [], eng.runner.prefill
    phase = {} if phase is None else phase

    def counted(*args, **kw_):
        prefills.append(1)
        phase["now"] = "prefill"
        try:
            return prefill(*args, **kw_)
        finally:
            phase["now"] = "decode"

    eng.runner.prefill = counted
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    t_run = time.perf_counter()
    if mesh.rank == 0:
        for i, p in zip(range(len(prompts)) if ids is None else ids, prompts):
            sp = SamplingParams() if params_of is None else params_of(i)
            eng.submit(Request(f"req{i}", p, max_new=max_new, params=sp))
        eng.run()
        eng.stop_followers()
    else:
        eng.follow()
    torch.cuda.synchronize()
    return eng, rec, len(prefills), time.perf_counter() - t_run


def _rank_result(mesh, eng, rec, prefills, wall, params, whole_bytes, t0):
    """One rank's record of a served path: launches (by shape), KV and
    weight MiB, the swap's exchange, the snapshot, the streams and stats."""
    from repro_torch.kernels import COUNTS

    st = eng.stats
    return {
        "describe": mesh.describe(), "launches": dict(COUNTS),
        "weights_mib": _tree_bytes(params) / 2**20, "whole_weights_mib": whole_bytes / 2**20,
        "recorder_ms_round": (rec.seconds / max(len(rec.rounds), 1) * 1e3
                              if rec is not None else 0.0),
        "shapes": {f"{name} {shape}": n for (name, shape), n in COUNTS.shapes().items()},
        "kv_bytes": eng.kv_bytes()["allocated"], "kv_mib": eng.kv_bytes()["allocated"] / 2**20,
        "exchange_bytes": eng.runner.engine.exchange_bytes,
        "exchanges": eng.runner.engine.exchanges,
        "relayout_ms": (statistics.mean(t.t_relayout for t in st.swap_timings) * 1e3
                        if st.swap_timings else 0.0),
        "snapshot": _decisions(eng.snapshot()),
        "streams": {r: list(map(int, q.out_tokens)) for r, q in eng.finished.items()},
        "stats": {"swaps": st.swaps, "prefills": prefills, "decode_rounds": st.decode_rounds,
                  "decode_round_ms": st.decode_round_cost() * 1e3,
                  "decode_tput": st.decode_tput(), "ttft_mean_ms": st.ttft.mean * 1e3},
        "wall": wall, "seconds": time.perf_counter() - t0}


def _save_rows(torch, rec, streams, path):
    rows = {(rid, pos): rec.row(rid, pos).cpu()
            for rid, toks in streams.items() for pos in range(1, len(toks))}
    torch.save(rows, path)


def _m2_rank(mesh, out: Path) -> None:
    """(M2) on this rank: draw the main path's weights and keep this rank's
    slice of them (the whole tree dropped), serve each of ``MESH_PATHS``
    and then ``MESH_NATIVE``, and write this rank's launches by shape, KV
    and weight bytes, the exchange's bytes, the snapshot and rank 0's
    streams and logits rows (recorded within the timed run, the
    recorder's host time measured)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.layers import collectives as C
    from repro_torch.models import transformer as T

    rank = mesh.rank
    full = get_config("bitnet-730m")
    form = C.form
    for cfg in (full, _mesh_cut(full)):  # (M2a) and the native rerun, then the cut paths
        whole = T.convert_for_inference(T.init(cfg, seed=0, device=mesh.device), cfg)
        whole_bytes = _tree_bytes(whole)
        params = shard_params(whole, cfg, mesh)  # the rank keeps its slice only
        del whole
        torch.cuda.empty_cache()
        for key, _, shared, kw, _ in MESH_PATHS + (MESH_NATIVE,):
            if (key in MESH_CUT) != (cfg is not full):
                continue
            t0 = time.perf_counter()
            if key == MESH_NATIVE[0]:
                C.form = lambda group: "native"
            n, new = MESH_NATIVE_RUN if key == MESH_NATIVE[0] else (len(PROMPT_LENS), MESH_NEW)
            prompts = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256 if shared else 0)[:n]
            try:
                eng, rec, prefills, wall = _serve_rank(torch, dist, mesh, cfg, params, prompts,
                                                       new, kw, record=rank == 0)
            finally:
                C.form = form
            result = _rank_result(mesh, eng, rec, prefills, wall, params, whole_bytes, t0)
            (out / f"{key}_rank{rank}.json").write_text(json.dumps(result))
            if rec is not None:
                _save_rows(torch, rec, result["streams"], out / f"{key}_rows.pt")
            del eng, rec
            torch.cuda.empty_cache()
        del params
    _free(torch)


def mesh_cut_references(torch, np):
    """The one-card runs the cut (M2) paths are held to: the cut model
    (``_mesh_cut``, ``T.init`` seed 0) in each path's configuration, its
    requests and new tokens, logits recorded; and in (M2a)'s, sound
    (``MESH_CUT_SOUND``) and with the walk's second half dropped (the
    planted fault ``MESH_CUT_FAULT``).  Run beside the 4-rank world, with
    no serving grid built first."""
    from repro_torch.layers import attention as A
    from repro_torch.models import transformer as T

    cfg = _mesh_cut(_bitnet())
    params = T.convert_for_inference(T.init(cfg, seed=0, device="cuda"), cfg)
    plain, walk = _split_walk(torch, drop=True)
    out = {}
    runs = [(p[0], p[2], p[3]) for p in MESH_PATHS if p[0] in MESH_CUT]
    runs += [(key, MESH_PATHS[0][2], MESH_PATHS[0][3])
             for key in (MESH_CUT_SOUND, MESH_CUT_FAULT)]
    for key, shared, kw in runs:
        prompts = make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256 if shared else 0)
        rec = []
        if key == MESH_CUT_FAULT:
            A.decode_attention = walk
        try:
            eng, *_ = serve(cfg, params, prompts, MESH_NEW, n_slots=4, max_len=2048,
                            block_size=16, grid=False,
                            on_engine=lambda e: rec.append(TargetRecorder(e)), **kw)
        finally:
            A.decode_attention = plain
        rec[0].stop()
        out[key] = {"streams": {f"req{i}": eng.finished[f"req{i}"].out_tokens
                                for i in range(len(prompts))}, "recorder": rec[0]}
        del eng
    del params
    return out


# ---- (MS): chunked prefill, speculative decoding and the swap policies, in
# the 4-rank world

MS_NEW = MESH_NEW  # new tokens a request of (MC), (MS), (MSc)
# key, what, the requests (which prompts, by index: "chunk" (i)'s 8, "spec"
# (k0)'s 8), their new tokens, sampled where (k0)'s are, the engine's
# options, the one-card run of the cut model it is held to, and whether it
# is a planted fault that must fail the (M2) limits.  bitnet-730m at full
# width cut to MESH_CUT_LAYERS, each rank its slice.
_PAGED8 = dict(cache_layout="paged", kv_dtype="int8", mode="pdswap")
_MC = dict(_PAGED8, prefill_chunk=CHUNK)
_MSC = dict(cache_layout="contiguous", kv_dtype="int8", mode="pdswap", spec_decode=SPEC_K)
MS_PATHS = (
    ("MC", f"(i)'s configuration: paged int8, 512 pages, {CHUNK}-token chunks",
     ("chunk", tuple(range(8))), MS_NEW, False, _MC, "MC", False),
    ("MS", f"(k)'s configuration: paged int8, 512 pages, spec_decode={SPEC_K}",
     ("spec", tuple(range(8))), MS_NEW, True, dict(_PAGED8, spec_decode=SPEC_K), "MS", False),
    ("MSc", f"(m)'s configuration: contiguous int8, spec_decode={SPEC_K} (B4 on verify rows "
     "over sequence halves)", ("spec", tuple(range(8))), MS_NEW, True, _MSC, "MSc", False),
    ("MP", "(MC)'s configuration under swap_policy=\"swap-aware\", rank 0 deciding",
     ("chunk", tuple(range(4))), 16, False, dict(_MC, swap_policy="swap-aware"), "MC", False),
    # the 1,536-token prompt and the 1,024-token tiled one reach
    # the second sequence half, which the fault drops from the verify walk
    ("FS", "(MSc) with the verify walk's second sequence half dropped (the planted fault)",
     ("spec", (3, 6)), 4, True, _MSC, "MSc", True),
    ("FC", "(MC) with model rank 0's chunk heads installed into both heads' rows (the "
           "planted fault)", ("chunk", (0, 1)), 4, False, _MC, "MC", True),
)
MS_SPEC = ("draft_tokens", "accepted_tokens", "verify_rounds")
# (MSc)'s witnesses on one card (``mesh_spec_references``) and their slots
MS_WITNESSES = (("ES1", 4), ("ES3", 2))


def _ms_prompts(np, cfg, which):
    return (spec_prompts(np, cfg) if which == "spec"
            else make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256))


def _ms_expect(cfg, kw, st):
    """One rank's launches on a chunked or speculative mesh path: every
    rank runs every linear (its shard) on every monolithic prefill, chunk,
    decode or verify round and replayed token, B2 (its heads) on every
    monolithic prefill, and its walk once a layer a round and a replayed
    token (a verify round's over its slots' 5 rows each, one launch)."""
    kernel = ("paged_" if kw["cache_layout"] == "paged" else "") + "decode_attention" + (
        "" if kw["kv_dtype"] == "fp" else "_quant")
    steps = st["decode_rounds"] + st["replayed_tokens"]
    linears = 7 * cfg.num_layers * (st["prefills"] + st["prefill_chunks"] + steps)
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": linears, "act_quant": linears,
                   "prefill_attention": cfg.num_layers * st["prefills"],
                   kernel: cfg.num_layers * steps})
    return expect


def _plant_ms_fault(key, mesh):
    """The planted fault of (FS) or (FC) on this rank; returns its undo.
    (FS): model rank 1 walks none of the verify rows (its half of the
    sequence drops out of every verify walk's merge).  (FC): every rank
    installs the chunk's KV with model rank 0's heads in place of rank
    1's."""
    import torch

    from repro_torch.models import transformer as T

    if key == "FS":
        plan_of = T.verify_plan

        def dropped(*args, seq_shard=None, **kw):
            plan = plan_of(*args, seq_shard=seq_shard, **kw)
            if seq_shard is not None and seq_shard[0] == 1:
                plan = plan._replace(walk=torch.zeros_like(plan.walk))
            return plan

        T.verify_plan = dropped
        return lambda: setattr(T, "verify_plan", plan_of)
    gather = T.gather_kv_heads

    def doubled(kv, cfg, pctx=T.NULL_CTX):
        kv = gather(kv, cfg, pctx)
        h = kv.k.shape[2] // 2
        return type(kv)(*(torch.cat([t[:, :, :h], t[:, :, :h]], dim=2) for t in kv))

    T.gather_kv_heads = doubled
    return lambda: setattr(T, "gather_kv_heads", gather)


def _ms_rank(mesh, out: Path) -> None:
    """(MS) on this rank: draw the cut model's weights (bitnet-730m at full
    width, ``MESH_CUT_LAYERS`` layers, seed 0) and keep this rank's slice,
    serve each of ``MS_PATHS`` on ``EngineCore`` over the (2, 2) mesh (the
    planted faults planted), and write this rank's launches by shape, the
    snapshot, the policy's decisions, the speculation and chunk counts, and
    rank 0's streams and logits rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.models import transformer as T

    rank = mesh.rank
    cfg = _mesh_cut(get_config("bitnet-730m"))
    whole = T.convert_for_inference(T.init(cfg, seed=0, device=mesh.device), cfg)
    whole_bytes = _tree_bytes(whole)
    params = shard_params(whole, cfg, mesh)
    del whole
    torch.cuda.empty_cache()
    for key, _, (which, ids), new, sampled, kw, _, fault in MS_PATHS:
        t0 = time.perf_counter()
        prompts = _ms_prompts(np, cfg, which)
        undo = _plant_ms_fault(key, mesh) if fault else None
        try:
            eng, rec, prefills, wall = _serve_rank(
                torch, dist, mesh, cfg, params, [prompts[i] for i in ids], new, kw,
                record=rank == 0, ids=ids, params_of=_sampled if sampled else None)
        finally:
            if undo is not None:
                undo()
        result = _rank_result(mesh, eng, rec, prefills, wall, params, whole_bytes, t0)
        st = eng.stats
        result["stats"].update({k: getattr(st, k) for k in MS_SPEC + (
            "prefill_chunks", "replayed_tokens", "preemptions")})
        result["policy"] = [list(d) for d in eng.decisions]
        (out / f"{key}_rank{rank}.json").write_text(json.dumps(result))
        if rec is not None:
            _save_rows(torch, rec, result["streams"], out / f"{key}_rows.pt")
        del eng, rec
        torch.cuda.empty_cache()
    del params
    _free(torch)


def mesh_spec_references(torch, np):
    """The one-card runs the (MS) paths and (MD3) are held to: the cut model
    (``_mesh_cut``, ``T.init`` seed 0) in (MC)'s, (MS)'s and (MSc)'s
    configurations with their requests and new tokens, and the one-card
    ``DisaggEngine`` in (MD3)'s, each with its logits recorded and its
    speculation counts; and the witnesses of (MSc)'s partings, (MSc)'s
    configuration on one card with its contiguous walks (decode and verify
    rows) in two sequence halves merged as the model ranks merge them
    (``_split_walk``): (ES1) on 4 slots, the halves alone, and (ES3) on 2
    slots, a data rank's batches too.  Run beside the 4-rank world, with
    no serving grid built first."""
    from repro_torch.layers import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.serving import DisaggEngine

    cfg = _mesh_cut(_bitnet())
    params = T.convert_for_inference(T.init(cfg, seed=0, device="cuda"), cfg)
    runs = [(key, _ms_prompts(np, cfg, which), new, sampled, kw, None, 4)
            for key, _, (which, _), new, sampled, kw, ref, fault in MS_PATHS
            if key == ref and not fault]
    msc = next(r for r in runs if r[0] == "MSc")
    runs += [(key,) + msc[1:6] + (slots,) for key, slots in MS_WITNESSES]
    md3 = next(p for p in MD_PATHS if p[0] == "MD3")
    runs.append(("MD3", make_prompts(np, cfg, PROMPT_LENS[:md3[2]]), md3[3], False, md3[4],
                 DisaggEngine, 4))
    out = {}
    for key, prompts, new, sampled, kw, cls, slots in runs:
        rec = []
        plain, walk = _split_walk(torch)
        if key in dict(MS_WITNESSES):
            A.decode_attention = walk
        try:
            eng, st, *_ = serve(cfg, params, prompts, new, _sampled if sampled else None,
                                engine_cls=cls, n_slots=slots, max_len=2048, block_size=16,
                                grid=False, on_engine=lambda e: rec.append(TargetRecorder(e)),
                                **kw)
        finally:
            A.decode_attention = plain
        rec[0].stop()
        out[key] = {"streams": {f"req{i}": eng.finished[f"req{i}"].out_tokens
                                for i in range(len(prompts))}, "recorder": rec[0],
                    "spec": {k: getattr(st, k) for k in MS_SPEC},
                    "chunks": st.prefill_chunks}
        del eng
    del params
    return out


def _ms_witnesses(torch, reading, streams, rows, refs, params_of, card):
    """(MSc)'s witnesses (``MS_WITNESSES``), each read against the one-card
    run as (MSc) is and against (MSc) itself: where each parts, whether
    (MSc)'s partings are among its own (the reordered sums then part them
    with no mesh code involved), and whether it gives (MSc)'s tokens and
    logits.  Each must pass the (M2) limits, as (E1)-(E3) must, and (ES3),
    a data rank's computation on one card, must give (MSc)'s tokens with
    logits within 1e-4, as (E3) gives (M2a)'s."""
    one = refs["MSc"]
    mesh_parts = {(p["rid"], p["pos"]) for p in reading["parts"]}
    for key, slots in MS_WITNESSES:
        w = refs[key]
        got = compare_streams(torch, f"({key}) against the cut model on one card", w["streams"],
                              one["streams"], w["recorder"], one["recorder"], params_of)
        _print_reading(key, got, card)
        own = {(p["rid"], p["pos"]) for p in got["parts"]}
        same = compare_streams(torch, f"({key}) against (MSc)", w["streams"], streams,
                               w["recorder"], rows, params_of)
        print(f"({key}) (MSc)'s configuration on one card, {slots} slots, the walks in two "
              f"sequence halves: parts at {sorted(own)}, (MSc) at {sorted(mesh_parts)}: "
              f"{'the same partings' if own == mesh_parts else 'other partings'}; against "
              f"(MSc) {len(same['parts'])} partings, logits within {same['agree']:.3g}; "
              f"{_spec_line(w['spec'])}  [{card}]")
        faults = mesh_faults(got)
        if faults:
            raise AssertionError(f"({key}): " + "; ".join(faults))
        if key == "ES3" and (same["parts"] or same["agree"] > 1e-4):
            raise AssertionError(f"(ES3) does not reproduce (MSc): {same}")


def _spec_line(st):
    d, a, v = (st[k] for k in MS_SPEC)
    return f"{v} verify rounds, {d} drafts, {a} accepted (rate {a / d if d else 0.0:.3f})"


def _mesh_ms_results(torch, cfg, refs, card):
    """(MS)'s checks and printout from the ranks' files: each rank's
    launches, its snapshot and its policy decisions rank 0's, the streams
    held to the cut model's one-card runs within the (M2) limits (the
    planted faults must fail them), speculation beside the one-card run's.
    Returns rank 0's launches over the paths that are no planted fault."""
    import numpy as np

    from repro_torch.serving import SamplingParams

    cut = _mesh_cut(cfg)
    total = {}
    for key, what, (which, ids), new, sampled, kw, ref, fault in MS_PATHS:
        ranks = [json.loads((MESH_DIR / f"{key}_rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        r0 = ranks[0]
        for r, got in enumerate(ranks):
            if got["snapshot"] != r0["snapshot"] or got["policy"] != r0["policy"]:
                raise AssertionError(f"({key}): rank {r}'s host or policy decisions differ from "
                                     "rank 0's")
            want = _ms_expect(cut, kw, got["stats"])
            if got["launches"] != want:
                raise AssertionError(f"({key}) rank {r}: launches {got['launches']} != {want}")
        st = r0["stats"]
        one = refs[ref]
        rows = _RowsRecorder(torch.load(MESH_DIR / f"{key}_rows.pt"), "cuda")
        params_of = ((lambda rid: _sampled(int(rid[3:]))) if sampled
                     else (lambda rid: SamplingParams()))
        try:
            reading = compare_streams(torch, f"({key}) against the cut model on one card",
                                      r0["streams"], _prefix(one["streams"], r0["streams"]),
                                      rows, one["recorder"], params_of)
            faults = mesh_faults(reading)
        except AssertionError as e:  # a stream parts at its prefill's token: no near tie there
            if not fault:
                raise
            reading, faults = None, [str(e)]
        if fault:
            if not faults:
                raise AssertionError(f"({key}): the planted fault passes the (M2) limits (tie "
                                     f"{MESH_TIE_TOL}, logits {MESH_AGREE_TOL})")
            print(f"({key}) {what}, {len(ids)} requests x {new}: fails the (M2) limits, as it "
                  f"must: {'; '.join(faults)}  [{card}]")
            continue
        if key == "MSc":
            _ms_witnesses(torch, reading, r0["streams"], rows, refs, params_of, card)
        if faults:
            raise AssertionError(f"({key}): " + "; ".join(faults))
        _print_reading(key, reading, card)
        extra = ""
        if kw.get("spec_decode"):
            if not (st["verify_rounds"] > 0 and st["accepted_tokens"] > 0):
                raise AssertionError(f"({key}): {_spec_line(st)}")
            extra = f"; {_spec_line(st)}, the one-card run {_spec_line(one['spec'])}"
        if kw.get("prefill_chunk"):
            prompts = _ms_prompts(np, cut, which)
            want = sum(-(-len(prompts[i]) // CHUNK) for i in ids)
            if st["prefill_chunks"] != want:
                raise AssertionError(f"({key}): {st['prefill_chunks']} chunks, expected {want}")
            extra += f"; {st['prefill_chunks']} chunks, the install's gather of each chunk's " \
                     f"heads {r0['exchange_bytes']} bytes from rank 0"
        if "swap_policy" in kw:
            kinds = sorted({k for k, _ in r0["policy"]})
            deferred = sum(k == "prefill" and not v for k, v in r0["policy"])
            extra += (f"; {len(r0['policy'])} policy decisions ({', '.join(kinds)}) by rank 0, "
                      f"{deferred} of them deferrals, each rank's list equal to it")
        parted = [(p["rid"], p["pos"]) for p in reading["parts"]]
        print(f"({key}) {what}, cut to {cut.num_layers} of {cfg.num_layers} layers, on the "
              f"(2, 2) gloo mesh: {len(ids)} requests x {new}, {st['prefills']} monolithic "
              f"prefills, {st['decode_rounds']} decode rounds, {r0['wall']:.2f} s wall, decode "
              f"{st['decode_round_ms']:.2f} ms a round ({st['decode_tput']:.1f} tok/s), TTFT "
              f"mean {st['ttft_mean_ms']:.1f} ms{extra}; the 4 ranks' snapshots equal; streams "
              f"{'equal' if not parted else f'part at near ties {parted} from'} the cut "
              f"model's one-card run; the rank's seconds {r0['seconds']:.1f}  [{card}]")
        for line in _shape_lines(r0["shapes"]):
            print(f"    {line}")
        for name, n in r0["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


# ---- (MD): the pod split of the disaggregated pools, in the 4-rank world --

MD_NEW = 16  # new tokens a request of the (MD) paths
MD_LEN = 2048  # max_len of the (MD) paths, (q)'s and (p)'s
MD_RECORDER = 2  # the rank that keeps the logits rows: the first decode rank
# key, what, how many of the main path's prompts, new tokens, the engine's
# options, the one-card DisaggEngine configuration its streams are held to;
# (FD)'s fault shows at the first decode token
MD_PATHS = (
    ("MD1", "contiguous bf16, pdswap with the overlapped swap, monolithic prefill", 4, MD_NEW,
     dict(cache_layout="contiguous", kv_dtype="fp", mode="pdswap", overlap=True), "q"),
    ("MD2", f"paged int8, 16-token pages, 512 pages, {CHUNK}-token chunks", 4, MD_NEW,
     dict(cache_layout="paged", kv_dtype="int8", mode="pdswap", num_blocks=512,
          prefill_chunk=CHUNK), "p"),
    ("FD", "(MD1) with prefill rank 1's heads sent into the other half's rows (the planted "
           "fault)", 2, 4, dict(cache_layout="contiguous", kv_dtype="fp", mode="pdswap",
                                overlap=True), "q"),
    # at MESH_CUT_LAYERS, held to the one-card DisaggEngine of the cut model
    # (``mesh_spec_references``)
    ("MD3", f"(MD2) with spec_decode={SPEC_K}: the verify rounds on the decode pod", 4, MD_NEW,
     dict(cache_layout="paged", kv_dtype="int8", mode="pdswap", num_blocks=512,
          prefill_chunk=CHUNK, spec_decode=SPEC_K), "MD3"),
)
MD_CUT = ("MD3",)  # the (MD) paths at the cut depth


def _plant_wrong_rows(eng, max_len: int) -> None:
    """(FD): this prefill rank's relayed heads rolled by half the rows before
    their exchange, so that they land in the other decode rank's rows."""
    pool = eng.prefill_pool.engine
    exchange = pool._heads_to_rows

    def wrong(seg):
        return exchange(type(seg)(*(t.roll(max_len // 2, dims=3) for t in seg)))

    pool._heads_to_rows = wrong


def _md_expect(cfg, role, stats, prefills):
    """One rank's launches on the split: a prefill rank runs B1 (its shard)
    on every prefill and chunk and B2 (its heads) on every monolithic
    prefill; a decode rank B1 and its walk on every decode round and
    replayed token."""
    expect = {name: 0 for name in DECODE_KERNELS}
    if role == "prefill":
        linears = 7 * cfg.num_layers * (prefills + stats["prefill_chunks"])
        expect.update({"tlmm": linears, "act_quant": linears,
                       "prefill_attention": cfg.num_layers * prefills})
        return expect
    steps = stats["decode_rounds"] + stats["replayed_tokens"]
    walk = "paged_decode_attention_quant" if stats["paged"] else "decode_attention"
    expect.update({"tlmm": 7 * cfg.num_layers * steps, "act_quant": 7 * cfg.num_layers * steps,
                   "prefill_attention": 0, walk: cfg.num_layers * steps})
    return expect


def _md_rank(mesh, out: Path) -> None:
    """(MD) on this rank: split a (pod 2, data 1, model 2) mesh of the
    world (ranks 0-1 prefill, 2-3 decode), draw the main path's weights and
    keep this rank's slice of them, and serve each of ``MD_PATHS`` on the
    split ``DisaggEngine``; write this rank's launches by shape, handoff
    counters, the bytes between the pods, the transfer's time, TTFT, decode
    ms a round, weight MiB and snapshot, and the recording rank's logits
    rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.disagg import split_pod_meshes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.models import transformer as T
    from repro_torch.serving.disagg import DisaggEngine

    rank = mesh.rank
    cfg = get_config("bitnet-730m")
    pools = split_pod_meshes(make_mesh((2, 1, 2), ("pod", "data", "model")))
    mine = next(m for m in pools if hasattr(m, "parent"))
    role = "prefill" if mine is pools[0] else "decode"
    params = None
    for key, _, n, new, kw, _ in MD_PATHS:
        if params is None or (key in MD_CUT) != (cfg.num_layers == MESH_CUT_LAYERS):
            if key in MD_CUT:
                cfg = _mesh_cut(cfg)
            del params
            torch.cuda.empty_cache()
            whole = T.convert_for_inference(T.init(cfg, seed=0, device=mesh.device), cfg)
            whole_bytes = _tree_bytes(whole)
            params = shard_params(whole, cfg, mine)  # the rank keeps its slice only
            del whole
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        prompts = make_prompts(np, cfg, PROMPT_LENS[:n])

        def make():
            eng = DisaggEngine(cfg, params, prefill_mesh=pools[0], decode_mesh=pools[1],
                               n_slots=4, max_len=MD_LEN, block_size=16, **kw)
            if key == "FD" and role == "prefill" and mine.coordinate("model") == 1:
                _plant_wrong_rows(eng, MD_LEN)
            return eng

        eng, rec, prefills, wall = _serve_rank(torch, dist, mesh, cfg, params, prompts, new,
                                               kw, record=rank == MD_RECORDER, make=make)
        result = _rank_result(mine, eng, rec, prefills, wall, params, whole_bytes, t0)
        if role == "prefill":  # the relay's exchange; no cache here (its bookkeeping on meta)
            result.update(kv_mib=0.0, exchange_bytes=eng.prefill_pool.engine.exchange_bytes,
                          exchanges=eng.prefill_pool.engine.exchanges)
        st = eng.stats
        ho = eng.snapshot()["disagg"]["handoff"]
        result.update(role=role, handoff=ho, pools=(eng.snapshot()["disagg"]["prefill_pool"],
                                                    eng.snapshot()["disagg"]["decode_pool"]))
        result["stats"].update(prefill_chunks=st.prefill_chunks, replayed_tokens=st.replayed_tokens,
                               paged=eng.runner.paged is not None,
                               **{k: getattr(st, k) for k in MS_SPEC},
                               ttft_p50_ms=st.ttft.percentile(50) * 1e3,
                               transfer_ms=ho["t_dispatch_s"] / max(ho["segments"], 1) * 1e3)
        (out / f"{key}_rank{rank}.json").write_text(json.dumps(result))
        if rec is not None:
            _save_rows(torch, rec, result["streams"], out / f"{key}_rows.pt")
        del eng, rec
        torch.cuda.empty_cache()
    del params
    _free(torch)


def md_references(torch, np, cfg, params):
    """The one-card ``DisaggEngine`` runs the (MD) paths are held to: the
    main path's first 4 prompts, ``MD_NEW`` new tokens, in (q)'s
    configuration (contiguous bf16, pdswap, monolithic) and in (p)'s
    (paged int8, 512 pages, 256-token chunks), each with its logits
    recorded.  Run beside the 4-rank world, with no serving grid built
    first (its programs capture at their first call): the world's ranks
    share the host."""
    from repro_torch.serving import DisaggEngine

    prompts = make_prompts(np, cfg, PROMPT_LENS[:4])
    out = {}
    for ref, kw in (("q", MD_PATHS[0][4]), ("p", MD_PATHS[1][4])):
        rec = []
        eng, *_ = serve(cfg, params, prompts, MD_NEW, engine_cls=DisaggEngine, n_slots=4,
                            max_len=MD_LEN, block_size=16, grid=False,
                            on_engine=lambda e: rec.append(TargetRecorder(e)), **kw)
        rec[0].stop()
        out[ref] = {"streams": {f"req{i}": eng.finished[f"req{i}"].out_tokens
                                for i in range(len(prompts))},
                    "recorder": rec[0]}
        del eng
    return out


def md_predicted_mib(cfg, key, n_prompts):
    """The MiB a rank sends or receives between the pods on an (MD) path,
    reckoned from the shapes before the run: a monolithic segment is the
    relaid f32 KV (the cast to bf16 happens on install) of max_len rows, a
    rank's half of it (its block of rows, every head); a chunk the f32 KV of
    the rank's 12 heads at its padded length; each prompt's logits row (f32,
    the padded vocabulary) too."""
    tok_half = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4 // 2
    lens = PROMPT_LENS[:n_prompts]
    if key in ("MD2", "MD3"):
        rows = sum(sum(-(-min(CHUNK, n - a) // 16) * 16 for a in range(0, n, CHUNK))
                   for n in lens)
    else:
        rows = MD_LEN * len(lens)
    return (rows * tok_half + len(lens) * cfg.padded_vocab() * 4) / 2**20


def _mesh_md_results(torch, cfg, refs, card):
    """(MD)'s checks and printout from the ranks' files: each rank's
    launches, the ranks' snapshots equal, the streams held to the one-card
    references within the (M2) limits ((FD) must fail them).  Returns
    (ranks 0's and 2's launches over (MD1) and (MD2), each path's
    partings)."""
    from repro_torch.serving import SamplingParams

    launches, partings = {}, {}
    full = cfg
    for key, what, n, new, kw, ref in MD_PATHS:
        cfg = _mesh_cut(full) if key in MD_CUT else full
        ranks = [json.loads((MESH_DIR / f"{key}_rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        r0 = ranks[0]
        for r, got in enumerate(ranks):
            if got["snapshot"] != r0["snapshot"]:
                raise AssertionError(f"({key}): rank {r}'s host decisions differ from rank 0's")
            want = _md_expect(cfg, got["role"], got["stats"], got["stats"]["prefills"])
            if got["launches"] != want:
                raise AssertionError(f"({key}) rank {r} ({got['role']}): launches "
                                     f"{got['launches']} != {want}")
        st, ho = r0["stats"], r0["handoff"]
        rows = _RowsRecorder(torch.load(MESH_DIR / f"{key}_rows.pt"), "cuda")
        want = _prefix(refs[ref]["streams"], r0["streams"])
        reading = compare_streams(torch, f"({key}) against the one-card DisaggEngine ({ref}'s "
                                  "configuration)", r0["streams"], want, rows,
                                  refs[ref]["recorder"], lambda rid: SamplingParams())
        faults = mesh_faults(reading)
        if key == "FD":
            if not faults:
                raise AssertionError(f"(FD): the planted fault passes the (M2) limits (tie "
                                     f"{MESH_TIE_TOL}, logits {MESH_AGREE_TOL})")
            print(f"(FD) fails the (M2) limits, as it must: {'; '.join(faults)}")
        elif faults:
            raise AssertionError(f"({key}): " + "; ".join(faults))
        chunks = st["prefill_chunks"]
        counts = (ho["segments"], ho["eager_segments"], ho["installs"], ho["discarded"],
                  ho["pending"])
        if counts != ((chunks, chunks - n, chunks, 0, 0) if chunks else (n, 0, 0, 0, 0)):
            raise AssertionError(f"({key}): handoff {ho} for {n} prompts and {chunks} chunks")
        parted = [(p["rid"], p["pos"]) for p in reading["parts"]]
        partings[key] = parted
        pred = md_predicted_mib(cfg, key, n)
        if kw.get("spec_decode"):
            if not st["verify_rounds"] > 0:
                raise AssertionError(f"({key}): {_spec_line(st)}")
            print(f"({key}) speculation on the split: {_spec_line(st)} (the one-card "
                  f"DisaggEngine: {_spec_line(refs[ref]['spec'])}); each round's targets "
                  f"broadcast from decode rank 2 to every rank  [{card}]")
        depth = (f", cut to {cfg.num_layers} of {full.num_layers} layers" if key in MD_CUT
                 else "")
        print(f"({key}) {what}{depth}, on the (pod 2, data 1, model 2) split (ranks 0-1 prefill, "
              f"2-3 decode): {n} requests x {new}, {st['prefills']} monolithic prefills and "
              f"{st['prefill_chunks']} chunks on the prefill pod, {st['decode_rounds']} decode "
              f"rounds, {r0['wall']:.2f} s wall; handoff {ho['segments']} segments "
              f"({ho['eager_segments']} eager), {ho['installs']} installs, {ho['discarded']} "
              f"discarded, {ho['pending']} pending, {ho['bytes_shipped'] / 2**20:.1f} MiB "
              f"shipped; TTFT p50 {st['ttft_p50_ms']:.1f} ms, decode "
              f"{st['decode_round_ms']:.2f} ms a round on rank 0; the 4 ranks' snapshots "
              f"equal; streams "
              f"{'equal' if not parted else f'part at {parted} from'} the one-card "
              f"DisaggEngine's; the rank's seconds {r0['seconds']:.1f}  [{card}]")
        for r, got in enumerate(ranks):
            g = got["handoff"]
            print(f"({key}) rank {r} ({got['role']}): between the pods "
                  f"{g['pod_bytes'] / 2**20:.1f} MiB (predicted {pred:.1f}), the transfer "
                  f"{got['stats']['transfer_ms']:.2f} ms a segment ({g['segments']} segments, "
                  f"{g['t_dispatch_s'] * 1e3:.1f} ms in all), decode "
                  f"{got['stats']['decode_round_ms']:.2f} ms a round, weights "
                  f"{got['weights_mib']:.1f} MiB (the whole tree's "
                  f"{got['whole_weights_mib']:.1f}), KV {got['kv_mib']:.1f} MiB, the exchange "
                  f"{got['exchange_bytes']} bytes in {got['exchanges']} swaps  [{card}]")
            if r in (0, MD_RECORDER):
                for line in _shape_lines(got["shapes"]):
                    print(f"    {line}")
            if key != "FD" and r in (0, MD_RECORDER):
                for name, c in got["launches"].items():
                    launches[name] = launches.get(name, 0) + c
    return launches, partings


def _decisions(tree):
    """A snapshot with its floats (times, rates) taken out: what the ranks'
    host decisions make equal."""
    if isinstance(tree, dict):
        return {k: _decisions(v) for k, v in tree.items() if not isinstance(v, float)}
    if isinstance(tree, (list, tuple)):
        return [_decisions(v) for v in tree if not isinstance(v, float)]
    return tree


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


def recorded(cfg, params, prompts, max_tokens, want, what, params_of=None, **engine_kw):
    """A path served once more, untimed, with a ``TargetRecorder``: the rows
    that ``check_near_ties`` reads, kept out of the timed run's window.  Its
    streams must be the timed run's (``want``).  Returns the recorder and
    the recorded run's decode seconds a round."""
    rec = []
    eng, st, *_ = serve(cfg, params, prompts, max_tokens, params_of,
                        on_engine=lambda e: rec.append(TargetRecorder(e)), **engine_kw)
    rec[0].stop()
    if {r: eng.finished[r].out_tokens for r in want} != want:
        raise AssertionError(f"{what}: the recorded run's tokens differ from the timed run's")
    return rec[0], st.decode_round_cost()


def serve(cfg, params, prompts, max_tokens, params_of=None, on_engine=None, engine_cls=None,
          grid=True, **engine_kw):
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
    ``engine_cls`` (``EngineCore`` by default) is the engine built; with
    ``grid`` False no serving grid is built (the grid returned is None)."""
    import numpy as np
    import torch

    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.serving import EngineCore, Request, SamplingParams

    eng = (engine_cls or EngineCore)(cfg, params, device="cuda", **engine_kw)
    grid = build_grid(torch, eng) if grid else None
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
            "pool_bytes": None if None in pools else sum(pools),
            "programs": {k for e in engines for k in e.programs}, "captured": set(graphs)}


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
    total, streams, latency, ops, recs = {}, {}, {}, {}, {}
    for key, what, ps, kw, params_of in paths:
        eng, st, wall, launches, prefills, events, grid = serve(
            cfg, params, ps, max_tokens, params_of,
            on_engine=((lambda e, key=key: recs.setdefault(key, TargetRecorder(e)))
                       if key == "i" else None),
            n_slots=n_slots, max_len=max_len, block_size=16, **kw)
        if key in recs:
            recs[key].stop()  # the profiles below are not recorded
        if key == "i":
            tput_i, chunks_i = st.decode_tput(), st.prefill_chunks
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
        if key == "d":
            grid_closure(eng, grid, "path (d)", card)
        if key == "a":
            eager_round_f32(torch, eng, cfg, card)
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
                   "recorder": recs["i"], "latency": latency["i"], "tput": tput_i,
                   "chunks": chunks_i}


class TargetRecorder:
    """Keeps, for every decode and verify round of an engine, a copy of
    its logits (on the device) and which request and token index each row
    scores, so that where two runs' streams part the scores behind both
    tokens can be read back (``check_near_ties``)."""

    def __init__(self, eng):
        self.eng = eng
        self.rounds = []  # (logits (B, W, V), {slot: (request id, index of row 0)})
        self.seconds = 0.0  # host time spent keeping rounds
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
        t0 = time.perf_counter()
        rows = {s: (r.request_id, len(r.out_tokens)) for s, r in self.eng.scheduler.inflight.items()}
        self.rounds.append((logits.clone(), rows))
        self.seconds += time.perf_counter() - t0

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


def compare_streams(torch, what, got, want, rec_got, rec_want, params_of):
    """Where two runs' streams ({request id: tokens}) part, and by how much
    their logits differ before that.  For each request that parts, at its
    first differing position: the two tokens, each run's margin for its
    own token over the other's (``_margin``), whether the draw was greedy,
    and how far apart the runs' logits rows lie there; the rest of a
    parted stream is not compared.  ``agree``: the largest difference
    between the two runs' logits on the tokens both gave.  Prints each
    parting and the agreement; checks nothing."""
    parts, agree = [], 0.0
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
        parts.append({"rid": rid, "pos": pos, "margins": (m0, m1), "diff": diff,
                      "greedy": sp.greedy})
    print(f"{what}: the two runs' logits on the tokens both gave lie within {agree:.3g}")
    return {"parts": parts, "agree": agree}


def near_tie_faults(reading, tol, agree_tol=None, draw_tol=None):
    """What in a ``compare_streams`` reading breaks the near-tie rule: a
    greedy parting where either margin exceeds ``tol``, a sampled one
    where the rows lie more than ``draw_tol`` (default ``tol``) apart, or
    (with ``agree_tol``) logits on common tokens further apart than
    ``agree_tol``."""
    draw_tol = tol if draw_tol is None else draw_tol
    faults = [f"{p['rid']} parts at token {p['pos']}, not at a near tie (margins "
              f"{p['margins'][0]}, {p['margins'][1]}; logits {p['diff']} apart; limit "
              f"{tol if p['greedy'] else draw_tol})"
              for p in reading["parts"]
              if (max(p["margins"]) if p["greedy"] else p["diff"]) > (
                  tol if p["greedy"] else draw_tol)]
    if agree_tol is not None and reading["agree"] > agree_tol:
        faults.append(f"the two runs' logits part by {reading['agree']} on tokens both gave "
                      f"(limit {agree_tol})")
    return faults


def mesh_faults(reading):
    """``near_tie_faults`` under the (M2) limits."""
    return near_tie_faults(reading, MESH_TIE_TOL, MESH_AGREE_TOL, MESH_DRAW_TOL)


def check_near_ties(torch, what, got, want, rec_got, rec_want, params_of, tol=TIE_TOL,
                    agree_tol=None):
    """Two runs' streams ({request id: tokens}) must be equal, or part only
    at a near tie: greedy, the two tokens' logits lie within TIE_TOL in
    both runs; sampled (where a draw can also flip at the top-k / top-p
    edge), the two runs' logits rows lie within TIE_TOL of each other, so
    that the same noise decides between nearly equal rows.  With
    ``agree_tol`` the logits on the tokens both gave must also lie within
    it.  Returns the partings [(request id, position)]."""
    reading = compare_streams(torch, what, got, want, rec_got, rec_want, params_of)
    faults = near_tie_faults(reading, tol, agree_tol)
    if faults:
        raise AssertionError(f"{what}: " + "; ".join(faults))
    return [(p["rid"], p["pos"]) for p in reading["parts"]]


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
    prompts profiled.  Returns the launches summed over the paths, and
    (k)'s streams, speculation counts and decode ms a round ((M1s) is held
    to them)."""
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
        if key == "k":
            path_k = {"streams": streams[key], "round_ms": st.decode_round_cost() * 1e3,
                      "spec": {k: getattr(st, k) for k in MS_SPEC}}
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
    return total, path_k


def mesh_m1_spec_phase(torch, np, cfg, params, n_slots, max_len, max_tokens, mesh, path_k,
                       path_i, card):
    """(M1s) and (M1c): paths (k) and (i) at full width and depth on (M1)'s
    (data 1, model 1) NCCL world in this process, the verify and chunk
    programs captured as CUDA graphs with their collectives (on groups of
    one) inside, each at its first call (no serving grid first).  (M1s) must give (k)'s tokens bit for bit and its drafts,
    accepted tokens and verify rounds; (M1c) (i)'s tokens bit for bit and
    its chunks.  Returns the launches over both."""
    t0 = time.perf_counter()
    paged8 = dict(cache_layout="paged", kv_dtype="int8", mode="pdswap")
    runs = (("M1s", f"(k)'s configuration: paged int8, 512 pages, spec_decode={SPEC_K}",
             spec_prompts(np, cfg), _sampled, dict(paged8, spec_decode=SPEC_K), path_k,
             "verify_paged:"),
            ("M1c", f"(i)'s configuration: paged int8, 512 pages, {CHUNK}-token chunks",
             make_prompts(np, cfg, PROMPT_LENS, shared_prefix=256), None,
             dict(paged8, prefill_chunk=CHUNK), path_i, "prefill_chunk_paged:"))
    total = {}
    for key, what, prompts, params_of, kw, want, graph in runs:
        # no serving grid: each program captures at its first call, so (M1c)
        # captures the chunk shapes its prompts reach, not all 83 of (i)'s grid
        eng, st, wall, launches, prefills, _, _ = serve(
            cfg, params, prompts, max_tokens, params_of, n_slots=n_slots, max_len=max_len,
            block_size=16, mesh=mesh, grid=False, **kw)
        check_served(eng, cfg, len(prompts), max_tokens)
        got = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
        graphs = sorted(k for k, p in eng.runner.engine.programs.items()
                        if p.captured is not None)
        captured = [k for k in graphs if k.startswith(graph)]
        if not captured:
            raise AssertionError(f"({key}): no {graph} program was captured ({graphs})")
        if got != want["streams"]:
            bad = [r for r in got if got[r] != want["streams"][r]]
            raise AssertionError(f"({key}): the tokens of {bad} differ from the card's path")
        steps = st.decode_rounds + st.replayed_tokens
        passes = prefills + st.prefill_chunks + steps
        expect = {name: 0 for name in DECODE_KERNELS}
        expect.update({"tlmm": 7 * cfg.num_layers * passes,
                       "act_quant": 7 * cfg.num_layers * passes,
                       "prefill_attention": cfg.num_layers * prefills,
                       "paged_decode_attention_quant": cfg.num_layers * steps})
        if launches != expect:
            raise AssertionError(f"({key}): launches {launches} != expected {expect}")
        if key == "M1s":
            spec = {k: getattr(st, k) for k in MS_SPEC}
            if spec != want["spec"]:
                raise AssertionError(f"({key}): speculation {spec} != path (k)'s {want['spec']}")
            extra = (f"{_spec_line(spec)}, as (k); decode {st.decode_round_cost() * 1e3:.2f} ms "
                     f"a round against (k)'s {want['round_ms']:.2f}")
        else:
            if st.prefill_chunks != want["chunks"]:
                raise AssertionError(f"({key}): {st.prefill_chunks} chunks, (i) "
                                     f"{want['chunks']}")
            extra = (f"{st.prefill_chunks} chunks, as (i); decode {st.decode_tput():.1f} tok/s "
                     f"against (i)'s {want['tput']:.1f}")
        shown = ", ".join(captured[:3]) + (", ..." if len(captured) > 3 else "")
        print(f"({key}) {what}, on a (1, 1) NCCL mesh: {len(prompts)} requests x {max_tokens}, "
              f"{prefills} monolithic prefills, {st.decode_rounds} decode rounds, {wall:.2f} s "
              f"wall; {extra}; {len(captured)} {graph[:-1]} graphs captured with their "
              f"collectives inside ({shown}); tokens equal the card's path bit for bit; "
              f"launches {launches}  [{card}]")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng
    print(f"(M1s), (M1c) the phase {time.perf_counter() - t0:.1f} s  [{card}]")
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


def _family_refs(torch, T, cfg, key, chunk_key):
    """Phase 10's references of one arch: (key)'s prefill and (chunk_key)'s
    (``family_references``), and for an MoE the plain version's drops at 2
    layers in the first chunk of the 1,536-token prompt.  Returns (p_gpu,
    p_cpu, those drops or None)."""
    import numpy as np

    family_references(torch, T, cfg, key)
    p_gpu, p_cpu = family_references(torch, T, cfg, chunk_key, chunked=True)
    plain = None
    if cfg.moe:
        longest = make_prompts(np, cfg, PROMPT_LENS)[PROMPT_LENS.index(1536)]
        plain = moe_drops(torch, T, dataclasses.replace(cfg, num_layers=2), p_cpu,
                          torch.from_numpy(longest[None]).long(), "cpu")
    return p_gpu, p_cpu, plain


FAMILY_REFS = (("r", "s", "qwen2.5-14b"), ("t", "u", "granite-moe-3b-a800m"))


def family_reference_jobs(torch):
    """Phase 10's references as (key, fn) jobs for ``EARLY``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    return [(f"references ({key}), ({chunk_key})",
             lambda key=key, chunk_key=chunk_key, arch=arch:
             _family_refs(torch, T, get_config(arch), key, chunk_key))
            for key, chunk_key, arch in FAMILY_REFS]


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


def family_phase(torch, np, card, me2=None, m1_mesh=None):
    """Phase 10, the transformer family at full width on bf16 weights from
    seed 0, each model's engine and weights freed before the next: (r)
    qwen2.5-14b at full depth, contiguous bf16, pdswap, (d)'s 8 prompts,
    32 new tokens; (s) its weights on a paged int8 pool of 512 pages of 16
    with 256-token chunks; (t) granite-moe-3b-a800m as (r) and (u) as (s),
    with the experts' dropped assignments in the first chunk of the
    1,536-token prompt; (v) the other five archs on one 300-token prompt,
    8 new tokens (chameleon-34b and moonshot-v1-16b-a3b at cut depth).
    With (ME2)'s results ``me2`` and (M1)'s mesh, (ME1), (E4) and (F2) run
    on (t)'s weights right after (t) (``moe_mesh_card_phase``).  Returns
    the launches summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    max_tokens, eng_kw = 32, dict(n_slots=4, max_len=2048, mode="pdswap", overlap=True)
    paged_kw = dict(eng_kw, cache_layout="paged", kv_dtype="int8", block_size=16,
                    prefill_chunk=CHUNK)
    for key, chunk_key, arch in FAMILY_REFS:
        _elapsed(f"path ({key}), {arch}")
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
        streams = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
        del eng
        _free(torch)
        if cfg.moe and me2 is not None:
            _elapsed("(ME1), (E4), (F2)")
            add(moe_mesh_card_phase(torch, np, cfg, params, streams, me2, m1_mesh, card))
        eng, _, launches = family_path(
            torch, np, chunk_key, f"{arch}, paged int8, 512 pages, {CHUNK}-token chunks", cfg,
            params, prompts, max_tokens, card, eager_graph=False, **paged_kw)
        add(launches)
        del eng
        _free(torch)
        p_gpu, p_cpu, plain = EARLY.take(f"references ({key}), ({chunk_key})",
                                         lambda: _family_refs(torch, T, cfg, key, chunk_key))
        if cfg.moe:
            longest = torch.from_numpy(prompts[PROMPT_LENS.index(1536)][None]).long()
            cfg2 = dataclasses.replace(cfg, num_layers=2)
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
    _elapsed("path (v)")
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
        _elapsed(path.__name__)
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
        _elapsed(path.__name__)
        launches = (EARLY.take("(T4)", lambda: family_gradients(torch, np, card))
                    if path is family_gradients else path(torch, np, card))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    refusal_checks(torch, ops)
    return total


# ---- phase (ME): MoE expert parallelism on a mesh of processes --

ME_ARCH = "granite-moe-3b-a800m"
ME_PROMPTS, ME_NEW = 4, 16  # (ME2): the main path's first 4 prompts, 16 new tokens
# (ME2b) keeps the full depth: cut to 8 of its 32 layers (4 x 16) it read
# 0.221 against (E4b) on the logits of common tokens, over the (M2) limit
# of 0.2 (a capacity-bound routing flips on another float order; H100 80GB
# HBM3, 700 W), and one reading sets no new limit
# (ME2)'s configurations: key, what, the engine's options
ME_PATHS = (
    ("ME2a", "contiguous bf16, pdswap with the overlapped swap",
     dict(cache_layout="contiguous", kv_dtype="fp", mode="pdswap", overlap=True)),
    ("ME2b", "paged int8, bs 16, full pool of 512 pages, pdswap",
     dict(cache_layout="paged", kv_dtype="int8", mode="pdswap")),
)
ME3_STEPS = 3
ME3_CAPACITY = 8.0  # (ME3): C = 1.6 T, over the T rows an expert can receive, so nothing drops
# (ME3) against the single card, relative (loss, grad norm and aux loss a
# step; mu and nu after step 3, each leaf's largest difference over its
# largest |value|): f32 with TF32 off, the ranks' sums of partial products,
# the data ranks' aux counts and the exchanged experts' rows taken in other
# orders than one card's.  Read on one H100 80GB HBM3 (700 W): loss
# 1.16e-7, grad norm 1.31e-7, aux 8.9e-8, mu 4.2e-6, nu 2.9e-6; the planted
# fault (the exchange's backward left out): loss 2.5e-3 (step 2; steps 0-1
# move no weight), grad norm 0.095-0.35, aux 0.078, mu 1.27, nu 1.22.  The
# limits lie between, each about 100 times the sound reading.
ME_LIMITS = {"loss": 1e-5, "grad_norm": 1e-5, "aux": 1e-5, "mu": 1e-3, "nu": 1e-3}


def _moe_counters(phase):
    """Count, on this rank, each MoE call's dropped assignments (device
    tensors, read once at the end) and the exchanges (calls and bytes),
    each under ``phase["now"]`` ("prefill", "decode", "step").  Returns
    (the record, a function putting ``_route`` and ``exchange`` back)."""
    from repro_torch.layers import collectives as C
    from repro_torch.layers import moe as M

    rec = {"drops": [], "exchanges": {"prefill": [0, 0], "decode": [0, 0], "step": [0, 0]}}
    route, exchange = M._route, C.exchange

    def counting(gate_logits, k, capacity, num_experts):
        out = route(gate_logits, k, capacity, num_experts)
        rec["drops"].append((phase["now"], (out[1] == num_experts * capacity).sum()))
        return out

    def counted(x, group, *, split_dim, cat_dim):
        c = rec["exchanges"][phase["now"]]
        c[0] += 1
        c[1] += x.numel() * x.element_size()
        return exchange(x, group, split_dim=split_dim, cat_dim=cat_dim)

    M._route, C.exchange = counting, counted

    def restore():
        M._route, C.exchange = route, exchange
    return rec, restore


def _drops_by_layer(drops, layers):
    """{"prefill" | "decode": [dropped assignments of layer l, summed over
    the calls]} from calls in order (each forward runs layers 0..L-1, one
    routing a layer: no prompt reaches ``MOE_TOKEN_CHUNK`` rows)."""
    out = {"prefill": [0] * layers, "decode": [0] * layers}
    seen = {"prefill": 0, "decode": 0}
    for phase, n in drops:
        out[phase][seen[phase] % layers] += int(n)
        seen[phase] += 1
    return out


def _me_rank(mesh, out: Path) -> None:
    """(ME2) and (ME3) on this rank of the world."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.models import transformer as T

    rank = mesh.rank
    cfg = get_config(ME_ARCH)
    t_draw = time.perf_counter()
    whole = T.init(cfg, seed=0, device=mesh.device)  # (t)'s weights
    whole_bytes = _tree_bytes(whole)
    params = shard_params(whole, cfg, mesh)
    del whole
    _free(torch)
    t_draw = time.perf_counter() - t_draw
    prompts = make_prompts(np, cfg, PROMPT_LENS[:ME_PROMPTS])
    for key, _, kw in ME_PATHS:
        t0 = time.perf_counter()
        phase = {"now": "decode"}
        rec_moe, restore = _moe_counters(phase)
        try:
            eng, rec, prefills, wall = _serve_rank(torch, dist, mesh, cfg, params, prompts,
                                                   ME_NEW, kw, record=True, phase=phase)
        finally:
            restore()
        result = _rank_result(mesh, eng, rec, prefills, wall, params, whole_bytes, t0)
        result.update(drops=_drops_by_layer(rec_moe["drops"], cfg.num_layers),
                      moe_exchanges=rec_moe["exchanges"], draw_s=t_draw)
        (out / f"{key}_rank{rank}.json").write_text(json.dumps(result))
        if rec is not None:
            _save_rows(torch, rec, result["streams"], out / f"{key}_rows.pt")
        del eng, rec
        _free(torch)
    del params
    _free(torch)
    _me3_rank(mesh, out)


def _me3_rank(mesh, out: Path) -> None:
    """(ME3) on this rank: granite training at full width, cut to
    ``MOE_TRAIN_LAYERS`` layers, capacity ``ME3_CAPACITY``, ``ME3_STEPS``
    steps on (T2)'s batches on the (2, 2) mesh, against one card (rank 0)
    within ``ME_LIMITS``; then the planted fault (the exchange's backward
    left out) must break every limit.  Rank 0 writes the report to
    ``ME_result.json``; a broken check fails the world."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch.sharding_rules import gather_params
    from repro_torch.layers import collectives as C
    from repro_torch.train import trainer as TR

    rank, dev = mesh.rank, mesh.device
    t_start = time.perf_counter()
    report, failures = [], []

    def say(line):
        if rank == 0:
            report.append(line)
            print(line, flush=True)

    def check(ok, what):
        if not ok:
            failures.append(what)
            say(f"FAILED: {what}")

    cfg = dataclasses.replace(get_config(ME_ARCH), num_layers=MOE_TRAIN_LAYERS,
                              moe_capacity_factor=ME3_CAPACITY)
    tcfg = TR.TrainConfig(schedule="wsd", warmup=1, total_steps=ME3_STEPS)
    batches = _mt_batches(np, cfg, ME3_STEPS)
    rec_moe, restore = _moe_counters({"now": "step"})
    tally, untally = _tally_collectives(dist)
    reset_counts()
    try:
        params, opt = TR.init_train_state(cfg, 0, mesh=mesh)
        params, opt, hist = _mt_steps(torch, TR.make_train_step(cfg, tcfg, mesh), params, opt,
                                      batches, 0, ME3_STEPS, dev)
    finally:
        restore()
        untally()
    launches = dict(COUNTS)
    drops = sum(int(n) for _, n in rec_moe["drops"])
    calls, nbytes = rec_moe["exchanges"]["step"]

    def moments(opt):  # mu and nu gathered whole onto rank 0's card
        return {k: gather_params(getattr(opt, k), cfg, mesh, train=True, only=0)
                for k in ("mu", "nu")}

    whole = moments(opt)
    del params, opt
    _free(torch)
    ref, rel = None, None
    if rank == 0:  # one card, the others waiting at the fault run's first collective
        p1, o1 = TR.init_train_state(cfg, 0, dev)
        p1, o1, ref = _mt_steps(torch, TR.make_train_step(cfg, tcfg), p1, o1, batches, 0,
                                ME3_STEPS, dev)
        del p1
        rel = {k: _mt_tree_rel(torch, whole[k], getattr(o1, k)) for k in whole}
    del whole
    _free(torch)
    exchange = C.exchange

    def forward_only(x, group, *, split_dim, cat_dim):  # the planted fault
        return C.all_to_all(x.detach(), group, split_dim=split_dim, cat_dim=cat_dim)

    C.exchange = forward_only
    try:
        pf, of = TR.init_train_state(cfg, 0, mesh=mesh)
        pf, of, hf = _mt_steps(torch, TR.make_train_step(cfg, tcfg, mesh), pf, of, batches, 0,
                               ME3_STEPS, dev)
    finally:
        C.exchange = exchange
    whole_f = moments(of)
    del pf, of
    fault_rel = None
    if rank == 0:
        fault_rel = {k: _mt_tree_rel(torch, whole_f[k], getattr(o1, k)) for k in whole_f}
        del o1
    del whole_f
    _free(torch)
    ref, rel, fault_rel = _bcast_obj(dist, (ref, rel, fault_rel))
    check(not any(launches.values()), f"(ME3): training launched kernels {launches}")
    check(drops == 0, f"(ME3): {drops} assignments dropped at capacity factor {ME3_CAPACITY}")
    check(not _mt_faults(hist, ref, rel, ME_LIMITS, ME3_STEPS),
          "(ME3) against the single card: " + "; ".join(_mt_faults(hist, ref, rel, ME_LIMITS,
                                                                    ME3_STEPS)))
    worst = _mt_worst(hist, ref, rel, ME_LIMITS)
    fault_worst = _mt_worst(hf, ref, fault_rel, ME_LIMITS)
    unbroken = [k for k, v in fault_worst.items() if v <= ME_LIMITS[k]]
    check(not unbroken, f"(ME3): the planted fault passes the limits of {unbroken}: "
          f"{fault_worst}")
    say(f"(ME3) {ME_ARCH} training at full width, {cfg.num_layers} of 32 layers (f32 weights "
        f"as (T3), capacity factor {ME3_CAPACITY}), on a (data 2, model 2) gloo mesh of 4 "
        f"processes on this card, {TRAIN_BATCH} x {TRAIN_SEQ} (T2's batches), {ME3_STEPS} steps: "
        f"losses " + " ".join(f"{h['loss']:.6f}" for h in hist) + ", aux "
        + " ".join(f"{h['aux']:.6f}" for h in hist) + "; against the single card's "
        + " ".join(f"{h['loss']:.6f}" for h in ref) + ", aux "
        + " ".join(f"{h['aux']:.6f}" for h in ref) + "; worst relative "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (after step {ME3_STEPS}, mu and nu gathered onto rank 0's card: "
        + ", ".join(f"{k} in {name}" for k, (v, name) in rel.items())
        + f"); limits {ME_LIMITS}; {drops} assignments dropped; no kernel launched")
    say(f"(ME3) rank 0: {statistics.median(h['ms'] for h in hist[1:]):.1f} ms a step (CUDA events, "
        f"median of steps 1-{ME3_STEPS - 1}) against the single card's "
        f"{statistics.median(h['ms'] for h in ref[1:]):.1f}; {calls // ME3_STEPS} exchanges a "
        f"step (remat and backward included), {nbytes / ME3_STEPS / 2**20:.1f} MiB sent through "
        f"them a step; {tally['calls'] // ME3_STEPS} collectives and "
        f"{tally['bytes'] / ME3_STEPS / 2**20:.1f} MiB through them a step in all")
    say(f"(ME3) planted fault (the exchange's backward left out): worst relative "
        + ", ".join(f"{k} {v:.3g}" for k, v in fault_worst.items()) + "; fails the limits: "
        + "; ".join(_mt_faults(hf, ref, fault_rel, ME_LIMITS, ME3_STEPS)))
    say(f"(ME3) rank 0's seconds {time.perf_counter() - t_start:.1f}")
    if failures:
        raise AssertionError(f"rank {rank}: " + "; ".join(failures))
    if rank == 0:
        (out / "ME_result.json").write_text(json.dumps({"report": report}))


def me2_results(torch, cfg, card):
    """(ME2)'s per-rank checks and printout from the ranks' files (the
    ranks' snapshots equal, each rank's launches by shape those its stats
    imply); returns {key: rank 0's streams, its logits rows, every rank's
    drops by layer, rank 0's launches} for the single-card comparison
    (``moe_mesh_card_phase``)."""
    out = {}
    for key, what, kw in ME_PATHS:
        ranks = [json.loads((MESH_DIR / f"{key}_rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        r0 = ranks[0]
        for r, got in enumerate(ranks):
            if got["snapshot"] != r0["snapshot"]:
                raise AssertionError(f"({key}): rank {r}'s host decisions differ from rank 0's")
            want = _mesh_expect(cfg, kw, got["stats"], got["stats"]["prefills"])
            if got["launches"] != want or sum(got["shapes"].values()) != sum(want.values()):
                raise AssertionError(f"({key}) rank {r}: launches {got['launches']} != {want}")
            ex = got["moe_exchanges"]
            rounds = max(got["stats"]["decode_rounds"], 1)
            print(f"({key}) rank {r}: {got['describe']}")
            for line in _shape_lines(got["shapes"]):
                print(f"    {line}")
            print(f"    KV {got['kv_mib']:.1f} MiB and weights {got['weights_mib']:.1f} MiB (the "
                  f"whole tree's {got['whole_weights_mib']:.1f}, drawn in {got['draw_s']:.1f} s "
                  f"and dropped once sliced) on this rank; the MoE's exchanges: "
                  f"{ex['decode'][0] / rounds:.1f} a decode round, "
                  f"{ex['decode'][1] / rounds / 2**20:.2f} MiB sent a round; "
                  f"{ex['prefill'][0]} in the prefills, {ex['prefill'][1] / 2**20:.1f} MiB; the "
                  f"swap's exchange {got['exchange_bytes']} bytes  [{card}]")
        st = r0["stats"]
        print(f"({key}) {ME_ARCH} {what} on the (2, 2) gloo mesh: {st['prefills']} prefills, "
              f"{st['decode_rounds']} decode rounds, {r0['wall']:.2f} s wall, decode "
              f"{st['decode_round_ms']:.2f} ms/round ({st['decode_tput']:.1f} tok/s), TTFT mean "
              f"{st['ttft_mean_ms']:.1f} ms; the 4 ranks' snapshots equal; the rank's seconds "
              f"{r0['seconds']:.1f}  [{card}]")
        out[key] = {"streams": r0["streams"], "launches": r0["launches"],
                    "recorder": _RowsRecorder(torch.load(MESH_DIR / f"{key}_rows.pt"), "cpu"),
                    "drops": [got["drops"] for got in ranks]}
    return out


class _GroupedMoE:
    """Each MoE call of an engine on one card routed in the dispatch groups
    of the (2, 2) mesh's ranks, by wrapping ``transformer.moe_forward``: a
    prefill's sequence cut in the model ranks' halves, a decode round's rows
    in the data ranks' halves (every model rank routes all of them), each
    group routed alone at its own capacity.  Counts each group's drops by
    layer; with ``fault`` the experts of shard 1 (the second half) give
    zeros, as if their outputs were lost after the inverse exchange."""

    def __init__(self, cfg, fault: bool = False):
        self.cfg, self.fault = cfg, fault
        self.reset()
        self._calls = {"prefill": 0, "decode": 0}

    def reset(self):
        """Forget the drops counted so far (a warm-up's, a capture's)."""
        self.drops = {"prefill": [[[] for _ in range(self.cfg.num_layers)] for _ in range(2)],
                      "decode": [[[] for _ in range(self.cfg.num_layers)] for _ in range(2)]}

    def __enter__(self):
        import torch

        from repro_torch.layers import moe as M
        from repro_torch.models import transformer as T

        self.T, self.M = T, M
        self.plain, self.route, self.ffn = T.moe_forward, M._route, M._expert_ffn
        self.group = None

        def route(gate_logits, k, capacity, num_experts):
            got = self.route(gate_logits, k, capacity, num_experts)
            if not torch.cuda.is_current_stream_capturing():  # a replay runs no Python
                phase, g, layer = self.group
                self.drops[phase][g][layer].append((got[1] == num_experts * capacity).sum())
            return got

        def ffn(buf, *w):
            y = self.ffn(buf, *w)
            if self.fault:
                y[buf.shape[0] // 2:] = 0
            return y

        def grouped(params, x, cfg, **kw):
            b, s, _ = x.shape
            phase = "decode" if s == 1 else "prefill"
            dim = 0 if s == 1 else 1
            layer = self._calls[phase] % cfg.num_layers
            self._calls[phase] += 1
            if x.shape[dim] % 2:
                raise AssertionError(f"(E4): a {phase} of {tuple(x.shape)} does not split in two")
            ys = []
            for g, part in enumerate(x.chunk(2, dim=dim)):
                self.group = (phase, g, layer)
                ys.append(self.plain(params, part.contiguous(), cfg, **kw))
            return torch.cat(ys, dim=dim)

        T.moe_forward, M._route, M._expert_ffn = grouped, route, ffn
        return self

    def __exit__(self, *exc):
        self.T.moe_forward, self.M._route, self.M._expert_ffn = self.plain, self.route, self.ffn

    def by_rank(self):
        """The prefill drops by layer a rank (d, m) of the mesh makes: those
        of the prefill half m, as rank r = 2 d + m.  The decode rounds are
        replayed graphs, which run no Python: their groups of 2 rows route
        under a capacity of 8 and drop nothing."""
        return [[int(sum(int(n) for n in cell)) for cell in self.drops["prefill"][r % 2]]
                for r in range(MESH_WORLD)]


def moe_mesh_card_phase(torch, np, cfg, params, t_streams, me2, m1_mesh, card):
    """On one card, on (t)'s weights: (ME1) (t)'s engine on the (data 1,
    model 1) NCCL mesh of (M1) (the MoE's exchanges on groups of one, the
    decode graph captured with them), whose tokens must be (t)'s bit for
    bit; (E4) the engine of each (ME2) configuration with every MoE call
    routed in the ranks' dispatch groups (``_GroupedMoE``), which (ME2)'s
    streams must equal up to near ties within the (M2) limits, each layer's
    drops by rank printed beside (ME2)'s; (F2) (E4a) with expert shard 1's
    outputs zeroed, the planted fault, which must break the limits.
    Returns the launches summed."""
    from repro_torch.serving import SamplingParams

    t0 = time.perf_counter()
    greedy = lambda rid: SamplingParams()  # noqa: E731
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    prompts = make_prompts(np, cfg, PROMPT_LENS)
    kw = dict(n_slots=4, max_len=2048, mode="pdswap", overlap=True)
    eng, st, wall, launches, prefills, _, grid = serve(cfg, params, prompts, 32, mesh=m1_mesh,
                                                       **kw)
    decode_key = "decode:4x2048"
    if decode_key not in grid["captured"]:
        raise AssertionError(f"(ME1): the decode program was not captured ({grid['captured']})")
    expect = {name: 0 for name in DECODE_KERNELS}
    expect.update({"tlmm": 0, "act_quant": 0, "prefill_attention": cfg.num_layers * prefills,
                   "decode_attention": cfg.num_layers * st.decode_rounds})
    if launches != expect:
        raise AssertionError(f"(ME1): launches {launches} != expected {expect}")
    got = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
    if got != t_streams:
        raise AssertionError(f"(ME1): the (1, 1) mesh's tokens differ from (t)'s")
    add(launches)
    print(f"(ME1) {ME_ARCH} at full width and depth on (t)'s weights on a (1, 1) NCCL mesh: "
          f"{st.swaps} prefills, {st.decode_rounds} decode rounds, {wall:.2f} s wall, decode "
          f"{st.decode_round_cost() * 1e3:.2f} ms/round ({st.decode_tput():.1f} tok/s); "
          f"{grid['graphs']} graphs captured, {decode_key} among them with the MoE's exchanges "
          f"on groups of one; tokens equal (t)'s bit for bit; launches {launches}  [{card}]")
    del eng
    _free(torch)
    me_prompts = prompts[:ME_PROMPTS]
    runs = [(key, f"(E4{key[-1]})", kw_, False) for key, _, kw_ in ME_PATHS]
    runs.append((ME_PATHS[0][0], "(F2)", ME_PATHS[0][2], True))
    for key, tag, path_kw, fault in runs:
        rec = []
        with _GroupedMoE(cfg, fault=fault) as grouped:
            eng, st, wall, launches, *_ = serve(
                cfg, params, me_prompts, ME_NEW, n_slots=4, max_len=2048, block_size=16,
                on_engine=lambda e: (grouped.reset(), rec.append(TargetRecorder(e))), **path_kw)
        rec[0].stop()
        add(launches)
        mine = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(ME_PROMPTS)}
        del eng
        ref = me2[key]
        try:
            reading = compare_streams(torch, f"{tag} against ({key})", ref["streams"], mine,
                                      ref["recorder"], _OnDevice(rec[0], "cpu"), greedy)
            faults = mesh_faults(reading)
        except AssertionError as e:  # a stream parts at its prefill's token: no near tie there
            if not fault:
                raise
            faults = [str(e)]
        print(f"{tag} {ME_ARCH} on one card, ({key})'s configuration with each MoE call routed "
              f"in the ranks' dispatch groups{' and expert shard 1 zeroed' if fault else ''}: "
              f"{st.decode_rounds} decode rounds, {wall:.2f} s wall  [{card}]")
        if fault:
            if not faults:
                raise AssertionError(f"(F2): the planted fault passes the (M2) limits (tie "
                                     f"{MESH_TIE_TOL}, logits {MESH_AGREE_TOL})")
            print(f"(F2) fails the (M2) limits against ({key}), as it must: {'; '.join(faults)}")
            continue
        if faults:
            raise AssertionError(f"({key}) against {tag}: " + "; ".join(faults))
        for r, (mesh_drops, card_drops) in enumerate(zip(ref["drops"], grouped.by_rank())):
            print(f"({key}) rank {r} (data {r // 2}, model {r % 2}) assignments dropped by "
                  f"layer in its prefills {mesh_drops['prefill']} (sum "
                  f"{sum(mesh_drops['prefill'])}), in its decode rounds "
                  f"{sum(mesh_drops['decode'])}; {tag}'s for the same group "
                  f"{card_drops} (sum {sum(card_drops)})")
        print(f"({key}) streams {'equal' if not reading['parts'] else 'part at near ties from'} "
              f"{tag}'s, within the (M2) limits (margins {MESH_TIE_TOL}, logits "
              f"{MESH_AGREE_TOL})  [{card}]")
        del rec
        _free(torch)
    print(f"(ME1), (E4), (F2) the phase {time.perf_counter() - t0:.1f} s  [{card}]")
    return total


class _OnDevice:
    """A recorder's rows moved to ``device`` as they are read."""

    def __init__(self, rec, device):
        self.rec, self.device = rec, device

    def row(self, rid, pos):
        got = self.rec.row(rid, pos)
        return None if got is None else got.to(self.device)


def moe_mesh_only(torch, np, card):
    """A development run of phase (ME) alone (``--only-moe-mesh``): the
    world's (ME2) and (ME3), then (t)'s engine on the card for its tokens
    (unchecked: phase 10 checks them) and ``moe_mesh_card_phase`` on a
    world of one of its own."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    me2 = mesh_world_phase(torch, card, parts=("ME",))["ME"]
    cfg = get_config(ME_ARCH)
    params = T.init(cfg, seed=0, device="cuda")
    prompts = make_prompts(np, cfg, PROMPT_LENS)
    eng, *_ = serve(cfg, params, prompts, 32, n_slots=4, max_len=2048, mode="pdswap",
                    overlap=True)
    streams = {f"req{i}": eng.finished[f"req{i}"].out_tokens for i in range(len(prompts))}
    del eng
    _free(torch)
    mesh = open_m1_world()
    try:
        moe_mesh_card_phase(torch, np, cfg, params, streams, me2, mesh, card)
    finally:
        close_m1_world()


# ---- phase (MT): training on a mesh of processes --

MT_DIR = Path("chiprun_out") / "mesh_train"  # the (MT) worlds' stores, results and checkpoint
MT_TIMEOUT_S = 600  # the (MT2)-(MT4) world
MT_STEPS, MT_MORE = 3, 2  # (MT1), (MT2): steps, then 2 more after the checkpoint
MT_PROMPTS, MT_PROMPT_LEN, MT_NEW = 4, 256, 16  # (MT3)
MT_TOY_STEPS = 300  # (MT4): the JAX test's toy regression
# (MT2)-(MT4) run bitnet-730m at full width, cut to 4 of its 24 layers: at
# full depth the 4-rank world took 275 s (12.3 s a step, 1,408 gloo
# collectives; H100 80GB HBM3, 700 W), over the 240 s the phase may take,
# and at 8 layers 115 s, when the smoke before it ran 970 s of its 1,200
MT_LAYERS = 4
# (MT2) against the single card, relative (loss and grad norm a step; mu
# and nu after step 3, each leaf's largest difference over its largest
# |value|): a model rank sums a row-parallel product from two partial
# products (another order of f32 sums), and in QAT a residual an ulp away
# can cross an int8 rounding step of the next fake quantizer; the steps
# carry it on.  Read on one H100 80GB HBM3 (700 W) at 4 layers: loss
# 4.6e-4, grad norm 2.1e-3, mu 0.012, nu 0.017; the planted fault (3
# steps): loss 2.5e-3 (step 2; steps 0-1 move no weight), grad norm
# 0.47-0.50, mu 0.35, nu 0.63 (PERF.md §6).  The params after step 3 are
# read and held to no limit: AdamW moves an element by at most the sum of
# the rates whatever the gradient, so the sound run read 0.012 and the
# fault 0.014; the moments carry a wrong gradient.  The planted fault must
# break every limit here.
MT_LIMITS = {"loss": 1e-3, "grad_norm": 1e-2, "mu": 0.05, "nu": 0.05}


def _mt_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _mt_tree_rel(torch, got, want):
    """Each leaf's largest |difference| over its largest |value| (want's),
    worst leaf: (value, name)."""
    from repro_torch.common.tree import named_leaves

    want = dict(named_leaves(want))
    worst = (0.0, "")
    for name, g in named_leaves(got):
        w = want[name].to(g.device)
        d = float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
        worst = max(worst, (d, name))
    return worst


def _mt_state_rel(torch, whole, p1, o1):
    """A gathered (params, AdamWState) against the single card's, by
    ``_mt_tree_rel``: {"params" | "mu" | "nu": (value, leaf)}."""
    return {k: _mt_tree_rel(torch, a, b) for k, a, b in
            (("params", whole[0], p1), ("mu", whole[1].mu, o1.mu), ("nu", whole[1].nu, o1.nu))}


def _step_keys(limits):
    """The per-step readings ``limits`` bounds: loss, grad norm (and aux)."""
    return [k for k in ("loss", "grad_norm", "aux") if k in limits]


def _mt_worst(hist, ref, state_rel, limits=MT_LIMITS):
    """Each limited reading's worst: {"loss" | "grad_norm" (| "aux") over
    the steps, "mu" | "nu" after the last step: value}."""
    out = {k: max(_mt_rel(h[k], r[k]) for h, r in zip(hist, ref)) for k in _step_keys(limits)}
    return {**out, **{k: v for k, (v, _) in state_rel.items() if k in limits}}


def _mt_faults(hist, ref, state_rel=None, limits=MT_LIMITS, after=MT_STEPS):
    """Where a run's per-step readings, and (``state_rel``) its state after
    step ``after``, break the limits against ``ref``."""
    out = [f"step {i} {k} {h[k]} against {r[k]} (relative {_mt_rel(h[k], r[k]):.3g}, limit "
           f"{limits[k]})" for i, (h, r) in enumerate(zip(hist, ref))
           for k in _step_keys(limits) if _mt_rel(h[k], r[k]) > limits[k]]
    return out + [f"{k} after step {after}: {name} {v:.3g} (limit {limits[k]})"
                  for k, (v, name) in (state_rel or {}).items() if k in limits and v > limits[k]]


def _mt_batches(np, cfg, n):
    from repro_torch.data.pipeline import DataConfig, make_source

    source = make_source(DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                    vocab_size=cfg.vocab_size, seed=0))
    return [source.batch(s) for s in range(n)]


def _mt_steps(torch, step_fn, params, opt, batches, lo, hi, dev, on_step=None):
    """Steps lo..hi-1: (params, opt, [metrics + "ms" by CUDA events])."""
    hist = []
    for s in range(lo, hi):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[s].items()}
        if on_step is not None:
            on_step()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, m = step_fn(params, opt, batch, s)
        e1.record()
        e1.synchronize()
        hist.append({**{k: float(v) for k, v in m.items()}, "ms": e0.elapsed_time(e1)})
    return params, opt, hist


def mesh_train_m1(torch, np, card):
    """(MT1): bitnet-730m QAT at full width and depth, f32 latent weights,
    8 x 256 (T2's batches), 3 steps on a (data 1, model 1) NCCL mesh in its
    process against the single-card step on the same weights and batches:
    every collective is a group of one, so the loss, the grad norm and every
    leaf of params, mu and nu after step 3 must be equal, bit for bit; no
    kernel is launched."""
    import torch.distributed as dist

    from repro_torch.common.tree import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

    t0 = time.perf_counter()
    MT_DIR.mkdir(parents=True, exist_ok=True)
    store = MT_DIR / "m1_store"
    store.unlink(missing_ok=True)
    cfg = get_config("bitnet-730m")
    tcfg = TrainConfig(schedule="wsd", warmup=1, total_steps=MT_STEPS + MT_MORE)
    batches = _mt_batches(np, cfg, MT_STEPS)
    p1, o1 = init_train_state(cfg, 0, "cuda")
    p1, o1, ref = _mt_steps(torch, make_train_step(cfg, tcfg), p1, o1, batches, 0, MT_STEPS, "cuda")
    join_process_group("nccl", init_method=f"file://{store.resolve()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(data=1, model=1)
        reset_counts()
        p2, o2 = init_train_state(cfg, 0, mesh=mesh)
        p2, o2, got = _mt_steps(torch, make_train_step(cfg, tcfg, mesh), p2, o2, batches, 0,
                                MT_STEPS, mesh.device)
        torch.cuda.synchronize()
        _no_launches("(MT1)", dict(COUNTS))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    differ = [f"step {i} {k}: {g[k]!r} against {r[k]!r}" for i, (g, r) in enumerate(zip(got, ref))
              for k in ("loss", "grad_norm") if g[k] != r[k]]
    for what, a, b in (("params", p2, p1), ("mu", o2.mu, o1.mu), ("nu", o2.nu, o1.nu)):
        for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
            if not torch.equal(x, y):
                differ.append(f"{what} {name}: {float((x - y).abs().max())} apart")
    if differ:
        raise AssertionError("(MT1): the (1, 1) mesh's steps differ from the single card's: "
                             + "; ".join(differ[:8]))
    print(f"(MT1) bitnet-730m QAT at full width and depth (f32 latent weights, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {MT_STEPS} steps, WSD) on a (1, 1) NCCL mesh in a process of its own: "
          f"losses "
          + " ".join(f"{h['loss']:.6f}" for h in got) + ", grad norms "
          + " ".join(f"{h['grad_norm']:.6f}" for h in got)
          + "; equal to the single card's bit for bit, and every leaf of params, mu and nu after "
          f"step {MT_STEPS}; {statistics.median(h['ms'] for h in got[1:]):.1f} ms a step on the "
          f"mesh against {statistics.median(h['ms'] for h in ref[1:]):.1f} (CUDA events, median "
          f"of steps 1-{MT_STEPS - 1}); no kernel launched; the phase "
          f"{time.perf_counter() - t0:.1f} s, run while the kernels built (nvcc on the host's "
          f"other cores)  [{card}]")
    del p1, o1, p2, o2
    _free(torch)


def mesh_train_m1_main() -> int:
    """(MT1) in a process of its own (``chip_smoke.py --mesh-train-m1``): a
    second NCCL world in the process that ran (M1) and destroyed its own
    crashed it (a segmentation fault on an H100 80GB HBM3)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    mesh_train_m1(torch, np, smi())
    return 0


def mesh_train_m1_start(flag: str = "--mesh-train-m1"):
    """Start (MT1) (or, ``--mesh-family-m1``, (MF1)) in a process of its own
    (``chip_smoke.py FLAG``), to run while the kernels build."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def mesh_train_m1_wait(proc, what: str = "(MT1)") -> str:
    """The report of (MT1) (or ``what``), once its process has ended;
    raises if it failed."""
    try:
        out, err = proc.communicate(timeout=MT_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{(out + err)[-6000:]}")
    return out.strip()


def _mt_rank(mesh, out: Path) -> None:
    """(MT2)-(MT4) on this rank of the world; rank 0 checks each and writes
    the report to ``MT_result.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import leaves, named_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding_rules import gather_params, shard_params
    from repro_torch.launch.train import gather_state, state_specs
    from repro_torch.layers import collectives as C
    from repro_torch.layers.sharding import TRAIN_RULES, MeshAxes, PartitionCtx
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as Z
    from repro_torch.serving import EngineCore, Request, SamplingParams
    from repro_torch.train import trainer as TR

    t_start = time.perf_counter()
    rank, dev = mesh.rank, mesh.device
    report = []

    def say(line):
        if rank == 0:
            report.append(line)
            print(line, flush=True)

    failures = []

    def check(ok, what):  # read on, and raise at the end: one run prints every reading
        if not ok:
            failures.append(what)
            say(f"FAILED: {what}")

    # the collectives, counted where they reach torch.distributed
    tally, restore = _tally_collectives(dist)

    full = get_config("bitnet-730m")
    cfg = dataclasses.replace(full, num_layers=MT_LAYERS)
    say(f"(MT2)-(MT4) bitnet-730m at full width, cut to {cfg.num_layers} of its "
        f"{full.num_layers} layers (MT_LAYERS: the phase at full depth would take over 240 s)")
    tcfg = TR.TrainConfig(schedule="wsd", warmup=1, total_steps=MT_STEPS + MT_MORE)
    n_steps = MT_STEPS + MT_MORE
    batches = _mt_batches(np, cfg, n_steps)
    marks = []

    def mark():  # each step's collectives
        torch.cuda.synchronize()
        marks.append(dict(tally))

    # ---- (MT2): the (2, 2) run, steps 0-2
    t0 = time.perf_counter()
    reset_counts()
    params, opt = TR.init_train_state(cfg, 0, mesh=mesh)
    mib = [None] * mesh.size
    dist.all_gather_object(mib, (_tree_bytes(params) / 2**20,
                                 (_tree_bytes(opt.mu) + _tree_bytes(opt.nu)) / 2**20))
    step22 = TR.make_train_step(cfg, tcfg, mesh)
    params, opt, h22 = _mt_steps(torch, step22, params, opt, batches, 0, MT_STEPS, dev, mark)
    mark()
    per_step = [(b["calls"] - a["calls"], b["bytes"] - a["bytes"]) for a, b in zip(marks, marks[1:])]
    whole = gather_state(params, opt, cfg, mesh, only=0)  # the host copy on rank 0 alone
    ckpt = out / "ckpt"
    t_save = 0.0
    if rank == 0:
        t_save = time.perf_counter()
        CheckpointManager(str(ckpt)).save(MT_STEPS, whole)
        t_save = time.perf_counter() - t_save
    dist.barrier()
    # the single card on rank 0 (the others wait): steps 0-2, its state then
    # held against the (2, 2) run's and the planted fault's, then steps 3-4
    ref, tree_rel = None, None
    if rank == 0:
        p1, o1 = TR.init_train_state(cfg, 0, dev)
        one = TR.make_train_step(cfg, tcfg)
        p1, o1, ref = _mt_steps(torch, one, p1, o1, batches, 0, MT_STEPS, dev)
        tree_rel = _mt_state_rel(torch, whole, p1, o1)
    del whole
    _free(torch)

    # the planted fault: the data axis's gradient reduction dropped (each data
    # rank's FSDP shard takes its own rows' gradient, the replicated leaves
    # are not summed), so each data rank steps on its own half batch; steps
    # 0-2 as the sound run, and its state after them
    reduce_scatter, reduce_dp = C.reduce_scatter, TR.reduce_dp_grads

    def own_rows(x, group, *, dim, how=None):
        per = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * per, per).contiguous()

    C.reduce_scatter, TR.reduce_dp_grads = own_rows, lambda grads, pctx, rep: grads
    try:
        pf, of = TR.init_train_state(cfg, 0, mesh=mesh)
        pf, of, hf = _mt_steps(torch, TR.make_train_step(cfg, tcfg, mesh), pf, of, batches, 0,
                               MT_STEPS, dev)
    finally:
        C.reduce_scatter, TR.reduce_dp_grads = reduce_scatter, reduce_dp
    whole_f = gather_state(pf, of, cfg, mesh, only=0)
    del pf, of
    fault_rel = None
    if rank == 0:
        fault_rel = _mt_state_rel(torch, whole_f, p1, o1)
        p1, o1, more = _mt_steps(torch, one, p1, o1, batches, MT_STEPS, n_steps, dev)
        ref += more
        del p1, o1
    del whole_f
    _free(torch)
    ref, tree_rel, fault_rel = _bcast_obj(dist, (ref, tree_rel, fault_rel))
    params, opt, more = _mt_steps(torch, step22, params, opt, batches, MT_STEPS, n_steps, dev)
    h22 += more
    launches = dict(COUNTS)
    check(not any(launches.values()), f"(MT2): training launched kernels {launches}")
    check(not _mt_faults(h22, ref, tree_rel), "(MT2) against the single card: "
          + "; ".join(_mt_faults(h22, ref, tree_rel)))
    calls = [c for c, _ in per_step]
    say("(MT2) per step, relative to the single card: loss "
        + " ".join(f"{_mt_rel(h['loss'], r['loss']):.3g}" for h, r in zip(h22, ref))
        + "; grad norm " + " ".join(f"{_mt_rel(h['grad_norm'], r['grad_norm']):.3g}"
                                    for h, r in zip(h22, ref)))
    say(f"(MT2) bitnet-730m QAT at full width ({cfg.num_layers} layers) on a (data 2, model 2) gloo mesh of 4 "
        f"processes on this card, {TRAIN_BATCH} x {TRAIN_SEQ} (T2's batches), "
        f"{n_steps} steps: losses " + " ".join(f"{h['loss']:.6f}" for h in h22)
        + " against the single card's " + " ".join(f"{h['loss']:.6f}" for h in ref)
        + f" (largest relative {max(_mt_rel(h['loss'], r['loss']) for h, r in zip(h22, ref)):.3g}); "
        f"grad norms largest relative "
        f"{max(_mt_rel(h['grad_norm'], r['grad_norm']) for h, r in zip(h22, ref)):.3g}; after step "
        f"{MT_STEPS}: " + ", ".join(f"{k} {v:.3g} ({name})" for k, (v, name) in tree_rel.items())
        + f" of a leaf's largest |value|; limits {MT_LIMITS}")
    say(f"(MT2) rank 0: {statistics.median(h['ms'] for h in h22[1:]):.1f} ms a step (CUDA events, "
        f"median of steps 1-{n_steps - 1}; {min(h['ms'] for h in h22[1:]):.1f}-"
        f"{max(h['ms'] for h in h22[1:]):.1f}) against the single card's "
        f"{statistics.median(h['ms'] for h in ref[1:]):.1f}; {calls[-1]} collectives a step "
        f"({', '.join(map(str, calls))} in steps 0-{MT_STEPS - 1}; each gloo broadcast of a "
        f"gather counted), {per_step[-1][1] / 2**20:.1f} MiB through them a step; no kernel "
        f"launched; the checkpoint at step {MT_STEPS} gathered and written by rank 0 in "
        f"{t_save:.1f} s")
    for r, (p_mib, m_mib) in enumerate(mib):
        say(f"(MT2) rank {r}: params {p_mib:.1f} MiB, moments {m_mib:.1f} MiB (the whole tree's "
            f"{_tree_bytes_cfg(cfg) / 2**20:.1f} and {2 * _tree_bytes_cfg(cfg) / 2**20:.1f})")
    say("(MT2) planted fault per step, relative to the single card: loss "
        + " ".join(f"{_mt_rel(h['loss'], r['loss']):.3g}" for h, r in zip(hf, ref))
        + "; grad norm " + " ".join(f"{_mt_rel(h['grad_norm'], r['grad_norm']):.3g}"
                                    for h, r in zip(hf, ref))
        + f"; after step {MT_STEPS}: "
        + ", ".join(f"{k} {v:.3g} ({name})" for k, (v, name) in fault_rel.items()))
    # the fault must break every limit, so that each has a reading above it
    planted = _mt_faults(hf, ref[:MT_STEPS], fault_rel)
    worst = _mt_worst(hf, ref[:MT_STEPS], fault_rel)
    unbroken = [k for k, v in worst.items() if v <= MT_LIMITS[k]]
    check(not unbroken, f"(MT2): the planted fault passes the limits of {unbroken}: {worst}")
    say(f"(MT2) planted fault (the data axis's gradient reduction dropped): fails the limits: "
        + "; ".join(planted))

    # restore the step-3 checkpoint onto (data 1, model 4) and onto one card
    mgr = CheckpointManager(str(ckpt))
    mesh14 = make_mesh((1, 4), ("data", "model"))
    t_r = time.perf_counter()
    template = TR.init_train_state(cfg, 0, mesh=mesh14)
    state, at = mgr.restore(template, device=dev, shardings=state_specs(template[0], cfg, mesh14),
                            mesh=mesh14)
    del template
    t_r = time.perf_counter() - t_r
    _, _, h14 = _mt_steps(torch, TR.make_train_step(cfg, tcfg, mesh14), *state, batches, at,
                          n_steps, dev)
    del state
    _free(torch)
    h1 = None
    if rank == 0:
        template = TR.init_train_state(cfg, 0, dev)
        state, at1 = mgr.restore(template, device=dev)
        del template
        _, _, h1 = _mt_steps(torch, TR.make_train_step(cfg, tcfg), *state, batches, at1, n_steps,
                             dev)
        del state
        _free(torch)
    h1 = _bcast_obj(dist, h1)
    say("(MT2) restored runs per step, relative to the (2, 2) run's: loss "
        + " / ".join(" ".join(f"{_mt_rel(h['loss'], r['loss']):.3g}"
                              for h, r in zip(hh, h22[MT_STEPS:])) for hh in (h14, h1))
        + "; grad norm " + " / ".join(" ".join(f"{_mt_rel(h['grad_norm'], r['grad_norm']):.3g}"
                                               for h, r in zip(hh, h22[MT_STEPS:]))
                                      for hh in (h14, h1)))
    faults = _mt_faults(h14, h22[MT_STEPS:]) + _mt_faults(h1, h22[MT_STEPS:])
    check(at == MT_STEPS and not faults, f"(MT2) restores (at step {at}): " + "; ".join(faults))
    say(f"(MT2) the step-{MT_STEPS} checkpoint restored onto a (data 1, model 4) mesh in the same "
        f"world ({t_r:.1f} s, every rank reading the whole tree on the host and keeping its "
        f"slice) and onto one card with no mesh: steps {MT_STEPS}-{n_steps - 1} losses "
        + " / ".join(" ".join(f"{h['loss']:.6f}" for h in hh) for hh in (h14, h1))
        + " against the (2, 2) run's " + " ".join(f"{h['loss']:.6f}" for h in h22[MT_STEPS:])
        + f"; grad norms largest relative "
        f"{max(_mt_rel(h['grad_norm'], r['grad_norm']) for hh in (h14, h1) for h, r in zip(hh, h22[MT_STEPS:])):.3g}"
        f"; within the limits")

    # ---- (MT4) first: the compressed mean over data of the ranks' gradients
    latent = gather_params(params, cfg, mesh, train=True)  # the trained weights, whole, on the card
    del params, opt
    _free(torch)
    tp_ctx = PartitionCtx(mesh=mesh, axes=MeshAxes(dp="data", tp="model", fsdp=None),
                          rules=dict(TRAIN_RULES))
    ptp = shard_params(latent, cfg, mesh, train=False)  # tensor-parallel, whole over data
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
    _, _, grads = TR.loss_and_grads(lambda p, b: T.loss_fn(p, b, cfg, pctx=tp_ctx), ptp,
                                    TR.local_rows(tp_ctx, batch))
    del ptp
    data = mesh.group("data")
    n = dist.get_world_size(data)
    err = Z.init_error_feedback(grads)
    mean, err = Z.compressed_mean_over_axis(grads, err, mesh, "data")
    worst, ratio_worst = 0.0, (0.0, "")
    for name, g in named_leaves(grads):
        exact = C.all_reduce(g.float(), data) / n
        scales = C.all_gather(Z._quant_int8(g)[1].reshape(1), data, dim=0)
        bound = float(scales.sum()) / 2 / n  # each rank's rounding within half its scale
        d = float((dict(named_leaves(mean))[name] - exact).abs().max())
        ratio_worst = max(ratio_worst, (d / max(bound, 1e-30), name))
        worst = max(worst, d)
    check(ratio_worst[0] <= 1.0 + 1e-5, f"(MT4): a mean {ratio_worst} of its int8 bound")
    # a rank receives each rank's int8 payload and f32 scale, against its f32 gradient
    int8_b = n * sum(g.numel() + 4 for g in leaves(grads))
    f32_b = n * sum(4 * g.numel() for g in leaves(grads))
    del grads, mean, err
    _free(torch)
    # the JAX test's toy regression, on a (pod 4) mesh of the same ranks
    meshp = make_mesh((4,), ("pod",))
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(dev)
    y = x @ w_true

    def toy_loss(w, b):
        xb, yb = b
        return torch.mean((xb @ w - yb) ** 2)

    grads_fn = Z.compressed_dp_grads(toy_loss, meshp)
    w_c, w_e = torch.zeros(8, device=dev), torch.zeros(8, device=dev)
    ef = Z.init_error_feedback(w_c)
    t_toy = time.perf_counter()
    for _ in range(MT_TOY_STEPS):
        _, g_c, ef = grads_fn(w_c, ef, (x, y))
        w_c = w_c - 0.05 * g_c
        w_e = w_e.requires_grad_()
        (g_e,) = torch.autograd.grad(toy_loss(w_e, (x, y)), w_e)
        w_e = (w_e - 0.05 * g_e).detach()
    t_toy = time.perf_counter() - t_toy
    final_c, final_e = float(toy_loss(w_c, (x, y))), float(toy_loss(w_e, (x, y)))
    check(final_c < 1e-3 and abs(final_c - final_e) < 1e-3,
          f"(MT4) toy regression: compressed {final_c}, exact {final_e}")
    say(f"(MT4) the compressed mean over the data axis of the 4 ranks' full-width gradients "
        f"(step 0's batch, a tensor-parallel slice whole over data, {len(leaves(latent))} leaves): "
        f"every leaf within its int8 bound (the ranks' half scales summed over the group size; "
        f"worst {ratio_worst[0]:.3f} of it, {ratio_worst[1]}; largest difference {worst:.3g}); "
        f"{int8_b / 2**20:.1f} MiB received a rank in int8 + scales against {f32_b / 2**20:.1f} "
        f"in f32 ({int8_b / f32_b:.3f}); the toy regression on a (pod 4) mesh, {MT_TOY_STEPS} "
        f"steps in {t_toy:.1f} s: final loss {final_c:.3g} compressed, {final_e:.3g} exact")

    # ---- (MT3): the (2, 2)-trained weights packed, sliced and served on the (2, 2) mesh
    packed = T.convert_for_inference(latent, cfg)
    del latent
    local = shard_params(packed, cfg, mesh)
    if rank != 0:
        del packed
    _free(torch)
    prompts = make_prompts(np, cfg, [MT_PROMPT_LEN] * MT_PROMPTS)
    kw = dict(n_slots=MT_PROMPTS, max_len=2048, cache_layout="contiguous", kv_dtype="fp",
              mode="pdswap", overlap=True)
    eng = EngineCore(cfg, local, mesh=mesh, **kw)
    rec = TargetRecorder(eng) if rank == 0 else None
    prefills, prefill = [], eng.runner.prefill

    def counted_prefill(*args, **kw_):
        prefills.append(1)
        return prefill(*args, **kw_)

    eng.runner.prefill = counted_prefill
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    t_serve = time.perf_counter()
    if rank == 0:
        for i, p in enumerate(prompts):
            eng.submit(Request(f"q{i}", p, max_new=MT_NEW))
        eng.run()
        eng.stop_followers()
    else:
        eng.follow()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t_serve
    mt3 = dict(COUNTS)
    st = eng.stats
    stats = {"decode_rounds": st.decode_rounds}
    want = _mesh_expect(cfg, kw, stats, len(prefills))
    shapes = {f"{name} {shape}": k for (name, shape), k in COUNTS.shapes().items()}
    check(mt3 == want, f"(MT3) rank {rank}: launches {mt3} != {want}")
    every = [None] * mesh.size
    dist.all_gather_object(every, (mt3, shapes))
    if rank == 0:
        got = {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}
        ref_eng = EngineCore(cfg, packed, device=dev, **kw)
        ref_rec = TargetRecorder(ref_eng)
        for i, p in enumerate(prompts):
            ref_eng.submit(Request(f"q{i}", p, max_new=MT_NEW))
        ref_eng.run()
        want_streams = {k: list(map(int, r.out_tokens)) for k, r in sorted(ref_eng.finished.items())}
        try:
            parted = check_near_ties(torch, "(MT3)", got, want_streams, rec, ref_rec,
                                     lambda rid: SamplingParams(), tol=MESH_TIE_TOL,
                                     agree_tol=MESH_AGREE_TOL)
        except AssertionError as e:
            check(False, str(e))
            parted = "not at near ties"
        say(f"(MT3) the (2, 2)-trained weights gathered, packed (convert_for_inference) and "
            f"sliced, served on the (2, 2) mesh: {MT_PROMPTS} prompts of {MT_PROMPT_LEN}, "
            f"{MT_NEW} new, greedy: {len(prefills)} prefills, {st.decode_rounds} decode rounds, "
            f"{t_serve:.1f} s; streams "
            f"{'equal' if not parted else f'part at near ties {parted} from'} the single-card "
            f"engine's on the same packed weights (margins within {MESH_TIE_TOL}, logits within "
            f"{MESH_AGREE_TOL}); rank 0's launches {mt3}")
        for r, (_, sh) in enumerate(every):
            for line in _shape_lines(sh):
                say(f"    (MT3) rank {r} {line}")
        del ref_eng, ref_rec, packed
    del eng, rec
    restore()
    _free(torch)
    say(f"(MT2)-(MT4) rank 0's seconds {time.perf_counter() - t_start:.1f}")
    if failures:
        raise AssertionError(f"rank {rank}: " + "; ".join(failures))
    if rank == 0:
        (out / "MT_result.json").write_text(json.dumps({"report": report, "launches": mt3}))


# ---- phase (MF): training of hymba, xLSTM and whisper on a mesh of processes --

# The families at full width, cut in depth as (T4) cuts them: hymba 2 of 32
# layers (layer 0 global, layer 1 windowed), 4 x 2,048 tokens so that the
# 1,024-token window masks (its 25 and 5 heads split on no model axis:
# every rank computes every head); xlstm one group of its 8 layers (7 mLSTM
# blocks and the sLSTM), 4 x 256; whisper 2 + 2 layers over 1,500 frames,
# 4 x 64 decoder tokens
MF_CUTS = (("hymba-1.5b", dict(num_layers=2), 2048),
           ("xlstm-1.3b", dict(num_layers=8), 256),
           ("whisper-large-v3", dict(num_layers=2, encoder_layers=2), 64))
MF_BATCH, MF_STEPS = 4, 3
MF_STORE = MT_DIR / "mf1_store"
# (MF2) against the single card, relative, as MT_LIMITS: loss and grad norm
# a step, mu and nu after step 3 (each leaf's largest difference over its
# largest |value|).  f32 with TF32 off and no QAT: the mesh sums its
# row-parallel products, the FSDP reduce-scatters and the channel sums in
# other orders than one card.  Read on one H100 80GB HBM3 (700 W; PERF.md
# §6): hymba loss 1.8e-7, grad norm 7.5e-7, mu 4.0e-6, nu 5.7e-6;
# whisper 0, 1.7e-7, 1.2e-6, 1.6e-6; their faults (1 step) 3.2e-5 and
# 4.2e-3, 1.1e-3 and 0.16, moments 1.8-6.0.  xlstm reads steps 0-1 as they
# do (8.5e-8, 4.0e-6) and step 2 8.1e-6, grad norm 1.1e-3, mu 0.113 (w_og),
# nu 0.080 (hnorm): step 1, the first at the full rate, clips grad norms of
# 60-76 and AdamW moves each weight by about the rate whatever its
# gradient, so rounding noise picks the sign of many moves, and the
# exponential gates carry it on.  One card reordering its own sums alone
# (two microbatches of the same rows, the same mean) reads 1.3e-5, 3.6e-4,
# 0.038, 0.054 there; its fault 2.9e-3, 0.51, 3.1, 6.2.  Each limit lies
# 4 to 60 times over its sound reading and 6 times or more under its
# fault's.
MF_LIMITS = {
    "hymba-1.5b": {"loss": 3e-6, "grad_norm": 1e-5, "mu": 1e-4, "nu": 1e-4},
    "xlstm-1.3b": {"loss": 1e-4, "grad_norm": 1e-2, "mu": 0.5, "nu": 0.5},
    "whisper-large-v3": {"loss": 3e-6, "grad_norm": 1e-5, "mu": 1e-4, "nu": 1e-4},
}
MF_FAULTS = {"hymba-1.5b": "the SSM's w_bc partial sums not summed over the model axis",
             "xlstm-1.3b": "hnorm's mean of squares not summed over the model axis",
             "whisper-large-v3": "the cross attention's K/V from the other model rank's heads"}


def _mf_config(arch, cut):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **cut)


def _mf_batches(np, cfg, seq, n):
    from repro_torch.data.pipeline import DataConfig, make_source, with_frames

    source = make_source(DataConfig(batch=MF_BATCH, seq_len=seq, vocab_size=cfg.vocab_size,
                                    seed=0))
    return [with_frames(source.batch(s), cfg, 0, s) for s in range(n)]


def _mf_tcfg():
    from repro_torch.train.trainer import TrainConfig

    return TrainConfig(schedule="wsd", warmup=1, total_steps=MF_STEPS)


def mesh_family_m1(torch, np, card):
    """(MF1): one step of each family (``MF_CUTS``) on a (data 1, model 1)
    NCCL mesh in its process against the single card's step on the same
    weights and batch: every collective is a group of one, so the loss,
    the grad norm and every leaf of params, mu and nu must be equal, bit
    for bit; no kernel is launched."""
    import torch.distributed as dist

    from repro_torch.common.tree import named_leaves
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.train.trainer import init_train_state, make_train_step

    t0 = time.perf_counter()
    MT_DIR.mkdir(parents=True, exist_ok=True)
    MF_STORE.unlink(missing_ok=True)
    join_process_group("nccl", init_method=f"file://{MF_STORE.resolve()}", rank=0, world_size=1)
    lines = []
    try:
        mesh = make_host_mesh(data=1, model=1)
        for arch, cut, seq in MF_CUTS:
            cfg = _mf_config(arch, cut)
            batches = _mf_batches(np, cfg, seq, 1)
            p1, o1 = init_train_state(cfg, 0, "cuda")
            p1, o1, ref = _mt_steps(torch, make_train_step(cfg, _mf_tcfg()), p1, o1, batches, 0,
                                    1, "cuda")
            reset_counts()
            p2, o2 = init_train_state(cfg, 0, mesh=mesh)
            p2, o2, got = _mt_steps(torch, make_train_step(cfg, _mf_tcfg(), mesh), p2, o2,
                                    batches, 0, 1, mesh.device)
            torch.cuda.synchronize()
            _no_launches(f"(MF1) {arch}", dict(COUNTS))
            differ = [f"{k}: {got[0][k]!r} against {ref[0][k]!r}" for k in ("loss", "grad_norm")
                      if got[0][k] != ref[0][k]]
            for what, a, b in (("params", p2, p1), ("mu", o2.mu, o1.mu), ("nu", o2.nu, o1.nu)):
                for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
                    if not torch.equal(x, y):
                        differ.append(f"{what} {name}: {float((x - y).abs().max())} apart")
            if differ:
                raise AssertionError(f"(MF1) {arch}: the (1, 1) mesh's step differs from the "
                                     "single card's: " + "; ".join(differ[:8]))
            lines.append(f"(MF1) {arch} at full width, {cut}, {MF_BATCH} x {seq}: loss "
                         f"{got[0]['loss']:.6f}, grad norm {got[0]['grad_norm']:.6f}, params, mu "
                         f"and nu equal to the single card's bit for bit; {got[0]['ms']:.1f} ms "
                         f"on the mesh against {ref[0]['ms']:.1f} (CUDA events, first step)")
            del p1, o1, p2, o2
            _free(torch)
    finally:
        dist.destroy_process_group()
        MF_STORE.unlink(missing_ok=True)
    print("\n".join(lines) + f"\n(MF1) a (1, 1) NCCL mesh in a process of its own, run while the "
          f"kernels built: no kernel launched; the phase {time.perf_counter() - t0:.1f} s  [{card}]")


def mesh_family_m1_main() -> int:
    """(MF1) in a process of its own (``chip_smoke.py --mesh-family-m1``)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    mesh_family_m1(torch, np, smi())
    return 0


def _mf_fault(arch, mesh):
    """Plant ``arch``'s fault on this rank; returns the function that lifts
    it.  hymba: the SSM's ``xc @ w_bc`` partial sums not summed over the
    model axis; xlstm: ``hnorm``'s mean of squares not summed; whisper: the
    cross attention's K/V taken from the other model rank's heads."""
    import torch.distributed as dist

    from repro_torch.layers import collectives as C
    from repro_torch.models import encdec as E, ssm as S, xlstm as X

    if arch.startswith("hymba"):
        real, S._bc = S._bc, lambda xc, w_bc, pctx: xc @ w_bc.float()
        return lambda: setattr(S, "_bc", real)
    if arch.startswith("xlstm"):
        real, X._mean_square = (X._mean_square,
                                lambda xf, d, pctx: (xf * xf).sum(dim=-1, keepdim=True) / d)
        return lambda: setattr(X, "_mean_square", real)
    real = E.project_cross_kv

    def other_shard(cross, enc_out, cfg, pctx):
        group = pctx.mesh.group(pctx.axes.tp)
        k = dist.get_world_size(group)
        nxt = (dist.get_rank(group) + 1) % k
        return tuple(C.gather_replicated(t, group, dim=1).chunk(k, dim=1)[nxt]
                     for t in real(cross, enc_out, cfg, pctx))

    E.project_cross_kv = other_shard
    return lambda: setattr(E, "project_cross_kv", real)


def _mf_moments_rel(torch, mesh, cfg, opt, ref):
    """Rank 0's ``_mt_tree_rel`` of each moment tree of this rank's slices
    ``opt`` (gathered leaf by leaf onto rank 0's card) against ``ref``
    ({"mu" | "nu": {leaf name: tensor}}, the single card's on rank 0, which
    ``_mt_tree_rel`` reads by name as it is): {"mu" | "nu": (value, leaf)}
    on rank 0, None elsewhere."""
    from repro_torch.launch.sharding_rules import gather_params

    out = {}
    for key in ("mu", "nu"):
        whole = gather_params(getattr(opt, key), cfg, mesh, train=True, only=0)
        if mesh.rank == 0:
            out[key] = _mt_tree_rel(torch, whole, ref[key])
        del whole
    return out if mesh.rank == 0 else None


def _mf_rank(mesh, out: Path) -> None:
    """(MF2) on this rank of the world: each family of ``MF_CUTS`` 3 steps
    on the (2, 2) mesh, each rank on its ``shard_params`` slice, held to
    the single card's steps (run first on rank 0; the others wait) within
    the family's ``MF_LIMITS``; then 1 step with the family's planted fault
    from the same slice, which must break each limit.  Rank 0 writes the
    report to ``MF_result.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.tree import named_leaves, tree_map
    from repro_torch.kernels import COUNTS, reset_counts
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import trainer as TR

    t_start = time.perf_counter()
    rank, dev = mesh.rank, mesh.device
    report, failures = [], []

    def say(line):
        if rank == 0:
            report.append(line)
            print(line, flush=True)

    def check(ok, what):
        if not ok:
            failures.append(what)
            say(f"FAILED: {what}")

    def moments(opt):
        return {k: {n: v.clone() for n, v in named_leaves(getattr(opt, k))} for k in ("mu", "nu")}

    tally, restore = _tally_collectives(dist)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(dict(tally))

    reset_counts()
    for arch, cut, seq in MF_CUTS:
        t0 = time.perf_counter()
        cfg, limits = _mf_config(arch, cut), MF_LIMITS[arch]
        batches = _mf_batches(np, cfg, seq, MF_STEPS)
        ref, first, last = None, None, None
        if rank == 0:  # the single card's steps; its moments after steps 1 and 3 kept
            p1, o1 = TR.init_train_state(cfg, 0, dev)
            one = TR.make_train_step(cfg, _mf_tcfg())
            p1, o1, ref = _mt_steps(torch, one, p1, o1, batches, 0, 1, dev)
            first = moments(o1)
            p1, o1, more = _mt_steps(torch, one, p1, o1, batches, 1, MF_STEPS, dev)
            ref, last = ref + more, moments(o1)
            del p1, o1
            _free(torch)
        ref = _bcast_obj(dist, ref)
        params, opt = TR.init_train_state(cfg, 0, mesh=mesh)
        start = tree_map(lambda t: t.clone(), params)  # the planted fault's first step starts here
        mib = [None] * mesh.size
        dist.all_gather_object(mib, (_tree_bytes(params) / 2**20,
                                     (_tree_bytes(opt.mu) + _tree_bytes(opt.nu)) / 2**20))
        marks.clear()
        step = TR.make_train_step(cfg, _mf_tcfg(), mesh)
        params, opt, hist = _mt_steps(torch, step, params, opt, batches, 0, MF_STEPS, dev, mark)
        mark()
        per_step = [(b["calls"] - a["calls"], b["bytes"] - a["bytes"])
                    for a, b in zip(marks, marks[1:])]
        del params
        state_rel = _bcast_obj(dist, _mf_moments_rel(torch, mesh, cfg, opt, last))
        del opt, last
        _free(torch)
        faults = _mt_faults(hist, ref, state_rel, limits=limits)
        check(not faults, f"(MF2) {arch} against the single card: " + "; ".join(faults))
        lift = _mf_fault(arch, mesh)
        try:
            of = adamw_init(start)
            pf, of, hf = _mt_steps(torch, TR.make_train_step(cfg, _mf_tcfg(), mesh), start, of,
                                   batches, 0, 1, dev)
        finally:
            lift()
        del pf, start
        fault_rel = _bcast_obj(dist, _mf_moments_rel(torch, mesh, cfg, of, first))
        del of, first
        _free(torch)
        worst = _mt_worst(hf, ref[:1], fault_rel, limits=limits)
        unbroken = [k for k, v in worst.items() if v <= limits[k]]
        check(not unbroken, f"(MF2) {arch}: the planted fault passes the limits of {unbroken}: "
                            f"{worst}")
        calls = [c for c, _ in per_step]
        say(f"(MF2) {arch} at full width, {cut}, {MF_BATCH} x {seq}"
            f"{f' over {cfg.encoder_seq:,} frames' if cfg.family == 'encdec' else ''}, f32, on a "
            f"(data 2, model 2) gloo mesh of 4 processes on this card, {MF_STEPS} steps: losses "
            + " ".join(f"{h['loss']:.6f}" for h in hist) + " against the single card's "
            + " ".join(f"{h['loss']:.6f}" for h in ref) + "; relative loss "
            + " ".join(f"{_mt_rel(h['loss'], r['loss']):.3g}" for h, r in zip(hist, ref))
            + ", grad norm " + " ".join(f"{_mt_rel(h['grad_norm'], r['grad_norm']):.3g}"
                                        for h, r in zip(hist, ref))
            + f"; after step {MF_STEPS}: " + ", ".join(f"{k} {v:.3g} ({name})"
                                                      for k, (v, name) in state_rel.items())
            + f" of a leaf's largest |value|; limits {limits}")
        say(f"(MF2) {arch} rank 0: {statistics.median(h['ms'] for h in hist[1:]):.1f} ms a step "
            f"(CUDA events, median of steps 1-{MF_STEPS - 1}; step 0 {hist[0]['ms']:.1f}) against "
            f"the single card's {statistics.median(h['ms'] for h in ref[1:]):.1f}; "
            f"{calls[-1]} gloo collectives a step ({', '.join(map(str, calls))}; each broadcast "
            f"of a gather counted), {per_step[-1][1] / 2**20:.1f} MiB through them a step; the "
            f"family's part {time.perf_counter() - t0:.1f} s")
        say(f"(MF2) {arch} per rank, params / moments MiB: "
            + ", ".join(f"rank {r} {p_mib:.1f} / {m_mib:.1f}" for r, (p_mib, m_mib) in enumerate(mib))
            + f" (the whole tree's {_tree_bytes_cfg(cfg) / 2**20:.1f} / "
            f"{2 * _tree_bytes_cfg(cfg) / 2**20:.1f})")
        verdict = "breaks every limit" if not unbroken else f"passes {unbroken}"
        say(f"(MF2) {arch} planted fault ({MF_FAULTS[arch]}), 1 step: loss {hf[0]['loss']:.6f} "
            f"(relative {_mt_rel(hf[0]['loss'], ref[0]['loss']):.3g}), grad norm relative "
            f"{_mt_rel(hf[0]['grad_norm'], ref[0]['grad_norm']):.3g}, after it "
            + ", ".join(f"{k} {v:.3g} ({name})" for k, (v, name) in fault_rel.items())
            + f": {verdict}")
    launches = dict(COUNTS)
    check(not any(launches.values()), f"(MF2): training launched kernels {launches}")
    restore()
    say(f"(MF2) rank 0's seconds {time.perf_counter() - t_start:.1f}")
    if failures:
        raise AssertionError(f"rank {rank}: " + "; ".join(failures))
    if rank == 0:
        (out / "MF_result.json").write_text(json.dumps({"report": report, "launches": launches}))


def _tally_collectives(dist):
    """Count the calls and bytes that reach ``torch.distributed``'s
    collectives (each gloo broadcast of a gather counted).  Returns (the
    tally, a function putting the collectives back)."""
    tally = {"calls": 0, "bytes": 0}
    names = ("broadcast", "all_reduce", "all_gather", "reduce_scatter_tensor", "all_to_all_single")
    real = {name: getattr(dist, name) for name in names}
    for name, fn in real.items():

        def counted(*args, _fn=fn, **kw):
            tally["calls"] += 1
            t = args[1] if _fn.__name__ in ("all_gather", "reduce_scatter_tensor") else args[0]
            t = t[0] if isinstance(t, list) else t
            tally["bytes"] += t.numel() * t.element_size()
            return _fn(*args, **kw)

        setattr(dist, name, counted)

    def restore():
        for name, fn in real.items():
            setattr(dist, name, fn)
    return tally, restore


def _bcast_obj(dist, obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _tree_bytes_cfg(cfg) -> int:
    """The whole latent f32 tree's bytes."""
    return 4 * cfg.param_count()


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
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-worker":  # one rank of the 4-rank world
        sys.exit(mesh_worker(Path(sys.argv[2]), sys.argv[3].split(",")))
    if sys.argv[1:] == ["--mesh-train-m1"]:  # (MT1), in its own process
        sys.exit(mesh_train_m1_main())
    if sys.argv[1:] == ["--mesh-family-m1"]:  # (MF1), in its own process
        sys.exit(mesh_family_m1_main())
    if sys.argv[1:] in (["--only-mesh-train"], ["--only-moe-mesh"], ["--only-disagg-mesh"],
                        ["--only-spec-mesh"], ["--only-family-mesh"]):  # for development
        sys.exit(main(only=sys.argv[1][len("--only-"):]))
    sys.exit(main())
