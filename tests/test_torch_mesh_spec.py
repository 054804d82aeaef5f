"""Chunked prefill, speculative decoding and the swap policies on a mesh of
processes: ``EngineCore(mesh=)`` on a (data 2, model 2) world of 4 gloo
ranks on the CPU, held to live JAX engines and to the port's own engine on
one device.

One world is started for the module (each rank a process running this
file, its store in a file under the test's temporary directory) and runs
every case in turn; rank 0 writes what each case found, and also serves
each case on one device.  Meanwhile the test process runs the JAX
``EngineCore`` without a mesh on the same weights and requests (the JAX
engine does not serve a one-prompt prefill on (data 2, model 2), ROADMAP
C), so each case is held to it token for token, with its drafts, accepted
tokens, verify rounds and chunks.  The model, weights and engine shape are
``tests/test_torch_mesh.py``'s: reduced bitnet-730m (2 layers, 4 heads of
32, vocab 256) on ``numpy_params``, 2 slots, max_len 64 (two sequence
halves of 32 rows), 8-token pages.

The speculative cases' prompts tile short patterns, so that prompt lookup
drafts; two of them run past row 32, so verify blocks straddle the two
sequence halves.  The swap-aware policy decides from measured times: there
the ranks' decisions are held to rank 0's and the tokens to JAX's.  The
SLO-aware case plants a shed on rank 0's clock only (a queued request
back-dated on rank 0 after the first step): every rank must drop it.

The unit tests below need no world: a verify block and a chunk straddling
the boundary of two sequence halves, each half's rows written by the mesh
writers, against the whole cache.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import argparse
import os
import pickle
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_mesh as TM

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
MAX_NEW = 8
PAGED8 = dict(cache_layout="paged", kv_dtype="int8")
HUGE_SLO = dict(ttft_target_s=1e6, itl_target_s=1e6)  # no decision reads a clock
SHED_BACKDATE_S = 1e7  # the planted shed: past any TTFT target here
# case -> (engine options, how the requests go): "spec" the tiled prompts,
# "shared" TM's prompts behind a two-page prefix, "shed" the SLO plant
CASES = {
    "chunked-fp": (dict(prefill_chunk=8), ""),
    "chunked-paged-int8": (dict(PAGED8, prefill_chunk=8), ""),
    "chunked-paged-int8-shared": (dict(PAGED8, prefill_chunk=8), "shared"),
    "spec-fp": (dict(spec_decode=2), "spec"),
    "spec-int8": (dict(kv_dtype="int8", spec_decode=2), "spec"),
    "spec-paged-int8": (dict(PAGED8, spec_decode=2), "spec"),
    "spec-chunked-paged-int8": (dict(PAGED8, spec_decode=2, prefill_chunk=8), "spec"),
    "spec-preempting": (dict(PAGED8, spec_decode=2, num_blocks=5), "spec"),
    "swap-aware": (dict(swap_policy="swap-aware", prefill_chunk=8), ""),
    "slo-shed": (dict(prefill_chunk=8), "shed"),
}
COUNTERS = ("draft_tokens", "accepted_tokens", "verify_rounds", "prefill_chunks",
            "preemptions", "sheds", "decode_tokens")


def spec_prompts():
    """Prompts that prompt lookup drafts from: two tile a short pattern
    (the 26-token one past row 32 within 8 tokens), two do not."""
    rng = np.random.default_rng(7)
    return [np.tile(rng.integers(0, 256, 4), 5).astype(np.int32),
            rng.integers(0, 256, 9).astype(np.int32),
            np.tile(rng.integers(0, 256, 3), 9)[:26].astype(np.int32),
            rng.integers(0, 256, 30).astype(np.int32)]


def case_prompts(how):
    return spec_prompts() if how == "spec" else TM.engine_prompts(how == "shared")


def policy(kw, how, slo_mod):
    """The case's swap policy: the SLO-aware one at targets no run reaches
    (its decisions then follow host state alone, so one device and JAX
    make the same ones) for the shed plant."""
    if how != "shed":
        return kw.get("swap_policy")
    return slo_mod.SLOAwareSwapPolicy(slo_mod.SLOConfig(**HUGE_SLO))


def serve(eng, case, request_cls, sampling_cls, slo_mod, *, lead=True):
    """Submit the case's requests and run them to the end (rank 0, or an
    engine with no mesh; the other ranks follow).  "shed": after the first
    step the last request, still queued, is back-dated on this process's
    copy only.  Returns (streams, counters)."""
    if not lead:
        eng.follow()
        return None
    _, how = CASES[case]
    reqs = [request_cls(f"r{i}", p, max_new=MAX_NEW, params=sampling_cls())
            for i, p in enumerate(case_prompts(how))]
    for r in reqs:
        eng.submit(r)
    if how == "shed":
        eng.step()
        reqs[-1].arrival_time_s -= SHED_BACKDATE_S
    eng.run()
    if getattr(eng, "mesh", None) is not None:
        eng.stop_followers()
    streams = {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}
    return streams, {k: int(getattr(eng.stats, k)) for k in COUNTERS}


# ---------------------------------------------------------------- the ranks --


def _engine(cfg, params, mesh, case):
    from repro_torch.serving import EngineCore, slo

    kw, how = CASES[case]
    kw = dict(kw, swap_policy=policy(kw, how, slo))
    return EngineCore(cfg, params, device="cpu", mesh=mesh, **TM.ENGINE_BASE, **kw)


def case_engine(ctx, case):
    """One case on the mesh; rank 0 also serves it on one device."""
    from repro_torch.serving import Request, SamplingParams, slo

    cfg, params, mesh = ctx["cfg"], ctx["params"], ctx["mesh"]
    eng = _engine(cfg, params, mesh, case)
    got = serve(eng, case, Request, SamplingParams, slo, lead=mesh.rank == 0)
    ref = None
    if mesh.rank == 0:
        ref = serve(_engine(cfg, params, None, case), case, Request, SamplingParams, slo)
    return {"got": got, "ref": ref, "snapshot": TM.decisions(eng.snapshot()),
            "decisions": list(eng.decisions), "exchange_bytes": eng.runner.engine.exchange_bytes}


def case_chunk_install(ctx, kv_dtype):
    """The mesh chunk program on a 16-token chunk at rows [24, 40) of slot
    1, which straddle the two sequence halves: this rank's block of the
    cache after it, and the one-device program's whole cache."""
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.layers.attention import KVCache
    from repro_torch.quant.kv_quant import QuantKV

    cfg, params, mesh = ctx["cfg"], ctx["params"], ctx["mesh"]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 40))).long()

    def run(m):
        eng = PhaseEngine(cfg, m, kv_dtype=kv_dtype)
        p = params if m is None else shard_params(params, cfg, m)
        cache = eng.init_cache(2, 64, device="cpu")
        heads = cfg.num_kv_heads // eng.prefill_ctx.tp_size
        shape = (cfg.num_layers, 1, heads, 64, cfg.head_dim)
        prefix = KVCache(torch.zeros(shape), torch.zeros(shape))
        for start, c in ((0, 24), (24, 16)):  # the second chunk straddles row 32
            prog = eng.prefill_chunk_program(c, 2, 64, 0 if start == 0 else 32)
            logits, _, _ = prog(p, tokens[:, start:start + c], cache, prefix,
                                torch.tensor(1, dtype=torch.int32),
                                torch.tensor(start, dtype=torch.int32),
                                torch.tensor(c - 1, dtype=torch.int32))
        out = {}
        for name, leaf in zip("kv", cache):
            out[name] = ({"q": leaf.q.numpy(), "scale": leaf.scale.numpy()}
                         if isinstance(leaf, QuantKV) else leaf.float().numpy())
        return out, logits.numpy(), eng.decode_ctx

    block, logits, ctx = run(mesh)
    rows = (ctx.local_range(2, "batch")[0], ctx.local_range(64, "kv_seq")[0])
    return {"block": block, "logits": logits, "rows": rows,
            "whole": run(None)[:2] if mesh.rank == 0 else None}


def _cases():
    cases = [(f"engine-{c}", lambda ctx, c=c: case_engine(ctx, c)) for c in CASES]
    cases += [(f"chunk-install-{d}", lambda ctx, d=d: case_chunk_install(ctx, d))
              for d in ("fp", "int8", "int4")]
    return cases


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the world: join, build the (2, 2) mesh, run every case,
    gather each case's result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    mesh = make_host_mesh(data=2, model=2)
    cfg = reduced_config("bitnet-730m")
    ctx = {"mesh": mesh, "cfg": cfg, "params": TM._port_params(cfg)}
    results = {}
    for name, fn in _cases():
        t0 = time.perf_counter()
        try:
            got = ("ok", fn(ctx))
        except Exception:  # noqa: BLE001 — the failing test prints it
            got = ("error", traceback.format_exc())
        every = [None] * world
        dist.all_gather_object(every, got)
        results[name] = every
        results[f"{name}:seconds"] = time.perf_counter() - t0
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)  # no gloo teardown: under load one rank's raced its peer's


# ------------------------------------------------------------ the JAX side --


def _jax_case(case):
    import repro.configs as jcfgs
    from repro.serving import EngineCore as JEngineCore
    from repro.serving import Request as JRequest
    from repro.serving import SamplingParams as JSamplingParams
    from repro.serving import slo as jslo

    cfg = jcfgs.reduced_config("bitnet-730m")
    kw, how = CASES[case]
    kw = dict(kw, swap_policy=policy(kw, how, jslo))
    eng = JEngineCore(cfg, TM.jax_params(cfg, TM.numpy_params(cfg)), **TM.ENGINE_BASE, **kw)
    return serve(eng, case, JRequest, JSamplingParams, jslo)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks, run the JAX engines meanwhile, collect both."""
    tmp = tmp_path_factory.mktemp("mesh_spec")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp / "ranks.pkl"
    ranks = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
                               "--store", str(tmp / "store"), "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = {}

    def drain(name, proc):  # keep the pipes from filling
        logs[name] = proc.communicate(timeout=400)[0]

    threads = [threading.Thread(target=drain, args=(f"rank{r}", p)) for r, p in enumerate(ranks)]
    for t in threads:
        t.start()
    jax_runs = {c: _jax_case(c) for c in CASES}
    for t in threads:
        t.join()
    codes = [p.returncode for p in ranks]
    assert codes == [0] * WORLD, "\n".join(f"--- {k}:\n{v[-4000:]}" for k, v in logs.items())
    with open(out, "rb") as f:
        return {"ranks": pickle.load(f), "jax": jax_runs}


def _case(world, name):
    every = world["ranks"][name]
    for r, (status, got) in enumerate(every):
        assert status == "ok", f"rank {r}, case {name}:\n{got}"
    return [got for _, got in every]


# --------------------------------------------------------------- the world --


@pytest.mark.parametrize("case", [c for c in CASES if c not in ("swap-aware",)])
def test_mesh_engine_gives_the_jax_tokens_and_counts(world, case):
    """Rank 0's streams equal the JAX engine's and the port's on one
    device, token for token, and so do the drafts, accepted tokens, verify
    rounds, chunks, preemptions and sheds; every rank's host decisions
    (the snapshot without its times, the policy's decisions) are rank 0's."""
    every = _case(world, f"engine-{case}")
    streams, counts = every[0]["got"]
    want_streams, want_counts = world["jax"][case]
    assert streams == want_streams
    assert counts == want_counts
    assert every[0]["ref"] == (want_streams, want_counts)
    for r in range(1, WORLD):
        assert every[r]["snapshot"] == every[0]["snapshot"], f"rank {r}"
        assert every[r]["decisions"] == every[0]["decisions"], f"rank {r}"
    _, how = CASES[case]
    kw = CASES[case][0]
    if how == "spec":
        assert counts["verify_rounds"] > 0 and counts["accepted_tokens"] > 0
    if "prefill_chunk" in kw:
        assert counts["prefill_chunks"] > len(streams)  # a prompt in several chunks
        assert every[0]["exchange_bytes"] > 0  # each chunk's heads gathered
    if case == "spec-preempting":
        assert counts["preemptions"] > 0
    if how == "shed":
        assert counts["sheds"] == 1 and streams["r3"] == []
        assert ("shed", True) in every[0]["decisions"]
    if how == "shared":
        assert every[0]["snapshot"]["prefix_hits"] > 0


def test_swap_aware_on_a_mesh_follows_rank_0(world):
    """The swap-cost-aware policy decides from measured times: rank 0's
    decisions reach every rank (each rank's list is rank 0's, and so is
    its snapshot), and the streams are JAX's and one device's."""
    every = _case(world, "engine-swap-aware")
    streams, counts = every[0]["got"]
    assert streams == world["jax"]["swap-aware"][0] == every[0]["ref"][0]
    kinds = {k for k, _ in every[0]["decisions"]}
    assert {"prefill", "quanta"} <= kinds
    for r in range(1, WORLD):
        assert every[r]["decisions"] == every[0]["decisions"], f"rank {r}"
        assert every[r]["snapshot"] == every[0]["snapshot"], f"rank {r}"
        assert every[r]["got"] is None


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_mesh_chunk_program_installs_the_straddling_rows_bit_for_bit(world, kv_dtype):
    """A 16-token chunk at rows [24, 40) of slot 1 (across the two
    sequence halves of 32 rows): each rank's block of the cache after the
    mesh chunk program equals that block of the one-device program's cache
    bit for bit (int8 / int4 payloads and scale planes included), and the
    chunk's logits are the same."""
    every = _case(world, f"chunk-install-{kv_dtype}")
    whole, logits = every[0]["whole"]
    for r, got in enumerate(every):
        b_lo, s_lo = got["rows"]
        for name in "kv":
            mine, ref = got["block"][name], whole[name]
            if kv_dtype == "fp":
                np.testing.assert_array_equal(mine, ref[b_lo:b_lo + 1, :, :, s_lo:s_lo + 32])
            else:
                for part in ("q", "scale"):
                    np.testing.assert_array_equal(
                        mine[part], ref[part][b_lo:b_lo + 1, :, :, s_lo:s_lo + 32])
        np.testing.assert_allclose(got["logits"], logits, atol=1e-4, rtol=0)
    # the rows crossed the boundary: slot 1's rows 24-31 on the first half, 32-39 on the second
    assert all(np.abs(every[r]["block"]["k"]["q"] if kv_dtype != "fp"
                      else every[r]["block"]["k"]).sum() > 0
               for r in range(WORLD) if every[r]["rows"][0] == 1)


# --------------------------------------------------- one process, no world --


def _verify_case(kv_dtype):
    """A one-layer cache of 3 slots x 16 rows (two sequence halves of 8),
    random: slot 0 at length 6 with a block of 5 rows (rows 6-10, across
    the boundary), slot 1 at length 0 with 3 rows of 5, slot 2 at length 13
    sitting the round out."""
    from repro_torch.layers.attention import KVCache
    from repro_torch.quant.kv_quant import QuantKV, quantize_kv

    rng = np.random.default_rng(9)
    b, hkv, s, d, w = 3, 2, 16, 8, 5
    lengths = torch.tensor([6, 0, 13], dtype=torch.int32)
    n_tokens = torch.tensor([5, 3, 0], dtype=torch.int32)  # slot 2 sits the round out

    def leaf():
        x = torch.from_numpy(rng.normal(size=(b, 1, hkv, s, d)).astype(np.float32))
        if kv_dtype == "fp":
            return x
        q, sc = quantize_kv(x, kv_dtype)
        return QuantKV(q, sc)

    cache = KVCache(leaf(), leaf())
    new = [torch.from_numpy(rng.normal(size=(1, b, hkv, w, d)).astype(np.float32))
           for _ in range(2)]
    q = torch.from_numpy(rng.normal(size=(b * w, 2 * hkv, d)).astype(np.float32))
    return cache, new, q, lengths, n_tokens, s, w


def _clone(leaf):
    from repro_torch.quant.kv_quant import QuantKV

    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q.clone(), leaf.scale.clone())
    return leaf.clone()


def _half(leaf, r, sl):
    from repro_torch.quant.kv_quant import QuantKV

    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, :, :, r * sl:(r + 1) * sl].clone(),
                       leaf.scale[:, :, :, r * sl:(r + 1) * sl].clone())
    return leaf[:, :, :, r * sl:(r + 1) * sl].clone()


def _planes(leaf):
    from repro_torch.quant.kv_quant import QuantKV

    return (leaf.q, leaf.scale) if isinstance(leaf, QuantKV) else (leaf,)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_verify_block_straddling_the_halves_writes_and_merges_as_one(kv_dtype):
    """A verify block across the boundary of two sequence halves: each
    half, written by the mesh verify's row writer, holds exactly its rows
    of the one-device write (bit for bit), nothing past ``n_tokens`` nor on
    a slot sitting out is written, and the two halves' walks with the
    local per-row lengths, merged, equal the whole walk within 1e-6."""
    from repro_torch.layers.attention import combine_partials, verify_plan, write_verify_rows_q

    cache, new, q, lengths, n_tokens, s, w = _verify_case(kv_dtype)
    sl = s // 2
    whole = [_clone(x) for x in cache]
    plan = verify_plan(lengths, n_tokens, w, smax=s)
    for leaf, t in zip(whole, new):
        write_verify_rows_q(leaf, t, plan.targets)
    want = _walk(q, whole, plan.walk, w)
    parts = []
    for r in range(2):
        half = [_half(x, r, sl) for x in cache]
        hplan = verify_plan(lengths, n_tokens, w, smax=s, seq_shard=(r, sl, None))
        for leaf, t in zip(half, new):
            write_verify_rows_q(leaf, t, hplan.targets)
        for got, ref in zip(half, whole):  # exactly its rows of the one-device write
            for a, b in zip(_planes(got), _planes(ref)):
                assert torch.equal(a, b[:, :, :, r * sl:(r + 1) * sl]), r
        parts.append(_walk(q, half, hplan.walk, w))
    out, l, m = combine_partials(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    torch.testing.assert_close(out, want[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l, want[1], atol=1e-6, rtol=1e-6)
    # rows past n_tokens and slot 2's rows were not written anywhere
    for got, ref in zip(whole, cache):
        for a, b in zip(_planes(got), _planes(ref)):
            assert torch.equal(a[0, :, :, 11:], b[0, :, :, 11:])
            assert torch.equal(a[1, :, :, 3:], b[1, :, :, 3:])
            assert torch.equal(a[2], b[2])


def _walk(q, kv, walk, w):
    """The verify walk (the decode kernel's plain version, ``rows_per_slot``
    w) of q over the one-layer cache ``kv``: (out, l, m)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.layers.attention import _kv_leaf_args, _layer0

    k, v, kw = _kv_leaf_args(_layer0(kv[0]), _layer0(kv[1]))
    return decode_attention(q, k, v, walk, return_stats=True, rows_per_slot=w, **kw)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_chunk_rows_writer_places_a_straddling_chunk_bit_for_bit(kv_dtype):
    """The mesh chunk programs' writer (``PhaseEngine._chunk_rows_writer``)
    on each rank of a (data 2, model 2) mesh, seen from each coordinate: a
    chunk at rows [28, 44) of slot 3 of a (4, L, Hkv, 64, D) cache, the
    slot and start as 0-d device tensors; every rank's block equals its
    block of the one-device install bit for bit, payloads and scales, and
    the blocks of the other data rank and the other slots are unchanged."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.layers.attention import write_chunk_kv_q
    from repro_torch.models import transformer as T

    cfg = reduced_config("bitnet-730m")
    rng = np.random.default_rng(12)
    kv = torch.from_numpy(rng.normal(size=(cfg.num_layers, 1, cfg.num_kv_heads, 16,
                                           cfg.head_dim)).astype(np.float32))
    whole = T.init_cache(cfg, 4, 64, kv_dtype=kv_dtype, device="cpu").k
    before = _clone(whole)
    write_chunk_kv_q(whole, kv, 3, 28)
    for d in range(2):
        for m in range(2):
            eng = PhaseEngine(cfg, TM._StubMesh({"data": d, "model": m}), kv_dtype=kv_dtype)
            block = eng.init_cache(4, 64, device="cpu").k
            write = eng._chunk_rows_writer(4)
            write(block, kv, torch.tensor(3, dtype=torch.int32),
                  torch.tensor(28, dtype=torch.int32))
            for got, ref, old in zip(_planes(block), _planes(whole), _planes(before)):
                want = ref[2 * d:2 * d + 2, :, :, 32 * m:32 * m + 32]
                assert torch.equal(got, want), (d, m)
                if d == 0:  # slot 3 is the other data rank's: nothing written
                    assert torch.equal(got, old[0:2, :, :, 32 * m:32 * m + 32])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the mesh speculation tests' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
