"""Serving on a mesh of processes: the port against the JAX package's mesh
programs and against its own single-device engine, on the CPU over gloo.

A (data=2, model=2) world of 4 ranks is started once for the module (each
rank a process running this file, its store in a file under the test's
temporary directory) and runs every multi-rank case in turn; rank 0 writes
what each case found, and each test below reads its case.  Beside it the
JAX reference runs once, in a subprocess with 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on a
``jax.sharding.Mesh`` built with Auto axes: prefill -> relayout -> 3
decode steps of reduced deepseek-7b and bitnet-730m, unsharded and on the
mesh.  Where a JAX mesh program does not run under the installed jax, the
port is held to the JAX program without a mesh instead (which is what the
JAX package's own mesh test asserts its mesh program equals); the
subprocess records which it ran, and
``test_mesh_prefill_relayout_decode_tokens_match_jax`` asserts that the
JAX mesh tokens equal the JAX unsharded ones wherever the mesh ran.

The live JAX engines run in this process on its single CPU device while
the ranks work.  Float work on the ranks is f32 with TF32 off; integer
and layout work (packed weights, int8 activations, TLMM accumulators,
int8/int4 KV payloads and scale planes) is compared bit for bit.
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
from launcher import run_launcher

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
B, P, MAXLEN = 4, 8, 32  # the JAX mesh test's shapes: 4 prompts of 8 tokens, max_len 32
STEPS = 3
ARCHS = ("bitnet-730m", "smollm-135m", "deepseek-7b", "qwen2.5-14b", "minicpm-2b",
         "chameleon-34b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
PROMPT_LENS = (5, 17, 9, 30)
MAX_NEW = 6
ENGINE_BASE = dict(n_slots=2, max_len=64, prompt_len=16, block_size=8)
# EngineCore(mesh=) cases: the engine's options, and whether the odd
# requests are sampled or the prompts share a 16-token (two-page) prefix
ENGINE_CASES = {
    "contiguous-fp": (dict(), ""),
    "contiguous-int8": (dict(kv_dtype="int8"), ""),
    "paged-fp": (dict(cache_layout="paged"), ""),
    "paged-int8": (dict(cache_layout="paged", kv_dtype="int8"), ""),
    "contiguous-int4": (dict(kv_dtype="int4"), ""),
    "static": (dict(mode="static"), ""),
    "serialized-swap": (dict(overlap=False), ""),
    "sampled": (dict(), "sampled"),
    "shared-prefix-paged-int8": (dict(cache_layout="paged", kv_dtype="int8"), "shared"),
}
KV_DTYPES = ("fp", "int8", "int4")


# ------------------------------------------------------------ shared data --


def numpy_params(cfg, seed=0):
    """Latent f32 weights in the JAX package's tree layout (layer-stacked)."""
    rng = np.random.default_rng(seed)
    L, d, h, hkv, hd, f = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff)

    def lin(k, n):
        return {"w": (rng.normal(size=(L, k, n)) * k**-0.5).astype(np.float32)}

    def norm(*shape):
        return {"scale": (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)}

    tree = {
        "emb": (rng.normal(size=(cfg.padded_vocab(), d)) * 0.02).astype(np.float32),
        "layers": {
            "attn": {"wq": lin(d, h * hd), "wk": lin(d, hkv * hd), "wv": lin(d, hkv * hd),
                     "wo": lin(h * hd, d)},
            "ln1": norm(L, d), "ln2": norm(L, d),
            "mlp": {"w_gate": lin(d, f), "w_up": lin(d, f), "w_down": lin(f, d)},
        },
        "ln_f": norm(d),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (rng.normal(size=(d, cfg.padded_vocab())) * 0.02).astype(np.float32)
    return tree


def prompt_tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


def engine_prompts(shared: bool):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in PROMPT_LENS]
    if shared:  # every prompt opens with the same two 8-token pages
        prefix = rng.integers(0, 256, size=16).astype(np.int32)
        prompts = [np.concatenate([prefix, p]) for p in prompts]
    return prompts


def sampled(i, mod):
    """The sampled case: the odd requests draw, the even ones are greedy."""
    if i % 2 == 0:
        return mod()
    return mod(temperature=0.8, top_k=64, top_p=0.95, seed=100 + i)


def decisions(tree):
    """A snapshot with every float (times, rates) taken out: what the
    ranks' host decisions must make equal."""
    if isinstance(tree, dict):
        return {k: decisions(v) for k, v in tree.items() if not isinstance(v, float)}
    if isinstance(tree, (list, tuple)):
        return [decisions(v) for v in tree if not isinstance(v, float)]
    return tree


def random_kv(cfg, seed=5):
    """Prefill KV (L, B, Hkv, P, D) f32 for the relayout cases."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, P, cfg.head_dim)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------- the ranks --


def _port_params(cfg, device="cpu"):
    from repro_torch.interop import params_from_numpy

    return params_from_numpy(numpy_params(cfg), cfg, device=device)


def _roll(cfg, params, mesh, *, kv_dtype="fp", long_context=False):
    """prefill -> relayout -> STEPS greedy decode steps of the B prompts
    through the port's phase programs (one prompt a prefill and relayout,
    as the engine installs them): the tokens (STEPS + 1, B)."""
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.launch.sharding_rules import shard_params

    eng = PhaseEngine(cfg, mesh, kv_dtype=kv_dtype, long_context=long_context)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    cache = eng.init_cache(B, MAXLEN, device="cpu")
    tokens = torch.from_numpy(prompt_tokens(cfg)).long()
    first = []
    for i in range(B):
        logits, kv = eng.prefill_program_varlen(1, P)(params, tokens[i:i + 1], P - 1)
        eng.relayout_program(1, P, MAXLEN)(kv, cache, i)
        first.append(int(torch.argmax(logits[0])))
    tok = torch.tensor(first)
    outs = [tok.numpy()]
    lengths = torch.full((B,), P, dtype=torch.int32)
    dec = eng.decode_program(B, MAXLEN)
    for i in range(STEPS):
        logits, cache = dec(params, tok, cache, lengths + i)
        tok = torch.argmax(logits, dim=-1)
        outs.append(tok.numpy())
    return np.stack(outs)


def _engine_run(cfg, params, mesh, case):
    from repro_torch.serving import EngineCore, Request, SamplingParams

    kw, how = ENGINE_CASES[case]
    eng = EngineCore(cfg, params, device="cpu", mesh=mesh, **ENGINE_BASE, **kw)
    if mesh is not None and mesh.rank != 0:
        eng.follow()
    else:
        for i, p in enumerate(engine_prompts(how == "shared")):
            sp = sampled(i, SamplingParams) if how == "sampled" else SamplingParams()
            eng.submit(Request(f"r{i}", p, max_new=MAX_NEW, params=sp))
        eng.run()
        if mesh is not None:
            eng.stop_followers()
    return ({k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())},
            decisions(eng.snapshot()), eng.stats.prefix_hits, eng.kv_bytes()["allocated"])


def case_engine(ctx, case):
    """One EngineCore(mesh=) case; rank 0 also runs the port's engine
    without a mesh."""
    cfg, params, mesh = ctx["cfg"], ctx["params"], ctx["mesh"]
    got = _engine_run(cfg, params, mesh, case)
    ref = _engine_run(cfg, params, None, case) if mesh.rank == 0 else None
    return {"streams": got[0], "snapshot": got[1], "prefix_hits": got[2], "kv_bytes": got[3],
            "ref": ref}


def case_engine_slice(ctx):
    """The contiguous-fp case on a slice each rank cut beforehand
    (``shard_params``), the whole tree dropped before the engine is built."""
    from repro_torch.launch.sharding_rules import shard_params

    cfg, mesh = ctx["cfg"], ctx["mesh"]
    local = shard_params(_port_params(cfg), cfg, mesh)
    streams, snap, _, kv = _engine_run(cfg, local, mesh, "contiguous-fp")
    return {"streams": streams, "snapshot": snap, "kv_bytes": kv}


def case_roll(ctx, arch):
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    params = _port_params(cfg)
    got = _roll(cfg, params, ctx["mesh"])
    return {"tokens": got, "unsharded": _roll(cfg, params, None) if ctx["mesh"].rank == 0 else None}


def case_long_context(ctx):
    """LONG_DECODE_RULES: the batch whole on every rank, the KV sequence
    over data x model (four shards of 8 rows), the same walk and merge."""
    cfg, mesh = ctx["cfg"], ctx["mesh"]
    return {"tokens": _roll(cfg, ctx["params"], mesh, long_context=True),
            "unsharded": _roll(cfg, ctx["params"], None) if mesh.rank == 0 else None}


def case_relayout(ctx, kv_dtype):
    """The exchange's placement: the same f32 prefill KV, this rank's heads
    of it, through the mesh's relayout; this rank's block of the cache and
    where it lies in the whole cache."""
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.layers.attention import KVCache
    from repro_torch.quant.kv_quant import QuantKV

    cfg, mesh = ctx["cfg"], ctx["mesh"]
    eng = PhaseEngine(cfg, mesh, kv_dtype=kv_dtype)
    cache = eng.init_cache(B, MAXLEN, device="cpu")
    k, v = random_kv(cfg)
    h_lo, h_hi = eng.prefill_ctx.local_range(cfg.num_kv_heads, "kv_heads")
    for i in range(B):
        kv = KVCache(*(torch.from_numpy(a[:, i:i + 1, h_lo:h_hi].copy()) for a in (k, v)))
        eng.relayout_program(1, P, MAXLEN)(kv, cache, i)
    b_lo, b_hi = eng.decode_ctx.local_range(B, "batch")
    s_lo, s_hi = eng.decode_ctx.local_range(MAXLEN, "kv_seq")

    def leaf(x):
        if isinstance(x, QuantKV):
            return {"q": x.q.numpy(), "scale": x.scale.numpy()}
        return x.float().numpy()

    return {"k": leaf(cache.k), "v": leaf(cache.v), "rows": (b_lo, b_hi, s_lo, s_hi),
            "exchange_bytes": eng.exchange_bytes}


def case_row_parallel(ctx):
    """A row-parallel packed linear over the model axis, bit for bit with
    the unsharded one: the int8 activations (the whole row's scale, an
    all-zero row, a row whose absmax lies on the other rank's half) and
    the f32 output."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels.tlmm.ops import tlmm_matmul
    from repro_torch.layers.linear import linear_apply_row_parallel
    from repro_torch.quant.act_quant import quantize_and_fold
    from repro_torch.quant.ternary import TernaryWeight, quantize_and_pack

    mesh = ctx["mesh"]
    m = mesh.coordinate("model")
    rng = np.random.default_rng(3)
    k, n = 256, 96
    w = quantize_and_pack(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32)).to(dt)
        x[1] = 0
        x[2, 7] = 40.0  # the absmax on model rank 0's half
        x[3, k - 3] = -50.0  # ... on rank 1's
        half = k // 2
        w_loc = TernaryWeight(w.packed[m * half // 4:(m + 1) * half // 4].contiguous(), w.scale)
        x_loc = x[:, m * half:(m + 1) * half]
        y = linear_apply_row_parallel({"w": w_loc}, x_loc, QuantConfig(mode="ternary"),
                                      mesh.group("model"))
        want = tlmm_matmul(x, w)
        absmax = x.float().abs().amax(-1, keepdim=True)
        aug = torch.cat([x_loc, absmax.to(dt), torch.zeros((5, 3), dtype=dt)], -1)
        xq_loc, s_loc = quantize_and_fold(aug, w.scale)
        xq, s = quantize_and_fold(x, w.scale)
        out[str(dt)] = {"y_equal": torch.equal(y, want),
                        "x_q_equal": torch.equal(xq_loc[:, :half], xq[:, m * half:(m + 1) * half]),
                        "scale_equal": torch.equal(s_loc, s)}
    return out


def case_collectives(ctx):
    """Each helper in both forms on each group: the portable form (gloo's
    broadcasts) must give the native collective's bits."""
    from repro_torch.layers import collectives as C

    mesh = ctx["mesh"]
    rank = mesh.rank
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1) - 0.5 * rank
    out = {"form": C.form(mesh.group("model"))}
    for name, group in (("model", mesh.group("model")), ("data", mesh.group("data")),
                        ("world", mesh.group(("data", "model")))):
        g = {how: C.all_gather(x, group, dim=1, how=how) for how in ("native", "portable")}
        a = {how: C.all_to_all(x, group, split_dim=0, cat_dim=1, how=how)
             for how in ("native", "portable")}
        out[name] = {"all_gather": torch.equal(g["native"], g["portable"]),
                     "all_to_all": torch.equal(a["native"], a["portable"]),
                     "gather_shape": tuple(g["native"].shape),
                     "sum": C.all_reduce(x, group).tolist(),
                     "max": C.all_reduce(x, group, op="max").tolist(),
                     "broadcast": C.broadcast(x.clone(), group, src=1).tolist()}
    # PartitionCtx.shard on a (4, 8, 6) tensor whose dim 1 (heads) is over
    # the model axis: to the sequence (an all-to-all), to nothing (a
    # gather), and back from nothing (a slice)
    from repro_torch.core.phase_engine import make_pctx

    pctx = make_pctx(mesh, "prefill")
    whole = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    m = mesh.coordinate("model")
    mine = whole[:, 4 * m:4 * (m + 1)]
    heads = ("seq", "heads", None)
    out["shard"] = {
        "to_seq": torch.equal(pctx.shard(mine, ("kv_seq", "heads", None), ("kv_seq", None, "heads"),
                                         whole.shape), whole[:, :, 3 * m:3 * (m + 1)]),
        "gather": torch.equal(pctx.shard(mine, heads, ("seq", None, None), whole.shape), whole),
        "slice": torch.equal(pctx.shard(whole, ("seq", None, None), heads, whole.shape), mine)}
    return out


def case_production_mesh(ctx):
    from repro_torch.launch.mesh import make_production_mesh

    try:
        make_production_mesh()
    except ValueError as e:
        return str(e)
    return None


def _cases():
    cases = [("collectives", case_collectives), ("row_parallel", case_row_parallel),
             ("production_mesh", case_production_mesh), ("long_context", case_long_context)]
    cases += [(f"relayout-{d}", lambda ctx, d=d: case_relayout(ctx, d)) for d in KV_DTYPES]
    cases += [(f"roll-{a}", lambda ctx, a=a: case_roll(ctx, a))
              for a in ("deepseek-7b", "bitnet-730m")]
    cases += [(f"engine-{c}", lambda ctx, c=c: case_engine(ctx, c)) for c in ENGINE_CASES]
    cases.append(("engine-slice", case_engine_slice))
    return cases


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the test world: join, build the (2, 2) mesh, run every
    case, gather each case's result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=60)
    mesh = make_host_mesh(data=2, model=2)
    cfg = reduced_config("bitnet-730m")
    ctx = {"mesh": mesh, "cfg": cfg, "params": _port_params(cfg)}
    results = {"describe": [None] * world}
    dist.all_gather_object(results["describe"], mesh.describe())
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
    dist.destroy_process_group()


# ------------------------------------------------------------ the JAX side --

JAX_MESH_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
import test_torch_mesh as M
from repro.configs import reduced_config
from repro.core.phase_engine import PhaseEngine

def roll(cfg, params, mesh):
    eng = PhaseEngine(cfg, mesh, max_len=M.MAXLEN)
    pa = jax.eval_shape(lambda: params)
    tokens = jnp.asarray(M.prompt_tokens(cfg))
    logits, kv = eng.prefill_program(pa, M.B, M.P).fn(params, tokens)
    cache = eng.relayout_program(M.B, M.P, M.MAXLEN).fn(kv)
    dec = eng.decode_program(pa, M.B, M.MAXLEN)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = [tok]
    lengths = jnp.full((M.B,), M.P, jnp.int32)
    for i in range(M.STEPS):
        lg, cache = dec.fn(params, tok, cache, lengths + i)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        outs.append(tok)
    return np.stack([np.asarray(t) for t in outs])

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {{}}
for arch in ("deepseek-7b", "bitnet-730m"):
    cfg = reduced_config(arch)
    params = M.jax_params(cfg, M.numpy_params(cfg))
    ref = roll(cfg, params, None)
    try:
        got, ran = roll(cfg, params, mesh), "mesh"
    except Exception as e:
        got, ran = None, f"{{type(e).__name__}}: {{str(e).splitlines()[0][:200]}}"
    out[arch] = {{"unsharded": ref, "mesh": got, "ran": ran}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def jax_params(cfg, tree):
    """JAX params from a numpy tree, every linear of a ternary config
    packed by ``jax.vmap(quantize_and_pack)``."""
    import jax
    import jax.numpy as jnp

    from repro.quant.ternary import quantize_and_pack

    out = jax.tree.map(jnp.asarray, tree)
    if cfg.quant.ternary:
        for g, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w_gate", "w_up", "w_down"))):
            for n in names:
                out["layers"][g][n]["w"] = jax.vmap(quantize_and_pack)(out["layers"][g][n]["w"])
    return out


def _jax_engine_streams(case):
    import repro.configs as jcfgs
    from repro.serving import EngineCore as JEngineCore
    from repro.serving import Request as JRequest
    from repro.serving import SamplingParams as JSamplingParams

    cfg = jcfgs.reduced_config("bitnet-730m")
    params = jax_params(cfg, numpy_params(cfg))
    kw, how = ENGINE_CASES[case]
    eng = JEngineCore(cfg, params, **ENGINE_BASE, **kw)
    for i, p in enumerate(engine_prompts(how == "shared")):
        sp = sampled(i, JSamplingParams) if how == "sampled" else JSamplingParams()
        eng.submit(JRequest(f"r{i}", p, max_new=MAX_NEW, params=sp))
    eng.run()
    return {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks and the JAX mesh subprocess, compute the live JAX
    engines' streams meanwhile, and collect everything."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp / "ranks.pkl"
    ranks = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
                               "--store", str(tmp / "store"), "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    jax_out = tmp / "jax.pkl"
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_MESH_SCRIPT.format(tests=str(REPO / "tests"), out=str(jax_out))],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}

    def drain(name, proc):  # keep the pipes from filling
        logs[name] = proc.communicate(timeout=400)[0]

    threads = [threading.Thread(target=drain, args=(f"rank{r}", p)) for r, p in enumerate(ranks)]
    threads.append(threading.Thread(target=drain, args=("jax", jax_proc)))
    for t in threads:
        t.start()
    jax_streams = {c: _jax_engine_streams(c) for c in ENGINE_CASES}
    for t in threads:
        t.join()
    codes = [p.returncode for p in ranks] + [jax_proc.returncode]
    assert codes == [0] * (WORLD + 1), "\n".join(f"--- {k}:\n{v[-4000:]}" for k, v in logs.items())
    with open(out, "rb") as f:
        results = pickle.load(f)
    with open(jax_out, "rb") as f:
        jax_mesh = pickle.load(f)
    return {"ranks": results, "jax_mesh": jax_mesh, "jax_streams": jax_streams}


def _case(world, name):
    every = world["ranks"][name]
    for r, (status, got) in enumerate(every):
        assert status == "ok", f"rank {r}, case {name}:\n{got}"
    return [got for _, got in every]


# --------------------------------------------------------- single process --


def test_rule_tables_match_jax():
    import repro.layers.sharding as J

    from repro_torch.layers import sharding as S

    for name in ("TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES", "LONG_DECODE_RULES"):
        assert getattr(S, name) == getattr(J, name), name
    assert S.MeshAxes() == S.MeshAxes(**vars(J.MeshAxes()))
    assert S.NULL_CTX.mesh is None and S.NULL_CTX.tp_size == 1


class _FakeMesh:
    """A mesh's shape and names, all the JAX functions read of one."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


_LOGICAL = [("batch", "seq", "embed"), ("batch", "heads", "seq", "head_dim"),
            ("batch", "layers", "kv_heads", "kv_seq", "head_dim"), ("batch", "seq", "vocab"),
            ("batch", "seq", "ffn"), (None, "layers", "kv_heads", None, "head_dim"),
            ("batch", "state"), ("param_embed", "param_ffn")]


@pytest.mark.parametrize("phase", ["train", "prefill", "decode", "long_decode"])
def test_resolve_and_sanitize_match_jax(phase):
    import repro.core.phase_engine as JPE
    import repro.layers.sharding as J

    from repro_torch.core import phase_engine as PE
    from repro_torch.layers import sharding as S

    for shape in ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 4}):
        mesh = _FakeMesh(shape)
        if phase == "train":
            ours = S.PartitionCtx(mesh=mesh, axes=PE._mesh_axes(mesh), rules=S.TRAIN_RULES)
            theirs = J.PartitionCtx(mesh=None, axes=JPE._mesh_axes(mesh), rules=J.TRAIN_RULES)
        else:
            ours = PE.make_pctx(mesh, phase)
            theirs = J.PartitionCtx(mesh=None, axes=JPE._mesh_axes(mesh),
                                    rules=JPE.make_pctx(None, phase).rules)
        assert ours.axes == S.MeshAxes(**vars(theirs.axes))
        assert ours.tp_size == shape["model"]
        for logical in _LOGICAL:
            spec = ours.resolve(logical)
            assert tuple(spec) == tuple(theirs.resolve(logical)), logical
            for dims in ((4, 8, 6, 32, 16), (1, 9, 12, 30, 2), (2, 16, 3, 64, 8)):
                dims = dims[:len(logical)]
                assert tuple(S.sanitize_spec(spec, dims, mesh)) == tuple(
                    J.sanitize_spec(theirs.resolve(logical), dims, mesh)), (logical, dims)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_jax_on_every_path(arch):
    """Every leaf of a reduced tree of each transformer arch (ternary ones
    packed, named as the JAX tree names a ``TernaryWeight``): the same
    spec from ``param_pspec`` at inference and in training, with and
    without expert parallelism, and the same sanitized spec on a (2, 2)
    mesh."""
    import repro.layers.sharding as J
    from repro.launch.sharding_rules import param_pspec as j_param_pspec

    from repro_torch.configs import reduced_config
    from repro_torch.launch import sharding_rules as R
    from repro_torch.models import transformer as T
    from repro_torch.quant.ternary import TernaryWeight

    cfg = reduced_config(arch)
    params = T.convert_for_inference(T.init(cfg, 0, device="cpu", dtype=torch.float32), cfg)
    mesh = _FakeMesh({"data": 2, "model": 2})
    seen = 0

    def check(path, leaf):
        nonlocal seen
        for tp, fsdp, ep in (("model", None, False), ("model", "data", False),
                             ("model", "data", True), (None, None, False)):
            ours = R.param_pspec(path, leaf, tp=tp, fsdp=fsdp, ep=ep)
            theirs = j_param_pspec(path, leaf, tp=tp, fsdp=fsdp, ep=ep)
            assert tuple(ours) == tuple(theirs), (path, tp, fsdp, ep)
        seen += 1
        return leaf

    R._map(check, params)
    assert seen == len(_leaves(params))
    for train in (False, True):
        specs = R.params_shardings(params, cfg, mesh, train=train)
        tp, fsdp, ep = R._axes(cfg, mesh, train, "model", "data")

        def same(path, leaf, specs=specs):
            want = J.sanitize_spec(j_param_pspec(path, leaf, tp=tp, fsdp=fsdp, ep=ep),
                                   leaf.shape, mesh)
            got = _spec_at(specs, path)
            assert tuple(got) == tuple(want), (path, train)
            return leaf

        R._map(same, params)
    if cfg.quant.ternary:  # the packed rows of a row-parallel linear are over the model axis
        spec = R.params_shardings(params, cfg, mesh, train=False)["layers"]["attn"]["wo"]["w"]
        assert isinstance(spec, TernaryWeight) and tuple(spec.packed) == (None, "model", None)


def _leaves(tree):
    from repro_torch.quant.ternary import TernaryWeight

    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, TernaryWeight):
        return [tree.packed, tree.scale]
    return [tree]


def _spec_at(specs, path):
    node = specs
    for part in path.split("/"):
        node = node[part] if isinstance(node, dict) else getattr(node, part)
    return node


def test_shard_params_slices_packed_bytes_and_keeps_the_scale():
    """A rank's slice of a packed linear is its rows of the packed bytes
    (column-parallel: its N columns; row-parallel: its K/4 rows) with the
    whole tensor's scale; nothing is quantized again."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.models import transformer as T

    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 0, device="cpu"), cfg)
    whole = params["layers"]["attn"]
    for d, m in ((0, 0), (0, 1), (1, 1)):
        mesh = _StubMesh({"data": d, "model": m})
        local = shard_params(params, cfg, mesh)
        wq, wo = local["layers"]["attn"]["wq"]["w"], local["layers"]["attn"]["wo"]["w"]
        n = whole["wq"]["w"].packed.shape[-1] // 2
        assert torch.equal(wq.packed, whole["wq"]["w"].packed[..., m * n:(m + 1) * n])
        kq = whole["wo"]["w"].packed.shape[1] // 2
        assert torch.equal(wo.packed, whole["wo"]["w"].packed[:, m * kq:(m + 1) * kq])
        assert torch.equal(wo.scale, whole["wo"]["w"].scale)
        vp = cfg.padded_vocab() // 2
        assert torch.equal(local["emb"], params["emb"][m * vp:(m + 1) * vp])
        assert torch.equal(local["ln_f"]["scale"], params["ln_f"]["scale"])


def test_local_params_takes_a_slice_as_given_and_refuses_another_ranks():
    """A rank's engine runs on a slice cut beforehand as it is, cuts its
    slice from a whole tree, and refuses a slice cut for another rank."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.sharding_rules import local_params, shard_params
    from repro_torch.models import transformer as T

    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 0, device="cpu"), cfg)
    mesh = _StubMesh({"data": 1, "model": 1})
    local = shard_params(params, cfg, mesh)
    assert local_params(local, cfg, mesh) is local
    cut = local_params(params, cfg, mesh)
    assert torch.equal(cut["emb"], local["emb"])
    assert torch.equal(cut["layers"]["mlp"]["w_down"]["w"].packed,
                       local["layers"]["mlp"]["w_down"]["w"].packed)
    with pytest.raises(ValueError, match="cut at"):
        local_params(local, cfg, _StubMesh({"data": 1, "model": 0}))
    with pytest.raises(ValueError, match="cut at"):
        local_params(local, cfg, mesh, train=True)


class _StubMesh(_FakeMesh):
    """A (2, 2) mesh seen from one coordinate, with no process group."""

    capturable = False  # as gloo's: its programs run eagerly
    size = 4

    def __init__(self, coords):
        super().__init__({"data": 2, "model": 2})
        self.coords = coords
        self.device = torch.device("cpu")

    def coordinate(self, axis):
        return self.coords[axis]


def test_walk_merge_with_an_empty_shard():
    """Two walks over disjoint halves of a cache merge into the whole
    walk's (out, l, m); a half with no rows weighs nothing and gives no
    NaN, and with no rows anywhere out and l are 0."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.layers.attention import combine_partials

    rng = np.random.default_rng(2)
    b, h, hkv, s, d = 3, 4, 2, 16, 8
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([5, 13, 0], dtype=torch.int32)  # shard 1 empty, split, both empty
    whole = decode_attention(q, k, v, lengths, return_stats=True)
    half = s // 2
    parts = [decode_attention(q, k[:, :, r * half:(r + 1) * half], v[:, :, r * half:(r + 1) * half],
                              torch.clamp(lengths - r * half, 0, half).to(torch.int32),
                              return_stats=True) for r in range(2)]
    out, l, m = combine_partials(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    assert torch.isfinite(out).all() and torch.isfinite(l).all()
    torch.testing.assert_close(out[:2], whole[0][:2], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l[:2], whole[1][:2], atol=1e-6, rtol=1e-6)
    assert torch.equal(m[:2], whole[2][:2])
    assert (out[2] == 0).all() and (l[2] == 0).all()


def test_mesh_refusals():
    """A mesh refuses what it does not shard, by name: xLSTM under the
    long-context decode rules (ROADMAP A.13.12; the other families serve,
    ``tests/test_torch_mesh_family_serve.py``) and dims the model axis does
    not divide; the disaggregated pools split a mesh with a pod axis only.
    Chunked prefill, speculative decoding and every swap policy are taken
    (``tests/test_torch_mesh_spec.py`` serves them), and so are the chunk
    and verify programs."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineCore

    mesh = _StubMesh({"data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match="A.13.12"):
        PhaseEngine(reduced_config("xlstm-1.3b"), mesh, long_context=True)
    PhaseEngine(reduced_config("hymba-1.5b"), mesh, long_context=True)
    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 0, device="cpu"), cfg)
    for kw in (dict(prefill_chunk=8, spec_decode=2), dict(swap_policy="swap-aware"),
               dict(swap_policy="slo-aware", cache_layout="paged", spec_decode=2)):
        eng = EngineCore(cfg, params, mesh=mesh, **ENGINE_BASE, **kw)
        assert eng.runner.verify_prog is not None or "spec_decode" not in kw
        if "prefill_chunk" in kw:  # the mirror holds this rank's heads
            assert eng.runner.chunk_prefix.k.shape[2] == cfg.num_kv_heads // 2
    from repro_torch.serving import DisaggEngine

    with pytest.raises(ValueError, match="spatial disaggregation needs a pod axis"):
        DisaggEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_BASE)
    with pytest.raises(ValueError, match="does not divide"):
        PhaseEngine(reduced_config("bitnet-730m", num_heads=3, num_kv_heads=3), mesh)
    eng = PhaseEngine(cfg, mesh)
    with pytest.raises(ValueError, match="sequence shards"):
        eng.init_cache(2, 33)
    assert eng.verify_program(2, 32, 3).name == "verify:2x3@32"
    assert eng.paged_prefill_chunk_program(16, 4, 8, 0).name == "prefill_chunk_paged:16+0@4x8"


def test_kernel_pass_holds_the_kernels_at_the_shard_shapes():
    """The kernel pass's card half also runs every kernel at a mesh rank's
    shard shapes (``kernel_check.mesh_cases``): act-quant over a row
    shard with its absmax column, B1 at the column and row shards (a row
    shard at a unit scale), B2 on 12 of 24 heads, the walks over a
    sequence half with an empty slot and over a data rank's slots; and
    granite-moe-3b-a800m's: B2 on 12 of 24 heads over 4 KV heads, B3 and
    B6 at G = 3; the pod split's decode pool: B3 over a sequence half at 4
    slots, B6 over 4 slots of the whole pool; the verify pass's and the
    chunks': B1 at a data rank's 10 verify rows and a 256-row chunk, B3 and
    B4 over each sequence half at 5 rows a slot (a block across the
    halves), B5 and B6 with each table row 5 times, the split's decode rank
    at 4 slots x 5; and the other families' on (2, 2): B3 over each half
    of hymba's 4,096-row cache from the window's start (a half wholly
    before the window, a half past every length), over whisper's cross
    halves (768 and 732 valid rows, the pad dead) and self halves, B2 on
    10 of whisper's 20 heads, B3 over a quarter of hymba's 524,288
    long-context rows.  Here each case's plain version runs, a row shard's
    B1 returns the exact int32 partial, and a walk's dead rows holding NaN
    change nothing (the plain version masks them as the kernel skips
    them)."""
    from repro_torch.analysis import kernel_check as K
    from repro_torch.quant.ternary import unpack_ternary

    cases = K.mesh_cases()
    assert {c.kernel for c in cases} == set(K.LAUNCHES)
    shards = {c.label.split("tlmm ")[1] for c in cases if c.kernel == "tlmm"}
    verify = [c for c in cases if "verify rows" in c.label]
    assert sorted(c.kernel for c in verify) == sorted(
        ["decode_attention"] * 2 + ["decode_attention_quant"] * 3 + ["paged_decode_attention"]
        + ["paged_decode_attention_quant"] * 2)
    assert any("local lengths=[45, 46, 47, 48, 48" in c.label for c in verify)  # across the halves
    assert all(c.repeat == 5 for c in verify if "sequence half" in c.label)
    for m in (2, 4, 10, 256):
        for k, n, how in ((1536, 768, "column"), (1536, 2048, "column"), (768, 1536, "row"),
                          (2048, 1536, "row")):
            assert f"M={m} K={k} N={n} (a model rank's {how} shard)" in shards
    assert any("H=12 Hkv=12" in c.label for c in cases if c.kernel == "prefill_attention")
    granite = [c.label for c in cases if "granite" in c.label]  # G = 3 shards of a MoE mesh
    assert sum("H=12 Hkv=4" in x for x in granite) == 2 and len(granite) == 5, granite
    assert any("lengths=[0, 48]" in c.label for c in cases if c.kernel == "decode_attention_quant")
    split = [c.kernel for c in cases if "the split's decode pool" in c.label]
    assert split == ["decode_attention", "paged_decode_attention_quant"], split
    family = [c.label for c in cases if "hymba" in c.label or "whisper" in c.label]
    assert len(family) == 8, family
    assert any("rank 0's half of 4096: local lengths=[1000, 2048, 2048, 2048] starts=[0, 1025, "
               "1977, 2048]" in x for x in family)  # slot 3: wholly before its window
    assert any("rank 1's half of 4096: local lengths=[0, 0, 952, 1952]" in x for x in family)
    assert any("cross half 1: 732 of 768 rows" in x for x in family)
    assert any("10 of whisper's 20 decoder heads" in x for x in family)
    assert any("local length 131071 of 131072" in x for x in family)
    plains = K._plains()
    for case in cases:
        named = K._plain_named(case)
        out = plains[case.kernel](*K._resolve(case.plain_args, named),
                                  **K._resolve_kw(case.plain_kwargs, named))
        outs = out if isinstance(out, tuple) else (out,)
        assert all(torch.isfinite(t.float()).all() for t in outs), case.label
        if case.kernel == "tlmm" and "row shard" in case.label:
            acc = named["x_q"].double() @ unpack_ternary(named["w"]).double()
            assert torch.equal(outs[0].double(), acc), case.label
        if case.label in family and case.kernel == "decode_attention":
            junk = K._plain_named(case, fill="a")  # NaN in the dead rows
            again = plains[case.kernel](*K._resolve(case.plain_args, junk),
                                        **K._resolve_kw(case.plain_kwargs, junk))
            assert all(torch.equal(a, b) for a, b in zip(outs, again)), case.label


def test_serve_mesh_example_over_the_launcher():
    """The documented way to start the ranks: ``torch.distributed.run``
    with 4 processes and the backend named, a reduced model on the CPU;
    rank 0's streams equal the unsharded engine's."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    run = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m", "repro_torch.examples.serve_mesh",
                        "--backend", "gloo", "--device", "cpu", "--reduced", "--check"],
                       env=env, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "streams equal the unsharded engine's" in run.stdout
    assert run.stdout.count("KV 0.12 MiB") == 4  # a quarter of the cache on each rank


# --------------------------------------------------------------- the world --


def test_world_comes_up_as_a_two_by_two_mesh(world):
    lines = world["ranks"]["describe"]
    assert [f"rank {r} of 4 on cpu (gloo; mesh data=2, model=2" in line
            for r, line in enumerate(lines)] == [True] * 4
    assert "at data=1, model=0" in lines[2] and "programs eager" in lines[0]
    msg = _case(world, "production_mesh")[0]
    assert msg is not None and "needs 256 ranks" in msg


def test_collective_helpers_portable_form_equals_native(world):
    per_rank = _case(world, "collectives")
    assert {r["form"] for r in per_rank} == {"portable"}  # gloo: broadcasts and all_reduce
    xs = [torch.arange(24, dtype=torch.float32).reshape(4, 6) * (r + 1) - 0.5 * r
          for r in range(WORLD)]
    members = {"model": lambda r: [r - r % 2, r - r % 2 + 1], "data": lambda r: [r % 2, r % 2 + 2],
               "world": lambda r: list(range(WORLD))}
    for r, got in enumerate(per_rank):
        for name, group in members.items():
            g = got[name]
            assert g["all_gather"] and g["all_to_all"], (r, name)
            assert g["gather_shape"] == (4, 6 * len(group(r)))
            assert g["sum"] == sum(xs[i] for i in group(r)).tolist()
            assert g["max"] == torch.stack([xs[i] for i in group(r)]).amax(0).tolist()
            assert g["broadcast"] == xs[group(r)[1]].tolist()
        assert got["shard"] == {"to_seq": True, "gather": True, "slice": True}, r


def test_act_quant_and_tlmm_over_k_shards_are_bit_exact(world):
    for r, got in enumerate(_case(world, "row_parallel")):
        for dt, flags in got.items():
            assert flags == {"y_equal": True, "x_q_equal": True, "scale_equal": True}, (r, dt)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_relayout_exchange_places_rows_as_jax_does(world, kv_dtype):
    """Each rank's block of the decode cache after the exchange equals the
    matching slice of the JAX relayout's global cache on the same f32
    prefill KV: int8/int4 payloads and scale planes bit for bit; a bf16
    cache bit for bit with the JAX f32 cache cast to bf16."""
    import jax.numpy as jnp

    import repro.configs as jcfgs
    from repro.core.phase_engine import PhaseEngine as JPhaseEngine
    from repro.layers.attention import KVCache as JKVCache

    cfg = jcfgs.reduced_config("bitnet-730m")
    k, v = random_kv(cfg)
    eng = JPhaseEngine(cfg, None, max_len=MAXLEN, kv_dtype=kv_dtype)
    cache = eng.relayout_program(B, P, MAXLEN).fn(JKVCache(jnp.asarray(k), jnp.asarray(v)))
    per_rank = _case(world, f"relayout-{kv_dtype}")
    seen = set()
    for r, got in enumerate(per_rank):
        b_lo, b_hi, s_lo, s_hi = got["rows"]
        seen.add((b_lo, s_lo))
        assert (b_hi - b_lo, s_hi - s_lo) == (B // 2, MAXLEN // 2)
        for name, leaf in (("k", cache.k), ("v", cache.v)):
            if kv_dtype == "fp":
                want = np.asarray(leaf.astype(jnp.bfloat16).astype(jnp.float32))
                np.testing.assert_array_equal(got[name], want[b_lo:b_hi, :, :, s_lo:s_hi])
            else:
                np.testing.assert_array_equal(got[name]["q"],
                                              np.asarray(leaf.q)[b_lo:b_hi, :, :, s_lo:s_hi])
                np.testing.assert_array_equal(got[name]["scale"],
                                              np.asarray(leaf.scale)[b_lo:b_hi, :, :, s_lo:s_hi])
        assert got["exchange_bytes"] > 0
    assert seen == {(0, 0), (0, 16), (2, 0), (2, 16)}  # every block of the cache, once


@pytest.mark.parametrize("arch", ["deepseek-7b", "bitnet-730m"])
def test_mesh_prefill_relayout_decode_tokens_match_jax(world, arch):
    """Reduced deepseek-7b (dense f32) and bitnet-730m (packed ternary):
    prefill -> relayout -> 3 greedy decode steps on the (2, 2) mesh give
    the JAX package's tokens on its (2, 2) mesh, and the port's own
    unsharded tokens.  Where the JAX mesh program did not run, the JAX
    unsharded program stands in for it (see the module docstring)."""
    ref = world["jax_mesh"][arch]
    want = ref["mesh"] if ref["ran"] == "mesh" else ref["unsharded"]
    if ref["ran"] == "mesh":
        np.testing.assert_array_equal(ref["mesh"], ref["unsharded"])
    per_rank = _case(world, f"roll-{arch}")
    for r, got in enumerate(per_rank):
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"rank {r}")
    np.testing.assert_array_equal(per_rank[0]["unsharded"], want)


def test_long_context_rules_walk_the_sequence_over_every_rank(world):
    per_rank = _case(world, "long_context")
    for r, got in enumerate(per_rank):
        np.testing.assert_array_equal(got["tokens"], per_rank[0]["unsharded"], err_msg=f"rank {r}")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_on_a_mesh_streams_match_the_port_and_jax(world, case):
    """EngineCore(mesh=) on reduced bitnet-730m: rank 0's streams equal the
    port's engine without a mesh and a live JAX engine's, and every rank's
    host decisions (the snapshot without its times) are the same."""
    per_rank = _case(world, f"engine-{case}")
    got = per_rank[0]["streams"]
    assert len(got) == len(PROMPT_LENS)
    assert got == per_rank[0]["ref"][0]
    assert got == world["jax_streams"][case]
    for r in range(1, WORLD):
        assert per_rank[r]["snapshot"] == per_rank[0]["snapshot"], f"rank {r}"
        assert per_rank[r]["streams"] == got, f"rank {r}"
    kw, how = ENGINE_CASES[case]
    if kw.get("cache_layout") == "paged":  # the pool is whole on every rank
        assert per_rank[0]["kv_bytes"] == per_rank[0]["ref"][3]
    else:  # a quarter: half the slots, half the sequence
        assert per_rank[0]["kv_bytes"] * 4 == per_rank[0]["ref"][3]
    if how == "shared":
        assert per_rank[0]["prefix_hits"] > 0
    if how == "sampled":
        assert got["r1"] != _case(world, "engine-contiguous-fp")[0]["streams"]["r1"]


def test_engine_runs_on_a_slice_cut_beforehand(world):
    """EngineCore(mesh=) given each rank's ``shard_params`` slice (the whole
    tree dropped) serves the streams and host decisions it serves when it
    cuts the slice from the whole tree itself."""
    per_rank = _case(world, "engine-slice")
    whole = _case(world, "engine-contiguous-fp")
    for r in range(WORLD):
        assert per_rank[r]["streams"] == whole[0]["streams"], f"rank {r}"
        assert per_rank[r]["snapshot"] == whole[r]["snapshot"], f"rank {r}"
        assert per_rank[r]["kv_bytes"] == whole[r]["kv_bytes"], f"rank {r}"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the mesh tests' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
