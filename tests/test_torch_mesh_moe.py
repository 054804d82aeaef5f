"""MoE expert parallelism on a mesh of processes: the port's ``moe_apply``
(EP with its exchange, the local-expert and the hidden-split paths), its
serving programs and its train step on a (data 2, model 2) mesh, against
the JAX package's mesh programs, on the CPU over gloo.

One world of 4 ranks is started for the module (each rank a process running
this file, its store in a file under the test's temporary directory) and
runs every multi-rank case; rank 0 writes what each case found.  Beside it
the JAX reference runs once, in a subprocess with 4 host devices, on a
``jax.sharding.Mesh`` built with Auto axes (``jax.make_mesh`` gives
Explicit axes under jax 0.9): the jitted ``moe_apply`` (its ``_route``
wrapped to report each dispatch group's drops through
``jax.debug.callback``), ``PhaseEngine`` prefill -> relayout -> 3 decode
steps, and ``jit_train_step``.  The JAX ``EngineCore`` does not run on a
mesh under the installed jax (its batch-1 prefill does not divide a data
axis of 2, and on a (1, 2) mesh its split tail refuses the heads-sharded
hidden state), so the engine cases are held to the JAX engine without a
mesh at a capacity factor of 8, where nothing drops and the dispatch
groups cannot matter; the live JAX engines run in this process while the
ranks work.

Configs: reduced granite-moe-3b-a800m (4 experts top-2: EP on the model
axis of 2), the same at 3 experts (the local-expert path where the
sequence divides the axis, the hidden split where it does not: decode) and
reduced moonshot-v1-16b-a3b (EP).  Float work is f32.

Tolerances (each read on this CPU and stated where it is used):
* ``moe_apply`` outputs within ``MOE_ATOL`` of JAX's mesh program: the
  expert products and the combine run the same f32 sums, the gather back
  and the exchange move bits; read 2.3e-6 (outputs of about 3).
* the serving programs' logits within ``LOGIT_ATOL``, the cache in f32 as
  JAX's; read 7.7e-7.  Tokens equal.
* the train step: losses and grad norms within ``DENSE_RTOL`` relative,
  the aux loss within ``AUX_RTOL`` relative (the port sums the counts over
  data, JAX takes one mean over the whole batch), params after step 3
  within ``PARAM_ATOL``, moments within ``MOMENT_RTOL`` of each leaf's
  largest |value|: the dense f32 limits of ``test_torch_mesh_train``.
  Read: losses 8.6e-8, grad norms 2.3e-7, aux 1.1e-7, params 1.2e-7,
  moments 1.9e-6.  Left out, the exchange's backward or the 1 / tp share
  of an output every model rank computes breaks these limits.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import argparse
import dataclasses
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

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
MOE_B = 32  # rows of x in the moe_apply cases: 16 a data rank
MOE_S = (8, 1)  # a prefill's sequence (over the model axis) and a decode step's
CAPACITIES = (8.0, 1.25)  # nothing drops; the configs' own factor
B, P, MAXLEN, STEPS = 4, 8, 32, 3  # the serving roll
TB, TSTEPS = 8, 3  # the train step's rows and steps
LR = 3e-4
MOE_ATOL = 5e-6  # read: 2.3e-6
LOGIT_ATOL = 1e-5  # read: 7.7e-7
DENSE_RTOL = 1e-6  # test_torch_mesh_train's
AUX_RTOL = 1e-6
PARAM_ATOL = 1e-4
MOMENT_RTOL = 2e-5
ENGINE_BASE = dict(n_slots=2, max_len=64, prompt_len=16, block_size=8)
PROMPT_LENS = (5, 17, 9, 30)
MAX_NEW = 6


def config(name, capacity=None, ternary=False, backend="torch"):
    """The reduced config ``name`` ("granite", "granite3", "moonshot") of
    the port or (``backend="jax"``) of the JAX package."""
    if backend == "jax":
        from repro.configs import reduced_config
        from repro.configs.base import QuantConfig
    else:
        from repro_torch.configs import reduced_config
        from repro_torch.configs.base import QuantConfig
    arch = {"moonshot": "moonshot-v1-16b-a3b", "qwen": "qwen2.5-14b"}.get(
        name, "granite-moe-3b-a800m")
    cfg = reduced_config(arch, **({"num_experts": 3} if name == "granite3" else {}))
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    if ternary:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode="ternary"))
    return cfg


# moe_apply cases: name -> (config, sequence, capacity, ternary)
MOE_CASES = {f"{c}-s{s}-cap{cap:g}": (c, s, cap, False)
             for c in ("granite", "granite3", "moonshot") for s in MOE_S for cap in CAPACITIES}
MOE_CASES.update({f"ternary-{c}-s{s}": (c, s, 8.0, True)
                  for c in ("granite", "granite3") for s in MOE_S})
MOE_SEEDS = {"granite": 1, "granite3": 1, "moonshot": 2}  # reduced moonshot's MoE has granite's shapes
ROLL_CASES = ("granite", "granite3", "moonshot")
# train step cases: name -> (config, sequence, mesh shape, mesh axes); at 31
# the sequence does not divide the model axis, so the rows are whole on
# every model rank (EP: each rank's loss reaches every expert; granite3: the
# hidden split); on (pod 4) there is no model axis: the MoE routes the
# whole batch as one group, as JAX's does with no shard_map, and every
# model-axis collective is a group of one (dense reduced qwen2.5-14b too)
DM = ((2, 2), ("data", "model"))
TRAIN_CASES = {"granite": ("granite", 32, *DM), "granite3": ("granite3", 32, *DM),
               "granite-s31": ("granite", 31, *DM), "granite3-s31": ("granite3", 31, *DM),
               "granite-pod": ("granite", 32, (4,), ("pod",)),
               "qwen-pod": ("qwen", 32, (4,), ("pod",))}
ENGINE_CASES = ("granite", "granite3", "moonshot")



# ------------------------------------------------------------ shared data --


def moe_layer_np(cfg, rng):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {"router": (rng.normal(size=(d, e)) * d**-0.5).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) * d**-0.5).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) * d**-0.5).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) * f**-0.5).astype(np.float32)}


def moe_inputs(cfg, s, seed):
    """One layer's f32 weights and x (MOE_B, s, d) leaning towards expert 0,
    so that at the configs' capacity some expert overflows."""
    rng = np.random.default_rng(seed)
    params = moe_layer_np(cfg, rng)
    lean = params["router"][:, 0] / np.linalg.norm(params["router"][:, 0])
    x = rng.normal(size=(MOE_B, s, cfg.d_model)) + 3.0 * lean
    return params, x.astype(np.float32)


def model_np(cfg, seed=0, emb_scale=0.02):
    """Latent f32 weights of a reduced MoE model in the JAX tree layout.  The
    engine cases draw the embedding (the tied head) at unit scale: at 0.02
    the reduced models' logits lie within about 0.6 of each other and a
    6-token stream meets near ties (two tokens' f32 scores 1e-4 apart) that
    the engines' bf16 caches round either way."""
    rng = np.random.default_rng(seed)
    L, d, h, hkv, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(k, n):
        return {"w": (rng.normal(size=(L, k, n)) * k**-0.5).astype(np.float32)}

    def norm(*shape):
        return {"scale": (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)}

    layers = [moe_layer_np(cfg, rng) for _ in range(L)]
    return {"emb": (rng.normal(size=(cfg.padded_vocab(), d)) * emb_scale).astype(np.float32),
            "layers": {"attn": {"wq": lin(d, h * hd), "wk": lin(d, hkv * hd),
                                "wv": lin(d, hkv * hd), "wo": lin(h * hd, d)},
                       "ln1": norm(L, d), "ln2": norm(L, d),
                       "moe": {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}},
            "ln_f": norm(d)}


def train_tree(cfg):
    """The latent f32 weights a train case starts from: an MoE tree, or
    ``test_torch_mesh_train``'s dense one."""
    if cfg.moe:
        return model_np(cfg)
    import test_torch_mesh_train

    return test_torch_mesh_train.numpy_train_params(cfg)


def prompt_tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


def train_batches(cfg, seq, n=TSTEPS, seed=7):
    """n global batches of TB x seq whose masks keep a share of each row
    that grows with the row."""
    rng = np.random.default_rng(seed)
    keep = np.linspace(0.3, 1.0, TB)[:, None]
    return [{"tokens": rng.integers(0, cfg.vocab_size, (TB, seq)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (TB, seq)).astype(np.int32),
             "mask": (rng.random((TB, seq)) < keep).astype(np.float32)} for _ in range(n)]


def engine_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in PROMPT_LENS]


# ---------------------------------------------------------------- the ranks --


def _counting_route():
    """Wrap the port's ``_route`` to count each call's dropped assignments;
    returns (the list, a function restoring ``_route``)."""
    from repro_torch.layers import moe as M

    drops, route = [], M._route

    def counting(gate_logits, k, capacity, num_experts):
        out = route(gate_logits, k, capacity, num_experts)
        drops.append(int((out[1] == num_experts * capacity).sum()))
        return out

    M._route = counting

    def restore():
        M._route = route
    return drops, restore


def _layer_slice(layer, cfg, mesh, train=False):
    """This rank's ``shard_params`` slice of one MoE layer's weights."""
    from repro_torch.launch.sharding_rules import shard_params

    tree = {"layers": {"moe": {k: torch.from_numpy(v)[None] for k, v in layer.items()}}}
    return {k: v[0] for k, v in shard_params(tree, cfg, mesh, train=train)["layers"]["moe"].items()}


def case_moe(ctx, name):
    from repro_torch.core.phase_engine import make_pctx
    from repro_torch.layers import moe as M
    from repro_torch.models.transformer import batch_rows

    cname, s, cap, ternary = MOE_CASES[name]
    cfg = config(cname, cap, ternary)
    mesh = ctx["mesh"]
    pctx = make_pctx(mesh, "prefill" if s > 1 else "decode")
    layer, x = moe_inputs(cfg, s, MOE_SEEDS[cname])
    lo, hi = batch_rows(pctx, MOE_B)
    drops, restore = _counting_route()
    try:
        y, aux = M.moe_apply(_layer_slice(layer, cfg, mesh), torch.from_numpy(x[lo:hi]), cfg,
                             pctx=pctx)
    finally:
        restore()
    return {"y": y.numpy(), "rows": (lo, hi), "aux": float(aux), "drops": drops}


def _roll(cfg, params, mesh):
    """prefill of the B prompts in one batch -> relayout -> STEPS greedy
    decode steps through the port's phase programs, the cache in f32 (the
    JAX relayout keeps the f32 prefill KV's dtype): (tokens (STEPS + 1, B),
    logits (STEPS + 1, B, Vp))."""
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.layers.attention import KVCache
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import batch_rows

    eng = PhaseEngine(cfg, mesh)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    eng.init_cache(B, MAXLEN, device="cpu")
    # this rank's block in f32, as the JAX relayout of f32 prefill KV makes the cache
    k = eng.decode_ctx.size(eng.decode_ctx.resolve(["kv_seq"])[0])
    lo, hi = batch_rows(eng.decode_ctx, B)
    cache = T.init_cache(cfg, hi - lo, MAXLEN // k, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(prompt_tokens(cfg)).long()
    logits, kv = eng.prefill_program_varlen(B, P)(params, tokens, P - 1)
    lo, hi = batch_rows(eng.prefill_ctx, B)
    for i in range(B):
        j = i - lo if lo <= i < hi else 0  # the other data row passes a KV it ignores
        eng.relayout_program(1, P, MAXLEN)(KVCache(kv.k[:, j:j + 1], kv.v[:, j:j + 1]), cache, i)
    tok = torch.argmax(logits, dim=-1)
    toks, lgs = [tok.numpy()], [logits.numpy()]
    lengths = torch.full((B,), P, dtype=torch.int32)
    dec = eng.decode_program(B, MAXLEN)
    for i in range(STEPS):
        logits, cache = dec(params, tok, cache, lengths + i)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok.numpy())
        lgs.append(logits.numpy())
    return np.stack(toks), np.stack(lgs)


def case_roll(ctx, name):
    from repro_torch.interop import params_from_numpy

    cfg = config(name)
    params = params_from_numpy(model_np(cfg), cfg, device="cpu")
    return dict(zip(("tokens", "logits"), _roll(cfg, params, ctx["mesh"])))


def case_engine(ctx, name):
    """EngineCore(mesh=) at capacity 8 (rank 0 admits, the others follow);
    rank 0 also runs the port's engine without a mesh."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.serving import EngineCore, Request

    cfg, mesh = config(name, 8.0), ctx["mesh"]
    params = params_from_numpy(model_np(cfg, emb_scale=1.0), cfg, device="cpu")
    out = {}
    for key, m in (("mesh", mesh), ("none", None)):
        if m is None and mesh.rank != 0:
            continue
        eng = EngineCore(cfg, params, device="cpu", mesh=m, **ENGINE_BASE)
        if m is not None and m.rank != 0:
            eng.follow()
        else:
            for i, p in enumerate(engine_prompts()):
                eng.submit(Request(f"r{i}", p, max_new=MAX_NEW))
            eng.run()
            if m is not None:
                eng.stop_followers()
        out[key] = {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}
    return out


def _np_tree(tree):
    from repro_torch.common.tree import named_leaves

    return {name: t.detach().cpu().numpy().copy() for name, t in named_leaves(tree)}


def case_train(ctx, name):
    """TSTEPS steps on the case's mesh; the whole params and moments
    gathered after the last."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.launch.train import gather_state
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    from repro_torch.launch.mesh import make_mesh

    cname, seq, shape, axes = TRAIN_CASES[name]
    cfg = config(cname)
    mesh = ctx["mesh"] if shape == DM[0] else make_mesh(shape, axes)
    params = shard_params(params_from_numpy(train_tree(cfg), cfg, device="cpu", latent=True),
                          cfg, mesh, train=True)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig(lr=LR, warmup=2), mesh)
    hist = []
    for s, b in enumerate(train_batches(cfg, seq)):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()}, s)
        hist.append({k: float(v) for k, v in m.items()})
    whole = gather_state(params, opt, cfg, mesh)
    out = {"hist": hist}
    if mesh.rank == 0:
        out.update(params=_np_tree(whole[0]), mu=_np_tree(whole[1].mu), nu=_np_tree(whole[1].nu))
    return out


def case_exchange_grad(ctx):
    """``collectives.exchange`` out and back inside a function of a tensor
    every model rank holds whole (this rank's rows cut after
    ``copy_to_tp``, the result gathered with ``gather_replicated``), by
    ``gradcheck`` in f64: its gradient is then the function's whole
    Jacobian on every rank.  Also the same with the exchange's backward
    left out (a plain ``all_to_all``), which gradcheck must refuse."""
    from repro_torch.layers import collectives as C

    mesh = ctx["mesh"]
    tp = mesh.group("model")
    r = mesh.coordinate("model")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 3))).requires_grad_()

    def f(x, exchange=C.exchange):
        mine = C.copy_to_tp(x, tp).narrow(0, 4 * r, 4)
        y = exchange(mine, tp, split_dim=0, cat_dim=1) * (1.5 + r)  # (2, 6) on each rank
        z = exchange(y, tp, split_dim=1, cat_dim=0)  # back to (4, 3)
        return C.gather_replicated(z, tp, dim=0)

    ok = torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8)

    def detached(x, group, *, split_dim, cat_dim):  # forward only: the gradient stops here
        return C.all_to_all(x.detach(), group, split_dim=split_dim, cat_dim=cat_dim)

    try:
        broken = torch.autograd.gradcheck(lambda x: f(x, detached) + x.sum() * 0, (x,),
                                          eps=1e-6, atol=1e-8, raise_exception=False)
    except RuntimeError:
        broken = False
    return {"ok": ok, "broken_passes": broken}


def _cases():
    cases = [("exchange_grad", case_exchange_grad)]
    cases += [(f"moe-{n}", lambda ctx, n=n: case_moe(ctx, n)) for n in MOE_CASES]
    cases += [(f"roll-{n}", lambda ctx, n=n: case_roll(ctx, n)) for n in ROLL_CASES]
    cases += [(f"engine-{n}", lambda ctx, n=n: case_engine(ctx, n)) for n in ENGINE_CASES]
    cases += [(f"train-{n}", lambda ctx, n=n: case_train(ctx, n)) for n in TRAIN_CASES]
    return cases


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the test world: join, build the (2, 2) mesh, run every
    case, gather each case's result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    ctx = {"mesh": make_host_mesh(data=2, model=2)}
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
    dist.destroy_process_group()


# ------------------------------------------------------------ the JAX side --

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_mesh_moe as M
import repro.layers.moe as JM
from repro.core.phase_engine import PhaseEngine, make_pctx
from repro.launch.sharding_rules import params_shardings
from repro.layers.sharding import NULL_CTX
from repro.optim.adamw import AdamWState, adamw_init
from repro.train.trainer import TrainConfig, jit_train_step

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
DROPS = []
_route = JM._route

def counting(gate_logits, k, capacity, num_experts):
    out = _route(gate_logits, k, capacity, num_experts)
    jax.debug.callback(lambda n: DROPS.append(int(n)), jnp.sum(out[1] == num_experts * capacity))
    return out

JM._route = counting
out = {{"moe": {{}}, "roll": {{}}, "train": {{}}}}
for name, (cname, s, cap, ternary) in M.MOE_CASES.items():
    cfg = M.config(cname, cap, ternary, backend="jax")
    layer, x = M.moe_inputs(cfg, s, M.MOE_SEEDS[cname])
    layer, x = jax.tree.map(jnp.asarray, layer), jnp.asarray(x)
    got = {{}}
    for key, pctx in (("mesh", make_pctx(mesh, "prefill" if s > 1 else "decode")),
                      ("single", NULL_CTX)):
        del DROPS[:]
        y, aux = jax.jit(lambda p, x: JM.moe_apply(p, x, cfg, pctx))(layer, x)
        jax.effects_barrier()
        got[key] = {{"y": np.asarray(y), "aux": float(aux), "drops": sorted(DROPS)}}
    out["moe"][name] = got

def roll(cfg, params):
    eng = PhaseEngine(cfg, mesh, max_len=M.MAXLEN)
    pa = jax.eval_shape(lambda: params)
    logits, kv = eng.prefill_program(pa, M.B, M.P).fn(params, jnp.asarray(M.prompt_tokens(cfg)))
    cache = eng.relayout_program(M.B, M.P, M.MAXLEN).fn(kv)
    dec = eng.decode_program(pa, M.B, M.MAXLEN)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, lgs = [np.asarray(tok)], [np.asarray(logits)]
    lengths = jnp.full((M.B,), M.P, jnp.int32)
    for i in range(M.STEPS):
        logits, cache = dec.fn(params, tok, cache, lengths + i)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(logits))
    return {{"tokens": np.stack(toks), "logits": np.stack(lgs)}}

for name in M.ROLL_CASES:
    cfg = M.config(name, backend="jax")
    out["roll"][name] = roll(cfg, jax.tree.map(jnp.asarray, M.model_np(cfg)))

for name, (cname, seq, shape, axes) in M.TRAIN_CASES.items():
    cfg = M.config(cname, backend="jax")
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    params = jax.tree.map(jnp.asarray, M.train_tree(cfg))
    opt = adamw_init(params)
    psh = params_shardings(params, cfg, mesh, train=True)
    params = jax.tree.map(jax.device_put, params, psh)
    opt = AdamWState(jax.device_put(opt.step, NamedSharding(mesh, P())),
                     jax.tree.map(jax.device_put, opt.mu, psh),
                     jax.tree.map(jax.device_put, opt.nu, psh))
    step = jit_train_step(cfg, TrainConfig(lr=M.LR, warmup=2), mesh,
                          jax.eval_shape(lambda: params), donate=False)
    hist = []
    for s, b in enumerate(M.train_batches(cfg, seq)):
        params, opt, m = step(params, opt, {{k: jnp.asarray(v) for k, v in b.items()}}, jnp.int32(s))
        hist.append({{k: float(v) for k, v in m.items()}})
    out["train"][name] = jax.tree.map(np.asarray, {{"hist": hist, "params": params, "mu": opt.mu,
                                                   "nu": opt.nu}})
with open({out_path!r}, "wb") as fh:
    pickle.dump(out, fh)
"""


def _jax_engine_streams(name):
    import jax
    import jax.numpy as jnp

    from repro.serving import EngineCore as JEngineCore
    from repro.serving import Request as JRequest

    cfg = config(name, 8.0, backend="jax")
    eng = JEngineCore(cfg, jax.tree.map(jnp.asarray, model_np(cfg, emb_scale=1.0)), **ENGINE_BASE)
    for i, p in enumerate(engine_prompts()):
        eng.submit(JRequest(f"r{i}", p, max_new=MAX_NEW))
    eng.run()
    return {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks and the JAX subprocess, run the live JAX engines
    meanwhile, and collect everything."""
    tmp = tmp_path_factory.mktemp("mesh_moe")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp / "ranks.pkl"
    ranks = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
                               "--store", str(tmp / "store"), "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    jax_out = tmp / "jax.pkl"
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(tests=str(REPO / "tests"), out_path=str(jax_out))],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}

    def drain(name, proc):  # keep the pipes from filling
        logs[name] = proc.communicate(timeout=400)[0]

    threads = [threading.Thread(target=drain, args=(f"rank{r}", p)) for r, p in enumerate(ranks)]
    threads.append(threading.Thread(target=drain, args=("jax", jax_proc)))
    for t in threads:
        t.start()
    jax_streams = {n: _jax_engine_streams(n) for n in ENGINE_CASES}
    for t in threads:
        t.join()
    codes = [p.returncode for p in ranks] + [jax_proc.returncode]
    assert codes == [0] * (WORLD + 1), "\n".join(f"--- {k}:\n{v[-4000:]}" for k, v in logs.items())
    with open(out, "rb") as f:
        results = pickle.load(f)
    with open(jax_out, "rb") as f:
        jax_ref = pickle.load(f)
    return {"ranks": results, "jax": jax_ref, "jax_streams": jax_streams}


def _case(world, name):
    every = world["ranks"][name]
    for r, (status, got) in enumerate(every):
        assert status == "ok", f"rank {r}, case {name}:\n{got}"
    return [got for _, got in every]


def _jax_flat(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = t
    walk(tree, "")
    return out


# --------------------------------------------------------- single process --


def test_one_rank_mesh_programs_equal_the_no_mesh_programs_bit_for_bit(tmp_path):
    """On a (data 1, model 1) world of one every collective is a group of
    one: reduced granite's bf16 prefill, relayout and decode programs give
    the no-mesh programs' logits bit for bit (the MoE's exchanges skipped,
    a dense row-parallel product the unsharded one)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.models import transformer as T

    join_process_group("gloo", device_type="cpu", init_method=f"file://{tmp_path / 'store1'}",
                       rank=0, world_size=1, timeout_s=60)
    try:
        cfg = config("granite")
        params = T.init(cfg, 0, device="cpu")  # bf16
        got = _roll(cfg, params, make_host_mesh())
        want = _roll(cfg, params, None)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()


# --------------------------------------------------------------- the world --


def test_exchange_gradient_by_gradcheck(world):
    """The exchange's backward (the inverse exchange) gives the Jacobian
    gradcheck measures in f64 on every rank; without it gradcheck fails."""
    for r, got in enumerate(_case(world, "exchange_grad")):
        assert got["ok"] and not got["broken_passes"], (r, got)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_apply_matches_the_jax_mesh_program(world, name):
    """Each rank's rows of ``moe_apply`` on the (2, 2) mesh equal the JAX
    mesh program's within ``MOE_ATOL``, its dispatch groups drop as many
    assignments (each group's count, over the 4 ranks), and the data ranks'
    aux shares sum to JAX's aux loss.  At the configs' capacity the mesh
    drops in other groups than one device; a ternary stack takes the local
    shard's absmean, so EP and the hidden split differ from one device
    while the local-expert path (whole stacks) does not."""
    cname, s, cap, ternary = MOE_CASES[name]
    want = world["jax"]["moe"][name]
    per_rank = _case(world, f"moe-{name}")
    for r, got in enumerate(per_rank):
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["y"], want["mesh"]["y"][lo:hi], rtol=0, atol=MOE_ATOL,
                                   err_msg=f"rank {r}")
    assert sorted(d for got in per_rank for d in got["drops"]) == want["mesh"]["drops"]
    aux = sum(per_rank[r]["aux"] for r in (0, 2))  # model rank 0 of each data row
    assert aux == pytest.approx(want["mesh"]["aux"], rel=1e-6)
    single = np.abs(want["mesh"]["y"] - want["single"]["y"]).max()
    if cap == 8.0 and not ternary:
        assert sum(want["mesh"]["drops"]) == 0 and single < MOE_ATOL
    if ternary:
        local = cname == "granite3" and s > 1
        assert (single < MOE_ATOL) if local else (single > 100 * MOE_ATOL), single


def test_moe_drops_follow_the_dispatch_groups(world):
    """At the configs' capacity factor the mesh drops assignments in its
    own dispatch groups, other counts than one device's: the cases can see
    a grouping fault."""
    seen = 0
    for name, (cname, s, cap, ternary) in MOE_CASES.items():
        want = world["jax"]["moe"][name]
        if cap != 8.0 and sum(want["mesh"]["drops"]):
            seen += 1
            assert want["mesh"]["drops"] != want["single"]["drops"], name
    assert seen >= 3, seen


@pytest.mark.parametrize("name", ROLL_CASES)
def test_mesh_prefill_relayout_decode_match_jax(world, name):
    """Prefill of 4 prompts -> relayout -> 3 greedy decode steps on the
    (2, 2) mesh give the JAX mesh program's tokens on every rank, and its
    logits within ``LOGIT_ATOL`` (granite3: the local experts in prefill,
    the hidden split in decode)."""
    want = world["jax"]["roll"][name]
    for r, got in enumerate(_case(world, f"roll-{name}")):
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_on_a_mesh_streams_match_jax(world, name):
    """EngineCore(mesh=) at capacity 8: every rank's streams equal the
    port's engine without a mesh and the live JAX engine's."""
    per_rank = _case(world, f"engine-{name}")
    got = per_rank[0]["mesh"]
    assert len(got) == len(PROMPT_LENS)
    assert got == per_rank[0]["none"] == world["jax_streams"][name]
    for r in range(1, WORLD):
        assert per_rank[r]["mesh"] == got, f"rank {r}"


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mesh_train_step_matches_jax_jit_train_step(world, name):
    """3 steps of the MoE train step on the case's mesh against JAX's
    ``jit_train_step`` on its Auto-axes mesh: every step's loss, grad norm
    and aux loss on every rank, then the whole params and moments."""
    want = world["jax"]["train"][name]
    per_rank = _case(world, f"train-{name}")
    for r, got in enumerate(per_rank):
        for s, (g, w) in enumerate(zip(got["hist"], want["hist"])):
            for key, tol in (("loss", DENSE_RTOL), ("grad_norm", DENSE_RTOL), ("aux", AUX_RTOL)):
                assert abs(g[key] - w[key]) <= tol * abs(w[key]), (r, s, key, g[key], w[key])
        assert got["hist"] == per_rank[0]["hist"], f"rank {r}"
    got = per_rank[0]
    for key in ("params", "mu", "nu"):
        ref = _jax_flat(want[key])
        assert sorted(got[key]) == sorted(ref), key
        for n, x in got[key].items():
            if key == "params":
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=PARAM_ATOL, err_msg=n)
            else:
                scale = max(float(np.abs(ref[n]).max()), 1e-30)
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=MOMENT_RTOL * scale,
                                           err_msg=f"{key} {n}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the MoE mesh tests' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
