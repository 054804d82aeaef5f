"""Training of the hymba, xLSTM and whisper families on a mesh of processes:
the port's FSDP x TP train step against the JAX package's
``jit_train_step`` on an Auto-axes (data 2, model 2) mesh, on the CPU over
gloo.

One world of 4 ranks is started for the module (each rank a process running
this file, its store in a file under the test's temporary directory); it
takes 3 steps of each case on (data 2, model 2), writes each case's
checkpoint, restores it onto (data 1, model 4) and onto no mesh, and cuts
and gathers each family's tree; rank 0 writes what each case found.
Beside it the JAX reference runs once, in a subprocess with 4 host devices,
on a ``jax.sharding.Mesh`` built with Auto axes (``jax.make_mesh`` gives
Explicit axes under jax 0.9), with ``TrainConfig(warmup=2)`` so that the
parameters move from step 1 on.  Both take the same latent f32 weights
(numpy, from a seed, through ``params_from_numpy``) and the same batches,
whose masks are not all ones.  The cases:

* reduced hymba (4 query and 2 KV heads: each model rank its own heads),
  48 tokens, so that layer 1's 32-token window masks;
* reduced hymba with 5 query heads and 1 KV head: the model axis divides
  neither, so every rank computes every head, while the rules still cut
  ``wq``'s 160 columns and ``wk``/``wv``'s 32 mid-head;
* reduced xlstm (one mLSTM and one sLSTM block), its heads over the model
  axis;
* reduced whisper (2 + 2 layers over 16 frames), the frames split over the
  data axis with the rows;
* the same whisper on the ternary config (QAT): its encoder and cross K/V
  run the inference linears, as JAX's, each ternary weight quantized by
  its whole tensor's absmean (the encoder's weights gathered whole on
  every rank), its decoder the QAT linears.

Float work is f32 with TF32 off; layout work (shards and their gathers,
checkpoints) is compared bit for bit.  Tolerances, those of
``test_torch_mesh_train.py::test_mesh_step_matches_jax_jit_train_step``
for its f32 (non-QAT) config, each read on this CPU where it is used:
losses within ``RTOL`` of JAX's, relative, and grad norms within
``GRAD_RTOL``; the params after step 3 within ``PARAM_ATOL``,
elementwise; the moments within ``MOMENT_RTOL`` of each leaf's largest
|value|.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import argparse
import os
import pickle
import re
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
B, S, STEPS = 8, 48, 3
LR = 3e-4  # the peak; under TrainConfig(warmup=2) steps 0-2 take 0, lr / 2, lr
# test_torch_mesh_train.py's f32 limits (DENSE_RTOL, PARAM_ATOL and its
# MOMENT_RTOL of the f32 config), read here: losses and nll 1.7e-7 (hymba),
# params 1.4e-6, moments 9.7e-6 (xlstm's emb nu); restored steps 2.1e-7.
# The grad norms read 8.9e-7 (xlstm), as much as the port's single-device
# step reads against JAX's: xLSTM's exponential gates carry each rounding
# on.  That is within 12 % of DENSE_RTOL, so they take GRAD_RTOL, about 5
# times the reading, as the other limits are set.
RTOL = 1e-6
GRAD_RTOL = 5e-6
PARAM_ATOL = 1e-4
MOMENT_RTOL = 2e-5

CASES = {  # name: (arch, reduced_config overrides)
    "hymba": ("hymba-1.5b", {}),
    "hymba-whole-heads": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1}),
    "xlstm": ("xlstm-1.3b", {}),
    "whisper": ("whisper-large-v3", {}),
    "whisper-ternary": ("whisper-large-v3", {}),
}
TERNARY = {"whisper-ternary"}  # cases on the ternary config (W1.58-A8 QAT)
# the ternary case's limits: losses and grad norms test_torch_mesh_train.py's
# for its QAT config (its module docstring says why QAT exceeds f32
# rounding), read here 1.1e-5 and 3.3e-4 (the step after a restore onto
# (data 1, model 4)); one device reads 1.4e-5 of JAX's loss at step 0 on
# its own.  Params after step 3 read 2.7e-4 (dec_layers/mlp/w_out): where a
# gradient is rounding noise AdamW moves a weight by about the rate either
# way, so two trajectories part by up to the sum of the rates, 4.5e-4; the
# limit lies below it.  Moments read 1.2e-2 of a leaf's largest (cross/wv,
# whose gradient one device already puts 0.9 % off JAX's), about 4 times
# under the limit.
QAT_TOL = {"loss": 2e-4, "nll": 2e-4, "grad_norm": 2e-3}
QAT_PARAM_ATOL = 4e-4
QAT_MOMENT_RTOL = 5e-2


# ------------------------------------------------------------ shared data --


def numpy_family_params(cfg, seed=0):
    """Latent f32 weights in the JAX package's tree layout for a hymba,
    xlstm or encdec ``cfg`` (its leaves and shapes from ``whole_shapes``):
    norm scales, gates and the SSM's skip about 1, biases small, the SSM's
    ``dt_bias`` about -4.6 and ``a_log`` about log 1..N, matrices N(0, 1/K)."""
    from repro_torch.launch.sharding_rules import whole_shapes

    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in sorted(whole_shapes(cfg).items()):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("scale", "gate_a", "gate_s", "d_skip"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf in ("bias", "b"):
            a = 0.02 * rng.normal(size=shape)
        elif leaf == "dt_bias":
            a = -4.6 + 0.1 * rng.normal(size=shape)
        elif leaf == "a_log":
            a = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rng.normal(size=shape)
        elif leaf == "conv":
            a = 0.2 * rng.normal(size=shape)
        elif leaf in ("emb", "lm_head", "pos_dec"):
            a = 0.02 * rng.normal(size=shape)
        else:  # a matrix (..., K, N), the sLSTM's r (.., H, hd, 4hd) too
            a = rng.normal(size=shape) * shape[-2] ** -0.5
        node = tree
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = np.asarray(a, np.float32)
    return tree


def batches(cfg, n=STEPS + 1, seed=7):
    """n global batches of B x S (and an encoder-decoder's frames); row r
    of each keeps a share of its positions that grows with r."""
    rng = np.random.default_rng(seed)
    keep = np.linspace(0.3, 1.0, B)[:, None]
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < keep).astype(np.float32)}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def case_config(name):
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import QuantConfig

    arch, kw = CASES[name]
    if name in TERNARY:
        kw = dict(kw, quant=QuantConfig(mode="ternary"))
    return reduced_config(arch, **kw)


# ---------------------------------------------------------------- the ranks --


def _np_tree(tree):
    from repro_torch.common.tree import named_leaves

    return {name: t.detach().cpu().numpy().copy() for name, t in named_leaves(tree)}


def _steps(cfg, mesh, n=STEPS, state=None, start=0):
    """n steps from step ``start`` of ``cfg`` (the numpy weights, or
    ``state``) on ``mesh`` (None: one device): each step's metrics and the
    final (params, opt) of this rank."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    if state is None:
        params = params_from_numpy(numpy_family_params(cfg), cfg, device="cpu", latent=True)
        if mesh is not None:
            params = shard_params(params, cfg, mesh, train=True)
        opt = adamw_init(params)
    else:
        params, opt = state
    step = make_train_step(cfg, TrainConfig(lr=LR, warmup=2), mesh)
    hist = []
    for s, b in list(enumerate(batches(cfg)))[start:start + n]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()}, s)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params, opt


def case_step(ctx, name):
    """3 steps on (data 2, model 2); the whole params and moments gathered,
    and written by rank 0 as the case's checkpoint."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import gather_state

    mesh = ctx["meshes"]["2x2"]
    cfg = case_config(name)
    hist, params, opt = _steps(cfg, mesh)
    whole = gather_state(params, opt, cfg, mesh)
    out = {"hist": hist, "local_shapes": {n: tuple(t.shape) for n, t in _np_tree(params).items()}}
    if mesh.rank == 0:
        out.update(params=_np_tree(whole[0]), mu=_np_tree(whole[1].mu), nu=_np_tree(whole[1].nu))
        CheckpointManager(str(ctx["ckpt"] / name)).save(STEPS, whole)
    dist.barrier()  # rank 0's write is whole before the restores read it
    return out


def case_restore(ctx, name):
    """The case's (2, 2) checkpoint restored onto (data 1, model 4) and (rank
    0) onto no mesh; one more step on each."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import state_specs
    from repro_torch.train.trainer import init_train_state

    cfg = case_config(name)
    mgr = CheckpointManager(str(ctx["ckpt"] / name))
    out = {}
    for key, mesh in (("1x4", ctx["meshes"]["1x4"]), ("none", None)):
        if mesh is None and dist.get_rank() != 0:
            continue
        template = init_train_state(cfg, 0, "cpu", mesh=mesh)
        specs = state_specs(template[0], cfg, mesh) if mesh is not None else None
        state, at = mgr.restore(template, device="cpu", shardings=specs, mesh=mesh)
        out[key] = {"at": at, "hist": _steps(cfg, mesh, n=1, state=state, start=at)[0]}
    return out


def case_roundtrip(ctx):
    """Each case's tree cut by ``shard_params(train=True)`` and gathered back
    by ``gather_params`` on (2, 2) and (1, 4), byte for byte; the sharded
    global norm against the whole tree's."""
    from repro_torch.common.tree import named_leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.sharding_rules import gather_params, shard_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.trainer import replicated_axes

    out = {}
    for name in CASES:
        cfg = case_config(name)
        whole = params_from_numpy(numpy_family_params(cfg, seed=3), cfg, device="cpu", latent=True)
        for key, mesh in ctx["meshes"].items():
            local = shard_params(whole, cfg, mesh, train=True)
            back = gather_params(local, cfg, mesh, train=True)
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and a.numpy().tobytes() == b.numpy().tobytes()
                       for (_, a), (_, b) in zip(named_leaves(whole), named_leaves(back)))
            rep = replicated_axes(local, cfg, mesh)
            out[(name, key)] = {"same": same, "norm": float(global_norm(local, mesh, rep)),
                                "whole_norm": float(global_norm(whole))}
    return out


def _cases():
    return ([(f"step-{n}", lambda ctx, n=n: case_step(ctx, n)) for n in CASES]
            + [(f"restore-{n}", lambda ctx, n=n: case_restore(ctx, n)) for n in CASES]
            + [("roundtrip", case_roundtrip)])


def rank_main(rank: int, world: int, store: str, out: str, ckpt: str) -> None:
    """One rank of the test world: join, run every case, gather each case's
    result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import join_process_group, make_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    ctx = {"ckpt": Path(ckpt), "meshes": {"2x2": make_mesh((2, 2), ("data", "model")),
                                          "1x4": make_mesh((1, 4), ("data", "model"))}}
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
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_mesh_families as M
from repro.configs import reduced_config
from repro.launch.sharding_rules import params_shardings
from repro.optim.adamw import AdamWState, adamw_init
from repro.train.trainer import TrainConfig, jit_train_step

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {{}}
for name, (arch, kw) in M.CASES.items():
    cfg = reduced_config(arch, **kw)
    if name in M.TERNARY:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, mode="ternary"))
    params = jax.tree.map(jnp.asarray, M.numpy_family_params(cfg))
    opt = adamw_init(params)
    psh = params_shardings(params, cfg, mesh, train=True)
    params = jax.tree.map(jax.device_put, params, psh)
    opt = AdamWState(jax.device_put(opt.step, NamedSharding(mesh, P())),
                     jax.tree.map(jax.device_put, opt.mu, psh), jax.tree.map(jax.device_put, opt.nu, psh))
    step = jit_train_step(cfg, TrainConfig(lr=M.LR, warmup=2), mesh, jax.eval_shape(lambda: params),
                          donate=False)
    hist = []
    for s, b in enumerate(M.batches(cfg)):
        params, opt, m = step(params, opt, {{k: jnp.asarray(v) for k, v in b.items()}}, jnp.int32(s))
        hist.append({{k: float(v) for k, v in m.items()}})
        if s == M.STEPS - 1:  # the state after step 3; the 4th step is the restores' reference
            out[name] = jax.tree.map(np.asarray, {{"params": params, "mu": opt.mu, "nu": opt.nu}})
    out[name]["hist"] = hist
with open({out_path!r}, "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks and the JAX subprocess and collect both."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out, ckpt = tmp / "ranks.pkl", tmp / "ckpt"
    ranks = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(WORLD),
                               "--store", str(tmp / "store"), "--out", str(out),
                               "--ckpt", str(ckpt)],
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
    for t in threads:
        t.join()
    codes = [p.returncode for p in ranks] + [jax_proc.returncode]
    assert codes == [0] * (WORLD + 1), "\n".join(f"--- {k}:\n{v[-4000:]}" for k, v in logs.items())
    with open(out, "rb") as f:
        results = pickle.load(f)
    with open(jax_out, "rb") as f:
        jax_ref = pickle.load(f)
    return {"ranks": results, "jax": jax_ref}


def _case(world, name):
    every = world["ranks"][name]
    for r, (status, got) in enumerate(every):
        assert status == "ok", f"rank {r}, case {name}:\n{got}"
    return [got for _, got in every]


def _jax_flat(tree):
    """A JAX result tree (nested dicts of numpy) keyed as the port's names."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = t
    walk(tree, "")
    return out


def _held_metrics(got, want, name=None):
    for s, (g, w) in enumerate(zip(got, want)):
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7), s
        for key in ("loss", "nll", "grad_norm"):
            tol = GRAD_RTOL if key == "grad_norm" else RTOL
            if name in TERNARY:
                tol = QAT_TOL[key]
            assert abs(g[key] - w[key]) <= tol * abs(w[key]), (s, key, g[key], w[key])


# --------------------------------------------------------------- the world --


@pytest.mark.parametrize("name", list(CASES))
def test_family_mesh_step_matches_jax_jit_train_step(world, name):
    """Each case's 3 steps on (data 2, model 2) against JAX's
    ``jit_train_step`` on its Auto-axes mesh: every step's loss, nll and
    grad norm on every rank, then the whole params and moments gathered
    after step 3."""
    want = world["jax"][name]
    per_rank = _case(world, f"step-{name}")
    for r, got in enumerate(per_rank):
        _held_metrics(got["hist"], want["hist"][:STEPS], name)
        assert got["hist"] == per_rank[0]["hist"], f"rank {r}"  # the ranks agree exactly
    got = per_rank[0]
    for key in ("params", "mu", "nu"):
        ref = _jax_flat(want[key])
        assert sorted(got[key]) == sorted(ref), key
        for n, x in got[key].items():
            assert x.shape == ref[n].shape, (key, n)
            if key == "params":
                atol = QAT_PARAM_ATOL if name in TERNARY else PARAM_ATOL
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=atol, err_msg=n)
            else:
                scale = max(float(np.abs(ref[n]).max()), 1e-30)
                tol = QAT_MOMENT_RTOL if name in TERNARY else MOMENT_RTOL
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=tol * scale,
                                           err_msg=f"{key} {n}")


def test_whole_heads_keep_the_rules_mid_head_cut(world):
    """hymba with 5 query heads and 1 KV head on (data 2, model 2): each
    rank holds half of ``wq``'s 160 columns (two and a half heads) and of
    ``wk``'s 32 (half a head), and half of ``wo``'s rows, as the JAX rules
    cut them; the 4-head case holds two whole heads a rank."""
    whole = _case(world, "step-hymba-whole-heads")[0]["local_shapes"]
    assert whole["layers/attn/wq/w"] == (2, 64, 80) and whole["layers/attn/wk/w"] == (2, 64, 16)
    assert whole["layers/attn/wo/w"] == (2, 80, 64)
    split = _case(world, "step-hymba")[0]["local_shapes"]
    assert split["layers/attn/wq/w"] == (2, 64, 64) and split["layers/attn/wk/w"] == (2, 64, 32)


@pytest.mark.parametrize("name", list(CASES))
def test_family_checkpoint_restores_onto_another_mesh(world, name):
    """The case's (2, 2) checkpoint restored onto (data 1, model 4) and onto
    no mesh: the next step's loss, nll and grad norm follow the
    uninterrupted JAX run's fourth step."""
    want = world["jax"][name]["hist"][STEPS:]
    for r, res in enumerate(_case(world, f"restore-{name}")):
        for key in ("1x4", "none"):
            if key not in res:
                continue
            assert res[key]["at"] == STEPS, (r, key)
            _held_metrics(res[key]["hist"], want, name)


@pytest.mark.parametrize("name", list(CASES))
def test_family_shard_and_gather_round_trip_and_global_norm(world, name):
    """Each case's tree cut and gathered back on (2, 2) and (1, 4), byte for
    byte; the sharded global norm equals the whole tree's."""
    for r, got in enumerate(_case(world, "roundtrip")):
        for key in ("2x2", "1x4"):
            g = got[(name, key)]
            assert g["same"], (r, key)
            assert g["norm"] == pytest.approx(g["whole_norm"], rel=1e-6), (r, key)


# --------------------------------------------------------- single process --


class _StubMesh:
    """A mesh of ``shape`` seen from coordinate 0 of every axis, with no
    process group: enough for the rules and the cuts."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def coordinate(self, axis):
        return 0


FAMILY_ARCHS = ("hymba-1.5b", "xlstm-1.3b", "whisper-large-v3")


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_specs_equal_jax_params_shardings(arch, train):
    """At full width and reduced, on (2, 2), (1, 4) and (4, 2), for training
    (FSDP x TP) and serving (``train=False``: no FSDP axis): every leaf's
    whole shape (``whole_shapes``) equals the JAX ``eval_shape`` tree's,
    and its spec from the port's ``params_shardings`` and from
    ``leaf_specs`` of a rank's slice equals JAX's ``params_shardings``
    (sanitized: hymba-1.5b's 25 and 5 heads still split ``wq``, ``wk`` and
    ``wv`` over every model axis, mid-head)."""
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget, reduced_config as jreduced
    from repro.launch.sharding_rules import eval_shape_params
    from repro.launch.sharding_rules import params_shardings as jshardings

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.sharding_rules import (
        leaf_specs,
        local_slice,
        params_shardings,
        whole_shapes,
    )

    for full in (True, False):
        cfg = get_config(arch) if full else reduced_config(arch)
        jcfg = jget(arch) if full else jreduced(arch)
        abstract = eval_shape_params(jcfg)
        jflat = _jax_flat(abstract)
        shapes = whole_shapes(cfg)
        assert {n: tuple(a.shape) for n, a in jflat.items()} == shapes, (arch, full)
        meta = {}
        for n, shp in shapes.items():
            node = meta
            *path, last = n.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = torch.empty(shp, device="meta")
        for dims in ((2, 2), (1, 4), (4, 2)):
            jmesh = AbstractMesh(dims, ("data", "model"))
            want = {n: tuple(s.spec) + (None,) * (len(shapes[n]) - len(s.spec))
                    for n, s in _jax_flat(jshardings(abstract, jcfg, jmesh, train=train)).items()}
            mesh = _StubMesh(dict(zip(("data", "model"), dims)))
            got = _jax_flat(params_shardings(meta, cfg, mesh, train=train))
            assert {n: tuple(s) for n, s in got.items()} == want, (arch, full, dims)
            local = {}
            for n, t in _jax_flat(meta).items():
                node = local
                *path, last = n.split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[last] = local_slice(t, got[n], mesh)
            specs = leaf_specs(local, cfg, mesh, train=train)
            assert {n: tuple(s) for n, s in specs.items()} == want, (arch, full, dims)
    if arch == "hymba-1.5b":  # the mid-head cut at full width
        cfg = get_config(arch)
        assert cfg.num_heads % 2 and cfg.num_kv_heads % 2
        assert want["layers/attn/wq/w"] == (None, "data" if train else None, "model")


def _world_of_one(tmp_path):
    from repro_torch.launch.mesh import join_process_group

    join_process_group("gloo", device_type="cpu", init_method=f"file://{tmp_path / 'store1'}",
                       rank=0, world_size=1, timeout_s=60)


def test_one_rank_family_steps_equal_the_no_mesh_steps_bit_for_bit(tmp_path):
    """On a (data 1, model 1) world of one every collective is a group of
    one: each case's 3 mesh steps are its no-mesh steps, bit for bit
    (losses, grad norms, params and both moments).  On one CPU thread (the
    embedding lookup's backward adds repeated tokens' rows in the threads'
    order)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _world_of_one(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_host_mesh()
        for name in CASES:
            cfg = case_config(name)
            got, p, o = _steps(cfg, mesh)
            want, p1, o1 = _steps(cfg, None)
            assert got == want, name
            for a, b in ((p, p1), (o.mu, o1.mu), (o.nu, o1.nu)):
                for (n, x), y in zip(_np_tree(a).items(), _np_tree(b).values()):
                    np.testing.assert_array_equal(x, y, err_msg=f"{name} {n}")
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()


BACKWARD_RANKS = 2


def backward_rank(rank: int, store: str, out: str) -> None:
    """One rank of a 2-rank gloo group: the gradients of each gathered or
    summed leaf against autograd over the whole tensors (every rank
    computes that reference itself), and the wrong backward's."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.layers import collectives as C

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=BACKWARD_RANKS)
    group = dist.group.WORLD
    k = BACKWARD_RANKS
    g = torch.Generator().manual_seed(0)
    w_whole = torch.randn(6, 8, generator=g, dtype=torch.float64)
    x = torch.randn(5, 6, generator=g, dtype=torch.float64)
    mine = slice(rank * 4, rank * 4 + 4)  # the columns of the weight this rank stores
    results = {}

    def grad_of(loss, leaf):
        return torch.autograd.grad(loss, leaf)[0]

    def ref_grad(fn):  # the whole weight, the global loss summed over the ranks' terms
        w = w_whole.clone().requires_grad_()
        return grad_of(sum(fn(w, r) for r in range(k)), w)[:, mine].clone()

    # each rank uses its own part of the gathered weight, which is not the
    # part it stores (as the SSM's w_in: x | z cut contiguously, a rank's
    # channels of each half used): the summing reduce-scatter backward
    # (fsdp_gather) is right, the own slice misses the other rank's share
    def own(w, r):
        return ((x @ torch.cat([w[:, 2 * r:2 * r + 2], w[:, 4 + 2 * r:6 + 2 * r]], 1)) ** 2).sum()

    for how, gather in (("sum", C.fsdp_gather), ("same", C.gather_replicated)):
        shard = w_whole[:, mine].clone().requires_grad_()
        results[("own columns", how)] = (grad_of(own(gather(shard, group, dim=1), rank), shard),
                                         ref_grad(own))
    # every rank uses all of it alike (one global term): the own-slice backward
    # (gather_replicated) is right, the summing one k times too large
    alike = lambda w, r: ((x @ w) ** 2).sum() / k  # noqa: E731  (k alike terms: one global term)
    for how, gather in (("sum", C.fsdp_gather), ("same", C.gather_replicated)):
        shard = w_whole[:, mine].clone().requires_grad_()
        results[("alike", how)] = (grad_of(alike(gather(shard, group, dim=1), rank) * k, shard),
                                   ref_grad(alike) * 1.0)
    # sum_shared: a partial contraction over this rank's rows, each rank using
    # the sum for its own columns; slice_replicated: a replicated vector cut
    # to this rank's part
    v_whole = torch.randn(8, generator=g, dtype=torch.float64)
    rows = slice(rank * 3, rank * 3 + 3)
    xs = x[:, rows].clone().requires_grad_()
    tot = C.sum_shared(xs @ w_whole[rows], group)
    got = grad_of((tot[:, mine] ** 2).sum(), xs)
    xw = x.clone().requires_grad_()
    want = grad_of(sum(((xw @ w_whole)[:, r * 4:r * 4 + 4] ** 2).sum() for r in range(k)), xw)
    results[("sum_shared", "sum")] = (got, want[:, rows])
    v = v_whole.clone().requires_grad_()
    got = grad_of((C.slice_replicated(v, group, dim=0) * torch.arange(4.0, dtype=torch.float64)
                   ** (rank + 1)).sum(), v)
    vw = v_whole.clone().requires_grad_()
    want = grad_of(sum((vw[r * 4:r * 4 + 4] * torch.arange(4.0, dtype=torch.float64) ** (r + 1)).sum()
                       for r in range(k)), vw)
    results[("slice_replicated", "same")] = (got, want)
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump({key: (a.numpy(), b.numpy()) for key, (a, b) in results.items()}, f)


def test_gathered_leaves_backwards_on_a_two_rank_group(tmp_path):
    """On a 2-rank gloo group: a gathered leaf whose ranks use their own
    parts takes the summing reduce-scatter backward (``fsdp_gather``), one
    every rank uses alike its own slice (``gather_replicated``); the wrong
    choice gives gradients 2 times too small or too large.  ``sum_shared``
    and ``slice_replicated`` give autograd's gradients over the whole
    tensors."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "grads"
    procs = [subprocess.Popen([sys.executable, __file__, "--backward-rank", str(r),
                               "--store", str(tmp_path / "store"), "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(BACKWARD_RANKS)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * BACKWARD_RANKS, "\n".join(logs)
    for r in range(BACKWARD_RANKS):
        with open(f"{out}.{r}", "rb") as f:
            res = pickle.load(f)
        np.testing.assert_allclose(*res[("own columns", "sum")], rtol=1e-12, err_msg=str(r))
        np.testing.assert_allclose(*res[("alike", "same")], rtol=1e-12, err_msg=str(r))
        got, want = res[("own columns", "same")]
        assert not np.allclose(got, want), r
        got, want = res[("alike", "sum")]
        np.testing.assert_allclose(got, 2 * want, rtol=1e-12, err_msg=str(r))
        np.testing.assert_allclose(*res[("sum_shared", "sum")], rtol=1e-12, err_msg=str(r))
        np.testing.assert_allclose(*res[("slice_replicated", "same")], rtol=1e-12, err_msg=str(r))


# --------------------------------------------------------- the launcher --


CLI = ["--arch", "hymba-1.5b", "--reduced", "--batch", "4", "--seq", "48", "--steps", "3",
       "--log-every", "1", "--device", "cpu"]


def _printed_losses(text):
    return {int(s): float(v) for s, v in re.findall(r"step\s+(\d+)\s+loss\s+([-\d.]+)", text)}


def test_train_cli_trains_hymba_on_two_ranks_over_the_launcher(capsys):
    """``launch.train --mesh host`` on 2 ranks started by
    ``torch.distributed.run`` ((data 2, model 1): FSDP over the 2 ranks),
    reduced hymba on the CPU: rank 0 prints the ``--mesh none`` run's
    losses."""
    from repro_torch.launch import train as train_cli

    assert train_cli.main(CLI) == 0
    want = _printed_losses(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    run = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
                        "--mesh", "host", "--backend", "gloo"], env=env, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert _printed_losses(run.stdout) == want and sorted(want) == [0, 1, 2], run.stdout


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the mesh family tests' worlds")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--backward-rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt")
    a = ap.parse_args()
    if a.backward_rank is not None:
        backward_rank(a.backward_rank, a.store, a.out)
    else:
        rank_main(a.rank, a.world, a.store, a.out, a.ckpt)
