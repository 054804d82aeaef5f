"""Training on a mesh of processes: the port's FSDP x TP train step, its
checkpoints across meshes and the error-feedback compressed gradient mean,
against the JAX package's ``jit_train_step`` and ``optim.compression`` and
against the port's own single-device step, on the CPU over gloo.

One world of 4 ranks is started for the module (each rank a process running
this file, its store in a file under the test's temporary directory); it
builds a mesh for each case in turn ((data 2, model 2), (pod 2, data 1,
model 2), (data 1, model 4), (pod 4)) and rank 0 writes what each case
found.  Beside it the JAX reference runs once, in a subprocess with 4 host
devices, on ``jax.sharding.Mesh``es built with Auto axes (``jax.make_mesh``
gives Explicit axes under jax 0.9, on which the JAX package's own mesh test
fails), with ``TrainConfig(warmup=2)`` so that the parameters move from
step 1 on (the learning rate at step 0 is 0, which would hide a wrong
gradient reduction in the parameters).  Both take the same latent f32
weights (numpy, from a seed) and the same batches, whose masks are not all
ones, so that a microbatch's mean depends on which rows it holds.

Float work is f32 with TF32 off; integer and layout work (shards and their
gathers, checkpoints, int8 payloads) is compared bit for bit.

Tolerances (each read on this CPU and stated where it is used):
* the dense config (reduced qwen2.5-14b: GQA, biases, untied head): losses
  and grad norms within ``DENSE_RTOL`` of JAX's, relative.  A model rank
  sums a row-parallel product from two partial products, another order
  of f32 sums than one device's.
* the ternary config (reduced bitnet-730m: QAT, tied head): within
  ``QAT_RTOL``.  There a residual that moved by an ulp can move an
  activation across an int8 rounding step of the next layer's fake
  quantizer, and each such step moves the loss by about 1e-5 of itself;
  the steps carry it on.
* parameters after step 3: within ``PARAM_ATOL`` of JAX's, elementwise.
  AdamW's update is m / sqrt(v) times the learning rate, so where a
  gradient is rounding noise around 0 (a key bias: softmax ignores a shift
  common to every key) the update's sign is the noise's, and two
  trajectories may part by up to the sum of the learning rates; the limit
  lies below that sum.
* moments: within ``MOMENT_RTOL`` of each leaf's largest |value|.
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
B, S, STEPS = 8, 32, 3
TOY_STEPS = 300
LR = 3e-4  # the peak; under TrainConfig(warmup=2) steps 0-2 take 0, lr / 2, lr
# the limits against JAX, each about 5-10 times the largest reading on this
# CPU (the module docstring says why each exceeds f32 rounding):
DENSE_RTOL = 1e-6  # read: 1.7e-7 (losses), 1.1e-7 (grad norms)
# read: 2.3e-5 and 2.8e-4 on the step after a restore onto (data 1, model 4)
QAT_RTOL = {"loss": 2e-4, "grad_norm": 2e-3}
PARAM_ATOL = 1e-4  # read: 1.75e-5 (bitnet), 7.8e-6 (qwen); the sum of the rates is 4.5e-4
MOMENT_RTOL = {"qwen2.5-14b": 2e-5, "bitnet-730m": 1e-2}  # read: 2.5e-6, 1.9e-3
COMPRESSED_ATOL = 1e-6  # read: 0


# ------------------------------------------------------------ shared data --


def numpy_train_params(cfg, seed=0):
    """Latent f32 weights in the JAX package's tree layout (layer-stacked),
    biases and an untied head where the config has them."""
    rng = np.random.default_rng(seed)
    L, d, h, hkv, hd, f = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff)

    def lin(k, n, bias=False):
        out = {"w": (rng.normal(size=(L, k, n)) * k**-0.5).astype(np.float32)}
        if bias:
            out["b"] = (rng.normal(size=(L, n)) * 0.02).astype(np.float32)
        return out

    def norm(*shape):
        return {"scale": (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)}

    bias = cfg.qkv_bias
    tree = {
        "emb": (rng.normal(size=(cfg.padded_vocab(), d)) * 0.02).astype(np.float32),
        "layers": {
            "attn": {"wq": lin(d, h * hd, bias), "wk": lin(d, hkv * hd, bias),
                     "wv": lin(d, hkv * hd, bias), "wo": lin(h * hd, d)},
            "ln1": norm(L, d), "ln2": norm(L, d),
            "mlp": {"w_gate": lin(d, f), "w_up": lin(d, f), "w_down": lin(f, d)},
        },
        "ln_f": norm(d),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (rng.normal(size=(d, cfg.padded_vocab())) * 0.02).astype(np.float32)
    return tree


def batches(cfg, n=STEPS + 1, seed=7):
    """n global batches of B x S; row r of each keeps a share of its
    positions that grows with r, so the rows' mask sums differ."""
    rng = np.random.default_rng(seed)
    keep = np.linspace(0.3, 1.0, B)[:, None]
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < keep).astype(np.float32)} for _ in range(n)]


def toy_data():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    return x, (x @ w_true).astype(np.float32)


def compress_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    grads = {"a": (rng.normal(size=(16, 8)) * 10.0 ** (rank - 2)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                   "z": np.zeros((3, 2), np.float32)}}
    err = {"a": (rng.normal(size=(16, 8)) * 1e-3).astype(np.float32),
           "b": {"c": (rng.normal(size=(5,)) * 1e-3).astype(np.float32),
                 "z": np.zeros((3, 2), np.float32)}}
    return grads, err


CASES = {  # name: (arch, mesh shape, mesh axes, microbatches)
    "step-bitnet": ("bitnet-730m", (2, 2), ("data", "model"), 1),
    "step-qwen": ("qwen2.5-14b", (2, 2), ("data", "model"), 1),
    "microbatch-qwen": ("qwen2.5-14b", (2, 2), ("data", "model"), 2),
    "pod-qwen": ("qwen2.5-14b", (2, 1, 2), ("pod", "data", "model"), 1),
}


# ---------------------------------------------------------------- the ranks --


def _np_tree(tree):
    from repro_torch.common.tree import named_leaves

    return {name: t.detach().cpu().numpy().copy() for name, t in named_leaves(tree)}


def _steps(arch, mesh, mb, n=STEPS, state=None, start=0):
    """n steps from step ``start`` of ``arch`` (the numpy weights, or
    ``state``) on ``mesh`` (None: one device): each step's metrics and the
    final (params, opt) of this rank."""
    from repro_torch.configs import reduced_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = reduced_config(arch)
    if state is None:
        params = params_from_numpy(numpy_train_params(cfg), cfg, device="cpu", latent=True)
        if mesh is not None:
            params = shard_params(params, cfg, mesh, train=True)
        opt = adamw_init(params)
    else:
        params, opt = state
    step = make_train_step(cfg, TrainConfig(lr=LR, warmup=2, microbatches=mb), mesh)
    hist = []
    for s, b in list(enumerate(batches(cfg)))[start:start + n]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()}, s)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params, opt


def case_step(ctx, name):
    """3 steps on the case's mesh; the whole params and moments gathered."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import gather_state

    arch, shape, axes, mb = CASES[name]
    mesh = make_mesh(shape, axes)
    hist, params, opt = _steps(arch, mesh, mb)
    cfg = ctx["cfgs"][arch]
    whole = gather_state(params, opt, cfg, mesh)
    out = {"hist": hist}
    if mesh.rank == 0:
        out.update(params=_np_tree(whole[0]), mu=_np_tree(whole[1].mu), nu=_np_tree(whole[1].nu))
    if name == "step-bitnet":  # rank 0 writes the whole tree, as the train CLI does
        from repro_torch.checkpoint.manager import CheckpointManager

        if mesh.rank == 0:
            CheckpointManager(ctx["ckpt"]).save(STEPS, whole)
        ctx["bitnet_mesh"] = mesh
    if name == "pod-qwen":
        import torch.distributed as dist

        out["batch_group"] = dist.get_process_group_ranks(mesh.group(("pod", "data")))
    return out


def case_restore(ctx):
    """The (2, 2) run's checkpoint restored onto a (data 1, model 4) mesh
    and (rank 0) onto no mesh; one more step on each."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import state_specs
    from repro_torch.train.trainer import init_train_state

    dist.barrier()  # rank 0's write is whole
    cfg = ctx["cfgs"]["bitnet-730m"]
    mgr = CheckpointManager(ctx["ckpt"])
    out = {}
    for key, mesh in (("1x4", make_mesh((1, 4), ("data", "model"))), ("none", None)):
        if mesh is None and dist.get_rank() != 0:
            continue
        template = init_train_state(cfg, 0, "cpu", mesh=mesh)
        specs = state_specs(template[0], cfg, mesh) if mesh is not None else None
        state, at = mgr.restore(template, device="cpu", shardings=specs, mesh=mesh)
        out[key] = {"at": at, "hist": _steps("bitnet-730m", mesh, 1, n=1, state=state, start=at)[0]}
    return out


def case_roundtrip(ctx):
    """shard_params(train=True) then gather_params: the whole tree back,
    byte for byte; global_norm over the shards against the whole tree's."""
    from repro_torch.common.tree import named_leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding_rules import gather_params, shard_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.trainer import replicated_axes

    out = {}
    for arch in ("bitnet-730m", "qwen2.5-14b"):
        cfg = ctx["cfgs"][arch]
        whole = params_from_numpy(numpy_train_params(cfg, seed=3), cfg, device="cpu", latent=True)
        mesh = ctx["bitnet_mesh"]
        local = shard_params(whole, cfg, mesh, train=True)
        back = gather_params(local, cfg, mesh, train=True)
        same = all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                   for (_, a), (_, b) in zip(named_leaves(whole), named_leaves(back)))
        rep = replicated_axes(local, cfg, mesh)
        out[arch] = {"same": same, "norm": float(global_norm(local, mesh, rep)),
                     "whole_norm": float(global_norm(whole)),
                     "local_shapes": {n: tuple(t.shape) for n, t in named_leaves(local)}}
    return out


def case_compress(ctx):
    """The compressed mean over a (pod 4) mesh, and the JAX test's toy
    regression: 300 steps with the int8 wire and 300 exact ones."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (
        compressed_dp_grads,
        compressed_mean_over_axis,
        init_error_feedback,
    )

    mesh = make_mesh((4,), ("pod",))
    g, e = compress_inputs(mesh.rank)
    tt = lambda tree: {k: (tt(v) if isinstance(v, dict) else torch.from_numpy(v))  # noqa: E731
                       for k, v in tree.items()}
    mean, err = compressed_mean_over_axis(tt(g), tt(e), mesh, "pod")
    x, y = (torch.from_numpy(a) for a in toy_data())

    def loss_fn(w, batch):
        xb, yb = batch
        return torch.mean((xb @ w - yb) ** 2)

    grads_fn = compressed_dp_grads(loss_fn, mesh)
    w_c = torch.zeros(8)
    ef = init_error_feedback(w_c)
    w_e = torch.zeros(8)
    traj = []
    for _ in range(TOY_STEPS):
        _, g_c, ef = grads_fn(w_c, ef, (x, y))
        w_c = w_c - 0.05 * g_c
        w_e = w_e.requires_grad_()
        (g_e,) = torch.autograd.grad(loss_fn(w_e, (x, y)), w_e)
        w_e = (w_e - 0.05 * g_e).detach()
        traj.append(w_c.numpy().copy())
    return {"mean": _np_tree(mean), "err": _np_tree(err), "traj": np.stack(traj),
            "final_c": float(loss_fn(w_c, (x, y))), "final_e": float(loss_fn(w_e, (x, y)))}


FAULT_CLI = ["--arch", "bitnet-730m", "--reduced", "--device", "cpu", "--mesh", "host",
             "--backend", "gloo", "--steps", "6", "--batch", "4", "--seq", "16",
             "--ckpt-every", "2", "--log-every", "100"]


def case_fault(ctx):
    """The train CLI's fault loop on the world's (data 4, model 1) host
    mesh, three runs of 6 steps with a checkpoint every 2: a clean one;
    "all", every rank raising before step 3's collectives; "some", rank 2
    alone raising after step 3 (its collectives done), then rank 0 alone
    raising as it writes the step-4 checkpoint.  Each fault restores the
    step-2 checkpoint on every rank and replays from there."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as LT

    rank = dist.get_rank()
    real_step, real_save = LT.make_train_step, CheckpointManager.save_async
    out = {}
    for key in ("clean", "all", "some"):
        fired = set()

        def make_step(cfg, tcfg, mesh=None, key=key, fired=fired):
            step_fn = real_step(cfg, tcfg, mesh)

            def step(params, opt, batch, s):
                if key == "all" and s == 3 and "all" not in fired:
                    fired.add("all")
                    raise RuntimeError("injected fault")
                got = step_fn(params, opt, batch, s)
                if key == "some" and rank == 2 and s == 3 and "step" not in fired:
                    fired.add("step")
                    raise RuntimeError("injected fault")
                return got
            return step

        def save_async(self, step, tree, key=key, fired=fired):
            if key == "some" and step == 4 and "save" not in fired:
                fired.add("save")
                raise OSError("injected checkpoint fault")
            return real_save(self, step, tree)

        text = io.StringIO()
        LT.make_train_step, CheckpointManager.save_async = make_step, save_async
        try:
            with contextlib.redirect_stdout(text):
                res = LT.train(LT.parse_args(FAULT_CLI + ["--ckpt-dir", f"{ctx['ckpt']}_{key}"]))
        finally:
            LT.make_train_step, CheckpointManager.save_async = real_step, real_save
        out[key] = {"hist": res.history, "step": res.step, "out": text.getvalue()}
    return out


def _cases():
    cases = [(name, lambda ctx, n=name: case_step(ctx, n)) for name in CASES]
    return cases + [("restore", case_restore), ("roundtrip", case_roundtrip),
                    ("compress", case_compress), ("fault", case_fault)]


def rank_main(rank: int, world: int, store: str, out: str, ckpt: str) -> None:
    """One rank of the test world: join, run every case, gather each case's
    result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import join_process_group

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    ctx = {"ckpt": ckpt, "cfgs": {a: reduced_config(a) for a in ("bitnet-730m", "qwen2.5-14b")}}
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
import pickle, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_mesh_train as M
from repro.checkpoint.manager import CheckpointManager
from repro.common.compat import shard_map
from repro.configs import reduced_config
from repro.launch.sharding_rules import params_shardings
from repro.optim.adamw import AdamWState, adamw_init
from repro.optim.compression import compressed_dp_grads, compressed_mean_over_axis, init_error_feedback
from repro.train.trainer import TrainConfig, jit_train_step

devs = np.array(jax.devices())
meshes = {{(2, 2): Mesh(devs.reshape(2, 2), ("data", "model")),
          (2, 1, 2): Mesh(devs.reshape(2, 1, 2), ("pod", "data", "model"))}}

def state(cfg, mesh):
    params = jax.tree.map(jnp.asarray, M.numpy_train_params(cfg))
    opt = adamw_init(params)
    if mesh is not None:
        psh = params_shardings(params, cfg, mesh, train=True)
        params = jax.tree.map(jax.device_put, params, psh)
        opt = AdamWState(jax.device_put(opt.step, NamedSharding(mesh, P())),
                         jax.tree.map(jax.device_put, opt.mu, psh),
                         jax.tree.map(jax.device_put, opt.nu, psh))
    return params, opt

def run(cfg, mesh, mb, params, opt, lo, hi):
    step = jit_train_step(cfg, TrainConfig(lr=M.LR, warmup=2, microbatches=mb), mesh,
                          jax.eval_shape(lambda: params), donate=False)
    hist = []
    for s, b in list(enumerate(M.batches(cfg)))[lo:hi]:
        params, opt, m = step(params, opt, {{k: jnp.asarray(v) for k, v in b.items()}}, jnp.int32(s))
        hist.append({{k: float(v) for k, v in m.items()}})
    return hist, params, opt

out = {{}}
for name, (arch, shape, axes, mb) in M.CASES.items():
    cfg = reduced_config(arch)
    hist, params, opt = run(cfg, meshes[shape], mb, *state(cfg, meshes[shape]), 0, M.STEPS)
    out[name] = {{"hist": hist, "params": params, "mu": opt.mu, "nu": opt.nu}}
    out[name] = jax.tree.map(np.asarray, out[name])
    if name == "step-bitnet":  # the next step after JAX's own save and restore
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(M.STEPS, (params, opt))
            (p2, o2), at = mgr.restore(jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), (params, opt)))
            out["restore"] = {{"at": at, "hist": run(cfg, None, 1, p2, o2, at, at + 1)[0]}}

mp = Mesh(devs, ("pod",))
ins = [M.compress_inputs(r) for r in range(4)]
G = jax.tree.map(lambda *xs: jnp.stack(xs), *[i[0] for i in ins])
E = jax.tree.map(lambda *xs: jnp.stack(xs), *[i[1] for i in ins])
def local(g, e):
    g, e = jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e)
    mean, err = compressed_mean_over_axis(g, e, "pod")
    return jax.tree.map(lambda x: x[None], mean), jax.tree.map(lambda x: x[None], err)
f = jax.jit(shard_map(local, mesh=mp, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
                      check_vma=False))
mean, err = f(G, E)
out["compress"] = {{"mean": jax.tree.map(np.asarray, mean), "err": jax.tree.map(np.asarray, err)}}

X, y = (jnp.asarray(a) for a in M.toy_data())
def loss_fn(w, batch):
    xb, yb = batch
    return jnp.mean((xb @ w - yb) ** 2)
grads_fn = jax.jit(compressed_dp_grads(loss_fn, mp, batch_spec=(P("pod"), P("pod"))))
w_c = jnp.zeros((8,), jnp.float32); e = init_error_feedback(w_c); traj = []
for _ in range(M.TOY_STEPS):
    _, g_c, e = grads_fn(w_c, e, (X, y))
    w_c = w_c - 0.05 * g_c
    traj.append(np.asarray(w_c))
out["toy"] = {{"traj": np.stack(traj), "final_c": float(loss_fn(w_c, (X, y)))}}
with open({out_path!r}, "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks and the JAX subprocess and collect both."""
    tmp = tmp_path_factory.mktemp("mesh_train")
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
    return {"ranks": results, "jax": jax_ref, "ckpt": ckpt}


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


def _held_metrics(got, want, arch):
    for s, (g, w) in enumerate(zip(got, want)):
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7), s
        for key in ("loss", "grad_norm"):
            tol = DENSE_RTOL if arch == "qwen2.5-14b" else QAT_RTOL[key]
            assert abs(g[key] - w[key]) <= tol * abs(w[key]), (s, key, g[key], w[key])


# --------------------------------------------------------- single process --


def test_quant_int8_payloads_equal_jitted_jax_bit_for_bit():
    """The int8 payload and f32 scale of every tensor equal ``jax.jit`` of
    the JAX ``_quant_int8`` (an unjitted call rounds the scale otherwise)."""
    import jax
    import jax.numpy as jnp

    from repro.optim.compression import _quant_int8 as jq

    from repro_torch.optim.compression import _quant_int8

    f = jax.jit(jq)
    rng = np.random.default_rng(0)
    for i in range(300):
        x = (rng.normal(size=(7, 33)) * 10.0 ** rng.uniform(-9, 4)).astype(np.float32)
        if i == 0:
            x[:] = 0
        if i == 1:
            x[3, 5] = 127.0 * 3.0
        q, s = f(jnp.asarray(x))
        tq, ts = _quant_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q), err_msg=str(i))
        assert ts.numpy().tobytes() == np.asarray(s).tobytes(), i


def _world_of_one(tmp_path):
    from repro_torch.launch.mesh import join_process_group

    join_process_group("gloo", device_type="cpu", init_method=f"file://{tmp_path / 'store1'}",
                       rank=0, world_size=1, timeout_s=60)


def test_one_rank_mesh_step_equals_the_no_mesh_step_bit_for_bit(tmp_path):
    """On a (data 1, model 1) world of one every collective is a group of
    one: the mesh step is the no-mesh step, bit for bit (losses, grad
    norms, params and both moments after 3 steps).  On one CPU thread: the
    embedding lookup's backward (an index-add) adds repeated tokens' rows in
    the threads' order, which differs from run to run with or without a
    mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _world_of_one(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_host_mesh()
        for arch in ("bitnet-730m", "qwen2.5-14b"):
            got, p, o = _steps(arch, mesh, 1)
            want, p1, o1 = _steps(arch, None, 1)
            assert got == want, arch
            for a, b in ((p, p1), (o.mu, o1.mu), (o.nu, o1.nu)):
                for (n, x), y in zip(_np_tree(a).items(), _np_tree(b).values()):
                    np.testing.assert_array_equal(x, y, err_msg=f"{arch} {n}")
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()


CLI = ["--arch", "bitnet-730m", "--reduced", "--batch", "4", "--seq", "32", "--steps", "3",
       "--log-every", "1", "--device", "cpu"]


def _printed_losses(text):
    return {int(s): float(v) for s, v in re.findall(r"step\s+(\d+)\s+loss\s+([-\d.]+)", text)}


def test_train_cli_on_a_mesh_of_one_and_its_refusals(tmp_path, capsys):
    """``--mesh host`` on a world of one prints the ``--mesh none`` run's
    losses and restores its own checkpoint; ``--mesh single`` raises that
    the world lacks 256 ranks; a mesh needs a backend; an MoE arch on
    ``--mesh host`` prints its ``--mesh none`` losses too."""
    from repro_torch.launch import train as train_cli

    ck = str(tmp_path / "ck")
    assert train_cli.main(CLI) == 0
    want = _printed_losses(capsys.readouterr().out)
    mesh = ["--mesh", "host", "--backend", "gloo"]
    assert train_cli.main(CLI + mesh + ["--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    text = capsys.readouterr().out
    assert _printed_losses(text) == want and sorted(want) == [0, 1, 2], text
    assert train_cli.main(CLI[:-6] + ["--steps", "4", "--log-every", "1", "--device", "cpu"]
                          + mesh + ["--ckpt-dir", ck, "--restore"]) == 0
    assert "[restore] resumed from step 3 (mesh=host)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        train_cli.main(CLI + ["--mesh", "single", "--backend", "gloo"])
    with pytest.raises(ValueError, match="needs --backend"):
        train_cli.main(CLI + ["--mesh", "host"])
    moe = ["--arch", "granite-moe-3b-a800m"] + CLI[2:]
    assert train_cli.main(moe) == 0
    want = _printed_losses(capsys.readouterr().out)
    assert train_cli.main(moe + mesh) == 0
    text = capsys.readouterr().out
    assert _printed_losses(text) == want and sorted(want) == [0, 1, 2], text
    import torch.distributed as dist

    assert not dist.is_initialized()  # each run left the world it made


def test_train_mesh_example_over_the_launcher():
    """The documented way to start the ranks: ``torch.distributed.run`` with
    4 processes and the backend named, reduced bitnet-730m on the CPU;
    rank 0's losses and grad norms match the single-device step's."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    run = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m", "repro_torch.examples.train_mesh",
                        "--backend", "gloo", "--device", "cpu", "--reduced", "--check"],
                       env=env, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "match the single-device step's" in run.stdout
    # a quarter of the 1.03 MiB tree's params (the norms are whole on each rank)
    assert run.stdout.count("params 0.35 MiB, moments 0.69 MiB") == 4


# --------------------------------------------------------------- the world --


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_jax_jit_train_step(world, name):
    """Each case's 3 steps against JAX's ``jit_train_step`` on its Auto-axes
    mesh: every step's loss and grad norm on every rank, then the whole
    params and moments gathered after step 3."""
    arch = CASES[name][0]
    want = world["jax"][name]
    per_rank = _case(world, name)
    for r, got in enumerate(per_rank):
        _held_metrics(got["hist"], want["hist"], arch)
        assert got["hist"] == per_rank[0]["hist"], f"rank {r}"  # the ranks agree exactly
    got = per_rank[0]
    for key in ("params", "mu", "nu"):
        ref = _jax_flat(want[key])
        assert sorted(got[key]) == sorted(ref), key
        for n, x in got[key].items():
            assert x.shape == ref[n].shape, (key, n)
            if key == "params":
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=PARAM_ATOL, err_msg=n)
            else:
                scale = max(float(np.abs(ref[n]).max()), 1e-30)
                np.testing.assert_allclose(x, ref[n], rtol=0, atol=MOMENT_RTOL[arch] * scale,
                                           err_msg=f"{key} {n}")
    if name == "pod-qwen":  # the ("pod", "data") batch group: ranks that differ in pod only
        assert [g["batch_group"] for g in per_rank] == [[0, 2], [1, 3], [0, 2], [1, 3]]


def test_microbatches_follow_jax_grouping(world):
    """With microbatches=2 each microbatch holds JAX's rows (rows 0-3, then
    4-7, split over the data ranks), so its mean runs over their mask: the
    losses follow JAX's, and differ from the one-microbatch run's, whose
    mean runs over all 8 rows' mask."""
    mb = _case(world, "microbatch-qwen")[0]["hist"]
    one = _case(world, "step-qwen")[0]["hist"]
    assert abs(mb[0]["loss"] - one[0]["loss"]) > 100 * DENSE_RTOL * abs(one[0]["loss"])


def test_shard_and_gather_round_trip_and_global_norm(world):
    for r, got in enumerate(_case(world, "roundtrip")):
        for arch, g in got.items():
            assert g["same"], (r, arch)
            assert g["norm"] == pytest.approx(g["whole_norm"], rel=1e-6), (r, arch)
    local = _case(world, "roundtrip")[0]["bitnet-730m"]["local_shapes"]
    assert local["emb"] == (128, 64) and local["layers/attn/wq/w"] == (2, 64, 64)
    assert local["layers/attn/wo/w"] == (2, 64, 64) and local["ln_f/scale"] == (128,)


def test_mesh_checkpoint_is_the_single_process_format_and_restores_elsewhere(world, tmp_path):
    """The (2, 2) run's checkpoint holds the arrays a single-process save of
    the gathered tree holds, byte for byte (same names, dtypes, shapes and
    bytes); JAX's ``CheckpointManager`` restores it to the gathered values;
    restored onto a (data 1, model 4) mesh and onto no mesh, the next
    step's loss follows JAX's next step after its own restore."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.optim.adamw import AdamWState as JAdamWState

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import AdamWState

    got = _case(world, "step-bitnet")[0]
    to_t = lambda flat: {n: torch.from_numpy(v) for n, v in flat.items()}  # noqa: E731

    def nest(flat):
        out = {}
        for n, v in flat.items():
            *path, leaf = n.split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
        return out

    whole = (nest(to_t(got["params"])),
             AdamWState(torch.tensor(STEPS, dtype=torch.int32), nest(to_t(got["mu"])),
                        nest(to_t(got["nu"]))))
    CheckpointManager(str(tmp_path)).save(STEPS, whole)
    name = f"step_{STEPS:08d}/arrays.npz"
    with np.load(world["ckpt"] / name) as a, np.load(tmp_path / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), whole[0])
    jopt = JAdamWState(jnp.zeros((), jnp.int32), template, template)
    (jp, jo), at = JCheckpointManager(str(world["ckpt"])).restore((template, jopt))
    assert at == STEPS and int(jo[0]) == STEPS
    for n, v in got["params"].items():
        np.testing.assert_array_equal(np.asarray(_jax_flat(jp)[n]), v)
    want = world["jax"]["restore"]
    assert want["at"] == STEPS
    per_rank = _case(world, "restore")
    for r, res in enumerate(per_rank):
        for key in ("1x4", "none"):
            if key not in res:
                continue
            assert res[key]["at"] == STEPS, (r, key)
            _held_metrics(res[key]["hist"], want["hist"], "bitnet-730m")


def test_train_cli_fault_loop_replays_on_the_mesh(world):
    """A fault on every rank at once, on one rank after its step's
    collectives, and on rank 0 alone as it writes a checkpoint: every rank
    learns of it, restores the last checkpoint and replays, and each run's
    6 steps give the clean run's metrics bit for bit on every rank."""
    per_rank = _case(world, "fault")
    for r, got in enumerate(per_rank):
        assert sorted(got["clean"]["hist"]) == list(range(6)), r
        for key in ("all", "some"):
            assert got[key]["step"] == 6, (r, key)
            assert got[key]["hist"] == got["clean"]["hist"], (r, key)
    lead = {k: v["out"] for k, v in per_rank[0].items()}
    assert "[fault]" not in lead["clean"]
    assert "[fault] step 3 failed (RuntimeError('injected fault'))" in lead["all"]
    assert "[fault] step 3 failed (RuntimeError('raised on rank(s) [2]'))" in lead["some"]
    assert "[fault] step 4 failed (OSError('injected checkpoint fault'))" in lead["some"]
    assert lead["all"].count("[fault] restored step 2, replaying") == 1
    assert lead["some"].count("[fault] restored step 2, replaying") == 2
    assert all("[fault]" not in got[k]["out"] for got in per_rank[1:] for k in got)


def test_compressed_mean_matches_jax_shard_map(world):
    """``compressed_mean_over_axis`` over a (pod 4) mesh against JAX's inside
    ``shard_map`` on the same gradients and carried errors: the means
    within ``COMPRESSED_ATOL`` (JAX's tensordot sums the 4 scaled payloads
    in its own order), the new errors bit for bit."""
    want = world["jax"]["compress"]
    for r, got in enumerate(_case(world, "compress")):
        wm, we = _jax_flat(want["mean"]), _jax_flat(want["err"])
        for n, x in got["mean"].items():
            np.testing.assert_allclose(x, wm[n][r], rtol=0, atol=COMPRESSED_ATOL, err_msg=n)
        for n, x in got["err"].items():
            np.testing.assert_array_equal(x, we[n][r], err_msg=n)


def test_compressed_dp_toy_regression_follows_jax(world):
    """The JAX test's toy regression (300 steps, int8 wire with error
    feedback over 4 pod ranks): the final loss is under 1e-3 and within
    1e-3 of the exact run's, and the weights follow JAX's trajectory
    within 1e-4 at every step (the two sum a pod's 16-row mean in their
    own orders, and a step's rounding is carried on by the error feedback)."""
    want = world["jax"]["toy"]
    for r, got in enumerate(_case(world, "compress")):
        assert got["final_c"] < 1e-3, r
        assert abs(got["final_c"] - got["final_e"]) < 1e-3, r
        np.testing.assert_allclose(got["traj"], want["traj"], rtol=0, atol=1e-4, err_msg=str(r))
    assert want["final_c"] < 1e-3


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the mesh training tests' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out, a.ckpt)
