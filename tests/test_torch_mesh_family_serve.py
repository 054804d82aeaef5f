"""Serving of the hymba, xLSTM and whisper families on a mesh of processes:
the port's phase programs (``PhaseEngine.prefill_program``,
``install_program``, ``decode_program``) against the JAX package's
``PhaseEngine`` on an Auto-axes (data 2, model 2) mesh, on the CPU over
gloo.

One world of 4 ranks is started for the module (each rank a process running
this file, its store in a file under the test's temporary directory); each
rank runs every case on (data 2, model 2) and reports its tokens, logits
and cache block, and rank 0 also runs each case on one device.  Beside it
the JAX reference runs once, in a subprocess with 4 host devices, on a
``jax.sharding.Mesh`` built with Auto axes: ``prefill_program`` (with
``frames=`` for whisper), the prefill cache installed by hand (the KV
padded to ``MAXLEN`` rows and moved batch-leading, the states kept as they
are), then ``STEPS`` ``decode_program`` steps, greedy, and the same
without a mesh.  Two quirks of the JAX mesh programs under jax 0.9 are
worked around there, not in the port (ROADMAP C): a one-prompt prefill
cannot split its (1, S) tokens over data 2, so the long-context case
prefills without a mesh and decodes on it; and the decode program's
output cache comes back in other shardings than its ``in_shardings`` pin,
so each step is handed host copies of the cache.  Both sides take the same
latent f32 weights (numpy, from a seed, through ``params_from_numpy``),
f32 caches and f32 math with TF32 off.  The cases:

* reduced hymba (4 query and 2 KV heads: each model rank its own heads),
  48-token prompts, so that layer 1's 32-token window masks and its start
  falls in model rank 0's half of the 64-row cache;
* reduced hymba with 5 query heads and 1 KV head: every rank computes
  every head, the rules cutting ``wq``/``wk``/``wv`` mid-head;
* reduced xlstm (one mLSTM and one sLSTM block), its heads over the model
  axis in prefill and whole in decode;
* reduced whisper (2 + 2 layers over 16 frames, the frames split over the
  data axis with the rows; its cross cache of 128 padded rows in halves of
  64, model rank 1's walking none of them);
* reduced hymba at batch 1 under the long-context rules: the KV sequence
  over data x model (4 blocks of 16 rows), the SSM's channels over model.

Tolerance, read on this CPU: greedy tokens equal; logits within
``LOGIT_ATOL`` of the JAX mesh program's (read 2.3e-6 for xlstm, at most
1.0e-6 for the others; the JAX mesh program itself reads within 9.2e-7 of
the JAX unsharded one), about 4 times the largest reading.
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
B, S, MAXLEN, STEPS = 4, 48, 64, 4
LOGIT_ATOL = 1e-5
CASES = {  # name: (arch, reduced_config overrides, long context)
    "hymba": ("hymba-1.5b", {}, False),
    "hymba-whole-heads": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1}, False),
    "xlstm": ("xlstm-1.3b", {}, False),
    "whisper": ("whisper-large-v3", {}, False),
    "hymba-long-context": ("hymba-1.5b", {}, True),
}


# ------------------------------------------------------------ shared data --


def case_config(name):
    from repro_torch.configs import reduced_config

    arch, kw, _ = CASES[name]
    return reduced_config(arch, **kw)


def case_inputs(cfg, b):
    """The prompts (b, S) and, for whisper, the frames (b, Senc, d)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


def numpy_params(cfg):
    from test_torch_mesh_families import numpy_family_params

    return numpy_family_params(cfg)


# ---------------------------------------------------------------- the ranks --


def roll(name, mesh):
    """prefill -> install -> STEPS greedy decode steps of the case through
    the port's phase programs on ``mesh`` (None: one device): (tokens
    (STEPS + 1, b), logits (STEPS + 1, b, Vp), this rank's cache block
    shapes by leaf, the exchange's calls)."""
    from repro_torch.common.tree import named_leaves
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.examples.serve_mesh import serve_family
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.sharding_rules import shard_params

    cfg, long = case_config(name), CASES[name][2]
    b = 1 if long else B
    params = params_from_numpy(numpy_params(cfg), cfg, device="cpu")
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    eng = PhaseEngine(cfg, mesh, long_context=long)
    prompts, frames = case_inputs(cfg, b)
    logits = []
    toks, cache = serve_family(eng, params, prompts, STEPS + 1, MAXLEN,
                               None if frames is None else torch.from_numpy(frames),
                               on_step=lambda i, lg: logits.append(lg.numpy().copy()),
                               dtype=torch.float32)
    blocks = {n: tuple(t.shape) for n, t in named_leaves(cache)}
    return toks, np.stack(logits), blocks, eng.exchanges


def case_roll(ctx, name):
    mesh = ctx["mesh"]
    toks, logits, blocks, exchanges = roll(name, mesh)
    out = {"tokens": toks, "logits": logits, "blocks": blocks, "exchanges": exchanges}
    if mesh.rank == 0:
        out["one_device"] = roll(name, None)[:2]
    return out


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the test world: join, run every case, gather each case's
    result from every rank to rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import join_process_group, make_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    ctx = {"mesh": make_mesh((2, 2), ("data", "model"))}
    results = {}
    for name in CASES:
        t0 = time.perf_counter()
        try:
            got = ("ok", case_roll(ctx, name))
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
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
import test_torch_mesh_family_serve as M
from repro.configs import reduced_config
from repro.core.phase_engine import PhaseEngine
from repro.launch.sharding_rules import params_shardings

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
host = lambda tree: jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


def batch_leading(kvs, rows):
    return tuple(jnp.moveaxis(jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, rows - x.shape[3]), (0, 0))),
                              0, 1) for x in kvs)


def roll(cfg, long, m):
    b = 1 if long else M.B
    params = jax.tree.map(jnp.asarray, M.numpy_params(cfg))
    pabs = jax.eval_shape(lambda: params)
    tokens, frames = M.case_inputs(cfg, b)
    eng = PhaseEngine(cfg, m, long_context=long)
    pre_eng = PhaseEngine(cfg, None) if long else eng  # (1, S) tokens do not split over data
    p = params if m is None else jax.tree.map(jax.device_put, params,
                                              params_shardings(params, cfg, m, train=False))
    args = (params if long else p, jnp.asarray(tokens))
    if frames is not None:
        args += (jnp.asarray(frames),)
    logits, pre = pre_eng.prefill_program(pabs, b, M.S, frames=frames is not None).fn(*args)
    cache = eng.api.init_cache(cfg, b, M.MAXLEN, dtype=jnp.float32)
    if cfg.family == "hymba":
        cache = type(cache)(type(cache.kv)(*batch_leading(pre.kv, M.MAXLEN)), pre.ssm_h, pre.conv)
    elif cfg.family == "encdec":
        cache = type(cache)(type(cache.self_kv)(*batch_leading(pre.self_kv, M.MAXLEN)),
                            type(cache.cross_kv)(*batch_leading(pre.cross_kv,
                                                                pre.cross_kv.k.shape[3])))
    else:
        cache = pre
    dec = eng.decode_program(pabs, b, M.MAXLEN)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, lgs = [np.asarray(tok)], [np.asarray(logits)]
    lengths = jnp.full((b,), M.S, jnp.int32)
    for i in range(M.STEPS):
        logits, cache = dec.fn(p, host(tok), host(cache), lengths + i)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(logits))
    return np.stack(toks), np.stack(lgs)


out = {{}}
for name, (arch, kw, long) in M.CASES.items():
    cfg = reduced_config(arch, **kw)
    out[name] = {{"mesh": roll(cfg, long, mesh), "none": roll(cfg, long, None)}}
with open({out_path!r}, "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks and the JAX subprocess and collect both."""
    tmp = tmp_path_factory.mktemp("mesh_family_serve")
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


# --------------------------------------------------------------- the world --


@pytest.mark.parametrize("name", list(CASES))
def test_family_mesh_serving_matches_jax_mesh_programs(world, name):
    """Each case on (data 2, model 2) against the JAX ``PhaseEngine``'s
    prefill and decode programs on its Auto-axes mesh: every rank's greedy
    tokens equal JAX's, its logits (the whole batch's, on every rank)
    within ``LOGIT_ATOL``; and the JAX mesh program's tokens equal its
    unsharded ones."""
    want_toks, want_logits = world["jax"][name]["mesh"]
    none_toks, none_logits = world["jax"][name]["none"]
    np.testing.assert_array_equal(want_toks, none_toks)
    for r, got in enumerate(_case(world, name)):
        np.testing.assert_array_equal(got["tokens"], want_toks, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], want_logits, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_family_mesh_serving_matches_the_port_on_one_device(world, name):
    """Each case on the mesh against the port's own programs on one device
    (rank 0): the same tokens, logits within ``LOGIT_ATOL``; the ranks of
    a data row agree exactly (each holds the whole batch's logits)."""
    every = _case(world, name)
    toks, logits = every[0]["one_device"]
    np.testing.assert_array_equal(every[0]["tokens"], toks)
    np.testing.assert_allclose(every[0]["logits"], logits, rtol=0, atol=LOGIT_ATOL)
    for r, got in enumerate(every):
        np.testing.assert_array_equal(got["logits"], every[0]["logits"], err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_family_cache_blocks_are_the_rules_cut(world, name):
    """Every rank's cache block is the shape ``PhaseEngine.cache_blocks``
    reckons from the rules: under the
    decode rules the batch over data, the KV sequence over model, the
    states whole on every model rank; under the long-context rules the
    batch whole, the sequence over data x model, the SSM's channels over
    model.  The install exchanged the heads once a prompt where the model
    axis splits them (none where every rank computes every head)."""
    cfg, long = case_config(name), CASES[name][2]
    every = _case(world, name)
    blocks = every[0]["blocks"]
    if cfg.family == "hymba":
        assert blocks["kv/k"] == ((1, 2, 2, 16, 32) if long else (2, 2, cfg.num_kv_heads, 32,
                                                                 cfg.head_dim))
        assert blocks["ssm_h"] == (2, 1 if long else 2, 64 if long else 128, 8)
    if cfg.family == "encdec":
        assert blocks["cross_kv/k"] == (2, 2, 4, 64, 32)  # 128 padded rows in halves
    if cfg.family == "xlstm":
        assert blocks["mlstm/c"] == (1, 1, 2, 4, 32, 32)  # every head, this data rank's rows
    for r, got in enumerate(every):
        assert got["blocks"] == blocks, r
        heads_split = cfg.num_kv_heads % 2 == 0 and cfg.family != "xlstm"
        # hymba: 1 exchange a prompt; whisper: self and cross a prompt; xlstm
        # and whole heads gather states only (hymba: ssm and conv, once each)
        n_prompts = 1 if long else 2  # a data rank's prompts (long: every prompt)
        want = {"hymba": n_prompts + 2, "encdec": 2 * n_prompts, "xlstm": 7}[cfg.family]
        if cfg.family == "hymba" and not heads_split:
            want = 2
        if long:
            want = n_prompts  # the long rules keep the SSM's channels split: no state gather
        assert got["exchanges"] == want, (r, got["exchanges"], want)


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


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_blocks_equal_jax_cache_shardings(arch):
    """At full width and reduced, on (2, 2), (1, 4) and (4, 2), under the
    decode and the long-context rules (xLSTM: the decode rules; the
    long-context ones are refused, ROADMAP A.13.12): every cache leaf's
    spec from ``PhaseEngine.cache_blocks`` (``layers.sharding.cache_spec``)
    equals the JAX ``PhaseEngine._cache_shardings`` spec of the same leaf,
    sanitized, and its block shape the shard shape of that sharding, which
    is also the shape ``PhaseEngine.init_cache`` allocates (each family's
    ``init_cache`` cutting its own leaves)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget, reduced_config as jreduced
    from repro.core.phase_engine import PhaseEngine as JPhaseEngine

    from repro.common.tree import tree_map_with_path_names

    from repro_torch.common.tree import named_leaves
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.phase_engine import PhaseEngine

    def named(tree):
        out = {}
        tree_map_with_path_names(lambda n, x: out.__setitem__(n, x), tree)
        return out

    for full in (True, False):
        cfg = get_config(arch) if full else reduced_config(arch)
        jcfg = jget(arch) if full else jreduced(arch)
        batch, max_len = 8, 4096 if full else 64
        for long in ((False, True) if cfg.family != "xlstm" else (False,)):
            for dims in ((2, 2), (1, 4), (4, 2)):
                jmesh = AbstractMesh(dims, ("data", "model"))
                jeng = JPhaseEngine(jcfg, jmesh, long_context=long)
                abstract = jax.eval_shape(lambda: jeng.api.init_cache(jcfg, batch, max_len))
                want = named(jeng._cache_shardings(abstract))
                shapes = named(abstract)
                eng = PhaseEngine(cfg, _StubMesh(dict(zip(("data", "model"), dims))),
                                  long_context=long)
                got = eng.cache_blocks(batch, max_len)
                assert sorted(got) == sorted(want), (arch, full, long, dims)
                for n, (spec, block) in got.items():
                    jspec = tuple(want[n].spec) + (None,) * (len(block) - len(want[n].spec))
                    assert tuple(spec) == jspec, (arch, full, long, dims, n)
                    assert block == tuple(want[n].shard_shape(shapes[n].shape)), (
                        arch, full, long, dims, n)
                made = eng.init_cache(batch, max_len, device="meta")
                assert {n: tuple(t.shape) for n, t in named_leaves(made)} == {
                    n: block for n, (_, block) in got.items()}, (arch, full, long, dims)


def test_family_serving_refusals():
    """``check_mesh_model`` refuses by name only what it must: xLSTM under
    the long-context rules (ROADMAP A.13.12), a model axis that does not
    divide what a rank must hold its own part of (hymba's SSM channels,
    xLSTM's heads, the projections' columns), and the families' programs
    take the contiguous fp cache only.  hymba's 25 / 5 heads serve on any
    model axis that divides their columns."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.phase_engine import PhaseEngine

    mesh = _StubMesh({"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="A.13.12"):
        PhaseEngine(reduced_config("xlstm-1.3b"), mesh, long_context=True)
    with pytest.raises(ValueError, match="SSM's channels"):
        PhaseEngine(reduced_config("hymba-1.5b", d_model=127), mesh)
    with pytest.raises(ValueError, match="num_heads"):
        PhaseEngine(reduced_config("xlstm-1.3b", num_heads=3, num_kv_heads=3), mesh)
    with pytest.raises(NotImplementedError, match="contiguous fp cache"):
        PhaseEngine(reduced_config("whisper-large-v3"), mesh, kv_dtype="int8")
    for arch in FAMILY_ARCHS:
        eng = PhaseEngine(get_config(arch), mesh, long_context=arch.startswith("hymba"))
        assert eng.decode_program(2, 4096).capturable is False  # eager, as the one-card path
        assert eng.prefill_program(2, 64).name == "prefill:2x64"


def test_one_rank_family_serving_equals_no_mesh_bit_for_bit(tmp_path):
    """On a (data 1, model 1) world of one every collective is a group of
    one: each case's tokens and logits are the one-device programs', bit
    for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_process_group, make_host_mesh

    join_process_group("gloo", device_type="cpu", init_method=f"file://{tmp_path / 'store1'}",
                       rank=0, world_size=1, timeout_s=60)
    try:
        mesh = make_host_mesh()
        for name in CASES:
            got, want = roll(name, mesh), roll(name, None)
            np.testing.assert_array_equal(got[0], want[0], err_msg=name)
            np.testing.assert_array_equal(got[1], want[1], err_msg=name)
    finally:
        dist.destroy_process_group()


def test_windowed_walk_in_halves_merges_to_the_whole_walk():
    """hymba's windowed walk split over two sequence halves, each from the
    window's start moved onto its rows (``clamp(start - r * Sl, 0, Sl)``)
    and merged as the ranks merge them (``combine_partials``), equals the
    whole windowed walk; a half wholly before the window or past a slot's
    length weighs nothing and gives no NaN."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.layers.attention import combine_partials

    rng = np.random.default_rng(4)
    b, h, hkv, s, d, window = 4, 10, 2, 64, 16, 20
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([10, 32, 45, 64], dtype=torch.int32)
    starts = torch.clamp(lengths + 1 - window, min=0).to(torch.int32)  # [0, 13, 26, 45]
    whole = decode_attention(q, k, v, lengths, starts, return_stats=True)
    half = s // 2
    parts = []
    for r in range(2):
        off = r * half
        parts.append(decode_attention(
            q, k[:, :, off:off + half], v[:, :, off:off + half],
            torch.clamp(lengths - off, 0, half).to(torch.int32),
            torch.clamp(starts - off, 0, half).to(torch.int32), return_stats=True))
    assert parts[0][1][3].abs().max() == 0  # slot 3: rank 0's half before its window
    assert parts[1][1][:2].abs().max() == 0  # slots 0, 1: rank 1's half past their lengths
    out, l, m = combine_partials(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    assert torch.isfinite(out).all() and torch.isfinite(l).all()
    torch.testing.assert_close(out, whole[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l, whole[1], atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(m, whole[2], atol=0, rtol=0)


def test_cross_walk_in_halves_merges_to_the_whole_cross_walk():
    """whisper's cross walk split over two halves of its padded rows, each
    walking ``clamp(cross_len - r * Sl, 0, Sl)`` of them with NaN in the
    pad, merged: equals the whole cross walk over ``cross_len`` rows; with
    ``cross_len`` inside the first half the second half walks nothing."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.layers.attention import combine_partials

    rng = np.random.default_rng(5)
    b, h, rows, d = 2, 4, 64, 16
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    for cross_len in (50, 20):
        k, v = (torch.from_numpy(rng.normal(size=(b, h, rows, d)).astype(np.float32))
                for _ in range(2))
        k[:, :, cross_len:], v[:, :, cross_len:] = float("nan"), float("nan")
        eff = torch.full((b,), cross_len, dtype=torch.int32)
        whole = decode_attention(q, k, v, eff, return_stats=True)
        half = rows // 2
        parts = [decode_attention(q, k[:, :, r * half:(r + 1) * half],
                                  v[:, :, r * half:(r + 1) * half],
                                  torch.full((b,), min(max(cross_len - r * half, 0), half),
                                             dtype=torch.int32), return_stats=True)
                 for r in range(2)]
        out, l, m = combine_partials(*(torch.stack([p[i] for p in parts]) for i in range(3)))
        assert torch.isfinite(out).all() and torch.isfinite(l).all(), cross_len
        torch.testing.assert_close(out, whole[0], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(l, whole[1], atol=1e-5, rtol=1e-6)


# --------------------------------------------------------- the launcher --


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-large-v3"])
def test_serve_mesh_example_serves_the_family_over_the_launcher(arch):
    """``serve_mesh --arch`` of another family on 4 gloo ranks started by
    ``torch.distributed.run``, a reduced model on the CPU: rank 0's greedy
    streams equal the one-device run's, and every rank prints its params
    and cache MiB."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    run = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m", "repro_torch.examples.serve_mesh",
                        "--backend", "gloo", "--device", "cpu", "--reduced", "--check",
                        "--arch", arch], env=env, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "streams equal the one-device run's" in run.stdout
    assert run.stdout.count("MiB, cache") == 4


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the mesh family serving tests' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
