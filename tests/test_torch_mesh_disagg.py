"""The pod split of the disaggregated pools on a mesh of processes: the
port's ``DisaggEngine`` with its prefill pool on one pod's ranks and its
decode pool on the other's, every KV segment crossing between them, held
on the CPU over gloo against the JAX package.

Two worlds are started once for the module (each rank a process running
this file, its store in a file under the test's temporary directory): a
(pod 2, model 1) world of 2 ranks and a (pod 2, model 2) world of 4.  A
third, ``launch.serve --disagg`` on 2 ranks started by
``torch.distributed.run``, runs beside them.  One JAX subprocess with 4
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
computes every reference once on ``jax.sharding.Mesh``es built with Auto
axes: the JAX ``DisaggEngine(mesh=)`` on (pod 2, model 1), for contiguous
fp with monolithic prefill and for paged int8 with 8-token chunks, and the
JAX colocated engine on (data 1, model 2), contiguous fp.  The JAX
``DisaggEngine`` on (pod 2, model 2) fails under jax 0.9 (its handoff
installs a replicated cache the decode program's jit refuses), and so
does its colocated mesh engine on paged int8: there the port is held to
its own ``DisaggEngine`` on one device, whose streams
``tests/test_torch_disagg.py`` holds to the JAX package.  The one-device
references run in this process while the worlds work, and so does the
one-device ``EngineCore`` on ``test_torch_mesh.numpy_params``'s weights,
whose logits are held to the JAX engine's on the same weights.

The model is the JAX test's (``tests/test_disagg_serving.py:239-277``):
reduced bitnet-730m, 2 layers, d_model 64, 4/2 heads, vocab 256, prompts
of 7, 11 and 18 tokens, 5 new, 2 slots, max_len 40, and its weights, the
JAX ``init`` from ``PRNGKey(0)`` in f32, latent (each linear quantizes on
the fly), which ``init_like_jax`` draws on the port's side and packs.  Tokens are
compared exactly: the ternary products are exact on the ranks (int32
partials), and the float sums a (pod 2, model 2) pool reorders keep every
argmax here.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import argparse
import os
import pickle
import subprocess
import sys
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
LENS = (7, 11, 18)
MAX_NEW = 5
BASE = dict(n_slots=2, max_len=40, prompt_len=8)
PAGED_CHUNKED = dict(cache_layout="paged", block_size=8, num_blocks=16, kv_dtype="int8",
                     prefill_chunk=8)
# the engine cases each world runs: key -> (engine options, how the requests go)
CASES = {
    "contiguous-fp": (dict(), ""),
    "paged-int8-chunked": (PAGED_CHUNKED, ""),
}
CASES4 = dict(CASES, **{
    "contiguous-int4-static": (dict(kv_dtype="int4", mode="static"), ""),
    "sampled": (dict(), "sampled"),
    "preempting": (dict(PAGED_CHUNKED, num_blocks=3), ""),
    "aborts": (PAGED_CHUNKED, "aborts"),
})
# speculation and the swap policies on the split, in both worlds (the
# swap-aware one decides from measured times: its tokens are held, not its
# counts), and colocated on the 2-rank world's (data 1, model 2) mesh
SPEC_CASES = {
    "spec-fp": (dict(spec_decode=2), ""),
    "spec-paged-int8-chunked": (dict(PAGED_CHUNKED, spec_decode=2), ""),
    "swap-aware": (dict(PAGED_CHUNKED, swap_policy="swap-aware"), ""),
}
TP_CASES = {
    "tp-spec-fp": (dict(spec_decode=2), ""),
    "tp-swap-aware": (dict(swap_policy="swap-aware"), ""),
}
ALL_CASES = dict(CASES4, **SPEC_CASES, **TP_CASES)
SPEC_KEYS = ("draft_tokens", "accepted_tokens", "verify_rounds", "prefill_chunks")
HANDOFF_KEYS = ("segments", "eager_segments", "installs", "bytes_shipped", "discarded",
                "pending")
CLI_ARGS = ["--reduced", "--device", "cpu", "--disagg", "--requests", "4", "--prompt-len", "16",
            "--max-len", "64", "--cache-layout", "paged", "--block-size", "8",
            "--prefill-chunk", "8"]


def model_config():
    from repro_torch.configs import reduced_config

    return reduced_config("bitnet-730m", num_layers=2, d_model=64, vocab_size=256, num_heads=4,
                          num_kv_heads=2)


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENS]


def sampling(i, how, mod):
    """The sampled case: the odd requests draw, the even ones are greedy."""
    if how != "sampled" or i % 2 == 0:
        return mod()
    return mod(temperature=0.8, top_k=64, top_p=0.95, seed=100 + i)


def decisions(tree):
    """A snapshot with every float (times, rates) taken out."""
    if isinstance(tree, dict):
        return {k: decisions(v) for k, v in tree.items() if not isinstance(v, float)}
    if isinstance(tree, (list, tuple)):
        return [decisions(v) for v in tree if not isinstance(v, float)]
    return tree


def serve(eng, how, *, lead=True):
    """Submit the requests and run them to the end (``lead``: rank 0 or no
    mesh; otherwise follow rank 0).  "aborts": once a request is part way
    through its chunked prefill, it and a decoding one are aborted (the
    followers apply rank 0's aborts at the next step).  Returns the
    streams and each abort's finish reason."""
    from repro_torch.serving import Request, SamplingParams

    if not lead:
        eng.follow()
        return None
    for i, p in enumerate(prompts()):
        eng.submit(Request(f"r{i}", p, max_new=MAX_NEW, params=sampling(i, how, SamplingParams)))
    aborted = {}
    if how == "aborts":
        while not eng._prefilling:
            eng.step()
        mid = next(iter(eng._prefilling.values())).req.request_id
        for rid in [mid] + [r.request_id for r in eng.scheduler.inflight.values()]:
            out = eng.abort(rid)
            aborted[rid] = None if out is None else out.finish_reason
    eng.run()
    if eng.mesh is not None:
        eng.stop_followers()
    return {"streams": {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())},
            "aborted": aborted}


def engine_result(eng, got):
    runner = eng.runner
    live = None
    if runner.paged is not None:
        live = runner.paged.num_blocks - runner.paged.pool.num_free
    snap = eng.snapshot()
    return {"got": got, "decisions": decisions(snap), "disagg": snap["disagg"],
            "handoff": {k: snap["disagg"]["handoff"][k] for k in HANDOFF_KEYS + ("pod_bytes",)},
            "preemptions": eng.stats.preemptions, "live_pages": live}


# ---------------------------------------------------------------- the ranks --


def _port_params(cfg):
    """The JAX test's weights, ``init(cfg, PRNGKey(0), float32)``, packed
    (a mesh's row-parallel products take packed weights; each holds the
    ternary values and scale the JAX engine quantizes to on the fly)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.jax_init import init_like_jax

    return T.convert_for_inference(init_like_jax(cfg, 0, "cpu"), cfg)


def case_engine(ctx, case):
    from repro_torch.serving import DisaggEngine

    kw, how = ALL_CASES[case]
    pm, dm = ctx["pools"]
    eng = DisaggEngine(ctx["cfg"], ctx["params"], prefill_mesh=pm, decode_mesh=dm, **BASE, **kw)
    got = serve(eng, how, lead=eng.mesh.rank == 0)
    return dict(engine_result(eng, got), policy=list(eng.decisions))


def case_colocated(ctx, case):
    """``EngineCore`` on the 2-rank world's (data 1, model 2) mesh."""
    from repro_torch.serving import EngineCore

    kw, how = ALL_CASES[case]
    mesh = ctx["tp"]
    eng = EngineCore(ctx["cfg"], ctx["params"], mesh=mesh, device="cpu", **BASE, **kw)
    got = serve(eng, how, lead=mesh.rank == 0)
    return {"got": got, "decisions": decisions(eng.snapshot()), "policy": list(eng.decisions)}


def case_groups(ctx):
    """Each rank's view of its pool: shape, coordinates, group sizes, the
    pod group's ranks, its place in the world."""
    import torch.distributed as dist

    pm, dm = ctx["pools"]
    mine = pm if hasattr(pm, "parent") else dm
    other = dm if mine is pm else pm
    return {"shape": mine.shape, "size": mine.size, "axis_names": mine.axis_names,
            "model": mine.coordinate("model"),
            "model_group": dist.get_process_group_ranks(mine.group("model")),
            "pod_group": dist.get_process_group_ranks(mine.pod_group),
            "one": dist.get_world_size(mine.group(None)),
            "pod": mine.pod.index, "pod_ranks": mine.pod.ranks,
            "other": (other.index, other.ranks, other.shape), "describe": mine.describe()}


def case_quant_transfer(ctx):
    """A ``QuantKV`` tree (an int8 payload of rank 5, f32 scales of rank
    4) moved from each prefill rank to the decode rank at its coordinates:
    every byte lands on the decode pod, the shapes and dtypes with it."""
    from repro_torch.core.disagg import kv_transfer
    from repro_torch.quant.kv_quant import QuantKV

    pm, dm = ctx["pools"]
    mine = pm if hasattr(pm, "parent") else dm
    at = mine.pod.ranks.index(mine.rank)
    src = (mine.pod if mine is pm else pm).ranks[at]  # the prefill rank at these coordinates
    offset = at * 7
    payload = (torch.arange(2 * 2 * 2 * 8 * 4, dtype=torch.int32).reshape(2, 2, 2, 8, 4)
               + offset).to(torch.int8)
    scales = torch.full((2, 2, 2, 8), 0.5 + at, dtype=torch.float32)
    want = QuantKV(payload, scales)
    if mine is pm:
        _, moved = kv_transfer(want, mine.pod_group, src=src)
        return {"moved": moved, "role": "prefill"}
    like = QuantKV(torch.empty(payload.shape, dtype=torch.int8, device="meta"),
                   torch.empty(scales.shape, device="meta"))  # what the receiver knows
    got, moved = kv_transfer(None, mine.pod_group, src=src, like=like, device=torch.device("cpu"))
    return {"moved": moved, "role": "decode",
            "payload_equal": torch.equal(got.q, payload), "scales_equal": torch.equal(got.scale,
                                                                                        scales),
            "dtypes": (str(got.q.dtype), str(got.scale.dtype)),
            "shapes": (tuple(got.q.shape), tuple(got.scale.shape))}


def case_refusals(ctx):
    """What the split refuses by name: a device given to a pool."""
    from repro_torch.serving import DisaggEngine

    pm, dm = ctx["pools"]
    try:
        DisaggEngine(ctx["cfg"], ctx["params"], prefill_mesh=pm, decode_mesh=dm, device="cpu",
                     **BASE)
    except ValueError as e:
        device = str(e)
    else:
        device = None
    return {"device": device}


def case_data_pools(ctx):
    """A (pod 2, data 2, model 1) mesh: pools of data 2 are refused."""
    from repro_torch.core.disagg import split_pod_meshes
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    try:
        split_pod_meshes(mesh)
    except NotImplementedError as e:
        return str(e)
    return None


def _cases(world):
    cases = [(f"engine-{c}", lambda ctx, c=c: case_engine(ctx, c))
             for c in list(CASES4 if world == 4 else CASES) + list(SPEC_CASES)]
    if world == 2:
        cases += [(c, lambda ctx, c=c: case_colocated(ctx, c)) for c in TP_CASES]
    cases.append(("groups", case_groups))
    if world == 4:
        cases += [("quant_transfer", case_quant_transfer), ("refusals", case_refusals),
                  ("data_pools", case_data_pools)]
    return cases


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a test world: join, split the (pod 2, model world / 2)
    mesh, run every case, gather each case's result on rank 0."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.serving.disagg import make_disagg_meshes

    join_process_group("gloo", device_type="cpu", init_method=f"file://{store}", rank=rank,
                       world_size=world, timeout_s=120)
    cfg = model_config()
    ctx = {"cfg": cfg, "params": _port_params(cfg), "pools": make_disagg_meshes(tp=world // 2)}
    if world == 2:
        ctx["tp"] = make_host_mesh(data=1, model=2)
    results = {}
    for name, fn in _cases(world):
        try:
            got = ("ok", fn(ctx))
        except Exception:  # noqa: BLE001 — the failing test prints it
            got = ("error", traceback.format_exc())
        every = [None] * world
        dist.all_gather_object(every, got)
        results[name] = every
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    # End here, the results written, with no teardown of the process group:
    # under the suite's load one rank's gloo teardown raced its peer's and
    # aborted the process (std::terminate) after its work was done.
    sys.stdout.flush()
    os._exit(0)


# ------------------------------------------------------------ the JAX side --

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
import test_torch_mesh_disagg as M
from repro.configs import reduced_config
from repro.models import get_model
from repro.serving import DisaggEngine, EngineCore, Request

cfg = reduced_config("bitnet-730m", num_layers=2, d_model=64, vocab_size=256, num_heads=4,
                     num_kv_heads=2)
params = get_model(cfg).init(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)

def run(cls, kw, **extra):
    eng = cls(cfg, params, **M.BASE, **kw, **extra)
    for i, p in enumerate(M.prompts()):
        eng.submit(Request(f"r{{i}}", p, max_new=M.MAX_NEW))
    eng.run()
    streams = {{k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}}
    ho = eng.snapshot().get("disagg")
    return {{"streams": streams,
             "handoff": None if ho is None else {{k: ho["handoff"][k] for k in M.HANDOFF_KEYS}},
             "pools": None if ho is None else (ho["prefill_pool"], ho["decode_pool"]),
             "spec": {{k: getattr(eng.stats, k) for k in M.SPEC_KEYS}}}}

devs = np.array(jax.devices())
pods = Mesh(devs[:2].reshape(2, 1), ("pod", "model"))
tp = Mesh(devs[:2].reshape(1, 2), ("data", "model"))
out = {{}}
for case, (kw, _) in M.CASES.items():
    out[case] = {{"disagg": run(DisaggEngine, kw, mesh=pods), "single": run(EngineCore, kw)}}
out["contiguous-fp"]["colocated_tp"] = run(EngineCore, {{}}, mesh=tp)
for case, (kw, _) in M.SPEC_CASES.items():
    out[case] = {{"disagg": run(DisaggEngine, kw, mesh=pods)}}
for case, (kw, _) in M.TP_CASES.items():
    out[case] = {{"colocated_tp": run(EngineCore, kw, mesh=tp)}}
import test_torch_mesh as TM
eng = EngineCore(cfg, TM.jax_params(cfg, TM.numpy_params(cfg)), **M.BASE)
out["numpy-fp"] = M.recorded_rows(eng, Request, lambda lg: np.asarray(lg, np.float32))
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def recorded_rows(eng, request, to_numpy):
    """Serve the requests greedily on ``eng`` (the JAX engine or the
    port's, ``request`` its ``Request``) with every decode round's logits
    kept: (streams, [(B, V) rows])."""
    rows, decode = [], eng.runner.decode_logits

    def kept(lengths):
        logits = decode(lengths)
        rows.append(to_numpy(logits)[:, :256].copy())
        return logits

    eng.runner.decode_logits = kept
    for i, p in enumerate(prompts()):
        eng.submit(request(f"r{i}", p, max_new=MAX_NEW))
    eng.run()
    return {k: list(map(int, r.out_tokens)) for k, r in sorted(eng.finished.items())}, rows


def _numpy_weights_rows():
    """The port's one-device ``EngineCore`` (contiguous fp) on the latent
    weights ``test_torch_mesh.numpy_params`` draws, its logits kept."""
    from test_torch_mesh import numpy_params

    from repro_torch.interop import params_from_numpy
    from repro_torch.serving import EngineCore, Request

    cfg = model_config()
    eng = EngineCore(cfg, params_from_numpy(numpy_params(cfg), cfg, device="cpu"),
                     device="cpu", **BASE)
    return recorded_rows(eng, Request, lambda lg: lg.float().numpy())


def _one_device(case):
    """The port's ``DisaggEngine`` with both pools on the CPU."""
    from repro_torch.serving import DisaggEngine

    cfg = model_config()
    kw, how = ALL_CASES[case]
    eng = DisaggEngine(cfg, _port_params(cfg), device="cpu", **BASE, **kw)
    return engine_result(eng, serve(eng, how))


def _cli(argv):
    import contextlib
    import io

    from repro_torch.launch import serve as S

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert S.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start both worlds, the CLI's world and the JAX subprocess; compute
    the one-device references meanwhile; collect everything."""
    tmp = tmp_path_factory.mktemp("mesh_disagg")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs, outs = {}, {}
    for world in (2, 4):
        outs[world] = tmp / f"ranks{world}.pkl"
        for r in range(world):
            procs[f"w{world}-rank{r}"] = subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world", str(world),
                 "--store", str(tmp / f"store{world}"), "--out", str(outs[world])],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs["cli"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", *CLI_ARGS],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jax_out = tmp / "jax.pkl"
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    procs["jax"] = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(tests=str(REPO / "tests"), out=str(jax_out))],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}

    def drain(name, proc):  # keep the pipes from filling
        logs[name] = proc.communicate(timeout=400)[0]

    threads = [threading.Thread(target=drain, args=item) for item in procs.items()]
    for t in threads:
        t.start()
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' float order
    try:
        single = {c: _one_device(c) for c in list(CASES4) + list(SPEC_CASES)}
        single["numpy-fp"] = _numpy_weights_rows()
        cli = _cli(CLI_ARGS)
    finally:
        torch.set_num_threads(threads_before)
    for t in threads:
        t.join()
    codes = {k: p.returncode for k, p in procs.items()}
    assert set(codes.values()) == {0}, "\n".join(f"--- {k} ({codes[k]}):\n{v[-4000:]}"
                                                 for k, v in logs.items())
    ranks = {}
    for world, path in outs.items():
        with open(path, "rb") as f:
            ranks[world] = pickle.load(f)
    with open(jax_out, "rb") as f:
        jax_ref = pickle.load(f)
    return {"ranks": ranks, "jax": jax_ref, "single": single, "cli": (cli, logs["cli"])}


def _case(worlds, world, name):
    every = worlds["ranks"][world][name]
    for r, (status, got) in enumerate(every):
        assert status == "ok", f"rank {r} of the {world}-rank world, case {name}:\n{got}"
    return [got for _, got in every]


def _ranks_agree(every):
    """Every rank made rank 0's decisions and counted what it counted."""
    for r, got in enumerate(every):
        assert got["decisions"] == every[0]["decisions"], f"rank {r}"
        assert got["handoff"] == every[0]["handoff"], f"rank {r}"


# ----------------------------------------------------- single process --


class _Grid:
    def __init__(self, shape):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)


class _StubMesh:
    """A mesh's names, sizes and rank grid, with no process group."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device_mesh = _Grid(tuple(shape.values()))


def test_split_refusals_carry_the_jax_messages():
    """``split_pod_meshes`` refuses a mesh with no pod axis and one pod (the
    JAX assertions, as errors with their messages); ``make_disagg_meshes``
    a world that is not 2 * tp ranks, in ranks (the JAX wording in
    devices); ``DisaggEngine`` a mesh and a pair together and half a pair
    (the JAX checks).  Pools of data > 1 and two devices in one process
    keep their refusals (ROADMAP A.13, A.8)."""
    import repro.core.disagg as JD
    import repro.serving.disagg.engine as JE

    from repro_torch.core.disagg import pool_devices, split_pod_meshes
    from repro_torch.serving import DisaggEngine
    from repro_torch.serving.disagg import make_disagg_meshes

    with pytest.raises(ValueError, match="spatial disaggregation needs a pod axis"):
        split_pod_meshes(_StubMesh({"data": 2, "model": 2}))
    with pytest.raises(ValueError, match="need >= 2 pods"):
        split_pod_meshes(_StubMesh({"pod": 1, "model": 2}))
    for text in ("spatial disaggregation needs a pod axis", "need >= 2 pods"):
        assert text in Path(JD.__file__).read_text()
    with pytest.raises(ValueError, match=r"need 2 ranks for two 1-wide pools, have 1"):
        make_disagg_meshes()
    with pytest.raises(ValueError, match=r"need 4 ranks for two 2-wide pools, have 1"):
        make_disagg_meshes(tp=2)
    assert "need {need} devices for two {tp}-wide pools, have" in Path(JE.__file__).read_text()
    cfg = model_config()
    params = _port_params(cfg)
    with pytest.raises(ValueError, match="not both"):
        DisaggEngine(cfg, params, mesh=_StubMesh({"pod": 2}), prefill_mesh=object(), **BASE)
    with pytest.raises(ValueError, match="go together"):
        DisaggEngine(cfg, params, decode_mesh=object(), **BASE)
    with pytest.raises(ValueError, match="needs a pod axis"):
        DisaggEngine(cfg, params, mesh=_StubMesh({"data": 1, "model": 2}), **BASE)
    with pytest.raises(ValueError, match="neither mesh is this rank's pod"):
        DisaggEngine(cfg, params, prefill_mesh=object(), decode_mesh=object(), **BASE)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        pool_devices("meta", "cpu")


def test_numpy_weights_part_the_engines_only_at_a_near_tie(worlds):
    """The port's one-device ``EngineCore`` on contiguous fp against the
    JAX engine, both on the latent weights ``test_torch_mesh.numpy_params``
    draws: every decode round's logits agree within 0.02 up to the first
    round whose argmax differs, and there both engines' two top tokens are
    the same pair within 0.005 of each other: a near tie of the two
    engines' float orders (r2's fourth token), not a fault of the decode
    path (ROADMAP C)."""
    want_streams, want = worlds["jax"]["numpy-fp"]
    got_streams, got = worlds["single"]["numpy-fp"]
    assert len(got) == len(want)
    for a, b in zip(want, got):
        parted = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
        assert np.abs(a - b).max() <= 0.02 or parted.size
        for s in parted:
            for row in (a[s], b[s]):
                top = np.argsort(-row)[:2]
                assert set(top) == {a[s].argmax(), b[s].argmax()}
                assert row[top[0]] - row[top[1]] <= 0.005
        if parted.size:
            break
    parts = [r for r in want_streams if want_streams[r] != got_streams[r]]
    assert parts == ["r2"] or not parts


def test_snapshot_keeps_the_device_names_on_one_device():
    """Without a mesh the ``disagg`` section names each pool's device as
    before; the channel counts no byte across pods."""
    from repro_torch.serving import DisaggEngine

    cfg = model_config()
    eng = DisaggEngine(cfg, _port_params(cfg), device="cpu", **BASE)
    snap = eng.snapshot()["disagg"]
    assert snap["prefill_pool"] == {"device": "cpu"} and snap["decode_pool"] == {"device": "cpu"}
    assert snap["handoff"]["pod_bytes"] == 0


# --------------------------------------------------------- the two worlds --


@pytest.mark.parametrize("case", list(CASES))
def test_pod_model1_gives_the_jax_disagg_mesh_tokens_and_counters(worlds, case):
    """(pod 2, model 1): the JAX ``DisaggEngine(mesh=)``'s tokens, token for
    token, and its segments, eager segments, installs and bytes shipped
    (each monolithic segment relaid to max_len rows; the chunks shipped as
    they finish), on every rank; the JAX split equals its one device."""
    every = _case(worlds, 2, f"engine-{case}")
    want = worlds["jax"][case]["disagg"]
    assert want["streams"] == worlds["jax"][case]["single"]["streams"]
    assert every[0]["got"]["streams"] == want["streams"]
    assert every[0]["handoff"] == dict(want["handoff"], pod_bytes=every[0]["handoff"]["pod_bytes"])
    _ranks_agree(every)
    for got in every:
        assert (got["disagg"]["prefill_pool"], got["disagg"]["decode_pool"]) == want["pools"]
    if case == "contiguous-fp":
        assert want["handoff"]["segments"] == 3 and want["handoff"]["eager_segments"] == 0
    else:
        assert want["handoff"]["eager_segments"] == 3 and want["handoff"]["installs"] == 6


def test_pod_model2_contiguous_gives_the_jax_colocated_mesh_tokens(worlds):
    """(pod 2, model 2), contiguous fp: the JAX colocated engine's tokens on
    (data 1, model 2) (where the JAX split does not run), which are also
    the JAX split's on (pod 2, model 1); the counters of the port's
    ``DisaggEngine`` on one device."""
    every = _case(worlds, 4, "engine-contiguous-fp")
    ref = worlds["jax"]["contiguous-fp"]
    assert ref["colocated_tp"]["streams"] == ref["disagg"]["streams"]
    assert every[0]["got"]["streams"] == ref["colocated_tp"]["streams"]
    single = worlds["single"]["contiguous-fp"]
    assert every[0]["handoff"] == dict(single["handoff"], pod_bytes=every[0]["handoff"]["pod_bytes"])
    _ranks_agree(every)
    for got in every:
        assert got["disagg"]["prefill_pool"] == {"devices": 2, "axes": {"model": 2}}
        assert got["disagg"]["decode_pool"] == {"devices": 2, "axes": {"model": 2}}


@pytest.mark.parametrize("case", ["paged-int8-chunked", "contiguous-int4-static", "sampled"])
def test_pod_model2_gives_the_one_device_disagg_tokens(worlds, case):
    """(pod 2, model 2), paged int8 with 8-token chunks (every chunk shipped
    eagerly, the installs deferred), contiguous int4 static and contiguous
    fp with the odd requests sampled: the port's ``DisaggEngine`` on one
    device, tokens and counters; the chunked case's are also the JAX
    split's on (pod 2, model 1)."""
    every = _case(worlds, 4, f"engine-{case}")
    single = worlds["single"][case]
    assert every[0]["got"] == single["got"]
    assert every[0]["handoff"] == dict(single["handoff"], pod_bytes=every[0]["handoff"]["pod_bytes"])
    _ranks_agree(every)
    if case == "paged-int8-chunked":
        assert single["got"]["streams"] == worlds["jax"][case]["disagg"]["streams"]
        assert every[0]["handoff"]["eager_segments"] == 3


def test_pod_bytes_are_each_ranks_part_of_the_segments(worlds):
    """What crosses between the pods on a rank: half of what it does on
    (pod 2, model 1) when two ranks each send a half (the segments' bytes
    plus each leaf's padding to 16 bytes, the same on both pods)."""
    for case in CASES:
        one = _case(worlds, 2, f"engine-{case}")[0]["handoff"]
        two = [got["handoff"] for got in _case(worlds, 4, f"engine-{case}")]
        assert one["pod_bytes"] >= one["bytes_shipped"]
        assert {h["pod_bytes"] for h in two} == {two[0]["pod_bytes"]}
        assert two[0]["bytes_shipped"] == one["bytes_shipped"]
        assert two[0]["bytes_shipped"] // 2 <= two[0]["pod_bytes"] < one["pod_bytes"]


def test_a_preempting_run_replays_to_the_same_tokens(worlds):
    """Paged int8, chunked, on 3 pages: the split preempts (its decode
    growth evicts), replays and gives the full pool's tokens and the
    one-device engine's counters; every page goes home on every rank."""
    every = _case(worlds, 4, "engine-preempting")
    single = worlds["single"]["preempting"]
    assert every[0]["preemptions"] == single["preemptions"] > 0
    assert every[0]["got"] == single["got"]
    assert every[0]["got"]["streams"] == worlds["single"]["paged-int8-chunked"]["got"]["streams"]
    assert every[0]["handoff"] == dict(single["handoff"], pod_bytes=every[0]["handoff"]["pod_bytes"])
    _ranks_agree(every)
    assert {got["live_pages"] for got in every} == {0}


def test_aborts_discard_on_both_pods(worlds):
    """An abort mid-chunked-prefill and one of a decoding request: each is
    an abort; the queued installs of the one mid-prefill are discarded on
    both pods, none stays pending, every page goes home on every rank, and
    the third request runs on; as on one device."""
    every = _case(worlds, 4, "engine-aborts")
    single = worlds["single"]["aborts"]
    assert every[0]["got"] == single["got"]
    assert list(single["got"]["aborted"].values()) == ["abort", "abort"]
    assert len(single["got"]["streams"]["r2"]) == MAX_NEW
    assert every[0]["handoff"] == dict(single["handoff"], pod_bytes=every[0]["handoff"]["pod_bytes"])
    assert single["handoff"]["discarded"] > 0 and single["handoff"]["pending"] == 0
    _ranks_agree(every)
    assert {got["live_pages"] for got in every} == {0}


def test_each_rank_sees_its_pool(worlds):
    """Each rank's pool mesh: the other axes with the pod's groups inside
    it, the pod group across the pods at its coordinates, the other pod's
    description; the (pod 2, model 1) world's pools of one rank each."""
    every = _case(worlds, 4, "groups")
    for r, got in enumerate(every):
        pod, at = divmod(r, 2)
        assert got["shape"] == {"model": 2} and got["size"] == 2 and got["axis_names"] == ("model",)
        assert got["model"] == at and got["pod"] == pod
        assert got["model_group"] == [2 * pod, 2 * pod + 1]
        assert got["pod_group"] == [at, 2 + at] and got["one"] == 1
        assert got["pod_ranks"] == (2 * pod, 2 * pod + 1)
        assert got["other"] == (1 - pod, (2 * (1 - pod), 2 * (1 - pod) + 1), {"model": 2})
        assert f"its pod {pod}" in got["describe"]
    for r, got in enumerate(_case(worlds, 2, "groups")):
        assert got["size"] == 1 and got["pod_group"] == [0, 1] and got["pod_ranks"] == (r,)


def test_a_quantized_tree_crosses_byte_for_byte(worlds):
    """``kv_transfer``: a ``QuantKV`` tree of an int8 payload (rank 5) and
    f32 scales (rank 4) from each prefill rank lands on the decode rank at
    its coordinates, bytes, shapes and dtypes equal, and both ends count
    the same bytes moved."""
    every = _case(worlds, 4, "quant_transfer")
    assert [got["role"] for got in every] == ["prefill", "prefill", "decode", "decode"]
    for got in every[2:]:
        assert got["payload_equal"] and got["scales_equal"]
        assert got["dtypes"] == ("torch.int8", "torch.float32")
        assert got["shapes"] == ((2, 2, 2, 8, 4), (2, 2, 2, 8))
    assert {got["moved"] for got in every} == {every[0]["moved"]}


def test_the_split_refuses_by_name(worlds):
    """On the split: a device given to a pool on a mesh, and pools with
    data > 1 (ROADMAP A.13).  Speculative decoding is taken (the tests
    below)."""
    for got in _case(worlds, 4, "refusals"):
        assert "pass no device" in got["device"]
    for got in _case(worlds, 4, "data_pools"):
        assert "ROADMAP A.13" in got


@pytest.mark.parametrize("case", ["spec-fp", "spec-paged-int8-chunked"])
def test_pod_model1_speculates_as_the_jax_split(worlds, case):
    """(pod 2, model 1) with ``spec_decode=2`` (paged int8 with 8-token
    chunks too): the JAX ``DisaggEngine(mesh=)``'s tokens, drafts, accepted
    tokens, verify rounds and chunks, the verify rounds on the decode pod
    and their targets broadcast to the prefill pod; every rank's decisions
    are rank 0's; and the port's one-device ``DisaggEngine``'s tokens."""
    every = _case(worlds, 2, f"engine-{case}")
    want = worlds["jax"][case]["disagg"]
    assert want["streams"] == worlds["single"][case]["got"]["streams"]
    assert every[0]["got"]["streams"] == want["streams"]
    assert {k: every[0]["decisions"][k] for k in SPEC_KEYS} == want["spec"]
    assert want["spec"]["verify_rounds"] > 0
    _ranks_agree(every)


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_pod_model2_speculates_and_follows_rank_0_as_one_device(worlds, case):
    """(pod 2, model 2): speculation on the split, and the swap-cost-aware
    policy decided by rank 0 for every rank: the port's ``DisaggEngine`` on
    one device (tokens; counters where no decision reads a clock), every
    rank's policy decisions rank 0's, the JAX split's tokens on (pod 2,
    model 1)."""
    every = _case(worlds, 4, f"engine-{case}")
    single = worlds["single"][case]
    assert every[0]["got"]["streams"] == single["got"]["streams"]
    assert every[0]["got"]["streams"] == worlds["jax"][case]["disagg"]["streams"]
    for got in every:
        assert got["policy"] == every[0]["policy"]
    if case == "swap-aware":
        assert {k for k, _ in every[0]["policy"]} >= {"prefill", "quanta"}
        for r, got in enumerate(every):
            assert got["decisions"] == every[0]["decisions"], f"rank {r}"
        return
    assert {k: every[0]["decisions"][k] for k in SPEC_KEYS} == {
        k: single["decisions"][k] for k in SPEC_KEYS}
    assert every[0]["handoff"] == dict(single["handoff"],
                                       pod_bytes=every[0]["handoff"]["pod_bytes"])
    _ranks_agree(every)


@pytest.mark.parametrize("case", list(TP_CASES))
def test_colocated_data1_model2_gives_the_jax_mesh_tokens(worlds, case):
    """``EngineCore`` on the 2-rank world's (data 1, model 2) mesh with
    ``spec_decode=2``, and under the swap-cost-aware policy: the tokens of
    the JAX engine on a (data 1, model 2) Auto-axes mesh, and with
    speculation its drafts, accepted tokens and verify rounds; every
    rank's decisions rank 0's."""
    every = _case(worlds, 2, case)
    ref = worlds["jax"][case]
    assert every[0]["got"]["streams"] == ref["colocated_tp"]["streams"]
    if case == "tp-spec-fp":
        assert {k: every[0]["decisions"][k] for k in SPEC_KEYS} == ref["colocated_tp"]["spec"]
        assert ref["colocated_tp"]["spec"]["verify_rounds"] > 0
    for r, got in enumerate(every):
        assert got["decisions"] == every[0]["decisions"], f"rank {r}"
        assert got["policy"] == every[0]["policy"], f"rank {r}"


def test_cli_disagg_on_a_world_gives_the_colocated_clis_tokens(worlds):
    """``launch.serve --disagg`` on 2 ranks from ``torch.distributed.run``
    (gloo, the default backend on the CPU): rank 0 prints the tokens and
    the ``KV handoff`` line of the CLI in one process (which colocates
    both pools and prints the JAX CLI's reason), and the bytes between the
    pods."""
    colocated, split = worlds["cli"]

    def lines(text, key):
        return [ln.strip() for ln in text.splitlines() if ln.strip().startswith(key)]

    assert "fewer than 2 local devices, colocating both pools" in colocated
    assert lines(split, "req-") == lines(colocated, "req-") and len(lines(split, "req-")) == 3
    assert lines(split, "KV handoff") == lines(colocated, "KV handoff")
    assert lines(split, "between the pods")
    assert sum("its pod" in ln for ln in split.splitlines()) == 2


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of the split tests' worlds")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.world, a.store, a.out)
