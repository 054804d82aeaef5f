"""The port's phase programs as captured units, held to the JAX package on the CPU.

The writers a captured program runs take no host read of which rows are
live: the paged scatter and the page write are held byte for byte against
``jax.jit`` of the JAX writers (``mode="drop"``), the chunk programs with
their slot, prefix length and last position as 0-d tensors against the
jitted JAX chunk programs, and the serving grid (``reachable_buckets``,
``reachable_chunk_shapes``, the program keys ``build_serving_grid``
builds) against the JAX engine's.  The quickstart's port gives the JAX
quickstart's greedy tokens.  On the CPU the programs run eagerly; their
graphs are held to the eager calls on the card (``tests/test_torch_gpu.py``).
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import contextlib
import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core.phase_engine import PhaseEngine as JPhaseEngine
from repro.layers import attention as JA
from repro.models import transformer as JT
from repro.quant.kv_quant import QuantKV as JQuantKV
from repro.serving import EngineCore as JEngineCore

from repro_torch.configs import reduced_config
from repro_torch.core.phase_engine import PhaseEngine, PhaseProgram, _rebuild, tensor_leaves
from repro_torch.core.staging import StagedTensor
from repro_torch.examples import quickstart as Q
from repro_torch.interop import params_from_numpy
from repro_torch.layers.attention import (
    KVCache,
    scatter_new_tokens_paged_q,
    write_prefill_pages_q,
)
from repro_torch.models import transformer as T
from repro_torch.quant.kv_quant import QuantKV, unpack_int4
from repro_torch.quant.ternary import TernaryWeight
from repro_torch.serving import EngineCore, Request
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)
MODEL_TOL = 1e-4  # f32 logits, summed in another order than XLA's
L, HKV, D, BS, N = 3, 2, 32, 8, 12  # the writers' pool: 12 pages of 8 positions


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    a = np.asarray(t)
    return (a.view(np.uint16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _planes(leaf):
    return list(leaf) if isinstance(leaf, (QuantKV, JQuantKV)) else [leaf]


def _pool(rng, kv_dtype, shape):
    """The same random pool for both packages: bf16 values, or random
    payload bytes with positive scales."""
    if kv_dtype == "fp":
        a = rng.normal(size=shape).astype(np.float32)
        return (jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16))
    d = shape[-1] // 2 if kv_dtype == "int4" else shape[-1]
    q = rng.integers(0 if kv_dtype == "int4" else -127, 255 if kv_dtype == "int4" else 128,
                     shape[:-1] + (d,)).astype(np.uint8 if kv_dtype == "int4" else np.int8)
    s = rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32)
    return (JQuantKV(jnp.asarray(q), jnp.asarray(s)),
            QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))


def _assert_same_bytes(got, want):
    for t, j in zip(_planes(got), _planes(want)):
        assert _bytes(t) == _bytes(j)


# ------------------------------------------------------- the masked writers --


@pytest.mark.parametrize("lengths", [[5, 17, 9, 30], [0, 17, 0, 0], [0, 0, 0, 3], [0, 0, 0, 0]],
                         ids=["all-live", "one-live", "last-live", "none-live"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_paged_scatter_byte_equal_jitted_jax(kv_dtype, lengths):
    """Every layer's new token into each slot's current page: the same
    bytes as the jitted JAX scatter, which drops inactive slots (length 0)
    through an out-of-range id.  Page 0 is a live slot's page, the page an
    inactive slot's table points at."""
    rng = np.random.default_rng(len(kv_dtype) * 7 + sum(lengths))
    jpool, pool = _pool(rng, kv_dtype, (N, L, HKV, BS, D))
    tables = np.array([[3, 9, 0, 0, 0], [7, 0, 4, 0, 0], [0, 0, 0, 0, 0], [2, 5, 11, 6, 0]],
                      np.int32)
    lens = np.asarray(lengths, np.int32)
    new = rng.normal(size=(L, 4, HKV, 1, D)).astype(np.float32)
    want = jax.jit(JA.scatter_new_tokens_paged_q)(jpool, jnp.asarray(new), jnp.asarray(tables),
                                                  jnp.asarray(lens))
    got = scatter_new_tokens_paged_q(pool, torch.from_numpy(new), torch.from_numpy(tables),
                                     torch.from_numpy(lens))
    _assert_same_bytes(got, want)


@pytest.mark.parametrize("ids", [[3, N, 0, 7], [N, N, N, N], [5, 0, 9, 2], [N, N, N, 4]],
                         ids=["some-skipped", "all-skipped", "none-skipped", "last-kept"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_page_write_byte_equal_jitted_jax(kv_dtype, ids):
    """A prompt's KV (4 pages of 8) into its pages, ids >= N skipped: the
    same bytes as the jitted JAX page write, the skipped pages untouched."""
    rng = np.random.default_rng(len(kv_dtype) + sum(ids))
    jpool, pool = _pool(rng, kv_dtype, (N, L, HKV, BS, D))
    kv = rng.normal(size=(L, 1, HKV, 4 * BS, D)).astype(np.float32)
    page_ids = np.asarray(ids, np.int32)
    want = jax.jit(JA.write_prefill_pages_q, static_argnames="block_size")(
        jpool, jnp.asarray(kv), jnp.asarray(page_ids), block_size=BS)
    got = write_prefill_pages_q(pool, torch.from_numpy(kv), torch.from_numpy(page_ids),
                                block_size=BS)
    _assert_same_bytes(got, want)


# ------------------------------------------------------- the chunk programs --


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunk_programs_with_device_scalars_match_jitted_jax(tiny, layout, kv_dtype):
    """Two chunks (16 real tokens, then 9 padded to 16 at prefix width 16)
    through the chunk programs, the port's slot, prefix length and last
    position given as 0-d int32 tensors.  Against the same program given
    Python ints: every byte and logit equal.  Against the jitted JAX
    program: the logits within 1e-4 and, on the prompt's positions, the
    bf16 rows and int8 payloads byte for byte.  The K/V values differ from
    XLA's by float rounding (RMSNorm's sum, RoPE's sin and cos), so an f32
    scale plane is held within 1e-6 relative, and an int4 payload, whose
    steps are coarse, to at most one step on under 1 % of its values."""
    cfg_j, params_j, cfg_t, params_t = tiny
    tokens = np.random.default_rng(9).integers(0, 512, 25).astype(np.int32)
    shape = (3, 1, 2, 64, 32)
    jprefix = JA.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    jeng = JPhaseEngine(cfg_j, mesh=None, max_len=64, cache_layout=layout, kv_dtype=kv_dtype)
    eng = PhaseEngine(cfg_t, cache_layout=layout, kv_dtype=kv_dtype)
    if layout == "paged":
        jcache = JT.init_paged_pool(cfg_j, 8, 8, kv_dtype=kv_dtype)
        caches = [T.init_paged_pool(cfg_t, 8, 8, kv_dtype=kv_dtype, device="cpu") for _ in "ab"]
    else:
        jcache = JT.init_cache(cfg_j, 2, 64, kv_dtype=kv_dtype)
        caches = [T.init_cache(cfg_t, 2, 64, kv_dtype=kv_dtype, device="cpu") for _ in "ab"]
    prefixes = [KVCache(torch.zeros(shape), torch.zeros(shape)) for _ in "ab"]
    scalar = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for start, size, width, ids in ((0, 16, 0, [5, 2]), (16, 9, 16, [7, 8])):
        buf = np.zeros((1, 16), np.int32)
        buf[0, :size] = tokens[start:start + size]
        tok = torch.from_numpy(buf).long()
        if layout == "paged":  # id 8 = N: the padding page, skipped
            jprog = jeng.paged_prefill_chunk_program(16, 8, 8, width)
            prog = eng.paged_prefill_chunk_program(16, 8, 8, width)
            jl, jcache, jprefix = jprog.fn(params_j, jnp.asarray(buf), jcache, jprefix,
                                           jnp.asarray(ids, jnp.int32), start, size - 1)
            pid = torch.tensor(ids, dtype=torch.int32)
            tl, _, _ = prog(params_t, tok, caches[0], prefixes[0], pid, scalar(start),
                            scalar(size - 1))
            il, _, _ = prog.fn(params_t, tok, caches[1], prefixes[1], pid, start, size - 1)
        else:
            jprog = jeng.prefill_chunk_program(16, 2, 64, width)
            prog = eng.prefill_chunk_program(16, 2, 64, width)
            jl, jcache, jprefix = jprog.fn(params_j, jnp.asarray(buf), jcache, jprefix, 1, start,
                                           size - 1)
            tl, _, _ = prog(params_t, tok, caches[0], prefixes[0], scalar(1), scalar(start),
                            scalar(size - 1))
            il, _, _ = prog.fn(params_t, tok, caches[1], prefixes[1], 1, start, size - 1)
        assert torch.equal(tl, il)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=0)
    for a, b in zip(list(caches[0]) + list(prefixes[0]), list(caches[1]) + list(prefixes[1])):
        _assert_same_bytes(a, b)
    for leaf, jleaf in zip(caches[0], jcache):
        for t, j in zip(_planes(leaf), _planes(jleaf)):
            if layout == "paged":  # pages 5, 2, 7: positions [0, 24) of the prompt
                t, j = t[[5, 2, 7]], np.asarray(j)[[5, 2, 7]]
            else:
                t, j = t[1, :, :, :25], np.asarray(j)[1, :, :, :25]
            if t.dtype == torch.float32:  # a scale plane
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
            elif kv_dtype == "int4":
                step = (unpack_int4(t).int() - unpack_int4(torch.from_numpy(j)).int()).abs()
                assert step.max() <= 1 and (step > 0).float().mean() < 0.01
            else:
                assert _bytes(t.contiguous()) == _bytes(np.ascontiguousarray(j))


def test_runner_refuses_a_chunk_past_the_cache(tiny):
    """The chunk program writes at a device position; the runner checks the
    rows on the host first."""
    _, _, cfg_t, params_t = tiny
    eng = EngineCore(cfg_t, params_t, n_slots=1, max_len=64, prefill_chunk=16, device="cpu")
    req = Request("r", np.arange(30, dtype=np.int32), max_new=2)
    with pytest.raises(ValueError, match="overflow"):
        eng.runner.run_prefill_chunk(req, 0, 56, 16, None, False, eng.stats)


# ---------------------------------------------------------- the serving grid --

GRIDS = {
    "contiguous": dict(mode="pdswap"),
    "contiguous-static": dict(mode="static"),
    "paged": dict(cache_layout="paged", kv_dtype="int8"),
    "chunked-contiguous": dict(prefill_chunk=16),
    "chunked-paged": dict(cache_layout="paged", prefill_chunk=16, kv_dtype="int4"),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_serving_grid_equals_jax(tiny, name):
    """``reachable_buckets``, ``reachable_chunk_shapes`` and the program
    keys after ``build_serving_grid`` equal the JAX engine's."""
    cfg_j, params_j, cfg_t, params_t = tiny
    kw = dict(n_slots=3, max_len=96, prompt_len=12, block_size=8, **GRIDS[name])
    jeng = JEngineCore(cfg_j, params_j, **kw)
    eng = EngineCore(cfg_t, params_t, device="cpu", **kw)
    assert eng.runner.reachable_buckets() == jeng.runner.reachable_buckets()
    assert eng.runner.reachable_chunk_shapes() == jeng.runner.reachable_chunk_shapes()
    assert bool(eng.runner.reachable_chunk_shapes()) == ("prefill_chunk" in kw)
    jeng.runner.build_serving_grid()
    eng.build_serving_grid()
    assert set(eng.runner.engine.programs) == set(jeng.runner.engine.programs)


def test_grid_built_engine_serves_the_same_tokens(tiny):
    """Building the grid first (on the CPU: the programs, no capture)
    changes no token; an engine with a request in flight refuses it."""
    _, _, cfg_t, params_t = tiny
    prompts = [np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
               for i, n in enumerate((7, 20, 33))]
    streams = []
    for build in (False, True):
        eng = EngineCore(cfg_t, params_t, n_slots=2, max_len=64, cache_layout="paged",
                         block_size=8, prefill_chunk=16, device="cpu")
        if build:
            eng.build_serving_grid()
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=5))
        eng.step()
        if build:
            with pytest.raises(RuntimeError, match="before any request"):
                eng.build_serving_grid()
        eng.run()
        streams.append({k: r.out_tokens for k, r in eng.finished.items()})
    assert streams[0] == streams[1]


# ------------------------------------------------------------- the programs --


def test_program_refuses_another_cache(tiny):
    """The decode program keeps its params and cache (the JAX program
    donates them): called with another cache tensor, or other params, it
    raises, on every device."""
    _, _, cfg_t, params_t = tiny
    eng = PhaseEngine(cfg_t)
    prog = eng.decode_program(2, 16)
    cache = T.init_cache(cfg_t, 2, 16, device="cpu")
    token, lengths = torch.tensor([3, 5]), torch.tensor([2, 4], dtype=torch.int32)
    prog(params_t, token, cache, lengths)
    prog(params_t, token + 1, cache, lengths + 1)  # other tokens and lengths: fine
    with pytest.raises(ValueError, match="argument 2"):
        prog(params_t, token, T.init_cache(cfg_t, 2, 16, device="cpu"), lengths)
    with pytest.raises(ValueError, match="argument 0"):
        prog({**params_t, "emb": params_t["emb"].clone()}, token, cache, lengths)
    assert eng.programs["decode:2x16"] is prog and prog.capturable
    assert not eng.prefill_program_varlen(1, 16).capturable  # monolithic prefill: eager


def test_captured_programs_hold_no_host_sync():
    """The code the decode, chunk and sampler programs run reads nothing
    back to the host and builds no tensor from host values: no
    ``nonzero``, ``.item()``, ``.cpu()``, ``.tolist()`` or ``torch.tensor``."""
    import inspect

    from repro_torch.core import sampling
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.tlmm import ops as tops
    from repro_torch.layers import attention, linear, mlp, norm, rotary

    fns = [T.decode_step, T.decode_step_paged, T._decode_layers, T.prefill_chunk,
           T.prefill_chunk_paged, T._prefill_chunk_body, T._at, T._embed, T._logits,
           attention._project_qkv, attention.attention_prefill_chunk, attention.write_chunk_kv,
           attention.write_chunk_kv_q, attention.scatter_new_tokens,
           attention.scatter_new_tokens_q, attention._first_kept,
           attention.scatter_new_tokens_paged, attention.scatter_new_tokens_paged_q,
           attention.write_prefill_pages, attention.write_prefill_pages_q,
           attention._merge_new_token, attention._decode_new_token, attention.attention_decode,
           attention.attention_decode_paged, linear.linear_apply, mlp.mlp_apply,
           norm.apply_norm, rotary.apply_rope, tops.tlmm_matmul,
           tops.act_quant_kernel, tops.tlmm_kernel, dops.decode_attention,
           pops.paged_decode_attention, sampling.sample_tokens, sampling.filter_logits,
           sampling.categorical, sampling.random_bits, sampling.fold_in, sampling.prng_key]
    for fn in fns:
        src = inspect.getsource(fn)
        for bad in ("nonzero", ".item(", ".cpu(", ".tolist(", "torch.tensor("):
            assert bad not in src, (fn.__qualname__, bad)


def test_tensor_leaves_round_trip():
    """The argument trees a program takes flatten to their tensors in a
    fixed order and rebuild with others in their place; any other leaf is
    refused (a graph would bake its value in)."""
    t = [torch.full((2,), float(i)) for i in range(6)]
    tree = {"a": t[0], "w": TernaryWeight(t[1], t[2]),
            "kv": KVCache(QuantKV(t[3], t[4]), t[5])}
    leaves = tensor_leaves(tree)
    assert [x.data_ptr() for x in leaves] == [x.data_ptr() for x in t]
    fresh = [x + 10 for x in leaves]
    back = _rebuild(tree, iter(fresh))
    assert isinstance(back["w"], TernaryWeight) and isinstance(back["kv"].k, QuantKV)
    assert [x.data_ptr() for x in tensor_leaves(back)] == [x.data_ptr() for x in fresh]
    with pytest.raises(TypeError, match="tensors only"):
        tensor_leaves((t[0], 3))
    prog = PhaseProgram("p", lambda a, b: a + b, capturable=True)
    assert prog(torch.ones(2), 3).tolist() == [4.0, 4.0]  # CPU: eager, ints allowed


def test_staged_tensor_writes_in_place():
    s = StagedTensor((2, 3), torch.int32, "cpu")
    dev = s.dev
    assert s.upload(np.arange(6).reshape(2, 3)) is dev
    assert dev.tolist() == [[0, 1, 2], [3, 4, 5]]
    s.upload(7)
    assert (dev == 7).all()


# --------------------------------------------------------------- quickstart --


@pytest.fixture(scope="module")
def jax_quickstart_tokens():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"),
                       run_name="__main__")
    line = next(x for x in out.getvalue().splitlines() if x.startswith("decoded"))
    return [int(v) for v in line.split("[")[1].rstrip("]").split(",")]


def test_quickstart_weights_are_the_jax_init():
    """The port's draw of the quickstart's weights from PRNGKey(0): the
    JAX package's init to float rounding (threefry bits exact, the inverse
    error function's polynomial in another rounding)."""
    from repro.models import get_model

    cfg = Q.quickstart_config()
    cfg_j = jcfgs.reduced_config("bitnet-730m", num_layers=4, d_model=256, vocab_size=1024)
    want = get_model(cfg_j).init(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    got = Q.init_like_jax(cfg, 0, "cpu")
    np.testing.assert_allclose(got["emb"].numpy(), np.asarray(want["emb"]), rtol=1e-6, atol=1e-9)
    for g, n in T.LINEARS:
        np.testing.assert_allclose(got["layers"][g][n]["w"].numpy(),
                                   np.asarray(want["layers"][g][n]["w"]), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("overlap", [True, False])
def test_quickstart_gives_jax_quickstart_tokens(jax_quickstart_tokens, overlap):
    """The port's quickstart — split prefill, the swap overlapped or not,
    greedy decode through the decode program — gives the tokens the JAX
    quickstart prints."""
    cfg = Q.quickstart_config()
    params = Q.init_like_jax(cfg, 0, "cpu")
    got = Q.run(params, cfg, device=torch.device("cpu"), overlap=overlap, log=lambda *a: None)
    assert got == jax_quickstart_tokens and len(got) == Q.N_NEW


def test_quickstart_parting_finds_the_first_other_token():
    """``parting``: None on the JAX quickstart's tokens; else the first step
    where they differ and how far that step's logits put the token picked
    above the JAX quickstart's."""
    want = list(Q.JAX_QUICKSTART_TOKENS)
    rows = [torch.zeros(1024) for _ in want]
    assert Q.parting(want, rows) is None
    got = want[:2] + [352] + want[3:5] + [9] + want[6:]
    rows[2][352], rows[2][want[2]] = 0.5, 0.25
    assert Q.parting(got, rows) == (2, 0.25)


def test_quickstart_cli_prints_the_jax_tokens(jax_quickstart_tokens, capsys):
    """``python -m repro_torch.examples.quickstart --device cpu`` exits 0
    printing the JAX quickstart's tokens for both swaps; the constant it
    holds them to is what the JAX quickstart prints."""
    assert Q.JAX_QUICKSTART_TOKENS == jax_quickstart_tokens
    assert Q.main(["--device", "cpu"]) == 0
    printed = [x for x in capsys.readouterr().out.splitlines() if x.startswith("decoded")]
    assert printed == [f"decoded {Q.N_NEW} tokens: {jax_quickstart_tokens}"] * 2
