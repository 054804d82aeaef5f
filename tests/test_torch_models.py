"""The rest of the transformer family in the port, against the JAX package
on the CPU: the registry (every arch of the JAX registry) and its arithmetic, the MoE layer, the weight
draws, greedy streams of reduced qwen2.5-14b, granite-moe-3b-a800m and
moonshot-v1-16b-a3b against a live JAX engine, the CLI's default arch, and
``EngineCore.generate``'s defaults.

Engines run f32 params with the JAX Pallas kernels in interpret mode
(``use_pallas=True``), as the earlier slices' tests run them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.configs import base as jbase
from repro.layers import moe as JM
from repro.layers.sharding import NULL_CTX
from repro.models import transformer as JT
from repro.serving import EngineCore as JEngineCore, Request as JRequest

from repro_torch import configs as C
from repro_torch.configs import base as B
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.layers import moe as M
from repro_torch.models import encdec as E
from repro_torch.models import hymba as H
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.jax_init import init_like_jax
from repro_torch.serving import EngineCore, Request, SamplingParams
from test_torch_frontend import _jax_kernel_path_main, _printed
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy
from test_torch_spec import SPEC_COUNTERS, _serve

KNOBS = ("use_pallas", "attn_impl")  # the JAX execution knobs the port has not
MOE_F32_TOL = 1e-5
# bf16 expert products: XLA and PyTorch round each product's f32 sum to bf16,
# and a sum taken in another order can land one bf16 ulp apart, 2^-6 for the
# outputs here (|y| < 4); the two packages measured bit-equal on the CPU
MOE_BF16_TOL = 2.0**-6


def _port_config(jc) -> B.ModelConfig:
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name not in KNOBS}
    fields["quant"] = B.QuantConfig(**dataclasses.asdict(jc.quant))
    return B.ModelConfig(**fields)


# ---------------------------------------------------------------- registry --


@pytest.mark.parametrize("arch", jcfgs.ALL_ARCHS)
def test_config_fields_and_arithmetic_equal_jax(arch):
    """Every field of the JAX config (less its execution knobs) and its
    derived numbers; the port's registry holds every arch with the JAX
    values, its reduced config the JAX one, and ``get_model`` gives the
    family's module."""
    jc = jcfgs.get_config(arch)
    pc = _port_config(jc)
    for name in ("param_count", "active_param_count"):
        assert getattr(pc, name)() == getattr(jc, name)(), name
    for name in ("ffn_hidden", "attention_free", "sub_quadratic", "q_group", "head_dim"):
        assert getattr(pc, name) == getattr(jc, name), name
    assert pc.padded_vocab() == jc.padded_vocab()
    assert [dataclasses.asdict(c) for c in B.applicable_shapes(pc)] == [
        dataclasses.asdict(c) for c in jbase.applicable_shapes(jc)]
    assert {k: dataclasses.asdict(v) for k, v in B.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert arch in C.ALL_ARCHS
    assert C.get_config(arch) == pc
    assert C.reduced_config(arch) == _port_config(jcfgs.reduced_config(arch))
    assert C.get_config(arch, quant_mode="ternary") == _port_config(
        jcfgs.get_config(arch, quant_mode="ternary"))
    api = R.get_model(pc)
    mod = {"transformer": T, "hymba": H, "xlstm": X, "encdec": E}[jc.family]
    assert api.init is mod.init and api.decode_step is mod.decode_step and api.module is mod
    assert api.forward_prefill is mod.forward_prefill and api.init_cache is mod.init_cache


def test_registry_lists_the_transformer_family():
    """The registry lists every arch of the JAX registry, eleven, of which
    the transformer family is eight."""
    family = sorted(a for a in jcfgs.ALL_ARCHS if jcfgs.get_config(a).family == "transformer")
    assert sorted(C.ALL_ARCHS) == sorted(jcfgs.ALL_ARCHS) and len(C.ALL_ARCHS) == 11
    assert sorted(a for a in C.ALL_ARCHS if C.get_config(a).family == "transformer") == family
    assert len(family) == 8


# --------------------------------------------------------------------- MoE --


def _moe_params(cfg, rng, dtype=np.float32, router_bias=0.0):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    router = rng.normal(size=(d, e)) / d**0.5
    router[:, 0] += router_bias  # skews every token towards expert 0: drops
    return {"router": router.astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / d**0.5).astype(dtype),
            "w_up": (rng.normal(size=(e, d, f)) / d**0.5).astype(dtype),
            "w_down": (rng.normal(size=(e, f, d)) / f**0.5).astype(dtype)}


def _torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("t,k,e,bias", [(16, 2, 4, 0.0), (40, 2, 4, 3.0), (64, 8, 40, 2.0),
                                        (4, 6, 64, 0.0)])
def test_route_equals_jax(t, k, e, bias):
    """token_idx and dest bit for bit (dest encodes each kept assignment's
    rank; a dropped one points at the spare row E*C), the combine weights
    and the probabilities within 1e-6; a biased router drops tokens."""
    rng = np.random.default_rng(t + e)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    logits[:, 0] += bias
    cap = max(8, int(t * k / e * 1.25))
    jt = [np.asarray(a) for a in JM._route(jnp.asarray(logits), k, cap, e)]
    pt = [a.numpy() for a in M._route(torch.from_numpy(logits), k, cap, e)]
    np.testing.assert_array_equal(pt[0], jt[0])
    np.testing.assert_array_equal(pt[1], jt[1])
    np.testing.assert_allclose(pt[2], jt[2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(pt[3], jt[3], atol=1e-6, rtol=0)
    if bias:
        assert (jt[1] == e * cap).any()  # some assignments were dropped


@pytest.mark.parametrize("dtype,mode", [("f32", "bf16"), ("f32", "ternary"), ("bf16", "bf16"),
                                        ("bf16", "ternary")])
def test_moe_apply_equals_jax(dtype, mode):
    """``moe_apply`` against the JAX ``moe_apply`` (no mesh): y and the aux
    loss, for f32 and bf16 params and activations, under bf16 (dense
    experts) and ternary quant (one absmean over the layer's whole stack),
    with a router biased so that tokens drop; and past a lowered token chunk,
    where the last chunk's zero padding routes too."""
    cfg_j = jcfgs.reduced_config("granite-moe-3b-a800m", quant=jcfgs.QuantConfig(mode=mode))
    cfg_t = _port_config(cfg_j)
    npdt = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(3)
    p = _moe_params(cfg_t, rng, npdt, router_bias=1.5)
    x = rng.normal(size=(2, 20, cfg_t.d_model)).astype(npdt)
    yj, auxj = JM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg_j, NULL_CTX)
    pt = {k: _torch(v) for k, v in p.items()}
    yt, auxt = M.moe_apply(pt, _torch(x), cfg_t)
    assert yt.dtype == _torch(x).dtype and yt.shape == x.shape
    tol = MOE_F32_TOL if dtype == "f32" else MOE_BF16_TOL
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    # 40 rows in chunks of 16: three chunks, the last padded with 8 zero rows
    xf, gl = x.reshape(40, -1), (x.reshape(40, -1).astype(np.float32) @ p["router"])
    want = JM._moe_tokens_chunked(jnp.asarray(xf), jnp.asarray(gl), jax.tree.map(jnp.asarray, p),
                                  cfg_j, training=False, tp_axis=None, ep=False, chunk=16)
    got = M._moe_tokens_chunked(_torch(xf), torch.from_numpy(gl), pt, cfg_t, chunk=16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_moe_layer_stays_on_device():
    """No host read in the routed layer: the counts are a scatter over the
    experts, so the same code serves every row count the programs route."""
    import ast
    import inspect

    called = {node.func.attr for node in ast.walk(ast.parse(inspect.getsource(M)))
              if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}
    assert "scatter_add_" in called
    assert not called & {"bincount", "nonzero", "item", "tolist", "masked_select", "unique"}


# --------------------------------------------------------------- weights --


def _jax_tree_numpy(params):
    return jax.tree.map(lambda a: np.asarray(a), params)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-moe-3b-a800m"])
def test_init_like_jax_and_interop_equal_the_jax_init(arch):
    """A biased, untied tree (qwen) and an MoE tree (granite): the port's
    ``init_like_jax`` draws the JAX ``init``'s f32 weights to float
    rounding (threefry bits exact, the inverse error function's polynomial
    rounded in another order, as ``test_quickstart_weights_are_the_jax_init``
    holds the dense tree), the tree's leaves, shapes and zero biases exact;
    ``params_from_numpy`` carries them over byte for byte (MoE stacks are
    no ``"w"`` leaves: they stay dense)."""
    cfg_j = jcfgs.reduced_config(arch, quant=jcfgs.QuantConfig(mode="bf16"))
    cfg_t = _port_config(cfg_j)
    want = _jax_tree_numpy(JT.init(cfg_j, jax.random.PRNGKey(7), dtype=jnp.float32))
    got = init_like_jax(cfg_t, 7, "cpu")
    carried = params_from_numpy(want, cfg_t, device="cpu")

    def check(a, b, c, path):
        if isinstance(a, dict):
            assert set(a) == set(b) == set(c), path
            for k in a:
                check(a[k], b[k], c[k], path + "/" + k)
            return
        assert b.dtype == c.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-9, err_msg=path)
        if not a.any():  # biases: zeros in both
            assert not b.any(), path
        np.testing.assert_array_equal(c.numpy(), a, err_msg=path)

    check(want, got, carried, "")
    assert ("lm_head" in want) == (not cfg_t.tie_embeddings)
    assert ("moe" in want["layers"]) == cfg_t.moe


def test_init_draws_bf16_layers_and_keeps_router_norms_latent():
    """``init`` defaults to bf16 (the JAX ``init``'s dtype): linears, biases,
    head and expert stacks in bf16, norms and the router in f32, biases
    zero; a ternary config keeps its latent f32 weights."""
    for arch in ("qwen2.5-14b", "granite-moe-3b-a800m"):
        cfg = C.reduced_config(arch)
        p = T.init(cfg, 1, device="cpu")
        f32 = T.init(cfg, 1, device="cpu", dtype=torch.float32)
        assert p["emb"].dtype == torch.bfloat16 and p["layers"]["ln1"]["scale"].dtype == torch.float32
        torch.testing.assert_close(p["emb"], f32["emb"].to(torch.bfloat16), rtol=0, atol=0)
        if cfg.moe:
            assert p["layers"]["moe"]["router"].dtype == torch.float32
            assert p["layers"]["moe"]["w_down"].shape == (2, 4, 64, 128)
            assert p["layers"]["moe"]["w_up"].dtype == torch.bfloat16 and "mlp" not in p["layers"]
        else:
            b = p["layers"]["attn"]["wq"]["b"]
            assert b.dtype == torch.bfloat16 and not b.any() and p["lm_head"].dtype == torch.bfloat16
    tern = C.reduced_config("granite-moe-3b-a800m", quant=B.QuantConfig(mode="ternary"))
    p = T.convert_for_inference(T.init(tern, 2, device="cpu"), tern)
    assert p["layers"]["moe"]["w_gate"].dtype == torch.float32  # stays latent
    assert type(p["layers"]["attn"]["wq"]["w"]).__name__ == "TernaryWeight"


# ---------------------------------------------------------------- streams --


def _family_params(cfg, seed):
    """f32 weights in the JAX tree layout with nonzero biases (qwen), an
    untied head, or MoE layers in place of the MLPs."""
    tree = _numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    L = cfg.num_layers
    if cfg.qkv_bias:
        for n, width in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads), ("wv", cfg.num_kv_heads)):
            tree["layers"]["attn"][n]["b"] = (0.1 * rng.normal(size=(L, width * cfg.head_dim))
                                              ).astype(np.float32)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (rng.normal(size=(cfg.d_model, cfg.padded_vocab())) * 0.02
                           ).astype(np.float32)
    if cfg.moe:
        del tree["layers"]["mlp"]
        layers = [_moe_params(cfg, rng) for _ in range(L)]
        tree["layers"]["moe"] = {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
    return tree


@pytest.fixture(scope="module")
def family():
    out = {}
    for arch in ("qwen2.5-14b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b"):
        cfg_j = jcfgs.reduced_config(arch, use_pallas=True)
        cfg_t = _port_config(cfg_j)
        tree = _family_params(cfg_t, seed=5)
        out[arch] = (cfg_j, jax.tree.map(jnp.asarray, tree), cfg_t,
                     params_from_numpy(tree, cfg_t, device="cpu"))
    return out


def _family_prompts(seed=9):
    """Three ragged prompts: 5 and 9 tokens pad to a bucket (whose pad rows
    claim MoE capacity), 21 tokens; one repeats a pattern (the drafter's
    regime)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 256, 7).astype(np.int32)
    return [rng.integers(0, 256, 5).astype(np.int32), np.tile(pat, 3),
            rng.integers(0, 256, 9).astype(np.int32)]


STREAM_CASES = [  # arch, layout, kv_dtype, prefill chunk, spec depth
    ("qwen2.5-14b", "contiguous", "fp", None, None),
    ("qwen2.5-14b", "paged", "int8", 8, None),
    ("granite-moe-3b-a800m", "contiguous", "fp", None, None),
    ("granite-moe-3b-a800m", "paged", "int8", 8, None),
    # spec: an int8 cache, where the JAX verify pass reads what its decode
    # reads (over a bf16 cache it rounds q and p to bf16, a reference trait
    # the port does not follow, ROADMAP C; an MoE router turns that into
    # another stream)
    ("granite-moe-3b-a800m", "contiguous", "int8", None, 2),
    ("moonshot-v1-16b-a3b", "contiguous", "fp", None, None),
]


@pytest.mark.parametrize("arch,layout,kv_dtype,chunk,spec", STREAM_CASES)
def test_family_greedy_streams_equal_jax(family, arch, layout, kv_dtype, chunk, spec):
    """Greedy streams token for token against the live JAX engine (its spec
    engine under ``spec_decode``, counters included: the capacity of a
    verify round's B x W rows is not a decode step's, so an MoE spec stream
    is held to the JAX spec engine, not to the port's plain run)."""
    cfg_j, params_j, cfg_t, params_t = family[arch]
    prompts = _family_prompts()
    kw = dict(cache_layout=layout, kv_dtype=kv_dtype, mode="pdswap", prefill_chunk=chunk,
              spec_decode=spec, max_new=7)
    got = _serve(EngineCore, Request, cfg_t, params_t, prompts, device="cpu", **kw)
    want = _serve(JEngineCore, JRequest, cfg_j, params_j, prompts, **kw)
    assert got[2] == want[2]
    assert [getattr(got[1], c) for c in SPEC_COUNTERS] == [getattr(want[1], c)
                                                            for c in SPEC_COUNTERS]
    if chunk:
        assert got[1].prefill_chunks == want[1].prefill_chunks > len(prompts)
    if spec:
        assert got[1].verify_rounds > 0


# -------------------------------------------------------------------- CLI --


def test_cli_default_arch_is_smollm_and_prints_the_jax_clis_tokens():
    """The CLI's default arch is the JAX CLI's (smollm-135m); at reduced
    size on the CPU it prints the JAX CLI's tokens."""
    assert serve.parse_args([]).arch == "smollm-135m"
    args = ["--arch", "smollm-135m", "--reduced", "--requests", "3", "--prompt-len", "12",
            "--max-new", "5", "--max-len", "48"]
    got, text = _printed(serve.main, args + ["--device", "cpu"])
    want, _ = _printed(_jax_kernel_path_main, args)
    assert got == want and len(got) == 3
    assert "requests finished : 3/3" in text


# --------------------------------------------------------------- generate --


@pytest.fixture(scope="module")
def bitnet():
    cfg_t = C.reduced_config("bitnet-730m")
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    return cfg_j, params_j, cfg_t, params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")


def test_unbudgeted_paged_generate_clamps_to_the_pool_as_jax(bitnet):
    """4 pages of 8 tokens, max_len 64, a 12-token prompt, no budget: the
    JAX engine streams pool_tokens - 12 + 1 = 21 tokens and ends by length;
    the port streams the same tokens (it used to raise)."""
    cfg_j, params_j, cfg_t, params_t = bitnet
    prompt = np.random.default_rng(3).integers(0, 256, 12).astype(np.int32)
    kw = dict(n_slots=1, max_len=64, prompt_len=16, cache_layout="paged", block_size=8,
              num_blocks=4)
    want = list(JEngineCore(cfg_j, params_j, **kw).generate(prompt))
    got = list(EngineCore(cfg_t, params_t, device="cpu", **kw).generate(prompt))
    assert want[-1].finish_reason == got[-1].finish_reason == "length"
    assert len(want[-1].token_ids) == 21
    assert got[-1].token_ids == want[-1].token_ids
    # a budget in the sampling parameters still overrides the headroom
    short = list(EngineCore(cfg_t, params_t, device="cpu", **kw).generate(
        prompt, SamplingParams(max_tokens=3)))
    assert short[-1].token_ids == want[-1].token_ids[:3]


def test_generate_priority_picks_the_preemption_victim(bitnet):
    """Two requests outgrow a 5-page pool: the older one submitted at
    priority 0, the generated one at priority 1.  The victim is the older
    one in both packages (without the keyword the younger would go), and
    the streams are the JAX engine's."""
    cfg_j, params_j, cfg_t, params_t = bitnet
    rng = np.random.default_rng(8)
    p0, p1 = (rng.integers(0, 256, 14).astype(np.int32) for _ in range(2))
    kw = dict(n_slots=2, max_len=64, prompt_len=16, cache_layout="paged", block_size=8,
              num_blocks=5)
    runs = []
    for eng, req in ((JEngineCore(cfg_j, params_j, **kw), JRequest),
                     (EngineCore(cfg_t, params_t, device="cpu", **kw), Request)):
        victims = []
        sched = eng.scheduler
        preempt = sched.preempt

        def logged(slot, stats, sched=sched, preempt=preempt, victims=victims):
            victims.append(sched.inflight[slot].request_id)
            preempt(slot, stats)

        sched.preempt = logged
        eng.submit(req("old", p0, max_new=20))
        outs = list(eng.generate(p1, max_new=20, priority=1, request_id="new"))
        eng.run()
        runs.append((victims, outs[-1].token_ids, eng.finished["old"].out_tokens,
                     eng.stats.preemptions))
    assert runs[0][0] and set(runs[0][0]) == {"old"}
    assert runs[1] == runs[0]
