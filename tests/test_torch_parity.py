"""The PyTorch port against the JAX package, on the CPU at reduced size.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode, ``use_pallas=True``, on weights packed
by ``jax.vmap(quantize_and_pack)``) and through the port's counterpart (the
plain PyTorch version of each kernel, since these tensors lie on the CPU).
Integer work is compared bit for bit, float work within a stated tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.prefill_attention.kernel import prefill_attention_pallas
from repro.kernels.tlmm.kernel import tlmm_pallas
from repro.kernels.tlmm.ops import tlmm_matmul as j_tlmm_matmul
from repro.models import transformer as JT
from repro.quant.act_quant import quantize_activations_int8 as j_act_quant
from repro.quant.ternary import TernaryWeight as JTernaryWeight
from repro.quant.ternary import pack_ternary as j_pack, quantize_and_pack as j_quantize_and_pack
from repro.quant.ternary import ternary_quantize as j_ternary_quantize
from repro.serving import EngineCore as JEngineCore, Request as JRequest

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.kernels.tlmm.ops import tlmm_matmul
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.models import transformer as T
from repro_torch.quant.act_quant import quantize_activations_int8
from repro_torch.quant.ternary import (
    pack_ternary,
    quantize_and_pack,
    ternary_quantize,
    unpack_ternary,
)
from repro_torch.serving import EngineCore, Request

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# float tolerances: f32 attention and logits summed in another order than the
# Pallas kernels' (blocked online softmax) — a few ulp of O(1) values
PREFILL_TOL = 2e-5
DECODE_TOL = 1e-5
MODEL_TOL = 1e-4

LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


# ------------------------------------------------------------ quantization --


def test_ternary_packing_bit_exact():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    jq, jbeta = j_ternary_quantize(jnp.asarray(w))
    tq, tbeta = ternary_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    # beta is an f32 mean over K*N values summed in another order: an ulp apart
    # at most (interop hands the port the JAX package's own beta, bit for bit)
    np.testing.assert_allclose(tbeta.item(), np.float32(jbeta), rtol=1e-6)
    jp = np.asarray(j_pack(jq))
    np.testing.assert_array_equal(jp, pack_ternary(tq).numpy())
    np.testing.assert_array_equal(unpack_ternary(torch.from_numpy(jp.copy())).numpy(), np.asarray(jq))
    # code 0b11 is unused and decodes to 0 in both packages
    assert unpack_ternary(torch.tensor([[0xFF]], dtype=torch.uint8)).abs().sum() == 0


def _act_rows(rows, k, decades, seed):
    """Random activations whose per-row absmax spreads over ``decades``
    decades, with an all-zero token (row 3) and half-way cases (row 5)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, k)) * 3).astype(np.float32)
    x *= (10.0 ** rng.uniform(-decades / 2, decades / 2, size=(rows, 1))).astype(np.float32)
    x[3, :] = 0.0  # an all-zero token
    x[5, 7] = 127.5 * (np.abs(x[5]).max() / 127.0 + 1e-5)  # a half-way case
    s = np.float32(np.float64(np.abs(x[5]).max()) * np.float64(np.float32(1 / 127))
                   + np.float64(np.float32(1e-5)))  # the row's scale, as jitted
    x[5, 8], x[5, 9] = np.float32(0.5) * s, np.float32(-2.5) * s  # exact halves
    return x


@pytest.mark.parametrize("rows,k,decades", [(37, 96, 0), (4096, 1536, 4)])
def test_act_quant_bit_exact(rows, k, decades):
    """The port's scale is what the JAX package's jitted programs compute
    (XLA's absmax * f32(1/127) + eps, fused): x_q and scale bit for bit
    against ``jax.jit``, in every row."""
    x = _act_rows(rows, k, decades, seed=1)
    jq, js = jax.jit(j_act_quant)(jnp.asarray(x))
    tq, ts = quantize_activations_int8(torch.from_numpy(x))
    assert (np.asarray(js) != ts.numpy()).sum() == 0
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert ts[3].item() == np.float32(1e-5) and (tq[3] == 0).all()
    if rows >= 4096:  # the op-by-op JAX call divides, then adds: other scales
        _, je = j_act_quant(jnp.asarray(x))
        assert (np.asarray(je) != np.asarray(js)).sum() > rows // 10


# ------------------------------------------------------------------- TLMM --


@pytest.mark.parametrize("m,k,n", [(5, 128, 256), (37, 256, 128), (3, 512, 128)])
def test_tlmm_bit_exact_vs_pallas(m, k, n):
    """M is no multiple of 8; the Pallas kernel gets its M padding, the port none."""
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = j_quantize_and_pack(jnp.asarray(w))
    jxq, jscale = jax.jit(j_act_quant)(jnp.asarray(x))
    scale = jscale * jw.scale
    mp = -(-m // 8) * 8
    y_j = tlmm_pallas(jnp.pad(jxq, ((0, mp - m), (0, 0))), jw.packed,
                      jnp.pad(scale, ((0, mp - m), (0, 0))),
                      bm=mp, bn=128, bk=min(k, 256), out_dtype=jnp.float32,
                      interpret=True)[:m]
    tw = quantize_and_pack(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    tw.scale = torch.tensor(np.float32(jw.scale))  # one absmean, held equal
    y_t = tlmm_matmul(torch.from_numpy(x), tw)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    y_r = tlmm_reference(torch.from_numpy(np.asarray(jxq)), tw.packed,
                         torch.from_numpy(np.asarray(scale)))
    np.testing.assert_array_equal(y_r.numpy(), np.asarray(y_j))


def test_tlmm_matmul_matches_jitted_jax():
    """``tlmm_matmul`` from f32 activations against the JAX package's jitted
    ``tlmm_matmul`` (act-quant, scale fold, TLMM), bit for bit in every row."""
    rng = np.random.default_rng(11)
    x = _act_rows(512, 1536, 4, seed=12)
    w = rng.normal(size=(1536, 256)).astype(np.float32)
    jw = j_quantize_and_pack(jnp.asarray(w))
    y_j = jax.jit(lambda a, b: j_tlmm_matmul(a, b, out_dtype=jnp.float32))(jnp.asarray(x), jw)
    tw = quantize_and_pack(torch.from_numpy(w))
    tw.scale = torch.tensor(np.float32(jw.scale))  # one absmean, held equal
    y_t = tlmm_matmul(torch.from_numpy(x), tw)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


# -------------------------------------------------------------- attention --


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 4, 100, 32), (2, 4, 2, 70, 32)])
def test_prefill_attention_vs_pallas(b, h, hkv, s, d):
    """S is no multiple of the block; the Pallas kernel runs the reverse
    schedule on inputs padded to whole blocks, the port masks the edge."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    blk = 32
    sp = -(-s // blk) * blk
    pad = ((0, 0), (0, 0), (0, sp - s), (0, 0))
    out_j = prefill_attention_pallas(*(jnp.pad(jnp.asarray(a), pad) for a in (q, k, v)),
                                     blk=blk, schedule="reverse", interpret=True)[:, :, :s]
    out_t = prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=PREFILL_TOL, rtol=0)


@pytest.mark.parametrize("g", [1, 2])
def test_decode_attention_stats_vs_pallas(g):
    """(out, l, m) over a bf16 cache with ragged lengths, one of them 0."""
    rng = np.random.default_rng(g)
    b, hkv, s, d = 4, 2, 96, 32
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    k = jnp.asarray(rng.normal(size=(b, hkv, s, d)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(b, hkv, s, d)), jnp.bfloat16)
    lengths = np.array([0, 1, 50, 96], np.int32)
    out_j, l_j, m_j = decode_attention_pallas(
        jnp.asarray(q).reshape(b, hkv, g, d), k, v, jnp.asarray(lengths), bk=32, interpret=True)
    k_t = torch.from_numpy(np.asarray(k.astype(jnp.float32))).to(torch.bfloat16)
    v_t = torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
    out_t, l_t, m_t = decode_attention(torch.from_numpy(q), k_t, v_t,
                                       torch.from_numpy(lengths), return_stats=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j).reshape(b, hkv * g, d),
                               atol=DECODE_TOL, rtol=0)
    np.testing.assert_allclose(l_t.numpy()[..., 0], np.asarray(l_j)[..., 0].reshape(b, hkv * g),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(m_t.numpy()[..., 0], np.asarray(m_j)[..., 0].reshape(b, hkv * g),
                               atol=DECODE_TOL, rtol=0)
    assert (out_t[0] == 0).all() and (l_t[0] == 0).all() and (m_t[0] == -1e30).all()


# ------------------------------------------------------------------ model --


def _numpy_params(cfg, seed=0):
    """Latent f32 weights in the JAX package's tree layout (layer-stacked)."""
    rng = np.random.default_rng(seed)
    L, d, h, hkv, hd, f = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff)

    def lin(k, n, std=None):
        return {"w": (rng.normal(size=(L, k, n)) * (std or k**-0.5)).astype(np.float32)}

    def norm():
        return {"scale": (1.0 + 0.1 * rng.normal(size=(L, d))).astype(np.float32)}

    return {
        "emb": (rng.normal(size=(cfg.padded_vocab(), d)) * 0.02).astype(np.float32),
        "layers": {
            "attn": {"wq": lin(d, h * hd), "wk": lin(d, hkv * hd), "wv": lin(d, hkv * hd),
                     "wo": lin(h * hd, d)},
            "ln1": norm(), "ln2": norm(),
            "mlp": {"w_gate": lin(d, f), "w_up": lin(d, f), "w_down": lin(f, d)},
        },
        "ln_f": {"scale": (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)},
    }


def _pack_jax(tree):
    """JAX params with every linear packed by ``jax.vmap(quantize_and_pack)``."""
    out = jax.tree.map(jnp.asarray, tree)
    for g, n in LINEARS:
        out["layers"][g][n]["w"] = jax.vmap(j_quantize_and_pack)(out["layers"][g][n]["w"])
    return out


def _to_numpy(tree):
    if isinstance(tree, JTernaryWeight):
        return {"packed": np.asarray(tree.packed), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def model():
    cfg_t = reduced_config("bitnet-730m")
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True)
    t_fields, j_fields = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
    assert t_fields == {k: j_fields[k] for k in t_fields}  # the port's copy of the config
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def test_interop_packs_latent_weights_like_jax():
    cfg = reduced_config("bitnet-730m")
    tree = _numpy_params(cfg, seed=3)
    from_latent = params_from_numpy(tree, cfg, device="cpu")
    jw = jax.vmap(j_quantize_and_pack)(jnp.asarray(tree["layers"]["mlp"]["w_up"]["w"]))
    tw = from_latent["layers"]["mlp"]["w_up"]["w"]
    np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale), rtol=1e-6)


def test_prefill_split_and_decode_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    rng = np.random.default_rng(7)
    b, s, smax = 2, 40, 64
    tokens = rng.integers(0, cfg_t.vocab_size, size=(b, s)).astype(np.int32)

    x_mid_j, kv_j = JT.forward_prefill(params_j, jnp.asarray(tokens), cfg_j, split_tail=True)
    logits_j = JT.prefill_tail(params_j, x_mid_j, cfg_j, last_pos=jnp.int32(s - 3))
    x_mid_t, kv_t = T.forward_prefill(params_t, torch.from_numpy(tokens).long(), cfg_t,
                                      split_tail=True)
    logits_t = T.prefill_tail(params_t, x_mid_t, cfg_t, last_pos=s - 3)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=MODEL_TOL, rtol=0)
    for a_t, a_j in zip(kv_t, kv_j):
        assert a_t.shape == a_j.shape  # (L, B, Hkv, S, D)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=MODEL_TOL, rtol=0)

    # install the prompt KV into a bf16 batch-leading cache in both packages
    cache_j = JT.init_cache(cfg_j, b, smax)
    pad = ((0, 0), (0, 0), (0, 0), (0, smax - s), (0, 0))
    cache_j = type(cache_j)(*(jnp.moveaxis(jnp.pad(a, pad), 0, 1).astype(jnp.bfloat16)
                              for a in kv_j))
    cache_t = T.init_cache(cfg_t, b, smax, device="cpu")
    for buf, a in zip(cache_t, kv_t):
        buf[:, :, :, :s] = a.permute(1, 0, 2, 3, 4).to(buf.dtype)
    lengths = np.array([s - 3, s], np.int32)
    tok = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
    for _ in range(2):
        lj, cache_j = JT.decode_step(params_j, jnp.asarray(tok), cache_j, jnp.asarray(lengths), cfg_j)
        lt, cache_t = T.decode_step(params_t, torch.from_numpy(tok).long(), cache_t,
                                    torch.from_numpy(lengths), cfg_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=MODEL_TOL, rtol=0)
        for a_t, a_j in zip(cache_t, cache_j):
            np.testing.assert_allclose(a_t.float().numpy(), np.asarray(a_j.astype(jnp.float32)),
                                       atol=1e-2, rtol=1e-2)  # one bf16 rounding apart at most
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        lengths = lengths + 1


# ----------------------------------------------------------------- engine --

PROMPTS = [5, 17, 9, 30]
MAX_NEW = 6


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in PROMPTS]


@pytest.mark.parametrize("mode,overlap", [("pdswap", True), ("pdswap", False), ("static", True)])
def test_engine_greedy_tokens_match_jax(model, mode, overlap):
    """Four ragged requests on two slots: the port's EngineCore (CPU) emits
    the JAX EngineCore's greedy tokens.  Every token the port picks first
    clears its runner-up by more than the model tolerance, so the equality
    is not decided by float noise."""
    cfg_j, params_j, cfg_t, params_t = model
    kw = dict(n_slots=2, max_len=64, prompt_len=16, mode=mode, overlap=overlap)

    jeng = JEngineCore(cfg_j, params_j, **kw)
    teng = EngineCore(cfg_t, params_t, device="cpu", **kw)
    margins = []

    def record(logits, rows):
        top2 = torch.topk(logits[rows].float(), 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())

    prefill, decode_logits = teng.runner.prefill, teng.runner.decode_logits

    def prefill_rec(req, slot, stats, resuming=False):
        logits = prefill(req, slot, stats, resuming)
        record(logits, [0])
        return logits

    def decode_rec(lengths):
        logits = decode_logits(lengths)
        record(logits, sorted(teng.scheduler.inflight))
        return logits

    teng.runner.prefill, teng.runner.decode_logits = prefill_rec, decode_rec
    for i, p in enumerate(_prompts()):
        jeng.submit(JRequest(f"r{i}", p, max_new=MAX_NEW))
        teng.submit(Request(f"r{i}", p, max_new=MAX_NEW))
    jeng.run()
    stats = teng.run()
    assert len(margins) == len(PROMPTS) * MAX_NEW
    assert min(margins) > MODEL_TOL
    for i in range(len(PROMPTS)):
        rid = f"r{i}"
        assert teng.finished[rid].finish_reason == "length"
        assert teng.finished[rid].out_tokens == jeng.finished[rid].out_tokens, rid
    assert stats.swaps == (len(PROMPTS) if mode == "pdswap" else 0)
    assert stats.decode_tokens == len(PROMPTS) * (MAX_NEW - 1)
