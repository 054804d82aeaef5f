"""The other model families in the port, against the JAX package on the
CPU: hymba (windowed attention and SSM heads), the selective SSM, xlstm
(mLSTM and sLSTM) and the whisper encoder-decoder, each at its reduced
config, their weights, LayerNorm and the GELU MLP.

Every case feeds the same numpy inputs, made from a seed, through the live
JAX function (jitted, its Pallas kernels in interpret mode:
``use_pallas=True``) and through the port's plain version, on f32 params
carried by ``params_from_numpy`` unless stated, and holds each output within
``F32_TOL`` of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.layers import mlp as JMLP
from repro.layers import norm as JN
from repro.layers.sharding import NULL_CTX
from repro.models import encdec as JE
from repro.models import hymba as JH
from repro.models import ssm as JS
from repro.models import xlstm as JX

from repro_torch.interop import params_from_numpy
from repro_torch.layers import mlp as M
from repro_torch.layers import norm as N
from repro_torch.models import encdec as E
from repro_torch.models import hymba as H
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.registry import get_model
from test_torch_models import _port_config

F32_TOL = 1e-4  # of max |x|, for every f32 output and state leaf
# bf16 weights and activations: both packages round each product's f32 sum
# to bf16, and a sum taken in another order can land one bf16 ulp (2^-8 of
# the value) apart; through two layers and eight steps that moves a logit by
# a few ulps of the activations.  Measured on the CPU at most 0.0112 of max
# |x| for hymba (the logits; every cache leaf closer), about 2.7 times that;
# and 0.0201 for xlstm (a decode step's logits; its sLSTM states 0.0104),
# whose recurrences carry each step's rounding into the next, 2.5 times that
BF16_TOL = 0.03
XLSTM_BF16_TOL = 0.05
DECODE_STEPS = 8
PERTURBED = ("scale", "bias", "b", "gate_a", "gate_s", "d_skip", "dt_bias")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-6), f"{what}: max abs err {err} (max |x| {scale})"


def _perturbed(tree, rng, key=""):
    """A JAX init's numpy tree with its norms, biases, gates and SSM
    constants moved off 1 and 0, so that each of them shows in the output."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree)
    if key in PERTURBED and a.dtype == np.float32:
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return a


def _setup(arch, seed, dtype=jnp.float32):
    cfg_j = jcfgs.reduced_config(arch, use_pallas=True)
    cfg_t = _port_config(cfg_j)
    mod = {"hymba": JH, "xlstm": JX, "encdec": JE}[cfg_j.family]
    tree = _perturbed(jax.tree.map(np.asarray, mod.init(cfg_j, jax.random.PRNGKey(seed), dtype)),
                      np.random.default_rng(seed))
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, cfg_t, "cpu")


def _jax_install(buf, src):
    """The JAX side of the logic swap (``tests/test_models.py``): KV leaves
    layer-major -> batch-leading, prompt rows at the front; the recurrent
    states keep (L, B, ...)."""
    if src.ndim == 5:
        src = jnp.moveaxis(src, 0, 1)
    if buf.ndim == src.ndim and buf.shape[:-2] == src.shape[:-2]:
        return buf.at[..., : src.shape[-2], :].set(src.astype(buf.dtype))
    return src


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _decode_both(jstep, tstep, params_j, params_t, cache_j, cache_t, logits_j, lengths,
                 tol=F32_TOL, steps=DECODE_STEPS):
    """``steps`` greedy steps of both packages on the JAX stream's tokens,
    their logits held together each step.  Returns the final caches."""
    lg = logits_j
    for t in range(steps):
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        ln = (lengths + t).astype(np.int32)
        lg, cache_j = jstep(params_j, jnp.asarray(tok), cache_j, jnp.asarray(ln))
        lt, cache_t = tstep(params_t, torch.from_numpy(tok).long(), cache_t, torch.from_numpy(ln))
        _close(lt, lg, f"decode logits, step {t}", tol)
    return cache_j, cache_t


# ----------------------------------------------------------------- hymba --


@pytest.fixture(scope="module")
def hymba_jit():
    cfg_j = jcfgs.reduced_config("hymba-1.5b", use_pallas=True)
    return (jax.jit(lambda p, t: JH.forward_prefill(p, t, cfg_j)),
            jax.jit(lambda p, t, c, l: JH.decode_step(p, t, c, l, cfg_j)))


def _hymba_case(hymba_jit, b, s, dtype, tol, decode=True):
    cfg_j, cfg_t, params_j, params_t = _setup("hymba-1.5b", 3, dtype)
    prefill_j, step_j = hymba_jit
    tok = _tokens(cfg_t, b, s, 4)
    lj, cj = prefill_j(params_j, jnp.asarray(tok))
    lt, ct = H.forward_prefill(params_t, torch.from_numpy(tok).long(), cfg_t)
    _close(lt, lj, "prefill logits", tol)
    for name, got, want in (("k", ct.kv.k, cj.kv.k), ("v", ct.kv.v, cj.kv.v),
                            ("ssm_h", ct.ssm_h, cj.ssm_h), ("conv", ct.conv, cj.conv)):
        _close(got, want, f"prefill {name}", tol)
    if not decode:
        return
    max_len = s + DECODE_STEPS + 8
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cache_j = jax.tree.map(_jax_install, JH.init_cache(cfg_j, b, max_len, dtype=dtype), cj)
    cache_t = H.install_prefill(H.init_cache(cfg_t, b, max_len, dtype=tdt, device="cpu"), ct)
    _close(cache_t.kv.k, cache_j.kv.k, "installed k", tol)
    cache_j, cache_t = _decode_both(
        step_j, lambda p, t, c, l: H.decode_step(p, t, c, l, cfg_t), params_j, params_t,
        cache_j, cache_t, lj, np.full((b,), s), tol)
    for name, got, want in (("k", cache_t.kv.k, cache_j.kv.k), ("v", cache_t.kv.v, cache_j.kv.v),
                            ("ssm_h", cache_t.ssm_h, cache_j.ssm_h),
                            ("conv", cache_t.conv, cache_j.conv)):
        _close(got, want, f"decoded {name}", tol)


def test_hymba_prefill_and_decode_equal_jax_past_the_window(hymba_jit):
    """48 prompt tokens over a window of 32 (layer 1; layer 0 is global):
    the window masks prefill rows, and the 8 decode steps walk from a
    nonzero start.  Logits and every cache leaf, prefill and after decode."""
    cfg = jcfgs.reduced_config("hymba-1.5b")
    assert cfg.sliding_window == 32 < 48 and cfg.global_attn_layers == (0,)
    assert H.layer_windows(_port_config(cfg)) == [H.FULL_WINDOW, 32]
    _hymba_case(hymba_jit, 2, 48, jnp.float32, F32_TOL)


def test_hymba_chunked_prefill_equals_jax():
    """1,100 tokens: past the dense path's 1,024, so both packages take the
    chunked path (512-query chunks) with the window applied."""
    cfg_j = jcfgs.reduced_config("hymba-1.5b", use_pallas=True)
    _hymba_case((jax.jit(lambda p, t: JH.forward_prefill(p, t, cfg_j)), None), 1, 1100,
                jnp.float32, F32_TOL, decode=False)


def test_hymba_bf16_equals_jax_within_bf16_rounding(hymba_jit):
    """The JAX ``init``'s bf16 weights (norms, gates and SSM constants f32),
    a bf16 cache: prefill and 8 decode steps within ``BF16_TOL``."""
    _hymba_case(hymba_jit, 2, 48, jnp.bfloat16, BF16_TOL)


# ------------------------------------------------------------------- ssm --


def test_ssm_prefill_across_chunks_equals_jax_and_its_own_decode():
    """S = 300 (chunks of 128, the last padded) from a nonzero state and
    conv state: y, h and the conv state against the JAX ``ssm_prefill``; and
    the port's prefill equals its own ``ssm_decode`` step by step."""
    cfg_j = jcfgs.reduced_config("hymba-1.5b")
    cfg_t = _port_config(cfg_j)
    rng = np.random.default_rng(5)
    tree = _perturbed(jax.tree.map(np.asarray, JS.ssm_init(cfg_j, jax.random.PRNGKey(2),
                                                          jnp.float32)), rng)
    p_t = {k: torch.from_numpy(v) for k, v in tree.items()}
    d, n, w = cfg_t.d_model, cfg_t.ssm_state, cfg_t.ssm_conv
    x = rng.normal(size=(2, 300, d)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(2, d, n))).astype(np.float32)
    conv0 = rng.normal(size=(2, w - 1, d)).astype(np.float32)
    yj, (hj, cj) = jax.jit(lambda p, x, h, c: JS.ssm_prefill(p, x, cfg_j, h, c))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(h0), jnp.asarray(conv0))
    yt, (ht, ct) = S.ssm_prefill(p_t, torch.from_numpy(x), cfg_t, torch.from_numpy(h0),
                                 torch.from_numpy(conv0))
    _close(yt, yj, "y")
    _close(ht, hj, "h")
    _close(ct, cj, "conv state")
    h, conv, ys = torch.from_numpy(h0), torch.from_numpy(conv0), []
    for t in range(x.shape[1]):
        y, (h, conv) = S.ssm_decode(p_t, torch.from_numpy(x[:, t:t + 1]), cfg_t, h, conv)
        ys.append(y)
    _close(torch.cat(ys, dim=1), yt, "stepped y")
    _close(h, ht, "stepped h")
    _close(conv, ct, "stepped conv state")


# ----------------------------------------------------------------- xlstm --


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL), (jnp.bfloat16, XLSTM_BF16_TOL)])
def test_xlstm_prefill_and_decode_equal_jax(dtype, tol):
    """70 prompt tokens (not a multiple of the mLSTM's 64-step chunks, so
    the last chunk has padded steps), then 8 decode steps: logits and every
    mLSTM and sLSTM state leaf, on f32 weights and on the JAX ``init``'s
    bf16 ones (the q/k/v and gate streams bf16, the states f32)."""
    cfg_j, cfg_t, params_j, params_t = _setup("xlstm-1.3b", 6, dtype)
    assert (cfg_t.num_layers, cfg_t.slstm_every, cfg_t.num_heads, cfg_t.head_dim) == (2, 2, 4, 32)
    tok = _tokens(cfg_t, 2, 70, 7)
    lj, cj = jax.jit(lambda p, t: JX.forward_prefill(p, t, cfg_j))(params_j, jnp.asarray(tok))
    lt, ct = X.forward_prefill(params_t, torch.from_numpy(tok).long(), cfg_t)
    assert torch.isfinite(lt).all()
    _close(lt, lj, "prefill logits", tol)

    def leaves(c):
        return [("mlstm." + f, t) for f, t in zip(c.mlstm._fields, c.mlstm)] + [
            ("slstm." + f, t) for f, t in zip(c.slstm._fields, c.slstm)]

    for (name, got), (_, want) in zip(leaves(ct), leaves(cj)):
        _close(got, want, f"prefill {name}", tol)
    step_j = jax.jit(lambda p, t, c, l: JX.decode_step(p, t, c, l, cfg_j))
    cj, ct = _decode_both(step_j, lambda p, t, c, l: X.decode_step(p, t, c, l, cfg_t), params_j,
                          params_t, cj, ct, lj, np.full((2,), 70), tol)
    for (name, got), (_, want) in zip(leaves(ct), leaves(cj)):
        _close(got, want, f"decoded {name}", tol)


def test_mlstm_chunk_equals_its_steps_from_a_fresh_state():
    """``_mlstm_chunk`` over 64 steps from a fresh state (m = -1e30: the
    first chunk's stabilizer arithmetic gives no NaN) equals ``_mlstm_step``
    applied step by step, outputs and end state."""
    rng = np.random.default_rng(8)
    b, h, c, hd = 2, 4, 64, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, c, hd)).astype(np.float32))
               for _ in range(3))
    it = torch.from_numpy(rng.normal(size=(b, h, c)).astype(np.float32))
    ft = torch.nn.functional.logsigmoid(
        torch.from_numpy((2.0 + rng.normal(size=(b, h, c))).astype(np.float32)))
    fresh = X.MLSTMState(torch.zeros(b, h, hd, hd), torch.zeros(b, h, hd),
                         torch.full((b, h), X.STATE_INIT_M))
    h_chunk, st_chunk = X._mlstm_chunk(q, k, v, it, ft, fresh)
    assert torch.isfinite(h_chunk).all()
    st, hs = fresh, []
    for t in range(c):
        ht, st = X._mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t], it[:, :, t], ft[:, :, t], st)
        hs.append(ht)
    _close(h_chunk, torch.stack(hs, dim=2), "h")
    # the states agree up to their common stabilizer: c and n scale with exp(m)
    scale = torch.exp(st_chunk.m - st.m)
    _close(st_chunk.c, st.c * scale[..., None, None], "c")
    _close(st_chunk.n, st.n * scale[..., None], "n")


# --------------------------------------------------------------- whisper --


@pytest.fixture(scope="module")
def whisper():
    cfg_j, cfg_t, params_j, params_t = _setup("whisper-large-v3", 9)
    frames = np.random.default_rng(10).normal(size=(2, cfg_t.encoder_seq, cfg_t.d_model)).astype(
        np.float32)
    return cfg_j, cfg_t, params_j, params_t, frames


def test_whisper_encoder_and_cross_kv_equal_jax(whisper):
    """The non-causal encoder (LayerNorm, GELU MLP, sinusoidal positions)
    and every decoder layer's cross K/V."""
    cfg_j, cfg_t, params_j, params_t, frames = whisper
    enc_j = jax.jit(lambda p, f: JE.encode(p, f, cfg_j))(params_j, jnp.asarray(frames))
    enc_t = E.encode(params_t, torch.from_numpy(frames), cfg_t)
    _close(enc_t, enc_j, "encoder output")
    kv_j = JE.compute_cross_kv(params_j, enc_j, cfg_j)
    kv_t = E.compute_cross_kv(params_t, torch.from_numpy(_np(enc_j)), cfg_t)
    _close(kv_t.k, kv_j.k, "cross k")
    _close(kv_t.v, kv_j.v, "cross v")
    # at full size the angles reach 1,499 rad, whose f32 ulp is 2^-13: an
    # ulp apart in exp's timescale moves sin and cos by about that much
    _close(E._sinusoids(1500, 1280), JE._sinusoids(1500, 1280), "sinusoids", 2 * 2.0**-13)


def test_whisper_prefill_and_decode_equal_jax(whisper):
    """The decoder's prefill with frames (self K/V and the cross K/V padded
    from 16 to 128 rows), then 8 decode steps whose cross walks read the
    first 16 rows: logits and the caches."""
    cfg_j, cfg_t, params_j, params_t, frames = whisper
    assert (cfg_t.encoder_seq, E.padded_enc_seq(cfg_t)) == (16, 128)
    tok = _tokens(cfg_t, 2, 8, 11)
    lj, cj = jax.jit(lambda p, t, f: JE.forward_prefill(p, t, cfg_j, frames=f))(
        params_j, jnp.asarray(tok), jnp.asarray(frames))
    lt, ct = E.forward_prefill(params_t, torch.from_numpy(tok).long(), cfg_t,
                               frames=torch.from_numpy(frames))
    _close(lt, lj, "prefill logits")
    for name, got, want in (("self k", ct.self_kv.k, cj.self_kv.k),
                            ("self v", ct.self_kv.v, cj.self_kv.v),
                            ("cross k", ct.cross_kv.k, cj.cross_kv.k),
                            ("cross v", ct.cross_kv.v, cj.cross_kv.v)):
        _close(got, want, f"prefill {name}")
    cache_j = jax.tree.map(_jax_install, JE.init_cache(cfg_j, 2, 32, dtype=jnp.float32), cj)
    cache_t = E.install_prefill(E.init_cache(cfg_t, 2, 32, dtype=torch.float32, device="cpu"), ct)
    step_j = jax.jit(lambda p, t, c, l: JE.decode_step(p, t, c, l, cfg_j))
    cache_j, cache_t = _decode_both(step_j, lambda p, t, c, l: E.decode_step(p, t, c, l, cfg_t),
                                    params_j, params_t, cache_j, cache_t, lj, np.full((2,), 8))
    _close(cache_t.self_kv.k, cache_j.self_kv.k, "decoded self k")
    _close(cache_t.cross_kv.v, cache_j.cross_kv.v, "cross v after decode")


def test_layernorm_and_gelu_mlp_equal_jax():
    """LayerNorm with the population variance and f32 statistics (f32 and
    bf16 inputs), and the GELU MLP (tanh approximation, biases)."""
    cfg_j = jcfgs.reduced_config("whisper-large-v3")
    cfg_t = _port_config(cfg_j)
    rng = np.random.default_rng(12)
    d = cfg_t.d_model
    p = {"scale": (1 + 0.1 * rng.normal(size=d)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=d)).astype(np.float32)}
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, d))).astype(np.float32)  # offset: the mean matters
    for dt, tol in ((np.float32, 1e-6), (ml_dtypes.bfloat16, 2.0**-7)):
        xd = x.astype(dt)
        want = JN.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xd),
                             "layernorm", cfg_j.norm_eps)
        xt = torch.from_numpy(xd.astype(np.float32)).to(
            torch.float32 if dt == np.float32 else torch.bfloat16)
        got = N.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, xt, "layernorm",
                           cfg_t.norm_eps)
        assert got.dtype == xt.dtype
        _close(got, want, f"layernorm {np.dtype(dt).name}", tol)
    mp = _perturbed(jax.tree.map(np.asarray, JMLP.mlp_init(cfg_j, jax.random.PRNGKey(4),
                                                          jnp.float32)), rng)
    want = JMLP.mlp_apply(jax.tree.map(jnp.asarray, mp), jnp.asarray(x), cfg_j, NULL_CTX)
    got = M.mlp_apply(params_from_numpy(mp, cfg_t, "cpu"), torch.from_numpy(x), cfg_t)
    _close(got, want, "GELU MLP", 1e-5)


# --------------------------------------------------------------- weights --


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b", "whisper-large-v3"])
def test_init_like_jax_and_interop_equal_the_jax_init(arch):
    """``init_like_jax`` draws each family's JAX ``init`` (its key-split
    tree, its constants) to float rounding, leaves, shapes and dtypes
    exact, with the tolerances of the transformer family's check;
    ``params_from_numpy`` carries the JAX tree byte for byte (the 0-d
    gates stacked to (L,)); under bf16 the same leaves are cast as the JAX
    ``init`` casts them, within one bf16 rounding, and the family's own
    ``init`` (its default dtype bf16) is that draw."""
    cfg_j = jcfgs.reduced_config(arch)
    cfg_t = _port_config(cfg_j)
    mod = {"hymba": JH, "xlstm": JX, "encdec": JE}[cfg_j.family]
    want = jax.tree.map(np.asarray, mod.init(cfg_j, jax.random.PRNGKey(7), dtype=jnp.float32))
    got = init_like_jax(cfg_t, 7, "cpu")
    carried = params_from_numpy(want, cfg_t, device="cpu")
    want16 = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                          mod.init(cfg_j, jax.random.PRNGKey(7), dtype=jnp.bfloat16))
    dt16 = jax.tree.map(lambda a: a.dtype, mod.init(cfg_j, jax.random.PRNGKey(7),
                                                    dtype=jnp.bfloat16))
    got16 = init_like_jax(cfg_t, 7, "cpu", dtype=torch.bfloat16)
    api16 = get_model(cfg_t).init(cfg_t, 7, device="cpu")

    def check(a, b, c, a16, d16, b16, e16, path):
        if isinstance(a, dict):
            assert set(a) == set(b) == set(c) == set(b16) == set(e16), path
            for k in a:
                check(a[k], b[k], c[k], a16[k], d16[k], b16[k], e16[k], path + "/" + k)
            return
        assert b.dtype == c.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-9, err_msg=path)
        np.testing.assert_array_equal(c.numpy(), a, err_msg=path)
        assert (b16.dtype == torch.bfloat16) == (d16 == jnp.bfloat16), path
        np.testing.assert_allclose(b16.float().numpy(), a16, rtol=2.0**-8, atol=1e-9,
                                   err_msg=path)
        assert e16.dtype == b16.dtype and torch.equal(e16, b16), path

    check(want, got, carried, want16, dt16, got16, api16, "")
    if cfg_j.family == "hymba":
        assert got["layers"]["gate_a"].shape == (cfg_t.num_layers,)
        assert carried["layers"]["gate_s"].shape == (cfg_t.num_layers,)


# -------------------------------------------------------------- refusals --


def test_engine_and_cli_refuse_other_families_as_jax():
    """The serving engine drives the transformer family, as the JAX engine
    does: a hymba config is refused with the JAX message, by ``EngineCore``
    and by the CLI (whose ``--arch`` takes all eleven archs)."""
    from repro_torch.configs import ALL_ARCHS, reduced_config
    from repro_torch.launch import serve
    from repro_torch.serving import EngineCore

    cfg = reduced_config("hymba-1.5b")
    params = H.init(cfg, 0, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="serving engine drives the transformer family"):
        EngineCore(cfg, params, n_slots=1, max_len=64, device="cpu")
    assert sorted(ALL_ARCHS) == sorted(jcfgs.ALL_ARCHS)
    args = serve.parse_args(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="serving engine drives the transformer family"):
        serve.build(args)


def test_long_context_example_runs_on_the_cpu():
    """The port of ``examples/long_context_decode.py`` with ``--device
    cpu --kv-dtype int8``: a line a context for each arch; xlstm's state
    stays the same size while hymba's KV grows with the context."""
    import contextlib
    import io

    from repro_torch.examples import long_context_decode as LC

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert LC.main(["--device", "cpu", "--kv-dtype", "int8"]) == 0
    text = out.getvalue()
    sections = {s.split(":")[0].split()[0]: [ln for ln in s.splitlines() if "ctx" in ln]
                for s in text.split("\n\n") if "per-decode-step" in s}
    assert set(sections) == {"xlstm-1.3b", "hymba-1.5b", "smollm-135m"}
    mib = {a: [float(ln.split()[-2]) for ln in sections[a]] for a in ("xlstm-1.3b", "hymba-1.5b")}
    assert len(mib["xlstm-1.3b"]) == 3 and len(set(mib["xlstm-1.3b"])) == 1
    assert mib["hymba-1.5b"] == sorted(mib["hymba-1.5b"]) and mib["hymba-1.5b"][0] < mib["hymba-1.5b"][-1]
    assert "kv_dtype=int8" in text
