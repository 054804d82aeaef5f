"""The training pass of every model family in the port against the JAX
package on the CPU: ``get_model(cfg).loss_fn``'s loss, aux and every
gradient leaf against ``jax.jit(jax.value_and_grad(loss_fn))`` on the same
weights (``params_from_numpy(..., latent=True)``), the chunked attention's
gradients past ``DENSE_MAX``, the remat policies, and the train step
against the JAX step.

Weights are the JAX ``init`` (f32) with the norms, biases, gates and SSM
constants moved off 1 and 0; batches are numpy from a seed, with some
targets masked out.  TF32 is off (``repro_torch``): every product is f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.layers import attention as JAttn
from repro.layers.sharding import NULL_CTX
from repro.models import get_model as jget_model
from repro.train import trainer as JTr

from repro_torch.common.tree import named_leaves
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.layers import attention as A
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw as OA
from repro_torch.train import trainer as Tr
from test_torch_families import _perturbed
from test_torch_models import _port_config

# f32 forward and backward summed in other orders: measured at most 3.5e-6
# of a gradient leaf's max |g| (hymba's gates) and 2e-7 of the loss
F32_TOL = 2e-5
# quantization-aware configs: an int8 activation code flips where the two
# packages' inputs lie an ulp apart across a rounding boundary, and beta can
# be an ulp off (ROADMAP C): measured 1.2e-3 of max |g| (granite's ternary
# copy, its routing moved with it: aux within 6e-6) and 1e-6 (bitnet)
QAT_TOL = 5e-3
BATCH, SEQ = 2, 24

CASES = [("smollm-135m", None), ("bitnet-730m", None), ("qwen2.5-14b", None),
         ("granite-moe-3b-a800m", None), ("granite-moe-3b-a800m", "ternary"),
         ("hymba-1.5b", None), ("xlstm-1.3b", None), ("whisper-large-v3", None)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-30), f"{what}: max abs err {err} (max |x| {scale})"


def _configs(arch, quant=None, **overrides):
    cfg_j = jcfgs.reduced_config(arch, **overrides)
    if quant:
        cfg_j = dataclasses.replace(cfg_j, quant=jcfgs.base.QuantConfig(mode=quant))
    return cfg_j, _port_config(cfg_j)


def _weights(cfg_j, seed=0):
    init = jget_model(cfg_j).init(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return _perturbed(jax.tree.map(np.asarray, init), np.random.default_rng(seed))


def _batch(cfg, seed=1, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(cfg_t, params, batch):
    api = get_model(cfg_t)
    return Tr.loss_and_grads(lambda p, b: api.loss_fn(p, b, cfg_t), params, _torch(batch))


@pytest.mark.parametrize("arch,quant", CASES, ids=[a + (f"-{q}" if q else "") for a, q in CASES])
def test_loss_fn_and_every_gradient_equal_jitted_jax(arch, quant):
    cfg_j, cfg_t = _configs(arch, quant)
    tree, batch = _weights(cfg_j), _batch(cfg_j)
    jloss = jax.jit(jax.value_and_grad(lambda p, b: jget_model(cfg_j).loss_fn(p, b, cfg_j),
                                       has_aux=True))
    (jl, jm), jg = jloss(_jax(tree), _jax(batch))
    params = params_from_numpy(tree, cfg_t, "cpu", latent=True)
    loss, metrics, grads = _port_grads(cfg_t, params, batch)
    tol = QAT_TOL if cfg_t.quant.ternary else F32_TOL
    _close(loss, jl, "loss", tol)
    _close(metrics["nll"], jm["nll"], "nll", tol)
    _close(metrics["aux"], jm["aux"], "aux", tol)
    if cfg_t.moe:
        assert float(metrics["aux"]) > 0
    jflat = dict(named_leaves(jg))
    tflat = dict(named_leaves(grads))
    assert tflat.keys() == jflat.keys()
    for name, g in tflat.items():
        _close(g, jflat[name], f"grad {name}", tol)
    if cfg_t.quant.ternary:  # the straight-through estimator reaches every latent weight
        for name, g in tflat.items():
            if name.endswith("/w") or "w_gate" in name or "w_up" in name or "w_down" in name:
                assert float(g.abs().max()) > 0, name


def test_attention_past_dense_max_takes_the_chunked_path_with_jax_gradients():
    """One attention layer over S = DENSE_MAX + 76 tokens in training: the
    chunked path (two 512-query chunks and a third of 76, each recomputed in
    backward), its output and the gradients of every weight and of x
    against the JAX layer (GQA, 4 query heads on 2 KV heads)."""
    cfg_j, cfg_t = _configs("qwen2.5-14b")
    s = A.DENSE_MAX + 76
    tree = _weights(cfg_j)["layers"]["attn"]
    lp = jax.tree.map(lambda a: a[0], tree)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, s, cfg_j.d_model)).astype(np.float32)
    c = rng.normal(size=(1, s, cfg_j.d_model)).astype(np.float32)
    pos = np.arange(s)[None]

    def jf(p, x):
        y, _ = JAttn.attention_prefill(p, x, jnp.asarray(pos), cfg_j, NULL_CTX, training=True)
        return jnp.sum(y * c), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        _jax(lp), jnp.asarray(x))
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), lp)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = A.attention_prefill(pt, xt, torch.from_numpy(pos), cfg_t, training=True)
    (y * torch.from_numpy(c)).sum().backward()
    _close(y, jy, "y")
    _close(xt.grad, jgx, "dx")
    for name, g in named_leaves(jgp):
        _close(dict(named_leaves(pt))[name].grad, g, f"d{name}")


@pytest.mark.parametrize("arch", ["bitnet-730m", "granite-moe-3b-a800m", "xlstm-1.3b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    """Recomputing a layer (or an xlstm group) in backward changes no
    number: the loss and every gradient equal those of remat "none", bit
    for bit on the CPU."""
    cfg_j, cfg_t = _configs(arch)
    tree, batch = _weights(cfg_j), _batch(cfg_j)
    params = params_from_numpy(tree, cfg_t, "cpu", latent=True)
    runs = [_port_grads(dataclasses.replace(cfg_t, remat=r), params, batch)
            for r in (remat, "none")]
    assert runs[0][0].item() == runs[1][0].item()
    for (name, a), (_, b) in zip(named_leaves(runs[0][2]), named_leaves(runs[1][2])):
        assert torch.equal(a, b), name


# The train step.  The schedules give step 0 an lr of 0, so step 1 is the
# first that moves the weights.  Through step 1 every parameter and moment
# holds to F32_TOL (the moments carry the gradients' rounding: measured
# 2.7e-6 of max |x|).  Later steps are held loosely: Adam moves a coordinate
# whose gradient lies a rounding away from 0 by a whole lr of either sign,
# so a parameter may lie up to 2 lr a step from JAX's, and the losses and
# norms that follow move with it (TRAJ_TOL; measured 2e-7 over 3 steps).
TRAJ_TOL = 1e-4


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_equals_the_jax_step(microbatches):
    cfg_j, cfg_t = _configs("smollm-135m")
    jt = JTr.TrainConfig(schedule="wsd", warmup=2, total_steps=6, microbatches=microbatches)
    tt = Tr.TrainConfig(schedule="wsd", warmup=2, total_steps=6, microbatches=microbatches)
    tree = _weights(cfg_j)
    jparams = _jax(tree)
    jopt = jax.tree.map(jnp.asarray, JTr.adamw_init(jparams))
    jstep = jax.jit(JTr.make_train_step(cfg_j, jt))
    params, opt = train_state_from_numpy(tree, jax.tree.map(np.asarray, jopt)._asdict(),
                                         cfg_t, "cpu")
    step_fn = Tr.make_train_step(cfg_t, tt)
    lr_sum = 0.0
    for s in range(3):
        batch = _batch(cfg_j, seed=10 + s, b=4)
        jparams, jopt, jm = jstep(jparams, jopt, _jax(batch), jnp.int32(s))
        params, opt, m = step_fn(params, opt, _torch(batch), s)
        assert set(m) == set(jm), (set(m), set(jm))
        _close(m["lr"], jm["lr"], "lr", 1e-6)
        tol = F32_TOL if s <= 1 else TRAJ_TOL
        _close(m["loss"], jm["loss"], f"loss, step {s}", tol)
        _close(m["grad_norm"], jm["grad_norm"], f"grad norm, step {s}", tol)
        lr_sum += float(m["lr"])
        jflat = dict(named_leaves((jparams, jopt)))
        for name, leaf in named_leaves((params, opt)):
            want = jflat[name]
            if name.endswith("step"):
                assert int(leaf) == int(want) == s + 1
            elif s <= 1 or not name.startswith("0/"):
                _close(leaf, want, f"step {s} {name}", tol)
            else:
                assert np.abs(_np(leaf) - _np(want)).max() <= 2 * lr_sum, name
    if microbatches > 1:
        assert set(m) == {"loss", "lr", "nll", "grad_norm"}
    assert isinstance(opt, OA.AdamWState) and int(opt.step) == 3


@pytest.mark.parametrize("arch", jcfgs.ALL_ARCHS)
def test_every_arch_trains_through_the_registry(arch):
    """``get_model(cfg).loss_fn`` on every arch of the registry at its
    reduced config (the JAX test_smoke_forward_and_train_step): a finite
    loss within 1.0 of ln(vocab) at the JAX init, and a finite, nonzero
    gradient norm."""
    cfg_j, cfg_t = _configs(arch)
    params = params_from_numpy(_weights(cfg_j), cfg_t, "cpu", latent=True)
    batch = _batch(cfg_j, b=2, s=16)
    loss, metrics, grads = _port_grads(cfg_t, params, batch)
    gnorm = float(OA.global_norm(grads))
    assert np.isfinite(float(loss)) and abs(float(loss) - np.log(cfg_t.vocab_size)) < 1.0
    assert np.isfinite(gnorm) and gnorm > 0
    # forward_train's full logits give loss_fn's nll (the chunked loss, unchunked)
    tb = _torch(batch)
    inputs = tb if cfg_t.family == "encdec" else tb["tokens"]
    with torch.no_grad():
        logits, _ = get_model(cfg_t).module.forward_train(params, inputs, cfg_t)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, tb["targets"].long()[..., None])[..., 0]
    _close((nll * tb["mask"]).sum() / tb["mask"].sum(), metrics["nll"], "forward_train nll")
