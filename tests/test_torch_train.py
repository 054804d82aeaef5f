"""Training in the port against the JAX package on the CPU: the
straight-through quantizers, the chunked loss, AdamW and the schedules, the
data pipeline, checkpoints (their format both ways), the train CLI and its
fault loop, the example, and the kernels' refusal of autograd.

Every JAX function runs jitted (``jax.jit``), as the JAX training step runs
it: XLA turns the act-quant scale's division into one multiply-add, which
the port computes (ROADMAP C, "KV scale").  Inputs are numpy arrays made
from a seed.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data import pipeline as JD
from repro.layers import linear as JL
from repro.launch import train as jtrain_cli
from repro.optim import adamw as JA
from repro.optim import schedules as JSched
from repro.quant import ternary as JTern
from repro.train import losses as JLoss
from repro.train import trainer as JTr

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import named_leaves
from repro_torch.configs import QuantConfig, reduced_config
from repro_torch.data import pipeline as D
from repro_torch.examples import train_smollm
from repro_torch.interop import train_state_from_numpy
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_kernel,
    decode_attention_quant_kernel,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention_kernel,
    paged_decode_attention_quant_kernel,
)
from repro_torch.kernels.prefill_attention.ops import prefill_attention_kernel
from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel
from repro_torch.launch import train as train_cli
from repro_torch.layers import attention as A
from repro_torch.layers import linear as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as OA
from repro_torch.optim import schedules as OS
from repro_torch.quant import ternary as Tern
from repro_torch.train import losses as Loss
from repro_torch.train import trainer as Tr

F32_TOL = 1e-5  # of max |x|: one f32 product or reduction summed in another order
# The QAT linear: the act-quant scale and codes are bit-equal to jax.jit's on
# equal inputs, but beta (an f32 mean over K x N) is summed in another order
# and can land one ulp apart (ROADMAP C, "beta"), which moves every output
# of the product by that ulp: 1e-6 of max |y| covers it; measured 1.2e-7.
QAT_TOL = 1e-6
# One AdamW step: elementwise f32 with the same operation order, but XLA
# contracts a multiply and an add into one fused multiply-add where torch
# rounds twice, and its pow/sqrt may round another way: one or two ulps of
# each value (measured 2.4e-7 of max |x|).
ADAM_TOL = 1e-6
# The CLI prints losses to 4 decimals; the port's losses must round to the
# printed ones or lie within a unit of the last place of them.
PRINT_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-30), f"{what}: max abs err {err} (max |x| {scale})"


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))  # a copy: the port updates in place
    return t.requires_grad_() if grad else t


# ----------------------------------------------------------- quantizers --


def test_ternary_quantize_ste_forward_and_straight_through_grad_equal_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(128, 96)) * 0.05).astype(np.float32)
    c = rng.normal(size=(128, 96)).astype(np.float32)

    def jloss(w):
        w_ste, beta = JTern.ternary_quantize_ste(w)
        return jnp.sum(w_ste * c), (w_ste, beta)

    (jl, (jw, jbeta)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(w))
    wt = _t(w, grad=True)
    w_ste, beta = Tern.ternary_quantize_ste(wt)
    (w_ste * _t(c)).sum().backward()
    _close(beta, jbeta, "beta", 1e-6)  # one f32 mean, another summation order
    _close(w_ste, jw, "w_ste", 1e-6)  # w + (w_q * beta - w): beta's ulp at most
    # the JAX value, not w_q * beta: in float w + (deq - w) rounds off deq
    codes = torch.round(w_ste.detach() / beta)
    assert torch.equal(codes, torch.round(_t(jw) / beta))
    np.testing.assert_array_equal(wt.grad.numpy(), c)  # identity to the latent weights
    np.testing.assert_array_equal(np.asarray(jg), c)


def test_act_fake_quant_ste_is_bit_equal_to_jitted_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 40, 128)) * rng.uniform(0.01, 30, size=(6, 40, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row
    got = L._act_fake_quant_ste(_t(x))
    want = jax.jit(JL._act_fake_quant_ste)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xt = _t(x, grad=True)
    L._act_fake_quant_ste(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


@pytest.mark.parametrize("bias", [False, True])
def test_qat_linear_apply_values_and_grads_equal_jax(bias):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 128)).astype(np.float32)
    params = {"w": (rng.normal(size=(128, 192)) / np.sqrt(128)).astype(np.float32)}
    if bias:
        params["b"] = rng.normal(size=(192,)).astype(np.float32)
    c = rng.normal(size=(2, 24, 192)).astype(np.float32)
    quant_j = jcfgs.base.QuantConfig(mode="ternary")

    def jloss(p, x):
        y = JL.linear_apply(p, x, quant_j, training=True)
        return jnp.sum(y * c), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    pt = {k: _t(v, grad=True) for k, v in params.items()}
    xt = _t(x, grad=True)
    y = L.linear_apply(pt, xt, QuantConfig(mode="ternary"), training=True)
    (y * _t(c)).sum().backward()
    _close(y, jy, "y", QAT_TOL)
    _close(xt.grad, jg[1], "dx", QAT_TOL)
    for k in params:
        _close(pt[k].grad, jg[0][k], f"d{k}", QAT_TOL)
    packed = {"w": Tern.quantize_and_pack(_t(params["w"]))}
    with pytest.raises(ValueError, match="no latent weights"):
        L.linear_apply(packed, _t(x), QuantConfig(mode="ternary"), training=True)


# ------------------------------------------------------------------ loss --


def test_chunked_ce_loss_and_grads_equal_jax():
    """S = 300 (two chunks of 256, the second padded), a padded vocab (300
    of 512 columns: the logsumexp runs over all 512, as in JAX), a mask with
    zeros; the gradients of the hidden states and of the head."""
    rng = np.random.default_rng(3)
    b, s, d, vp = 2, 300, 64, 512
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, vp)) * 0.1).astype(np.float32)
    targets = rng.integers(0, 300, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda x, h: JLoss.chunked_ce_loss(x, h, jnp.asarray(targets), jnp.asarray(mask)),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(head))
    xt, ht = _t(x, grad=True), _t(head, grad=True)
    loss = Loss.chunked_ce_loss(xt, ht, _t(targets), _t(mask))
    loss.backward()
    _close(loss, jl, "loss")
    _close(xt.grad, jg[0], "dx")
    _close(ht.grad, jg[1], "dhead")
    with torch.no_grad():  # no grad: the same value without the recompute
        assert Loss.chunked_ce_loss(xt, ht, _t(targets), _t(mask)).item() == loss.item()


# ----------------------------------------------------- optimizer, schedules --


def _opt_tree(rng, layers=3, d=16, n=24):
    """A layer-stacked tree: stacked matrices, stacked norm scales (L, d)
    and biases (L, n), an unstacked final norm (d,) and an embedding."""
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"emb": f(40, d), "ln_f": {"scale": 1 + 0.1 * f(d)},
            "layers": {"ln1": {"scale": 1 + 0.1 * f(layers, d)},
                       "attn": {"wq": {"w": f(layers, d, n), "b": f(layers, n)}}}}


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clip-on", "clip-off"])
def test_adamw_update_equals_jax(clip):
    rng = np.random.default_rng(4)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    cfg_j, cfg_t = JA.AdamWConfig(grad_clip=clip), OA.AdamWConfig(grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = JA.adamw_init(jp)
    tp = jax.tree.map(_t, params)
    topt = OA.adamw_init(tp)
    upd = jax.jit(lambda g, o, p, lr: JA.adamw_update(g, o, p, lr, cfg_j))
    for i in range(3):  # three steps, the moments carried
        g = jax.tree.map(lambda a: a * (i + 1), grads)
        jp, jopt, jm = upd(jax.tree.map(jnp.asarray, g), jopt, jp, jnp.float32(1e-2))
        tp, topt, tm = OA.adamw_update(jax.tree.map(_t, g), topt, tp, 1e-2, cfg_t)
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm", ADAM_TOL)
    assert int(topt.step) == int(jopt.step) == 3
    jflat = dict(named_leaves((jp, jopt.mu, jopt.nu)))
    for name, leaf in named_leaves((tp, topt.mu, topt.nu)):
        _close(leaf, jflat[name], name, ADAM_TOL)
    if clip == 1.0:  # the norm is well above 1: the step was clipped
        assert float(tm["grad_norm"]) > 10
    # the decay set: the stacked norm scales and biases are decayed, ln_f is not
    p0 = _opt_tree(np.random.default_rng(4))
    tp = jax.tree.map(_t, p0)
    OA.adamw_update(jax.tree.map(lambda a: _t(np.zeros_like(a)), p0), OA.adamw_init(tp), tp,
                    1.0, cfg_t)
    assert torch.equal(tp["ln_f"]["scale"], _t(p0["ln_f"]["scale"]))
    for path in (("layers", "ln1", "scale"), ("layers", "attn", "wq", "b"), ("emb",)):
        got, orig = tp, p0
        for k in path:
            got, orig = got[k], orig[k]
        torch.testing.assert_close(got, _t(orig) * (1 - cfg_t.weight_decay), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_equal_jax(name):
    for total, warmup in ((20, 5), (1000, 100), (10, 5)):
        kw = dict(peak_lr=3e-4, warmup=warmup, total=total)
        steps = np.arange(total + 3, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(lambda s: JSched.SCHEDULES[name](s, **kw)))(steps))
        got = np.array([float(OS.SCHEDULES[name](int(s), **kw)) for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ data --


@pytest.mark.parametrize("source", ["synthetic", "textfile"])
def test_batches_are_byte_equal_to_jax(source, tmp_path):
    path = None
    if source == "textfile":
        path = tmp_path / "corpus.txt"
        path.write_bytes(bytes(np.random.default_rng(5).integers(0, 256, 5000, dtype=np.uint8)))
    kw = dict(batch=4, seq_len=33, vocab_size=300, seed=7, source=source,
              path=None if path is None else str(path))
    jit_, it = JD.data_iterator(JD.DataConfig(**kw), 3), D.data_iterator(D.DataConfig(**kw), 3)
    for _ in range(3):
        want, got = next(jit_), next(it)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


# ----------------------------------------------------------- checkpoints --


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32))},
            "emb": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
            "step_scalar": torch.tensor(3.5),
            "half": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)).bfloat16()}


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v) for k, v in tree.items()}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(7, tree)
    restored, step = mgr.restore(_zeros(tree))
    assert step == 7
    for (n, a), (_, b) in zip(named_leaves(tree), named_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), n
    assert sorted(np.load(tmp_path / "step_00000007" / "arrays.npz").files) == [
        "emb", "half", "layers/w", "step_scalar"]


def test_checkpoint_async_save_copies_before_returning_and_gcs(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        tree = _tree(s)
        mgr.save_async(s, tree)
        tree["emb"].add_(100.0)  # the next step's in-place update must not reach the write
    mgr.wait()
    assert mgr.all_steps() == [3, 4]  # gc keeps the last 2
    restored, step = mgr.restore(_zeros(_tree()))
    assert step == 4 and torch.equal(restored["emb"], _tree(4)["emb"])


def test_checkpoint_crash_safety_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree())
    (tmp_path / ".tmp_step_00000009").mkdir()  # a crashed write
    broken = tmp_path / "step_00000777"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5  # incomplete checkpoints are invisible
    _, step = mgr.restore(_zeros(_tree()))
    assert step == 5


TRAIN_BATCH, TRAIN_SEQ = 2, 32


@pytest.fixture(scope="module")
def jax_training():
    """The JAX launcher's state and jitted step on reduced smollm (WSD over
    8 steps), and its batches."""
    cfg = jcfgs.reduced_config("smollm-135m")
    tcfg = JTr.TrainConfig(schedule="wsd", warmup=5, total_steps=8)
    params, opt = JTr.init_train_state(cfg, jax.random.PRNGKey(0))
    step_fn = JTr.jit_train_step(cfg, tcfg, None, jax.eval_shape(lambda: params), donate=False)
    source = JD.make_source(JD.DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                          vocab_size=cfg.vocab_size, seed=0))
    return params, opt, step_fn, source


def _port_training():
    cfg = reduced_config("smollm-135m")
    tcfg = Tr.TrainConfig(schedule="wsd", warmup=5, total_steps=8)
    params, opt = Tr.init_train_state(cfg, 0, "cpu")
    return cfg, params, opt, Tr.make_train_step(cfg, tcfg)


def _batch_t(source, step):
    return {k: torch.from_numpy(v) for k, v in source.batch(step).items()}


def test_jax_checkpoint_restores_into_the_port_and_continues_with_jax_loss(jax_training, tmp_path):
    params, opt, step_fn, source = jax_training
    for s in range(2):
        params, opt, _ = step_fn(params, opt, {k: jnp.asarray(v) for k, v in source.batch(s).items()},
                                 jnp.int32(s))
    JCheckpointManager(tmp_path).save(2, (params, opt))
    _, jopt_next, jm = step_fn(params, opt, {k: jnp.asarray(v) for k, v in source.batch(2).items()},
                               jnp.int32(2))
    cfg, tparams, topt, tstep = _port_training()
    (tparams, topt), step = CheckpointManager(tmp_path).restore((tparams, topt))
    assert step == 2 and int(topt.step) == 2
    # the restored state is the JAX state byte for byte (as interop carries it)
    carried = train_state_from_numpy(jax.tree.map(np.asarray, params),
                                     jax.tree.map(np.asarray, opt)._asdict(), cfg, "cpu")
    for (n, a), (_, b) in zip(named_leaves((tparams, topt)), named_leaves(carried)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), n
    _, _, tm = tstep(tparams, topt, _batch_t(source, 2), 2)
    _close(tm["loss"], jm["loss"], "step-2 loss")
    _close(tm["grad_norm"], jm["grad_norm"], "step-2 grad norm", 1e-4)


def test_port_checkpoint_restores_into_jax_and_continues_with_port_loss(jax_training, tmp_path):
    jparams, jopt, step_fn, source = jax_training
    cfg, params, opt, tstep = _port_training()
    for s in range(2):
        params, opt, _ = tstep(params, opt, _batch_t(source, s), s)
    CheckpointManager(tmp_path).save(2, (params, opt))
    _, _, tm = tstep(params, opt, _batch_t(source, 2), 2)
    (jparams, jopt), step = JCheckpointManager(tmp_path).restore((jparams, jopt))
    assert step == 2 and int(jopt.step) == 2
    _, _, jm = step_fn(jparams, jopt, {k: jnp.asarray(v) for k, v in source.batch(2).items()},
                       jnp.int32(2))
    _close(jm["loss"], tm["loss"], "step-2 loss")


# ------------------------------------------------------------------- CLI --

CLI = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "32", "--ckpt-every", "3",
       "--log-every", "1"]


def _printed_losses(text):
    return {int(s): float(l) for s, l in re.findall(r"step\s+(\d+)\s+loss\s+([-\d.]+)", text)}


def test_train_cli_matches_the_jax_cli_and_resumes(tmp_path, capsys):
    """6 steps, then --restore to 8 (the JAX test_train_cli_fault_recovery),
    in both packages from the same seed: every step's loss equals the JAX
    CLI's to its printed 4 decimals, and each resumes at step 6."""
    runs = []
    for pkg, main in (("jax", jtrain_cli.main), ("port", train_cli.main)):
        ck = str(tmp_path / pkg)
        extra = [] if pkg == "jax" else ["--device", "cpu"]
        assert main(CLI + extra + ["--steps", "6", "--ckpt-dir", ck]) == 0
        assert main(CLI + extra + ["--steps", "8", "--ckpt-dir", ck, "--restore"]) == 0
        text = capsys.readouterr().out
        assert "[restore] resumed from step 6 (mesh=none)" in text, text
        assert JCheckpointManager(ck).latest_step() == 8
        runs.append(_printed_losses(text))
    want, got = runs
    assert sorted(got) == sorted(want) == list(range(8))
    for s in want:
        assert abs(got[s] - want[s]) <= PRINT_TOL, (s, got[s], want[s])
    # the port's history carries the unrounded losses
    res = train_cli.train(train_cli.parse_args(CLI + ["--device", "cpu", "--steps", "3"]))
    for s in range(3):
        assert abs(res.history[s]["loss"] - want[s]) <= PRINT_TOL
        assert set(res.history[s]) == {"loss", "lr", "nll", "aux", "grad_norm"}
    # on a mesh of one process (a (data 1, model 1) world of one, which the
    # CLI joins itself) the same losses; the production mesh needs 256 ranks
    mesh = ["--device", "cpu", "--steps", "3", "--mesh", "host", "--backend", "gloo"]
    assert train_cli.main(CLI + mesh) == 0
    assert _printed_losses(capsys.readouterr().out) == {s: round(res.history[s]["loss"], 4)
                                                        for s in range(3)}
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train_cli.main(CLI + ["--device", "cpu", "--steps", "1", "--mesh", "single",
                              "--backend", "gloo"])


def test_train_cli_fault_loop_restores_and_replays(tmp_path, monkeypatch, capsys):
    """A step that raises restores the last checkpoint (step 3) and replays:
    the losses equal an uninterrupted run's, bit for bit on the CPU."""
    argv = CLI + ["--device", "cpu", "--steps", "6"]
    clean = train_cli.train(train_cli.parse_args(argv))
    make_source, failed = train_cli.make_source, []

    def flaky(cfg):
        src = make_source(cfg)
        batch = src.batch

        def once(step):
            if step == 4 and not failed:
                failed.append(step)
                raise RuntimeError("injected transient fault")
            return batch(step)

        src.batch = once
        return src

    monkeypatch.setattr(train_cli, "make_source", flaky)
    res = train_cli.train(train_cli.parse_args(argv + ["--ckpt-dir", str(tmp_path)]))
    text = capsys.readouterr().out
    assert "[fault] step 4 failed (RuntimeError('injected transient fault')); retry 1/2" in text
    assert "[fault] restored step 3, replaying" in text
    assert res.step == 6 and failed == [4]
    assert [h["loss"] for h in res.history.values()] == [h["loss"] for h in clean.history.values()]


def test_train_smollm_example_trains_then_resumes(capsys):
    assert train_smollm.main(["--device", "cpu", "--steps", "4"]) == 0
    text = capsys.readouterr().out
    assert "[restore] resumed from step 4 (mesh=none)" in text
    losses = _printed_losses(text)
    assert losses[0] > losses[20]  # the loss goes down


# ------------------------------------------------- kernels stay off the path --


def test_kernel_launchers_refuse_grad_requiring_inputs():
    """Every kernel launcher raises on an input that requires grad while
    grad is enabled (its output would cut the graph), before it looks at
    the device; under no_grad it goes on to its own checks."""
    g = lambda *shape: torch.zeros(shape, requires_grad=True)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    calls = {
        "act_quant_kernel": lambda: act_quant_kernel(g(4, 64), torch.ones(1)),
        "tlmm_kernel": lambda: tlmm_kernel(torch.zeros(4, 64, dtype=torch.int8),
                                           torch.zeros(16, 32, dtype=torch.uint8), g(4, 1)),
        "prefill_attention_kernel": lambda: prefill_attention_kernel(g(1, 2, 8, 32), g(1, 2, 8, 32),
                                                                     g(1, 2, 8, 32)),
        "decode_attention_kernel": lambda: decode_attention_kernel(g(2, 2, 1, 32), g(2, 2, 8, 32),
                                                                   g(2, 2, 8, 32), i32(2)),
        "decode_attention_quant_kernel": lambda: decode_attention_quant_kernel(
            g(2, 2, 1, 32), torch.zeros(2, 2, 8, 32, dtype=torch.int8), g(2, 2, 8),
            torch.zeros(2, 2, 8, 32, dtype=torch.int8), g(2, 2, 8), i32(2), kv_dtype="int8"),
        "paged_decode_attention_kernel": lambda: paged_decode_attention_kernel(
            g(2, 2, 1, 32), g(4, 2, 16, 32), g(4, 2, 16, 32), i32(2, 2), i32(2)),
        "paged_decode_attention_quant_kernel": lambda: paged_decode_attention_quant_kernel(
            g(2, 2, 1, 32), torch.zeros(4, 2, 16, 32, dtype=torch.int8), g(4, 2, 16),
            torch.zeros(4, 2, 16, 32, dtype=torch.int8), g(4, 2, 16), i32(2, 2), i32(2),
            kv_dtype="int8"),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: a hand-written kernel has no backward"):
            call()
        with torch.no_grad(), pytest.raises((ValueError, TypeError)):
            call()  # past the refusal: a CPU tensor is not the kernel's


def test_training_attention_never_reaches_the_prefill_kernel(monkeypatch):
    """attention_prefill(training=True) takes the dense path up to
    DENSE_MAX and the chunked path past it, never ``prefill_attention``;
    serving (training=False) still reaches it."""
    cfg = reduced_config("smollm-135m")
    params = T.init(cfg, 0, device="cpu", dtype=torch.float32)
    lp = T.layer_params(params["layers"], 0)["attn"]
    called = []
    real = A.prefill_attention
    monkeypatch.setattr(A, "prefill_attention", lambda *a, **k: called.append(1) or real(*a, **k))
    for s in (16, A.DENSE_MAX + 8):
        x = torch.randn(1, s, cfg.d_model, requires_grad=True)
        pos = torch.arange(s)[None]
        y, _ = A.attention_prefill(lp, x, pos, cfg, training=True)
        y.sum().backward()
        assert not called and x.grad is not None
    A.attention_prefill(lp, torch.randn(1, 16, cfg.d_model), torch.arange(16)[None], cfg)
    assert called == [1]
    tokens = torch.randint(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": tokens, "targets": tokens, "mask": torch.ones(2, 12)}
    T.loss_fn(params, batch, cfg)
    assert called == [1]
