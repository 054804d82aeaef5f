"""The port's analytic models against the JAX package's and the smoke's
bounds: ``kernels/costs.py`` (the Hopper kernels' cost models), the TLMM
table-lookup oracle, ``core/dse.py`` and the DSE example.

* ``flops`` of each kernel's cost equal the JAX ``kernels/costs.py``
  model's for the same shapes (the prefill's at unit tiles, where the JAX
  model counts the causal half exactly); the mLSTM and sLSTM models equal
  JAX's field for field;
* ``min_bytes`` and ``flops`` give the bound ``chip_smoke.py`` prints for
  every shape of ``PERF.md`` §6, to the digits printed there, and equal the
  sums the smoke used to write out inline;
* B2's shared memory is ``smem_bytes<D, BKV>()``; every registry arch's
  launches fit in 227 KiB and 8-block clusters;
* ``tlmm_lut_reference`` is bit-equal to ``tlmm_reference`` and to the JAX
  ``tlmm_lut_reference``;
* ``run_dse`` / ``best_config`` handed ``TPU_V5E`` equal the JAX ones, and
  the example prints the JAX example's frontier.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.common.hardware import TPU_V5E as JAX_V5E
from repro.configs import get_config as jax_config
from repro.core import dse as jax_dse
from repro.kernels import costs as jax_costs
from repro.kernels.tlmm.ref import tlmm_lut_reference as jax_lut

from repro_torch.analysis import kernel_check
from repro_torch.common.hardware import TPU_V5E
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import dse
from repro_torch.examples import dse_explore
from repro_torch.kernels import costs
from repro_torch.kernels.tlmm.ref import tlmm_lut_reference, tlmm_reference

ROOT = Path(__file__).resolve().parents[1]
HBM, PEAK = 3.35e12, {"int8": 1979e12, "f32": 67e12, "tf32": 495e12}


def _bound_ms(nbytes, ops, kind):
    return max(nbytes / HBM, ops / PEAK[kind]) * 1e3


# ------------------------------------------------------------ the flops --

@pytest.mark.parametrize("m,k,n", [(1, 1536, 1536), (4, 1536, 4096), (8, 4096, 1536),
                                   (9, 1536, 200), (20, 260, 136), (1024, 4096, 1536)])
def test_tlmm_flops_equal_the_jax_model(m, k, n):
    assert costs.tlmm_cost(m, k, n).flops == jax_costs.tlmm_cost(m, k, n).flops


@pytest.mark.parametrize("b,h,hkv,s,d,window,skv", [
    (1, 24, 24, 256, 64, None, None), (2, 40, 8, 2048, 128, None, None),
    (1, 25, 5, 2048, 64, 1024, None), (1, 20, 20, 64, 64, None, 1500),
    (1, 8, 2, 65, 32, None, None)])
def test_prefill_flops_equal_the_jax_model_at_unit_tiles(b, h, hkv, s, d, window, skv):
    # the JAX model rounds the causal walk to its 256-row tiles; at 1-row
    # tiles it counts each query row's keys, the work the port's bound counts
    want = jax_costs.prefill_attention_cost(b, h, hkv, s, d, blk=1, window=window, skv=skv)
    got = costs.prefill_attention_cost(b, h, hkv, s, d, window=window, skv=skv)
    assert got.flops == pytest.approx(want.flops, rel=1e-12)


@pytest.mark.parametrize("b,h,hkv,s,d,window", [(4, 24, 24, 2048, 64, None),
                                                (4, 40, 8, 2048, 128, None),
                                                (4, 25, 5, 4096, 64, 1024)])
def test_decode_flops_equal_the_jax_model(b, h, hkv, s, d, window):
    want = jax_costs.decode_attention_cost(b, h, hkv, s, d, window=window)
    starts = None if window is None else [s - window] * b
    for kv, paged in (("fp", False), ("int8", True), ("int4", False)):
        got = costs.decode_attention_cost([s] * b, hkv, h // hkv, d, starts=starts, kv_dtype=kv,
                                          paged=paged, cap=s)
        assert got.flops == want.flops


def test_recurrent_models_equal_the_jax_models_exactly():
    for args in ((4, 4, 512, 512), (1, 4, 2048, 256)):
        got, want = costs.mlstm_chunk_cost(*args), jax_costs.mlstm_chunk_cost(*args)
        assert (got.flops, got.hbm_bytes, got.smem_bytes) == (
            want.flops, want.hbm_bytes, want.vmem_bytes)
    for args in ((4, 512, 2048, 4), (1, 1024, 1024, 4)):
        got, want = costs.slstm_scan_cost(*args), jax_costs.slstm_scan_cost(*args)
        assert (got.flops, got.hbm_bytes, got.smem_bytes) == (
            want.flops, want.hbm_bytes, want.vmem_bytes)


# -------------------------------------------- the bounds of PERF.md §6 --

DECODE = [0, 517, 1300, 2048]
VERIFY = [n + i for n in (5, 517, 1300, 2040) for i in range(5)]
HYMBA = [2048, 2100, 3000, 4095]

# (what, cost, kind of operations, their multiple, the bound PERF.md prints)
PERF_BOUNDS = [
    ("B1 M=4 1536x1536", lambda: costs.tlmm_cost(4, 1536, 1536), "int8", 1, "0.00019"),
    ("B1 M=4 1536x4096", lambda: costs.tlmm_cost(4, 1536, 4096), "int8", 1, "0.00049"),
    ("B1 M=4 4096x1536", lambda: costs.tlmm_cost(4, 4096, 1536), "int8", 1, "0.00048"),
    ("B1 M=20 1536x1536", lambda: costs.tlmm_cost(20, 1536, 1536), "int8", 1, "0.00022"),
    ("B1 M=20 1536x4096", lambda: costs.tlmm_cost(20, 1536, 4096), "int8", 1, "0.00058"),
    ("B1 M=20 4096x1536", lambda: costs.tlmm_cost(20, 4096, 1536), "int8", 1, "0.00053"),
    ("B1 M=1024 1536x1536", lambda: costs.tlmm_cost(1024, 1536, 1536), "int8", 1, "0.0025"),
    ("B1 M=1024 1536x4096", lambda: costs.tlmm_cost(1024, 1536, 4096), "int8", 1, "0.0065"),
    ("B1 M=1024 4096x1536", lambda: costs.tlmm_cost(1024, 4096, 1536), "int8", 1, "0.0065"),
    ("B2 (1,24,256,64)", lambda: costs.prefill_attention_cost(1, 24, 24, 256, 64), "tf32", 3,
     "0.0019"),
    ("B2 (1,24,256,64) FMA", lambda: costs.prefill_attention_cost(1, 24, 24, 256, 64), "f32", 1,
     "0.0030"),
    ("B2 (1,24,2048,64)", lambda: costs.prefill_attention_cost(1, 24, 24, 2048, 64), "tf32", 3,
     "0.0781"),
    ("B2 (1,24,2048,64) FMA", lambda: costs.prefill_attention_cost(1, 24, 24, 2048, 64), "f32",
     1, "0.1924"),
    ("B2 qwen S=256", lambda: costs.prefill_attention_cost(1, 40, 8, 256, 128), "tf32", 3,
     "0.0041"),
    ("B2 qwen S=256 FMA", lambda: costs.prefill_attention_cost(1, 40, 8, 256, 128), "f32", 1,
     "0.0101"),
    ("B2 qwen S=2048", lambda: costs.prefill_attention_cost(1, 40, 8, 2048, 128), "tf32", 3,
     "0.2604"),
    ("B2 qwen S=2048 FMA", lambda: costs.prefill_attention_cost(1, 40, 8, 2048, 128), "f32", 1,
     "0.6414"),
    ("B2 whisper S=64", lambda: costs.prefill_attention_cost(1, 20, 20, 64, 64), "tf32", 3,
     "0.0004"),
    ("B2 whisper S=2048", lambda: costs.prefill_attention_cost(1, 20, 20, 2048, 64), "tf32", 3,
     "0.0651"),
    ("B2 whisper S=2048 FMA", lambda: costs.prefill_attention_cost(1, 20, 20, 2048, 64), "f32",
     1, "0.1603"),
    ("B3 bitnet", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, cap=2048), "f32", 1,
     "0.0071"),
    ("B3 qwen", lambda: costs.decode_attention_cost(DECODE, 8, 5, 128, cap=2048), "f32", 1,
     "0.0048"),
    ("B3 chameleon", lambda: costs.decode_attention_cost(DECODE, 8, 8, 128, cap=2048), "f32", 1,
     "0.0048"),
    ("B3 granite", lambda: costs.decode_attention_cost(DECODE, 8, 3, 64, cap=2048), "f32", 1,
     "0.0024"),
    ("B3 hymba window", lambda: costs.decode_attention_cost(
        HYMBA, 5, 5, 64, cap=4096, starts=[max(n + 1 - 1024, 0) for n in HYMBA]), "f32", 1,
     "0.0016"),
    ("B3 whisper cross", lambda: costs.decode_attention_cost([1500] * 4, 20, 1, 64, cap=1536),
     "f32", 1, "0.0092"),
    ("B3 long_500k", lambda: costs.decode_attention_cost([524287], 5, 5, 64, cap=524288), "f32",
     1, "0.2003"),
    ("B4 int8", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, kv_dtype="int8",
                                                     cap=2048), "f32", 1, "0.0038"),
    ("B4 int4", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, kv_dtype="int4",
                                                     cap=2048), "f32", 1, "0.0020"),
    ("B4 verify", lambda: costs.decode_attention_cost(VERIFY, 24, 1, 64, kv_dtype="int8",
                                                       cap=2048, rows_per_slot=5), "f32", 1,
     "0.0039"),
    ("B4 qwen int8", lambda: costs.decode_attention_cost(DECODE, 8, 5, 128, kv_dtype="int8",
                                                          cap=2048), "f32", 1, "0.0025"),
    ("B5 bitnet", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, paged=True, bs=16,
                                                       cap=2048), "f32", 1, "0.0071"),
    ("B5 qwen", lambda: costs.decode_attention_cost(DECODE, 8, 5, 128, paged=True, bs=16,
                                                     cap=2048), "f32", 1, "0.0048"),
    ("B6 int8", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, kv_dtype="int8",
                                                     paged=True, bs=16, cap=2048), "f32", 1,
     "0.0038"),
    ("B6 int4", lambda: costs.decode_attention_cost(DECODE, 24, 1, 64, kv_dtype="int4",
                                                     paged=True, bs=16, cap=2048), "f32", 1,
     "0.0020"),
    ("B6 verify", lambda: costs.decode_attention_cost(VERIFY, 24, 1, 64, kv_dtype="int8",
                                                       paged=True, bs=16, cap=2048,
                                                       rows_per_slot=5), "f32", 1, "0.0039"),
    ("B6 qwen int8", lambda: costs.decode_attention_cost(DECODE, 8, 5, 128, kv_dtype="int8",
                                                          paged=True, bs=16, cap=2048), "f32", 1,
     "0.0025"),
    ("B6 chameleon int8", lambda: costs.decode_attention_cost(DECODE, 8, 8, 128, kv_dtype="int8",
                                                               paged=True, bs=16, cap=2048),
     "f32", 1, "0.0025"),
    ("B6 granite int8", lambda: costs.decode_attention_cost(DECODE, 8, 3, 64, kv_dtype="int8",
                                                             paged=True, bs=16, cap=2048), "f32",
     1, "0.0013"),
]


@pytest.mark.parametrize("what,cost,kind,mult,printed", PERF_BOUNDS,
                         ids=[p[0] for p in PERF_BOUNDS])
def test_bounds_of_perf_md_are_unchanged(what, cost, kind, mult, printed):
    c = cost()
    got = _bound_ms(c.min_bytes, mult * c.flops, kind)
    decimals = len(printed.split(".")[1])
    assert f"{got:.{decimals}f}" == printed, (what, got)


def _walk_inline(lengths, hkv, g, d, row_bytes, starts=None, tables=0):
    """The walks' bound as the smoke summed it inline before kernels.costs."""
    b = len(lengths)
    live = sum(n - (0 if starts is None else s) for n, s in zip(lengths, starts or lengths))
    small = b * hkv * g * d * 4 * 2 + 2 * b * hkv * g * 4 + b * 4 * (1 if starts is None else 2)
    return 2 * live * hkv * row_bytes + small + tables * 4, 4.0 * d * hkv * g * live


def test_costs_equal_the_sums_the_smoke_wrote_out():
    for m in (4, 20, 1024):
        for k, n in ((1536, 1536), (1536, 4096), (4096, 1536)):
            c = costs.tlmm_cost(m, k, n)
            assert (c.min_bytes, c.flops) == (m * k + k * n / 4 + m * 4 + m * n * 4,
                                              2.0 * m * k * n)
    for h, hkv, s, d in ((24, 24, 256, 64), (40, 8, 2048, 128), (20, 20, 64, 64)):
        c = costs.prefill_attention_cost(1, h, hkv, s, d)
        assert (c.min_bytes, c.flops) == ((2 * h * s * d + 2 * hkv * s * d) * 4,
                                          4.0 * d * h * s * (s + 1) / 2)
    used = sum(-(-n // 16) for n in DECODE)
    for g, d, hkv in ((1, 64, 24), (5, 128, 8), (3, 64, 8)):
        for kv, rb in (("fp", 2 * d), ("int8", d + 4), ("int4", d // 2 + 4)):
            slot = costs.decode_attention_cost(DECODE, hkv, g, d, kv_dtype=kv, cap=2048)
            paged = costs.decode_attention_cost(DECODE, hkv, g, d, kv_dtype=kv, paged=True,
                                                cap=2048)
            assert (slot.min_bytes, slot.flops) == _walk_inline(DECODE, hkv, g, d, rb)
            assert (paged.min_bytes, paged.flops) == _walk_inline(DECODE, hkv, g, d, rb,
                                                                  tables=used)
    starts = [max(n + 1 - 1024, 0) for n in HYMBA]
    c = costs.decode_attention_cost(HYMBA, 5, 5, 64, cap=4096, starts=starts)
    assert (c.min_bytes, c.flops) == _walk_inline(HYMBA, 5, 5, 64, 128, starts=starts)
    # verify rows: each slot's rows read once (its longest row), every row's operations
    c = costs.decode_attention_cost(VERIFY, 24, 1, 64, kv_dtype="int8", cap=2048,
                                    rows_per_slot=5)
    small = 20 * 24 * 64 * 4 * 2 + 2 * 20 * 24 * 4 + 20 * 4
    read = sum((5, 517, 1300, 2040)) + 4 * 4
    assert (c.min_bytes, c.flops) == (2 * read * 24 * 68 + small, 4.0 * 64 * 24 * sum(VERIFY))
    p = costs.decode_attention_cost(VERIFY, 24, 1, 64, kv_dtype="int8", paged=True, cap=2048,
                                    rows_per_slot=5)
    assert p.min_bytes == c.min_bytes + 4 * sum(-(-(n + 4) // 16) for n in (5, 517, 1300, 2040))


# ------------------------------------------------------- shared memory --

@pytest.mark.parametrize("d,s,bkv", [(32, 64, 64), (64, 512, 64), (64, 513, 32),
                                     (128, 256, 32), (128, 2048, 32)])
def test_prefill_smem_is_the_kernels_smem_bytes(d, s, bkv):
    # csrc/prefill_attention.cu: smem_bytes<D, BKV>() = (kBQ + 4 * BKV) * (D + 4) * 4
    assert costs.prefill_attention_cost(1, 8, 8, s, d).smem_bytes == (64 + 4 * bkv) * (d + 4) * 4


def test_every_registry_arch_launch_fits_the_card():
    for arch in ALL_ARCHS:
        launches, problems = kernel_check.served_launches(get_config(arch))
        assert problems == [], (arch, problems)
        for ln in launches:
            assert ln.cost.smem_bytes <= 227 * 1024, (arch, ln)
            assert ln.cost.cluster <= 8, (arch, ln)
    # the walks: 8-block clusters; the split-K TLMM 4 or 8; the MMA TLMM none
    assert costs.decode_attention_cost([64], 2, 1, 64).cluster == 8
    assert costs.tlmm_cost(4, 1536, 1536).cluster in (4, 8)
    assert costs.tlmm_cost(9, 1536, 1536).cluster == 1


# ------------------------------------------------------- the LUT oracle --

@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (4, 256, 130), (9, 512, 64), (7, 1536, 40)])
def test_tlmm_lut_reference_is_bit_equal(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    scale = (rng.random((m, 1)) * 1e-2).astype(np.float32)
    xt, wt, st = (torch.from_numpy(a) for a in (x_q, w, scale))
    got = tlmm_lut_reference(xt, wt, st)
    assert got.dtype == torch.float32
    assert torch.equal(got, tlmm_reference(xt, wt, st))
    want = np.asarray(jax_lut(jnp.asarray(x_q), jnp.asarray(w), jnp.asarray(scale),
                              out_dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the DSE --

DSE_CASES = [dict(), dict(static_baseline=True), dict(kv_dtype="int8"), dict(kv_dtype="int4"),
             dict(spec_k=4, spec_accept_rate=0.6)]


@pytest.mark.parametrize("arch", ["bitnet-730m", "qwen2.5-14b"])
def test_run_dse_equals_jax_on_tpu_v5e(arch):
    for kw in DSE_CASES:
        got = dse.run_dse(get_config(arch), chip=TPU_V5E, **kw)
        want = jax_dse.run_dse(jax_config(arch), chip=JAX_V5E, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.config.__dict__ == w.config.__dict__, kw
            assert (g.vmem_bytes, g.feasible) == (w.vmem_bytes, w.feasible)
            for f in ("t_pre", "t_dec_short", "t_dec_long", "objective"):
                assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12, abs=0.0)
        assert (dse.best_config(get_config(arch), chip=TPU_V5E, **kw).__dict__
                == jax_dse.best_config(jax_config(arch), chip=JAX_V5E, **kw).__dict__)


def test_dse_defaults_to_the_h100():
    from repro_torch.common.hardware import H100_SXM

    assert dse.DEFAULT_CHIP is H100_SXM
    pts = dse.run_dse(get_config("bitnet-730m"))
    assert pts[0].feasible and pts[0].vmem_bytes <= H100_SXM.vmem_bytes


def test_example_prints_the_jax_examples_frontier_on_tpu_v5e():
    spec = importlib.util.spec_from_file_location("jax_dse_explore",
                                                  ROOT / "examples" / "dse_explore.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    for arch in ("bitnet-730m", "qwen2.5-14b", "xlstm-1.3b"):
        got, want = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(got):
            dse_explore.explore(arch, chip=TPU_V5E)
        with contextlib.redirect_stdout(want):
            jax_example.explore(arch)
        assert got.getvalue() == want.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dse_explore.main(["--arch", "smollm-135m", "--chip", "tpu-v5e"])
    assert "=== smollm-135m ===" in out.getvalue()
