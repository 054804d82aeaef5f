"""The PyTorch port on its own: what it imports, where it runs, its launch
counters, and the pieces of the serving path that need no JAX run."""
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serving.core import ModelRunner as JModelRunner

from repro_torch.configs import reduced_config
from repro_torch.core.swap import SwapTiming
from repro_torch.kernels import COUNTS, reset_counts
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_kernel,
    decode_attention_quant_kernel,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention,
    paged_decode_attention_kernel,
    paged_decode_attention_quant_kernel,
)
from repro_torch.kernels.prefill_attention.ops import prefill_attention, prefill_attention_kernel
from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel, tlmm_matmul
from repro_torch.models import transformer as T
from repro_torch.quant.ternary import quantize_and_pack
from repro_torch.serving import EngineCore, Request

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path[:0] = [{src!r}, {root!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        new = set(["repro_torch.quant.kv_quant", "repro_torch.serving.paging",
                   "repro_torch.kernels.paged_attention.ops",
                   "repro_torch.kernels.paged_attention.ref",
                   "repro_torch.serving.fair_queue", "repro_torch.serving.slo",
                   "repro_torch.serving.arrivals", "repro_torch.serving.async_engine",
                   "repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.drift",
                   "repro_torch.obs.engine", "repro_torch.common.hardware",
                   "repro_torch.core.roofline", "repro_torch.models.jax_init",
                   "repro_torch.launch.serve", "repro_torch.layers.moe",
                   "repro_torch.models.registry", "repro_torch.configs.smollm_135m",
                   "repro_torch.configs.deepseek_7b", "repro_torch.configs.qwen2_5_14b",
                   "repro_torch.configs.minicpm_2b", "repro_torch.configs.chameleon_34b",
                   "repro_torch.configs.granite_moe_3b_a800m",
                   "repro_torch.configs.moonshot_v1_16b_a3b",
                   "repro_torch.configs.hymba_1_5b", "repro_torch.configs.xlstm_1_3b",
                   "repro_torch.configs.whisper_large_v3", "repro_torch.models.ssm",
                   "repro_torch.models.hymba", "repro_torch.models.xlstm",
                   "repro_torch.models.encdec",
                   "repro_torch.examples.long_context_decode"])
        assert new <= set(names), sorted(new - set(names))
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        assert not bad, bad
    """).format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 45  # every module of the port was imported


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 0, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineCore(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 2, 64)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions never run a plain version: a CPU tensor is an error."""
    x_q = torch.zeros((4, 64), dtype=torch.int8)
    w = quantize_and_pack(torch.randn(64, 32))
    with pytest.raises(ValueError):
        tlmm_kernel(x_q, w.packed, torch.ones(4, 1))
    with pytest.raises(ValueError):
        act_quant_kernel(torch.zeros((4, 64)), w.scale)
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError):
        prefill_attention_kernel(q, q, q)
    with pytest.raises(ValueError):
        decode_attention_kernel(torch.zeros((1, 2, 1, 32)), q, q, torch.ones(1, dtype=torch.int32))
    qg, lengths = torch.zeros((1, 2, 1, 32)), torch.ones(1, dtype=torch.int32)
    payload, scale = torch.zeros((1, 2, 8, 16), dtype=torch.uint8), torch.ones((1, 2, 8))
    with pytest.raises(ValueError):
        decode_attention_quant_kernel(qg, payload, scale, payload, scale, lengths, kv_dtype="int4")
    tables = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_decode_attention_kernel(qg, q, q, tables, lengths)
    with pytest.raises(ValueError):
        paged_decode_attention_quant_kernel(qg, payload, scale, payload, scale, tables, lengths,
                                            kv_dtype="int4")


def test_tlmm_wrappers_refuse_empty_rows():
    """M = 0 is refused before any launch: no kernel writes into an empty y."""
    w = quantize_and_pack(torch.randn(64, 32))
    with pytest.raises(ValueError, match="non-empty"):
        tlmm_kernel(torch.zeros((0, 64), dtype=torch.int8), w.packed, torch.ones(0, 1))
    with pytest.raises(ValueError, match="M >= 1"):
        act_quant_kernel(torch.zeros((0, 64)), w.scale)


def test_launch_counters_stay_zero_on_cpu_tensors():
    reset_counts()
    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 1, device="cpu"), cfg)
    w = quantize_and_pack(torch.randn(64, 32))
    tlmm_matmul(torch.randn(3, 64), w)
    q = torch.randn(1, 2, 8, 32)
    prefill_attention(q, q, q)
    decode_attention(torch.randn(1, 2, 32), q, q, torch.tensor([5], dtype=torch.int32))
    eng = EngineCore(cfg, params, n_slots=2, max_len=64, prompt_len=16, device="cpu")
    outs = list(eng.generate(np.arange(7), max_new=3))
    assert outs[-1].finished and len(outs[-1].token_ids) == 3
    kv = T.init_paged_pool(cfg, 6, 8, kv_dtype="int4", device="cpu")
    paged_decode_attention(torch.randn(1, 4, 32), kv.k.q[:, 0], kv.v.q[:, 0],
                           torch.zeros((1, 2), dtype=torch.int32), torch.tensor([9], dtype=torch.int32),
                           k_scales=kv.k.scale[:, 0], v_scales=kv.v.scale[:, 0], kv_dtype="int4")
    eng = EngineCore(cfg, params, n_slots=2, max_len=64, prompt_len=16, cache_layout="paged",
                     kv_dtype="int8", device="cpu")
    outs = list(eng.generate(np.arange(7), max_new=3))
    assert outs[-1].finished and len(outs[-1].token_ids) == 3
    assert set(COUNTS) == {"act_quant", "tlmm", "prefill_attention", "decode_attention", "decode_attention_quant",
                           "paged_decode_attention", "paged_decode_attention_quant"}
    assert all(v == 0 for v in COUNTS.values()), COUNTS


def test_bucket_matches_jax_contiguous_buckets():
    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 2, device="cpu"), cfg)
    for max_len, q in [(2048, 32), (100, 16), (64, 16)]:
        eng = EngineCore(cfg, params, n_slots=1, max_len=max_len, prompt_len=q, device="cpu")
        jself = SimpleNamespace(cache_layout="contiguous", prompt_len=q, block_size=16,
                                max_len=max_len)
        for n in range(1, max_len):
            assert eng.runner.bucket(n) == JModelRunner.bucket(jself, n), (max_len, q, n)


def test_out_of_slice_arguments_raise_not_implemented():
    from repro_torch.serving import DisaggEngine

    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 3, device="cpu"), cfg)
    kw = dict(n_slots=1, max_len=64, device="cpu")
    # the disaggregated pools are ported; their split across two devices is not
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        DisaggEngine(cfg, params, n_slots=1, max_len=64, prefill_device="meta",
                     decode_device="cpu")
    # every model family and training are ported: the registry's loss_fn
    # trains the latent weights (the packed ones are refused)
    from repro_torch.models.registry import get_model

    tokens = torch.arange(16).reshape(2, 8) % cfg.vocab_size
    batch = {"tokens": tokens, "targets": tokens, "mask": torch.ones(2, 8)}
    loss, metrics = get_model(cfg).loss_fn(T.init(cfg, 3, device="cpu"), batch, cfg)
    assert torch.isfinite(loss) and loss.dim() == 0 and set(metrics) == {"nll", "aux"}
    with pytest.raises(ValueError, match="no latent weights"):
        get_model(cfg).loss_fn(params, batch, cfg)
    eng = EngineCore(cfg, params, **kw, swap_policy="slo-aware")
    with pytest.raises(ValueError, match="never truncated"):
        eng.submit(Request("long", np.arange(60, dtype=np.int32), max_new=8))


def test_decode_writes_the_new_token_after_attending_and_clamps_the_row():
    """The cache is read-only while the layers run; one write per step lands
    at min(length, Smax - 1), cast to the cache dtype."""
    cfg = reduced_config("bitnet-730m")
    params = T.convert_for_inference(T.init(cfg, 4, device="cpu"), cfg)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    lengths = torch.tensor([3, 40], dtype=torch.int32)  # slot 1 parked past the end
    logits, cache = T.decode_step(params, torch.tensor([1, 2]), cache, lengths, cfg)
    assert logits.shape == (2, cfg.padded_vocab()) and cache.k.dtype == torch.bfloat16
    written = cache.k.abs().sum(dim=(1, 2, 4)) > 0  # (B, Smax)
    assert written[0].nonzero().flatten().tolist() == [3]
    assert written[1].nonzero().flatten().tolist() == [15]


def test_swap_timing_hidden_fraction():
    t = SwapTiming(t_body=1.0, t_tail=0.5, t_relayout=0.4, t_total_overlapped=1.6)
    assert t.hidden_fraction == pytest.approx(0.75)
    assert SwapTiming(t_relayout=0.0).hidden_fraction == 0.0
