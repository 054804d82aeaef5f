"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips where there is none.  Run them on a machine with a card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import COUNTS, reset_counts
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.prefill_attention.ops import prefill_attention_kernel
from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference
from repro_torch.kernels.tlmm.ops import tlmm_kernel
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.models import transformer as T
from repro_torch.serving import EngineCore, Request

pytestmark = pytest.mark.gpu

# f32 attention in another summation order than the plain version
ATTN_TOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 1536, 1536), (4, 1536, 4096), (8, 4096, 1536),
                                   (3, 256, 100), (9, 256, 100), (37, 1536, 1536), (300, 4096, 1536)])
def test_tlmm_kernel_bit_exact(m, k, n):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    x_q = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    w = torch.randint(0, 256, (k // 4, n), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-2
    y = tlmm_kernel(x_q, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(y, tlmm_reference(x_q, w, scale))


@pytest.mark.parametrize("h,hkv,s,d", [(4, 4, 1, 64), (4, 2, 65, 32), (24, 24, 200, 64),
                                       (2, 1, 130, 128)])
def test_prefill_attention_kernel(h, hkv, s, d):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s + d)
    b = 2
    # strided (B, S, H, D) -> (B, H, S, D) views, as the attention layer passes them
    q = torch.randn((b, s, h, d), generator=g, device=dev).transpose(1, 2)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).transpose(1, 2)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).transpose(1, 2)
    out = prefill_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    ref = prefill_attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= ATTN_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,d", [(1, 64), (2, 32), (3, 128)])
def test_decode_attention_kernel_on_strided_cache(dtype, g, d):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(g * d)
    b, layers, hkv, smax = 4, 3, 2, 300
    cache = torch.randn((b, layers, hkv, smax, d), generator=gen, device=dev).to(dtype)
    k, v = cache[:, 1], cache[:, 2]  # strided layer slices, never copied
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
    lengths = torch.tensor([0, 1, 257, smax], dtype=torch.int32, device=dev)
    for starts in (None, torch.tensor([0, 0, 40, 290], dtype=torch.int32, device=dev)):
        out, l, m = decode_attention_kernel(q, k, v, lengths, starts)
        torch.cuda.synchronize()
        out_r, l_r, m_r = decode_attention_reference(q, k, v, lengths, starts)
        assert (out - out_r).abs().max().item() <= ATTN_TOL
        assert torch.allclose(l, l_r, rtol=ATTN_TOL, atol=ATTN_TOL)
        assert torch.allclose(m, m_r, rtol=0, atol=ATTN_TOL)
        assert (out[0] == 0).all() and (l[0] == 0).all() and (m[0] == -1e30).all()


@pytest.mark.parametrize("mode,overlap", [("pdswap", True), ("pdswap", False), ("static", True)])
def test_engine_on_cuda_matches_cpu_and_goes_through_the_kernels(mode, overlap):
    dev = _cuda()
    cfg = reduced_config("bitnet-730m", num_layers=3)
    params_cpu = T.convert_for_inference(T.init(cfg, 5, device="cpu"), cfg)
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 17, 9, 30)]
    streams = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = EngineCore(cfg, params, n_slots=2, max_len=64, prompt_len=16, mode=mode,
                         overlap=overlap, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, max_new=6))
        reset_counts()
        st = eng.run()
        streams[device] = {r: q.out_tokens for r, q in eng.finished.items()}
    assert streams["cuda"] == streams["cpu"]
    assert COUNTS["tlmm"] == 7 * cfg.num_layers * (len(prompts) + st.decode_rounds)
    assert COUNTS["prefill_attention"] == cfg.num_layers * len(prompts)
    assert COUNTS["decode_attention"] == cfg.num_layers * st.decode_rounds


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(tree.packed.to(dev), tree.scale.to(dev))
