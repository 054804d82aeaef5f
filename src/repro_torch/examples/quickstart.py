"""Quickstart: the PD-Swap mechanism end to end on the port, in one page.

Builds the quickstart's tiny BitNet-style ternary transformer (bitnet-730m
cut to 4 layers, d_model 256, vocab 1024), runs the split prefill program,
performs the logic swap (the KV relayout into the decode cache, overlapped
with the prefill tail on a second CUDA stream), then decodes greedily with
the decode program — a CUDA graph on a card — with the overlap on and off.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The weights are drawn as the JAX package's ``init`` draws them from
``PRNGKey(0)`` (threefry keys and bits bit for bit, the normal through the
polynomial inverse error function XLA evaluates, equal to float rounding)
and stay latent, quantized on the fly at every linear as in the JAX
quickstart (``examples/quickstart.py``).  It runs on the card unless
``--device cpu`` asks for the CPU.  It exits non-zero when the overlapped
and the serialized swap disagree, and when the tokens are not the JAX
quickstart's.  On the card the f32 sums run in other orders, and an ulp
can move an int8 activation rounding, which moves a logit by far more
than an ulp; where the model's top two logits lie closer than that, the
card may pick the other one.  So on the card the tokens must be the JAX
quickstart's up to the first step where they part, and there the card's
own logits must hold the JAX quickstart's token within ``2 * LOGIT_TOL``
of the one it picked (a near tie); the later tokens follow another prefix
and are printed only.  ``tests/test_torch_gpu.py`` holds the card's logits
to the CPU port's, on the card's tokens, within ``LOGIT_TOL``.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.core.sampling import MASK32, random_bits, threefry2x32
from repro_torch.core.swap import SwapController
from repro_torch.models import transformer as T

PROMPT_LEN, MAX_LEN, N_NEW = 32, 96, 12
# what ``examples/quickstart.py`` prints on the CPU (jax 0.9); the tests
# hold this to a live run of it
JAX_QUICKSTART_TOKENS = [317, 317, 317, 720, 720, 720, 720, 720, 720, 720, 206, 279]
# how far the card's logits may lie from the CPU port's on the same tokens
LOGIT_TOL = 5e-3
# Giles's single-precision erf_inv polynomial (the one XLA evaluates), in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def quickstart_config():
    return reduced_config("bitnet-730m", num_layers=4, d_model=256, vocab_size=1024)


def _split(key, n: int):
    """``jax.random.split(key, n)`` (threefry, partitionable): key i is the
    threefry of the counter (0, i)."""
    k0, k1 = key
    x1 = torch.arange(n, dtype=torch.int64)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return [(y0[i], y1[i]) for i in range(n)]


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = torch.where(small, torch.tensor(a), torch.tensor(b)) + p * w
    return p * x


def _normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: uniform on
    [nextafter(-1, 0), 1) from the key's bits, times sqrt(2), through the
    inverse error function."""
    n = math.prod(shape)
    bits = random_bits((key[0].reshape(1), key[1].reshape(1)), n)[0]
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = torch.maximum(floats * 2.0 + lo, lo)  # (1 - lo) rounds to 2.0 in f32
    return (_erf_inv(u) * math.sqrt(2)).reshape(shape)


def init_like_jax(cfg, seed: int = 0, device=None) -> dict:
    """The quickstart model's latent f32 weights as the JAX package's
    ``transformer.init(cfg, PRNGKey(seed), float32)`` draws them (the
    key-split tree of its init, layer by layer), in the port's layout."""
    k_emb, k_layers, _ = _split((torch.tensor(0), torch.tensor(seed & MASK32)), 3)
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(key, k, n, scale=None):
        return {"w": _normal(key, (k, n)) * (1.0 / k ** 0.5 if scale is None else scale)}

    layers = []
    for kl in _split(k_layers, cfg.num_layers):
        ka, kf = _split(kl, 2)
        k1, k2, k3, k4 = _split(ka, 4)
        m1, m2, m3 = _split(kf, 3)
        layers.append({
            "attn": {"wq": lin(k1, d, h * hd), "wk": lin(k2, d, hkv * hd),
                     "wv": lin(k3, d, hkv * hd), "wo": lin(k4, h * hd, d, 1.0 / (h * hd) ** 0.5)},
            "ln1": {"scale": torch.ones(d)}, "ln2": {"scale": torch.ones(d)},
            "mlp": {"w_gate": lin(m1, d, f), "w_up": lin(m2, d, f),
                    "w_down": lin(m3, f, d, 1.0 / f ** 0.5)},
        })
    params = {"emb": _normal(k_emb, (cfg.padded_vocab(), d)) * 0.02,
              "layers": T._stack(layers), "ln_f": {"scale": torch.ones(d)}}
    dev = resolve_device(device)
    return _to(params, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def run(params, cfg, *, device, overlap: bool, log=print, feed: Optional[List[int]] = None,
        logits_out: Optional[list] = None) -> List[int]:
    """Prefill + swap + greedy decode of the quickstart's prompt; returns
    the N_NEW tokens.  ``feed`` (N_NEW tokens) is decoded in place of the
    greedy ones (the tokens returned stay the argmax of each step);
    ``logits_out`` collects each step's logits row, on the CPU."""
    tokens = (torch.arange(PROMPT_LEN, dtype=torch.int64, device=device) * 7
              % cfg.vocab_size)[None]
    engine = PhaseEngine(cfg)
    body, tail = engine.prefill_split_programs(1, PROMPT_LEN)
    relayout = engine.relayout_program(1, PROMPT_LEN, MAX_LEN)
    decode = engine.decode_program(1, MAX_LEN)
    cache = T.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device=device)

    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    ctl = SwapController(body.fn, tail.fn, lambda kv: relayout(kv, cache, 0), side_stream=side)
    logits, cache, timing = ctl.prefill_and_swap(params, tokens, overlap=overlap)
    log(f"prefill+swap ({'overlapped' if overlap else 'serialized'}): body "
        f"{timing.t_body * 1e3:.1f} ms, tail {timing.t_tail * 1e3:.1f} ms, relayout "
        f"{timing.t_relayout * 1e3:.1f} ms")

    lengths = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=device)
    out = []
    t0 = time.perf_counter()
    for i in range(N_NEW):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(int(tok[0]))
        if logits_out is not None:
            logits_out.append(logits[0, :cfg.vocab_size].float().cpu())
        if i == N_NEW - 1:
            break
        if feed is not None:
            tok = torch.full((1,), feed[i], dtype=torch.int32, device=device)
        logits, _ = decode(params, tok, cache, lengths)
        lengths += 1
    dt = time.perf_counter() - t0
    log(f"decoded {N_NEW} tokens: {out}")
    log(f"decode: {N_NEW / dt:.1f} tok/s on {device} (a toy size: launch overhead)")
    return out


def parting(tokens: List[int], logits: List[torch.Tensor]):
    """The first step where ``tokens`` leave the JAX quickstart's, and how
    far that step's logits put the token picked above the JAX quickstart's
    (None where they do not part)."""
    for i, (got, want) in enumerate(zip(tokens, JAX_QUICKSTART_TOKENS)):
        if got != want:
            return i, float(logits[i][got] - logits[i][want])
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = quickstart_config()
    params = init_like_jax(cfg, 0, device)  # latent: ternary on the fly, as the JAX quickstart
    rows = [[], []]
    streams = [run(params, cfg, device=device, overlap=o, logits_out=r)
               for o, r in zip((True, False), rows)]
    if streams[0] != streams[1]:
        print("overlap on and off gave different tokens")
        return 1
    part = parting(streams[0], rows[0])
    if part is None:
        print(f"the JAX quickstart's tokens: {JAX_QUICKSTART_TOKENS} (the same)")
        return 0
    step, margin = part
    tie = device.type == "cuda" and margin <= 2 * LOGIT_TOL
    print(f"the JAX quickstart's tokens: {JAX_QUICKSTART_TOKENS} (these part at step {step}: "
          f"{streams[0][step]} over {JAX_QUICKSTART_TOKENS[step]} by {margin:.6f} in this run's "
          f"logits, {'a near tie' if tie else 'not a near tie'} at a tolerance of "
          f"{2 * LOGIT_TOL if device.type == 'cuda' else 0})")
    return 0 if tie else 1


if __name__ == "__main__":
    raise SystemExit(main())
