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
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.core.swap import SwapController
from repro_torch.models import transformer as T
from repro_torch.models.jax_init import init_like_jax

PROMPT_LEN, MAX_LEN, N_NEW = 32, 96, 12
# what ``examples/quickstart.py`` prints on the CPU (jax 0.9); the tests
# hold this to a live run of it
JAX_QUICKSTART_TOKENS = [317, 317, 317, 720, 720, 720, 720, 720, 720, 720, 206, 279]
# how far the card's logits may lie from the CPU port's on the same tokens
LOGIT_TOL = 5e-3


def quickstart_config():
    return reduced_config("bitnet-730m", num_layers=4, d_model=256, vocab_size=1024)


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
