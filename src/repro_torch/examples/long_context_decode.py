"""Long-context decode on the sub-quadratic architectures — and the
quantized-KV transformer: the port of ``examples/long_context_decode.py``.

The ``long_500k`` cell (524,288-token context, batch 1) is only feasible for
architectures whose decode state is bounded: xlstm (O(1) recurrent state)
and hymba (sliding-window attention + SSM).  This example runs the decode
programs of both at a reduced scale and prints the time a step and the
state's MiB against the context length.  xlstm's state does not grow;
hymba's KV cache does, and its three global layers walk all of it, so only
its windowed layers' cost is flat in the context.

``--kv-dtype int8|int4`` additionally runs a transformer decode program
over the *quantized* KV cache (packed payload + f32 scale planes,
``repro_torch.quant.kv_quant``): the state column shrinks 2x/4x, which is
the paper's Eq. (5) bandwidth lever at long context.

    PYTHONPATH=src python -m repro_torch.examples.long_context_decode \\
        [--device cpu] [--kv-dtype int8]

It runs on the card unless ``--device cpu`` is given.  The weights are the
JAX example's (``init(cfg, PRNGKey(0), float32)``, drawn by
``models.jax_init``); the cache is the fresh one the JAX example decodes
over, or, with ``fill``, rows the caller writes.  On the card a step is
timed with CUDA events around ``STEPS`` eager steps (the host's launches
included).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.registry import get_model
from repro_torch.quant.kv_quant import payload_bytes

CONTEXTS = (64, 256, 1024)
STEPS = 5  # timed steps a context, after one warm-up


def state_bytes(cache) -> int:
    """Bytes of every tensor of a cache or state (nested tuples)."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(state_bytes(c) for c in cache)


def step_ms(step: Callable, device: torch.device) -> float:
    """ms a call of ``step()``, over ``STEPS`` calls after one warm-up:
    CUDA events on a card, the wall clock on the CPU."""
    step()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        return (time.perf_counter() - t0) / STEPS * 1e3
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    e0.record()
    for _ in range(STEPS):
        step()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / STEPS


def decode_rows(cfg: ModelConfig, params: dict, ctx_lengths, device, *,
                fill: Optional[Callable] = None,
                on_cache: Optional[Callable] = None) -> List[Tuple[int, float, int]]:
    """The decode program of ``cfg``'s family at batch 1 over each context:
    a cache of ``ctx`` rows (xlstm: its fixed state) with ``ctx - 1``
    tokens in it, ``fill(cache)`` writing its rows first where given, then
    ``STEPS`` timed steps of token 0.  ``on_cache(ctx, cache, lengths)``
    runs after the timing.  Returns [(ctx, ms a step, state bytes)]."""
    dev = resolve_device(device)
    api = get_model(cfg)
    rows = []
    for ctx in ctx_lengths:
        if cfg.family == "xlstm":
            cache = api.init_cache(cfg, 1, device=dev)  # O(1) state: no KV buffer at all
        else:
            cache = api.init_cache(cfg, 1, ctx, device=dev)
        if fill is not None:
            fill(cache)
        lengths = torch.full((1,), ctx - 1, dtype=torch.int32, device=dev)
        tok = torch.zeros((1,), dtype=torch.long, device=dev)
        ms = step_ms(lambda: api.decode_step(params, tok, cache, lengths, cfg), dev)
        rows.append((ctx, ms, state_bytes(cache)))
        if on_cache is not None:
            on_cache(ctx, cache, lengths)
        del cache
    return rows


def run_arch(arch: str, device) -> None:
    cfg = reduced_config(arch)
    dev = resolve_device(device)
    params = init_like_jax(cfg, 0, dev)
    print(f"\n{arch} ({cfg.family}): per-decode-step time vs context")
    for ctx, ms, nbytes in decode_rows(cfg, params, CONTEXTS, dev):
        print(f"  ctx {ctx:6d}: {ms:7.2f} ms/step   state {nbytes / 2**20:7.2f} MiB")


def run_transformer_kv(arch: str, kv_dtype: str, device) -> None:
    """Transformer decode program over a (possibly quantized) contiguous
    cache: the KV state column is what ``kv_dtype`` shrinks."""
    cfg = reduced_config(arch)
    dev = resolve_device(device)
    params = init_like_jax(cfg, 0, dev)
    print(f"\n{arch} (transformer, kv_dtype={kv_dtype}): per-decode-step time vs context")
    for ctx in CONTEXTS:
        cache = T.init_cache(cfg, 1, ctx, kv_dtype=kv_dtype, device=dev)
        lengths = torch.full((1,), ctx - 1, dtype=torch.int32, device=dev)
        tok = torch.zeros((1,), dtype=torch.long, device=dev)
        ms = step_ms(lambda: T.decode_step(params, tok, cache, lengths, cfg), dev)
        print(f"  ctx {ctx:6d}: {ms:7.2f} ms/step   KV {state_bytes(cache) / 2**20:7.2f} MiB "
              f"(payload {payload_bytes(cache) / 2**20:.2f} MiB)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8", "int4"],
                   help="KV-cache precision for the transformer long-context run")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    run_arch("xlstm-1.3b", args.device)
    run_arch("hymba-1.5b", args.device)
    run_transformer_kv("smollm-135m", args.kv_dtype, args.device)
    print("\nfull width on the card, up to the long_500k cell's 524,288 tokens: "
          "chip_smoke.py path (z)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
