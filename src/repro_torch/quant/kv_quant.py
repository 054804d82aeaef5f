"""KV-cache quantization: symmetric int8/int4 storage with f32 scale planes.

The port of the JAX package's ``repro.quant.kv_quant``, byte for byte:

* one symmetric absmax scale per (…, token) row, kept as an f32 *scale
  plane* of shape ``payload.shape[:-1]`` beside the packed payload;
  ``scale = absmax * f32(1/qmax)`` (1.0 for an all-zero row), the payload
  ``round_half_even(x / scale)`` clipped to ``±qmax`` — a multiply and a
  true f32 division, as the JAX package's jitted programs compute them,
  because the bytes depend on it (its op-by-op ``quantize_kv`` divides by
  qmax and can land one ulp away in the scale);
* int4 values in [-7, 7], nibble-packed in pairs along head_dim with the
  even index in the low nibble, so one token's row is ``D/2`` bytes and a
  one-token append touches only its own bytes.

Requantizing the same f32 values gives the same bytes, which is what keeps
preemption replay exact under quantization.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

KV_DTYPES = ("fp", "int8", "int4")

# bits a cached element takes (fp: the bf16 cache) and a row's scale
KV_DTYPE_BITS = {"fp": 16, "int8": 8, "int4": 4}
SCALE_BITS = 32  # one f32 scale a (layer, head, token) row

# symmetric range per dtype: int4 uses [-7, 7] (not -8) so negation is exact
QMAX = {"int8": 127, "int4": 7}


class QuantKV(NamedTuple):
    """One quantized K or V tensor: packed payload + its f32 scale plane.

    ``q``:     int8 (int8 mode) or uint8 nibble pairs (int4 mode); the
               trailing axis is head_dim (int8) or head_dim // 2 (int4).
    ``scale``: f32 with shape ``q.shape[:-1]``.
    """

    q: torch.Tensor
    scale: torch.Tensor


def assert_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def infer_kv_dtype(payload: torch.Tensor) -> str:
    """Payload dtype encodes the mode: int8 -> "int8", uint8 -> "int4"."""
    if payload.dtype == torch.int8:
        return "int8"
    if payload.dtype == torch.uint8:
        return "int4"
    return "fp"


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, D) int8 values in [-8, 7] -> (…, D//2) uint8 nibble pairs, the
    even index in the low nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"head_dim must be even to nibble-pack, got {tuple(q.shape)}")
    lo = q[..., 0::2].to(torch.int32) & 0x0F
    hi = q[..., 1::2].to(torch.int32) & 0x0F
    return ((hi << 4) | lo).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(…, D//2) uint8 -> (…, D) int8, sign-extending each nibble with an
    arithmetic shift."""
    pi = packed.view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(pi, 4), 4)
    hi = torch.bitwise_right_shift(pi, 4)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize_kv(x: torch.Tensor, kv_dtype: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Symmetric per-row absmax quantization of a (…, D) K/V tensor, from
    f32.  Returns ``(payload, scale)``; ``"fp"`` returns ``(x, None)``."""
    assert_kv_dtype(kv_dtype)
    if kv_dtype == "fp":
        return x, None
    qmax = QMAX[kv_dtype]
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    # times the f32 reciprocal of qmax (the Python scalar is rounded to f32):
    # what XLA compiles the JAX package's `absmax / qmax` to in every jitted
    # serving program
    scale = torch.where(absmax > 0, absmax * (1.0 / qmax), torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax).to(torch.int8)
    if kv_dtype == "int4":
        q = pack_int4(q)
    return q, scale


def dequantize_kv(payload: torch.Tensor, scale: torch.Tensor,
                  kv_dtype: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` -> f32 (…, D)."""
    if kv_dtype is None:
        kv_dtype = infer_kv_dtype(payload)
    if kv_dtype == "fp":
        return payload
    q = unpack_int4(payload) if kv_dtype == "int4" else payload
    return q.float() * scale[..., None].float()


def quantize_kv_tree(kv, kv_dtype: str):
    """A KVCache of fp tensors -> a KVCache of QuantKV leaves (unchanged for
    "fp")."""
    assert_kv_dtype(kv_dtype)
    if kv_dtype == "fp":
        return kv
    return type(kv)(*(QuantKV(*quantize_kv(x, kv_dtype)) for x in kv))


def _leaves(tree):
    for leaf in tree:
        if isinstance(leaf, QuantKV):
            yield from leaf
        else:
            yield leaf


def total_nbytes(tree) -> int:
    """Bytes of every tensor of a KVCache, scale planes included."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def payload_bytes(tree) -> int:
    """Payload bytes of a KVCache whose leaves may be QuantKV (scales excluded)."""
    total = 0
    for leaf in tree:
        t = leaf.q if isinstance(leaf, QuantKV) else leaf
        total += t.numel() * t.element_size()
    return total
