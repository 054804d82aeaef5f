"""BitNet b1.58 ternary weight quantization + 2-bit packing.

Packing format (the same bytes as ``repro.quant.ternary``):
  4 ternary values -> 1 uint8 along the *input* (K) dimension.
  2-bit codes: 0b00 -> 0, 0b01 -> +1, 0b10 -> -1  (0b11 unused, decodes to 0).
  value k = 4*j + i  lives in bits [2i, 2i+2) of packed[j].
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class TernaryWeight:
    """A packed ternary weight: the on-device format of a TLMM linear.
    Layer-stacked in a model's params: ``packed`` (L, K/4, N), ``scale`` (L,)."""

    packed: torch.Tensor  # uint8, (K // 4, N)
    scale: torch.Tensor  # f32 scalar — BitNet absmean beta

    @property
    def n(self) -> int:
        return self.packed.shape[-1]

    def __getitem__(self, i) -> "TernaryWeight":
        """Index the leading (layer) dim of a stacked weight."""
        return TernaryWeight(self.packed[i], self.scale[i])


def ternary_quantize(w: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmean quantizer: W_q = RoundClip(W / (mean|W| + eps), -1, 1),
    beta = mean|W|.  Returns (w_q int8 in {-1,0,1}, beta f32 scalar).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    wf = w.float()
    beta = wf.abs().mean()
    w_q = torch.clamp(torch.round(wf / (beta + eps)), -1, 1)
    return w_q.to(torch.int8), beta


def ternary_quantize_ste(w: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The straight-through version for quantization-aware training.
    Forward: the dequantized ternary weights ``w_q * beta``, as the JAX
    expression ``w + stop_gradient(deq - w)`` rounds them (in float that is
    not always ``deq``); backward: the identity to the latent weights."""
    with torch.no_grad():
        w_q, beta = ternary_quantize(w, eps)
        deq = w_q.to(w.dtype) * beta.to(w.dtype)
    return w + (deq - w).detach(), beta


def pack_ternary(w_q: torch.Tensor) -> torch.Tensor:
    """Pack int8 ternary (K, N) -> uint8 (K//4, N); K must be a multiple of 4."""
    k, n = w_q.shape
    assert k % 4 == 0, f"K={k} not a multiple of 4"
    codes = torch.where(w_q < 0, 2, w_q.to(torch.int32)).to(torch.int32)
    codes = codes.reshape(k // 4, 4, n)
    packed = codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | (codes[:, 3] << 6)
    return packed.to(torch.uint8)


def unpack_ternary(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (K//4, N) -> int8 ternary (K, N)."""
    kq, n = packed.shape
    p = packed.to(torch.int32)
    parts = []
    for i in range(4):
        bits = (p >> (2 * i)) & 0x3
        parts.append(torch.where(bits == 1, 1, torch.where(bits == 2, -1, 0)))
    return torch.stack(parts, dim=1).reshape(kq * 4, n).to(torch.int8)


def quantize_and_pack(w: torch.Tensor) -> TernaryWeight:
    w_q, beta = ternary_quantize(w)
    return TernaryWeight(packed=pack_ternary(w_q), scale=beta)


def quantize_and_pack_stacked(w: torch.Tensor) -> TernaryWeight:
    """Layer-stacked (L, K, N) latent weights -> a stacked TernaryWeight,
    one absmean scale per layer (the JAX package's ``vmap(quantize_and_pack)``)."""
    parts = [quantize_and_pack(w[i]) for i in range(w.shape[0])]
    return TernaryWeight(torch.stack([p.packed for p in parts]),
                         torch.stack([p.scale for p in parts]))
