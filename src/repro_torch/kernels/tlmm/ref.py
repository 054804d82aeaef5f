"""Plain PyTorch versions of the TLMM kernel (``csrc/tlmm.cu``).

Two oracles:

* ``tlmm_reference`` — unpack and multiply; the plain version the kernel is
  held to bit for bit.
* ``tlmm_lut_reference`` — the paper's own algorithm (its contribution C2):
  activations in groups of 4, the 3^4 = 81 signed sums of each group
  precomputed into a table, each group of 4 ternary weights re-encoded as a
  base-3 index into it, and the looked-up sums accumulated.  Exactly the
  direct product in integer arithmetic; an oracle for the CPU, never on
  the serving path.
"""
from __future__ import annotations

import torch

from repro_torch.quant.ternary import unpack_ternary

TL_GROUP = 4
_POW3 = (1, 3, 9, 27)


def tlmm_reference(x_q: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 @ unpack(w_packed) -> (M,N) f32, scaled per row by ``scale``
    (M,1).  The product runs in f32, which is exact integer arithmetic while
    127*K < 2**24 (TF32 is off, see ``repro_torch``), so the one rounding is
    the final scale — the same as the kernel's int32 path."""
    k = x_q.shape[1]
    assert 127 * k < 2**24, f"K={k}: the f32 product is no longer exact"
    w = unpack_ternary(w_packed).float()
    acc = x_q.float() @ w
    return acc * scale


def ternary_group_codes(w_q: torch.Tensor) -> torch.Tensor:
    """int8 ternary (K, N) -> base-3 group codes (K/4, N) in [0, 81): digit
    i of a code is weight 4j+i plus 1."""
    k, n = w_q.shape
    digits = (w_q.to(torch.int64) + 1).reshape(k // TL_GROUP, TL_GROUP, n)
    pow3 = torch.tensor(_POW3, dtype=torch.int64)
    return (digits * pow3[None, :, None]).sum(dim=1)


def group_luts(x_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 -> the tables (M, K/4, 81) int64: entry c of group j is
    sum_i (digit_i(c) - 1) * x[4j + i], the 81 ternary combinations of the
    group's four activations."""
    m, k = x_q.shape
    codes = torch.arange(3 ** TL_GROUP, dtype=torch.int64)
    digits = torch.stack([(codes // p) % 3 - 1 for p in _POW3], dim=1)  # (81, 4)
    groups = x_q.to(torch.int64).reshape(m, k // TL_GROUP, TL_GROUP)
    return torch.einsum("mgi,ci->mgc", groups, digits)


def tlmm_lut_reference(x_q: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The paper's index -> lookup -> accumulate TLMM: (M,K) int8 x_q and
    uint8 (K/4,N) packed weights -> (M,N) f32, scaled per row by ``scale``
    (M,1).  Bit-equal to ``tlmm_reference``: the sum is exact in int64 and
    the scale is the one rounding."""
    x_q, w_packed, scale = x_q.cpu(), w_packed.cpu(), scale.cpu()
    codes = ternary_group_codes(unpack_ternary(w_packed))  # (K/4, N)
    luts = group_luts(x_q)  # (M, K/4, 81)
    m, groups = luts.shape[:2]
    picked = torch.gather(luts, 2, codes[None].expand(m, groups, codes.shape[1]))
    return picked.sum(dim=1).to(torch.float32) * scale.to(torch.float32)
