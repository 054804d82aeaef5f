"""KV-cache slot manager for continuous batching, and the prefill-KV install.

The decode buffer is a fixed batch-leading (B_slots, L, Hkv, max_len, D)
allocation.  Prefilled requests are installed into free slots; per-slot
``lengths`` drive the masking inside the decode attention kernel, so slots
of different ages batch together.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.staging import StagedTensor
from repro_torch.quant.kv_quant import QuantKV, infer_kv_dtype, quantize_kv


@dataclasses.dataclass
class SlotState:
    request_id: Optional[str] = None
    length: int = 0
    generated: int = 0


class KVSlotManager:
    """The slots' host state, and their lengths in a static device tensor
    (``lengths_array``) written in place, so a captured decode program can
    read them from one address every round."""

    def __init__(self, n_slots: int, device):
        self.slots: List[SlotState] = [SlotState() for _ in range(n_slots)]
        self._lengths = StagedTensor((n_slots,), torch.int32, device)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request_id is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request_id is not None]

    def assign(self, request_id: str, length: int) -> int:
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free KV slots")
        i = free[0]
        self.slots[i] = SlotState(request_id, length)
        return i

    def release(self, slot: int) -> None:
        self.slots[slot] = SlotState()

    def lengths_array(self, overrides: Optional[Dict[int, int]] = None) -> torch.Tensor:
        """(n_slots,) int32: every slot's length, or ``overrides[slot]``
        where given, written into the static device tensor, which is
        returned."""
        arr = np.array([s.length for s in self.slots], np.int32)
        for slot, n in (overrides or {}).items():
            arr[slot] = n
        return self._lengths.upload(arr)


def insert_prefill_kv(cache, prefill_kv, slot: int):
    """Install a prefilled request's KV into cache slot ``slot``, in place.

    cache leaves: (B_slots, L, Hkv, max_len, D), batch-leading, in the cache
    dtype (bf16 by default) or ``QuantKV``; prefill_kv leaves: (L, 1, Hkv,
    S, D) f32 in prefill layout, S the prompt bucket.  The layer-major ->
    batch-leading move, the cast to the cache dtype (or the quantization,
    from f32) and the padding of rows [S, max_len) happen in one pass per
    leaf — the JAX package's relayout (pad + moveaxis, quantize on write)
    followed by its slot update.  Padding rows hold what the zero-padded
    rows quantize to: payload 0 and scale 1.0."""
    for buf, new in zip(cache, prefill_kv):
        s = new.shape[-2]
        if isinstance(buf, QuantKV):
            payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
            _install(buf.q, payload, slot, s, 0)
            _install(buf.scale, scale, slot, s, 1.0)
        else:
            _install(buf, new, slot, s, 0)
    return cache


def _install(buf: torch.Tensor, new: torch.Tensor, slot: int, s: int, pad) -> None:
    buf[slot, :, :, :s].copy_(new[:, 0])
    buf[slot, :, :, s:].fill_(pad)


def relay_prefill_kv(prefill_kv, max_len: int, kv_dtype: str):
    """The prefill half of ``insert_prefill_kv``, for the disaggregated
    pools: a prompt's KV (L, 1, Hkv, S, D) f32 in prefill layout becomes
    one decode-layout segment (1, L, Hkv, max_len, D), rows [S, max_len)
    padded — f32 values under "fp" (the cast to the cache dtype happens on
    install), a ``QuantKV`` quantized on write otherwise (padding: payload
    0, scale 1.0).  What the JAX package's relayout program ships."""
    out = []
    for new in prefill_kv:
        n_layers, _, hkv, s, d = new.shape
        if kv_dtype == "fp":
            buf = new.new_zeros((1, n_layers, hkv, max_len, d))
            _install(buf, new, 0, s, 0)
            out.append(buf)
            continue
        payload, scale = quantize_kv(new, kv_dtype)
        q = payload.new_zeros((1, n_layers, hkv, max_len, payload.shape[-1]))
        sc = scale.new_ones((1, n_layers, hkv, max_len))
        _install(q, payload, 0, s, 0)
        _install(sc, scale, 0, s, 1.0)
        out.append(QuantKV(q, sc))
    return type(prefill_kv)(*out)


def install_relayed_kv(cache, relayed, slot: int):
    """The decode half: copy a relayed segment (``relay_prefill_kv``) into
    cache slot ``slot`` in place (cast to the cache dtype under "fp"), which
    stores the bytes ``insert_prefill_kv`` stores, padding rows included."""
    for buf, new in zip(cache, relayed):
        if isinstance(buf, QuantKV):
            buf.q[slot].copy_(new.q[0])
            buf.scale[slot].copy_(new.scale[0])
        else:
            buf[slot].copy_(new[0])
    return cache
