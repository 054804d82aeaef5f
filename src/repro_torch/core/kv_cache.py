"""KV-cache slot manager for continuous batching, and the prefill-KV install.

The decode buffer is a fixed batch-leading (B_slots, L, Hkv, max_len, D)
allocation.  Prefilled requests are installed into free slots; per-slot
``lengths`` drive the masking inside the decode attention kernel, so slots
of different ages batch together.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class SlotState:
    request_id: Optional[str] = None
    length: int = 0
    generated: int = 0


class KVSlotManager:
    def __init__(self, n_slots: int):
        self.slots: List[SlotState] = [SlotState() for _ in range(n_slots)]

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

    def lengths_array(self, device=None) -> torch.Tensor:
        return torch.tensor([s.length for s in self.slots], dtype=torch.int32, device=device)


def insert_prefill_kv(cache, prefill_kv, slot: int):
    """Install a prefilled request's KV into cache slot ``slot``, in place.

    cache leaves: (B_slots, L, Hkv, max_len, D), batch-leading, in the cache
    dtype (bf16 by default); prefill_kv leaves: (L, 1, Hkv, S, D) f32 in
    prefill layout, S the prompt bucket.  The layer-major
    -> batch-leading move, the cast to the cache dtype and the zero padding
    of rows [S, max_len) happen in one pass per leaf — the JAX package's
    relayout (pad + moveaxis) followed by its slot update."""
    for buf, new in zip(cache, prefill_kv):
        s = new.shape[-2]
        buf[slot, :, :, :s].copy_(new[:, 0])
        buf[slot, :, :, s:].zero_()
    return cache
