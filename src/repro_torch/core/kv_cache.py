"""KV-cache slot manager for continuous batching, and the prefill-KV install.

The decode buffer is a fixed batch-leading (B_slots, L, Hkv, max_len, D)
allocation.  Prefilled requests are installed into free slots; per-slot
``lengths`` drive the masking inside the decode attention kernel, so slots
of different ages batch together.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.staging import StagedTensor
from repro_torch.layers import collectives as C
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


def heads_to_rows(kv, sl: int, pctx) -> Tuple[tuple, int]:
    """The swap on a mesh: one prompt's prefill KV (L, 1, Hkv / tp, S, D)
    of this rank's heads (a ``KVCache``) becomes this rank's rows [i * Sl,
    i * Sl + n) of every head (n = what of the prompt falls in them), i its
    index on the decode sequence axis of ``pctx`` (the decode rules), by
    one all-to-all over the model axis that carries K and V together.
    Each model rank gets a chunk of c = min(Sl, S) rows from each; rows
    past the prompt are zeros.  Returns (the rows, as ``kv``'s type; the
    bytes this rank sent)."""
    tp = pctx.axes.tp
    seq_ax = pctx.resolve(["kv_seq"])[0]
    seq_axes = seq_ax if isinstance(seq_ax, tuple) else (seq_ax,)
    if seq_axes[-1] != tp:
        raise NotImplementedError(f"the decode sequence axis {seq_ax} must end in {tp!r}")
    k = pctx.size(tp)
    i = pctx.index(seq_ax)
    base = i - pctx.index(tp)  # the sequence index of model rank 0 of this group
    both = torch.stack([kv.k, kv.v])  # (2, L, 1, Hkv / tp, S, D)
    s = both.shape[4]
    c = min(sl, s)
    send = both.new_zeros(both.shape[:4] + (k * c,) + both.shape[5:])
    for j in range(k):
        a = (base + j) * sl
        n = max(0, min(s - a, c))
        if n:
            send[:, :, :, :, j * c:j * c + n] = both[:, :, :, :, a:a + n]
    recv = C.all_to_all(send, pctx.mesh.group(tp), split_dim=4, cat_dim=3)
    n_mine = max(0, min(s - i * sl, c))
    return (type(kv)(recv[0, :, :, :, :n_mine], recv[1, :, :, :, :n_mine]),
            send.numel() * send.element_size() * (k - 1) // k)


@dataclasses.dataclass(eq=False)
class MeshInstall:
    """What a family's ``install_prefill`` does on a mesh, one rank's part
    of it: a prefill of the prompts ``slots`` (prompt i into slot
    ``slots[i]`` of the whole batch of ``n_slots``), run under the
    ``prefill`` rules, into this rank's block of the decode cache, laid
    out by the ``decode`` rules.  ``count(nbytes)`` is told what each
    collective sent."""

    num_kv_heads: int
    prefill: object  # layers.sharding.PartitionCtx
    decode: object
    n_slots: int
    slots: Sequence[int]
    count: Callable[[int], None] = lambda nbytes: None

    def rows(self) -> List[Tuple[int, int]]:
        """[(prompt row of the prefill's local rows, slot of this rank's
        block)]: the prompts this rank installs, on the data rank whose
        rows of the batch hold their slots.  A prefill that split its
        prompts over data must have prefilled each where its slot lies."""
        b = len(self.slots)
        plo, phi = self.prefill.local_range(b, "batch") if self.prefill.mesh else (0, b)
        lo, hi = self.decode.local_range(self.n_slots, "batch")
        out = []
        for i in range(plo, phi):
            if lo <= self.slots[i] < hi:
                out.append((i - plo, self.slots[i] - lo))
            elif phi - plo < b:
                raise ValueError(f"prompt {i} was prefilled on another data rank than the one "
                                 f"whose rows hold slot {self.slots[i]}")
        return out

    def kv(self, kv, sl: int):
        """One prompt's prefill KV (L, 1, Hkv', S, D) as this rank's rows of
        the sequence block of ``sl`` rows it holds: exchanged from heads to
        rows (``heads_to_rows``) where the prefill split the heads, else
        cut from the whole heads every rank computed."""
        if kv.k.shape[2] < self.num_kv_heads:
            rows, nbytes = heads_to_rows(kv, sl, self.decode)
            self.count(nbytes)
            return rows
        ax = self.decode.resolve(["kv_seq"])[0]
        a = self.decode.index(ax) * sl
        n = max(0, min(kv.k.shape[3] - a, sl))
        return type(kv)(kv.k[:, :, :, a:a + n], kv.v[:, :, :, a:a + n])

    def state(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """A prefill state whose ``dim`` the prefill split over the model
        axis, gathered whole there where the decode cache holds ``n`` rows
        of it (the decode rules keep it whole); as it is where the cache
        holds the same split."""
        if t.shape[dim] == n:
            return t
        self.count(t.numel() * t.element_size())
        return C.all_gather(t, self.prefill.mesh.group(self.prefill.axes.tp), dim=dim)
