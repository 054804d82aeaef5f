"""Spatial prefill/decode disaggregation: the pools' devices and the cost
model.

The paper time-multiplexes one fabric between the phases.  The same
asymmetry supports spatial disaggregation: one pool keeps the prefill
programs, another the decode programs, and the swap becomes a KV transfer
between them.  The JAX package splits a TPU mesh along a pod axis
(``split_pod_meshes``) and moves KV with a resharding ``device_put``
(``kv_transfer_program``); neither has a one-card counterpart.  Here a pool
takes a ``torch.device``, and on one card both pools share it, each on its
own CUDA stream (``serving.disagg``).

``DisaggCostModel`` is the JAX package's analytic comparison of the temporal
swap with the spatial transfer, on the port's ``ChipSpec``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.common.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.roofline import kv_bytes_per_ctx_token


def pool_devices(prefill_device=None, decode_device=None) -> Tuple[torch.device, torch.device]:
    """(prefill device, decode device): the decode pool's device (CUDA unless
    the caller asks for the CPU), and the prefill pool's, the same one when
    not given.  Two different devices raise: the split across two cards
    waits for a two-card machine (ROADMAP A.8)."""
    decode = resolve_device(decode_device)
    prefill = decode if prefill_device is None else resolve_device(prefill_device)
    if prefill.type == "cuda" and prefill.index is None:
        prefill = torch.device("cuda", torch.cuda.current_device())
    if decode.type == "cuda" and decode.index is None:
        decode = torch.device("cuda", torch.cuda.current_device())
    if prefill != decode:
        raise NotImplementedError(
            f"prefill pool on {prefill}, decode pool on {decode}: the port runs both pools on "
            "one device, each on its own stream; the split across two cards is ROADMAP A.8")
    return prefill, decode


@dataclasses.dataclass
class DisaggCostModel:
    """Analytic comparison of the temporal swap with spatial disaggregation."""

    cfg: ModelConfig
    chips_per_pod: int
    chip: ChipSpec = DEFAULT_CHIP
    # storage precision of the serving KV cache ("fp" | "int8" | "int4"): a
    # quantized cache shrinks the relayout and the transfer alike (payload and
    # scale planes both move)
    kv_dtype: str = "fp"

    def kv_bytes(self, batch: int, seq: int) -> float:
        c = self.cfg
        if getattr(c, "attention_free", False):  # recurrent state instead of KV
            hd = c.d_model // c.num_heads
            return c.num_layers * batch * c.num_heads * (hd * hd + hd) * 4
        return kv_bytes_per_ctx_token(c, self.kv_dtype) * batch * seq

    def temporal_swap_latency(self, batch: int, seq: int) -> float:
        """The relayout: one read and one write of the KV over device
        memory, and the resharding over the interconnect (each byte once)."""
        b = self.kv_bytes(batch, seq) / self.chips_per_pod
        t_hbm = 2 * b / self.chip.hbm_bw
        t_ici = b / (self.chip.ici_bw_per_link * self.chip.ici_links)
        return max(t_hbm, t_ici)

    def spatial_transfer_latency(self, batch: int, seq: int) -> float:
        """The KV moved between pools over the host link (a chip's share,
        every link at once)."""
        b = self.kv_bytes(batch, seq) / self.chips_per_pod
        return b / self.chip.dcn_bw

    def better_mode(self, batch: int, seq: int, decode_steps: int) -> str:
        """Spatial when prefill and decode pipeline across requests and the
        transfer hides under a decode batch; temporal for single bursty
        requests (the paper's edge setting)."""
        t_sp = self.spatial_transfer_latency(batch, seq)
        t_tm = self.temporal_swap_latency(batch, seq)
        return "spatial" if t_sp < t_tm * 4 and decode_steps > 64 else "temporal"
