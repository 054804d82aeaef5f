"""Spatial prefill/decode disaggregation: the pools' devices and meshes,
the KV transfer between them, and the cost model.

The paper time-multiplexes one fabric between the phases.  The same
asymmetry supports spatial disaggregation: one pool keeps the prefill
programs, another the decode programs, and the swap becomes a KV transfer
between them.  The JAX package splits a TPU mesh along a pod axis
(``split_pod_meshes``) and moves KV with a resharding ``device_put``
(``kv_transfer_program``).  Here a mesh is one process a rank: the split
gives each rank its own pod's mesh (``launch.mesh.PodMesh``) and the other
pod's description, and a segment crosses over the pod axis's group, one
broadcast from the prefill rank to the decode rank at the same coordinates
(``kv_transfer``).  Without a mesh a pool takes a ``torch.device``, and on
one card both pools share it, each on its own CUDA stream
(``serving.disagg``).

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
from repro_torch.core.phase_engine import _rebuild, tensor_leaves
from repro_torch.core.roofline import kv_bytes_per_ctx_token
from repro_torch.layers import collectives as C


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


def split_pod_meshes(mesh) -> Tuple[object, object]:
    """(prefill, decode) from a (pod, ...) mesh of processes: pod 0 prefills,
    pod 1 decodes, as in the JAX package.  The one this rank belongs to is
    its pod's mesh (``launch.mesh.PodMesh``: the other axes, their groups,
    the pod axis's group for the transfer); the other is that pod's
    description (``launch.mesh.Pod``).  Every rank must call it together
    (it builds the pools' groups).  A rank of a pod past the first two has
    no pool and raises, as do pools with a data axis wider than 1: the
    split puts a prompt's KV on the decode rank at the prefill rank's
    coordinates, and a data row of its own is ROADMAP A.13.9."""
    from repro_torch.launch.mesh import pod_submesh, pods

    if "pod" not in mesh.axis_names:
        raise ValueError("spatial disaggregation needs a pod axis")
    every = pods(mesh)
    if len(every) < 2:
        raise ValueError("need >= 2 pods")
    if mesh.shape.get("data", 1) > 1:
        raise NotImplementedError(f"pools of data {mesh.shape['data']} on the pod split: a pool "
                                  "with data > 1 is ROADMAP A.13.9")
    mine = mesh.coordinate("pod")
    if mine > 1:
        raise ValueError(f"rank {mesh.rank} is in pod {mine}: the split's pools are pods 0 and 1")
    sub = pod_submesh(mesh)
    return (sub, every[1]) if mine == 0 else (every[0], sub)


def kv_transfer(tree, group, *, src: int, like=None, device=None):
    """Move a KV segment (a tree of tensors: ``KVCache``, ``QuantKV``
    leaves, logits) across the pods, the counterpart of the JAX package's
    ``kv_transfer_program``, over ``group`` (the pod axis's) from global
    rank ``src``: every leaf's bytes in one buffer (each leaf from a
    16-byte boundary), one broadcast.  The sender passes ``tree``; a
    receiver passes ``like``, a tree of the segment's structure, shapes and
    dtypes (``meta`` tensors will do: both sides know them from the state
    they hold in lockstep), and its ``device``, and gets the segment.
    Returns (segment, bytes moved)."""
    import torch.distributed as dist

    sending = tree is not None
    leaves = tensor_leaves(tree if sending else like)
    sizes = [t.numel() * t.element_size() for t in leaves]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 16) * 16)
    dev = leaves[0].device if sending else device
    if sending:
        buf = torch.zeros((starts[-1],), dtype=torch.uint8, device=dev)
        for t, at, n in zip(leaves, starts, sizes):
            buf[at:at + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    else:
        buf = torch.empty((starts[-1],), dtype=torch.uint8, device=dev)
    C.broadcast(buf, group, src=dist.get_group_rank(group, src))
    if sending:
        return tree, buf.numel()
    out = [buf[at:at + n].view(t.dtype).reshape(t.shape)
           for t, at, n in zip(leaves, starts, sizes)]
    return _rebuild(like, iter(out)), buf.numel()


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
