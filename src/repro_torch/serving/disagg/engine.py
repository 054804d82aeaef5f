"""``DisaggEngine``: the two-pool serving engine.

It subclasses ``EngineCore``, so admission (the fair queue, SLO shedding,
the swap policies), chunked-prefill quanta, speculative decoding,
preemption, aborts and the async and HTTP front ends all work unchanged: the
engine is the router.  ``step()`` admits from the same queue, prefills on the
prefill pool through ``DisaggRunner`` and follows each request across the
pools (mid-prefill it holds a decode-pool slot and its pages but sits the
decode rounds out; its KV crosses the ``KVHandoffChannel``; once its last
segment is installed it joins the decode set).

Devices: each pool takes a ``torch.device``, and on one card both share it,
the prefill pool on its own CUDA stream and dispatch thread, the decode pool
on the engine's stream.  Two different devices raise
(``core.disagg.pool_devices``): the split across two cards waits for a
two-card machine.

Greedy and sampled streams equal the colocated ``EngineCore``'s on
{contiguous, paged} x {fp, int8, int4}, chunked prefill included, as in the
JAX package.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.disagg import pool_devices
from repro_torch.serving.core import EngineCore
from repro_torch.serving.disagg.decode_pool import DisaggRunner
from repro_torch.serving.disagg.handoff import KVHandoffChannel
from repro_torch.serving.disagg.prefill_pool import PrefillPool


class DisaggEngine(EngineCore):
    """``EngineCore`` over a prefill pool, a decode pool and the handoff
    channel between them."""

    runner_cls = DisaggRunner

    def __init__(self, cfg: ModelConfig, params, *, prefill_device=None, decode_device=None,
                 device=None, **engine_kwargs):
        if device is not None and decode_device is not None:
            raise ValueError("pass device (both pools) or decode_device, not both")
        prefill, decode = pool_devices(prefill_device, device if device is not None
                                       else decode_device)
        # the base engine is the decode pool: the runner's cache, decode and
        # verify programs, slots and replay live on it
        super().__init__(cfg, params, device=decode, **engine_kwargs)
        r = self.runner
        self.handoff = KVHandoffChannel()
        self.prefill_pool = PrefillPool(
            cfg, params, device=prefill, max_len=r.max_len, mode=r.mode,
            cache_layout="paged" if r.paged is not None else "contiguous",
            block_size=r.block_size, kv_dtype=r.kv_dtype, prefill_chunk=r.prefill_chunk)
        r.attach(self.prefill_pool, self.handoff)

    def snapshot_sections(self) -> dict:
        """The ``disagg`` section of ``snapshot()``: the channel's counters
        and each pool's device."""
        return {"disagg": {
            "handoff": self.handoff.snapshot(),
            "prefill_pool": {"device": str(self.prefill_pool.device)},
            "decode_pool": {"device": str(self.runner.device)},
        }}
