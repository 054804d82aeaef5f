"""Disaggregated prefill and decode serving: two phase-specialized pools.

The paper time-multiplexes one fabric between a compute-bound prefill engine
and a bandwidth-bound decode engine; the same asymmetry supports spatial
disaggregation.  This package is that runtime: a ``PrefillPool`` (the
prefill programs on their own CUDA stream and dispatch thread), the decode
pool (``DisaggRunner``: the base ``ModelRunner`` on the engine's stream), a
``KVHandoffChannel`` carrying finished prefill KV across (chunks shipped as
they finish, installs deferred), and ``DisaggEngine``, the ``EngineCore``
subclass routing requests across the pools with the colocated engine's
tokens.  On one card both pools share the device; on the pod split of a
mesh each pool is its own ranks.
"""
from repro_torch.serving.disagg.decode_pool import DisaggRunner
from repro_torch.serving.disagg.engine import DisaggEngine, make_disagg_meshes
from repro_torch.serving.disagg.handoff import KVHandoffChannel, Segment
from repro_torch.serving.disagg.prefill_pool import PrefillPool

__all__ = ["DisaggEngine", "DisaggRunner", "KVHandoffChannel", "PrefillPool", "Segment",
           "make_disagg_meshes"]
