"""``DisaggEngine``: the two-pool serving engine.

It subclasses ``EngineCore``, so admission (the fair queue, SLO shedding,
the swap policies), chunked-prefill quanta, speculative decoding,
preemption, aborts and the async and HTTP front ends all work unchanged: the
engine is the router.  ``step()`` admits from the same queue, prefills on the
prefill pool through ``DisaggRunner`` and follows each request across the
pools (mid-prefill it holds a decode-pool slot and its pages but sits the
decode rounds out; its KV crosses the ``KVHandoffChannel``; once its last
segment is installed it joins the decode set).

Placement, as in the JAX package: a mesh whose leading axis is ``pod``
(``mesh``) is split by ``core.disagg.split_pod_meshes``, or a pair of pool
meshes is given (``prefill_mesh``, ``decode_mesh``; on each rank one of
them is its own pod's ``PodMesh``, the other the other pod's description);
``make_disagg_meshes`` builds the standard split of a world of ``2 * tp``
ranks.  On the split each rank is a process of one pool, with its slice of
the weights; every rank steps in lockstep (rank 0 admits) and a segment
crosses between the pods (``KVHandoffChannel``).  With no mesh each pool takes a
``torch.device``, and on one card both share it, the prefill pool on its
own CUDA stream and dispatch thread, the decode pool on the engine's
stream.  Two different devices raise (``core.disagg.pool_devices``): the
split across two cards in one process waits for a two-card machine.

Greedy and sampled streams equal the colocated ``EngineCore``'s on
{contiguous, paged} x {fp, int8, int4}, chunked prefill included, as in the
JAX package; on the split, those of the engine on one device (the mesh
programs' products sum over the ranks in another order where they are
not exact), speculative decoding and every swap policy included (rank 0
decides for every rank).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.disagg import pool_devices, split_pod_meshes
from repro_torch.serving.core import EngineCore
from repro_torch.serving.disagg.decode_pool import DisaggRunner
from repro_torch.serving.disagg.handoff import KVHandoffChannel
from repro_torch.serving.disagg.prefill_pool import PrefillPool


def make_disagg_meshes(*, tp: int = 1):
    """(prefill, decode): a (pod 2, model ``tp``) mesh over the world's
    ranks, pod-major, split into two ``tp``-wide tensor-parallel pools
    (``split_pod_meshes``).  The world must have ``2 * tp`` ranks; every
    rank calls it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    have = dist.get_world_size() if dist.is_initialized() else 1
    need = 2 * tp
    if have != need:
        raise ValueError(
            f"need {need} ranks for two {tp}-wide pools, have {have} (start them with "
            f"python -m torch.distributed.run --nproc-per-node {need})")
    return split_pod_meshes(make_mesh((2, tp), ("pod", "model")))


def _mesh_info(pool) -> dict:
    """A pool's devices and axes, as the JAX ``_mesh_info`` gives them."""
    return {"devices": int(pool.size), "axes": dict(pool.shape)}


class DisaggEngine(EngineCore):
    """``EngineCore`` over a prefill pool, a decode pool and the handoff
    channel between them."""

    runner_cls = DisaggRunner

    def __init__(self, cfg: ModelConfig, params, *, prefill_mesh=None, decode_mesh=None,
                 mesh=None, prefill_device=None, decode_device=None, device=None,
                 **engine_kwargs):
        if mesh is not None:
            if prefill_mesh is not None or decode_mesh is not None:
                raise ValueError("pass either mesh (a pod mesh to split) or an explicit "
                                 "prefill_mesh/decode_mesh pair, not both")
            prefill_mesh, decode_mesh = split_pod_meshes(mesh)
        if (prefill_mesh is None) != (decode_mesh is None):
            raise ValueError("prefill_mesh and decode_mesh go together")
        self._pools = None
        if prefill_mesh is not None:
            self._init_split(cfg, params, prefill_mesh, decode_mesh,
                             (prefill_device, decode_device, device), engine_kwargs)
            return
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

    def _init_split(self, cfg, params, prefill_mesh, decode_mesh, devices, engine_kwargs):
        """The pod split: this rank builds its pool only, on its slice."""
        from repro_torch.launch.mesh import PodMesh

        if any(d is not None for d in devices):
            raise ValueError("on a mesh each pool lives on its ranks' devices: pass no device")
        mine = next((m for m in (prefill_mesh, decode_mesh) if isinstance(m, PodMesh)), None)
        if mine is None:
            raise ValueError("neither mesh is this rank's pod (split_pod_meshes gives each rank "
                             "its own)")
        self._pod, self._role = mine, "prefill" if mine is prefill_mesh else "decode"
        self._pools = (prefill_mesh, decode_mesh)
        # the engine's mesh is the whole world: rank 0 admits, every rank
        # steps; the runner's is this rank's pod
        super().__init__(cfg, params, mesh=mine.parent, **engine_kwargs)
        r = self.runner
        self.handoff = KVHandoffChannel(mine, self._role)
        self.prefill_pool = None
        if self._role == "prefill":
            self.prefill_pool = PrefillPool(
                cfg, r.params, device=mine.device, max_len=r.max_len, mode=r.mode,
                cache_layout="paged" if r.paged is not None else "contiguous",
                block_size=r.block_size, kv_dtype=r.kv_dtype, prefill_chunk=r.prefill_chunk,
                mesh=mine)
        r.attach(self.prefill_pool, self.handoff)

    def _mesh_runner_options(self, mesh) -> dict:
        return {"mesh": self._pod, "role": self._role}

    def snapshot_sections(self) -> dict:
        """The ``disagg`` section of ``snapshot()``: the channel's counters
        and each pool's place: its devices and axes on the split (as the
        JAX engine's), its device on one."""
        if self._pools is not None:
            pools = {"prefill_pool": _mesh_info(self._pools[0]),
                     "decode_pool": _mesh_info(self._pools[1])}
        else:
            pools = {"prefill_pool": {"device": str(self.prefill_pool.device)},
                     "decode_pool": {"device": str(self.runner.device)}}
        return {"disagg": {"handoff": self.handoff.snapshot(), **pools}}
