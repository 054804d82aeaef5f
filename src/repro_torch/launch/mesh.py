"""Meshes of processes: one process a rank, each holding its own shards.

The JAX package drives a mesh of devices from one controller.  Here every
rank is a process that runs the same program on its local tensors and
calls named collectives on the groups of the mesh's axes.  Start the ranks
with ``python -m torch.distributed.run --nproc-per-node N ...`` (or
``torch.multiprocessing.spawn``); each joins with ``join_process_group``
and builds its view of the mesh with ``make_host_mesh``.

Rank r lives on ``cuda:(r % torch.cuda.device_count())``: on a machine with
one card every rank shares ``cuda:0``.  The backend is the caller's to
name, never guessed: NCCL runs the native collectives and lets the decode
programs be captured as CUDA graphs with their collectives inside; gloo
runs the portable ones (``layers.collectives``), which a graph cannot
capture, so its programs run eagerly.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_JOINED: Dict[str, torch.device] = {}  # "device": the device join_process_group chose


def rank_device(rank: int, device_type: str = "cuda") -> torch.device:
    """Where rank ``rank`` lives: ``cuda:(rank % device_count)``, or the
    CPU when asked for."""
    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a rank on CUDA needs a card and none is available")
    return torch.device("cuda", rank % n)


def join_process_group(backend: str, *, device_type: str = "cuda",
                       init_method: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = 300.0) -> torch.device:
    """Join the world as the launcher set it up and return this rank's
    device.  ``rank`` and ``world_size`` default to the launcher's
    ``RANK`` and ``WORLD_SIZE``; ``init_method`` to its ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``), or pass ``file:///path`` for a store in a
    file, which no two runs share.  ``backend`` is "nccl" or "gloo"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs CUDA ranks")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _JOINED["device"] = device
    return device


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh of processes: the axes' names and sizes,
    this rank's coordinate on each, and each axis's process group (the
    ranks that differ from this one only along that axis).  The groups
    come from a ``DeviceMesh``; collectives on them are explicit calls
    (``layers.collectives``), never ``DTensor`` dispatch."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    # the whole world over gloo, for the host's own messages (rank 0's
    # admissions): CPU tensors, so no step waits on a card for them
    host_group: object = None
    # this rank's group of each tuple of axes asked for (``group``)
    tuple_groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return int(self.device_mesh.mesh.numel())

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def coordinate(self, axis: str) -> int:
        return self.device_mesh.get_coordinate()[self.axis_names.index(axis)]

    def group(self, axis):
        """The process group of mesh axis ``axis``.  A tuple of axes (in the
        mesh's order) names the ranks that differ from this one only along
        those axes, ordered major to minor as JAX orders them: every axis is
        the whole world, ``("pod", "data")`` the multi-pod mesh's batch
        group.  A tuple's groups are built once, on first use, by every
        rank together (the same call on every rank, as all collectives)."""
        if isinstance(axis, tuple):
            if len(axis) == 1:
                axis = axis[0]
            else:
                if [a for a in self.axis_names if a in axis] != list(axis):
                    raise ValueError(f"axes {axis} out of the mesh's order {self.axis_names}")
                if len(axis) == len(self.axis_names):
                    return dist.group.WORLD
                return self._tuple_group(axis)
        return self.device_mesh.get_group(axis)

    def _tuple_group(self, axes: Tuple[str, ...]):
        groups = self.tuple_groups
        if axes not in groups:
            names = self.axis_names
            ids = self.device_mesh.mesh  # (sizes...) of global ranks
            rest = [names.index(a) for a in names if a not in axes]
            rows = ids.permute(*rest, *[names.index(a) for a in axes]).reshape(
                -1, math.prod(self.shape[a] for a in axes))
            mine = None
            for row in rows.tolist():  # every rank makes every group, in one order
                # ranks ascend along axes taken in the mesh's order, so the
                # group's (sorted) order is JAX's major-to-minor order
                g = dist.new_group(ranks=row, backend=self.backend)
                if self.rank in row:
                    mine = g
            groups[axes] = mine
        return groups[axes]

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @property
    def capturable(self) -> bool:
        """Whether programs with collectives inside may be captured as CUDA
        graphs: NCCL's collectives can be, gloo's cannot.  Decided here,
        by the backend, never by a failed capture."""
        return self.backend == "nccl"

    def describe(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        coords = ", ".join(f"{a}={self.coordinate(a)}" for a in self.axis_names)
        graphs = "graphs captured" if self.capturable else "programs eager"
        return (f"rank {self.rank} of {self.size} on {self.device} ({self.backend}; mesh {axes}; "
                f"at {coords}; {graphs})")


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("join the process group first (join_process_group)")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {dict(zip(names, shape))} needs {n} ranks; the world has "
                         f"{world}")
    device = _JOINED.get("device") or rank_device(dist.get_rank())
    backend = dist.get_backend()
    dm = init_device_mesh(device.type, shape, mesh_dim_names=names,
                          backend_override={name: backend for name in names})
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dm, device, host)


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the world's ranks, row-major (``jax.make_mesh``'s
    order): it must cover the world."""
    return _mesh(tuple(shape), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production meshes: (data 16, model 16), or (pod
    2, data 16, model 16).  Raises unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the world's ranks, clamped as the JAX
    ``make_host_mesh`` clamps to the devices there are; the clamped mesh
    must cover the world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh((data, model), ("data", "model"))


def _probe_rank(rank: int, world: int, store: str, backend: str, device_type: str, out: str):
    """One rank of ``probe``: each collective tried once on this rank's
    device, the ones that raised recorded with their error."""
    import json

    device = join_process_group(backend, device_type=device_type, init_method=f"file://{store}",
                                rank=rank, world_size=world)
    x = torch.full((4, 2), float(rank + 1), device=device)
    tries = {
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "broadcast_object_list": lambda: dist.broadcast_object_list([{"a": 1}], src=0),
    }
    found = {}
    for name, fn in tries.items():
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            found[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe reports what the backend refuses
            found[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(found, f)
    dist.barrier()
    dist.destroy_process_group()


def probe(backend: str = "gloo", world: int = 2, device_type: str = "cuda") -> dict:
    """Which collectives ``backend`` carries on ``device_type`` tensors: a
    world of ``world`` spawned ranks tries each once.  Returns {collective:
    "ok" or the error}."""
    import json
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "found.json")
        mp.spawn(_probe_rank, args=(world, store, backend, device_type, out), nprocs=world)
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="which collectives a backend carries")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    for name, how in probe(a.backend, a.world, a.device).items():
        print(f"{a.backend} on {a.device} tensors, {a.world} ranks: {name}: {how}")
