"""Logical-axis sharding: the JAX package's rule tables, for a mesh of
processes.

Model code names the logical dims of a tensor; a ``PartitionCtx`` resolves
them to mesh axes through a rules table.  In the JAX package the result is
a sharding annotation that the compiler acts on.  Here every rank runs the
same program on its local shards, so ``PartitionCtx.shard`` is where a
local tensor moves from one placement to another: an all-gather where a
dim stops being sharded, a local slice where it starts, an all-to-all where
one dim hands its axis to another (``layers.collectives``).  With no mesh
every call is a no-op, so the same model code runs anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import torch

from repro_torch.layers import collectives as C

Axis = Union[None, str, tuple]


class PartitionSpec(tuple):
    """One mesh axis (or a tuple of them, or None) a dim: the counterpart
    of ``jax.sharding.PartitionSpec``, a tuple that compares equal to it."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# The JAX package's rule tables.  "dp" is data-parallel (('pod','data') on
# the multi-pod mesh), "tp" is tensor-parallel ('model'), "fsdp" the
# param-sharding axis.
TRAIN_RULES: dict = {
    "batch": "__dp__",
    "seq": None,
    "embed": None,  # activations keep embed replicated across tp
    "heads": "__tp__",
    "kv_heads": "__tp__",
    "head_dim": None,
    "ffn": "__tp__",
    "vocab": "__tp__",
    "experts": None,
    "expert_ffn": "__tp__",
    "layers": None,
    # parameter logical axes
    "param_embed": "__fsdp__",  # FSDP: shard the big dim of every weight
    "param_ffn": "__tp__",
    "param_heads": "__tp__",
    "param_vocab": "__tp__",
    "kv_seq": None,
    "state": None,
}

PREFILL_RULES = dict(
    TRAIN_RULES,
    param_embed=None,  # inference: weights replicated over dp, sharded over tp
)

# Decode: batch over data; the KV cache *sequence* dim over the model axis
# (each model rank walks its own rows and the ranks merge their softmax
# partials), the heads replicated: the query is one token.
DECODE_RULES = dict(
    PREFILL_RULES,
    batch="__dp__",
    kv_seq="__tp__",
    heads=None,
    kv_heads=None,
)

# long-context decode (global_batch=1): batch can't shard, so the KV/state
# sequence dim takes *every* mesh axis and the whole mesh walks one cache.
LONG_DECODE_RULES = dict(DECODE_RULES, batch=None, kv_seq="__dp_tp__", state="__tp__")


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Axis = "data"  # ('pod','data') on the multi-pod mesh
    tp: Axis = "model"
    fsdp: Axis = "data"


def _axes_of(ax: Axis) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


@dataclasses.dataclass(frozen=True)
class PartitionCtx:
    """The rules one phase program runs under, on one rank's ``mesh``
    (``launch.mesh.Mesh``; None: no mesh, every call a no-op)."""

    mesh: Optional[object] = None
    axes: MeshAxes = dataclasses.field(default_factory=MeshAxes)
    rules: Mapping[str, Axis] = dataclasses.field(default_factory=lambda: dict(TRAIN_RULES))

    def resolve(self, logical: Sequence[Optional[str]]) -> PartitionSpec:
        out = []
        for name in logical:
            ax = self.rules.get(name) if name else None
            if ax == "__dp__":
                ax = self.axes.dp
            elif ax == "__tp__":
                ax = self.axes.tp
            elif ax == "__fsdp__":
                ax = self.axes.fsdp
            elif ax == "__dp_tp__":
                dp = self.axes.dp if isinstance(self.axes.dp, tuple) else (self.axes.dp,)
                tp = self.axes.tp if isinstance(self.axes.tp, tuple) else (self.axes.tp,)
                ax = tuple(a for a in dp + tp if a)
            out.append(ax)
        return P(*out)

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        ax = self.axes.tp
        return self.mesh.shape[ax] if isinstance(ax, str) else 1

    def with_rules(self, rules: Mapping[str, Axis]) -> "PartitionCtx":
        return dataclasses.replace(self, rules=rules)

    @property
    def fsdp_axis(self) -> Axis:
        """The axis the rules shard every weight's d_model dim over (the
        train rules' FSDP), or None: the serving rules keep the weights
        whole over data."""
        if self.mesh is None or self.rules.get("param_embed") != "__fsdp__":
            return None
        return self.axes.fsdp

    # ------------------------------------------------ one rank's shards --

    def size(self, ax: Axis) -> int:
        """Ranks along ``ax`` (a product over a tuple of axes; 1 for None)."""
        n = 1
        for a in _axes_of(ax):
            n *= self.mesh.shape[a] if self.mesh is not None else 1
        return n

    def index(self, ax: Axis) -> int:
        """This rank's position along ``ax``, the first axis major."""
        i = 0
        for a in _axes_of(ax):
            i = i * self.mesh.shape[a] + self.mesh.coordinate(a)
        return i

    def spec(self, shape: Sequence[int], *logical: Optional[str]) -> PartitionSpec:
        """The resolved spec of a tensor of global ``shape``, each axis
        that does not divide its dim dropped (``sanitize_spec``)."""
        if self.mesh is None:
            return P(*(None,) * len(shape))
        return sanitize_spec(self.resolve(logical), shape, self.mesh)

    def local_range(self, n: int, name: Optional[str]) -> tuple:
        """[lo, hi) of this rank's rows of a dim of ``n`` named ``name``
        (the whole dim when its axis is None or does not divide ``n``)."""
        ax = self.spec((n,), name)[0]
        k = self.size(ax)
        per = n // k
        lo = self.index(ax) * per
        return lo, lo + per

    def axis_slice(self, x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
        """This rank's 1/k of ``x`` along ``dim``, k the ranks along mesh
        axis ``ax``, whatever the rules say of the dim."""
        k = self.size(ax)
        per = x.shape[dim] // k
        return x.narrow(dim, self.index(ax) * per, per)

    def shard(self, x: torch.Tensor, src: Sequence[Optional[str]],
              dst: Sequence[Optional[str]], shape: Sequence[int]) -> torch.Tensor:
        """Move the local tensor ``x`` of a global ``shape`` from the
        placement of logical dims ``src`` to that of ``dst`` (both resolved
        under these rules and sanitized against ``shape``).  Each dim whose
        axis goes away is all-gathered; each whose axis appears is sliced
        locally; an axis that moves from one dim to another is one
        all-to-all.  No mesh: ``x`` unchanged."""
        if self.mesh is None:
            return x
        a, b = self.spec(shape, *src), self.spec(shape, *dst)
        moves = {}
        for d, (fa, fb) in enumerate(zip(a, b)):
            if fa == fb:
                continue
            for ax in _axes_of(fa):
                if ax not in _axes_of(fb):
                    moves.setdefault(ax, [None, None])[0] = d
            for ax in _axes_of(fb):
                if ax not in _axes_of(fa):
                    moves.setdefault(ax, [None, None])[1] = d
        for ax, (d_from, d_to) in moves.items():
            group = self.mesh.group(ax)
            if d_from is not None and d_to is not None:
                x = C.all_to_all(x, group, split_dim=d_to, cat_dim=d_from)
            elif d_from is not None:
                x = C.all_gather(x, group, dim=d_from)
            else:
                k = self.mesh.shape[ax]
                per = x.shape[d_to] // k
                x = x.narrow(d_to, self.mesh.coordinate(ax) * per, per)
        return x


NULL_CTX = PartitionCtx()


def cache_logical(name: str, ndim: int) -> tuple:
    """The logical dims of a decode-cache leaf named ``name`` (its path in
    the family's cache, ``common.tree.named_leaves``), as the JAX
    ``PhaseEngine._cache_shardings`` names them: the mLSTM state (G, nm,
    B, H, dk[, dv]) and the sLSTM's (G, B, H, hd) by batch, their last dim
    the "state"; a quantized KV's scale plane (B, L, Hkv, S); the KV (B, L,
    Hkv, S, D), batch-leading; hymba's conv state (L, B, w - 1, d_in) and
    SSM state (L, B, d_in, N), their channels the "state"."""
    p = name.lower()
    if "mlstm" in p:
        names = [None] * ndim
        if ndim >= 3:
            names[2] = "batch"
        if ndim >= 5:
            names[-1] = "state"
        return tuple(names)
    if "slstm" in p:
        return (None, "batch", None, "state")
    if "scale" in p and ndim == 4:
        return ("batch", "layers", "kv_heads", "kv_seq")
    if ndim == 5:
        return ("batch", "layers", "kv_heads", "kv_seq", "head_dim")
    if "conv" in p and ndim == 4:
        return ("layers", "batch", None, "state")
    if ndim == 4:
        return ("layers", "batch", "state", None)
    if ndim == 3:
        return ("layers", "batch", None)
    return (None,) * ndim


def cache_spec(pctx: PartitionCtx, name: str, shape: Sequence[int]) -> PartitionSpec:
    """The sanitized spec of the decode-cache leaf ``name`` of whole
    ``shape`` under ``pctx``'s rules: what ``PhaseEngine.init_cache`` cuts
    a rank's block by."""
    return pctx.spec(shape, *cache_logical(name, len(shape)))


def local_shape(pctx: PartitionCtx, spec: PartitionSpec, shape: Sequence[int]) -> tuple:
    """A rank's block of a tensor of whole ``shape`` cut by ``spec``."""
    return tuple(n // pctx.size(ax) for n, ax in zip(shape, spec))


def cache_block(pctx: PartitionCtx, name: str, shape: Sequence[int]) -> tuple:
    """This rank's block of the decode-cache leaf ``name`` of whole
    ``shape``, cut by ``cache_spec`` (the whole shape off a mesh): what
    each family's ``init_cache`` allocates."""
    return local_shape(pctx, cache_spec(pctx, name, shape), shape)


def sanitize_spec(spec: PartitionSpec, shape: Sequence[int], mesh) -> PartitionSpec:
    """Drop spec axes whose mesh size does not divide the dim: odd dims (9
    heads on a 16-way axis, whisper's 1500-frame encoder) fall back to
    replication on that dim rather than erroring."""
    out = []
    for d, size in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is not None:
            n = 1
            for a in _axes_of(ax):
                n *= mesh.shape[a]
            if size % n != 0:
                ax = None
        out.append(ax)
    return P(*out)
