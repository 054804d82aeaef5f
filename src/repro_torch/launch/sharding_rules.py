"""Per-parameter partition specs inferred from tree paths, and each rank's
slice of a parameter tree.

Training: FSDP (big dim over the data axis) x TP (heads/ffn/vocab over the
model axis).  Inference: TP only (fsdp=None), so decode never gathers
weights.  The path rules are the JAX package's; a packed ``TernaryWeight``
is named as the JAX tree names it (``.../w/packed``, ``.../w/scale``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.sharding import P, PartitionSpec, sanitize_spec
from repro_torch.quant.ternary import TernaryWeight

# linears whose *output* dim is tensor-parallel
_TP_OUT = ("wq/w", "wk/w", "wv/w", "w_in/w", "w_gate/w", "w_up/w",
           "w_qkv", "w_if", "w_og", "ssm/w_in", "slstm/w")
# linears whose *input* dim is tensor-parallel (summed over the axis after)
_TP_IN = ("wo/w", "w_out/w", "w_down/w", "mlstm/w_out", "slstm/w_out", "ssm/w_out")
# biases that follow a TP-output linear
_TP_BIAS = ("wq/b", "wk/b", "wv/b", "w_in/b", "slstm/b")
# ssm per-channel tensors: channel dim (second-to-last or last) is TP
_SSM_CHANNEL = ("ssm/conv", "a_log", "w_bc", "w_dt", "d_skip", "dt_bias")


def param_pspec(path: str, leaf: Any, *, tp: Optional[str], fsdp: Optional[str],
                ep: bool) -> PartitionSpec:
    nd = leaf.ndim
    p = path.lower()

    def spec(*tail):
        return P(*((None,) * (nd - len(tail)) + tail))

    if nd == 0:
        return P()
    if p.endswith("emb"):
        return P(tp, fsdp)
    if p.endswith("lm_head"):
        return P(fsdp, tp)
    if "pos_dec" in p:
        return P(*(None,) * nd)
    # MoE expert stacks: (L, E, d, f) / (L, E, f, d)
    if "/moe/" in p or ("moe" in p and nd == 4):
        if "router" in p:
            return spec(fsdp, None)
        if "w_down" in p:
            return spec(tp, None, fsdp) if ep else spec(None, tp, fsdp)
        return spec(tp, fsdp, None) if ep else spec(None, fsdp, tp)
    if any(p.endswith(s) or f"/{s}/" in p + "/" for s in _TP_BIAS):
        return spec(tp)
    if any(s in p for s in _TP_IN):
        return spec(tp, fsdp)
    if any(s in p for s in _TP_OUT):
        return spec(fsdp, tp)
    if "slstm/r" in p:  # (G, H, hd, 4hd)
        return spec(None, tp)
    if any(s in p for s in _SSM_CHANNEL):
        if p.endswith(("d_skip", "dt_bias")):
            return spec(tp)
        if "conv" in p:
            return spec(tp)  # (L, w, d_in): channel is last
        return spec(tp, None)  # (L, d_in, N)-shaped
    if "router" in p:
        return spec(fsdp, None)
    return P(*(None,) * nd)  # norms, gates, stabilizers: replicated


def _map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a params tree, a ``TernaryWeight`` taken
    apart into its ``packed`` and ``scale`` leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, TernaryWeight):
        return TernaryWeight(fn(f"{path}/packed", tree.packed), fn(f"{path}/scale", tree.scale))
    return fn(path, tree)


def _axes(cfg: ModelConfig, mesh, train: bool, tp_axis: Optional[str],
          fsdp_axis: Optional[str]):
    tp = tp_axis if (tp_axis and tp_axis in mesh.axis_names) else None
    fsdp = fsdp_axis if (train and fsdp_axis and fsdp_axis in mesh.axis_names) else None
    ep = bool(cfg.moe and tp and cfg.num_experts % mesh.shape[tp] == 0)
    return tp, fsdp, ep


def params_shardings(params: Any, cfg: ModelConfig, mesh, *, train: bool,
                     tp_axis: str = "model", fsdp_axis: Optional[str] = "data") -> Any:
    """A tree of ``PartitionSpec`` matching ``params`` (sanitized against
    each leaf's shape): the JAX ``params_shardings`` without the device
    placement."""
    tp, fsdp, ep = _axes(cfg, mesh, train, tp_axis, fsdp_axis)

    def rule(path, leaf):
        return sanitize_spec(param_pspec(path, leaf, tp=tp, fsdp=fsdp, ep=ep), leaf.shape, mesh)

    return _map(rule, params)


def local_slice(leaf: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of a whole ``leaf`` under ``spec``: each sharded
    dim cut into equal parts, this rank's coordinate picking one."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        k, i = 1, 0
        for a in axes:
            k *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coordinate(a)
        per = leaf.shape[d] // k
        leaf = leaf.narrow(d, i * per, per)
    return leaf


class RankSlice(dict):
    """A params tree that is one rank's slice already (``shard_params``),
    with where it was cut: ``place`` is ((axis, size, coordinate), ...) of
    the mesh and rank it belongs to."""

    def __init__(self, tree: dict, place: tuple, train: bool):
        super().__init__(tree)
        self.place, self.train = place, train


def _place(mesh) -> tuple:
    return tuple((a, n, mesh.coordinate(a)) for a, n in mesh.shape.items())


def shard_params(params: Any, cfg: ModelConfig, mesh, *, train: bool = False,
                 device=None) -> RankSlice:
    """This rank's slice of a whole params tree (the port's, or one from
    ``interop.params_from_numpy``), each slice a contiguous copy on
    ``device`` (the mesh's by default).  A packed ``TernaryWeight`` is
    sliced in its packed bytes — (K/4, N) rows of four K rows each — and
    keeps the whole tensor's absmean scale: a shard is never quantized
    again, since its own absmean would be another scale.

    Only the slices are copied: a whole tree on the host (a checkpoint
    read with ``interop.params_from_numpy``) puts no more than the rank's
    slice on its card.  Drop the whole tree once the slice is taken."""
    specs = params_shardings(params, cfg, mesh, train=train)
    dev = mesh.device if device is None else torch.device(device)

    def take(tree, spec):
        if isinstance(tree, dict):
            return {k: take(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, TernaryWeight):
            # the scale (L,) stays whole whatever its spec says of the
            # layer axis: every layer's shard needs its own layer's beta
            return TernaryWeight(take(tree.packed, spec.packed), tree.scale.to(dev).contiguous())
        return local_slice(tree, spec, mesh).to(dev).contiguous()

    return RankSlice(take(params, specs), _place(mesh), train)


def local_params(params: Any, cfg: ModelConfig, mesh, *, train: bool = False) -> RankSlice:
    """The params a rank of ``mesh`` runs on: ``params`` itself where it is
    this rank's slice already (``shard_params``; cut for another mesh or
    rank, it raises), else this rank's slice of the whole tree given."""
    if isinstance(params, RankSlice):
        if params.place != _place(mesh) or params.train != train:
            raise ValueError(f"a params slice cut at {params.place} (train={params.train}) "
                             f"given to a rank at {_place(mesh)} (train={train})")
        return params
    return shard_params(params, cfg, mesh, train=train)
