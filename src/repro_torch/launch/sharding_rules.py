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


def whole_shapes(cfg: ModelConfig) -> dict:
    """Each leaf's name -> its whole shape, for the hymba, xlstm and encdec
    families (the JAX ``init``'s tree, as ``init_like_jax`` draws it),
    with no draw."""
    d, h, hkv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    vp = cfg.padded_vocab()

    def attn(pre, n):
        return {f"{pre}/wq/w": (n, d, h * hd), f"{pre}/wk/w": (n, d, hkv * hd),
                f"{pre}/wv/w": (n, d, hkv * hd), f"{pre}/wo/w": (n, h * hd, d)}

    def norm(pre, lead, bias=False):
        return {f"{pre}/scale": lead + (d,), **({f"{pre}/bias": lead + (d,)} if bias else {})}

    if cfg.family == "hymba":
        L, n = cfg.num_layers, cfg.ssm_state
        out = {"emb": (vp, d), **attn("layers/attn", L), "layers/ssm/w_in": (L, d, 2 * d),
               "layers/ssm/conv": (L, cfg.ssm_conv, d), "layers/ssm/w_bc": (L, d, 2 * n),
               "layers/ssm/w_dt": (L, d, 1), "layers/ssm/dt_bias": (L, d),
               "layers/ssm/a_log": (L, d, n), "layers/ssm/d_skip": (L, d),
               "layers/ssm/w_out": (L, d, d), "layers/gate_a": (L,), "layers/gate_s": (L,),
               "layers/mlp/w_gate/w": (L, d, f), "layers/mlp/w_up/w": (L, d, f),
               "layers/mlp/w_down/w": (L, f, d), **norm("ln_f", ())}
        for nm in ("ln1", "ln2", "attn_norm", "ssm_norm"):
            out.update(norm(f"layers/{nm}", (L,)))
        return out
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import _group_counts

        g, nm = _group_counts(cfg)
        m, s, hd = "groups/mlstm", "groups/slstm", d // h
        return {"emb": (vp, d), "lm_head": (d, vp), **norm("ln_f", ()),
                **norm(f"{m}/ln", (g, nm)), f"{m}/w_qkv": (g, nm, d, 3 * d),
                f"{m}/w_if": (g, nm, d, 2 * h), f"{m}/w_og": (g, nm, d, d),
                f"{m}/w_out": (g, nm, d, d), **norm(f"{m}/hnorm", (g, nm)),
                **norm(f"{s}/ln", (g,)), f"{s}/w": (g, d, 4 * d), f"{s}/r": (g, h, hd, 4 * hd),
                f"{s}/b": (g, 4 * d), f"{s}/w_out": (g, d, d), **norm(f"{s}/hnorm", (g,))}
    if cfg.family == "encdec":
        out = {"emb": (vp, d), "pos_dec": (cfg.max_position_embeddings, d),
               **norm("ln_enc", (), True), **norm("ln_f", (), True)}
        for pre, n, parts in (("enc_layers", cfg.encoder_layers, ("attn",)),
                              ("dec_layers", cfg.num_layers, ("attn", "cross"))):
            for part in parts:
                out.update(attn(f"{pre}/{part}", n))
            for nm in ("ln1", "ln2") + (("lnx",) if pre == "dec_layers" else ()):
                out.update(norm(f"{pre}/{nm}", (n,), True))
            out.update({f"{pre}/mlp/w_in/w": (n, d, f), f"{pre}/mlp/w_in/b": (n, f),
                        f"{pre}/mlp/w_out/w": (n, f, d), f"{pre}/mlp/w_out/b": (n, d)})
        return out
    raise ValueError(f"{cfg.name}: whole_shapes covers the hymba, xlstm and encdec families")


def leaf_specs(local: Any, cfg: ModelConfig, mesh, *, train: bool) -> dict:
    """The spec each leaf of a latent slice was cut under, keyed by the
    leaf's name (``common.tree.named_leaves``).  A slice's shapes cannot
    tell a sharded dim from one its axis did not divide, so the rules are
    sanitized against the whole leaf's shape: for the hymba, xlstm and
    encdec families from ``whole_shapes`` (hymba-1.5b's 25 heads, say, on
    any model axis: its ``wq`` columns still split, mid-head); for the
    transformer family they are taken unsanitized, ``check_mesh_model``
    making sure every sharded dim divides (and a packed ``TernaryWeight``'s
    leaves have no whole shape of their own)."""
    from repro_torch.common.tree import named_leaves

    tp, fsdp, ep = _axes(cfg, mesh, train, "model", "data")
    whole = None if cfg.family == "transformer" else whole_shapes(cfg)
    out = {}
    for name, leaf in named_leaves(local):
        spec = param_pspec(name, leaf, tp=tp, fsdp=fsdp, ep=ep)
        out[name] = spec if whole is None else sanitize_spec(spec, whole[name], mesh)
    return out


def gather_params(local: Any, cfg: ModelConfig, mesh, *, train: bool, device=None,
                  only: Optional[int] = None) -> dict:
    """The whole latent tree from the ranks' slices: ``shard_params``'s
    inverse.  Every rank calls it (each leaf is all-gathered over the axes
    of its spec, in the spec's dim order) and every rank gets the whole
    tree, each leaf moved to ``device`` (by default where the slice lies)
    as soon as it is whole, so a gather onto the host holds one whole leaf
    on the card at a time.  With ``only`` the other ranks drop each whole
    leaf at once and get None leaves (rank 0 writing a checkpoint holds the
    host copy alone).  A moment tree (AdamW's mu, nu) is gathered the same
    way: its leaves take their parameter's spec."""
    from repro_torch.common.tree import tree_map_with_path_names
    from repro_torch.layers import collectives as C

    specs = leaf_specs(local, cfg, mesh, train=train)

    def whole(name, leaf):
        for d, ax in enumerate(specs[name]):
            if ax is not None:
                leaf = C.all_gather(leaf, mesh.group(ax), dim=d)
        if only is not None and mesh.rank != only:
            return None
        return leaf if device is None else leaf.to(device)

    return tree_map_with_path_names(whole, dict(local))
