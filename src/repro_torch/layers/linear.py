"""Linear layers: dense matmul and TLMM-backed packed ternary (the paper's
static region, shared by both phases).

Params are ``{"w": (K, N) tensor}`` (+``"b"``) for dense weights, or
``{"w": TernaryWeight}`` for packed ternary weights.  Latent ternary
weights take one of three regimes, as in the JAX package:

* inference, packed once (``models.transformer.convert_for_inference``)
  and multiplied by the TLMM kernel;
* inference, quantized and packed on the fly at every call (the slow path);
* training (``training=True``): BitNet quantization-aware training, the
  straight-through ternary weights times the straight-through int8
  activations in an f32 product.  It reaches no kernel: a kernel's output
  has no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import QuantConfig
from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel, tlmm_matmul
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.layers import collectives as C
from repro_torch.quant.act_quant import quantize_activations_int8, quantize_and_fold
from repro_torch.quant.ternary import (
    TernaryWeight,
    pack_ternary,
    ternary_quantize,
    ternary_quantize_ste,
)


def linear_init(gen: torch.Generator, k: int, n: int, *, bias: bool = False,
                scale: Optional[float] = None, device=None) -> dict:
    """N(0, 1/K) f32 weights (``scale`` overrides the std), drawn from ``gen``."""
    if scale is None:
        scale = 1.0 / (k**0.5)
    p = {"w": torch.randn((k, n), generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((n,), device=device)
    return p


def _act_fake_quant_ste(x: torch.Tensor, group=None) -> torch.Tensor:
    """Per-token int8 fake quantization with a straight-through gradient:
    forward ``x + (deq - x)``, deq the int8 codes times their row scale in
    x's dtype; backward the identity.  Where ``x`` is this rank's slice of
    each row (a row-parallel linear over ``group``), the row's absmax is the
    MAX of the ranks' partial absmaxes."""
    with torch.no_grad():
        absmax = None
        if group is not None and dist.get_world_size(group) > 1:
            absmax = C.all_reduce(x.float().abs().amax(dim=-1, keepdim=True), group, op="max")
        x_q, scale = quantize_activations_int8(x, absmax=absmax)
        deq = (x_q.float() * scale).to(x.dtype)
    return x + (deq - x).detach()


def linear_apply_train_sharded(params: dict, x: torch.Tensor, quant: QuantConfig, pctx, *,
                               parallel: str) -> torch.Tensor:
    """A linear of the training pass on a mesh (``pctx``, the train rules).
    This rank holds the weight's FSDP x TP block: (K/data, N/model) for a
    ``column``-parallel linear (wq, wk, wv, w_gate, w_up; ``x`` whole, the
    caller having passed it through ``copy_to_tp``), (K/model, N/data) for
    a ``row``-parallel one (wo, w_down; ``x`` this rank's K/model slice).
    The block is gathered over data (``fsdp_gather``: its gradient is
    reduce-scattered back, summed over the data ranks' batches), multiplied
    as ``linear_apply(training=True)`` multiplies (a ternary config's QAT
    with the whole weight's beta and the whole row's activation scale),
    and a row-parallel product is summed over the model axis
    (``reduce_from_tp``).  A column bias is this rank's columns."""
    if parallel not in ("column", "row"):
        raise ValueError(f"parallel must be 'column' or 'row', got {parallel!r}")
    mesh = pctx.mesh
    tp = mesh.group(pctx.axes.tp) if pctx.axes.tp else None
    fsdp = pctx.axes.fsdp
    w = params["w"]
    if isinstance(w, TernaryWeight):
        raise ValueError("a packed TernaryWeight has no latent weights to train; "
                         "train the latent weights and pack them afterwards")
    if fsdp is not None:
        w = C.fsdp_gather(w, mesh.group(fsdp), dim=w.dim() - 2 if parallel == "column" else w.dim() - 1)
    row = tp if parallel == "row" else None
    if quant.ternary:
        wf, beta = w.float(), None
        if tp is not None and dist.get_world_size(tp) > 1:
            with torch.no_grad():  # the whole (K, N) weight's absmean, not this shard's
                beta = C.all_reduce(wf.abs().sum(), tp) / (wf.numel() * dist.get_world_size(tp))
        w_ste, _ = ternary_quantize_ste(wf, beta=beta)
        y = (_act_fake_quant_ste(x, row).float() @ w_ste).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if parallel == "row" and tp is not None:
        y = C.reduce_from_tp(y, tp)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def train_weight(w: torch.Tensor, pctx, whole, *, fsdp_dim: Optional[int] = None,
                 tp_dim: Optional[int] = None, tp: str = "keep") -> torch.Tensor:
    """This rank's copy of a weight for the training pass on a mesh
    (``pctx``, the train rules).  ``w`` is the leaf's FSDP x TP block under
    the sanitized rules, ``whole`` the whole weight's shape.  Along
    ``fsdp_dim`` it is gathered over the fsdp axis (``fsdp_gather``: the
    gradient reduce-scattered back, summed over the data ranks' batches),
    where the axis divides that dim; elsewhere it is whole there already.
    Along ``tp_dim``, over the model axis, ``tp`` says what the ranks do
    with it: ``"keep"`` this rank's block; ``"sum"`` gathered whole, each
    rank then using its own part of it (``fsdp_gather``: the summing
    reduce-scatter, since the ranks' gradients differ); ``"same"``
    gathered whole, every rank using all of it alike (``gather_replicated``:
    this rank's slice of the gradient every rank holds whole)."""
    if tp not in ("keep", "sum", "same"):
        raise ValueError(f"tp must be 'keep', 'sum' or 'same', got {tp!r}")
    mesh = pctx.mesh

    def split(dim, ax):
        return ax is not None and dim is not None and whole[dim] % pctx.size(ax) == 0

    if split(fsdp_dim, pctx.axes.fsdp):
        w = C.fsdp_gather(w, mesh.group(pctx.axes.fsdp), dim=fsdp_dim % w.dim())
    if tp != "keep" and split(tp_dim, pctx.axes.tp):
        gather = C.fsdp_gather if tp == "sum" else C.gather_replicated
        w = gather(w, mesh.group(pctx.axes.tp), dim=tp_dim % w.dim())
    return w


def linear_apply_train_whole(params: dict, x: torch.Tensor, quant: QuantConfig, pctx,
                             whole) -> torch.Tensor:
    """A linear of the training pass on a mesh that every model rank
    computes whole (hymba's heads where the model axis does not split
    them): the (K, N) weight of whole shape ``whole`` under the (fsdp,
    model) rule, gathered over both (``train_weight(tp="same")``), and its
    bias, multiplied as ``linear_apply(training=True)``.  ``x`` is whole on
    every rank and takes no ``copy_to_tp``: every rank's gradient of it is
    the whole one already."""
    out = {"w": train_weight(params["w"], pctx, whole, fsdp_dim=0, tp_dim=1, tp="same")}
    if "b" in params:
        out["b"] = train_weight(params["b"], pctx, whole[1:], tp_dim=0, tp="same")
    return linear_apply(out, x, quant, training=True)


def linear_apply(params: dict, x: torch.Tensor, quant: QuantConfig, *,
                 training: bool = False) -> torch.Tensor:
    w = params["w"]
    if isinstance(w, TernaryWeight):
        if training:
            raise ValueError("a packed TernaryWeight has no latent weights to train; "
                             "train the latent weights and pack them afterwards")
        y = tlmm_matmul(x, w)
    elif quant.ternary and training:  # BitNet QAT
        w_ste, _ = ternary_quantize_ste(w.float())
        y = (_act_fake_quant_ste(x).float() @ w_ste).to(x.dtype)
    elif quant.ternary:  # unconverted: quantize on the fly (the slow path)
        # a unit weight scale folds nothing; beta multiplies the f32 product
        # afterwards, in the JAX package's order
        w_q, beta = ternary_quantize(w)
        unit = TernaryWeight(pack_ternary(w_q), torch.ones_like(beta))
        y = (tlmm_matmul(x.float(), unit) * beta).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def linear_apply_row_parallel(params: dict, x: torch.Tensor, quant: QuantConfig, group, *,
                              whole_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel linear on a mesh: ``x`` (..., K/k) is this rank's
    slice of the input along K, ``params["w"]`` the matching (K/k, N) rows
    (packed: (K/4k, N) bytes), and the k ranks of ``group`` sum their
    partial products.  Returns the whole (..., N) output on every rank.

    A packed weight gives the unsharded linear's bits.  The per-token int8
    scale of the activations is taken over the whole row: its absmax is
    the MAX over the ranks' partial absmaxes (or the absmax of
    ``whole_row``, the whole input where every rank holds it).  It enters
    the ``act_quant`` kernel as one extra column of the slice, so the
    kernel quantizes the slice with the whole row's scale.  Each rank's
    TLMM runs with a unit scale and returns its int32 partial sum as an
    f32 integer (exact while 127 * K < 2**24), the ranks sum those
    exactly, and the one rounding is the final scale, as in the unsharded
    kernel.  A dense weight sums f32 partial products, rounded once to
    x's dtype at the end (a rounding the unsharded product does not
    make); on a group of one it is the unsharded product, bit for bit."""
    w = params["w"]
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if isinstance(w, TernaryWeight):
        src = x2 if whole_row is None else whole_row.reshape(x2.shape[0], -1)
        absmax = src.float().abs().amax(dim=-1, keepdim=True)
        if whole_row is None:
            absmax = C.all_reduce(absmax, group, op="max")
        pad = torch.zeros((x2.shape[0], 3), dtype=x2.dtype, device=x2.device)
        x_aug = torch.cat([x2, absmax.to(x2.dtype), pad], dim=-1)
        unit = torch.ones((x2.shape[0], 1), dtype=torch.float32, device=x2.device)
        if x2.is_cuda:
            x_q, scale = act_quant_kernel(x_aug, w.scale)
            acc = tlmm_kernel(x_q[:, :k], w.packed, unit)
        else:
            x_q, scale = quantize_and_fold(x_aug, w.scale)
            acc = tlmm_reference(x_q[:, :k], w.packed, unit)
        y = (C.all_reduce(acc, group) * scale).to(x.dtype)
    elif quant.ternary:
        raise NotImplementedError("a row-parallel ternary linear takes packed weights "
                                  "(models.transformer.convert_for_inference)")
    elif C._trivial(group):
        return linear_apply(params, x, quant)
    else:
        y = C.all_reduce(x2.float() @ w.float(), group).to(x.dtype)
    y = y.reshape(*lead, y.shape[-1])
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
