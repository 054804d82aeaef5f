"""Parameters from the JAX package, as numpy, into the port.

``params_from_numpy(tree, cfg, device)`` takes the JAX package's parameter
tree after the caller has turned every leaf into a numpy array: nested
dicts with layer-stacked leaves (leading dim L).  A linear's ``"w"`` entry
is either

* a packed ternary weight flattened to ``{"packed": (L, K/4, N) uint8,
  "scale": (L,) f32}`` — it becomes a ``TernaryWeight`` byte for byte; or
* a latent ``(L, K, N)`` array — packed here by the port's own quantizer
  when the config is ternary, kept dense otherwise.

``train_state_from_numpy(params, opt, cfg, device)`` takes the JAX
training state, (params, ``AdamWState``) with every leaf numpy (``opt`` as
``{"step", "mu", "nu"}``, an ``AdamWState``'s ``_asdict()``): the weights
stay latent (a ternary config trains them), the moments f32, the step
int32.

``kv_from_numpy(tree, device)`` takes a JAX decode cache or page pool the
same way: ``{"k": leaf, "v": leaf}``, a leaf being an array or a quantized
leaf flattened to ``{"q": payload, "scale": scale plane}``; it becomes the
port's ``KVCache`` of tensors or ``QuantKV`` leaves, byte for byte.

The port never sees a JAX type, and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import KVCache
from repro_torch.quant.kv_quant import QuantKV
from repro_torch.quant.ternary import TernaryWeight, quantize_and_pack_stacked


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; a 0-d leaf stays 0-d
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which numpy cannot hand to torch
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(node, cfg: ModelConfig, device, key: str = "", latent: bool = False):
    if isinstance(node, dict):
        if key == "w" and "packed" in node:
            return TernaryWeight(_tensor(node["packed"], device),
                                 _tensor(np.asarray(node["scale"], np.float32), device))
        return {k: _convert(v, cfg, device, k, latent) for k, v in node.items()}
    t = _tensor(node, device)
    if key == "w" and cfg.quant.ternary and not latent:
        return quantize_and_pack_stacked(t.float())
    return t


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None, *, latent: bool = False) -> dict:
    """The port's params for ``cfg`` on ``device`` (CUDA by default);
    ``latent=True`` keeps a ternary config's latent weights as they are
    (to train them) instead of packing them."""
    return _convert(tree, cfg, resolve_device(device), latent=latent)


def train_state_from_numpy(params: dict, opt, cfg: ModelConfig, device=None):
    """The port's (params, ``AdamWState``) for a JAX training state given as
    numpy, on ``device`` (CUDA by default), byte for byte."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    moments = [_convert(opt[k], cfg, dev, latent=True) for k in ("mu", "nu")]
    return (params_from_numpy(params, cfg, dev, latent=True),
            AdamWState(_tensor(np.asarray(opt["step"], np.int32), dev), *moments))


def kv_from_numpy(tree: dict, device=None) -> KVCache:
    """The port's cache or pool for a JAX one given as numpy, on ``device``
    (CUDA by default)."""
    dev = resolve_device(device)

    def leaf(node):
        if isinstance(node, dict):
            return QuantKV(_tensor(node["q"], dev), _tensor(node["scale"], dev))
        return _tensor(node, dev)

    return KVCache(leaf(tree["k"]), leaf(tree["v"]))
