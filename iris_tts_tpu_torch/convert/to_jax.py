"""Carry a port module's weights back to the JAX package's layout.

The inverse of :func:`~iris_tts_tpu_torch.convert.from_jax.module_state_from_jax`:
:func:`jax_params_from_module` lays a module's parameters out as the flax
``params`` tree of its JAX counterpart (nested dicts of float32 numpy
arrays, flax leaf names and layouts), which is what a checkpoint shared
with the JAX package holds (``text.neural_g2p.save_g2p``). It covers the
layer types of the G2P transformer (dense layers, attention projections,
embeddings, LayerNorm), each inverting its row of ``from_jax``'s table;
the round trip through ``module_state_from_jax`` gives the module's state
dict back exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from iris_tts_tpu_torch.models.encoder import MultiHeadAttention
from iris_tts_tpu_torch.models.layers import Dense, Embedding, LayerNorm


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().float().numpy())


def _layer_leaves(layer: nn.Module, heads: int) -> Dict[str, np.ndarray]:
    """One layer's flax leaves. ``heads``: the head count when the layer
    is an attention output projection (kernel ``[H, D, E]``), else 0."""
    if isinstance(layer, Dense):
        w, b = _np(layer.weight), _np(layer.bias)
        if layer._split_bias:  # attention query/key/value: [E, H, D]
            h = layer._heads
            return {"kernel": w.T.reshape(w.shape[1], h, -1),
                    "bias": b.reshape(h, -1)}
        if heads:
            return {"kernel": w.T.reshape(heads, -1, w.shape[0]), "bias": b}
        return {"kernel": w.T, "bias": b}
    if isinstance(layer, Embedding):
        return {"embedding": _np(layer.weight)}
    if isinstance(layer, LayerNorm):
        return {"scale": _np(layer.weight), "bias": _np(layer.bias)}
    raise ValueError(f"no flax layout for {type(layer).__name__}")


def jax_params_from_module(module: nn.Module) -> Dict:
    """A port module's parameters → the flax ``params`` tree of its JAX
    counterpart (numpy leaves). Raises on a layer type it cannot lay out
    (a convolution, or BatchNorm)."""
    tree: Dict = {}
    parents = dict(module.named_modules())
    for name, layer in module.named_modules():
        if not any(True for _ in layer.parameters(recurse=False)):
            continue
        path = name.split(".") if name else []
        parent = parents.get(".".join(path[:-1])) if path else None
        heads = (parent.num_heads if isinstance(parent, MultiHeadAttention)
                 and path[-1] == "out" else 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node.update({k: np.ascontiguousarray(v, np.float32)
                     for k, v in _layer_leaves(layer, heads).items()})
    return tree
