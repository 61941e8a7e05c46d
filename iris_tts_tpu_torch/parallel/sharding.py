"""Parameter and batch placement rules.

Counterpart of the JAX package's ``parallel/sharding.py``. JAX's rule:
every parameter leaf at least 2-D whose trailing dim is at least
``min_dim`` wide and divides by the model axis shards that dim over the
``model`` axis; everything else is replicated, and GSPMD inserts the
collectives. The port applies the same rule to the same leaves: each
column-parallel layer (``models/layers.ColumnParallel``) is judged on the
trailing dim of the flax kernel its weight converts from
(``convert/from_jax.py``), which is its output-channel count (``D`` of an
attention query/key/value kernel ``(E, H, D)``), and a sharded layer
computes its slice of the output channels and gathers them over the model
group (``parallel/tp.py``). Biases, norm scales and statistics are 1-D and
stay whole, but for attention's ``(H, D)`` query/key/value biases, which
split with their kernels.

A sharded parameter is this rank's slice; :func:`full_state_dict` and
:func:`load_full_state_dict` read and write whole tensors, so a checkpoint
written on a model axis loads in one process and the reverse.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import MeshConfig
from iris_tts_tpu_torch.parallel.mesh import Mesh, replicate_params, shard_batch
from iris_tts_tpu_torch.parallel.tp import model_axis


def _column_layers(module: nn.Module):
    from iris_tts_tpu_torch.models.layers import ColumnParallel

    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, ColumnParallel)]


def tp_param_sharding(params: Any, mesh: Mesh,
                      cfg: MeshConfig = MeshConfig(),
                      min_dim: int = 8) -> Any:
    """Place a module's parameters (or a tree of tensors) on ``mesh``:
    replicated from world rank 0, then, on a model axis wider than one
    rank, every column-parallel layer whose flax kernel's trailing dim is
    at least ``min_dim`` and divides by the axis keeps its slice of the
    output channels. A tree of tensors is only replicated (the model axis
    needs the layers that compute on the slices). Returns ``params``."""
    del cfg  # the mesh's second axis is its model axis
    axis = model_axis(mesh)
    if isinstance(params, nn.Module) and is_sharded(params):
        raise ValueError("the module is sharded already")
    params = replicate_params(params, mesh)
    if axis is None:
        return params
    if not isinstance(params, nn.Module):
        raise TypeError("the model axis shards the layers of a module; "
                        f"got {type(params).__name__}")
    for m in params.modules():
        if getattr(m, "tp_refusal", None):
            raise ValueError(m.tp_refusal)
    for _, layer in _column_layers(params):
        width = layer.jax_width()
        if layer.tp is None and width >= min_dim and width % axis.size == 0:
            layer.shard_(axis)
    return params


def sharded_params(module: nn.Module) -> Dict[str, Tuple[Any, str]]:
    """State-dict key → (layer, parameter name) of every parameter that
    holds this rank's slice (empty for an unsharded module)."""
    out = {}
    for prefix, layer in _column_layers(module):
        for name in layer.split_params():
            out[f"{prefix}.{name}" if prefix else name] = (layer, name)
    return out


def is_sharded(module: nn.Module) -> bool:
    return any(layer.tp is not None for _, layer in _column_layers(module))


def whole(module: nn.Module, key: str, local: torch.Tensor) -> torch.Tensor:
    """The whole tensor of sharded leaf ``key`` from this rank's slice
    ``local`` (the leaf itself, or a tensor of its shape such as an Adam
    moment): a gather over the model group."""
    layer, name = sharded_params(module)[key]
    return layer.tp.whole(local.detach(), layer.param_dim(name))


def local(module: nn.Module, key: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor ``full`` of sharded leaf
    ``key``."""
    layer, name = sharded_params(module)[key]
    return layer.tp.local(full, layer.param_dim(name))


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded leaf whole (a gather over
    the model group per leaf: every rank of the axis calls it)."""
    sd = module.state_dict()
    for key in sharded_params(module):
        sd[key] = whole(module, key, sd[key])
    return sd


def load_full_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor]):
    """``module.load_state_dict(strict=True)`` of whole tensors: each
    sharded leaf takes this rank's slice."""
    sharded = sharded_params(module)
    if sharded:
        sd = dict(sd)
        for key in sharded:
            if key in sd:
                sd[key] = local(module, key, sd[key])
    return module.load_state_dict(sd, strict=True)


def batch_sharding_tree(batch: Any, mesh: Mesh,
                        cfg: MeshConfig = MeshConfig()):
    """Alias of :func:`iris_tts_tpu_torch.parallel.mesh.shard_batch`."""
    return shard_batch(batch, mesh, cfg)
