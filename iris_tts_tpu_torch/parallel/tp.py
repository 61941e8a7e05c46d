"""The model axis: column-parallel layers over a group of ranks.

Counterpart of what GSPMD does for the JAX package when
``parallel/sharding.tp_param_sharding`` puts a parameter's trailing
(output-channel) dim on the ``model`` axis. Here the layer itself is
rewritten: a sharded layer keeps its slice of the output channels as its
own parameter, computes only those channels and gathers them along the
channel dim over the model group, with the standard differentiable pair
around its op:

* before it, :func:`enter_model`: identity forward, a sum of the input's
  gradient over the model group backward (each rank's gradient reaches the
  input through its own channels only);
* after it, :func:`gather_channels`: the ranks' slices gathered forward
  (an all-reduce into a zero-filled buffer, exact, as every gather of the
  port), this rank's slice of the gradient backward.

Every activation outside a sharded layer is then whole and the same on
each rank of the model group, and so is every gradient of an unsharded
parameter. A layer whose bias stays whole adds it after the gather, so no
rank uses that bias in part and none of its gradients needs a sum.

A split's output channels are ``[outer, size, inner]`` with rank ``r``
owning ``[:, r, :]``: ``outer`` is 1 for a plain slice and the head count
for attention's query/key/value, whose flax kernel ``(E, H, D)`` splits
``D`` within each head. Collectives are counted in
``parallel.mesh.COLLECTIVES`` under ``tp_gather``, ``tp_input_grad`` and
``tp_state`` (a state dict's slices gathered whole).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES, local_only


@dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's place on a mesh's model axis: the axis' process group,
    this rank's coordinate on it and its size."""

    group: Any
    rank: int
    size: int
    backend: Optional[str]

    def __deepcopy__(self, memo):  # a module copy shares the group
        return self


def model_axis(mesh) -> Optional[ModelAxis]:
    """The model axis of ``mesh``; None where it has one rank. A model axis
    wider than one rank with no process group raises: the model axis
    never falls back to replication."""
    if mesh is None or mesh.model_size == 1:
        return None
    if local_only(mesh) or mesh.model_group is None:
        raise ValueError(f"a model axis of {mesh.model_size} needs a process "
                         "group over its ranks (initialize_multihost, then "
                         "build_mesh)")
    return ModelAxis(mesh.model_group, mesh.model_rank, mesh.model_size,
                     mesh.backend)


def _blocks(t: torch.Tensor, dim: int, outer: int, n: int) -> torch.Tensor:
    """``t`` with ``dim`` viewed as ``(outer, n, rest)``."""
    s = t.shape
    return t.reshape(*s[:dim], outer, n, s[dim] // (outer * n), *s[dim + 1:])


@dataclass(frozen=True, eq=False)
class ColumnSplit:
    """How a layer's output channels lie over the model axis: ``outer``
    blocks, each split ``axis.size`` ways; ``bias``: the bias is split
    too (else it stays whole and is added after the gather)."""

    axis: ModelAxis
    outer: int = 1
    bias: bool = False

    def __deepcopy__(self, memo):
        return self

    def local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a whole tensor along ``dim``."""
        part = _blocks(full, dim, self.outer, self.axis.size).select(
            dim + 1, self.axis.rank)
        s = full.shape
        return part.reshape(*s[:dim], s[dim] // self.axis.size,
                            *s[dim + 1:]).contiguous()

    def whole(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice gathered into the whole tensor along ``dim``
        (a collective: every rank of the model axis calls it)."""
        return _gather(local, self.axis, dim, self.outer, "tp_state")


def _gather(local: torch.Tensor, axis: ModelAxis, dim: int, outer: int,
            path: str) -> torch.Tensor:
    s = list(local.shape)
    s[dim] *= axis.size
    buf = torch.zeros(s, dtype=local.dtype, device=local.device)
    _blocks(buf, dim, outer, axis.size).select(dim + 1, axis.rank).copy_(
        _blocks(local, dim, outer, 1).select(dim + 1, 0))
    COLLECTIVES[(path, "all_reduce", axis.backend)] += 1
    dist.all_reduce(buf, group=axis.group)
    return buf


def input_grad_sum_(grad: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The backward of :func:`enter_model`: the input's gradient summed
    over the model group, in place."""
    COLLECTIVES[("tp_input_grad", "all_reduce", axis.backend)] += 1
    dist.all_reduce(grad, group=axis.group)
    return grad


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # Looked up at each call, so a test can plant the sum out.
        return input_grad_sum_(grad.contiguous().clone(), ctx.axis), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, dim, outer):
        ctx.axis, ctx.dim, ctx.outer = axis, dim, outer
        return _gather(y.contiguous(), axis, dim, outer, "tp_gather")

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        part = _blocks(grad, ctx.dim, ctx.outer, a.size).select(
            ctx.dim + 1, a.rank)
        s = list(grad.shape)
        s[ctx.dim] //= a.size
        return part.reshape(s).contiguous(), None, None, None


def enter_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity; in the backward pass the gradient is summed over the
    model group (nothing to do when no gradient is recorded)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _EnterModel.apply(x, axis)


def gather_channels(y: torch.Tensor, split: ColumnSplit,
                    dim: int) -> torch.Tensor:
    """This rank's output channels (``dim`` of ``y``) → every rank's, on
    every rank; the backward pass keeps this rank's slice."""
    dim = dim % y.ndim
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatherChannels.apply(y, split.axis, dim, split.outer)
    return _gather(y.contiguous(), split.axis, dim, split.outer, "tp_gather")
