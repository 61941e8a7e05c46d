"""Layer modules shared by the model zoo, with flax-matching init.

Counterpart of the JAX package's ``models/layers.py``. ``Conv1d`` and
``Dense`` hold their parameters directly (``weight``, ``bias``) so that a
flax path such as ``vae/in_proj/kernel`` maps to the state-dict key
``vae.in_proj.weight``. Convolutions run channels-first ``[B, C, T]``.

Random init mirrors flax's defaults so a random-weight pipeline has the same
output scale as the JAX one (the numbers differ: the generators differ):
lecun-normal (truncated normal, variance 1/fan_in) kernels with zero biases,
``normal(1/sqrt(features))`` embeddings, and the per-layer overrides the
JAX modules name (zero-initialised heads, HiFiGAN's ``normal(0.01)``).

Compute dtype, as flax's per-module ``dtype``: every module of the model
zoo that computes carries a ``dtype`` attribute (float32 by default).
Parameters stay float32; ``Conv1d``, ``ConvTranspose1d``, ``Conv2d`` and
``Dense`` cast their input, weight and bias to ``dtype`` at each call and
return that dtype (cuDNN and cuBLAS accumulate a bf16 product in f32,
``runtime.pin_math_precision``); ``LayerNorm`` takes its statistics in f32
and returns ``dtype``. :func:`set_dtype` sets the dtype of a whole module
tree, :func:`computing` does so for the length of a ``with`` block (the
train steps), and :func:`dtype_view` makes a copy of the module tree that
shares the parameters (``TTSPipeline``'s ``dtype``). Remat
(``torch.utils.checkpoint``) of a block that draws dropout masks from an
explicit generator goes through :func:`checkpoint_block`.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
from typing import Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from iris_tts_tpu_torch.ops.conv import conv1d, conv_transpose1d

# flax's truncated_normal variance_scaling divides by the stddev of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator],
            broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """``flax.linen.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; identity when
    ``deterministic`` or ``rate == 0``. The mask is drawn from
    ``generator`` (on ``x``'s device), so a train state that owns the
    generator replays its masks exactly on resume; ``broadcast_dims``
    share one mask along those axes."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = [1 if i in broadcast_dims else n for i, n in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def set_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of every module in ``module``'s tree that has
    one; the parameters are not touched."""
    for m in module.modules():
        if "dtype" in vars(m):
            m.dtype = dtype
    return module


def module_dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype of the first module in ``module``'s tree that has
    one (float32 if none has)."""
    for m in module.modules():
        if "dtype" in vars(m):
            return m.dtype
    return torch.float32


@contextlib.contextmanager
def computing(modules: Iterable[nn.Module], dtype: torch.dtype,
              remat: Optional[bool] = None):
    """Within the block, ``modules`` compute in ``dtype`` (and, when
    ``remat`` is not None, every module with a ``remat`` switch has it set
    so); the previous settings come back on exit. A train step wraps its
    forward and backward passes in it, so the modules in its state keep
    the dtype they had."""
    saved = []
    for mod in modules:
        if mod is None:
            continue
        for m in mod.modules():
            attrs = vars(m)
            for name, value in (("dtype", dtype), ("remat", remat)):
                if value is not None and name in attrs:
                    saved.append((m, name, attrs[name]))
                    setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in reversed(saved):
            setattr(m, name, value)


def dtype_view(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module``'s tree of modules computing in ``dtype`` that
    shares its parameters and buffers (no tensor is copied): two pipelines
    of one model in two dtypes."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                               module.buffers())}
    return set_dtype(copy.deepcopy(module, memo), dtype)


def checkpoint_block(block, *args,
                     generator: Optional[torch.Generator] = None):
    """``block(*args, generator=generator)`` (``block(*args)`` without a
    generator) under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    stored but recomputed in the backward pass, as flax's ``nn.remat``
    does.

    ``checkpoint`` replays only PyTorch's default generators, while the
    port's dropout draws from an explicit ``generator`` that has moved on
    by the time of the backward pass: the recompute would draw other masks
    and the gradients would be silently wrong. So the generator's state is
    taken before the forward call, and the recompute draws from a clone
    restored to it (the live generator is not advanced twice), which is
    how JAX's remat replays the same key. The default generators are not
    stashed (``preserve_rng_state=False``): nothing in a block draws from
    them."""
    if generator is None:
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False)
    state = generator.get_state()
    calls = []

    def run(*a):
        g = generator
        if calls:  # the recompute in the backward pass
            g = torch.Generator(device=generator.device)
            g.set_state(state)
        calls.append(None)
        return block(*a, generator=g)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def same_padding(t: int, k: int, stride: int, dilation: int
                 ) -> Tuple[int, int]:
    """TF/XLA 'SAME': output ceil(T/s); the extra pad goes on the right."""
    out = -(-t // stride)
    eff_k = (k - 1) * dilation + 1
    pad_total = max((out - 1) * stride + eff_k - t, 0)
    pl = pad_total // 2
    return pl, pad_total - pl


class Conv1d(nn.Module):
    """1-D conv on ``[B, C_in, T]``, 'SAME' (default) or explicit
    (left, right) padding. ``init``: "lecun" (flax default), "zeros", or
    "normal" (HiFiGAN's normal(0.01) kernels)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: Union[str, Tuple[int, int]] = "SAME",
                 init: str = "lecun", dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(padding, str) and padding.upper() != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        if init not in ("lecun", "zeros", "normal"):
            raise ValueError(f"unknown init {init!r}")
        self.dtype = dtype
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding, self.init = padding, init
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator) -> None:
        if self.init == "lecun":
            lecun_normal_(self.weight, self.weight[0].numel(), generator)
        elif self.init == "normal":
            nn.init.normal_(self.weight, 0.0, 0.01, generator=generator)
        else:
            nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if isinstance(self.padding, str):
            pad = same_padding(x.shape[-1], k, self.stride, self.dilation)
        else:
            pad = tuple(self.padding)
        dt = self.dtype
        return conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                      stride=self.stride, dilation=self.dilation,
                      padding=pad, groups=self.groups)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv with torch semantics (crop = (K−u)//2 → T_out =
    T·u). Weight ``[C_in, C_out, K]`` in true-convolution orientation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, init: str = "lecun",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if init not in ("lecun", "normal"):
            raise ValueError(f"unknown init {init!r}")
        self.dtype = dtype
        self.stride, self.init = stride, init
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator) -> None:
        if self.init == "lecun":
            fan_in = self.weight.shape[0] * self.weight.shape[2]
            lecun_normal_(self.weight, fan_in, generator)
        else:
            nn.init.normal_(self.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return conv_transpose1d(x.to(dt), self.weight.to(dt),
                                self.bias.to(dt), stride=self.stride)


class Conv2d(nn.Module):
    """2-D conv on ``[B, C, H, W]`` with explicit ((top, bottom), (left,
    right)) padding; weight ``[C_out, C_in, kh, kw]``, flax lecun init."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride=(1, 1),
                 padding=((0, 0), (0, 0)), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = tuple(stride)
        (pt, pb), (pl, pr) = padding
        self.pad = (pl, pr, pt, pb)  # F.pad order: last dim first
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(F.pad(x.to(dt), self.pad), self.weight.to(dt),
                        self.bias.to(dt), stride=self.stride)


class Dense(nn.Linear):
    """``flax.linen.Dense`` on the last axis; ``zero_init`` for the heads
    the JAX modules initialise to zero."""

    def __init__(self, in_features: int, out_features: int,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32):
        self.zero_init = zero_init  # read by reset_parameters() in __init__
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        # nn.Linear.__init__ calls this with no generator; the model-level
        # init_params() calls it again with one.
        if self.zero_init or generator is None:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def forward_ct(self, x: torch.Tensor) -> torch.Tensor:
        """Apply on the channel axis of a ``[B, C, T]`` tensor."""
        return self(x.transpose(1, 2)).transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm(dtype=...)``: statistics, scale and shift in
    f32 whatever the input's dtype, output in ``dtype``."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax-matching random init of every parameter of ``model``, drawn
    from ``generator`` in module order."""
    for m in model.modules():
        if isinstance(m, (Conv1d, Conv2d, ConvTranspose1d, Dense)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(m.embedding_dim),
                            generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.reset_parameters()
