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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

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
                 init: str = "lecun"):
        super().__init__()
        if isinstance(padding, str) and padding.upper() != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        if init not in ("lecun", "zeros", "normal"):
            raise ValueError(f"unknown init {init!r}")
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
        return conv1d(x, self.weight, self.bias, stride=self.stride,
                      dilation=self.dilation, padding=pad, groups=self.groups)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv with torch semantics (crop = (K−u)//2 → T_out =
    T·u). Weight ``[C_in, C_out, K]`` in true-convolution orientation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, init: str = "lecun"):
        super().__init__()
        if init not in ("lecun", "normal"):
            raise ValueError(f"unknown init {init!r}")
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
        return conv_transpose1d(x, self.weight, self.bias, stride=self.stride)


class Conv2d(nn.Module):
    """2-D conv on ``[B, C, H, W]`` with explicit ((top, bottom), (left,
    right)) padding; weight ``[C_out, C_in, kh, kw]``, flax lecun init."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride=(1, 1),
                 padding=((0, 0), (0, 0))):
        super().__init__()
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
        return F.conv2d(F.pad(x, self.pad), self.weight, self.bias,
                        stride=self.stride)


class Dense(nn.Linear):
    """``flax.linen.Dense`` on the last axis; ``zero_init`` for the heads
    the JAX modules initialise to zero."""

    def __init__(self, in_features: int, out_features: int,
                 zero_init: bool = False):
        self.zero_init = zero_init  # read by reset_parameters() in __init__
        super().__init__(in_features, out_features)

    def reset_parameters(self, generator=None) -> None:
        # nn.Linear.__init__ calls this with no generator; the model-level
        # init_params() calls it again with one.
        if self.zero_init or generator is None:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward_ct(self, x: torch.Tensor) -> torch.Tensor:
        """Apply on the channel axis of a ``[B, C, T]`` tensor."""
        return F.linear(x.transpose(1, 2), self.weight,
                        self.bias).transpose(1, 2)


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
