"""BigVGAN-v2's generator (inference), channels-first.

NVIDIA/BigVGAN's ``bigvgan.py`` with ``resblock "1"`` and
``activation "snakebeta"`` (``AMPBlock1``, ``alias_free_activation``): the
vocoder of ``bigvgan_v2_22khz_80band_fmax8k_256x`` and its siblings, built
from :class:`~iris_tts_tpu_torch.config.HiFiGANConfig` with
``activation="snakebeta"``. It takes the pipeline's mel as HiFiGAN does,
``[B, T, n_mels]`` → ``[B, T · prod(upsample_rates)]``:

    conv_pre → N × (ups[i] → mean of AMPBlock1_k) → activation_post
    → conv_post (no bias) → clamp(−1, 1)

with no activation before ``ups[i]``. An ``AMPBlock1`` layer is
``x + conv2(A2(conv1(A1(x))))``, each ``A`` an anti-aliased SnakeBeta
(:class:`Activation1d`) with its own per-channel α and β, stored as
logarithms. ``activation="snakebeta"`` states the v2 keys of the source's
config with it: ``snake_logscale`` true, ``use_tanh_at_final`` and
``use_bias_at_final`` false; the port builds no other variant.

Module names are NVIDIA's, with weight norm folded into ``weight``, so a
state dict reads ``conv_pre.weight``, ``ups.<i>.0.weight``,
``resblocks.<n>.convs1.<j>.weight``,
``resblocks.<n>.activations.<m>.act.alpha`` / ``.beta``,
``activation_post.act.alpha``, ``conv_post.weight``
(``convert/bigvgan.py`` folds a published checkpoint into it). The
anti-aliasing filter is a buffer left out of the state dict: it is fixed by
the formula (``ops.amp_cuda.FILTER``).

The convolutions are cuDNN's (``TorchConv1d``, ``TorchConvTranspose1d``),
f32 with TF32 off (callers pin it). Off the CPU each activation runs the
hand-written kernel (``ops/amp_cuda.py``, one launch), which raises for
anything but float32 inference; on the CPU, the plain composition. While a
profiler records, each activation opens ``iris.amp_act`` and counts
``vocoder.amp_fused`` or ``vocoder.amp_library`` (``utils/prof.py``).

Not supported: remat and tensor-parallel sharding (both raise), and on the
card gradients, bf16 and export (the kernel raises).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    TorchConv1d,
    TorchConvTranspose1d,
)
from iris_tts_tpu_torch.models.layers import set_dtype
from iris_tts_tpu_torch.ops.amp_cuda import FILTER, amp_cuda, amp_plain
from iris_tts_tpu_torch.utils import prof

# Scale of the drawn log-α and log-β: BigVGAN initialises them to zero
# (α = β = 1 on every channel), under which a mix-up of channels or of α
# and β would change nothing; a seeded model draws them instead.
SNAKE_LOG_STD = 0.5


class SnakeBeta(nn.Module):
    """Per-channel ``alpha`` and ``beta``, stored as logarithms, read by
    :class:`Activation1d`."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def draw_params(self, generator: torch.Generator) -> None:
        """A seeded model's draw (``layers.init_params``): log-α and log-β
        from N(0, :data:`SNAKE_LOG_STD`)."""
        with torch.no_grad():
            for p in (self.alpha, self.beta):
                p.normal_(0.0, SNAKE_LOG_STD, generator=generator)


class Activation1d(nn.Module):
    """BigVGAN's anti-aliased activation: ``Down(SnakeBeta(Up(x)))``, 2×
    up and down by the 12-tap low-pass filter, in ``x``'s dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.register_buffer("filter", FILTER.clone(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.act
        with prof.span("amp_act"):
            if x.device.type == "cpu":
                prof.count("vocoder.amp_library")
                return amp_plain(x, a.alpha, a.beta, self.filter)
            prof.count("vocoder.amp_fused")
            return amp_cuda(x, a.alpha, a.beta)


class AMPBlock1(nn.Module):
    """``len(dilations)`` layers ``x + conv2(A2(conv1(A1(x))))``; conv1
    dilated, conv2 not; activations ``2j`` and ``2j + 1`` are layer
    ``j``'s A1 and A2, as NVIDIA indexes them."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            TorchConv1d(channels, channels, kernel_size, d)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            TorchConv1d(channels, channels, kernel_size, 1)
            for _ in dilations)
        self.activations = nn.ModuleList(
            Activation1d(channels) for _ in range(2 * len(dilations)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = self.activations
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            x = c2(acts[2 * j + 1](c1(acts[2 * j](x)))) + x
        return x


def generator_class(config: HiFiGANConfig) -> type:
    """The generator that ``config`` states: :class:`BigVGANGenerator`
    for ``activation="snakebeta"``, else HiFiGAN's."""
    if config.activation == "snakebeta":
        return BigVGANGenerator
    return HiFiGANGenerator


class BigVGANGenerator(nn.Module):
    """BigVGAN-v2's generator: mel ``[B, T, n_mels]`` → waveform
    ``[B, T · total_upsample]``."""

    tp_refusal = "BigVGAN has no tensor-parallel path (model axis > 1)"

    def __init__(self, config: HiFiGANConfig,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if config.activation != "snakebeta":
            raise ValueError(f"BigVGAN takes activation 'snakebeta', not "
                             f"{config.activation!r}")
        if remat:
            raise ValueError("BigVGAN has no remat path")
        self.config = cfg = config
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        c0 = cfg.upsample_initial_channel
        self.conv_pre = TorchConv1d(cfg.in_channels, c0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ModuleList(
                [TorchConvTranspose1d(c0 // 2 ** i, ch, k, u)]))
            self.resblocks.extend(
                AMPBlock1(ch, rk, tuple(rd))
                for rk, rd in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilations))
        ch = c0 // 2 ** len(cfg.upsample_rates)
        self.activation_post = Activation1d(ch)
        self.conv_post = TorchConv1d(ch, 1, 7, bias=False)
        set_dtype(self, dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up[0](x)
            acc = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                out = block(x)
                acc = out if acc is None else acc + out
            x = acc / n
        x = self.conv_post(self.activation_post(x))
        return torch.clamp(x, -1.0, 1.0)[:, 0]
