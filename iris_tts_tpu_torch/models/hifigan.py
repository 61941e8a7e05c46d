"""HiFiGAN generator (inference), channels-first.

Counterpart of the JAX package's ``models/hifigan.py`` (``HiFiGANGenerator``
and ``ResBlock``), with torch padding semantics: convs pad
``(k·d − d) // 2`` per side and the transposed convs crop ``(k − u) // 2``,
so T mel frames become exactly T · prod(upsample_rates) samples.

The convolutions are about 99% of synthesis FLOPs. In the JAX package they
are XLA's own conv lowering (no Pallas kernel), and here they are
``F.conv1d`` / ``F.conv_transpose1d``; f32 must stay f32 on the card, so
callers pin TF32 off (``runtime.pin_f32_math``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.models.layers import Conv1d, ConvTranspose1d

LRELU_SLOPE = 0.1


def _torch_conv(cin: int, cout: int, k: int, dilation: int = 1) -> Conv1d:
    """Conv with torch's explicit same-padding and normal(0.01) init."""
    p = (k * dilation - dilation) // 2
    return Conv1d(cin, cout, k, dilation=dilation, padding=(p, p),
                  init="normal")


class ResBlock(nn.Module):
    """Pairs of (dilated, plain) convs with leaky-relu pre-activations."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}",
                            _torch_conv(channels, channels, kernel_size, d))
            self.add_module(f"convs2_{i}",
                            _torch_conv(channels, channels, kernel_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"convs2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    """conv_pre → N × (upsample → MRF resblock average) → conv_post → tanh.

    Input mel ``[B, T, n_mels]`` (time-major, as the JAX module takes it)
    → waveform ``[B, T · total_upsample]``.
    """

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        cfg = self.config = config
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.num_ups = len(cfg.upsample_rates)
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _torch_conv(cfg.in_channels, c0, 7)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin, ch = c0 // (2 ** i), c0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}",
                            ConvTranspose1d(cin, ch, k, u, init="normal"))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilations)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                ResBlock(ch, rk, tuple(rd)))
        self.conv_post = _torch_conv(c0 // (2 ** self.num_ups), 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.num_ups):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            # Multi-receptive-field fusion: average of the resblock outputs.
            acc = None
            for j in range(self.num_kernels):
                out = getattr(self, f"resblocks_{i * self.num_kernels + j}")(x)
                acc = out if acc is None else acc + out
            x = acc / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0]


def receptive_radius_frames(config: HiFiGANConfig = HiFiGANConfig()) -> int:
    """Upper bound on the generator's receptive-field radius, in mel
    frames: an output sample at time t depends only on mel frames within
    ``radius`` of t / total_upsample.

    This is what makes exact chunked vocoding possible: a chunk computed
    with ``radius`` frames of real context on each side equals the same
    region of a full-utterance pass, because the network is fully
    convolutional (``TTSPipeline.vocode_streaming``).

    Walks the ladder accumulating each layer's radius in output-sample
    units: a dilated conv adds ``(k-1)//2 * d`` current-rate steps; a
    transposed conv adds at most ``ceil(k/u)`` input-rate steps; MRF
    branches run in parallel, so their radius is the max over resblocks of
    the summed sequential pairs. Default topology → 15 frames.
    """
    total_up = config.total_upsample
    spu = total_up  # output samples per step at the current rate
    r = 3 * spu  # conv_pre k=7
    mrf = max(
        sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils)
        for k, dils in zip(config.resblock_kernel_sizes,
                           config.resblock_dilations)
    )
    for u, k in zip(config.upsample_rates, config.upsample_kernel_sizes):
        r += -(-k // u) * spu  # transposed conv, in input-rate steps
        spu //= u
        r += mrf * spu
    r += 3  # conv_post k=7 (spu == 1)
    return -(-r // total_up)


def iter_stream_windows(t: int, chunk_frames: int, context_frames: int):
    """The exact-streaming window plan of ``TTSPipeline.vocode_streaming``:
    one home for the clamping arithmetic that sample-exactness depends on.

    Yields ``(a, b, w0, start_f, start_cl_f)`` per chunk: mel rows [a, b)
    are produced from window ``[w0, w0 + chunk + 2*context)``; the keep
    region starts ``start_f`` frames into the window, and ``start_cl_f`` is
    that start clamped so a fixed-size slice fits (the caller trims the
    difference, in samples, on the host). Windows touching the true mel
    boundaries align to them so layer zero-padding matches a full pass.
    Requires ``t > chunk_frames + 2*context_frames`` (shorter mels fit one
    whole-mel call).
    """
    window = chunk_frames + 2 * context_frames
    for a in range(0, t, chunk_frames):
        b = min(a + chunk_frames, t)
        w0 = min(max(a - context_frames, 0), t - window)
        start_f = a - w0
        start_cl_f = min(start_f, window - chunk_frames)
        yield a, b, w0, start_f, start_cl_f
