"""HiFiGAN generator (inference), channels-first.

Counterpart of the JAX package's ``models/hifigan.py`` (``HiFiGANGenerator``
and ``ResBlock``), with torch padding semantics: convs pad
``(k·d − d) // 2`` per side and the transposed convs crop ``(k − u) // 2``,
so T mel frames become exactly T · prod(upsample_rates) samples.

The convolutions are about 99% of synthesis FLOPs. In the JAX package they
are XLA's own conv lowering (no Pallas kernel). Here ``conv_pre``, the
upsamplers and ``conv_post`` are cuDNN's ``F.conv1d`` /
``F.conv_transpose1d``, f32 with TF32 off (callers pin it,
``runtime.pin_math_precision``). The MRF stages of 8 to 256 channels
(every stage of V1 and V2) run hand-written f32 CUDA kernels, with the
leaky ReLUs, residual adds, the MRF average and the next leaky ReLU in
their prologues and epilogues (``ops/mrf_cuda.py``: one launch a resblock
layer at 8 and 16 channels, an implicit GEMM a conv at 32-256), on a CUDA
float32 input with gradients off outside export tracing, where a stage the
kernel has no plan for (another width, kernel size or dilation) raises;
anywhere else (gradients on, bf16, export, sharded convs, the CPU) they
run the library's composition. Every stage returns the leaky ReLU of its
average, the only form the next layer reads.

``dtype`` is the compute dtype (``models/layers.py``); the waveform comes
out in it. ``remat=True`` recomputes each MRF ``ResBlock``'s activations
in the backward pass (the resblocks run at the upsampled rate, so they
hold most of the GAN stage's activation memory), as the JAX generator's
``nn.remat(ResBlock)``; with gradients off it changes nothing.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    checkpoint_block,
    init_params,
    set_dtype,
)
from iris_tts_tpu_torch.ops.amp_cuda import HALO
from iris_tts_tpu_torch.ops.mrf_cuda import (
    LRELU_SLOPE,
    block_refusal,
    fused_mrf_applies,
    mrf_plain,
    mrf_stage,
)
from iris_tts_tpu_torch.runtime import (
    DeviceLike,
    DtypeLike,
    pin_math_precision,
    resolve_device,
    resolve_dtype,
    seeded_generator,
)
from iris_tts_tpu_torch.utils import prof


class TorchConv1d(Conv1d):
    """1-D convolution with torch's explicit same-padding ``(k·d − d) // 2``
    on each side and HiFiGAN's normal(0.01) init; weight ``[C_out, C_in,
    K]``, torch's own layout (the JAX module stores ``[K, C_in, C_out]``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        p = (kernel_size * dilation - dilation) // 2
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, dilation=dilation, padding=(p, p),
                         init="normal", dtype=dtype, bias=bias)


class TorchConvTranspose1d(ConvTranspose1d):
    """Transposed 1-D convolution as torch's ``ConvTranspose1d`` with
    ``padding=(k − u) // 2``: ``T · u`` samples out when ``k − u`` is even
    (the upsampler contract); normal(0.01) init; weight ``[C_in, C_out,
    K]`` in true-convolution orientation, torch's own layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         init="normal", dtype=dtype)


class ResBlock(nn.Module):
    """Pairs of (dilated, plain) convs with leaky-relu pre-activations."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Tuple[int, ...]):
        super().__init__()
        self.n = len(dilations)
        # Why the MRF kernel cannot run this block, or None.
        self.kernel_refusal = block_refusal(channels, kernel_size, dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}",
                            TorchConv1d(channels, channels, kernel_size, d))
            self.add_module(f"convs2_{i}",
                            TorchConv1d(channels, channels, kernel_size, 1))

    def layers(self) -> List[Tuple[TorchConv1d, TorchConv1d]]:
        """Each layer's (dilated conv, plain conv), in order."""
        return [(getattr(self, f"convs1_{i}"), getattr(self, f"convs2_{i}"))
                for i in range(self.n)]

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

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if config.activation != "leaky_relu":
            raise ValueError(f"HiFiGAN's generator takes leaky ReLU, not "
                             f"{config.activation!r}; a 'snakebeta' config "
                             f"is BigVGAN's (models/bigvgan.py)")
        cfg = self.config = config
        self.remat = remat
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.num_ups = len(cfg.upsample_rates)
        c0 = cfg.upsample_initial_channel
        self.conv_pre = TorchConv1d(cfg.in_channels, c0, 7)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin, ch = c0 // (2 ** i), c0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}", TorchConvTranspose1d(cin, ch, k, u))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilations)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                ResBlock(ch, rk, tuple(rd)))
        self.conv_post = TorchConv1d(c0 // (2 ** self.num_ups), 1, 7)
        set_dtype(self, dtype)

    def mrf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``i``'s multi-receptive-field fusion of the upsampled ``x``:
        the leaky ReLU of the average of its resblocks' outputs. The kernel
        where ``ops.mrf_cuda.fused_mrf_applies`` holds (it raises for f32
        inference on the card on blocks the kernel has no plan for), else
        the library's convs (each block recomputed in the backward pass
        under remat).
        While a profiler records, counts the stage's resblock layers as
        ``vocoder.fused_layers`` or ``vocoder.library_layers``."""
        blocks = [getattr(self, f"resblocks_{i * self.num_kernels + j}")
                  for j in range(self.num_kernels)]
        n_layers = sum(block.n for block in blocks)
        if fused_mrf_applies(x, blocks):
            prof.count("vocoder.fused_layers", n_layers)
            return mrf_stage(x, blocks)
        prof.count("vocoder.library_layers", n_layers)
        if self.remat and torch.is_grad_enabled():
            blocks = [functools.partial(checkpoint_block, b) for b in blocks]
        return mrf_plain(x, blocks)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv_pre(mel.transpose(1, 2)), LRELU_SLOPE)
        for i in range(self.num_ups):
            x = self.mrf(i, getattr(self, f"ups_{i}")(x))
        return torch.tanh(self.conv_post(x))[:, 0]


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
    the summed sequential pairs. BigVGAN's anti-aliased activations
    (``activation="snakebeta"``: two a resblock layer and one before
    ``conv_post``) add ``ops.amp_cuda.HALO`` current-rate steps each: Up's
    6-tap phases and Down's 12 taps at twice the rate reach 5 input samples
    a side. Default topology → 15 frames.
    """
    act = HALO if config.activation == "snakebeta" else 0
    total_up = config.total_upsample
    spu = total_up  # output samples per step at the current rate
    r = 3 * spu  # conv_pre k=7
    mrf = max(
        sum((k - 1) // 2 * d + (k - 1) // 2 + 2 * act for d in dils)
        for k, dils in zip(config.resblock_kernel_sizes,
                           config.resblock_dilations)
    )
    for u, k in zip(config.upsample_rates, config.upsample_kernel_sizes):
        r += -(-k // u) * spu  # transposed conv, in input-rate steps
        spu //= u
        r += mrf * spu
    r += act + 3  # activation_post, conv_post k=7 (spu == 1)
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


# ---------------------------------------------------------------------------
# Convenience wrappers (API parity with the reference)
# ---------------------------------------------------------------------------


class HiFiGANVocoder:
    """A generator with its weights on one device, called on mels in the
    reference layout: ``[n_mels, T]`` → ``[T · hop]``, ``[B, n_mels, T]`` →
    ``[B, T · hop]`` (the JAX package's ``HiFiGANVocoder.__call__``).

    ``params`` is a :class:`HiFiGANGenerator` state dict (port format,
    e.g. from ``convert/from_jax.py``). ``device`` defaults to the CUDA
    device and raises without one; ``dtype`` is the compute dtype (params
    stay f32). The waveform comes back as a tensor on ``device`` in the
    compute dtype.
    """

    def __init__(self, params: Dict[str, torch.Tensor],
                 config: HiFiGANConfig = HiFiGANConfig(),
                 dtype: DtypeLike = None, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        pin_math_precision()
        module = HiFiGANGenerator(config)
        module.load_state_dict(params, strict=True)
        self.module = set_dtype(module.to(self.device).eval(), self.dtype)
        for p in self.module.parameters():
            p.requires_grad_(False)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.module.state_dict()

    @torch.inference_mode()
    def __call__(self, mel) -> torch.Tensor:
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.asarray(mel, np.float32))
        mel = mel.to(self.device, torch.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        audio = self.module(mel.transpose(-1, -2).contiguous())
        return audio[0] if squeeze else audio

    infer = __call__


def create_vocoder(config: HiFiGANConfig = HiFiGANConfig(), seed: int = 0,
                   dtype: DtypeLike = None,
                   device: DeviceLike = None) -> HiFiGANVocoder:
    """A vocoder with seeded random weights (the flax-matching init drawn
    from a ``torch.Generator`` seeded with ``seed``)."""
    module = HiFiGANGenerator(config)
    init_params(module, seeded_generator(seed, "cpu"))
    return HiFiGANVocoder(module.state_dict(), config, dtype=dtype,
                          device=device)
