"""HiFi-GAN discriminators: multi-period (MPD) + multi-scale (MSD).

Counterpart of the JAX package's ``models/discriminators.py``
(arXiv:2010.05646 §2.3), with its padding conventions:

* MPD: one sub-discriminator per period p ∈ {2,3,5,7,11}; audio is padded
  at its end by repeating the last sample ("edge", torch's ``replicate``) up
  to a multiple of p, reshaped to [T/p, p], and run through 2-D convs with
  (5,1) kernels and (3,1) strides.
* MSD: three sub-discriminators on ×1 / ×2 / ×4 average-pooled audio, each
  a ladder of large-kernel grouped 1-D convs with flax 'SAME' padding
  (asymmetric where the total is odd); the pooling pads with zeros and
  divides by 4 (``count_include_pad``).

Both return (logits, feature maps) for the LSGAN and feature-matching
losses. Audio is [B, T]; the MPD feature maps are [B, C, T/p, p] and the
MSD ones [B, C, T'] (the JAX package keeps channels last). Submodule names
follow the flax tree (``mpd.period_2.conv_0``, ``msd.scale_0.conv_post``).
``dtype`` is the compute dtype of every convolution (``models/layers.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.models.layers import Conv1d, Conv2d, set_dtype

_LRELU = 0.1


class PeriodDiscriminator(nn.Module):
    """One MPD sub-discriminator for a fixed period; ``width`` scales every
    channel count (1.0 = the paper's sizes)."""

    def __init__(self, period: int, width: float = 1.0):
        super().__init__()
        self.period = period
        chans = [max(4, int(c * width)) for c in (32, 128, 512, 1024)]
        cin = 1
        for i, ch in enumerate(chans):
            self.add_module(f"conv_{i}", Conv2d(
                cin, ch, (5, 1), stride=(3, 1), padding=((2, 2), (0, 0))))
            cin = ch
        self.conv_4 = Conv2d(cin, chans[-1], (5, 1),
                             padding=((2, 2), (0, 0)))
        self.conv_post = Conv2d(chans[-1], 1, (3, 1),
                                padding=((1, 1), (0, 0)))

    def forward(self, audio: torch.Tensor):
        """audio [B, T] → (logits [B, L], features list)."""
        p = self.period
        b, t = audio.shape
        pad = (-t) % p
        x = audio
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="replicate")[:, 0]
        x = x.reshape(b, 1, (t + pad) // p, p)
        feats: List[torch.Tensor] = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), _LRELU)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        # Flatten in the JAX (T/p, p) order: channels are 1 here.
        return x.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """One MSD sub-discriminator; ``width`` scales every channel count."""

    def __init__(self, width: float = 1.0):
        super().__init__()

        def c(n):  # scaled channels, kept divisible by the largest group
            return max(16, int(n * width) // 16 * 16)

        specs = [
            # (features, kernel, stride, groups)
            (c(128), 15, 1, 1),
            (c(128), 41, 2, 4),
            (c(256), 41, 2, 16),
            (c(512), 41, 4, 16),
            (c(1024), 41, 4, 16),
            (c(1024), 41, 1, 16),
            (c(1024), 5, 1, 1),
        ]
        self.num_convs = len(specs)
        cin = 1
        for i, (ch, k, s, g) in enumerate(specs):
            self.add_module(f"conv_{i}", Conv1d(cin, ch, k, stride=s,
                                                groups=g))
            cin = ch
        self.conv_post = Conv1d(cin, 1, 3)

    def forward(self, audio: torch.Tensor):
        """audio [B, T] → (logits [B, L], features list)."""
        x = audio[:, None]
        feats: List[torch.Tensor] = []
        for i in range(self.num_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), _LRELU)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x[:, 0], feats


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """HiFi-GAN's AvgPool1d(4, 2, 2) on [B, T]: zero padding counted in the
    divisor, as flax ``avg_pool``."""
    return F.avg_pool1d(x[:, None], 4, 2, 2, count_include_pad=True)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 width: float = 1.0):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p, width))

    def forward(self, audio: torch.Tensor):
        logits, feats = [], []
        for p in self.periods:
            l, f = getattr(self, f"period_{p}")(audio)
            logits.append(l)
            feats.append(f)
        return logits, feats


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3, width: float = 1.0):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"scale_{i}", ScaleDiscriminator(width))

    def forward(self, audio: torch.Tensor):
        logits, feats = [], []
        x = audio
        for i in range(self.num_scales):
            if i > 0:
                x = avg_pool2(x)
            l, f = getattr(self, f"scale_{i}")(x)
            logits.append(l)
            feats.append(f)
        return logits, feats


class HiFiGANDiscriminators(nn.Module):
    """MPD + MSD under one set of params (one optimizer, as in the paper's
    combined discriminator loss). Full width by default."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 num_scales: int = 3, width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, width)
        self.msd = MultiScaleDiscriminator(num_scales, width)
        set_dtype(self, dtype)

    def forward(self, audio: torch.Tensor):
        mpd_logits, mpd_feats = self.mpd(audio)
        msd_logits, msd_feats = self.msd(audio)
        return mpd_logits + msd_logits, mpd_feats + msd_feats
