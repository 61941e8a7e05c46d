"""Tacotron2-style PostNet for mel refinement.

Counterpart of the JAX package's ``models/postnet.py``: (L−1) × [Conv1D +
BatchNorm + tanh + dropout] then Conv1D → n_mels + BatchNorm, added
residually to the input mel. BatchNorm follows flax with Keras' settings
(momentum 0.99, eps 1e-3): at inference it normalises by the running
statistics; in training (``use_running_average=False``) by the batch's own
statistics over (B, T), and it updates the running statistics by flax's
rule (see :class:`BatchNorm`). ``dtype`` is the compute dtype
(``models/layers.py``); BatchNorm's statistics and running averages stay
f32 in any dtype, as flax's ``BatchNorm(dtype=bfloat16)`` keeps them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import PostNetConfig
from iris_tts_tpu_torch.models.layers import Conv1d, dropout, set_dtype


class BatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm`` on ``[B, C, T]``, with torch's state-dict
    keys (``weight``, ``bias``, ``running_mean``, ``running_var``).

    Batch statistics are flax's: mean over (B, T) and the *biased*
    variance ``E[x²] − E[x]²`` clipped at 0, in f32. The running update is
    ``ra = momentum·ra + (1 − momentum)·batch`` with that biased variance;
    ``torch.nn.BatchNorm1d`` would blend in the unbiased variance instead,
    and converted statistics would drift from the JAX ones step by step.
    The mode is an argument, not ``self.training``, as in flax. The
    normalisation runs in f32 and its output is cast to ``dtype``."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-3, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            mean = xf.mean(dim=(0, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 2)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
                self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)[None, :, None]
        y = (x.float() - mean[None, :, None]) * inv
        y = y * self.weight[None, :, None] + self.bias[None, :, None]
        return y.to(self.dtype)


class PostNet(nn.Module):
    def __init__(self, config: PostNetConfig = PostNetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_hidden = config.num_layers - 1
        self.dropout = config.dropout
        c = config.n_mels
        for i in range(self.num_hidden):
            self.add_module(f"conv_{i}", Conv1d(c, config.channels,
                                                config.kernel_size))
            self.add_module(f"bn_{i}", BatchNorm(config.channels))
            c = config.channels
        self.conv_out = Conv1d(c, config.n_mels, config.kernel_size)
        self.bn_out = BatchNorm(config.n_mels)
        set_dtype(self, dtype)

    def forward(self, mel: torch.Tensor, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel [B, T, n_mels] → refined mel [B, T, n_mels].

        Inference: the defaults. Training: ``deterministic=False`` (dropout
        from ``generator``) and ``use_running_average=False`` (batch
        statistics; the running statistics are updated in place)."""
        h = mel.transpose(1, 2)
        for i in range(self.num_hidden):
            h = getattr(self, f"conv_{i}")(h)
            h = torch.tanh(getattr(self, f"bn_{i}")(h, use_running_average))
            h = dropout(h, self.dropout, deterministic, generator)
        res = self.bn_out(self.conv_out(h), use_running_average)
        return mel + res.transpose(1, 2)
