"""Tacotron2-style PostNet for mel refinement (inference).

Counterpart of the JAX package's ``models/postnet.py``: (L−1) × [Conv1D +
BatchNorm + tanh] then Conv1D → n_mels + BatchNorm, added residually to the
input mel. BatchNorm uses the running statistics (flax ``batch_stats``)
with Keras' eps 1e-3; flax momentum 0.99 is torch momentum 0.01.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import PostNetConfig
from iris_tts_tpu_torch.models.layers import Conv1d


def _batch_norm(channels: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(channels, eps=1e-3, momentum=0.01)


class PostNet(nn.Module):
    def __init__(self, config: PostNetConfig = PostNetConfig()):
        super().__init__()
        self.num_hidden = config.num_layers - 1
        c = config.n_mels
        for i in range(self.num_hidden):
            self.add_module(f"conv_{i}", Conv1d(c, config.channels,
                                                config.kernel_size))
            self.add_module(f"bn_{i}", _batch_norm(config.channels))
            c = config.channels
        self.conv_out = Conv1d(c, config.n_mels, config.kernel_size)
        self.bn_out = _batch_norm(config.n_mels)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels] → refined mel [B, T, n_mels]. Call in eval
        mode (running statistics)."""
        h = mel.transpose(1, 2)
        for i in range(self.num_hidden):
            h = getattr(self, f"conv_{i}")(h)
            h = torch.tanh(getattr(self, f"bn_{i}")(h))
        res = self.bn_out(self.conv_out(h))
        return mel + res.transpose(1, 2)
