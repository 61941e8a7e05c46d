"""Torch HiFi-GAN oracle: an independent torch implementation of the
standard published HiFi-GAN generator (weight-normed ``Conv1d`` /
``ConvTranspose1d`` with torch padding), a copy of the JAX package's
``convert/torch_oracle.py``. It only produces golden outputs for the
converter's checks (the parity tests, ``scripts/verify_reference_artifacts``
and ``scripts/hifigan_integration``), never on a serving or training path:
its state dict has the published layout (``conv_pre``, ``ups.N``,
``resblocks.N.convs{1,2}.M``, ``conv_post``, weight-norm ``weight_g`` /
``weight_v``), which ``convert/hifigan_torch.py`` folds into the port's
:class:`~iris_tts_tpu_torch.models.hifigan.HiFiGANGenerator`.
"""

from __future__ import annotations

import torch
import torch.nn as tnn
import torch.nn.functional as tF

from iris_tts_tpu_torch.config import HiFiGANConfig


def _wn(mod):
    return tnn.utils.weight_norm(mod)


class TorchResBlock(tnn.Module):
    def __init__(self, ch, k, dils):
        super().__init__()
        self.convs1 = tnn.ModuleList(
            [
                _wn(tnn.Conv1d(ch, ch, k, dilation=d,
                               padding=(k * d - d) // 2))
                for d in dils
            ]
        )
        self.convs2 = tnn.ModuleList(
            [_wn(tnn.Conv1d(ch, ch, k, padding=(k - 1) // 2)) for _ in dils]
        )

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = tF.leaky_relu(x, 0.1)
            xt = c1(xt)
            xt = tF.leaky_relu(xt, 0.1)
            xt = c2(xt)
            x = xt + x
        return x


class TorchGenerator(tnn.Module):
    """The full MRF generator; state-dict-compatible with the published
    HiFi-GAN layout (conv_pre / ups.N / resblocks.N / conv_post). Input
    ``[B, n_mels, T]``, output ``[B, 1, T · hop]``."""

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_pre = _wn(
            tnn.Conv1d(cfg.in_channels, cfg.upsample_initial_channel, 7,
                       padding=3)
        )
        self.ups = tnn.ModuleList()
        for i, (u, k) in enumerate(
            zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)
        ):
            self.ups.append(
                _wn(
                    tnn.ConvTranspose1d(
                        cfg.upsample_initial_channel // (2**i),
                        cfg.upsample_initial_channel // (2 ** (i + 1)),
                        k,
                        u,
                        padding=(k - u) // 2,
                    )
                )
            )
        self.resblocks = tnn.ModuleList()
        for i in range(len(self.ups)):
            ch = cfg.upsample_initial_channel // (2 ** (i + 1))
            for k, d in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilations):
                self.resblocks.append(TorchResBlock(ch, k, list(d)))
        self.conv_post = _wn(tnn.Conv1d(ch, 1, 7, padding=3))

    def forward(self, x):
        nk = len(self.cfg.resblock_kernel_sizes)
        x = self.conv_pre(x)
        for i in range(len(self.ups)):
            x = tF.leaky_relu(x, 0.1)
            x = self.ups[i](x)
            xs = None
            for j in range(nk):
                out = self.resblocks[i * nk + j](x)
                xs = out if xs is None else xs + out
            x = xs / nk
        x = tF.leaky_relu(x, 0.1)
        return torch.tanh(self.conv_post(x))
