"""PortaSpeech-style text-conditioned VAE with a volume-preserving flow.

Counterpart of the JAX package's ``models/vae.py``: the training path
(:meth:`TextConditionedVAE.forward`: posterior encode, reparameterised
sample, flow, decode) and the inference path
(:meth:`TextConditionedVAE.generate`: inverse flow on a prior sample, then
decode). Internally the tensors are channels-first ``[B, C, T]``; the public
methods take and return the JAX package's time-major ``[B, T, C]``.

Flax ``nn.gelu`` is the tanh approximation, hence ``approximate="tanh"``
throughout.

``dtype`` is the compute dtype of every submodule (``models/layers.py``).
The posterior and prior noise is drawn in f32 from the explicit generator
and rounded to the compute dtype, where JAX draws it in that dtype
(``vae.py:335,374``); the two packages' draws differ anyway. ``remat=True``
recomputes each WaveNet block's activations in the backward pass
(``layers.checkpoint_block``, dropout masks replayed), as the JAX VAE's
``nn.remat`` blocks do; with gradients off it changes nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.config import VAEConfig
from iris_tts_tpu_torch.models.layers import (
    Conv1d,
    Dense,
    checkpoint_block,
    dropout,
    set_dtype,
)
from iris_tts_tpu_torch.parallel.mesh import draw_rows


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class FiLM(nn.Module):
    """y = gamma(cond) * x + beta(cond), on ``[B, C, T]``."""

    def __init__(self, cond_dim: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(cond_dim, 2 * channels, dtype=dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.proj.forward_ct(cond).chunk(2, dim=1)
        return gamma * x + beta


class WaveNetResBlock(nn.Module):
    """x + res_proj(dropout(FiLM(gelu(dilated_conv(x)), cond)))."""

    def __init__(self, channels: int, cond_dim: int, kernel_size: int,
                 dilation: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.conv = Conv1d(channels, channels, kernel_size, dilation=dilation)
        self.film = FiLM(cond_dim, channels)
        self.res_proj = Conv1d(channels, channels, 1)
        set_dtype(self, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.film(_gelu(self.conv(x)), cond)
        h = dropout(h, self.dropout, deterministic, generator)
        return x + self.res_proj(h)


class TemporalDownsample(nn.Module):
    """num_stages × [stride-2 'SAME' conv → GELU]: T → T / 2**num_stages.
    An odd total pad goes on the right, as XLA's 'SAME' puts it."""

    def __init__(self, in_channels: int, channels: int, num_stages: int = 2,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = num_stages
        for i in range(num_stages):
            self.add_module(f"conv_{i}", Conv1d(
                in_channels if i == 0 else channels, channels, kernel_size,
                stride=2, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_stages):
            x = _gelu(getattr(self, f"conv_{i}")(x))
        return x


class TemporalUpsample(nn.Module):
    """num_stages × [repeat-2× → conv → GELU]."""

    def __init__(self, channels: int, num_stages: int = 2,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = num_stages
        for i in range(num_stages):
            self.add_module(f"conv_{i}", Conv1d(channels, channels,
                                                kernel_size, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_stages):
            x = torch.repeat_interleave(x, 2, dim=2)
            x = _gelu(getattr(self, f"conv_{i}")(x))
        return x


class APCoupling(nn.Module):
    """Additive coupling (volume-preserving) with a FiLM-modulated
    translation; the output conv is zero-initialised."""

    def __init__(self, channels: int, hidden_channels: int, cond_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = channels // 2
        self.cond_proj = Dense(cond_dim, half)
        self.net_pre = Conv1d(half, hidden_channels, 3)
        self.net_post = Conv1d(hidden_channels, half, 1, init="zeros")
        self.film = FiLM(half, half)
        set_dtype(self, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        cond_embed = _gelu(self.cond_proj.forward_ct(cond))
        h = _gelu(self.net_pre(x1 + cond_embed))
        t = self.film(self.net_post(h), cond_embed)
        y2 = x2 - t if reverse else x2 + t
        return torch.cat([x1, y2], dim=1)


class VolumePreservingFlow(nn.Module):
    """Stack of additive couplings; exactly invertible."""

    def __init__(self, channels: int, num_layers: int, hidden_channels: int,
                 cond_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"ap_{i}", APCoupling(channels, hidden_channels,
                                                  cond_dim, dtype))

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        order = range(self.num_layers)
        for i in (reversed(order) if reverse else order):
            x = getattr(self, f"ap_{i}")(x, cond, reverse=reverse)
        return x


def reparameterize(mean: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """The posterior sample ``z = mean + exp(logvar / 2) · eps``."""
    return mean + torch.exp(0.5 * logvar) * eps


class TextConditionedVAE(nn.Module):
    """Triple-conditioned VAE: ``forward`` is the training path,
    ``generate`` the inference path."""

    def __init__(self, config: VAEConfig = VAEConfig(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        cfg = self.config = config
        self.remat = remat
        c, k = cfg.model_channels, cfg.wavenet_kernel_size
        self.in_proj = Conv1d(cfg.n_mels, c, 1)
        for i in range(cfg.num_wavenet_blocks):
            self.add_module(f"enc_block_{i}", WaveNetResBlock(
                c, cfg.cond_dim, k, dilation=2 ** (i % 4),
                dropout=cfg.dropout))
        self.downsample = TemporalDownsample(c, c, cfg.down_stages, 5)
        self.down_cond_proj = Conv1d(cfg.cond_dim, c, 1)
        self.latent_mean_proj = Dense(c, cfg.latent_dim)
        self.latent_logvar_proj = Dense(c, cfg.latent_dim, zero_init=True)
        self.vpflow = VolumePreservingFlow(cfg.latent_dim, cfg.flow_layers,
                                           cfg.flow_hidden, c)
        self.latent_dec_proj = Dense(cfg.latent_dim, c)
        for i in range(cfg.decoder_blocks):
            self.add_module(f"dec_block_{i}", WaveNetResBlock(
                c, c, k, dilation=2 ** (i % 4), dropout=cfg.dropout))
        self.upsample = TemporalUpsample(c, cfg.down_stages, 5)
        self.out_proj = Conv1d(c, cfg.n_mels, 1)
        self.residual_proj = Dense(c, cfg.cond_dim)
        set_dtype(self, dtype)

    def _block(self, name: str, x, cond, deterministic, generator):
        """One WaveNet block, under remat when it is on and gradients are
        recorded."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint_block(block, x, cond, deterministic,
                                    generator=generator)
        return block(x, cond, deterministic, generator)

    def latent_cond(self, frame_cond_ct: torch.Tensor) -> torch.Tensor:
        """Frame-rate cond [B, cond, T] → latent-rate cond [B, C, T']."""
        return self.downsample(self.down_cond_proj(frame_cond_ct))

    def decode(self, z_ct: torch.Tensor, lat_cond: torch.Tensor,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent [B, latent, T'] → (mel [B, n_mels, T], residual
        [B, cond, T])."""
        d = self.latent_dec_proj.forward_ct(z_ct)
        for i in range(self.config.decoder_blocks):
            d = self._block(f"dec_block_{i}", d, lat_cond, deterministic,
                            generator)
        d_up = self.upsample(d)
        return self.out_proj(d_up), self.residual_proj.forward_ct(d_up)

    def forward(
        self,
        mel: torch.Tensor,
        frame_cond: torch.Tensor,
        deterministic: bool = True,
        return_u: bool = False,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Posterior encode + reconstruct (the training path).

        Args:
            mel: [B, T, n_mels] target mel (time-major).
            frame_cond: [B, T, cond_dim] frame-aligned text conditioning.
            deterministic: True → z is the posterior mean and dropout is
                off; False → ``z = mean + exp(logvar/2)·eps`` with ``eps``
                drawn from ``generator`` unless given ([B, T', latent]).
            return_u: also return ``u = flow(z)``, the flow-prior image of
                the sample (the ``flow_prior`` training objective).
        Returns:
            recon [B, T, n_mels], (mean, logvar) [B, T', latent], residual
            [B, T, cond_dim] — plus ``u`` [B, T', latent] when ``return_u``.
        """
        cfg = self.config
        h = self.in_proj(mel.transpose(1, 2))
        for i in range(cfg.num_wavenet_blocks):
            h = self._block(f"enc_block_{i}", h, frame_cond.transpose(1, 2),
                            deterministic, generator)
        lat_cond = self.latent_cond(frame_cond.transpose(1, 2))
        lat_h = self.downsample(h)
        mean = self.latent_mean_proj.forward_ct(lat_h)
        logvar = self.latent_logvar_proj.forward_ct(lat_h)
        if deterministic and eps is None:
            z = mean
        else:
            if eps is None:
                # the global batch's draw in a data-parallel step
                eps = draw_rows(mean.shape, generator, mean.device,
                                normal=True).to(mean.dtype)
            else:
                eps = eps.transpose(1, 2)
            z = reparameterize(mean, logvar, eps)
        u = self.vpflow(z, lat_cond)
        # flow_prior decodes the posterior sample itself (the space
        # generate() decodes); reference mode decodes flow(z).
        z_dec = z if cfg.flow_prior else u
        recon, residual = self.decode(z_dec, lat_cond, deterministic,
                                      generator)
        out = (recon.transpose(1, 2),
               (mean.transpose(1, 2), logvar.transpose(1, 2)),
               residual.transpose(1, 2))
        return out + (u.transpose(1, 2),) if return_u else out

    def generate(
        self,
        frame_cond: torch.Tensor,
        z_prior: Optional[torch.Tensor] = None,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prior sample → inverse flow → decode.

        Args:
            frame_cond: [B, T, cond_dim]; T divisible by the down factor.
            z_prior: optional [B, T', latent_dim] latent; when None it is
                ``temperature`` × a standard normal drawn from
                ``generator``.
        Returns:
            mel [B, T, n_mels], residual [B, T, cond_dim].
        """
        lat_cond = self.latent_cond(frame_cond.transpose(1, 2))
        if z_prior is None:
            b, tp = lat_cond.shape[0], lat_cond.shape[2]
            z = temperature * torch.randn(
                (b, self.config.latent_dim, tp), generator=generator,
                device=lat_cond.device).to(lat_cond.dtype)
        else:
            z = z_prior.transpose(1, 2)
        z = self.vpflow(z, lat_cond, reverse=True)
        mel, residual = self.decode(z, lat_cond)
        return mel.transpose(1, 2), residual.transpose(1, 2)
