"""Masked training losses.

Counterpart of the JAX package's ``ops/losses.py``, with the same masking
and denominator conventions. Every reduction is in f32 whatever the dtype
of its inputs: a low-precision sum over thousands of elements loses mass,
skewing both the logged metric and the 1/sum(mask) gradient scale.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def duration_huber_loss(
    pred_log_durations: torch.Tensor,
    target_durations: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    delta: float = 10.0,
) -> torch.Tensor:
    """Huber loss on durations in linear space: predictions are the
    duration head's softplus outputs read as log(d+1) and inverted with
    ``exp(p) - 1``; Huber with ``delta`` in frames; masked mean with a +1e-8
    denominator guard.

    Args:
        pred_log_durations: [B, P] or [B, P, 1] head outputs.
        target_durations: [B, P] ground-truth frame counts (float).
        mask: optional [B, P] validity mask.
    """
    if pred_log_durations.dim() == target_durations.dim() + 1:
        pred_log_durations = pred_log_durations[..., 0]
    pred = torch.exp(pred_log_durations.float()) - 1.0
    diff = pred - target_durations.float()
    abs_diff = diff.abs()
    huber = torch.where(abs_diff <= delta, 0.5 * diff.square(),
                        delta * (abs_diff - 0.5 * delta))
    if mask is not None:
        mask = mask.to(huber.dtype)
        return torch.sum(huber * mask) / (torch.sum(mask) + 1e-8)
    return huber.mean()


def masked_l1_loss(
    target: torch.Tensor,
    pred: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked mean-absolute-error over mel frames; the denominator is
    ``sum(mask) * n_mels + 1e-6``.

    Args:
        target/pred: [B, T, n_mels] (time-major layout).
        frame_mask: optional [B, T].
    """
    diff = (target.float() - pred.float()).abs()
    if frame_mask is not None:
        m = frame_mask.to(diff.dtype)[..., None]  # [B, T, 1]
        return torch.sum(diff * m) / (torch.sum(m) * diff.shape[-1] + 1e-6)
    return diff.mean()


def kl_divergence(
    mean: torch.Tensor,
    logvar: torch.Tensor,
    latent_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(N(mean, exp(logvar)) || N(0, I)), masked mean with a
    ``sum(mask) + 1e-8`` denominator.

    Args:
        mean/logvar: [B, T', latent_dim].
        latent_mask: optional [B, T'].
    """
    mean, logvar = mean.float(), logvar.float()
    kl = -0.5 * (1.0 + logvar - mean.square() - torch.exp(logvar))
    if latent_mask is not None:
        m = latent_mask.to(kl.dtype)[..., None]  # [B, T', 1]
        return torch.sum(kl * m) / (torch.sum(m) + 1e-8)
    return kl.mean()


def flow_prior_kl(
    mean: torch.Tensor,
    logvar: torch.Tensor,
    u: torch.Tensor,
    latent_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Monte-Carlo KL(q(z|x) ‖ p_flow(z)) for the flow-prior VAE: with one
    posterior sample z and u = flow(z) (unit Jacobian),
    KL ≈ −½Σ(1+logvar) + ½Σu² per masked position. ``mean`` enters through
    ``u``."""
    del mean
    logvar, u = logvar.float(), u.float()
    kl = 0.5 * u.square() - 0.5 * (1.0 + logvar)
    if latent_mask is not None:
        m = latent_mask.to(kl.dtype)[..., None]
        return torch.sum(kl * m) / (torch.sum(m) + 1e-8)
    return kl.mean()


def vae_loss(
    target_mel: torch.Tensor,
    recon_mel: torch.Tensor,
    mean: torch.Tensor,
    logvar: torch.Tensor,
    frame_mask: torch.Tensor,
    down_factor: int,
    kl_weight,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Masked L1 + kl_weight × masked KL, the KL taken at the latent rate
    (the frame mask strided by ``down_factor``). With ``u`` (the flow image
    of the sampled latent) the KL is against the flow prior."""
    recon = masked_l1_loss(target_mel, recon_mel, frame_mask)
    latent_mask = frame_mask[:, ::down_factor]
    if u is not None:
        kl = flow_prior_kl(mean, logvar, u, latent_mask)
    else:
        kl = kl_divergence(mean, logvar, latent_mask)
    total = recon + kl_weight * kl
    return total, {"recon_l1": recon, "kl": kl, "total": total}


# ---------------------------------------------------------------------------
# GAN losses (HiFi-GAN, arXiv:2010.05646)
# ---------------------------------------------------------------------------


def lsgan_discriminator_loss(real_outputs: Sequence[torch.Tensor],
                             fake_outputs: Sequence[torch.Tensor]
                             ) -> torch.Tensor:
    """Least-squares GAN discriminator loss (HiFi-GAN eq. 1)."""
    loss = 0.0
    for dr, df in zip(real_outputs, fake_outputs):
        loss = loss + torch.mean((dr.float() - 1.0).square()) + torch.mean(
            df.float().square())
    return loss


def lsgan_generator_loss(fake_outputs: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Least-squares GAN generator adversarial loss (HiFi-GAN eq. 2)."""
    loss = 0.0
    for df in fake_outputs:
        loss = loss + torch.mean((df.float() - 1.0).square())
    return loss


def feature_matching_loss(real_features, fake_features) -> torch.Tensor:
    """L1 feature-matching loss over all discriminator feature maps."""
    loss = 0.0
    for reals, fakes in zip(real_features, fake_features):
        for r, f in zip(reals, fakes):
            loss = loss + torch.mean((r.float() - f.float()).abs())
    return loss
