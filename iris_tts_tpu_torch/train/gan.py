"""HiFiGAN adversarial fine-tuning: generator and discriminator steps.

Counterpart of the JAX package's ``train/gan.py``. Losses follow the
HiFi-GAN paper (arXiv:2010.05646): LSGAN adversarial + feature matching
(λ_fm = 2) + mel-spectrogram L1 (λ_mel = 45). The mel loss differentiates
through the fake audio's log-mel, so it uses ``log_mel_spectrogram(...,
impl="xla")``, the differentiable path, as the JAX step does; the
hand-written log-mel kernel is forward-only.

Gradient boundaries, as in the JAX steps:

* the discriminator step detaches the fake audio (the generator gets no
  gradient);
* the generator step sends gradients through the discriminator's
  activations, but the discriminator's parameters are frozen for it
  (``requires_grad`` off), so nothing accumulates in their ``.grad``;
* each side has its own optimizer and train state.

``compute_dtype`` and ``remat`` as in the JAX steps: the generator and the
discriminators compute in ``compute_dtype`` (params, gradients and Adam
state stay f32; losses reduce in f32), and ``remat=True`` recomputes each
HiFiGAN MRF resblock in the backward pass.

Batches: ``{"mel": [B, T, n_mels], "audio": [B, T * hop]}``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models.layers import computing
from iris_tts_tpu_torch.ops.losses import (
    feature_matching_loss,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
)
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.runtime import DtypeLike, resolve_dtype
from iris_tts_tpu_torch.train.state import TrainState
from iris_tts_tpu_torch.train.steps import _accumulated_grads

LAMBDA_FM = 2.0
LAMBDA_MEL = 45.0


@contextlib.contextmanager
def frozen_params(module: nn.Module):
    """Turn ``requires_grad`` off for ``module``'s parameters inside the
    block: gradients still flow through its activations to the inputs."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def disc_loss(disc: nn.Module, gen: nn.Module, batch):
    """LSGAN discriminator loss on real audio and detached fake audio."""
    with torch.no_grad():
        fake = gen(batch["mel"])
    real_logits, _ = disc(batch["audio"])
    fake_logits, _ = disc(fake)
    loss = lsgan_discriminator_loss(real_logits, fake_logits)
    return loss, {"disc_loss": loss}


def gen_loss(gen: nn.Module, disc: nn.Module, batch, cfg: IrisConfig):
    """Adversarial + λ_fm·feature matching + λ_mel·mel L1 of the generator;
    call with the discriminator's parameters frozen."""
    fake = gen(batch["mel"])
    fake_logits, fake_feats = disc(fake)
    with torch.no_grad():
        _, real_feats = disc(batch["audio"])
        real_mel = log_mel_spectrogram(batch["audio"], cfg.audio, impl="xla")
    adv = lsgan_generator_loss(fake_logits)
    fm = feature_matching_loss(real_feats, fake_feats)
    fake_mel = log_mel_spectrogram(fake, cfg.audio, impl="xla")
    mel_l1 = torch.mean((fake_mel - real_mel).abs())
    total = adv + LAMBDA_FM * fm + LAMBDA_MEL * mel_l1
    return total, {"gen_adv": adv, "gen_fm": fm, "gen_mel_l1": mel_l1,
                   "gen_total": total}


def make_gan_steps(cfg: IrisConfig, accum_steps: int = 1,
                   compute_dtype: DtypeLike = None, remat: bool = False):
    """Returns (discriminator_step, generator_step), each
    ``(gen_state, disc_state, batch) → (its own new state, metrics)``;
    alternate them per batch as in the paper. The discriminators' periods,
    scales and width are those of the module in ``disc_state.params``."""
    dt = resolve_dtype(compute_dtype)

    def modes(gen_state, disc_state):
        return computing([gen_state.params, disc_state.params], dt,
                         remat=remat)

    def disc_step(gen_state: TrainState, disc_state: TrainState, batch):
        with modes(gen_state, disc_state):
            metrics = _accumulated_grads(
                lambda b: disc_loss(disc_state.params, gen_state.params, b),
                batch, accum_steps)
        return disc_state.apply_gradients(), metrics

    def gen_step(gen_state: TrainState, disc_state: TrainState, batch):
        with modes(gen_state, disc_state), frozen_params(disc_state.params):
            metrics = _accumulated_grads(
                lambda b: gen_loss(gen_state.params, disc_state.params, b,
                                   cfg),
                batch, accum_steps)
        return gen_state.apply_gradients(), metrics

    return disc_step, gen_step


@dataclass(eq=False)
class GANState:
    """Both sides of the GAN as one state for the training loop and its
    checkpoints (the JAX stage script keeps two checkpoint directories;
    here one checkpoint holds ``gen`` and ``disc``, so they can never be a
    save apart). ``step`` is the generator's."""

    gen: TrainState
    disc: TrainState
    frozen = None

    @property
    def step(self) -> int:
        return self.gen.step

    @property
    def epoch(self) -> int:
        return self.gen.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.gen.epoch = self.disc.epoch = value

    @property
    def params(self) -> nn.Module:
        return self.gen.params

    @property
    def serving_params(self) -> nn.Module:
        return self.gen.serving_params

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict()}

    def load_state_dict(self, sd: dict) -> "GANState":
        self.gen.load_state_dict(sd["gen"])
        self.disc.load_state_dict(sd["disc"])
        return self


def make_gan_train_step(cfg: IrisConfig, accum_steps: int = 1,
                        compute_dtype: DtypeLike = None, remat: bool = False):
    """One round on a :class:`GANState`: the discriminator step, then the
    generator step against the updated discriminator (the per-batch order
    of the JAX stage script)."""
    disc_step, gen_step = make_gan_steps(cfg, accum_steps, compute_dtype,
                                         remat)

    def step(state: GANState, batch) -> Tuple[GANState, Dict]:
        _, dm = disc_step(state.gen, state.disc, batch)
        _, gm = gen_step(state.gen, state.disc, batch)
        return state, {**dm, **gm}

    return step
