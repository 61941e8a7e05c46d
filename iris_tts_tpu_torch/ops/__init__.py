"""Numerical ops: convolutions, length regulation, log-mel features,
losses."""

from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    gaussian_upsample,
    length_regulate,
    padding_mask,
    round_up_to_multiple,
)
from iris_tts_tpu_torch.ops.losses import (
    duration_huber_loss,
    feature_matching_loss,
    kl_divergence,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
    masked_l1_loss,
    vae_loss,
)
from iris_tts_tpu_torch.ops.stft import (
    hann_window,
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
    mel_filterbank,
    stft_magnitude_matmul,
)

__all__ = [
    "durations_from_log",
    "gaussian_upsample",
    "length_regulate",
    "padding_mask",
    "round_up_to_multiple",
    "duration_huber_loss",
    "feature_matching_loss",
    "kl_divergence",
    "lsgan_discriminator_loss",
    "lsgan_generator_loss",
    "masked_l1_loss",
    "vae_loss",
    "hann_window",
    "log_mel_spectrogram",
    "log_mel_spectrogram_plain",
    "mel_filterbank",
    "stft_magnitude_matmul",
]
