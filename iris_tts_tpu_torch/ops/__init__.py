"""Numerical ops: convolutions, length regulation, log-mel features,
losses, the Griffin-Lim vocoder (``ops.griffin_lim``)."""

from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    gaussian_upsample,
    length_regulate,
    pad_time_to_multiple,
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
    from_reference_layout,
    hann_window,
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
    mel_filterbank,
    normalize_mel,
    stft_magnitude,
    stft_magnitude_matmul,
    to_reference_layout,
)

__all__ = [
    "durations_from_log",
    "gaussian_upsample",
    "length_regulate",
    "pad_time_to_multiple",
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
    "stft_magnitude",
    "normalize_mel",
    "to_reference_layout",
    "from_reference_layout",
]
