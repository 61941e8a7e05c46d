"""Numerical ops: convolutions, length regulation, log-mel features."""

from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    gaussian_upsample,
    length_regulate,
    padding_mask,
    round_up_to_multiple,
)
from iris_tts_tpu_torch.ops.stft import (
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
    mel_filterbank,
)

__all__ = [
    "durations_from_log",
    "gaussian_upsample",
    "length_regulate",
    "padding_mask",
    "round_up_to_multiple",
    "log_mel_spectrogram",
    "log_mel_spectrogram_plain",
    "mel_filterbank",
]
