"""Griffin-Lim fallback vocoder, on the tensor's device.

Counterpart of the JAX package's ``ops/griffin_lim.py``: log-mel → linear
magnitude (a non-negative least-squares solve through the mel filterbank,
warm-started at its clipped pseudo-inverse) → iterative phase recovery →
waveform. Each iteration is an inverse STFT (overlap-add with window-square
normalisation) and an STFT with phase renormalisation. The FFTs are
``torch.fft`` (XLA's own FFT in the JAX package), and the overlap-add is
``F.fold``, which sums each output sample's frames in a fixed order, so a
seeded run gives the same bits every time on the card too.

JAX draws the initial phase from ``jax.random.uniform(PRNGKey(seed))``;
here it comes from a ``torch.Generator`` seeded with ``seed`` on the
magnitude's device. :func:`griffin_lim_from_phase` takes the initial phase
itself, so the tests can start both packages from the same one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.ops.stft import (
    frame_signal,
    mel_filterbank,
    padded_window,
)
from iris_tts_tpu_torch.runtime import seeded_generator

MEL_TO_LINEAR_METHODS = ("nnls", "pinv")


@functools.lru_cache(maxsize=None)
def _mel_pinv(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """Clipped pseudo-inverse of the mel filterbank [n_mels, n_freqs] (the
    warm start for the NNLS solve below)."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)  # [F, M]
    pinv = np.linalg.pinv(fb.astype(np.float64))  # [M, F]
    return np.maximum(pinv, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_lipschitz(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> float:
    """L = ||fb||₂², the Lipschitz constant of ∇½||m·fb − mel||²: the
    NNLS projected-gradient step is 1/L."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return float(np.linalg.norm(fb.astype(np.float64), 2) ** 2)


def mel_to_linear(log_mel: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                  method: str = "nnls", n_iter: int = 30) -> torch.Tensor:
    """log-mel [T, n_mels] → linear magnitude [T, n_freqs] in f32.

    ``method="nnls"`` (default) solves min ‖m·fb − mel‖² s.t. m ≥ 0 (the
    librosa semantics) by ``n_iter`` steps of projected gradient descent
    from the clipped pseudo-inverse; ``method="pinv"`` is that one matmul
    alone."""
    if method not in MEL_TO_LINEAR_METHODS:
        raise ValueError(f"method={method!r} is not one of "
                         f"{MEL_TO_LINEAR_METHODS}")
    fb_args = (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel = torch.exp(torch.clamp(log_mel.float(), -11.513, 2.0))
    pinv = torch.from_numpy(_mel_pinv(*fb_args)).to(mel.device)
    m = torch.clamp(mel @ pinv, min=0.0)
    if method == "pinv":
        return m
    fb = torch.from_numpy(mel_filterbank(*fb_args)).to(mel.device)  # [F, M]
    eta = 1.0 / _mel_lipschitz(*fb_args)
    for _ in range(n_iter):
        grad = (m @ fb - mel) @ fb.T
        m = torch.clamp(m - eta * grad, min=0.0)
    return m


def _window(cfg: AudioConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(padded_window(cfg.n_fft, cfg.win_length)).to(
        device)


def _stft_complex(audio: torch.Tensor, cfg: AudioConfig,
                  win: torch.Tensor) -> torch.Tensor:
    # Framing shared with the mel extractor (ops/stft.py), so the analysis
    # STFT cannot drift from the features it inverts.
    frames = frame_signal(audio, cfg.n_fft, cfg.hop_length, cfg.pad_mode)
    return torch.fft.rfft(frames * win, dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Frames [T, n_fft] summed at hop spacing → [(T−1)·hop + n_fft]."""
    t, n_fft = frames.shape
    total = (t - 1) * hop + n_fft
    return F.fold(frames.T[None], output_size=(1, total),
                  kernel_size=(1, n_fft), stride=(1, hop)).reshape(total)


def _istft(spec: torch.Tensor, n_samples: int, cfg: AudioConfig,
           win: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Overlap-add inverse STFT, divided by the overlap-added squared
    window ``norm`` floored at 1e-8."""
    frames = torch.fft.irfft(spec, n=cfg.n_fft, dim=-1) * win
    audio = _overlap_add(frames, cfg.hop_length) / torch.clamp(norm, min=1e-8)
    pad = cfg.n_fft // 2
    return audio[pad: pad + n_samples]


def griffin_lim_from_phase(magnitude: torch.Tensor, angles: torch.Tensor,
                           cfg: AudioConfig = AudioConfig(),
                           n_iter: int = 60) -> torch.Tensor:
    """Phase recovery from |STFT| [T, n_freqs] and an initial phase of the
    same shape → waveform [(T−1)·hop] in f32."""
    magnitude = magnitude.float()
    t = magnitude.shape[0]
    n_samples = (t - 1) * cfg.hop_length
    win = _window(cfg, magnitude.device)
    norm = _overlap_add((win * win).expand(t, cfg.n_fft), cfg.hop_length)
    spec = torch.polar(magnitude, angles.float())
    for _ in range(n_iter):
        audio = _istft(spec, n_samples, cfg, win, norm)
        rebuilt = _stft_complex(audio, cfg, win)[:t]
        phase = rebuilt / torch.clamp(rebuilt.abs(), min=1e-8)
        spec = magnitude * phase
    return _istft(spec, n_samples, cfg, win, norm)


def griffin_lim(magnitude: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                n_iter: int = 60, seed: int = 0) -> torch.Tensor:
    """Phase recovery from |STFT| [T, n_freqs] → waveform (60 iterations by
    default), from a uniform initial phase in [−π, π) drawn by a generator
    seeded with ``seed`` on the magnitude's device."""
    g = seeded_generator(seed, magnitude.device)
    angles = (torch.rand(magnitude.shape, generator=g,
                         device=magnitude.device) * 2.0 - 1.0) * math.pi
    return griffin_lim_from_phase(magnitude, angles, cfg, n_iter)


def griffin_lim_from_log_mel(log_mel: torch.Tensor, n_iter: int = 60,
                             cfg: AudioConfig = AudioConfig(),
                             seed: int = 0) -> torch.Tensor:
    """log-mel [T, n_mels] → waveform on the log-mel's device. ``cfg`` is
    the audio config the log-mel was made with (the JAX function always
    takes the default one)."""
    return griffin_lim(mel_to_linear(log_mel, cfg), cfg, n_iter=n_iter,
                       seed=seed)
