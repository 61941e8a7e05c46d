"""STFT / log-mel feature extraction.

Counterpart of the JAX package's ``ops/stft.py``: magnitude spectrogram
(power 1.0) → Slaney mel filterbank → ``log(max(mel, 1e-5))``, the
system-wide mel convention the HiFiGAN vocoder expects.

The numpy constants (window, DFT matrices, filterbank) are this package's
own copies. :func:`log_mel_spectrogram_plain` is the plain PyTorch version
(frame + windowed-DFT matmuls): the reference the tests and the card's
smoke run hold the CUDA kernel (``ops/mel_cuda.py``) against.
:func:`log_mel_spectrogram` is the entry point: the kernel for a CUDA
tensor, the plain version for a CPU tensor.

Dtypes, as the JAX package's: the log-mel comes back in the audio's dtype
when that is float16 or bfloat16, and in f32 otherwise. The kernel and the
plain version compute in f32 and cast the result (the Pallas kernel too is
f32 inside). The ``impl="xla"`` composition follows JAX's ``impl="xla"``
step by step: its magnitude is rounded to the audio's dtype before the
mel projection, as ``stft_magnitude_matmul`` casts it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch.config import AudioConfig

# ---------------------------------------------------------------------------
# Windows and mel filterbank (host-side numpy, cached)
# ---------------------------------------------------------------------------


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', N)``, as librosa)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


@functools.lru_cache(maxsize=None)
def padded_window(n_fft: int, win_length: int,
                  dtype_name: str = "float32") -> np.ndarray:
    """The analysis window centred in an n_fft frame."""
    win = np.zeros(n_fft, dtype=np.dtype(dtype_name))
    offset = (n_fft - win_length) // 2
    win[offset: offset + win_length] = hann_window(
        win_length, np.dtype(dtype_name)
    )
    return win


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freqs >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz)
        / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs
    )


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 8000.0,
) -> np.ndarray:
    """Triangular Slaney-normalised mel filterbank, shape [n_freqs, n_mels]
    (``mel = |S| @ fb``)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array([fmin]))[0],
        _hz_to_mel_slaney(np.array([fmax]))[0],
        n_mels + 2,
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(n_fft: int, win_length: int, dtype_name: str = "float32"):
    """Real/imag DFT matrices [n_fft, n_freqs] with the analysis window
    folded in: ``f @ real + i·(f @ imag) == rfft(window · f)``."""
    dtype = np.dtype(dtype_name)
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    win = padded_window(n_fft, win_length, "float64")
    real = (np.cos(ang) * win[:, None]).astype(dtype)
    imag = (np.sin(ang) * win[:, None]).astype(dtype)
    return real, imag


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frames of a centre-padded signal: 1 + N // hop (librosa)."""
    return 1 + n_samples // hop_length


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

_TORCH_PAD_MODES = {"constant": "constant", "reflect": "reflect"}


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int,
                 pad_mode: str = "constant") -> torch.Tensor:
    """Centre-pad by n_fft//2 and slice ``audio`` [..., N] into frames
    [..., 1 + N//hop, n_fft] (a strided view of the padded signal)."""
    if pad_mode not in _TORCH_PAD_MODES:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    pad = n_fft // 2
    lead = audio.shape[:-1]
    flat = audio.reshape(-1, 1, audio.shape[-1])
    padded = F.pad(flat, (pad, pad), mode=_TORCH_PAD_MODES[pad_mode])
    frames = padded[:, 0].unfold(-1, n_fft, hop_length)
    return frames.reshape(*lead, frames.shape[-2], n_fft)


@functools.lru_cache(maxsize=8)
def _dft_tensors(n_fft: int, win_length: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in dft_matrices(n_fft, win_length))


@functools.lru_cache(maxsize=8)
def _filterbank_tensor(cfg: AudioConfig, device: torch.device):
    return torch.from_numpy(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(device)


def log_mel_dtype(audio: torch.Tensor) -> torch.dtype:
    """The dtype of a feature of ``audio`` (magnitude, log-mel): a
    half-precision audio dtype (float16, bfloat16) carries over, anything
    else gives f32."""
    if audio.dtype in (torch.float16, torch.bfloat16):
        return audio.dtype
    return torch.float32


def _magnitude_f32(audio: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, pad_mode: str) -> torch.Tensor:
    """|STFT| in f32 by windowed-DFT matmuls, floored under the root:
    ``sqrt(re² + im² + 1e-12)`` (the JAX package's XLA path keeps the same
    1e-12 floor, which bounds the gradient at a silent bin)."""
    frames = frame_signal(audio.to(torch.float32), n_fft, hop_length,
                          pad_mode)
    real, imag = _dft_tensors(n_fft, win_length, frames.device)
    re = frames @ real
    im = frames @ imag
    return torch.sqrt(re * re + im * im + 1e-12)


def stft_magnitude(audio: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 256, win_length: int = 1024,
                   pad_mode: str = "constant") -> torch.Tensor:
    """|STFT| via an FFT (``torch.fft.rfft``; XLA's rfft in the JAX
    package): audio [..., N] → [..., T, n_freqs], with the same 1e-12 floor
    under the root, computed in f32 and returned in
    :func:`log_mel_dtype`."""
    frames = frame_signal(audio.to(torch.float32), n_fft, hop_length,
                          pad_mode)
    win = torch.from_numpy(padded_window(n_fft, win_length)).to(
        frames.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag + 1e-12)
    return mag.to(log_mel_dtype(audio))


def stft_magnitude_matmul(audio: torch.Tensor, n_fft: int = 1024,
                          hop_length: int = 256, win_length: int = 1024,
                          pad_mode: str = "constant") -> torch.Tensor:
    """|STFT| via windowed-DFT matmuls: audio [..., N] → [..., T, n_freqs],
    computed in f32 and returned in :func:`log_mel_dtype`."""
    return _magnitude_f32(audio, n_fft, hop_length, win_length,
                          pad_mode).to(log_mel_dtype(audio))


def _log_mel_of(mag: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """f32 magnitude → ``log(max(mag @ fb, log_clip_min))`` in f32."""
    fb = _filterbank_tensor(cfg, mag.device)
    return torch.log(torch.clamp(mag.float() @ fb, min=cfg.log_clip_min))


def log_mel_spectrogram_plain(audio: torch.Tensor,
                              cfg: AudioConfig = AudioConfig()
                              ) -> torch.Tensor:
    """audio [..., N] → log-mel [..., T, n_mels]: frames @ windowed DFT →
    floored magnitude → @ mel filterbank → ``log(max(·, log_clip_min))``,
    all in f32, then cast to :func:`log_mel_dtype` as the kernel's wrapper
    casts.

    Runs on any device, in full f32 on the card only with TF32 matmuls off
    (``torch.backends.cuda.matmul.allow_tf32``, False by default)."""
    mag = _magnitude_f32(audio, cfg.n_fft, cfg.hop_length, cfg.win_length,
                         cfg.pad_mode)
    return _log_mel_of(mag, cfg).to(log_mel_dtype(audio))


def log_mel_spectrogram(audio: torch.Tensor,
                        cfg: AudioConfig = AudioConfig(),
                        impl: Optional[str] = None) -> torch.Tensor:
    """audio [..., N] → log-mel [..., T, n_mels] (time-major; dtype:
    :func:`log_mel_dtype`).

    ``impl=None``: a CUDA tensor goes through the hand-written kernel
    (:func:`~iris_tts_tpu_torch.ops.mel_cuda.log_mel_cuda`), which raises if
    it cannot build or launch; a CPU tensor goes through the plain version.

    ``impl="xla"``: the port of the JAX package's ``impl="xla"`` path, a
    dense windowed-DFT matmul plus elementwise math that autograd
    differentiates. The GAN mel loss differentiates through the fake audio's
    mel and uses it for that reason, as the JAX generator step does (its
    kernel, like this port's, is forward-only). It shares its code with
    :func:`log_mel_spectrogram_plain`; it is a path of its own, not a
    fallback of the kernel.
    """
    if impl == "xla":
        return log_mel_spectrogram_plain(audio, cfg)
    if impl is not None:
        raise ValueError(f"unknown log-mel impl {impl!r}")
    from iris_tts_tpu_torch.ops.mel_cuda import log_mel_cuda

    return log_mel_cuda(audio, cfg)



def to_reference_layout(mel_tc: torch.Tensor) -> torch.Tensor:
    """[..., T, n_mels] → [..., n_mels, T] (the reference's module-boundary
    layout)."""
    return mel_tc.transpose(-1, -2)


def from_reference_layout(mel_ct: torch.Tensor) -> torch.Tensor:
    """[..., n_mels, T] → [..., T, n_mels]."""
    return mel_ct.transpose(-1, -2)


def normalize_mel(mel: torch.Tensor, mean: Optional[torch.Tensor] = None,
                  std: Optional[torch.Tensor] = None):
    """Standardise a mel spectrogram → (normalised, mean, std); the mean
    and the population std (``ddof=0``, as ``jnp.std``) of the whole tensor
    when not given."""
    if mean is None:
        mean = torch.mean(mel)
    if std is None:
        std = torch.std(mel, correction=0)
    return (mel - mean) / (std + 1e-8), mean, std
