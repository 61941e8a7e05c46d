"""WAV audio IO with zero third-party audio dependencies.

The port's own copy of the JAX package's ``data/audio_io.py``: RIFF/WAVE
parsing and writing (PCM 16/24/32-bit and IEEE float32, mono/multichannel)
plus a polyphase resampler via scipy (imported only when the rates differ).
These are cold-path host utilities; device feature extraction lives in
:mod:`iris_tts_tpu_torch.ops.stft`.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples in [-1, 1] shaped [N] or [N, C], sr)."""
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (audio_format, channels, sample_rate, _, _, bits) = struct.unpack_from(
        "<HHIIHH", fmt, 0
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        # True format lives in the GUID's first two bytes.
        (audio_format,) = struct.unpack_from("<H", fmt, 24)

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = (
                np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
            )
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as32 = np.where(as32 & 0x800000, as32 - (1 << 24), as32)
            samples = as32.astype(np.float32) / 8388608.0
        elif bits == 8:
            samples = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            samples = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format 0x{audio_format:04x}")

    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, sample_rate


def wav_bytes(
    samples: np.ndarray,
    sample_rate: int,
    subtype: str = "pcm16",
) -> bytes:
    """Float samples in [-1, 1] → a complete RIFF/WAV byte string (pcm16 or
    float32). The serving layer streams these over HTTP without touching
    the filesystem; write_wav is the file-backed wrapper."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    elif samples.ndim == 2:
        channels = samples.shape[1]
    else:
        raise ValueError("samples must be [N] or [N, C]")

    if subtype == "pcm16":
        if samples.dtype == np.int16:  # already device-quantized
            raw = samples.astype("<i2").tobytes()
        else:
            clipped = np.clip(samples, -1.0, 1.0)
            raw = (clipped * 32767.0).astype("<i2").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
    elif subtype == "float32":
        raw = samples.astype("<f4").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", fmt_tag, channels, sample_rate, byte_rate, block_align, bits
    )
    body = (
        b"WAVE"
        + b"fmt "
        + struct.pack("<I", len(fmt_chunk))
        + fmt_chunk
        + b"data"
        + struct.pack("<I", len(raw))
        + raw
    )
    return b"RIFF" + struct.pack("<I", len(body)) + body


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    subtype: str = "pcm16",
) -> None:
    """Write float samples in [-1, 1] to a WAV file (pcm16 or float32)."""
    Path(path).write_bytes(wav_bytes(samples, sample_rate, subtype))


def to_mono(samples: np.ndarray) -> np.ndarray:
    """Downmix [N, C] → [N] by channel mean (librosa.load semantics)."""
    if samples.ndim == 2:
        return samples.mean(axis=1)
    return samples


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (host-side, offline data prep only)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    out = resample_poly(audio, target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def load_audio(path: str | Path, sample_rate: int = 22050) -> np.ndarray:
    """Load a WAV as mono float32 at ``sample_rate``.

    Drop-in equivalent of the reference's librosa loader
    (reference src/iris/data.py:10-22).
    """
    samples, sr = read_wav(path)
    samples = to_mono(samples)
    return resample(samples, sr, sample_rate)


def join_wave_chunks(
    outs, gap_ms: float, sample_rate: int
) -> np.ndarray:
    """Concatenate chunk waveforms with ``gap_ms`` of silence between them.

    The single source of the long-form join policy, shared by
    ``TTSPipeline.synthesize_long``, the serving batcher, and the AOT
    serving path. The gap inherits the chunks' dtype so int16 (PCM16
    transfer) audio is never silently promoted to float.
    """
    if len(outs) == 1:
        return outs[0]
    gap = np.zeros(
        int(round(gap_ms / 1000.0 * sample_rate)), outs[0].dtype
    )
    joined = []
    for i, a in enumerate(outs):
        if i:
            joined.append(gap)
        joined.append(a)
    return np.concatenate(joined)
