"""Fused log-mel spectrogram: the hand-written CUDA kernel and its wrapper.

Replaces the JAX package's Pallas TPU kernel (``ops/mel_pallas.py``,
``_mel_kernel`` via ``log_mel_spectrogram_pallas``). The kernel lives in
``csrc/log_mel.cu``; its header comment gives the design and what bounds it:
a shared-memory radix-4 FFT of two frames at a time with a fused sparse mel
epilogue. :func:`kernel_tables` builds the tables it reads (window,
twiddles, sparse filterbank); the card path takes n_fft a power of two in
[64, 2048] and zero padding only.

Build: at first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/iris_tts_tpu_torch/`` at the repo
root, keyed by a hash of the source and flags, and ``ctypes`` loads it. The
launch goes on PyTorch's current stream; its error code is checked and a
failure raises. There is no fallback to the plain version on the card:
:func:`log_mel_cuda` takes the plain version (``ops/stft.py``) only for a
tensor that lies on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.ops.stft import (
    log_mel_dtype,
    log_mel_spectrogram_plain,
    mel_filterbank,
    num_frames,
    padded_window,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "log_mel.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iris_tts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MIN_N_FFT, MAX_N_FFT = 64, 2048  # the FFT sizes the kernel is compiled for


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library() -> Path:
    """Compile ``csrc/log_mel.cu`` (once per source hash) and return the
    path of the shared library. ptxas' register/shared-memory report is
    kept beside it as ``<name>.ptxas.txt``."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"log_mel_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".log_mel_{key}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {r.returncode}:\n{r.stderr[-4000:]}"
        )
    lib.with_suffix(".ptxas.txt").write_text(r.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.iris_log_mel.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.iris_log_mel.restype = ctypes.c_int
    lib.iris_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iris_cuda_error_string.restype = ctypes.c_char_p
    return lib


class KernelTables(NamedTuple):
    """The constants the kernel reads, built on the host.

    ``window`` [n_fft] f32: the analysis window centred in the frame.
    ``twiddles`` [n_fft, 2] f32: (cos, -sin)(2 pi k / n_fft), i.e.
    ``W_N^k = exp(-2 pi i k / N)``, computed in float64 and rounded once.
    ``fb_first`` [n_mels] i32, ``fb_offset`` [n_mels + 1] i32 and
    ``fb_weights`` [nnz] f32: the mel filterbank with its zeros dropped.
    Filter m covers bins ``fb_first[m] + q`` for ``q < fb_offset[m + 1] -
    fb_offset[m]``, with weights ``fb_weights[fb_offset[m]:fb_offset[m+1]]``.
    """

    window: np.ndarray
    twiddles: np.ndarray
    fb_first: np.ndarray
    fb_offset: np.ndarray
    fb_weights: np.ndarray


def sparse_filterbank(fb: np.ndarray):
    """Dense [n_freqs, n_mels] filterbank → (first bin [n_mels], offsets
    [n_mels + 1], weights [nnz]): each column's run from its first to its
    last nonzero bin. A column with no nonzero bin gets an empty run."""
    first = np.zeros(fb.shape[1], np.int32)
    offset = np.zeros(fb.shape[1] + 1, np.int32)
    runs = []
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        run = fb[nz[0]: nz[-1] + 1, m] if nz.size else fb[:0, m]
        first[m] = nz[0] if nz.size else 0
        offset[m + 1] = offset[m] + run.size
        runs.append(run)
    return first, offset, np.concatenate(runs).astype(np.float32)


@functools.lru_cache(maxsize=8)
def kernel_tables(cfg: AudioConfig) -> KernelTables:
    """Window, twiddle and sparse filterbank tables for ``cfg`` (read-only
    arrays, cached). Raises ValueError for a config the kernel does not
    take: it pads with zeros and runs FFTs compiled for n_fft = 64, 128,
    ..., 2048."""
    n = cfg.n_fft
    if n < MIN_N_FFT or n > MAX_N_FFT or n & (n - 1):
        raise ValueError(
            f"the log-mel kernel needs n_fft a power of two in "
            f"[{MIN_N_FFT}, {MAX_N_FFT}], got {n}")
    if cfg.pad_mode != "constant":
        raise ValueError(
            f"the log-mel kernel pads with zeros; pad_mode={cfg.pad_mode!r}")
    ang = 2.0 * np.pi * np.arange(n) / n
    tables = KernelTables(
        padded_window(n, cfg.win_length).copy(),
        np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32),
        *sparse_filterbank(mel_filterbank(cfg.sample_rate, n, cfg.n_mels,
                                          cfg.fmin, cfg.fmax)),
    )
    for a in tables:
        a.setflags(write=False)
    return tables


@functools.lru_cache(maxsize=8)
def _device_tables(cfg: AudioConfig, device: torch.device):
    return tuple(torch.tensor(a, device=device) for a in kernel_tables(cfg))


def log_mel_cuda(audio: torch.Tensor,
                 cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """audio [..., N] → log-mel [..., 1 + N//hop, n_mels], in
    ``stft.log_mel_dtype(audio)`` (bf16 for bf16 audio, else f32).

    CUDA tensor: one launch of the kernel for the whole batch (counted in
    ``log_mel_cuda.launches``); the kernel reads f32 audio and writes an f32
    log-mel, as the Pallas kernel does, and the wrapper casts on both
    sides. It raises for a config the kernel does not take
    (:func:`kernel_tables`). CPU tensor: the plain version. Any other device
    raises."""
    if audio.device.type == "cpu":
        return log_mel_spectrogram_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {audio.device}")
    tables = _device_tables(cfg, audio.device)
    lead, n = audio.shape[:-1], audio.shape[-1]
    flat = audio.reshape(-1, n).to(torch.float32).contiguous()
    b, t = flat.shape[0], num_frames(n, cfg.hop_length)
    out = torch.empty((b, t, cfg.n_mels), device=audio.device,
                      dtype=torch.float32)
    if b == 0:
        return out.reshape(*lead, t, cfg.n_mels).to(log_mel_dtype(audio))
    lib = _library()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        code = lib.iris_log_mel(
            flat.data_ptr(), *(a.data_ptr() for a in tables), out.data_ptr(),
            b, n, t, cfg.n_fft, cfg.hop_length, cfg.n_mels,
            tables[-1].numel(), cfg.log_clip_min, stream,
        )
    if code != 0:
        raise RuntimeError(
            "log-mel kernel launch failed: "
            + lib.iris_cuda_error_string(code).decode()
        )
    log_mel_cuda.launches += 1
    return out.reshape(*lead, t, cfg.n_mels).to(log_mel_dtype(audio))


log_mel_cuda.launches = 0
