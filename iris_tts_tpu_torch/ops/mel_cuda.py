"""Fused log-mel spectrogram: the hand-written CUDA kernel and its wrapper.

Replaces the JAX package's Pallas TPU kernel (``ops/mel_pallas.py``,
``_mel_kernel`` via ``log_mel_spectrogram_pallas``). The kernel lives in
``csrc/log_mel.cu``; its header comment gives the design and what bounds it.

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

import torch

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.ops.stft import (
    dft_matrices,
    log_mel_spectrogram_plain,
    mel_filterbank,
    num_frames,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "log_mel.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iris_tts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.iris_log_mel.restype = ctypes.c_int
    lib.iris_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iris_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=8)
def _kernel_constants(cfg: AudioConfig, device: torch.device):
    real, imag = dft_matrices(cfg.n_fft, cfg.win_length)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                        cfg.fmax)
    return tuple(
        torch.from_numpy(a).to(device).contiguous() for a in (real, imag, fb)
    )


def log_mel_cuda(audio: torch.Tensor,
                 cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """audio [..., N] → log-mel [..., 1 + N//hop, n_mels], f32.

    CUDA tensor: one launch of the kernel for the whole batch (counted in
    ``log_mel_cuda.launches``). CPU tensor: the plain version. Any other
    device raises."""
    if audio.device.type == "cpu":
        return log_mel_spectrogram_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {audio.device}")
    if cfg.pad_mode != "constant":
        raise ValueError(
            f"the log-mel kernel pads with zeros; pad_mode={cfg.pad_mode!r}"
        )
    if cfg.n_fft % 32:
        raise ValueError(f"the log-mel kernel needs n_fft % 32 == 0, got "
                         f"{cfg.n_fft}")
    lead, n = audio.shape[:-1], audio.shape[-1]
    flat = audio.reshape(-1, n).to(torch.float32).contiguous()
    b, t = flat.shape[0], num_frames(n, cfg.hop_length)
    out = torch.empty((b, t, cfg.n_mels), device=audio.device,
                      dtype=torch.float32)
    if b == 0:
        return out.reshape(*lead, t, cfg.n_mels)
    dft_re, dft_im, fb = _kernel_constants(cfg, audio.device)
    lib = _library()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        code = lib.iris_log_mel(
            flat.data_ptr(), dft_re.data_ptr(), dft_im.data_ptr(),
            fb.data_ptr(), out.data_ptr(), b, n, t, cfg.n_fft,
            cfg.hop_length, fb.shape[0], cfg.n_mels, cfg.log_clip_min,
            stream,
        )
    if code != 0:
        raise RuntimeError(
            "log-mel kernel launch failed: "
            + lib.iris_cuda_error_string(code).decode()
        )
    log_mel_cuda.launches += 1
    return out.reshape(*lead, t, cfg.n_mels)


log_mel_cuda.launches = 0
