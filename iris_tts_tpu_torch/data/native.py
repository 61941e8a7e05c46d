"""ctypes bindings for the native WAV codec / batch loader.

The port's counterpart of the JAX package's ``data/native.py``, over its
own copy of the C++ source (``data/csrc/wavio.cpp``). The library is built
with ``g++`` at first use into ``build/iris_tts_tpu_torch/`` (once per
source hash; a build goes to a pid-suffixed file that is then renamed, so
concurrent processes never load a half-written library) and exposes:

* :func:`read_wav_mono` — one file → mono float32,
* :func:`read_wav_batch` — thread-pooled batch decode into one padded
  [N, max_samples] array (the training input-pipeline hot path),
* :func:`write_wav_pcm16`.

Every entry point falls back to the pure-Python implementation in
:mod:`iris_tts_tpu_torch.data.audio_io` when the library is unavailable
(no compiler, or a failed build), so the package never hard-requires one;
:func:`native_available` says which one runs.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from iris_tts_tpu_torch.data.audio_io import read_wav, resample, to_mono
from iris_tts_tpu_torch.data.audio_io import write_wav as _write_wav_python
from iris_tts_tpu_torch.utils.cxx import build_shared_library

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "csrc" / "wavio.cpp"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_library() -> Path:
    """Compile ``csrc/wavio.cpp`` (once per source hash) and return the
    path of the shared library; raises if it cannot."""
    return build_shared_library(SOURCE, "libiriswav")


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = build_library()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.debug("native WAV build failed: %s", e)
        return None
    lib = ctypes.CDLL(str(path))
    lib.iris_read_wav_mono.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.iris_read_wav_mono.restype = ctypes.c_int
    lib.iris_free.argtypes = [ctypes.c_void_p]
    lib.iris_free.restype = None
    lib.iris_read_wav_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.iris_read_wav_batch.restype = ctypes.c_int
    lib.iris_write_wav_pcm16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.iris_write_wav_pcm16.restype = ctypes.c_int
    _lib = lib
    logger.info("native WAV codec loaded from %s", path)
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def read_wav_mono(path: str | Path) -> Tuple[np.ndarray, int]:
    """One WAV → (mono float32 [N], sample_rate); native with Python
    fallback."""
    lib = get_lib()
    if lib is None:
        samples, sr = read_wav(path)
        return to_mono(samples), sr
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.iris_read_wav_mono(
        str(path).encode(), ctypes.byref(out), ctypes.byref(n),
        ctypes.byref(sr),
    )
    if rc != 0:
        raise ValueError(f"{path}: native WAV decode failed (code {rc})")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.iris_free(out)
    return arr, sr.value


def read_wav_batch(
    paths: List[str | Path],
    max_samples: int,
    num_threads: int = 8,
    expected_sample_rate: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch decode → (audio [N, max_samples] zero-padded, lengths [N],
    rates [N]). Thread-pooled in C++; Python loop as fallback. A file that
    fails to decode gives a zero row of length 0.

    Rows are returned at each file's native sample rate. Pass
    ``expected_sample_rate`` to resample (with a warning) any row whose rate
    differs — otherwise callers MUST validate the returned ``rates`` array,
    or a mixed-rate corpus silently produces wrong-timebase features.
    Resampling happens after the decode is clipped to ``max_samples``, so
    size the buffer for the NATIVE rate of the longest file.
    """
    lib = get_lib()
    n = len(paths)
    audio = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros((n,), np.int64)
    rates = np.zeros((n,), np.int32)
    if lib is None:
        for i, p in enumerate(paths):
            mono, sr = read_wav_mono(p)
            take = min(len(mono), max_samples)
            audio[i, :take] = mono[:take]
            lengths[i] = take
            rates[i] = sr
    else:
        blob = b"".join(str(p).encode() + b"\x00" for p in paths)
        failures = lib.iris_read_wav_batch(
            blob,
            n,
            max_samples,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            num_threads,
        )
        if failures:
            logger.warning("%d/%d files failed to decode", failures, n)
    if expected_sample_rate is not None:
        mismatched = np.flatnonzero(
            (rates != expected_sample_rate) & (lengths > 0)
        )
        if mismatched.size:
            logger.warning(
                "%d/%d files are not at %d Hz — resampling them",
                mismatched.size, n, expected_sample_rate,
            )
            for i in mismatched:
                row = resample(
                    audio[i, : lengths[i]], int(rates[i]),
                    expected_sample_rate,
                )
                take = min(len(row), max_samples)
                audio[i, :take] = row[:take]
                audio[i, take:] = 0.0
                lengths[i] = take
                rates[i] = expected_sample_rate
    return audio, lengths, rates


def load_audio(path: str | Path, sample_rate: int = 22050) -> np.ndarray:
    """Mono float32 at ``sample_rate`` via the native decoder (Python
    fallback) + polyphase resample — the preferred loader for the training
    input pipeline."""
    mono, sr = read_wav_mono(path)
    return resample(mono, sr, sample_rate)


def write_wav_pcm16(path: str | Path, samples: np.ndarray,
                    sample_rate: int) -> None:
    lib = get_lib()
    if lib is None:
        _write_wav_python(path, samples, sample_rate, subtype="pcm16")
        return
    samples = np.ascontiguousarray(samples, np.float32)
    rc = lib.iris_write_wav_pcm16(
        str(path).encode(),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples),
        sample_rate,
    )
    if rc != 0:
        raise IOError(f"native WAV write failed (code {rc})")
