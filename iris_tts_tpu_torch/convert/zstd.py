"""Zstandard decompression without the ``zstandard`` package.

ctypes bindings for ``csrc/zstd_decode.cpp``, a frame decoder written to
RFC 8878 (no dictionaries), which also carries the CRC-32C that OCDBT files
end with. The library is built with ``$CXX`` (default ``g++``) at first use
into ``build/iris_tts_tpu_torch/``. There is no pure-Python fallback: a
missing compiler or a failed build raises ``RuntimeError``, so a broken
build never turns into a silent slow path.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

from iris_tts_tpu_torch.utils.cxx import build_shared_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "zstd_decode.cpp"
_NO_LIMIT = (1 << 64) - 1
_ERR_CAP = 256

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/zstd_decode.cpp`` (once per source hash) and return
    the path of the shared library; raises ``RuntimeError`` if it cannot."""
    return build_shared_library(SOURCE, "libiriszstd")


def get_lib() -> ctypes.CDLL:
    """The loaded decoder library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.iris_zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.iris_zstd_decompress.restype = ctypes.c_int
            lib.iris_zstd_free.argtypes = [ctypes.c_void_p]
            lib.iris_zstd_free.restype = None
            lib.iris_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.iris_crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def decompress(data: bytes, max_output_size: Optional[int] = None) -> bytes:
    """Every frame of ``data`` (concatenated frames and skippable frames
    included) decoded and joined. Raises ``ValueError`` for malformed input
    (truncated, bad magic number, checksum mismatch, a frame's output
    other than its stated content size) and for an output over
    ``max_output_size`` bytes."""
    lib = get_lib()
    data = bytes(data)
    limit = _NO_LIMIT if max_output_size is None else int(max_output_size)
    if limit < 0:
        raise ValueError("max_output_size must be >= 0")
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.iris_zstd_decompress(data, len(data), limit, ctypes.byref(out),
                                  ctypes.byref(n), err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    if not out:
        return b""
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.iris_zstd_free(out)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(get_lib().iris_crc32c(data, len(data)))
