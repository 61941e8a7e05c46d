"""Build a C++ or CUDA source of the port into a shared library at first
use.

The port's host libraries (the WAV codec in ``data/csrc``, the zstd
decoder in ``convert/csrc``) are compiled with ``$CXX`` (default ``g++``),
its CUDA kernels (``ops/csrc``) with ``nvcc`` into a library with a plain C
interface, into ``build/iris_tts_tpu_torch/`` (:data:`BUILD_DIR`) beside
the package, once per hash of the source and flags. The compiler's messages
(for ``nvcc``, ptxas' register and shared-memory report) are kept beside
the library as ``<stem>_<hash>.build.txt``. A build writes a pid-suffixed
file that is then renamed, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iris_tts_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _build(source: Path, stem: str, compiler: Callable[[], str],
           flags: Sequence[str]) -> Path:
    """``BUILD_DIR/<stem>_<hash>.so`` of ``source``, compiled with
    ``compiler()`` (looked up only when the library is not built yet) and
    ``flags``; raises ``RuntimeError`` naming the compiler when it does not
    run or the build fails."""
    key = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{key}.so"
    if lib.exists():
        return lib
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{stem}_{key}.{os.getpid()}.so"
    try:
        r = subprocess.run([cc, *flags, str(source), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=600)
    except OSError as e:
        raise RuntimeError(f"compiler {cc!r} did not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"{cc} failed on {source.name} with exit code "
                           f"{r.returncode}:\n{r.stderr[-4000:]}")
    lib.with_suffix(".build.txt").write_text(r.stderr)
    os.replace(tmp, lib)
    return lib


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    return cxx


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


def build_shared_library(source: Path, stem: str) -> Path:
    """Compile the C++ ``source`` with ``$CXX`` (once per source hash) and
    return the path of ``BUILD_DIR/<stem>_<hash>.so``."""
    return _build(source, stem, _cxx, CXX_FLAGS)


def build_cuda_library(source: Path, stem: str) -> Path:
    """Compile the CUDA ``source`` with ``nvcc`` (once per source hash) and
    return the path of ``BUILD_DIR/<stem>_<hash>.so``."""
    return _build(source, stem, _nvcc, NVCC_FLAGS)
