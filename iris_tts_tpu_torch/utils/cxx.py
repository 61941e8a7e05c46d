"""Build a C++ source of the port into a shared library at first use.

The port's host libraries (the WAV codec in ``data/csrc``, the zstd
decoder in ``convert/csrc``) are compiled with ``$CXX`` (default ``g++``)
into ``build/iris_tts_tpu_torch/`` (:data:`BUILD_DIR`) beside the package,
once per hash of the source and flags. A build writes a pid-suffixed file
that is then renamed, so concurrent processes never load a half-written
library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iris_tts_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def build_shared_library(source: Path, stem: str) -> Path:
    """Compile ``source`` (once per source hash) and return the path of
    ``BUILD_DIR/<stem>_<hash>.so``; raises ``RuntimeError`` naming the
    compiler when there is none or the build fails."""
    key = hashlib.sha256(
        source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{key}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler to build {source.name}: set "
                           "CXX or put g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{stem}_{key}.{os.getpid()}.so"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"C++ compiler {cxx!r} did not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {source.name} with exit code "
                           f"{r.returncode}:\n{r.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib
