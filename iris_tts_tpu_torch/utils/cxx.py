"""Build a C++ or CUDA source of the port into a shared library at first
use.

The port's host libraries (the WAV codec in ``data/csrc``, the zstd
decoder in ``convert/csrc``) are compiled with ``$CXX`` (default ``g++``),
its CUDA kernels (``ops/csrc``) with ``nvcc`` into a library with a plain C
interface, into ``build/iris_tts_tpu_torch/`` (:data:`BUILD_DIR`) beside
the package, once per hash of the source and flags. A source may be built
in parts, each with defines of its own, compiled side by side and linked
into one library (the MRF kernels build a translation unit a width this
way). The compiler's messages (for ``nvcc``, ptxas' register and
shared-memory report) are kept beside the library as
``<stem>_<hash>.build.txt``. A build writes a pid-suffixed file that is
then renamed, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iris_tts_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _run(cmd: Sequence[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(list(cmd), capture_output=True, text=True,
                              timeout=600)
    except OSError as e:
        raise RuntimeError(f"compiler {cmd[0]!r} did not run: {e}") from e


def _build(source: Path, stem: str, compiler: Callable[[], str],
           flags: Sequence[str],
           parts: Sequence[Sequence[str]] = ((),)) -> Path:
    """``BUILD_DIR/<stem>_<hash>.so`` of ``source``, compiled with
    ``compiler()`` (looked up only when the library is not built yet) and
    ``flags``; raises ``RuntimeError`` naming the compiler when it does not
    run or the build fails. With more than one of ``parts`` (each a list of
    extra flags, such as ``-D`` defines), ``source`` is compiled once a
    part, side by side, into objects that are then linked into the
    library."""
    spec = " ".join(flags) + "".join(
        " | " + " ".join(p) for p in parts if len(parts) > 1)
    key = hashlib.sha256(source.read_bytes() + spec.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{key}.so"
    if lib.exists():
        return lib
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{stem}_{key}.{os.getpid()}.so"
    if len(parts) == 1:
        steps = [_run([cc, *flags, *parts[0], str(source), "-o", str(tmp)])]
    else:
        objs = [tmp.with_suffix(f".{i}.o") for i in range(len(parts))]
        compile_flags = [f for f in flags if f != "-shared"]
        try:
            with ThreadPoolExecutor(len(parts)) as pool:
                steps = list(pool.map(_run, (
                    [cc, *compile_flags, *p, "-c", str(source), "-o", str(o)]
                    for p, o in zip(parts, objs))))
            if all(r.returncode == 0 for r in steps):
                steps.append(_run([cc, *flags, *map(str, objs), "-o",
                                   str(tmp)]))
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    for r in steps:
        if r.returncode != 0:
            raise RuntimeError(f"{cc} failed on {source.name} with exit code "
                               f"{r.returncode}:\n{r.stderr[-4000:]}")
    lib.with_suffix(".build.txt").write_text("".join(r.stderr for r in steps))
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


def build_cuda_library(source: Path, stem: str,
                       parts: Sequence[Sequence[str]] = ((),)) -> Path:
    """Compile the CUDA ``source`` with ``nvcc`` (once per source hash and
    flags; once a part of ``parts``, side by side) and return the path of
    ``BUILD_DIR/<stem>_<hash>.so``."""
    return _build(source, stem, _nvcc, NVCC_FLAGS, parts)
