"""Build of the C++ serving host (``serve/csrc/aoti_runner.cpp``).

The host serves an artifact directory that ``export_pipeline(...,
native=True)`` wrote, with no Python at all (its usage is in the source's
header). :func:`build_host` compiles it with ``g++`` against the installed
libtorch at first use into ``build/iris_tts_tpu_torch/`` (once per source
hash, flags and torch version; a build goes to a pid-suffixed file that is
then renamed, so concurrent processes never run a half-written binary),
linked with the port's own WAV codec (``data/csrc/wavio.cpp``). Unlike the
WAV codec, the host has no Python fallback: a failed build raises with
g++'s output.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "serve" / "csrc" / "aoti_runner.cpp",
           _PKG / "data" / "csrc" / "wavio.cpp")
BUILD_DIR = _PKG.parent / "build" / "iris_tts_tpu_torch"


def _cxx_standard() -> str:
    """The C++ standard torch's own ``cpp_extension`` compiles against for
    the installed version (its headers may need it)."""
    from torch.utils import cpp_extension

    found = re.findall(r"-std=c\+\+(\d+)", inspect.getsource(cpp_extension))
    return f"c++{max(int(v) for v in found)}" if found else "c++17"


def _host_flags() -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of the host for the installed torch."""
    from torch.utils import cpp_extension

    lib_dirs = cpp_extension.library_paths()
    compile_flags = [
        "-O2", f"-std={_cxx_standard()}", "-Wall", "-pthread",
        f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
        f'-DIRIS_TORCH_VERSION="{torch.__version__}"',
        *(f"-I{p}" for p in cpp_extension.include_paths())]
    # --no-as-needed: nothing in the host names a symbol of torch_cuda, but
    # loading it registers the CUDA backend (device, generator, AOTInductor
    # runner) that a CUDA package needs.
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    link_flags = [*(f"-L{p}" for p in lib_dirs),
                  *(f"-Wl,-rpath,{p}" for p in lib_dirs),
                  "-Wl,--no-as-needed", *libs, "-Wl,--as-needed", "-ldl"]
    return compile_flags, link_flags


def build_host() -> Path:
    """Compile the host (once per source hash, flags and torch version) and
    return the binary's path; raises with g++'s output if it cannot."""
    compile_flags, link_flags = _host_flags()
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(compile_flags + link_flags).encode())
    binary = BUILD_DIR / f"aoti_runner_{digest.hexdigest()[:16]}"
    if binary.exists():
        return binary
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{binary.name}.{os.getpid()}"
    r = subprocess.run(
        [cxx, *compile_flags, *map(str, SOURCES), "-o", str(tmp),
         *link_flags],
        capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed with exit code {r.returncode}:\n{r.stderr[-6000:]}")
    os.replace(tmp, binary)
    return binary
