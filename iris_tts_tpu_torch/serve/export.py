"""Ahead-of-time serving artifacts: the fused synthesis function as
``torch.export`` programs, replayed as CUDA graphs.

Counterpart of the JAX package's ``serve/export.py``. :func:`export_pipeline`
exports the fused device function (``models/pipeline.fused_synthesis``) once
per (batch, phoneme) bucket with the weights inside, so serving needs no
model code: :class:`AotPipeline` loads the programs, captures each one once
as a ``torch.cuda.CUDAGraph`` and replays it per request, behind the same
``DynamicBatcher``/``TTSServer`` as a live pipeline
(``python -m iris_tts_tpu_torch.serve --aot DIR``). The host text frontend
stays on the host; the exported vocab maps text to ids at the edge.

Artifact layout (one directory):
    synth_b{B}_p{P}.pt2    the fused function per (batch, phoneme) bucket:
                           (ids [B,P] int64, lengths [B] int64,
                           eps [B, latent_dim, T/down_factor] (dtype),
                           temperature [] f32) →
                           (audio [B, T·hop] (dtype), mel [B,T,n_mels]
                           (dtype), n_frames [B] int32, deficit [B])
    vocwin_c{C}_x{X}.pt2   optional streaming-vocoder window:
                           (mel [1, window, n_mels] f32, start [] int64) →
                           audio [1, C·hop] (dtype)
    synth_b{B}_p{P}.aoti.pt2
                           with ``native=True``: the same program compiled
                           by AOTInductor, for the C++ serving host
                           (``serve/csrc/aoti_runner.cpp``), which needs no
                           Python; the JAX package writes the raw StableHLO
                           beside each program for its native host
    vocab.json             phoneme → id table for the host frontend
    manifest.json          format version, shapes, ladders, device, and
                           the compute dtype ("dtype": the pipeline's,
                           baked into the programs, as the JAX package
                           bakes ``pipe.dtype``); with ``native=True`` each
                           entry's ``native_file`` and the torch version
                           that compiled them (``native_torch``)

The prior noise is an input: a ``torch.Generator`` cannot be one, and its
draws depend on the shape drawn. The host side draws the live fused path's
noise (``models/pipeline.prior_noise``) at the live frame budget, which the
manifest's ladder gives, into the front of the bucket's ``eps`` and leaves
the tail zero; the tail's frames are masked. The noise is drawn in f32 and
rounded to the compute dtype, as the live path feeds it. So the artifact
reproduces the live fused path at any temperature whenever the kept frames
end at least a receptive field before the live budget (nothing compressed,
and the usual headroom of ``fused_frames_per_phoneme``); a row compressed
to the live budget differs in its last frames, where the live path sees
padding and the program sees the bucket's longer tail.

Ids and lengths are int64 here, where the JAX artifacts take int32. The
programs bake device literals (``torch.arange(..., device=...)``), so
export on the device that will serve; a loader on another device type
moves the program with ``torch.export.passes.move_to_device_pass``.

Capture and replay take separate locks: a request to a bucket whose graph
is captured replays while another bucket is being captured on the
progressive-warmup thread, as a compiled JAX executable runs while the
compile thread works on the next.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from iris_tts_tpu_torch.data.audio_io import join_wave_chunks
from iris_tts_tpu_torch.models.hifigan import (
    iter_stream_windows,
    receptive_radius_frames,
)
from iris_tts_tpu_torch.models.pipeline import (
    fused_synthesis,
    host_pcm16,
    mel_time_major,
    pick_bucket,
    prior_noise,
    to_host,
)
from iris_tts_tpu_torch.ops.length import round_up_to_multiple
from iris_tts_tpu_torch.runtime import (
    DeviceLike,
    dtype_name,
    pin_math_precision,
    resolve_device,
    resolve_dtype,
    wrap_int32,
)
from iris_tts_tpu_torch.text.frontend import (
    chunk_text_by_phonemes,
    create_text_processor,
)
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

logger = logging.getLogger(__name__)

# Calling convention of the programs. Bump whenever their inputs or
# outputs change; loaders refuse other versions with a re-export message
# instead of failing at the first call.
# v1: inputs (ids, lengths, eps, temperature), outputs (audio, mel,
#     n_frames, deficit).
AOT_FORMAT_VERSION = 1

# Eager runs of a program on a side stream before its capture, so cuDNN
# picks its plans and lazy initialisation happens outside the graph.
_CAPTURE_WARMUP_RUNS = 3


def _check_format_version(manifest: Dict, path: Path) -> None:
    got = manifest.get("format_version")
    if got != AOT_FORMAT_VERSION:
        raise ValueError(
            f"AOT artifact {path} has format_version={got}, this runtime "
            f"expects {AOT_FORMAT_VERSION}; re-export with python -m "
            "iris_tts_tpu_torch.serve.export")


@contextlib.contextmanager
def _device_mode():
    """No autograd, and ordinary (not inference) tensors, whatever mode the
    calling thread is in: static buffers made on one thread are filled in
    place from another (the batcher's device thread runs under
    ``torch.inference_mode``)."""
    with torch.inference_mode(False), torch.no_grad():
        yield


class FusedSynthesis(nn.Module):
    """:func:`~iris_tts_tpu_torch.models.pipeline.fused_synthesis` at a
    fixed frame budget, with the pipeline's weights inside: the module
    exported per bucket."""

    def __init__(self, model: nn.Module, total_frames: int,
                 use_postnet: bool, upsample: str):
        super().__init__()
        self.model = model
        self.total_frames = int(total_frames)
        self.use_postnet = bool(use_postnet)
        self.upsample = upsample

    def forward(self, ids, lengths, eps, temperature):
        return fused_synthesis(self.model, ids, lengths, eps, temperature,
                               self.total_frames, self.use_postnet,
                               self.upsample)


def window_cut(audio: torch.Tensor, start: torch.Tensor,
               chunk_samples: int) -> torch.Tensor:
    """``audio[:, start:start + chunk_samples]`` for a 0-d tensor ``start``,
    as a gather (a slice with a tensor bound is data-dependent under export
    and capture). ``start`` is clamped into range, as a dynamic slice
    clamps it."""
    start = start.clamp(0, audio.shape[1] - chunk_samples)
    idx = start + torch.arange(chunk_samples, device=audio.device)
    return audio.index_select(1, idx)


class VocoderWindow(nn.Module):
    """The streaming vocoder's device stage (``TTSPipeline._vocode_window``)
    with a tensor ``start``: vocode one fixed-size mel window and keep
    ``chunk_samples`` samples from ``start``."""

    def __init__(self, hifigan: nn.Module, chunk_samples: int):
        super().__init__()
        self.hifigan = hifigan
        self.chunk_samples = int(chunk_samples)

    def forward(self, mel, start):
        return window_cut(self.hifigan(mel), start, self.chunk_samples)


def _export(module: nn.Module, args: Tuple[torch.Tensor, ...],
            file: Path):
    """Export ``module`` at ``args``'s shapes, save it to ``file``, return
    (the exported program, its size in bytes)."""
    ep = torch.export.export(module.eval(), args, strict=False)
    torch.export.save(ep, file)
    return ep, file.stat().st_size


@functools.lru_cache(maxsize=None)
def _openmp_cxx() -> str:
    """A C++ compiler that links ``-fopenmp``, which AOTInductor passes
    when it builds a package on Linux: ``$CXX`` first, then ``g++`` and
    ``c++`` on the PATH (a ``$CXX`` wrapper without OpenMP's spec file
    cannot build one)."""
    tried = []
    for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"),
                                          shutil.which("g++"),
                                          shutil.which("c++")))):
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "omp.cpp"
            src.write_text("int main() { return 0; }\n")
            r = subprocess.run([cxx, "-fopenmp", str(src), "-o",
                                str(Path(tmp) / "omp")],
                               capture_output=True, text=True, timeout=120)
        if r.returncode == 0:
            return cxx
        tried.append(f"{cxx}: {r.stderr.strip()[-300:]}")
    raise RuntimeError("AOTInductor needs a C++ compiler that links "
                       "-fopenmp; none does: " + "; ".join(tried))


def _compile_native(ep, package: Path) -> int:
    """AOTInductor-compile the exported program ``ep`` into the package
    ``package`` for the C++ host; return its size in bytes. The compile
    runs with the port's numerics pinned (TF32 off), which the generated
    code inherits."""
    pin_math_precision()
    with torch._inductor.config.patch({"cpp.cxx": (_openmp_cxx(),)}):
        torch._inductor.aoti_compile_and_package(ep, package_path=str(package))
    return package.stat().st_size


def export_pipeline(
    pipe,
    path: Union[str, Path],
    batch_sizes: Sequence[int] = (1, 8),
    phoneme_buckets: Optional[Sequence[int]] = None,
    vocode_chunk_frames: Optional[int] = None,
    vocode_context_frames: Optional[int] = None,
    native: bool = False,
) -> Path:
    """Export the pipeline's fused path per (B, P) bucket to ``path``.

    Args:
        pipe: a ready ``TTSPipeline``; its weights go into every program,
            its device is the one the programs serve on, and its compute
            dtype is the programs' (recorded in the manifest).
        batch_sizes / phoneme_buckets: the grid to export (default phoneme
            buckets: the pipeline's). Each pair is one program whose frame
            budget is the pipeline's fused budget for the full bucket,
            never less than the live path's budget for a request that fits
            it.
        vocode_chunk_frames: also export one streaming-vocoder window
            program (:meth:`AotPipeline.vocode_streaming`);
            ``vocode_context_frames`` defaults to the generator's
            receptive-field radius.
        native: also compile each synthesis program with AOTInductor
            (``synth_b{B}_p{P}.aoti.pt2``, the C++ host's input; tens of
            seconds a bucket). The vocoder window gets none: the host
            does not serve it.
    Returns:
        the artifact directory.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    phoneme_buckets = tuple(phoneme_buckets or pipe.phoneme_buckets)
    cfg, dev = pipe.config, pipe.device
    factor, latent = cfg.vae.down_factor, cfg.vae.latent_dim
    manifest: Dict = {
        "format_version": AOT_FORMAT_VERSION,
        "device": dev.type,
        "id_dtype": "int64",
        "sample_rate": cfg.audio.sample_rate,
        "samples_per_frame": cfg.hifigan.total_upsample,
        "n_mels": cfg.hifigan.in_channels,
        "latent_dim": latent,
        "down_factor": factor,
        "fused_frames_per_phoneme": pipe.fused_frames_per_phoneme,
        "frame_buckets": list(pipe.frame_buckets),
        "upsample": pipe.upsample,
        "dtype": dtype_name(pipe.dtype),
        "entries": [],
    }
    if native:
        manifest["native_torch"] = torch.__version__
    with _device_mode():
        for b in batch_sizes:
            for p in phoneme_buckets:
                t = pipe._fused_frame_budget(np.full((b,), p))
                args = (
                    torch.full((b, p), pipe.vocab.pad_id, dtype=torch.int64,
                               device=dev),
                    torch.full((b,), p, dtype=torch.int64, device=dev),
                    torch.zeros((b, latent, t // factor), device=dev,
                                dtype=pipe.dtype),
                    torch.tensor(1.0, device=dev),
                )
                name = f"synth_b{b}_p{p}.pt2"
                ep, size = _export(FusedSynthesis(pipe.model, t,
                                                  pipe.use_postnet,
                                                  pipe.upsample),
                                   args, path / name)
                entry = {"file": name, "batch": b, "phoneme_bucket": p,
                         "frame_bucket": t, "bytes": size}
                logger.info("exported %s (T=%d, %d bytes)", name, t, size)
                if native:
                    t0 = time.perf_counter()
                    entry["native_file"] = name.replace(".pt2", ".aoti.pt2")
                    entry["native_bytes"] = _compile_native(
                        ep, path / entry["native_file"])
                    entry["native_compile_s"] = round(
                        time.perf_counter() - t0, 3)
                    logger.info("compiled %s (%.1f s)", entry["native_file"],
                                entry["native_compile_s"])
                manifest["entries"].append(entry)

        if vocode_chunk_frames:
            ctx = (vocode_context_frames if vocode_context_frames is not None
                   else receptive_radius_frames(cfg.hifigan))
            chunk = int(vocode_chunk_frames)
            window = chunk + 2 * int(ctx)
            args = (torch.zeros((1, window, cfg.hifigan.in_channels),
                                device=dev),
                    torch.tensor(0, dtype=torch.int64, device=dev))
            name = f"vocwin_c{chunk}_x{int(ctx)}.pt2"
            _, size = _export(VocoderWindow(
                pipe.model.hifigan, chunk * cfg.hifigan.total_upsample),
                args, path / name)
            manifest["vocode_window"] = {
                "file": name, "chunk_frames": chunk,
                "context_frames": int(ctx), "window_frames": window,
                "bytes": size,
            }
            logger.info("exported %s (window=%d frames)", name, window)

    pipe.vocab.save(path / "vocab.json")
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return path


def _load_program(file: Path, exported_on: str, device: torch.device):
    """A saved program as a callable module on ``device``."""
    ep = torch.export.load(file)
    if torch.device(exported_on).type != device.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep.module()


def _load_artifact(path, device: torch.device, text_processor=None,
                   defer_frontend: bool = False):
    """Shared loader of ExportedSynthesizer and AotPipeline: the manifest
    (format checked), the vocab, the text processor, and the per-(B, P)
    programs.

    ``defer_frontend=True`` returns ``tp=None`` so the caller can build the
    frontend while the first capture runs (``AotPipeline(warmup_async=
    True)``)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    _check_format_version(manifest, path)
    vocab = PhonemeVocab.load(path / "vocab.json")
    tp = (None if (defer_frontend and text_processor is None)
          else text_processor or create_text_processor())
    progs = {}
    for e in manifest["entries"]:
        progs[(e["batch"], e["phoneme_bucket"])] = (
            _load_program(path / e["file"], manifest["device"], device), e)
    return path, manifest, vocab, tp, progs


def _pick_bucket(progs, n_rows: int, max_len: int) -> Tuple[int, int]:
    """Smallest exported (B, P) bucket covering the request: the smallest
    phoneme bucket first, then the smallest batch at it."""
    fits = sorted((p, b) for (b, p) in progs if p >= max_len and b >= n_rows)
    if not fits:
        raise ValueError(
            f"request ({n_rows} rows, {max_len} phonemes) exceeds every "
            f"exported bucket {sorted(progs)}")
    p_bucket = fits[0][0]
    b_bucket = min(bb for (bb, pp) in progs if pp == p_bucket and bb >= n_rows)
    return b_bucket, p_bucket


def manifest_dtype(manifest: Dict) -> torch.dtype:
    """The programs' compute dtype (float32 for an artifact that predates
    the key)."""
    return resolve_dtype(manifest.get("dtype", "float32"))


def live_frame_budget(manifest: Dict, max_len: int) -> int:
    """The live fused path's frame budget for a request whose longest
    utterance has ``max_len`` ids (``TTSPipeline._fused_frame_budget``
    from the manifest's ladder)."""
    factor = int(manifest["down_factor"])
    est = max_len * int(manifest["fused_frames_per_phoneme"])
    return pick_bucket(round_up_to_multiple(max(est, factor), factor),
                       manifest["frame_buckets"])


def _request_inputs(manifest: Dict, id_lists: List[np.ndarray], b: int,
                    p: int, pad_id: int, seed: int, device: torch.device):
    """Host ids and lengths of a (B, P) bucket (unused rows: ``pad_id`` and
    length 1) and the live path's prior noise for the real rows [n, latent,
    T_live/down_factor], drawn on ``device`` in the programs' dtype."""
    ids = np.full((b, p), pad_id, np.int64)
    lengths = np.ones((b,), np.int64)
    for row, seq in enumerate(id_lists):
        ids[row, :len(seq)] = seq
        lengths[row] = len(seq)
    t_live = live_frame_budget(manifest, max(len(s) for s in id_lists))
    noise = prior_noise(len(id_lists), int(manifest["latent_dim"]), t_live,
                        int(manifest["down_factor"]), seed, device,
                        manifest_dtype(manifest))
    return ids, lengths, noise


def _fill_synth_inputs(bufs, ids, lengths, noise, temperature) -> None:
    """Write a request into a bucket's input tensors: the noise into the
    front of ``eps``, zeros behind it."""
    ids_t, len_t, eps_t, temp_t = bufs
    ids_t.copy_(torch.from_numpy(ids))
    len_t.copy_(torch.from_numpy(lengths))
    eps_t.zero_()
    eps_t[:noise.shape[0], :, :noise.shape[2]].copy_(noise)
    temp_t.fill_(float(temperature))


def _synth_buffers(entry: Dict, manifest: Dict, pad_id: int,
                   device: torch.device):
    b, p, t = entry["batch"], entry["phoneme_bucket"], entry["frame_bucket"]
    return (torch.full((b, p), pad_id, dtype=torch.int64, device=device),
            torch.ones((b,), dtype=torch.int64, device=device),
            torch.zeros((b, int(manifest["latent_dim"]),
                         t // int(manifest["down_factor"])), device=device,
                        dtype=manifest_dtype(manifest)),
            torch.tensor(1.0, device=device))


class ExportedSynthesizer:
    """Host-side runner of an artifact directory: picks the smallest
    exported (B, P) bucket that fits, pads, calls the program as loaded (no
    graph), trims. The bucketing contract of ``TTSPipeline.synthesize``,
    rebuilt from the artifact alone."""

    def __init__(self, path: Union[str, Path], text_processor=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        pin_math_precision()
        (_, self.manifest, self.vocab, self.text_processor,
         self._progs) = _load_artifact(path, self.device, text_processor)

    def synthesize(self, text: str, seed: int = 0,
                   temperature: float = 1.0) -> np.ndarray:
        ids = self.text_processor.text_to_ids(text, self.vocab)
        return self._synthesize_ids(ids, seed, temperature)[0]

    def _synthesize_ids(self, ids, seed: int, temperature: float):
        """One row of ids → (trimmed audio, the bucket's mel [T, n_mels],
        n_frames, deficit): the request path of :meth:`synthesize` after
        the frontend (the C++ host's reference)."""
        b, p = _pick_bucket(self._progs, 1, len(ids))
        prog, entry = self._progs[(b, p)]
        with _device_mode():
            host = _request_inputs(self.manifest, [ids], b, p,
                                   self.vocab.pad_id, wrap_int32(seed),
                                   self.device)
            bufs = _synth_buffers(entry, self.manifest, self.vocab.pad_id,
                                  self.device)
            _fill_synth_inputs(bufs, *host, temperature)
            audio, mel, n_frames, deficit = prog(*bufs)
            n = int(n_frames[0])
            hop = int(self.manifest["samples_per_frame"])
            return (to_host(audio[0, :n * hop]), to_host(mel[0]), n,
                    int(deficit[0]))


class _Program:
    """One loaded program with its static input buffers and, on CUDA, its
    captured graph and static outputs."""

    def __init__(self, prog, inputs: Tuple[torch.Tensor, ...]):
        self.prog = prog
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None

    def run(self):
        if self.graph is None:
            return self.prog(*self.inputs)
        self.graph.replay()
        return self.outputs


class AotPipeline:
    """The serving surface of ``TTSPipeline`` (what ``DynamicBatcher`` and
    ``TTSServer`` drive) over an artifact directory, with no model code.

    On CUDA, :meth:`warmup` captures each program once as a CUDA graph;
    a request fills the bucket's static inputs, replays the graph and
    copies the outputs to the host. Graphs share one memory pool and
    replay one at a time under the replay lock; a graph's outputs are
    overwritten by its next replay (and may be by another graph's), so
    they are copied out under that lock. Captures take a lock of their
    own, one at a time, and hold the replay lock only for a new graph's
    first replay: a request to a captured bucket does not wait for a
    capture in flight (capture mode ``thread_local`` leaves other threads
    free to launch and copy). A capture or replay failure raises: nothing
    falls back to eager. On the CPU (``device="cpu"``) the programs run as
    loaded. ``dtype`` is the programs' compute dtype, from the manifest;
    audio and mels come back as f32 whatever it is.

    Every exported program is the fused path, so there is no two-stage
    redo of over-compressed rows (``fused_fallback_count`` stays 0), as
    in the JAX package.
    """

    fused_fallback_count = 0

    def __init__(self, path: Union[str, Path], text_processor=None,
                 base_seed: int = 1337, warmup_async: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        pin_math_precision()
        (path, self.manifest, self.vocab, self.text_processor,
         progs) = _load_artifact(path, self.device, text_processor,
                                 defer_frontend=warmup_async)
        m = self.manifest
        self.dtype = manifest_dtype(m)
        self.hop = int(m["samples_per_frame"])
        # Duck-typed config: the serving stack reads the sample rate.
        self.config = SimpleNamespace(
            audio=SimpleNamespace(sample_rate=int(m["sample_rate"])),
            hifigan=SimpleNamespace(total_upsample=self.hop,
                                    in_channels=int(m["n_mels"])))
        self._entries = {key: e for key, (_, e) in progs.items()}
        with _device_mode():
            self._programs: Dict = {
                key: _Program(prog, _synth_buffers(e, m, self.vocab.pad_id,
                                                   self.device))
                for key, (prog, e) in progs.items()}
            vw = m.get("vocode_window")
            if vw:
                self._programs["vocwin"] = _Program(
                    _load_program(path / vw["file"], m["device"],
                                  self.device),
                    (torch.zeros((1, int(vw["window_frames"]),
                                  int(m["n_mels"])), device=self.device),
                     torch.tensor(0, dtype=torch.int64, device=self.device)))
        self.phoneme_buckets = tuple(sorted({p for (_, p) in self._entries}))
        self.batch_buckets = tuple(sorted({b for (b, _) in self._entries}))
        self.seed = base_seed
        self._seed_counter = 0
        self.fused_overflow_count = 0
        # Replay: fill a bucket's inputs, replay, copy out. Capture: one
        # capture at a time, and the shared pool. Requests waiting to
        # capture go before the background warmup's next capture.
        self._lock = threading.Lock()
        self._capture_lock = threading.Lock()
        self._waiting = 0
        self._waiting_lock = threading.Lock()
        self._ready: set = set()
        self._pool = None
        self._warm_all: Optional[threading.Event] = None
        self.warmup_errors: List[str] = []
        if warmup_async:
            # Cold-start overlap: the first capture starts on the warmup
            # thread now, and the text frontend is built meanwhile.
            self.warmup(block=False, sync_first=False)
            if self.text_processor is None:
                self.text_processor = create_text_processor()

    # -- graphs ------------------------------------------------------------

    def _prepare(self, key, request: bool = True) -> _Program:
        """The program of ``key``, captured on its first use under the
        capture lock: a request to a captured bucket never takes it, and a
        request to another waits for at most the capture in flight, since
        the background warmup lets waiting requests go first (``request``
        is False for its own captures). Call without the replay lock."""
        prog = self._programs[key]
        if key in self._ready:
            return prog
        if request:
            with self._waiting_lock:
                self._waiting += 1
        try:
            with self._capture_lock:
                if key not in self._ready:
                    self._capture(prog)
                    self._ready.add(key)
        finally:
            if request:
                with self._waiting_lock:
                    self._waiting -= 1
        return prog

    def _capture(self, prog: _Program) -> None:
        """Capture ``prog`` as a CUDA graph on the shared pool (on the CPU:
        run it once) and replay it once under the replay lock."""
        with _device_mode():
            if self.device.type != "cuda":
                prog.run()
                return
            with torch.cuda.device(self.device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(_CAPTURE_WARMUP_RUNS):
                        prog.prog(*prog.inputs)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    outputs = prog.prog(*prog.inputs)
                # A new graph's temporaries may share the pool with another
                # graph's: its first replay waits its turn like any other.
                with self._lock:
                    prog.graph, prog.outputs = graph, outputs
                    graph.replay()
                    torch.cuda.synchronize(self.device)

    def _warm_one(self, key) -> None:
        while self._waiting:  # requests waiting to capture go first
            time.sleep(0.001)
        self._prepare(key, request=False)

    def graph_pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' shared pool has reserved on the card (0 before
        the first capture, None where the allocator's snapshot does not say
        which pool a segment belongs to)."""
        if self._pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))

    def warmup(self, block: bool = True, sync_first: bool = True) -> int:
        """Capture every program before traffic, smallest bucket first,
        then the vocoder window. Returns the number captured before it
        returns.

        ``block=True`` captures them all here. ``block=False``
        (progressive) captures the smallest bucket here and the rest on a
        background thread; a request for a bucket not yet captured captures it
        inline. ``sync_first=False`` moves even the first capture to the
        thread (the ``warmup_async`` constructor). ``warm_all_done()``
        reports completion; a capture that failed on the thread is logged
        in ``warmup_errors`` and retried by the first request that needs it.
        The first call decides: a later call returns at once."""
        if self._warm_all is not None:
            return 0
        keys = sorted(k for k in self._programs if k != "vocwin")
        if "vocwin" in self._programs:
            keys.append("vocwin")
        self._warm_all = threading.Event()
        first = keys[:1] if (block or sync_first) else []
        for k in first:
            self._warm_one(k)
        rest = keys[len(first):]
        if block:
            for k in rest:
                self._warm_one(k)
            self._warm_all.set()
            return len(keys)

        def _bg():
            for k in rest:
                try:
                    self._warm_one(k)
                except Exception as e:  # noqa: BLE001 — requests retry
                    logger.exception("background capture of %s failed", k)
                    self.warmup_errors.append(f"{k}: {e!r}")
            self._warm_all.set()

        # Not a daemon: interpreter shutdown under a thread still running
        # device work can crash the process, so exit waits for the rest.
        threading.Thread(target=_bg, name="aot-warmup").start()
        return len(first)

    def warm_all_done(self) -> bool:
        return self._warm_all is not None and self._warm_all.is_set()

    # -- the DynamicBatcher surface ------------------------------------------

    def _chunk_long_text(self, text: str, max_phonemes: int) -> list:
        return chunk_text_by_phonemes(
            self.text_processor, self.vocab, text,
            min(max_phonemes, self.phoneme_buckets[-1]))

    def join_chunks(self, outs: Sequence[np.ndarray],
                    gap_ms: float = 120.0) -> np.ndarray:
        return join_wave_chunks(outs, gap_ms, self.config.audio.sample_rate)

    def _next_seed(self, seed: Optional[int]) -> int:
        if seed is None:
            self._seed_counter += 1
            seed = self.seed + self._seed_counter
        return wrap_int32(seed)

    def synthesize(self, text, seed: Optional[int] = None,
                   temperature: float = 1.0, fused: Optional[bool] = None,
                   return_mel: bool = False, pcm16: bool = False):
        """Text(s) → trimmed waveform(s): ``TTSPipeline.synthesize``'s
        contract as serving uses it. Every program is the fused path, so
        ``fused`` is ignored. Audio comes back as float32 (widened on the
        host from a bf16 program's); ``pcm16`` quantizes on the host
        (``host_pcm16``)."""
        del fused
        seed = self._next_seed(seed)
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        if not texts:
            raise ValueError("synthesize needs at least one utterance")
        id_lists = [self.text_processor.text_to_ids(t, self.vocab)
                    for t in texts]
        n = len(texts)
        b, p = _pick_bucket(self._entries, n,
                            max(len(i) for i in id_lists))
        prog = self._prepare((b, p))
        with self._lock, _device_mode():
            host = _request_inputs(self.manifest, id_lists, b, p,
                                   self.vocab.pad_id, seed, self.device)
            _fill_synth_inputs(prog.inputs, *host, temperature)
            audio, mel, n_frames, deficit = prog.run()
            audio_np = to_host(audio[:n])
            n_np = n_frames[:n].cpu().numpy()
            d_np = deficit[:n].cpu().numpy()
            mel_np = to_host(mel[:n]) if return_mel else None
        self.fused_overflow_count += int((d_np > 0).sum())
        outs = [a[: int(k) * self.hop] for a, k in zip(audio_np, n_np)]
        if pcm16:
            outs = [host_pcm16(a) for a in outs]
        if return_mel:
            mels = [m[: int(k)] for m, k in zip(mel_np, n_np)]
            return (outs[0], mels[0]) if single else (outs, mels)
        return outs[0] if single else outs

    def vocode_streaming(self, mel, pcm16: bool = False):
        """Long log-mel → waveform chunks through the window program:
        ``TTSPipeline.vocode_streaming`` with the chunk and context baked
        at export (``manifest["vocode_window"]``). The mel must be longer
        than one window (a shorter one fits one ``vocode`` call)."""
        vw = self.manifest.get("vocode_window")
        if vw is None:
            raise RuntimeError(
                "artifact was exported without a streaming-vocoder window; "
                "re-export with vocode_chunk_frames=")
        chunk, ctx = int(vw["chunk_frames"]), int(vw["context_frames"])
        window = int(vw["window_frames"])
        mel = np.asarray(mel, np.float32)
        if mel.ndim != 2:
            raise ValueError("vocode_streaming takes one [T, n_mels] mel")
        mel = np.ascontiguousarray(mel_time_major(
            mel, int(self.manifest["n_mels"])))
        t = mel.shape[0]
        if t <= window:
            raise ValueError(
                f"mel has {t} frames <= the exported window ({window}); "
                "short mels fit one vocode call")
        up = self.hop
        for a, b, w0, start_f, start_cl_f in iter_stream_windows(t, chunk,
                                                                 ctx):
            prog = self._prepare("vocwin")
            with self._lock, _device_mode():
                mel_t, start_t = prog.inputs
                mel_t.copy_(torch.from_numpy(mel[None, w0:w0 + window]))
                start_t.fill_(start_cl_f * up)
                block = to_host(prog.run()[0])
            off = (start_f - start_cl_f) * up
            out = block[off:off + (b - a) * up]
            yield host_pcm16(out) if pcm16 else out


def main(argv=None) -> None:
    """``python -m iris_tts_tpu_torch.serve.export``: write an artifact
    directory from a saved pipeline or from seeded random weights."""
    from iris_tts_tpu_torch.config import load_config
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    parser = argparse.ArgumentParser(
        description="Export the fused synthesis path per (batch, phoneme) "
        "bucket as torch.export programs (serve them with python -m "
        "iris_tts_tpu_torch.serve --aot DIR).")
    parser.add_argument("--pipeline", type=Path,
                        help="pipeline directory (TTSPipeline.save, this "
                        "package's or the JAX package's)")
    parser.add_argument("--random_weights", action="store_true",
                        help="export an untrained pipeline (smoke testing)")
    parser.add_argument("--config", type=Path, default=None,
                        help="IrisConfig JSON of this package for "
                        "--random_weights (default: IrisConfig())")
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--phoneme_buckets", type=int, nargs="+",
                        default=None,
                        help="default: the pipeline's phoneme buckets")
    parser.add_argument("--vocode_chunk_frames", type=int, default=None,
                        help="also export a streaming-vocoder window program "
                        "with this chunk size (AotPipeline.vocode_streaming)")
    parser.add_argument("--vocode_context_frames", type=int, default=None,
                        help="context per side of the vocoder window "
                        "(default: the generator's receptive-field radius)")
    parser.add_argument("--device", default=None,
                        help="torch device to export for, the one that will "
                        "serve (default: the CUDA device)")
    parser.add_argument("--native", action="store_true",
                        help="also compile each synthesis program with "
                        "AOTInductor for the C++ serving host "
                        "(iris_tts_tpu_torch/serve/csrc/aoti_runner.cpp)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.pipeline:
        pipe = TTSPipeline.load(args.pipeline, device=args.device)
    elif args.random_weights:
        config = load_config(args.config) if args.config else None
        pipe = TTSPipeline.initialize(config, device=args.device)
    else:
        parser.error("need --pipeline DIR or --random_weights")
    out = export_pipeline(pipe, args.output, batch_sizes=args.batch_sizes,
                          phoneme_buckets=args.phoneme_buckets,
                          vocode_chunk_frames=args.vocode_chunk_frames,
                          vocode_context_frames=args.vocode_context_frames,
                          native=args.native)
    logger.info("wrote serving artifacts to %s", out)


if __name__ == "__main__":
    main()
