"""Headline benchmark of the port: end-to-end synthesis realtime factor on
one card.

The port's counterpart of the JAX package's root ``bench.py``. Prints ONE
JSON line on stdout:

    {"metric": "synthesis_rtf_per_chip", "value": N, "unit": "x_realtime",
     "vs_baseline": N, ...}

``value`` is seconds of 22.05 kHz audio generated per wall-clock second by
the full synthesis path (ids → encoder → durations → device length
regulation → VAE prior decode → PostNet → HiFiGAN → waveform) at B=128,
bf16 compute (params f32), steady state, on one card; ``rtf_b8`` is the
same at the serving batch B=8. Each timed loop queues its dispatches and
reads one on-device checksum back at its end, the one host sync of the
loop; the first call of each shape (cuDNN's choice of execution plans) is
not timed. ``vs_baseline`` = value / 50, the JAX package's self-set
target. Diagnostics go to stderr.

Beside it, as the JAX bench: the same loop synced after every dispatch;
the fused single-utterance dispatch's p50 (B=1, 256 frames); the public
``synthesize(text)`` p50 and its ``pcm16=True`` variant; the frontend's
text → ids time, memoized and not; the roofline of the headline dispatch
(``scripts.roofline.count_cost`` and its data-sheet peaks:
``sol_rt_factor`` is the realtime factor at the bound, ``sol_fraction``
the bound over the measured wall, ``sol_bound`` ``"hbm"`` or ``"flops"``).

Cold start, first, in two child processes: ``python -m
iris_tts_tpu_torch.serve.export --random_weights`` writes one AOT program
(B=1, 64 phonemes) on the card (``aot_export_s``, its wall time); a fresh
process then loads it with ``AotPipeline(dir, warmup_async=True)`` and
synthesizes one sentence. Its marks, on this card:
``cold_start_env_floor_s`` is ``import torch`` and the first CUDA op (the
context); ``cold_start_marginal_jit_s`` a second trivial op (a new
kernel's first launch); ``cold_start_import_s`` the serving module's
import; ``cold_start_init_s`` the constructor (program load, text
frontend, the capture thread started); ``cold_start_backend_compile_s``
the wait for every CUDA-graph capture (each program's first runs, where
cuDNN picks its plans, then the capture); ``cold_start_first_synth_s``
the first ``synthesize`` (a graph replay); ``cold_start_framework_s``
import + init + first synthesize; ``cold_start_to_first_audio_s`` process
start to audio on the host. A child that fails fails the benchmark;
``IRIS_BENCH_SKIP_COLDSTART=1`` skips the cold start.

``--device cpu`` runs the JAX bench's CPU shape (B=1, 256 frames, two
iterations) and prints its short line with ``"device": "cpu"`` (no bulk,
latencies, roofline or cold start, as JAX's CPU line has none). Without
``--device`` and without CUDA it raises.

Usage:
    python -m iris_tts_tpu_torch.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import dtype_name, resolve_device
from iris_tts_tpu_torch.scripts import roofline
from iris_tts_tpu_torch.scripts.common import add_device_arg, device_label

VS_BASELINE_RTF = 50.0
# The serving-shaped workload: 8 utterances of 64 phonemes in the
# 1024-frame bucket (11.9 s of audio each), 10 timed dispatches.
SHAPE = (8, 64, 1024, 10)
CPU_SHAPE = (1, 64, 256, 2)
# One bulk batch, measured as it is: no smaller batch stands in for it.
BULK_BATCH = 128
BULK_ITERS = 5
FUSED_FRAMES = 256
LATENCY_CALLS = 11
TEXT = "The quick brown fox jumps over the lazy dog."
COLD_MARKS = ("ENV_FLOOR_S", "MARGINAL_JIT_S", "IMPORT_S", "DESERIALIZE_S",
              "WARM_S", "FIRST_SYNTH_S", "FIRST_AUDIO_S")
CHILD_TIMEOUT_S = 900

# The cold-start child: a fresh process timing each step to first audio.
_COLD_CHILD = """\
import sys, time
t0 = time.time()
import numpy as np
import torch
torch.ones(1, device=sys.argv[3]).add_(1).item()
print(f"ENV_FLOOR_S={time.time() - t0:.4f}")
t_m = time.time()
(torch.ones(1, device=sys.argv[3]) * 2 + 3).item()
print(f"MARGINAL_JIT_S={time.time() - t_m:.4f}")
t_i = time.time()
from iris_tts_tpu_torch.serve.export import AotPipeline
print(f"IMPORT_S={time.time() - t_i:.4f}")
t_d = time.time()
aot = AotPipeline(sys.argv[1], warmup_async=True, device=sys.argv[3])
print(f"DESERIALIZE_S={time.time() - t_d:.4f}")
t_w = time.time()
while not aot.warm_all_done():
    time.sleep(0.01)
if aot.warmup_errors:
    raise RuntimeError(f"captures failed: {aot.warmup_errors}")
print(f"WARM_S={time.time() - t_w:.4f}")
t_s = time.time()
audio = aot.synthesize(sys.argv[2], seed=0)
print(f"FIRST_SYNTH_S={time.time() - t_s:.4f}")
if not (audio.size > 0 and np.isfinite(audio).all()):
    raise RuntimeError("first audio empty or not finite")
print(f"FIRST_AUDIO_S={time.time() - t0:.4f}")
"""


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


@torch.inference_mode()
def synth_step(pipe: TTSPipeline, ids: np.ndarray, lengths: np.ndarray,
               total_frames: int, seed: int, acc: torch.Tensor,
               temperature: float = 1.0):
    """The timed dispatch, the JAX bench's jitted ``synth``: stage A
    (``_stage_a_device``) then stage B (``_stage_b``) at ``total_frames``,
    and the waveform's f32 sum added to ``acc`` on the device. Returns
    (audio [B, total_frames × hop], the new ``acc``); nothing waits for
    the device."""
    enc, frames, _ = pipe._stage_a_device(ids, lengths)
    audio = pipe._stage_b(enc, frames, total_frames, seed, temperature,
                          False, len(ids)).audio
    return audio, acc + audio.sum(dtype=torch.float32)


def timed_loop(pipe, ids, lengths, total_frames: int, n: int):
    """Seconds per dispatch of ``n`` queued :func:`synth_step` calls (seeds
    0 … n−1) with one host read of the checksum at the end, and the last
    audio."""
    acc = torch.zeros((), device=pipe.device)
    t0 = time.time()
    for i in range(n):
        audio, acc = synth_step(pipe, ids, lengths, total_frames, i, acc)
    float(acc)
    return (time.time() - t0) / n, audio


def first_call_s(pipe, ids, lengths, total_frames: int) -> float:
    """Wall seconds of the first call of a shape, read back."""
    t0 = time.time()
    _, acc = synth_step(pipe, ids, lengths, total_frames, 0,
                        torch.zeros((), device=pipe.device))
    checksum = float(acc)
    s = time.time() - t0
    log(f"first call B={len(ids)} T={total_frames} = {s:.2f}s "
        f"(sum={checksum:.3f})")
    return s


def p50_s(fn: Callable[[int], object], n: int = LATENCY_CALLS) -> float:
    """Median wall seconds of ``fn(i)`` for i in 0 … n−1; ``fn`` returns
    host data, so the device work is done when it returns."""
    ts = []
    for i in range(n):
        t0 = time.time()
        fn(i)
        ts.append(time.time() - t0)
    return sorted(ts)[n // 2]


def sol_of(pipe, ids, lengths, total_frames: int, audio_s: float,
           rtf: float) -> Dict:
    """The JAX bench's roofline keys for one dispatch: its (FLOPs, bytes)
    from ``roofline.count_cost`` at ``roofline``'s data-sheet peaks for
    the pipeline's dtype."""
    dtype = dtype_name(pipe.dtype)
    cost = roofline.count_cost(
        synth_step, pipe, ids, lengths, total_frames, 0,
        torch.zeros((), device=pipe.device))
    row, = roofline.roofline_rows({"dispatch": cost}, audio_s,
                                  roofline.PEAK_TFLOPS[dtype],
                                  roofline.PEAK_HBM_GBPS)
    sol_rt = row["sol_rt_factor"]
    out = {"sol_rt_factor": round(sol_rt, 1),
           "sol_fraction": round(rtf / sol_rt, 3),
           "sol_bound": "hbm" if row["bound"] == "HBM" else "flops"}
    log(f"roofline: {row['gflops']:.1f} GFLOP, {row['gbytes']:.2f} GB "
        f"(B={len(ids)}, {dtype}) -> speed of light {sol_rt:.0f}x realtime "
        f"({out['sol_bound']}-bound); running at {100 * rtf / sol_rt:.1f}% "
        f"of light")
    return out


def measure_cold_start(device: torch.device) -> Dict:
    """The two cold-start children (module docstring): one exports, a fresh
    one loads, captures and synthesizes. Raises if either fails."""
    repo = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory(prefix="iris_bench_aot_") as tmp:
        aot = str(Path(tmp) / "aot")
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "iris_tts_tpu_torch.serve.export",
             "--random_weights", "--output", aot, "--batch_sizes", "1",
             "--phoneme_buckets", "64", "--device", str(device)],
            cwd=repo, capture_output=True, text=True,
            timeout=CHILD_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(f"AOT export child exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        export_s = time.time() - t0
        log(f"AOT export (child process, {device}) took {export_s:.1f}s")
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", _COLD_CHILD, aot, TEXT,
                            str(device)],
                           cwd=repo, capture_output=True, text=True,
                           timeout=CHILD_TIMEOUT_S)
        total_s = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"cold-start child exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return cold_start_keys(r.stdout, export_s, total_s)


def cold_start_keys(stdout: str, export_s: float, total_s: float) -> Dict:
    """The JAX bench's cold-start keys from the child's ``NAME=seconds``
    lines; a missing mark raises."""
    marks = {}
    for line in stdout.splitlines():
        name, _, value = line.partition("=")
        if name in COLD_MARKS:
            marks[name] = float(value)
    missing = [m for m in COLD_MARKS if m not in marks]
    if missing:
        raise RuntimeError(f"cold-start child printed no {missing}")
    framework_s = (marks["IMPORT_S"] + marks["DESERIALIZE_S"]
                   + marks["FIRST_SYNTH_S"])
    log(f"cold start to first audio (AOT serving path) = "
        f"{marks['FIRST_AUDIO_S']:.1f}s in-process: torch + CUDA context "
        f"{marks['ENV_FLOOR_S']:.1f}s (a second trivial op after it: "
        f"{marks['MARGINAL_JIT_S']:.3f}s), graph captures "
        f"{marks['WARM_S']:.1f}s, framework share {framework_s:.2f}s; "
        f"{total_s:.1f}s including interpreter spawn")
    return {
        "cold_start_to_first_audio_s": round(marks["FIRST_AUDIO_S"], 2),
        "cold_start_env_floor_s": round(marks["ENV_FLOOR_S"], 2),
        "cold_start_marginal_jit_s": round(marks["MARGINAL_JIT_S"], 2),
        "cold_start_backend_compile_s": round(marks["WARM_S"], 2),
        "cold_start_framework_s": round(framework_s, 2),
        "cold_start_import_s": round(marks["IMPORT_S"], 2),
        "cold_start_init_s": round(marks["DESERIALIZE_S"], 2),
        "cold_start_first_synth_s": round(marks["FIRST_SYNTH_S"], 2),
        "aot_export_s": round(export_s, 2),
    }


def headline(rtf_b8: float, mel_fps_b8: float, bulk: Dict,
             fused_p50_s: float, api_p50_s: float, pcm_p50_s: float,
             sol: Dict, cold: Dict) -> Dict:
    """The card's JSON line, in the JAX bench's keys and order: the bulk
    batch's realtime factor is the headline ``value``."""
    value = bulk["bulk_rtf"]
    return {
        "metric": "synthesis_rtf_per_chip",
        "value": round(value, 2),
        "unit": "x_realtime",
        "vs_baseline": round(value / VS_BASELINE_RTF, 3),
        "mel_frames_per_sec": bulk["bulk_mel_frames_per_sec"],
        "rtf_b8": round(rtf_b8, 2),
        "mel_frames_per_sec_b8": round(mel_fps_b8, 1),
        **bulk,
        "p50_fused_dispatch_ms": round(fused_p50_s * 1e3, 2),
        "p50_public_api_ms": round(api_p50_s * 1e3, 2),
        "p50_public_api_pcm16_ms": round(pcm_p50_s * 1e3, 2),
        **sol,
        **cold,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    add_device_arg(ap)
    return ap


def main(argv=None) -> Dict:
    """Prints the JSON line (stdout) and the diagnostics (stderr); returns
    the JSON object."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    on_cpu = device.type == "cpu"
    # Cold start first, before this process takes the card's memory.
    cold = ({} if on_cpu or os.environ.get("IRIS_BENCH_SKIP_COLDSTART")
            else measure_cold_start(device))
    log(f"device = {device_label(device)}")

    cfg = IrisConfig()
    # bf16 compute is the serving default (params stay f32).
    pipe = TTSPipeline.initialize(cfg, seed=1337, dtype=torch.bfloat16,
                                  device=device)
    B, P, T, n_iters = CPU_SHAPE if on_cpu else SHAPE
    if on_cpu:
        log(f"CPU run: workload B={B}, T={T}, {n_iters} iterations")
    rng = np.random.default_rng(1337)
    ids = rng.integers(2, len(pipe.vocab), size=(B, P))
    lengths = np.full((B,), P, np.int64)
    sr = cfg.audio.sample_rate
    hop = cfg.hifigan.total_upsample

    first_call_s(pipe, ids, lengths, T)
    wall, audio = timed_loop(pipe, ids, lengths, T, n_iters)

    # Diagnostic: the same loop read back after every dispatch.
    t0 = time.time()
    for i in range(n_iters):
        float(synth_step(pipe, ids, lengths, T, i,
                         torch.zeros((), device=device))[1])
    wall_synced = (time.time() - t0) / n_iters
    log(f"per-dispatch-synced steady state = {wall_synced * 1e3:.1f} ms "
        f"({B * T / wall_synced:.0f} mel frames/s)")

    audio_s = audio.shape[0] * audio.shape[1] / sr
    rtf = audio_s / wall
    mel_fps = B * T / wall
    log(f"{audio_s:.1f}s audio in {wall * 1e3:.1f}ms "
        f"({tuple(audio.shape)}) -> {rtf:.1f}x realtime, {mel_fps:.0f} mel "
        f"frames/s")
    if on_cpu:
        out = {"metric": "synthesis_rtf_per_chip", "value": round(rtf, 2),
               "unit": "x_realtime",
               "vs_baseline": round(rtf / VS_BASELINE_RTF, 3),
               # Not a card number: the caller asked for the CPU.
               "device": "cpu"}
        print(json.dumps(out), flush=True)
        return out

    # Bulk throughput: B=128 in the same 1024-frame bucket.
    ids_b = rng.integers(2, len(pipe.vocab), size=(BULK_BATCH, P))
    len_b = np.full((BULK_BATCH,), P, np.int64)
    torch.cuda.reset_peak_memory_stats(device)
    compile_bulk_s = first_call_s(pipe, ids_b, len_b, T)
    wall_b, audio_b = timed_loop(pipe, ids_b, len_b, T, BULK_ITERS)
    audio_s_b = audio_b.shape[0] * audio_b.shape[1] / sr
    bulk = {"bulk_batch": BULK_BATCH,
            "bulk_rtf": round(audio_s_b / wall_b, 2),
            "bulk_mel_frames_per_sec": round(BULK_BATCH * T / wall_b, 1)}
    log(f"bulk throughput B={BULK_BATCH}: {audio_s_b:.0f}s audio in "
        f"{wall_b * 1e3:.0f}ms -> {bulk['bulk_rtf']:.0f}x realtime (first "
        f"call {compile_bulk_s:.1f}s; peak allocated "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB)")
    del audio_b

    # The fused single-dispatch path: one utterance, read back.
    ids1, lengths1 = ids[:1], lengths[:1]

    @torch.inference_mode()
    def fused_one(seed: int) -> float:
        disp, _ = pipe._fused_device(ids1, lengths1, FUSED_FRAMES, seed,
                                     1.0, False)
        return float(disp.audio.sum())

    fused_one(0)
    p50 = p50_s(fused_one)
    log(f"p50 single-utterance latency (fused single dispatch) = "
        f"{p50 * 1e3:.1f} ms for {FUSED_FRAMES * hop / sr:.2f}s of audio")

    # The public API: text in, trimmed waveform on the host.
    pipe.synthesize(TEXT, seed=0)
    api_p50 = p50_s(lambda i: pipe.synthesize(TEXT, seed=i))
    log(f"p50 public-API synthesize latency = {api_p50 * 1e3:.1f} ms")
    pipe.synthesize(TEXT, seed=0, pcm16=True)
    pcm_p50 = p50_s(lambda i: pipe.synthesize(TEXT, seed=i, pcm16=True))

    frontend_cached_ms = p50_s(lambda i: pipe._encode_texts([TEXT])) * 1e3

    def uncached(i):
        pipe._ids_cache.clear()
        pipe._encode_texts([TEXT])

    frontend_uncached_ms = p50_s(uncached) * 1e3
    log(f"public-API breakdown: frontend text->ids "
        f"{frontend_uncached_ms:.2f} ms uncached / {frontend_cached_ms:.2f} "
        f"ms memoized; fused device dispatch {p50 * 1e3:.1f} ms; residual "
        f"(upload+fetch+trim) "
        f"{max(api_p50 * 1e3 - frontend_cached_ms - p50 * 1e3, 0):.1f} ms; "
        f"pcm16 variant p50 {pcm_p50 * 1e3:.1f} ms")

    sol = sol_of(pipe, ids_b, len_b, T, audio_s_b, bulk["bulk_rtf"])
    out = headline(rtf, mel_fps, bulk, p50, api_p50, pcm_p50, sol, cold)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
