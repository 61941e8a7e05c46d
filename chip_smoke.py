"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port (``iris_tts_tpu_torch``) through the entry points a user
calls, at the full default width with seeded random weights, and holds
every kernel against its plain PyTorch version:

1. build the log-mel kernel (``iris_tts_tpu_torch/ops/csrc/log_mel.cu``)
   from the sources in this checkout;
2. kernel vs plain version on 10 s audio, a 4000-sample clip, a
   300-sample clip (both frames in the padding), a batch of 3 with an odd
   length and a batch of 8 × 10 s (max-abs ≤ 2e-3), with the times of the
   kernel, the plain version and a cuFFT yardstick (``torch.stft`` then
   magnitude, mel matmul and log; the port never calls it) and the
   kernel's bound;
3. synthesis at full width: the fused path (one sentence) and the
   two-stage path (a batch of 4), with their latencies;
4. copy synthesis: log-mel of the phase-3 audio through the kernel, then
   ``vocode``;
5. the same pipeline on the card and on the CPU at temperature 0: equal
   frame counts, waveform max-abs ≤ 1e-3 (catches TF32).

Phases 3 and 4 are the main path: the kernels' launch counts are zeroed
just before them and read just after, and a kernel of the path that was
not launched fails the run. The last three lines are the card's name and
power limit, a ``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero; so
does a host without a CUDA device.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): f32 on
# the CUDA cores and HBM3 bandwidth. bound_ms is work / peak.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SENTENCE = "Hello world, this is the iris text to speech system."
BATCH = [
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $12.50 on January 3, 1984.",
    "Speech synthesis on a graphics card.",
    "Short one.",
]
SHORT = "Hello world."


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_cuda_ms(fn, reps: int = 200, warmup: int = 5,
                 graph: bool = True) -> float:
    """Device time of one call: ``reps`` calls between one pair of CUDA
    events, divided by ``reps``, after a warm-up. With ``graph`` the calls
    are captured in one CUDA graph and replayed, so the host side of each
    call (Python, allocation, the launch) stays out of the window even
    where it takes longer than the device work; without it the calls are
    issued eagerly back to back, which is what a caller in a loop sees."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median wall time of a call that returns host data (so the device
    work is done when it returns)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a, b) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    return float((a - b).abs().max()) if a.numel() else 0.0


def log_mel_work(batch: int, n_samples: int, cfg, tables):
    """(operations, bytes) the log-mel function needs at least: per frame a
    real FFT (2.5 n log2 n), the window (n), the magnitude (3 per bin), the
    mel projection (2 per filterbank nonzero) and the log (1 per mel); the
    audio read once, the output written once, and the window, twiddle and
    sparse filterbank tables (``tables``, as the kernel reads them)."""
    n = cfg.n_fft
    t = 1 + n_samples // cfg.hop_length
    per_frame = (2.5 * n * math.log2(n) + n + 3 * (n // 2 + 1)
                 + 2 * tables.fb_weights.size + cfg.n_mels)
    nbytes = (4 * (batch * n_samples + batch * t * cfg.n_mels)
              + sum(a.nbytes for a in tables))
    return batch * t * per_frame, nbytes


def dense_dft_work(batch: int, n_samples: int, cfg):
    """(operations, bytes) of the dense-DFT formulation, the yardstick of
    the kernel's first design: two [T, n_fft] @ [n_fft, n_freqs]
    contractions and one [T, n_freqs] @ [n_freqs, n_mels] per row; audio,
    both DFT matrices and the filterbank read once, the output written
    once."""
    t = 1 + n_samples // cfg.hop_length
    n_freqs = cfg.n_fft // 2 + 1
    flops = batch * t * (2 * 2 * cfg.n_fft * n_freqs
                         + 2 * n_freqs * cfg.n_mels)
    nbytes = 4 * (batch * n_samples + 2 * cfg.n_fft * n_freqs
                  + n_freqs * cfg.n_mels + batch * t * cfg.n_mels)
    return flops, nbytes


def bound(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of work over peak."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def log_mel_library(audio, cfg, window, fb_t):
    """The same function from library calls (the yardstick, never called
    by the port): cuFFT through ``torch.stft``, the floored magnitude, the
    mel matmul and the clamped log, in f32."""
    spec = torch.stft(audio, cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                      center=True, pad_mode="constant", return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).square().sum(-1) + 1e-12)
    mel = fb_t @ mag
    return torch.log(torch.clamp(mel, min=cfg.log_clip_min)).transpose(-1, -2)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    import iris_tts_tpu_torch
    from iris_tts_tpu_torch import AudioConfig, IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import (
        log_mel_spectrogram,
        log_mel_spectrogram_plain,
        mel_filterbank,
        padded_window,
    )

    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = mel_cuda.build_library()
    mel_cuda._library()
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_suffix(".ptxas.txt")
    ptxas_info = " | ".join(
        ln.strip() for ln in ptxas.read_text().splitlines()
        if "registers" in ln or "spill" in ln) if ptxas.exists() else "n/a"
    print(f"phase 1 build: log_mel.cu -> {lib_path.name} in {build_s:.1f} s; "
          f"ptxas: {ptxas_info}", flush=True)

    # -- 2. kernel vs plain, with the cuFFT yardstick ----------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32
    cfg = AudioConfig()
    tables = mel_cuda.kernel_tables(cfg)
    window = torch.from_numpy(padded_window(cfg.n_fft, cfg.win_length)).to(dev)
    fb_t = torch.from_numpy(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax).T.copy()
    ).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    sr = cfg.sample_rate
    t = torch.arange(10 * sr) / sr
    tone = 0.4 * torch.sin(2 * torch.pi * 440 * t)

    def clip(*shape):
        return tone[:shape[-1]] + 0.05 * torch.randn(*shape, generator=gen)

    inputs = {
        "single_10s": clip(10 * sr),
        "short": clip(4000),          # 16 frames: one group of the kernel
        "tiny_300": clip(300),        # 2 frames, both in the padding
        "batch3_odd": clip(3, 70001),  # odd row length
        "batch8_10s": clip(8, 10 * sr),
    }
    worst = 0.0
    timing = {}
    for name, audio in inputs.items():
        a = audio.to(dev)
        got = log_mel_spectrogram(a, cfg)
        torch.cuda.synchronize()
        want = log_mel_spectrogram_plain(a, cfg)
        lib = log_mel_library(a, cfg, window, fb_t)
        err = max_abs(got, want)
        lib_err = max_abs(lib, want)
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), f"finite log-mel ({name})")
        check(err <= 2e-3, f"kernel vs plain max-abs {err} <= 2e-3 ({name})")
        check(lib_err <= 2e-3,
              f"yardstick vs plain max-abs {lib_err} <= 2e-3 ({name})")
        k_ms = time_cuda_ms(lambda: mel_cuda.log_mel_cuda(a, cfg))
        p_ms = time_cuda_ms(lambda: log_mel_spectrogram_plain(a, cfg))
        l_ms = time_cuda_ms(lambda: log_mel_library(a, cfg, window, fb_t))
        e_ms = time_cuda_ms(lambda: mel_cuda.log_mel_cuda(a, cfg),
                            graph=False)
        flops, nbytes = log_mel_work(a.shape[0] if a.dim() > 1 else 1,
                                     a.shape[-1], cfg, tables)
        b_ms, b_by = bound(flops, nbytes)
        timing[name] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"phase 2 log-mel {name} {tuple(a.shape)} -> "
              f"{tuple(got.shape)}: max-abs {err:.3e} (yardstick "
              f"{lib_err:.3e}); kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
              f"cuFFT yardstick {l_ms:.5f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB), "
              f"kernel/bound {k_ms / b_ms:.2f}x; kernel issued eagerly "
              f"{e_ms:.5f} ms a call (device times: CUDA graph of 200 "
              f"calls; {card})", flush=True)
    b8 = inputs["batch8_10s"]
    k_ms, p_ms, l_ms, bound_ms, bound_by = timing["batch8_10s"]
    d_flops, d_bytes = dense_dft_work(b8.shape[0], b8.shape[1], cfg)
    d_ms, d_by = bound(d_flops, d_bytes)
    print(f"phase 2 bound at batch8_10s: FFT count {bound_ms:.5f} ms "
          f"({bound_by}), kernel {k_ms / bound_ms:.2f}x it; the dense-DFT "
          f"count of the first design {d_flops / 1e9:.2f} GFLOP, "
          f"{d_bytes / 1e6:.2f} MB -> {d_ms:.4f} ms ({d_by}); worst kernel "
          f"max-abs {worst:.3e}",
          flush=True)

    # -- main path: phases 3 and 4 ------------------------------------------
    mel_cuda.log_mel_cuda.launches = 0

    # 3. synthesis at full width
    t0 = time.perf_counter()
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0)
    print(f"phase 3 init: full-width pipeline "
          f"({sum(p.numel() for p in pipe.model.parameters()) / 1e6:.2f} M "
          f"params) in {time.perf_counter() - t0:.1f} s", flush=True)
    hop = pipe.config.hifigan.total_upsample
    audio, mel = pipe.synthesize(SENTENCE, seed=1, return_mel=True)
    check(len(audio) == mel.shape[0] * hop and len(audio) > 0,
          "fused audio length = n_frames x hop")
    check(bool(np.isfinite(audio).all()), "fused audio finite")
    check(float(np.abs(audio).max()) > 0.0, "fused audio not silent")
    fused_ms = time_host_ms(lambda: pipe.synthesize(SENTENCE, seed=1))
    print(f"phase 3 fused: {len(audio)} samples ({mel.shape[0]} frames), "
          f"rms {float(np.sqrt(np.mean(audio ** 2))):.3e}; latency "
          f"{fused_ms:.2f} ms (median of 5; {card})", flush=True)
    outs, mels = pipe.synthesize(BATCH, seed=2, return_mel=True)
    check(len(outs) == len(BATCH), "batch row count")
    for a, m in zip(outs, mels):
        check(len(a) == m.shape[0] * hop and len(a) > 0,
              "batch audio length = n_frames x hop")
        check(bool(np.isfinite(a).all()), "batch audio finite")
        check(float(np.abs(a).max()) > 0.0, "batch audio not silent")
    batch_ms = time_host_ms(lambda: pipe.synthesize(BATCH, seed=2))
    print(f"phase 3 two-stage batch of {len(BATCH)}: frames "
          f"{[m.shape[0] for m in mels]}; latency {batch_ms:.2f} ms "
          f"(median of 5; {card})", flush=True)

    # 4. copy synthesis through the kernel
    feats = log_mel_spectrogram(torch.from_numpy(audio).to(dev), cfg)
    check(feats.shape == (1 + len(audio) // hop, cfg.n_mels),
          "log-mel shape")
    resynth = pipe.vocode(feats)
    check(len(resynth) == feats.shape[0] * hop, "vocoded length")
    check(bool(np.isfinite(resynth).all()), "vocoded audio finite")
    print(f"phase 4 copy synthesis: {len(audio)} samples -> log-mel "
          f"{tuple(feats.shape)} -> {len(resynth)} samples", flush=True)
    launches = mel_cuda.log_mel_cuda.launches
    check(launches >= 1, "the main path launched the log-mel kernel")

    # -- 5. card vs CPU ----------------------------------------------------
    cpu = TTSPipeline.initialize(IrisConfig(), seed=0, device="cpu")
    a_gpu, m_gpu = pipe.synthesize(SHORT, temperature=0.0, return_mel=True)
    a_cpu, m_cpu = cpu.synthesize(SHORT, temperature=0.0, return_mel=True)
    check(m_gpu.shape == m_cpu.shape, "card and CPU frame counts")
    wave_err, mel_err = max_abs(a_gpu, a_cpu), max_abs(m_gpu, m_cpu)
    peak = float(np.abs(a_cpu).max())
    check(wave_err <= 1e-3, f"card vs CPU waveform max-abs {wave_err}")
    # Random-weight audio is small (HiFiGAN's normal(0.01) init), so hold
    # the error relative to the peak to the same 1e-3 as well.
    check(wave_err <= 1e-3 * peak,
          f"card vs CPU waveform max-abs {wave_err} <= 1e-3 x peak {peak}")
    check(mel_err <= 1e-3, f"card vs CPU mel max-abs {mel_err}")
    print(f"phase 5 card vs CPU ({m_cpu.shape[0]} frames): waveform max-abs "
          f"{wave_err:.3e} (peak {peak:.3e}, relative "
          f"{wave_err / max(peak, 1e-30):.3e}), mel max-abs {mel_err:.3e}",
          flush=True)

    # -- where the time goes: one fused synthesize under the profiler --------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.synthesize(SENTENCE, seed=1)
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only: a CPU op's row repeats the device time of the
    # kernels it launched.
    dev_rows = [(e.key, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    dev_us = sum(t for _, t in dev_rows)
    if dev_us > 0:
        top = sorted(dev_rows, key=lambda r: -r[1])[:6]
        print(f"profile fused synthesize (profiler on): wall "
              f"{wall_us / 1e3:.2f} ms, "
              f"device busy {dev_us / 1e3:.2f} ms "
              f"({100 * dev_us / wall_us:.1f}%); top device time: "
              + "; ".join(f"{k[:60]} {t / 1e3:.2f} ms" for k, t in top)
              + f" ({card})", flush=True)
    else:
        print("profile fused synthesize: the profiler recorded no device "
              "time (not measured)", flush=True)

    jax_pkg = iris_tts_tpu_torch.__name__.removesuffix("_torch")
    kernels = [{
        "name": "log_mel",
        "route": "cuda",
        "source": "iris_tts_tpu_torch/ops/csrc/log_mel.cu",
        "replaces": f"{jax_pkg}/ops/mel_pallas.py:110",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": l_ms,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
