"""Log-mel feature extraction: the hand-written kernel against the
differentiable composition, on the card.

The port's counterpart of the JAX package's ``scripts/bench_mel.py``
(Pallas against XLA): times ``ops.stft.log_mel_spectrogram(impl="xla")``
(the windowed-DFT matmul, floored magnitude, mel matmul and log that the
GAN's mel loss differentiates) against the CUDA kernel
``ops.mel_cuda.log_mel_cuda`` on N seconds of audio, single and batched,
with ``scripts.common.avg_ms`` (one warm-up call, 30 calls queued over the
four inputs, one device barrier), and prints the max-abs between them.

The kernel column calls the kernel's wrapper directly. The kernel runs on
the card only, so on another device that column prints a line saying so
and no time (as the JAX script prints ``pallas FAILED``).

Usage:
    python -m iris_tts_tpu_torch.scripts.bench_mel [--seconds 10] \
        [--batch 8] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.ops import mel_cuda
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg, avg_ms


def run_case(label: str, audio_arrays: List[torch.Tensor],
             cfg: AudioConfig) -> Optional[Dict]:
    """Prints the case's line; returns ``{"xla_ms", "kernel_ms",
    "speedup", "maxabs"}``, or None where the inputs are not on a CUDA
    device."""
    def f_xla(a):
        return log_mel_spectrogram(a, cfg, impl="xla")

    def f_kernel(a):
        return mel_cuda.log_mel_cuda(a, cfg)

    x = audio_arrays[0]
    if x.device.type != "cuda":
        print(f"{label}: cuda kernel not run: it needs a CUDA device "
              f"(the inputs are on {x.device})")
        return None
    y_xla = f_xla(x)
    y_kernel = f_kernel(x)
    err = float((y_kernel - y_xla).abs().max())
    ms_xla = avg_ms(f_xla, audio_arrays)
    ms_kernel = avg_ms(f_kernel, audio_arrays)
    print(f"{label}: xla {ms_xla:8.2f} ms | cuda {ms_kernel:8.2f} ms | "
          f"speedup {ms_xla / ms_kernel:5.2f}x | maxabs {err:.2e}")
    return {"xla_ms": ms_xla, "kernel_ms": ms_kernel,
            "speedup": ms_xla / ms_kernel, "maxabs": err}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=8)
    add_device_arg(ap)
    return ap


def make_inputs(seconds: float, batch: int, cfg: AudioConfig,
                device: torch.device):
    """The JAX script's inputs: four tones (200 … 500 Hz) plus noise from
    ``default_rng(0)``, and for each a batch of ``batch`` copies rolled by
    17·j samples → (singles, batches)."""
    n = int(seconds * cfg.sample_rate)
    rng = np.random.default_rng(0)
    t = np.arange(n) / cfg.sample_rate
    singles = [
        torch.from_numpy(
            (0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        ).to(device)
        for i in range(4)
    ]
    batches = [torch.stack([torch.roll(s, 17 * j) for j in range(batch)])
               for s in singles]
    return singles, batches


def main(argv=None) -> Dict:
    """Prints the two cases' lines; returns ``{"single": ..., "batch":
    ...}`` (:func:`run_case`'s results)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = AudioConfig()
    singles, batches = make_inputs(args.seconds, args.batch, cfg, device)
    return {
        "single": run_case(f"single [{args.seconds:.0f}s]", singles, cfg),
        "batch": run_case(f"batch  [B={args.batch}, {args.seconds:.0f}s]",
                          batches, cfg),
    }


if __name__ == "__main__":
    main()
