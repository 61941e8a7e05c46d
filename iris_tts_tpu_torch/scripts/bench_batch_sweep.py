"""Synthesis throughput against batch size on the card.

The port's counterpart of the JAX package's
``scripts/bench_batch_sweep.py``: sweeps the two-stage synthesis dispatch
(``iris_tts_tpu_torch.bench.synth_step``) over batch sizes with the
headline bench's measurement (the dispatches queued, one on-device
checksum read back a loop) and prints one JSON line a batch: mel frames/s,
realtime factor, step ms, the marginal scaling efficiency against the
previous point (None on the first) and ``compile_s``, the first call of
the shape (on this card cuDNN's choice of execution plans; nothing is
compiled).

Usage:
    python -m iris_tts_tpu_torch.scripts.bench_batch_sweep \
        [--batches 1,2,4,8,16,32] [--frames 1024] [--dtype bf16|f32] \
        [--config C] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from iris_tts_tpu_torch.bench import first_call_s, timed_loop
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    device_label,
    resolve_config,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--batches", type=str, default="1,2,4,8,16,32")
    ap.add_argument("--phonemes", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--config", type=str, default=None,
                    help="IrisConfig JSON (default: production config)")
    add_device_arg(ap)
    return ap


def main(argv=None) -> list:
    """Prints one JSON row a batch and returns the rows."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    pipe = TTSPipeline.initialize(cfg, seed=1337, dtype=args.dtype,
                                  device=device)
    P, T = args.phonemes, args.frames
    sr = cfg.audio.sample_rate
    print(f"device: {device_label(device)}", file=sys.stderr)

    rng = np.random.default_rng(1337)
    rows = []
    prev_fps = prev_b = None
    for b in (int(x) for x in args.batches.split(",")):
        ids = rng.integers(2, len(pipe.vocab), size=(b, P))
        lengths = np.full((b,), P, np.int64)
        compile_s = first_call_s(pipe, ids, lengths, T)
        wall, audio = timed_loop(pipe, ids, lengths, T, args.iters)
        fps = b * T / wall
        audio_s = audio.shape[0] * audio.shape[1] / sr
        # Marginal efficiency: 1.0 = linear scaling from the previous batch
        # point, 0.0 = no gain.
        eff = None
        if prev_fps is not None and b != prev_b:
            eff = round((fps / prev_fps - 1.0) / (b / prev_b - 1.0), 3)
        prev_fps, prev_b = fps, b
        row = {
            "metric": "synthesis_batch_sweep",
            "batch": b,
            "frames": T,
            "mel_frames_per_sec": round(fps, 1),
            "rtf": round(audio_s / wall, 1),
            "step_ms": round(wall * 1e3, 2),
            "marginal_scaling_eff": eff,
            "compile_s": round(compile_s, 1),
            "dtype": args.dtype,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
