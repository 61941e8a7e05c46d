"""Streaming vocoder: time to first audio and throughput against the full
pass.

The port's counterpart of the JAX package's ``scripts/bench_stream.py``.
For a long mel (standard-normal around −3, ``default_rng(0)``) it times:

* the full-pass ``vocode`` (one dispatch and one copy to the host, the
  mean of three calls on slightly varied inputs after a first call);
* ``vocode_streaming``'s time to first audio (one window's dispatch and
  its chunk's copy) and its total time over every chunk, after one warm
  pass.

The streamed waveform must equal the full pass: within 1e-5 of the full
pass's peak (both f32), or within one LSB with ``--pcm16``. The JAX script
demands bitwise equality on the CPU; here cuDNN and oneDNN pick their
convolution algorithms per shape, so the window and the whole mel are not
bitwise equal on either device (5.0e-6 of the peak measured on the CPU,
1.9e-6 on the H100), and the port holds both to 1e-5. A miss, or a stream
of another length, exits 1.

Usage:
    python -m iris_tts_tpu_torch.scripts.bench_stream [--frames 2048] \
        [--chunk 256] [--pcm16] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg, device_label

# Largest |stream − full pass| as a share of the full pass's peak (f32).
STREAM_LIMIT = 1e-5
# ... and in LSBs with --pcm16.
PCM16_LSB_LIMIT = 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=2048,
                    help="mel length (2048 frames ≈ 23.8 s of audio)")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--pcm16", action="store_true")
    add_device_arg(ap)
    return ap


def main(argv=None) -> Dict:
    """Prints the result line; returns ``{"full_ms", "ttfa_ms",
    "total_ms", "chunks", "err", "ok"}`` (``err`` as a share of the peak,
    or in LSBs with ``--pcm16``). Exits 1 where the stream misses."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0, device=device)
    print(f"device: {device_label(device)}", file=sys.stderr)
    rng = np.random.default_rng(0)
    n_mels = pipe.config.hifigan.in_channels
    mel = rng.normal(-3.0, 2.0, size=(args.frames, n_mels)).astype(
        np.float32)
    sr = pipe.config.audio.sample_rate
    secs = args.frames * pipe.config.hifigan.total_upsample / sr

    # Full pass: a first call, then timed calls over varied inputs (each
    # returns host data).
    pipe.vocode(mel)
    t0 = time.perf_counter()
    n = 3
    for i in range(n):
        pipe.vocode(mel + np.float32(i) * 1e-6)
    full_ms = 1000 * (time.perf_counter() - t0) / n

    # Streaming: one warm pass, then TTFA = first chunk out, total = all.
    for _ in pipe.vocode_streaming(mel, chunk_frames=args.chunk,
                                   pcm16=args.pcm16):
        pass
    t0 = time.perf_counter()
    gen = pipe.vocode_streaming(mel, chunk_frames=args.chunk,
                                pcm16=args.pcm16)
    first = next(gen)
    ttfa_ms = 1000 * (time.perf_counter() - t0)
    chunks = [first] + list(gen)
    total_ms = 1000 * (time.perf_counter() - t0)

    audio = np.concatenate(chunks)
    want = pipe.vocode(mel)
    same_length = audio.shape == want.shape
    if args.pcm16:
        want = (np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16)
        err = (int(np.abs(audio.astype(np.int32)
                          - want.astype(np.int32)).max())
               if same_length else None)
        ok = same_length and err <= PCM16_LSB_LIMIT
        verdict = f"max |Δ| = {err} LSB"
    else:
        scale = float(np.abs(want).max()) or 1.0
        diff = float(np.abs(audio - want).max()) if same_length else None
        err = diff / scale if same_length else None
        ok = same_length and err <= STREAM_LIMIT
        verdict = (f"max |Δ| = {diff:.2e}, {err:.2e} of the peak "
                   f"{scale:.2e}" if same_length else "")
    if not same_length:
        verdict = (f"{len(audio)} streamed samples against the full "
                   f"pass's {len(want)}")

    print(
        f"{secs:.1f}s audio ({args.frames} frames, chunk {args.chunk}"
        f"{', pcm16' if args.pcm16 else ''}): "
        f"full pass {full_ms:.1f} ms ({1000 * secs / full_ms:.0f}x RT) | "
        f"stream TTFA {ttfa_ms:.1f} ms, total {total_ms:.1f} ms "
        f"({1000 * secs / total_ms:.0f}x RT, {len(chunks)} chunks) | "
        f"equal to the full pass: {verdict}"
    )
    if not ok:
        sys.exit(1)
    return {"full_ms": full_ms, "ttfa_ms": ttfa_ms, "total_ms": total_ms,
            "chunks": len(chunks), "err": err, "ok": ok}


if __name__ == "__main__":
    main()
