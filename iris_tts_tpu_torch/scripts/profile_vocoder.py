"""Per-stage timing of the HiFiGAN generator.

The port's counterpart of the JAX package's ``scripts/profile_vocoder.py``:
times the whole generator, ``conv_pre``, each (upsample, MRF) stage and
``conv_post`` (with its tanh) with ``scripts.common.avg_ms`` (one warm-up
call, 20 calls queued, one device barrier), under ``torch.no_grad``.

Unlike the JAX script, which initialises each stage anew, the stages are
the generator's own submodules with its weights, so chained they give back
the generator's output exactly, and the last line sets the sum of the
parts beside the whole. Each part is timed on its own, so its number holds
its own launches and device work; compare parts, not absolutes.

Usage:
    python -m iris_tts_tpu_torch.scripts.profile_vocoder [--seconds 10] \
        [--batch 1] [--dtype bf16|f32] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.models.hifigan import LRELU_SLOPE, HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.runtime import (
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.scripts.common import add_device_arg, avg_ms


def median_ms(fn, *args, n: int = 20) -> float:
    """Per-call time of ``fn(*args)`` from :func:`avg_ms` with one
    repeated input."""
    return avg_ms(fn, [args], n=n)


def stage_calls(gen: HiFiGANGenerator) -> List[Tuple[str, Callable]]:
    """The generator's forward as a chain of parts, each a call on the
    previous part's output: ``conv_pre`` (conv, leaky ReLU) on the
    time-major mel, then for each stage ``ups_i`` (transposed conv) and
    ``mrf_i`` (``gen.mrf``: the leaky ReLU of its resblocks' average, by
    the kernel where the generator runs it), then ``conv_post`` (conv,
    tanh) → waveform ``[B, samples]``. The same ops in the same order as
    ``gen.forward``."""
    calls = [("conv_pre", lambda mel: F.leaky_relu(
        gen.conv_pre(mel.transpose(1, 2)), LRELU_SLOPE))]
    for i in range(gen.num_ups):
        calls.append((f"ups_{i}", getattr(gen, f"ups_{i}")))
        calls.append((f"mrf_{i}", functools.partial(gen.mrf, i)))
    calls.append(("conv_post",
                  lambda x: torch.tanh(gen.conv_post(x))[:, 0]))
    return calls


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    add_device_arg(ap)
    return ap


def build_generator(seconds: float, batch: int, dtype: str,
                    device: torch.device):
    """The profiled generator (``HiFiGANConfig()``, weights seeded with 0,
    computing in ``dtype``: ``"bf16"`` or ``"f32"``) on ``device`` and its
    input, ``batch`` standard-normal mels of ``seconds`` of audio."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    cfg = HiFiGANConfig()
    gen = HiFiGANGenerator(cfg, dtype=dt)
    init_params(gen, seeded_generator(0, "cpu"))
    t_frames = int(seconds * 22050 / 256)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, t_frames, cfg.in_channels))).to(device, dt)
    return gen.to(device).eval(), mel


@torch.no_grad()
def main(argv=None) -> dict:
    """Prints the JAX script's lines and the sum of the parts; returns
    ``{"full_ms", "parts_ms": {part: ms}, "sum_ms"}``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pin_math_precision()  # f32 is f32 (no TF32), as the pipeline runs it
    gen, mel = build_generator(args.seconds, args.batch, args.dtype, device)

    full_ms = median_ms(gen, mel)
    print(f"full generator: {full_ms:8.2f} ms "
          f"({args.seconds}s audio, B={args.batch}, {args.dtype})")
    parts = {}
    x = mel
    for name, call in stage_calls(gen):
        shape = (x.shape[1], x.shape[2]) if name == "conv_pre" else (
            x.shape[2], x.shape[1])  # [T x C] of the part's input
        parts[name] = median_ms(call, x)
        x = call(x)
        if name == "conv_pre":
            print(f"  conv_pre  [{shape[0]:7d} x {shape[1]:3d}]: "
                  f"{parts[name]:8.2f} ms")
        elif name.startswith("mrf_"):
            i = int(name[4:])
            print(f"  stage {i}: ups [{x.shape[2]:7d} x {x.shape[1]:3d}]: "
                  f"{parts[f'ups_{i}']:8.2f} ms   MRF: {parts[name]:8.2f} ms")
        elif name == "conv_post":
            print(f"  conv_post [{shape[0]:7d} x {shape[1]:3d}]: "
                  f"{parts[name]:8.2f} ms")
    total = sum(parts.values())
    print(f"sum of the parts: {total:8.2f} ms against the full generator's "
          f"{full_ms:.2f} ms ({total / full_ms:.3f}x)")
    return {"full_ms": full_ms, "parts_ms": parts, "sum_ms": total}


if __name__ == "__main__":
    main()
