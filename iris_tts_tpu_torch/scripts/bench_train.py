"""Training throughput: the VAE step or the GAN round on the card.

The port's counterpart of the JAX package's ``scripts/bench_train.py``:
times the steady-state train step at the production architecture on
synthetic batches of the bucketed LJSpeech shape (numpy draws from JAX's
seeds; model weights from seeded ``torch.Generator``s), so the number
leaves out data loading. Each step's loss is read back on the host, and
the fastest of ``--iters`` steps after a first one is reported.

``--stage vae`` (default): the VAE step (Adam, global-norm clip 1.0) with
the frozen phoneme encoder conditioning it. ``--stage gan``: one
discriminator step and one generator step of HiFiGAN fine-tuning on
``--segment_frames`` × hop samples a row. ``--bf16`` computes in bf16
(params, gradients and optimizer in f32), the training drivers' flag.

Usage:
    python -m iris_tts_tpu_torch.scripts.bench_train [--batch_size 16] \
        [--frames 1024] [--bf16] [--device cpu]
    python -m iris_tts_tpu_torch.scripts.bench_train --stage gan
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models import PhonemeEncoder, TextConditionedVAE
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.runtime import (
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.scripts.common import add_device_arg, device_label
from iris_tts_tpu_torch.train.gan import make_gan_steps
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import make_vae_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--phonemes", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision step (bf16 compute, f32 "
                    "params/grads) — the --bf16 training-CLI path")
    ap.add_argument("--stage", choices=["vae", "gan"], default="vae")
    ap.add_argument("--segment_frames", type=int, default=32,
                    help="GAN stage: mel frames per training segment "
                    "(32 frames = 8192 samples, the standard regime)")
    add_device_arg(ap)
    return ap


def _n_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _fastest_s(step, iters: int) -> float:
    """The fastest of ``iters`` calls of ``step()``, each read back."""
    times = []
    for _ in range(iters):
        t0 = time.time()
        step()
        times.append(time.time() - t0)
    return min(times)


def main(argv=None) -> Dict:
    """Prints the JSON line and returns it."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    pin_math_precision()  # as the training stages run
    print(f"device: {device_label(device)}", file=sys.stderr)
    cfg = IrisConfig()
    if args.stage == "gan":
        return _bench_gan(args, cfg, device)
    B, P, T = args.batch_size, args.phonemes, args.frames
    if T % max(1, P) != 0 or T // P < 1:
        parser.error(f"--frames ({T}) must be a positive multiple of "
                     f"--phonemes ({P})")
    if T % cfg.vae.down_factor != 0:
        parser.error(f"--frames ({T}) must be a multiple of the VAE "
                     f"downsample factor ({cfg.vae.down_factor})")

    encoder = PhonemeEncoder(cfg.encoder)
    vae = TextConditionedVAE(cfg.vae)
    init_params(encoder, seeded_generator(0, "cpu"))
    init_params(vae, seeded_generator(0, "cpu"))
    state = TrainState.create(vae.to(device),
                              adam_clipped(1e-4, clip_norm=1.0), 0,
                              frozen={"encoder": encoder.to(device)})
    print(f"VAE params: {_n_params(vae):,}", file=sys.stderr)

    rng = np.random.default_rng(0)
    batch = {
        "phoneme_ids": torch.from_numpy(
            rng.integers(2, cfg.encoder.vocab_size, (B, P))).to(device),
        "phoneme_mask": torch.ones((B, P), device=device),
        "durations": torch.full((B, P), float(T // P), device=device),
        "mel": torch.from_numpy(rng.standard_normal(
            (B, T, cfg.vae.n_mels)).astype(np.float32)).to(device),
    }
    kl_w = 0.01
    step = make_vae_train_step(
        cfg, compute_dtype=torch.bfloat16 if args.bf16 else None)

    t0 = time.time()
    state, metrics = step(state, batch, kl_w)
    checksum = float(metrics["total"])
    print(f"first step: {time.time() - t0:.1f}s (loss {checksum:.4f})",
          file=sys.stderr)

    def one():
        nonlocal state
        state, m = step(state, batch, kl_w)
        float(m["total"])  # read back

    dt = _fastest_s(one, args.iters)
    frames_per_sec = B * T / dt
    audio_sec_per_sec = (frames_per_sec * cfg.audio.hop_length
                         / cfg.audio.sample_rate)
    print(f"steady: {dt * 1e3:.1f} ms/step, {frames_per_sec:,.0f} "
          f"mel-frames/s ({audio_sec_per_sec:.1f}s of audio trained per "
          f"second)", file=sys.stderr)
    out = {
        "metric": "vae_train_mel_frames_per_sec",
        "value": round(frames_per_sec, 1),
        "unit": "frames/s",
        "step_ms": round(dt * 1e3, 2),
        "batch": [B, T],
        "dtype": "bf16" if args.bf16 else "f32",
    }
    print(json.dumps(out), flush=True)
    return out


def _bench_gan(args, cfg: IrisConfig, device: torch.device) -> Dict:
    """One discriminator step and one generator step a round (the
    alternating regime of ``train_hifigan``) on synthetic segments."""
    B, seg = args.batch_size, args.segment_frames
    hop = cfg.hifigan.total_upsample
    dt = torch.bfloat16 if args.bf16 else None
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (B, seg, cfg.hifigan.in_channels)).astype(np.float32)).to(device)
    audio = torch.from_numpy(
        (0.1 * rng.standard_normal((B, seg * hop))).astype(np.float32)
    ).to(device)

    gen, disc = HiFiGANGenerator(cfg.hifigan), HiFiGANDiscriminators()
    init_params(gen, seeded_generator(0, "cpu"))
    init_params(disc, seeded_generator(1, "cpu"))
    print(f"generator params: {_n_params(gen):,}  discriminators: "
          f"{_n_params(disc):,}", file=sys.stderr)
    g_state = TrainState.create(gen.to(device), adam_clipped(2e-4), 0)
    d_state = TrainState.create(disc.to(device), adam_clipped(2e-4), 1)
    batch = {"mel": mel, "audio": audio}
    disc_step, gen_step = make_gan_steps(cfg, compute_dtype=dt)

    t0 = time.time()
    d_state, dm = disc_step(g_state, d_state, batch)
    g_state, gm = gen_step(g_state, d_state, batch)
    losses = {k: float(v) for k, v in {**dm, **gm}.items()}
    print(f"first round: {time.time() - t0:.1f}s (disc "
          f"{losses['disc_loss']:.3f} gen {losses['gen_total']:.3f})",
          file=sys.stderr)

    def one():
        nonlocal d_state, g_state
        d_state, _ = disc_step(g_state, d_state, batch)
        g_state, m = gen_step(g_state, d_state, batch)
        float(m["gen_total"])  # read back (the generator used disc's update)

    dt_s = _fastest_s(one, args.iters)
    samples_per_sec = B * seg * hop / dt_s
    audio_sec_per_sec = samples_per_sec / cfg.audio.sample_rate
    print(f"steady: {dt_s * 1e3:.1f} ms per disc+gen pair, "
          f"{audio_sec_per_sec:.1f}s of audio trained per second",
          file=sys.stderr)
    out = {
        "metric": "gan_train_audio_sec_per_sec",
        "value": round(audio_sec_per_sec, 2),
        "unit": "audio_s/s",
        "step_ms": round(dt_s * 1e3, 2),
        "batch": [B, seg],
        "dtype": "bf16" if args.bf16 else "f32",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
