"""HiFiGAN integration check: import → checkpoint convert/load → inference.

The port's counterpart of the JAX package's root
``test_hifigan_integration.py``: with ``--checkpoint`` it loads a torch
``generator.ckpt`` through the converter; without one it builds a
synthetic weight-normed torch state dict at the production config to
exercise the converter. Then it vocodes a 20-frame random mel and checks
the waveform's length, finiteness and range. Exits nonzero on failure, so
it can gate CI.

Usage:
    python -m iris_tts_tpu_torch.scripts.hifigan_integration \
        [--checkpoint generator.ckpt] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from iris_tts_tpu_torch.scripts.common import add_device_arg


def synthetic_state_dict(cfg, seed: int = 0) -> dict:
    """A torch generator state dict in the published layout with
    ``weight_g`` / ``weight_v`` pairs, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def wn(name, shape, out_dim):
        w = torch.randn(*shape, generator=g) * 0.01
        sd[f"{name}.weight_v"] = w
        sd[f"{name}.weight_g"] = w.norm(dim=tuple(range(1, w.ndim)),
                                        keepdim=True)
        sd[f"{name}.bias"] = torch.zeros(shape[out_dim])

    ch = cfg.upsample_initial_channel
    wn("conv_pre", (ch, cfg.in_channels, 7), 0)
    nk = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        wn(f"ups.{i}", (ch, ch // 2, k), 1)
        ch //= 2
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilations)):
            for c in range(len(rd)):
                wn(f"resblocks.{i * nk + j}.convs1.{c}", (ch, ch, rk), 0)
                wn(f"resblocks.{i * nk + j}.convs2.{c}", (ch, ch, rk), 0)
    wn("conv_post", (1, ch, 7), 0)
    return sd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="torch generator.ckpt; synthetic if omitted")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    print("1. imports...")
    from iris_tts_tpu_torch.config import HiFiGANConfig
    from iris_tts_tpu_torch.convert.hifigan_torch import (
        convert_hifigan_state_dict,
        load_pretrained_hifigan,
    )
    from iris_tts_tpu_torch.models.hifigan import HiFiGANVocoder

    print("   ok")
    cfg = HiFiGANConfig()
    if args.checkpoint:
        print(f"2. loading checkpoint {args.checkpoint}...")
        vocoder = load_pretrained_hifigan(args.checkpoint, cfg,
                                          device=args.device)
    else:
        print("2. no checkpoint given — building a synthetic torch state "
              "dict to exercise the converter...")
        params = convert_hifigan_state_dict(synthetic_state_dict(cfg), cfg)
        vocoder = HiFiGANVocoder(params, cfg, device=args.device)
    print("   ok")

    print("3. dummy-mel inference...")
    mel = np.random.default_rng(0).standard_normal(
        (cfg.in_channels, 20)).astype(np.float32)
    audio = vocoder(mel).float().cpu().numpy()
    expected = (20 * cfg.total_upsample,)
    failures = []
    if audio.shape != expected:
        failures.append(f"audio shape {audio.shape} != {expected}")
    elif not np.isfinite(audio).all():
        failures.append("audio not finite")
    elif np.abs(audio).max() > 1.0:
        failures.append(f"audio peak {np.abs(audio).max()} > 1")
    if failures:
        print("FAILED: " + "; ".join(failures))
        return 1
    print(f"   ok: audio {audio.shape}, range [{audio.min():.3f}, "
          f"{audio.max():.3f}]")
    print("ALL CHECKS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
