"""HiFiGAN vocoder demo: log-mel extraction → vocoding → wav.

The port's counterpart of the JAX package's root ``demo_vocoder.py``: the
log-mel of a wav (or of a 220 + 440 Hz tone) through the port's feature
path (the CUDA log-mel kernel on the card), then the HiFiGAN generator
(a converted torch ``generator.ckpt`` if given, else seeded random
weights, so the output is noise), written as a wav.

Usage:
    python -m iris_tts_tpu_torch.scripts.demo_vocoder \
        [--input_wav in.wav] [--checkpoint generator.ckpt] \
        [--output_wav outputs/vocoder_demo.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from iris_tts_tpu_torch.config import AudioConfig, HiFiGANConfig
from iris_tts_tpu_torch.data.audio_io import load_audio, write_wav
from iris_tts_tpu_torch.models.hifigan import create_vocoder
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram, to_reference_layout
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg


def main(argv=None) -> np.ndarray:
    """Writes ``--output_wav`` and returns the waveform."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_wav", type=str, default=None,
                        help="source audio; defaults to a synthetic tone")
    parser.add_argument("--output_wav", type=str,
                        default="outputs/vocoder_demo.wav")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="torch generator.ckpt to convert and use")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    audio_cfg = AudioConfig()
    if args.input_wav:
        audio = load_audio(args.input_wav, audio_cfg.sample_rate)
    else:
        t = np.arange(audio_cfg.sample_rate) / audio_cfg.sample_rate
        audio = (
            0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.25 * np.sin(2 * np.pi * 440 * t)
        ).astype(np.float32)
        print("no --input_wav given; using a synthetic 220+440 Hz tone")

    mel = log_mel_spectrogram(torch.from_numpy(audio).to(device), audio_cfg)
    print(f"mel: {tuple(mel.shape)} range [{float(mel.min()):.2f}, "
          f"{float(mel.max()):.2f}]")

    if args.checkpoint:
        from iris_tts_tpu_torch.convert.hifigan_torch import (
            load_pretrained_hifigan,
        )

        vocoder = load_pretrained_hifigan(args.checkpoint, device=device)
        print(f"loaded pretrained vocoder from {args.checkpoint}")
    else:
        vocoder = create_vocoder(HiFiGANConfig(), device=device)
        print("WARNING: random weights — output will be noise "
              "(train with iris_tts_tpu_torch.scripts.train_hifigan or "
              "convert a pretrained checkpoint)")

    wav = vocoder(to_reference_layout(mel[None]))[0].float().cpu().numpy()
    out = Path(args.output_wav)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_wav(out, wav, audio_cfg.sample_rate)
    print(f"wrote {out} ({len(wav) / audio_cfg.sample_rate:.2f} s)")
    return wav


if __name__ == "__main__":
    main()
