"""Minimal end-to-end example of the public API.

The port's counterpart of the JAX package's root ``example.py``: a
full-width pipeline with seeded random weights (swap in
``TTSPipeline.from_checkpoints(...)`` after training), one sentence
synthesized in memory and one written straight to a WAV.

Usage:
    python -m iris_tts_tpu_torch.scripts.example \
        [--output_wav outputs/example.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from iris_tts_tpu_torch import IrisConfig, TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg


def main(argv=None) -> dict:
    """Returns ``{"samples", "seconds", "file_samples", "output_wav"}``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output_wav", type=str,
                        default="outputs/example.wav")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # Random weights — swap in TTSPipeline.from_checkpoints(...) after
    # training.
    pipeline = TTSPipeline.initialize(IrisConfig(), device=device)

    audio = pipeline.synthesize("Hello world, this is Iris speaking.",
                                seed=0)
    sr = pipeline.config.audio.sample_rate
    print(f"synthesized {len(audio)} samples ({len(audio) / sr:.2f} s)")

    Path(args.output_wav).parent.mkdir(parents=True, exist_ok=True)
    saved = pipeline.synthesize_to_file("Saving straight to disk.",
                                        args.output_wav)
    print(f"wrote {args.output_wav}")
    return {"samples": len(audio), "seconds": len(audio) / sr,
            "file_samples": len(saved), "output_wav": args.output_wav}


if __name__ == "__main__":
    main()
