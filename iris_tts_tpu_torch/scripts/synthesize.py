"""Text → 22.05 kHz WAV: the main inference entry point.

The pipeline comes from a deployable artifact (``--artifact``, written by
``TTSPipeline.save`` or ``train_full_pipeline`` of this package or of the
JAX package, such as ``release/pipeline_artifact``), from seeded random
weights (``--random_weights``, a smoke test), or from the training stages'
checkpoints (either package's), with a pretrained torch HiFiGAN
(``--hifigan_checkpoint``) or the GAN stage's generator. The waveform comes
from the HiFiGAN generator, or from the Griffin-Lim vocoder
(``--use_griffin_lim``, 60 iterations on the pipeline's device).

Usage:
    python -m iris_tts_tpu_torch.scripts.synthesize --text "Hello world." \
        --artifact outputs/full_run/pipeline_artifact \
        --output_wav outputs/sample.wav
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from iris_tts_tpu_torch.config import IrisConfig, load_config
from iris_tts_tpu_torch.data.audio_io import write_wav
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, to_host
from iris_tts_tpu_torch.ops.griffin_lim import griffin_lim_from_log_mel
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    setup_logging,
)

logger = logging.getLogger(__name__)

GRIFFIN_LIM_ITERS = 60


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--text", type=str,
                        default="Hello world, this is a test.")
    parser.add_argument("--output_wav", type=str,
                        default="outputs/sample.wav")
    parser.add_argument("--artifact", type=str, default=None,
                        help="deployable pipeline directory "
                        "(TTSPipeline.save, this package's or the JAX "
                        "package's) — overrides the per-stage checkpoint "
                        "flags")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--vocab_path", type=str, default=None,
                        help="phoneme_vocab.json the encoder trained with")
    parser.add_argument("--lexicon_path", type=str, default=None,
                        help="CMUdict-format lexicon file")
    parser.add_argument("--encoder_checkpoint", type=str,
                        default="outputs/encoder/checkpoints")
    parser.add_argument("--vae_checkpoint", type=str,
                        default="outputs/vae/checkpoints")
    parser.add_argument("--postnet_checkpoint", type=str, default=None)
    parser.add_argument("--hifigan_checkpoint", type=str, default=None,
                        help="pretrained torch generator.ckpt")
    parser.add_argument("--hifigan_gan_checkpoint", type=str, default=None,
                        help="the GAN stage's checkpoint dir "
                        "(outputs/hifigan_gan/checkpoints); deploys the EMA "
                        "average when the run tracked one")
    parser.add_argument("--use_griffin_lim", action="store_true",
                        help="Griffin-Lim fallback vocoder (60 iters)")
    parser.add_argument("--random_weights", action="store_true",
                        help="smoke-test mode without trained checkpoints")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                        help="compute dtype (params stay f32)")
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    return parser


def build_pipeline(args, device: torch.device) -> TTSPipeline:
    if args.artifact:
        return TTSPipeline.load(args.artifact, lexicon_path=args.lexicon_path,
                                device=device, dtype=args.dtype)
    if args.random_weights:
        cfg = load_config(args.config) if args.config else IrisConfig()
        return TTSPipeline.initialize(cfg, seed=args.seed, device=device,
                                      lexicon_path=args.lexicon_path,
                                      dtype=args.dtype)
    return TTSPipeline.from_checkpoints(
        args.encoder_checkpoint,
        args.vae_checkpoint,
        postnet_checkpoint=args.postnet_checkpoint,
        hifigan_checkpoint=args.hifigan_checkpoint,
        hifigan_gan_checkpoint=args.hifigan_gan_checkpoint,
        config=load_config(args.config) if args.config else None,
        vocab_path=args.vocab_path,
        lexicon_path=args.lexicon_path,
        device=device,
        dtype=args.dtype,
    )


def main(argv=None) -> np.ndarray:
    """Writes ``--output_wav`` and returns the float waveform."""
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    pipe = build_pipeline(args, resolve_device(args.device))
    if args.use_griffin_lim:
        mel = pipe.synthesize_mel(args.text, seed=args.seed,
                                  temperature=args.temperature)
        # Back on the pipeline's device: the iterations run there.
        audio = to_host(griffin_lim_from_log_mel(
            torch.from_numpy(mel).to(pipe.device), n_iter=GRIFFIN_LIM_ITERS,
            cfg=pipe.config.audio))
    else:
        audio = pipe.synthesize(args.text, seed=args.seed,
                                temperature=args.temperature)
    sr = pipe.config.audio.sample_rate
    logger.info("generated %s samples (%.2f s)", audio.shape, len(audio) / sr)
    out = Path(args.output_wav)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_wav(out, audio, sr)
    logger.info("wrote %s", out)
    return audio


if __name__ == "__main__":
    main()
