"""Import reference-trained Keras checkpoints into a deployable pipeline.

Converts any subset of the reference's per-stage ``.weights.h5`` files
(encoder, duration head, VAE, PostNet, and the trainable Keras vocoder)
into one ``TTSPipeline.save`` directory (params + config + vocab) that
``TTSPipeline.load`` and ``python -m iris_tts_tpu_torch.scripts.synthesize
--artifact`` read. The reference's ``config_vae.json`` sets the VAE's
architecture and its ``phoneme_vocab.npy`` the vocabulary; components not
given keep their seeded random weights. Reading ``.weights.h5`` needs
``h5py``.

Usage:
    python -m iris_tts_tpu_torch.scripts.import_keras_checkpoint \
        --output outputs/imported \
        --encoder_weights ckpt/encoder_best.weights.h5 \
        --duration_weights ckpt/duration_best.weights.h5 \
        --vae_weights ckpt/vae_best.weights.h5 \
        --config_vae ckpt/config_vae.json \
        --postnet_weights ckpt/postnet_best.weights.h5 \
        --vocab phoneme_vocab.npy
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path

from iris_tts_tpu_torch.config import IrisConfig, load_config
from iris_tts_tpu_torch.convert.keras_h5 import load_keras_stage_weights
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg, setup_logging
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

logger = logging.getLogger(__name__)


def _vae_config_from_reference(cfg: IrisConfig, path: Path) -> IrisConfig:
    """Fold the reference's config_vae.json fields into the config tree
    (the reference's field names)."""
    ref = json.loads(Path(path).read_text())
    vae = dataclasses.replace(
        cfg.vae,
        n_mels=ref.get("n_mels", cfg.vae.n_mels),
        cond_dim=ref.get("embed_dim", cfg.vae.cond_dim),
        model_channels=ref.get("model_channels", cfg.vae.model_channels),
        latent_dim=ref.get("latent_dim", cfg.vae.latent_dim),
        num_wavenet_blocks=ref.get("num_blocks", cfg.vae.num_wavenet_blocks),
        decoder_blocks=ref.get("decoder_blocks", cfg.vae.decoder_blocks),
        down_stages=ref.get("down_stages", cfg.vae.down_stages),
        flow_layers=ref.get("flow_layers", cfg.vae.flow_layers),
        flow_hidden=ref.get("flow_hidden", cfg.vae.flow_hidden),
    )
    enc = dataclasses.replace(
        cfg.encoder, embed_dim=ref.get("embed_dim", cfg.encoder.embed_dim)
    )
    return dataclasses.replace(cfg, vae=vae, encoder=enc)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", type=Path, required=True,
                        help="pipeline export directory")
    parser.add_argument("--encoder_weights", type=Path)
    parser.add_argument("--duration_weights", type=Path)
    parser.add_argument("--vae_weights", type=Path)
    parser.add_argument("--postnet_weights", type=Path)
    parser.add_argument("--vocoder_weights", type=Path,
                        help="Keras (trainable) vocoder .weights.h5; for "
                        "the torch/speechbrain checkpoint use "
                        "--hifigan_checkpoint of "
                        "iris_tts_tpu_torch.scripts.synthesize")
    parser.add_argument("--config", type=Path,
                        help="the port's config.json (default: production "
                        "config)")
    parser.add_argument("--config_vae", type=Path,
                        help="reference config_vae.json to match the VAE "
                        "architecture")
    parser.add_argument("--vocab", type=Path,
                        help="reference phoneme_vocab.npy (or a vocab.json)")
    add_device_arg(parser)
    return parser


def main(argv=None) -> TTSPipeline:
    """Writes ``--output`` and returns the assembled pipeline."""
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging()

    cfg = load_config(args.config) if args.config else IrisConfig()
    if args.config_vae:
        cfg = _vae_config_from_reference(cfg, args.config_vae)
    vocab = PhonemeVocab.load(args.vocab) if args.vocab else None
    pipe = TTSPipeline.initialize(cfg, vocab=vocab,
                                  device=resolve_device(args.device))
    cfg = pipe.config  # the vocab size may have been adjusted

    converted = load_keras_stage_weights(
        cfg,
        encoder_path=args.encoder_weights,
        duration_path=args.duration_weights,
        vae_path=args.vae_weights,
        postnet_path=args.postnet_weights,
        vocoder_path=args.vocoder_weights,
    )
    if not converted:
        parser.error("no *_weights arguments given — nothing to import")
    for name, sd in converted.items():
        module = getattr(pipe.model, name)
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        bad = [f"  {k}: checkpoint {got.get(k)} != model {want.get(k)}"
               for k in sorted(set(want) | set(got))
               if want.get(k) != got.get(k)]
        if bad:
            raise SystemExit(
                f"{name}: converted shapes do not match the configured "
                f"model — check --config/--config_vae/--vocab\n"
                + "\n".join(bad[:20]))
        module.load_state_dict(sd, strict=True)
        logger.info("imported %s from keras checkpoint", name)
    missing = sorted({"encoder", "duration", "vae", "postnet", "hifigan"}
                     - set(converted))
    if missing:
        logger.warning("components left at random init: %s", missing)

    pipe.save(args.output)
    logger.info("exported pipeline to %s", args.output)
    return pipe


if __name__ == "__main__":
    main()
