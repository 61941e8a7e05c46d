"""Stage 1: train the phoneme encoder + duration predictor on LJSpeech-layout
data with MFA-style alignments (``train.stages.duration_stage``): masked
attention + Huber duration loss, bucketed static shapes, warmup+cosine Adam,
full-state checkpoints with resume.

Usage:
    python -m iris_tts_tpu_torch.scripts.train_encoder \
        --data_root data/LJSpeech-1.1 --alignment_dir data/aligned \
        --num_epochs 100
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from pathlib import Path

from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_accum_arg,
    add_bf16_arg,
    add_checkify_arg,
    add_common_args,
    compute_dtype_of,
    persist_config,
    resolve_config,
    run_loop,
    setup_logging,
)
from iris_tts_tpu_torch.train import stages


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--max_phoneme_length", type=int, default=256)
    add_accum_arg(parser)
    add_bf16_arg(parser)
    add_checkify_arg(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    loop = stages.duration_stage(
        cfg, args.data_root, args.alignment_dir, args.output_dir,
        cache_dir=args.cache_dir, device=device,
        accum_steps=args.accum_steps,
        max_phoneme_length=args.max_phoneme_length,
        compute_dtype=compute_dtype_of(args))
    vocab = loop.batcher.dataset.vocab
    persist_config(
        replace(cfg, encoder=replace(cfg.encoder, vocab_size=len(vocab))),
        Path(args.output_dir) / "encoder", "config_encoder.json")
    return run_loop(loop, args.checkify)


if __name__ == "__main__":
    main()
