"""Stage 2: train the text-conditioned VAE over the frozen stage-1 encoder
(``train.stages.vae_stage``): cached mels (built first, through the log-mel
kernel on the card), bucketed shapes, annealed-KL composite loss, full-state
resume.

Usage:
    python -m iris_tts_tpu_torch.scripts.train_vae \
        --encoder_checkpoint outputs/encoder/checkpoints
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
    add_mesh_arg,
    compute_dtype_of,
    mesh_from_args,
    persist_config,
    resolve_config,
    run_as_script,
    run_loop,
    setup_logging,
    spawn_cpu_ranks,
)
from iris_tts_tpu_torch.train import stages


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument(
        "--encoder_checkpoint", type=str, default=None,
        help="stage-1 checkpoint dir (default: "
        "<output_dir>/encoder/checkpoints)",
    )
    parser.add_argument("--max_frames", type=int, default=2048)
    add_accum_arg(parser)
    add_bf16_arg(parser)
    add_checkify_arg(parser)
    parser.add_argument(
        "--remat", action="store_true",
        help="recompute WaveNet-block activations in the backward pass: "
        "less activation memory for one extra block forward",
    )
    add_mesh_arg(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.force_cpu_devices:
        return spawn_cpu_ranks(__spec__.name, argv, args.force_cpu_devices)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    mesh = mesh_from_args(args, device)
    cfg = resolve_config(args)
    loop = stages.vae_stage(
        cfg, args.data_root, args.alignment_dir, args.output_dir,
        cache_dir=args.cache_dir, device=device,
        accum_steps=args.accum_steps, max_frames=args.max_frames,
        encoder_checkpoint=args.encoder_checkpoint,
        compute_dtype=compute_dtype_of(args), remat=args.remat,
        mesh=mesh)
    vocab = loop.batcher.dataset.vocab
    persist_config(
        replace(cfg, encoder=replace(cfg.encoder, vocab_size=len(vocab))),
        Path(args.output_dir) / "vae", "config_vae.json")
    return run_loop(loop, args.checkify)


if __name__ == "__main__":
    run_as_script(main)
