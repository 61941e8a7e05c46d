"""Stage 3: train the PostNet over the frozen encoder and VAE
(``train.stages.postnet_stage``). The architecture comes from the config
the VAE stage recorded, so it cannot drift from the VAE it refines.

Usage:
    python -m iris_tts_tpu_torch.scripts.train_postnet --output_dir outputs
"""

from __future__ import annotations

import argparse
from pathlib import Path

from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_bf16_arg,
    add_checkify_arg,
    add_common_args,
    compute_dtype_of,
    resolve_config,
    run_loop,
    setup_logging,
)
from iris_tts_tpu_torch.train import stages


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    add_bf16_arg(parser)
    add_checkify_arg(parser)
    parser.add_argument(
        "--encoder_checkpoint", type=str, default=None,
        help="stage-1 checkpoint dir (default: "
        "<output_dir>/encoder/checkpoints)",
    )
    parser.add_argument(
        "--vae_checkpoint", type=str, default=None,
        help="stage-2 checkpoint dir (default: <output_dir>/vae/checkpoints)",
    )
    parser.add_argument(
        "--vae_config", type=str, default=None,
        help="config persisted by stage 2 (default: "
        "<output_dir>/vae/config_vae.json; ensures matching architecture)",
    )
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    vae_config = Path(args.vae_config or Path(args.output_dir) / "vae"
                      / "config_vae.json")
    if vae_config.exists():
        args.config = str(vae_config)
    cfg = resolve_config(args)
    loop = stages.postnet_stage(
        cfg, args.data_root, args.alignment_dir, args.output_dir,
        cache_dir=args.cache_dir, device=device,
        encoder_checkpoint=args.encoder_checkpoint,
        vae_checkpoint=args.vae_checkpoint,
        compute_dtype=compute_dtype_of(args))
    return run_loop(loop, args.checkify)


if __name__ == "__main__":
    main()
