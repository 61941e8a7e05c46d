"""Stage 4: HiFiGAN adversarial training with MPD/MSD discriminators
(``train.stages.gan_stage``): alternating discriminator and generator steps
with LSGAN + feature-matching + mel losses on random fixed-length (mel,
audio) segments, both sides' full state in one checkpoint under
``<output_dir>/hifigan_gan/checkpoints``, and an optional EMA generator,
which ``TTSPipeline.from_checkpoints`` then deploys.

Usage:
    python -m iris_tts_tpu_torch.scripts.train_hifigan --output_dir outputs \
        --ema_decay 0.999
"""

from __future__ import annotations

import argparse

from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_accum_arg,
    add_bf16_arg,
    add_checkify_arg,
    add_common_args,
    add_mesh_arg,
    compute_dtype_of,
    mesh_from_args,
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
    parser.add_argument("--segment_frames", type=int, default=32,
                        help="mel frames per training segment (32 → 8192 "
                        "samples, the HiFi-GAN paper's segment size)")
    parser.add_argument(
        "--disc_width", type=float, default=1.0,
        help="discriminator channel scale (1.0 = paper sizes; smaller for "
        "smoke tests)",
    )
    parser.add_argument("--periods", type=int, nargs="+",
                        default=[2, 3, 5, 7, 11])
    parser.add_argument("--num_scales", type=int, default=3)
    add_accum_arg(parser)
    add_bf16_arg(parser)
    add_checkify_arg(parser)
    parser.add_argument(
        "--remat", action="store_true",
        help="recompute MRF resblock activations in the generator's "
        "backward pass (they run at the audio rate and hold most of the "
        "GAN's activation memory)",
    )
    parser.add_argument(
        "--ema_decay", type=float, default=0.0,
        help="exponential-moving-average decay for the generator params "
        "(e.g. 0.999); the averaged generator is what from_checkpoints "
        "deploys, 0 disables",
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
    loop = stages.gan_stage(
        cfg, args.data_root, args.alignment_dir, args.output_dir,
        cache_dir=args.cache_dir, device=device,
        segment_frames=args.segment_frames, disc_width=args.disc_width,
        periods=tuple(args.periods), num_scales=args.num_scales,
        accum_steps=args.accum_steps, ema_decay=args.ema_decay,
        compute_dtype=compute_dtype_of(args), remat=args.remat,
        mesh=mesh)
    return run_loop(loop, args.checkify)


if __name__ == "__main__":
    run_as_script(main)
