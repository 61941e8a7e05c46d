"""Validate a trained VAE checkpoint: recon/KL metrics + generate smoke test.

The port's counterpart of the JAX package's
``scripts/validate_vae_checkpoint.py``: the validation split's mels (the
CUDA log-mel kernel on the card), masked recon L1, KL and total over
``--num_batches`` batches, MCD / LSD of the posterior-mean reconstruction
per utterance, the recon-L1 verdict, then a ``generate()`` smoke check
from the prior with its mode-collapse warning. The prior draw comes from a
``torch.Generator`` seeded with ``--seed`` (0 when not given).

Usage:
    python -m iris_tts_tpu_torch.scripts.validate_vae_checkpoint \
        --encoder_checkpoint outputs/encoder/checkpoints \
        --vae_checkpoint outputs/vae/checkpoints \
        [--data_root ...] [--alignment_dir ...] [--cache_dir ...] \
        [--num_batches 10] [--kl_weight 0.01] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from iris_tts_tpu_torch.data.batching import BucketedBatcher, to_device
from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)
from iris_tts_tpu_torch.train import make_vae_eval_step, make_vae_recon_step
from iris_tts_tpu_torch.train.stages import load_frozen_encoder, load_frozen_vae
from iris_tts_tpu_torch.utils.metrics import RunningMean, quality_report

logger = logging.getLogger(__name__)

GENERATE_FRAMES = 64
COLLAPSE_STD = 0.5


def recon_verdict(recon_l1: float) -> str:
    return ("not trained well" if recon_l1 > 5
            else "could be better" if recon_l1 > 1
            else "reasonable")


def validation_metrics(vae, encoder, val_ds, cfg, num_batches: int,
                       kl_weight: float, device):
    """Eval metrics and posterior-mean MCD / LSD / mel L1 (utterances of
    at least 4 frames) averaged over the first ``num_batches`` batches of
    the split (seed 0). Returns (means, batches)."""
    frozen = nn.ModuleDict({"encoder": encoder})
    eval_step, recon_step = make_vae_eval_step(cfg), make_vae_recon_step(cfg)
    batcher = BucketedBatcher(
        val_ds, cfg.train.batch_size, with_mel=True,
        down_factor=cfg.vae.down_factor, seed=0,
    )
    kl = torch.tensor(kl_weight, device=device)
    rm = RunningMean()
    n_batches = 0
    for batch in batcher.epoch(0):
        if n_batches >= num_batches:
            break
        batch = to_device(batch, device)
        m = eval_step(vae, frozen, batch, kl)
        rm.update({k: float(v) for k, v in m.items()})
        recon, frame_mask = recon_step(vae, frozen, batch)
        recon, mask_np = recon.cpu().numpy(), frame_mask.cpu().numpy()
        gt = batch["mel"].cpu().numpy()
        for i in range(recon.shape[0]):
            n = int((mask_np[i] > 0).sum())
            if n >= 4:
                rm.update(quality_report(recon[i, :n], gt[i, :n]))
        n_batches += 1
    return rm.means(), n_batches


@torch.no_grad()
def generation_smoke(vae, cfg, device, generator=None, z_prior=None) -> dict:
    """``generate()`` on zero conditioning of :data:`GENERATE_FRAMES`
    frames; ``z_prior`` ([1, T', latent]) replaces the draw from
    ``generator``."""
    cond = torch.zeros((1, GENERATE_FRAMES, cfg.vae.cond_dim), device=device)
    if z_prior is not None:
        z_prior = torch.as_tensor(z_prior, device=device)
    mel, _ = vae.generate(cond, z_prior=z_prior, generator=generator)
    mel = mel.cpu().numpy()
    return {"shape": mel.shape, "mean": float(mel.mean()),
            "std": float(mel.std()), "finite": bool(np.isfinite(mel).all()),
            "mel": mel}


def main(argv=None) -> dict:
    """Returns ``{"n_batches", "means", "verdict", "generate": {"shape",
    "mean", "std", "finite", "collapse"}}``; empty when the split yields
    no batch."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument(
        "--encoder_checkpoint", type=str,
        default="outputs/encoder/checkpoints",
    )
    parser.add_argument(
        "--vae_checkpoint", type=str, default="outputs/vae/checkpoints"
    )
    parser.add_argument("--num_batches", type=int, default=10)
    parser.add_argument("--kl_weight", type=float, default=0.01)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.verbose)
    vae_cfg_file = Path(args.vae_checkpoint) / "config.json"
    if vae_cfg_file.exists():
        args.config = str(vae_cfg_file)
    cfg = resolve_config(args)

    val_ds = LJSpeechVAEDataset(
        args.data_root, args.alignment_dir, split="val",
        cache_dir=args.cache_dir, audio=cfg.audio, device=device,
    )
    val_ds.precompute_mels()

    encoder = load_frozen_encoder(cfg, args.encoder_checkpoint, device)
    vae = load_frozen_vae(cfg, args.vae_checkpoint, device)
    means, n_batches = validation_metrics(
        vae, encoder, val_ds, cfg, args.num_batches, args.kl_weight, device)
    if not means:
        logger.error(
            "no validation batches (val split has %d utterances); use a "
            "larger corpus or val_fraction", len(val_ds),
        )
        return {}
    logger.info("validation over %d batches: %s", n_batches,
                {k: round(v, 5) for k, v in means.items()})

    # Quality rubric on the masked recon L1.
    out = {"n_batches": n_batches, "means": means,
           "verdict": recon_verdict(means["recon_l1"])}
    logger.info("recon L1 %.4f → %s", means["recon_l1"], out["verdict"])
    if "mcd_db" in means:
        logger.info(
            "reconstruction quality: MCD=%.2f dB  LSD=%.2f dB "
            "(trained TTS recon typically well under the ~4-8 dB "
            "synthesis range; unrelated speech >10 dB)",
            means["mcd_db"], means["lsd_db"],
        )

    # Generation smoke test from the prior.
    gen = seeded_generator(0 if args.seed is None else args.seed, device)
    g = generation_smoke(vae, cfg, device, generator=gen)
    g.pop("mel")
    g["collapse"] = g["std"] < COLLAPSE_STD
    out["generate"] = g
    logger.info("generate(): shape=%s mean=%.3f std=%.3f finite=%s",
                g["shape"], g["mean"], g["std"], g["finite"])
    if g["collapse"]:
        logger.warning("low output variance — possible mode collapse")
    return out


if __name__ == "__main__":
    main()
