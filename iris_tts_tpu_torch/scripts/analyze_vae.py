"""VAE output diagnostics: reconstruction quality + mode-collapse heuristics.

The port's counterpart of the JAX package's root ``analyze_vae.py``: for
each validation utterance (its mel from the CUDA log-mel kernel on the
card), the posterior-mean reconstruction against the ground truth (MSE and
its rubric, the flat-output warning) and the posterior statistics, then a
generation from the prior and a random-conditioning control (the two
generations must differ by more than 0.05 on average, or the conditioning
is ignored). The prior draws and the random conditioning come from a
``torch.Generator`` seeded with ``--seed`` (0 when not given).

Usage:
    python -m iris_tts_tpu_torch.scripts.analyze_vae \
        --encoder_checkpoint outputs/encoder/checkpoints \
        --vae_checkpoint outputs/vae/checkpoints \
        [--data_root ...] [--alignment_dir ...] [--cache_dir ...] \
        [--num_samples 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.ops.length import length_regulate, round_up_to_multiple
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)
from iris_tts_tpu_torch.train.stages import load_frozen_encoder, load_frozen_vae

FLAT_STD = 0.5
LIVE_DELTA = 0.05


def rubric(mse: float) -> str:
    if mse > 5:
        return "not trained well"
    if mse > 1:
        return "could be better"
    return "reasonable"


def _draw(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def analyze_sample(encoder, vae, sample, cfg, device, generator=None,
                   draws=None) -> dict:
    """The numbers of one utterance. ``draws`` (``z_prior`` [1, T',
    latent], ``rand_cond`` [1, T, cond_dim], ``z_control`` [1, T',
    latent]) replace the draws from ``generator``, made in that order."""
    n_true = sample.mel.shape[0]
    T = round_up_to_multiple(n_true, cfg.vae.down_factor)
    mel = torch.from_numpy(
        np.pad(sample.mel, ((0, T - n_true), (0, 0)))).to(device)[None]
    ids = torch.from_numpy(np.asarray(sample.phoneme_ids,
                                      np.int64)).to(device)[None]
    durs = torch.from_numpy(
        sample.durations.astype(np.int32)).to(device)[None]
    cond, _ = length_regulate(encoder(ids), durs, T)

    # Reconstruction (posterior mean).
    recon, (mean, logvar), _ = vae(mel, cond)
    r = recon[0, :n_true].cpu().numpy()
    out = {"file_id": sample.file_id,
           "mse": float(np.mean((r - sample.mel) ** 2)),
           "recon_std": float(r.std()), "target_std": float(sample.mel.std()),
           "posterior_abs_mean": float(mean.abs().mean()),
           "logvar_mean": float(logvar.mean())}
    out["rubric"] = rubric(out["mse"])
    out["flat"] = out["recon_std"] < FLAT_STD

    if draws is None:
        tp = T // cfg.vae.down_factor
        z_shape = (1, tp, cfg.vae.latent_dim)
        draws = {"z_prior": _draw(z_shape, generator, device),
                 "rand_cond": _draw(tuple(cond.shape), generator, device),
                 "z_control": _draw(z_shape, generator, device)}
    draws = {k: torch.as_tensor(v, device=device) for k, v in draws.items()}

    # Conditioned generation from the prior.
    gen, _ = vae.generate(cond, z_prior=draws["z_prior"])
    g = gen[0].cpu().numpy()
    out.update(gen_std=float(g.std()), gen_min=float(g.min()),
               gen_max=float(g.max()))

    # Random-conditioning control (should look different).
    gen_r, _ = vae.generate(draws["rand_cond"], z_prior=draws["z_control"])
    out["delta"] = float(np.abs(gen_r.cpu().numpy() - g).mean())
    out["live"] = out["delta"] > LIVE_DELTA
    return out


def main(argv=None) -> list:
    """Returns one dict of :func:`analyze_sample` an utterance."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--encoder_checkpoint", type=str,
                        default="outputs/encoder/checkpoints")
    parser.add_argument("--vae_checkpoint", type=str,
                        default="outputs/vae/checkpoints")
    parser.add_argument("--num_samples", type=int, default=4)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.verbose)
    cfg_file = Path(args.vae_checkpoint) / "config.json"
    if cfg_file.exists():
        args.config = str(cfg_file)
    cfg = resolve_config(args)

    ds = LJSpeechVAEDataset(
        args.data_root, args.alignment_dir, split="val",
        cache_dir=args.cache_dir, audio=cfg.audio, device=device,
    )
    encoder = load_frozen_encoder(cfg, args.encoder_checkpoint, device)
    vae = load_frozen_vae(cfg, args.vae_checkpoint, device)
    gen = seeded_generator(0 if args.seed is None else args.seed, device)

    rows = []
    for i in range(min(args.num_samples, len(ds))):
        a = analyze_sample(encoder, vae, ds[i], cfg, device, generator=gen)
        rows.append(a)
        print(f"[{a['file_id']}] recon MSE={a['mse']:.4f} ({a['rubric']}) "
              f"recon std={a['recon_std']:.3f} target std="
              f"{a['target_std']:.3f} posterior |mean|="
              f"{a['posterior_abs_mean']:.3f} logvar mean="
              f"{a['logvar_mean']:.3f}")
        if a["flat"]:
            print("  WARNING: flat reconstruction (std < 0.5) — possible "
                  "mode collapse")
        print(f"  prior generate: std={a['gen_std']:.3f} "
              f"range [{a['gen_min']:.2f}, {a['gen_max']:.2f}]")
        print(f"  random-cond control: |Δ|={a['delta']:.3f} "
              + ("(conditioning is live)" if a["live"]
                 else "(WARNING: conditioning ignored!)"))
    return rows


if __name__ == "__main__":
    main()
