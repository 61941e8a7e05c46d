"""VAE loss forensics: re-derive the training step's loss arithmetic.

The port's counterpart of the JAX package's root ``debug_vae_loss.py``, at
the full ``IrisConfig()``: one batch through (1) the VAE train step, (2)
an explicit recompute with the library loss on the same random stream,
and (3) the raw NumPy arithmetic (masked sums, denominators, KL
composition), with NaN/Inf tripwires. If the three disagree (beyond 1e-4)
the training step has a bug.

Usage:
    python -m iris_tts_tpu_torch.scripts.debug_vae_loss \
        [--batch_size 2] [--frames 32] [--kl_weight 0.01] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.data.batching import to_device
from iris_tts_tpu_torch.models import PhonemeEncoder, TextConditionedVAE
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.ops.length import length_regulate
from iris_tts_tpu_torch.ops.losses import vae_loss
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import add_device_arg
from iris_tts_tpu_torch.train import TrainState, adam_clipped, make_vae_train_step

AGREE_LIMIT = 1e-4


def _rounded(metrics) -> dict:
    return {k: round(float(v), 6) for k, v in metrics.items()}


def main(argv=None) -> dict:
    """Returns ``{"step": metrics, "manual": metrics, "raw": {"recon_l1",
    "kl", "total"}, "agree": bool}``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--kl_weight", type=float, default=0.01)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = IrisConfig()
    B, P, T = args.batch_size, 8, args.frames
    encoder = PhonemeEncoder(cfg.encoder)
    vae = TextConditionedVAE(cfg.vae)
    init_params(encoder, seeded_generator(0, "cpu"))
    init_params(vae, seeded_generator(0, "cpu"))
    encoder, vae = encoder.to(device).eval(), vae.to(device)

    rng = np.random.default_rng(0)
    batch = to_device({
        "phoneme_ids": rng.integers(2, cfg.encoder.vocab_size,
                                    (B, P)).astype(np.int32),
        "phoneme_mask": np.ones((B, P), np.float32),
        "durations": np.full((B, P), T // P, np.float32),
        "mel": rng.standard_normal((B, T, cfg.vae.n_mels)).astype(
            np.float32),
    }, device)
    kl_weight = torch.tensor(args.kl_weight, device=device)

    # 1) What the train step computes (it updates the VAE in place, so the
    # recompute below runs on a copy of the weights it started from).
    before = copy.deepcopy(vae)
    state = TrainState.create(vae, adam_clipped(1e-4), 0,
                              frozen={"encoder": encoder})
    rng_state = state.generator.get_state()
    _, metrics = make_vae_train_step(cfg)(state, batch, kl_weight)
    out = {"step": _rounded(metrics)}
    print("train step:      ", out["step"])

    # 2) Explicit re-derivation with the same random stream: the step draws
    # its posterior noise and dropout masks from the state's generator, so
    # a generator restored to the state it had before the step replays them
    # (JAX folds the step count into the state's key instead).
    gen = torch.Generator(device=device)
    gen.set_state(rng_state)
    with torch.no_grad():
        enc = encoder(batch["phoneme_ids"],
                      padding_mask=batch["phoneme_mask"])
        cond, frame_mask = length_regulate(
            enc, batch["durations"].to(torch.int32), T)
        recon, (mean, logvar), _ = before(batch["mel"], cond,
                                          deterministic=False, generator=gen)
        for name, x in [("recon", recon), ("mean", mean),
                        ("logvar", logvar)]:
            assert bool(torch.isfinite(x).all()), f"{name} has NaN/Inf!"
        _, manual = vae_loss(batch["mel"], recon, mean, logvar, frame_mask,
                             cfg.vae.down_factor, kl_weight)
    out["manual"] = _rounded(manual)
    print("manual recompute:", out["manual"])

    # 3) Fully-manual arithmetic (no library loss functions).
    m = frame_mask.cpu().numpy()[..., None]
    mel_np, recon_np = batch["mel"].cpu().numpy(), recon.cpu().numpy()
    mean_np, logvar_np = mean.cpu().numpy(), logvar.cpu().numpy()
    diff = np.abs(mel_np - recon_np) * m
    recon_l1 = diff.sum() / (m.sum() * cfg.vae.n_mels + 1e-6)
    lm = frame_mask.cpu().numpy()[:, :: cfg.vae.down_factor][..., None]
    kl_el = -0.5 * (1 + logvar_np - mean_np ** 2 - np.exp(logvar_np))
    kl = (kl_el * lm).sum() / (lm.sum() + 1e-8)
    out["raw"] = {"recon_l1": float(recon_l1), "kl": float(kl),
                  "total": float(recon_l1 + args.kl_weight * kl)}
    print(f"raw numpy:        recon_l1={recon_l1:.6f} kl={kl:.6f} "
          f"total={recon_l1 + args.kl_weight * kl:.6f}")

    out["agree"] = bool(
        abs(recon_l1 - float(manual["recon_l1"])) < AGREE_LIMIT
        and abs(kl - float(manual["kl"])) < AGREE_LIMIT)
    print("✓ all three derivations agree" if out["agree"]
          else "✗ MISMATCH — investigate")
    return out


if __name__ == "__main__":
    main()
