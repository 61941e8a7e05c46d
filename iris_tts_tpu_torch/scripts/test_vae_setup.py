"""Pre-training smoke test for the VAE stage, incl. flow invertibility.

The port's counterpart of the JAX package's ``scripts/test_vae_setup.py``:
the reconstruction forward's shapes and the zero-initialised ``logvar``
head, a finite ``generate()`` from the prior, and the flow invertibility
property ``max|z − flow⁻¹(flow(z))|`` on ``latent_dim`` (below 1e-4),
printed as ✓/✗ checks and ``SETUP OK``; the exit code is the number of
failures. Weights and inputs come from generators seeded with 0.

Usage:
    python -m iris_tts_tpu_torch.scripts.test_vae_setup \
        [--config cfg.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import traceback

import torch

from iris_tts_tpu_torch.models import TextConditionedVAE, VolumePreservingFlow
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)

FLOW_LIMIT = 1e-4


def main(argv=None) -> dict:
    """Returns ``{"failures", "gen_std", "flow_err"}`` (None where a check
    failed before its number)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.verbose)
    cfg = resolve_config(args).vae
    out = {"failures": 0, "gen_std": None, "flow_err": None}
    gen = seeded_generator(0, device)
    B, T = 2, cfg.down_factor * 8
    tp = T // cfg.down_factor

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    # 1. build + reconstruction forward
    try:
        vae = TextConditionedVAE(cfg)
        init_params(vae, seeded_generator(0, "cpu"))
        vae = vae.to(device).eval()
        mel, cond = normal(B, T, cfg.n_mels), normal(B, T, cfg.cond_dim)
        with torch.no_grad():
            recon, (mean, logvar), _ = vae(mel, cond)
        assert tuple(recon.shape) == (B, T, cfg.n_mels)
        assert tuple(mean.shape) == (B, tp, cfg.latent_dim)
        assert float(logvar.abs().max()) == 0.0  # zero-init head
        print(f"✓ VAE forward: recon {tuple(recon.shape)}, latent "
              f"{tuple(mean.shape)}, logvar zero-init")
    except Exception:
        traceback.print_exc()
        out["failures"] = 1
        return out

    # 2. generation from prior
    try:
        with torch.no_grad():
            mel_gen, _ = vae.generate(cond, generator=gen)
        assert tuple(mel_gen.shape) == (B, T, cfg.n_mels)
        assert bool(torch.isfinite(mel_gen).all())
        out["gen_std"] = float(mel_gen.std(unbiased=False))
        print(f"✓ generate(): {tuple(mel_gen.shape)}, "
              f"std={out['gen_std']:.3f}")
    except Exception:
        traceback.print_exc()
        out["failures"] += 1

    # 3. flow invertibility on latent_dim
    try:
        flow = VolumePreservingFlow(cfg.latent_dim, cfg.flow_layers,
                                    cfg.flow_hidden, cfg.model_channels)
        init_params(flow, seeded_generator(0, "cpu"))
        flow = flow.to(device)
        # channels first, as the VAE runs its flow
        z = normal(B, cfg.latent_dim, tp)
        lat_cond = normal(B, cfg.model_channels, tp)
        with torch.no_grad():
            back = flow(flow(z, lat_cond), lat_cond, reverse=True)
        err = float((z - back).abs().max())
        out["flow_err"] = err
        assert err < FLOW_LIMIT, err
        print(f"✓ flow invertibility: max|z − f⁻¹(f(z))| = {err:.2e}")
    except Exception:
        traceback.print_exc()
        out["failures"] += 1

    print("SETUP OK" if out["failures"] == 0
          else f"{out['failures']} FAILURES")
    return out


if __name__ == "__main__":
    sys.exit(main()["failures"])
