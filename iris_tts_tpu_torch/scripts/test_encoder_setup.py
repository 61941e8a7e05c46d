"""Pre-training smoke test for the encoder/duration stage.

The port's counterpart of the JAX package's
``scripts/test_encoder_setup.py``: dataset load (synthetic samples when no
corpus is found) → model build → batched forward + Huber loss, printed as
✓/✗ checks and ``SETUP OK``; the exit code is the number of failures. The
real correctness coverage lives in the tests; this is the quick
pre-flight.

Usage:
    python -m iris_tts_tpu_torch.scripts.test_encoder_setup \
        [--data_root data/LJSpeech-1.1] [--config cfg.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import traceback
from dataclasses import replace

import numpy as np
import torch
from torch import nn

from iris_tts_tpu_torch.data.batching import collate_duration_batch, to_device
from iris_tts_tpu_torch.data.ljspeech import LJSpeechDurationDataset, Sample
from iris_tts_tpu_torch.models import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.ops.losses import duration_huber_loss
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)


def main(argv=None) -> dict:
    """Returns ``{"failures", "samples", "vocab_size", "n_params",
    "loss"}`` (``loss`` None when the forward failed)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.verbose)
    cfg = resolve_config(args)
    out = {"failures": 0, "loss": None}

    # 1. dataset (falls back to synthetic samples if no corpus present)
    try:
        ds = LJSpeechDurationDataset(
            args.data_root, args.alignment_dir, split="train",
            cache_dir=args.cache_dir, audio=cfg.audio,
        )
        assert len(ds) > 0
        print(f"✓ dataset: {len(ds)} samples, vocab {len(ds.vocab)}")
        vocab_size = len(ds.vocab)
        samples = [ds[i] for i in range(min(4, len(ds)))]
    except Exception as e:
        print(f"… no corpus at {args.data_root} ({e}); using synthetic")
        vocab_size = cfg.encoder.vocab_size
        rng = np.random.default_rng(0)
        samples = [
            Sample(f"syn{i}", "",
                   rng.integers(2, vocab_size, 12).astype(np.int32),
                   rng.integers(1, 9, 12).astype(np.float32))
            for i in range(4)
        ]
    out.update(samples=len(samples), vocab_size=vocab_size)

    # 2. model build
    try:
        cfg = replace(cfg, encoder=replace(cfg.encoder,
                                           vocab_size=vocab_size))
        params = nn.ModuleDict({
            "encoder": PhonemeEncoder(cfg.encoder),
            "duration": DurationPredictor(cfg.encoder.embed_dim,
                                          cfg.duration),
        })
        init_params(params, seeded_generator(0, "cpu"))
        params = params.to(device).eval()
        out["n_params"] = sum(p.numel()
                              for p in params["encoder"].parameters())
        print(f"✓ models built ({out['n_params']:,} encoder params)")
    except Exception:
        traceback.print_exc()
        out["failures"] = 1
        return out

    # 3. batched forward + loss
    try:
        batch = to_device(collate_duration_batch(samples, phoneme_bucket=16),
                          device)
        with torch.no_grad():
            enc = params["encoder"](batch["phoneme_ids"],
                                    padding_mask=batch["phoneme_mask"])
            pred = params["duration"](enc)
            loss = float(duration_huber_loss(pred, batch["durations"],
                                             batch["phoneme_mask"]))
        assert np.isfinite(loss)
        out["loss"] = loss
        print(f"✓ batched forward + loss = {loss:.4f} "
              f"({'reasonable' if loss < 500 else 'check scaling'})")
    except Exception:
        traceback.print_exc()
        out["failures"] += 1

    print("SETUP OK" if out["failures"] == 0
          else f"{out['failures']} FAILURES")
    return out


if __name__ == "__main__":
    sys.exit(main()["failures"])
