"""Evaluate a trained duration model: MAE / RMSE / correlation + verdict.

The port's counterpart of the JAX package's
``scripts/test_trained_encoder.py``: the best (else latest) duration-stage
checkpoint on the validation split, per utterance in linear frames, with
the tiered rubric (MAE < 5 frames EXCELLENT, < 10 GOOD, < 20 FAIR, else
POOR; one frame is hop / sample rate, 11.6 ms by default).

Usage:
    python -m iris_tts_tpu_torch.scripts.test_trained_encoder \
        --encoder_checkpoint outputs/encoder/checkpoints \
        [--data_root ...] [--alignment_dir ...] [--cache_dir ...] \
        [--num_samples 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from iris_tts_tpu_torch.data.batching import BucketedBatcher, to_device
from iris_tts_tpu_torch.data.ljspeech import LJSpeechDurationDataset
from iris_tts_tpu_torch.models import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager

logger = logging.getLogger(__name__)

VERDICTS = [(5, "EXCELLENT"), (10, "GOOD"), (20, "FAIR"), (1e9, "POOR")]


def verdict_of(mae: float) -> str:
    return next(v for thresh, v in VERDICTS if mae < thresh)


def load_duration_model(cfg, checkpoint_dir, device) -> nn.ModuleDict:
    """Encoder + duration head of the best (else latest) checkpoint."""
    params = nn.ModuleDict({
        "encoder": PhonemeEncoder(cfg.encoder),
        "duration": DurationPredictor(cfg.encoder.embed_dim, cfg.duration),
    })
    mgr = CheckpointManager(Path(checkpoint_dir))
    params.load_state_dict(mgr.restore_best_params())
    mgr.close()
    return params.to(device).eval()


@torch.no_grad()
def duration_errors(params: nn.ModuleDict, val_ds, num_samples: int,
                    device) -> dict:
    """Per-utterance MAE / RMSE (and correlation where both sides vary) of
    the predicted linear frames over the first ``num_samples`` evaluable
    utterances of the split, in the batcher's order (seed 0)."""
    batcher = BucketedBatcher(val_ds, 16, with_mel=False, seed=0)
    maes, rmses, corrs = [], [], []
    n_seen = 0
    for batch in batcher.epoch(0):
        b = to_device(batch, device)
        enc = params["encoder"](b["phoneme_ids"],
                                padding_mask=b["phoneme_mask"])
        log_d = params["duration"](enc)
        pred = (torch.exp(log_d) - 1.0).cpu().numpy()  # linear frames
        for i in range(pred.shape[0]):
            m = batch["phoneme_mask"][i] > 0
            if m.sum() < 2 or n_seen >= num_samples:
                continue
            p, t = pred[i][m], batch["durations"][i][m]
            maes.append(np.abs(p - t).mean())
            rmses.append(np.sqrt(((p - t) ** 2).mean()))
            if np.std(p) > 1e-6 and np.std(t) > 1e-6:
                corrs.append(np.corrcoef(p, t)[0, 1])
            n_seen += 1
        if n_seen >= num_samples:
            break
    return {"maes": maes, "rmses": rmses, "corrs": corrs, "n_seen": n_seen}


def main(argv=None) -> dict:
    """Returns ``{"n_samples", "mae_frames", "mae_ms", "rmse_frames",
    "corr", "verdict"}``; empty when the split has no evaluable
    utterance."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument(
        "--encoder_checkpoint", type=str,
        default="outputs/encoder/checkpoints",
    )
    parser.add_argument("--num_samples", type=int, default=100)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    setup_logging(args.verbose)
    cfg_file = Path(args.encoder_checkpoint) / "config.json"
    if cfg_file.exists():
        args.config = str(cfg_file)
    cfg = resolve_config(args)

    val_ds = LJSpeechDurationDataset(
        args.data_root, args.alignment_dir, split="val",
        cache_dir=args.cache_dir, audio=cfg.audio,
    )
    params = load_duration_model(cfg, args.encoder_checkpoint, device)
    errs = duration_errors(params, val_ds, args.num_samples, device)
    if not errs["maes"]:
        logger.error(
            "no evaluable validation samples (val split has %d utterances); "
            "train with a larger corpus or val_fraction", len(val_ds),
        )
        return {}
    mae = float(np.mean(errs["maes"]))
    frame_ms = cfg.audio.hop_length / cfg.audio.sample_rate * 1000
    out = {"n_samples": errs["n_seen"], "mae_frames": mae,
           "mae_ms": mae * frame_ms,
           "rmse_frames": float(np.mean(errs["rmses"])),
           "corr": (float(np.mean(errs["corrs"])) if errs["corrs"]
                    else float("nan")),
           "verdict": verdict_of(mae)}
    logger.info(
        "%d samples: MAE %.2f frames (%.1f ms), RMSE %.2f, corr %.3f → %s",
        out["n_samples"], mae, out["mae_ms"], out["rmse_frames"],
        out["corr"], out["verdict"],
    )
    return out


if __name__ == "__main__":
    main()
