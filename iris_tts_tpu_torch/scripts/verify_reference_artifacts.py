"""One-command check of real reference artifacts against the port.

The port's counterpart of the JAX package's
``scripts/verify_reference_artifacts.py``. Given any of the reference's
trained artifacts (the speechbrain HiFiGAN ``generator.ckpt``, per-stage
Keras ``.weights.h5`` files, LJSpeech with its alignments), it runs the
conversion, scores it (the converted generator's waveform against the
torch oracle's forward, the BASELINE 1e-3 max-abs contract; each Keras
stage's forward finite), optionally trains one real VAE epoch, and
appends a dated results section to the Markdown file ``--parity_md``
(which it requires: it writes no file of its own choosing).

Usage (any subset of the artifact flags):
    python -m iris_tts_tpu_torch.scripts.verify_reference_artifacts \
        --hifigan_ckpt /path/to/generator.ckpt \
        --encoder_h5 enc.weights.h5 --duration_h5 dur.weights.h5 \
        --ljspeech /path/to/LJSpeech-1.1 --alignment_dir /path/to/aligned \
        --parity_md outputs/parity_report.md
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from iris_tts_tpu_torch.runtime import (
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.scripts.common import add_device_arg


def check_hifigan(ckpt: Path, cfg, lines: list, device) -> bool:
    """Convert a torch generator checkpoint and score the port generator's
    waveform against the torch oracle's forward on the same weights, both
    on ``device`` (max-abs ≤ 1e-3)."""
    from iris_tts_tpu_torch.convert.hifigan_torch import (
        convert_hifigan_state_dict,
        load_torch_checkpoint,
        normalize_state_dict_keys,
    )
    from iris_tts_tpu_torch.convert.torch_oracle import TorchGenerator
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator

    t0 = time.time()
    sd = load_torch_checkpoint(ckpt)
    params = convert_hifigan_state_dict(sd, cfg.hifigan)
    lines.append(f"- hifigan conversion: OK ({time.time() - t0:.1f}s, "
                 f"{ckpt})")
    try:
        oracle = TorchGenerator(cfg.hifigan)
        oracle.load_state_dict(
            {k: torch.as_tensor(np.asarray(v))
             for k, v in normalize_state_dict_keys(sd).items()},
            strict=False,
        )
        oracle = oracle.to(device).eval()
    except (RuntimeError, KeyError, ValueError) as e:
        lines.append(f"- hifigan torch-oracle load FAILED: {e}")
        return False
    mel = np.random.default_rng(0).standard_normal(
        (1, 87, cfg.hifigan.in_channels)).astype(np.float32)
    x = torch.from_numpy(mel).to(device)
    gen = HiFiGANGenerator(cfg.hifigan)
    gen.load_state_dict(params, strict=True)
    gen = gen.to(device).eval()
    with torch.no_grad():
        want = oracle(x.transpose(1, 2))[:, 0]
        got = gen(x)
    err = float((got - want).abs().max())
    ok = err <= 1e-3
    lines.append(
        f"- hifigan waveform parity vs torch oracle: max|Δ| = {err:.2e} "
        f"({'PASS' if ok else 'FAIL'} vs the 1e-3 BASELINE contract)"
    )
    return ok


def check_keras_stage(h5: Path, stage: str, cfg, lines: list,
                      device) -> bool:
    """Convert a reference ``.weights.h5`` and smoke the converted weights
    through the matching port module."""
    from iris_tts_tpu_torch.convert import keras_h5
    from iris_tts_tpu_torch.models import (
        DurationPredictor,
        PhonemeEncoder,
        PostNet,
        TextConditionedVAE,
    )

    t0 = time.time()
    w = keras_h5.read_weights_h5(h5)
    try:
        if stage == "encoder":
            mod = PhonemeEncoder(cfg.encoder)
            sd = keras_h5.convert_encoder(w, cfg.encoder.num_blocks)
            args = (torch.zeros((1, 8), dtype=torch.long),)
        elif stage == "duration":
            mod = DurationPredictor(cfg.encoder.embed_dim, cfg.duration)
            sd = keras_h5.convert_duration(w, cfg.duration.num_layers)
            args = (torch.zeros((1, 8, cfg.encoder.embed_dim)),)
        elif stage == "postnet":
            mod = PostNet(cfg.postnet)
            sd = keras_h5.convert_postnet(w, cfg.postnet.num_layers)
            args = (torch.zeros((1, 8, cfg.postnet.n_mels)),)
        elif stage == "vae":
            mod = TextConditionedVAE(cfg.vae)
            sd = keras_h5.convert_vae(
                w, cfg.vae.num_wavenet_blocks, cfg.vae.decoder_blocks,
                cfg.vae.down_stages, cfg.vae.flow_layers)
            t = cfg.vae.down_factor * 4
            args = (torch.zeros((1, t, cfg.vae.n_mels)),
                    torch.zeros((1, t, cfg.vae.cond_dim)))
        else:
            raise ValueError(f"unknown stage {stage}")
        mod.load_state_dict(sd, strict=True)
        mod = mod.to(device).eval()
        with torch.no_grad():
            out = mod(*(a.to(device) for a in args))
    except (KeyError, RuntimeError, ValueError) as e:
        lines.append(f"- {stage} .weights.h5 conversion FAILED: {e}")
        return False
    leaves = out if isinstance(out, (tuple, list)) else [out]
    flat = []
    while leaves:
        x = leaves.pop()
        if isinstance(x, (tuple, list)):
            leaves.extend(x)
        elif torch.is_tensor(x):
            flat.append(x)
    finite = all(bool(torch.isfinite(x).all()) for x in flat)
    lines.append(
        f"- {stage} .weights.h5 conversion: OK ({time.time() - t0:.1f}s, "
        f"forward finite={finite}, {h5})"
    )
    return finite


def check_ljspeech_epoch(data_root: Path, alignment_dir: Path, cfg,
                         lines: list, cache_dir: Path, device) -> bool:
    """One real VAE training epoch on the dataset: encoder from random
    init (frozen), batch 8; the losses must be finite and fall within the
    epoch."""
    from iris_tts_tpu_torch.data.batching import BucketedBatcher, to_device
    from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
    from iris_tts_tpu_torch.models import PhonemeEncoder, TextConditionedVAE
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.train import (
        TrainState,
        adam_clipped,
        make_vae_train_step,
    )

    t0 = time.time()
    ds = LJSpeechVAEDataset(
        data_root, alignment_dir, split="train", cache_dir=cache_dir,
        audio=cfg.audio, max_frames=1024, device=device,
    )
    lines.append(f"- LJSpeech dataset: {len(ds)} train utterances, vocab "
                 f"{len(ds.vocab)}")
    if not len(ds):
        lines.append("- LJSpeech epoch: FAILED (empty dataset)")
        return False
    cfg = replace(cfg, encoder=replace(cfg.encoder,
                                       vocab_size=len(ds.vocab)))
    enc = PhonemeEncoder(cfg.encoder)
    vae = TextConditionedVAE(cfg.vae)
    init_params(enc, seeded_generator(0, "cpu"))
    init_params(vae, seeded_generator(1, "cpu"))
    state = TrainState.create(vae.to(device), adam_clipped(1e-3), 0,
                              frozen={"encoder": enc.to(device)})
    step = make_vae_train_step(cfg)
    batcher = BucketedBatcher(ds, 8, with_mel=True,
                              down_factor=cfg.vae.down_factor)
    losses = []
    for batch in batcher.epoch(0):
        state, metrics = step(state, to_device(batch, device), 0.001)
        losses.append(float(metrics["total"]))
    ok = (
        len(losses) > 1
        and all(np.isfinite(losses))
        and losses[-1] < losses[0]
    )
    lines.append(
        f"- LJSpeech VAE epoch: {len(losses)} steps in "
        f"{time.time() - t0:.1f}s, loss {losses[0]:.3f} → {losses[-1]:.3f} "
        f"({'PASS' if ok else 'FAIL'})"
    )
    return ok


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hifigan_ckpt", type=Path, default=None)
    ap.add_argument("--encoder_h5", type=Path, default=None)
    ap.add_argument("--duration_h5", type=Path, default=None)
    ap.add_argument("--postnet_h5", type=Path, default=None)
    ap.add_argument("--vae_h5", type=Path, default=None)
    ap.add_argument("--ljspeech", type=Path, default=None)
    ap.add_argument("--alignment_dir", type=Path, default=None)
    ap.add_argument("--cache_dir", type=Path, default=Path("outputs/refcache"))
    ap.add_argument("--config", type=str, default=None,
                    help="IrisConfig JSON (default: production config)")
    ap.add_argument("--parity_md", type=Path, required=True,
                    help="Markdown report the dated section is appended to")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from iris_tts_tpu_torch.config import IrisConfig, load_config

    cfg = load_config(args.config) if args.config else IrisConfig()
    device = resolve_device(args.device)
    pin_math_precision()
    lines: list = []
    results: list = []
    if args.hifigan_ckpt:
        results.append(check_hifigan(args.hifigan_ckpt, cfg, lines, device))
    for stage, p in (("encoder", args.encoder_h5),
                     ("duration", args.duration_h5),
                     ("postnet", args.postnet_h5),
                     ("vae", args.vae_h5)):
        if p:
            results.append(check_keras_stage(p, stage, cfg, lines, device))
    if args.ljspeech:
        if not args.alignment_dir:
            ap.error("--ljspeech needs --alignment_dir")
        results.append(check_ljspeech_epoch(
            args.ljspeech, args.alignment_dir, cfg, lines, args.cache_dir,
            device))
    if not results:
        ap.error("nothing to verify: pass at least one artifact flag")

    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
    verdict = "ALL PASS" if all(results) else "FAILURES PRESENT"
    section = "\n".join([
        "",
        f"## Real-artifact verification — {stamp} ({verdict})",
        "",
        "Produced by `python -m "
        "iris_tts_tpu_torch.scripts.verify_reference_artifacts`:",
        "",
        *lines,
        "",
    ])
    with open(args.parity_md, "a") as f:
        f.write(section)
    print(section)
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
