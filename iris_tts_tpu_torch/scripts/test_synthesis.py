"""End-to-end evaluation on a validation sample: generated vs ground truth.

The port's counterpart of the JAX package's ``scripts/test_synthesis.py``:
one validation utterance (its mel from the CUDA log-mel kernel on the
card) generated from the prior with its ground-truth durations, mel MSE /
MAE against the ground-truth mel, the trimmed quality report (MCD, LSD,
mel L1), and ``reference.wav`` plus ``generated.wav`` under
``<output_dir>/test_synthesis`` for listening. The waveform comes from
Griffin-Lim (60 iterations on the device) or from a torch HiFiGAN
``generator.ckpt`` (``--hifigan_checkpoint``, converted on load). The
prior draw comes from a ``torch.Generator`` seeded with ``--seed`` (0 when
not given).

Usage:
    python -m iris_tts_tpu_torch.scripts.test_synthesis \
        --encoder_checkpoint outputs/encoder/checkpoints \
        --vae_checkpoint outputs/vae/checkpoints \
        [--hifigan_checkpoint generator.ckpt] [--sample_index 0] \
        [--data_root ...] [--alignment_dir ...] [--cache_dir ...] \
        [--output_dir outputs] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from iris_tts_tpu_torch.data.audio_io import load_audio, write_wav
from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.ops.griffin_lim import griffin_lim_from_log_mel
from iris_tts_tpu_torch.ops.length import length_regulate, round_up_to_multiple
from iris_tts_tpu_torch.runtime import resolve_device, seeded_generator
from iris_tts_tpu_torch.scripts.common import (
    add_common_args,
    resolve_config,
    setup_logging,
)
from iris_tts_tpu_torch.train.stages import load_frozen_encoder, load_frozen_vae
from iris_tts_tpu_torch.utils.metrics import quality_report

logger = logging.getLogger(__name__)

GRIFFIN_LIM_ITERS = 60


@torch.no_grad()
def generate_with_gt_durations(encoder, vae, sample, cfg, device,
                               generator=None, z_prior=None) -> np.ndarray:
    """The mel generated from the prior over the utterance's ground-truth
    durations, trimmed to their sum: [n, n_mels]. ``z_prior`` ([1, T',
    latent]) replaces the draw from ``generator``."""
    ids = torch.from_numpy(np.asarray(sample.phoneme_ids,
                                      np.int64)).to(device)[None]
    durs = torch.from_numpy(
        sample.durations.astype(np.int32)).to(device)[None]
    T = round_up_to_multiple(int(durs.sum()), cfg.vae.down_factor)
    cond, mask = length_regulate(encoder(ids), durs, T)
    if z_prior is not None:
        z_prior = torch.as_tensor(z_prior, device=device)
    mel, _ = vae.generate(cond, z_prior=z_prior, generator=generator)
    n = int(mask.sum())
    return mel[0, :n].cpu().numpy()


def main(argv=None) -> dict:
    """Writes the two wavs; returns ``{"file_id", "mse", "mae", "mcd_db",
    "lsd_db", "mel_l1", "generated", "reference"}`` (the wav paths)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument(
        "--encoder_checkpoint", type=str,
        default="outputs/encoder/checkpoints",
    )
    parser.add_argument(
        "--vae_checkpoint", type=str, default="outputs/vae/checkpoints"
    )
    parser.add_argument("--hifigan_checkpoint", type=str, default=None)
    parser.add_argument("--sample_index", type=int, default=0)
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
    sample = val_ds[args.sample_index]
    logger.info("sample %s: %d phonemes, %d frames, text=%r",
                sample.file_id, sample.num_phonemes, sample.num_frames,
                sample.text[:60])

    encoder = load_frozen_encoder(cfg, args.encoder_checkpoint, device)
    vae = load_frozen_vae(cfg, args.vae_checkpoint, device)
    gen = seeded_generator(0 if args.seed is None else args.seed, device)
    mel_gen = generate_with_gt_durations(encoder, vae, sample, cfg, device,
                                         generator=gen)
    mel_gt = sample.mel[: len(mel_gen)]

    out = {"file_id": sample.file_id,
           "mse": float(np.mean((mel_gen - mel_gt) ** 2)),
           "mae": float(np.mean(np.abs(mel_gen - mel_gt)))}
    logger.info("GT-duration mel MSE=%.4f MAE=%.4f "
                "(rubric: MSE>5 bad, >1 could be better)",
                out["mse"], out["mae"])

    # Objective quality: MCD + log-spectral distance (dB). Frames already
    # correspond (ground-truth durations), so trim alignment is exact.
    out.update(quality_report(mel_gen, mel_gt, align="trim"))
    logger.info(
        "quality: MCD=%.2f dB  LSD=%.2f dB  mel L1=%.3f "
        "(trained TTS typically ~4-8 dB MCD; unrelated speech >10)",
        out["mcd_db"], out["lsd_db"], out["mel_l1"],
    )

    wav_dir = Path(args.output_dir) / "test_synthesis"
    wav_dir.mkdir(parents=True, exist_ok=True)
    sr = cfg.audio.sample_rate
    ref_wav = load_audio(
        Path(args.data_root) / "wavs" / f"{sample.file_id}.wav", sr)
    out["reference"] = wav_dir / "reference.wav"
    write_wav(out["reference"], ref_wav, sr)

    if args.hifigan_checkpoint:
        from iris_tts_tpu_torch.convert.hifigan_torch import (
            load_pretrained_hifigan,
        )

        voc = load_pretrained_hifigan(args.hifigan_checkpoint, cfg.hifigan,
                                      device=device)
        audio = voc(mel_gen.T)  # the reference layout, [n_mels, T]
    else:
        audio = griffin_lim_from_log_mel(
            torch.from_numpy(mel_gen).to(device), n_iter=GRIFFIN_LIM_ITERS,
            cfg=cfg.audio)
    out["generated"] = wav_dir / "generated.wav"
    write_wav(out["generated"], audio.float().cpu().numpy(), sr)
    logger.info("wrote %s (generated + reference)", wav_dir)
    return out


if __name__ == "__main__":
    main()
