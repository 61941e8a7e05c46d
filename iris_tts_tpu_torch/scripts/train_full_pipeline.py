"""One-command four-stage training run: encoder → VAE → PostNet → HiFiGAN
GAN, then assembly, held-out quality evaluation, and a deployable pipeline
artifact.

All four stages run in one process, each through its driver's
``main(argv)``, so resume and metrics behave as when they run alone. Then:

* ``TTSPipeline.from_checkpoints`` assembles the stages (the GAN stage's
  one checkpoint directory, ``hifigan_gan/checkpoints``, holds both sides;
  its EMA generator deploys when the run tracked one),
* the held-out split is scored: duration MAE, DTW-aligned MCD/LSD of
  synthesized vs ground-truth mels against a shuffled-utterance control,
  and the vocoder's resynthesis MCD (the resynthesis is scored through the
  log-mel on the pipeline's device: the CUDA kernel on the card), with
  eval wavs written beside the summary,
* the assembled pipeline is saved as one deployable artifact
  (``TTSPipeline.save``), reloaded, and re-scored against the pre-save
  numbers (the smoke-eval): the run exits 1 when the reload drifts.

A stage stopped by SIGTERM/SIGINT checkpoints, leaves its partial evidence
and stops the run with exit code 75; a rerun with the same ``--output_dir``
resumes every stage in place. The checkpoints and the artifact are the
port's own format (``torch.save`` files), not the JAX package's.

Usage (full run on the corpus generator's output):
    python -m iris_tts_tpu_torch.scripts.make_synthetic_corpus \
        --root data_synth --n 600
    python -m iris_tts_tpu_torch.scripts.train_full_pipeline \
        --data_root data_synth/LJSpeech-1.1 \
        --alignment_dir data_synth/aligned \
        --cache_dir outputs/synth_cache --output_dir outputs/run1 --bf16
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from iris_tts_tpu_torch.data.audio_io import load_audio, write_wav
from iris_tts_tpu_torch.data.batching import BucketedBatcher, to_device
from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.scripts import (
    train_encoder,
    train_hifigan,
    train_postnet,
    train_vae,
)
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    setup_logging,
)
from iris_tts_tpu_torch.scripts.plot_training_curves import (
    plot_stage,
    read_metrics,
)
from iris_tts_tpu_torch.train import loop as train_loop
from iris_tts_tpu_torch.train.steps import make_duration_eval_step
from iris_tts_tpu_torch.utils.metrics import MetricsWriter, quality_report

logger = logging.getLogger(__name__)

# stage name → subdirectory the stage writes under --output_dir
STAGE_DIRS = {
    "encoder": "encoder",
    "vae": "vae",
    "postnet": "postnet",
    "hifigan": "hifigan_gan",
}


def write_stage_evidence(
    out_root: Path,
    evidence_dir: Path | None,
    stage: str,
    seconds: float,
    partial: bool = False,
) -> None:
    """Snapshot one stage's metrics + config + loss curve into the evidence
    directory the moment the stage finishes (or is preempted), so a run cut
    short still leaves proof of every stage that completed."""
    if evidence_dir is None:
        return
    stage_dir = STAGE_DIRS.get(stage, stage)
    src = out_root / stage_dir
    dst = evidence_dir / "stages" / stage_dir
    dst.mkdir(parents=True, exist_ok=True)
    snapshot: dict = {
        "stage": stage_dir,
        "seconds": round(seconds, 1),
        "partial": partial,
    }
    mcsv = src / "metrics.csv"
    if mcsv.exists():
        shutil.copy2(mcsv, dst / "metrics.csv")
        series = read_metrics(mcsv)
        last: dict = {}
        last_step = None
        for name, pts in series.items():
            pts.sort()
            if pts:
                last[name] = round(pts[-1][1], 6)
                last_step = max(last_step or 0, pts[-1][0])
        snapshot["final_metrics"] = dict(sorted(last.items()))
        snapshot["last_step"] = last_step
        try:
            plot_stage(mcsv, dst / "curves.png",
                       f"{stage_dir} training metrics")
        except Exception as e:  # a plot failure must not kill the run
            logger.warning("curve plot for %s failed: %s", stage_dir, e)
    for cfg in src.glob("config_*.json"):
        shutil.copy2(cfg, dst / cfg.name)
    (dst / "snapshot.json").write_text(json.dumps(snapshot, indent=2))
    logger.info("stage evidence written to %s", dst)


def run_stage(
    name: str,
    main_fn,
    argv: list[str],
    out_root: Path,
    evidence_dir: Path | None = None,
) -> float:
    """Run one stage driver in-process with ``argv``; returns seconds."""
    logger.info("=== stage %s: %s ===", name, " ".join(argv))
    t0 = time.time()
    main_fn(argv)
    dt = time.time() - t0
    if train_loop.was_preempted():
        # The stage checkpointed and stopped on SIGTERM/SIGINT. Running the
        # next stage against a half-trained upstream would produce a
        # "complete" but wrong run: stop the whole driver instead; a rerun
        # with the same --output_dir resumes every stage in place.
        write_stage_evidence(out_root, evidence_dir, name, dt, partial=True)
        logger.warning(
            "=== stage %s preempted after %.1fs — stopping the pipeline "
            "(rerun with the same --output_dir to resume) ===", name, dt,
        )
        sys.exit(75)  # EX_TEMPFAIL
    write_stage_evidence(out_root, evidence_dir, name, dt)
    logger.info("=== stage %s done in %.1fs ===", name, dt)
    return dt


def build_pipeline(out_root: Path, cache_dir: str | Path,
                   device: torch.device,
                   skip_gan: bool = False) -> TTSPipeline:
    """The inference pipeline assembled from the stages' checkpoints under
    ``out_root``, with the vocab the encoder trained with."""
    return TTSPipeline.from_checkpoints(
        out_root / "encoder" / "checkpoints",
        out_root / "vae" / "checkpoints",
        postnet_checkpoint=out_root / "postnet" / "checkpoints",
        hifigan_gan_checkpoint=(
            None if skip_gan else out_root / "hifigan_gan" / "checkpoints"),
        vocab_path=Path(cache_dir) / "phoneme_vocab.json",
        device=device,
    )


def duration_mae(pipe: TTSPipeline, val_ds) -> float | None:
    """Duration MAE in frames over the whole split, each batch weighted by
    its real phonemes."""
    step = make_duration_eval_step(pipe.config)
    params = nn.ModuleDict({"encoder": pipe.model.encoder,
                            "duration": pipe.model.duration})
    maes, weights = [], []
    for batch in BucketedBatcher(val_ds, 8, with_mel=False, seed=0).epoch(0):
        m = step(params, to_device(batch, pipe.device))
        maes.append(float(m["duration_mae_frames"]))
        weights.append(int(np.asarray(batch["phoneme_mask"]).sum()))
    return float(np.average(maes, weights=weights)) if maes else None


def _mean(rows: list, key: str) -> float | None:
    return float(np.mean([r[key] for r in rows])) if rows else None


def evaluate_pipeline(pipe: TTSPipeline, val_ds, eval_dir: Path,
                      data_root: str | Path, eval_samples: int = 16,
                      eval_temperature: float = 0.7):
    """Held-out evaluation of ``pipe`` on ``val_ds`` → (summary, rows): the
    summary of duration MAE, DTW-aligned MCD/LSD against the shuffled
    control and resynthesis MCD, and the per-utterance quality rows. Writes
    ``quality.csv`` and the wavs under ``eval_dir``."""
    cfg = pipe.config
    sr = cfg.audio.sample_rate
    eval_dir.mkdir(parents=True, exist_ok=True)
    wav_dir = eval_dir / "wavs"
    wav_dir.mkdir(exist_ok=True)
    n_eval = min(eval_samples, len(val_ds))
    logger.info("evaluating on %d held-out utterances", n_eval)
    mae = duration_mae(pipe, val_ds)

    # Per-utterance synthesis quality: MCD/LSD vs ground truth, against a
    # shuffled-utterance control.
    per_sample = MetricsWriter(eval_dir / "quality.csv")
    rows = []
    quality_s = 0.0
    for i in range(n_eval):
        gt = val_ds[i]
        other = val_ds[(i + n_eval // 2 + 1) % len(val_ds)]
        synth_mel = pipe.synthesize_mel(gt.text, seed=0, temperature=0.0)
        t0 = time.perf_counter()
        q = quality_report(synth_mel, gt.mel, align="dtw")
        qc = quality_report(synth_mel, other.mel, align="dtw")
        quality_s += time.perf_counter() - t0
        row = {
            "mcd_db": q["mcd_db"], "lsd_db": q["lsd_db"],
            "control_mcd_db": qc["mcd_db"], "control_lsd_db": qc["lsd_db"],
            "gt_frames": gt.mel.shape[0], "synth_frames": len(synth_mel),
        }
        per_sample.write(i, row)
        rows.append(row)
        logger.info(
            "val[%d] %s: MCD %.2f dB (control %.2f), LSD %.2f dB",
            i, gt.file_id, q["mcd_db"], qc["mcd_db"], q["lsd_db"],
        )

    # Vocoder resynthesis: HiFiGAN on the ground-truth mel, scored as
    # mel(resynth) vs gt mel (frame-aligned, no DTW). The audio goes back to
    # the pipeline's device first, so the log-mel runs there.
    resynth_mcd = []
    for i in range(min(4, n_eval)):
        gt = val_ds[i]
        audio_r = pipe.vocode(gt.mel)
        mel_r = log_mel_spectrogram(
            torch.from_numpy(audio_r).to(pipe.device), cfg.audio
        ).cpu().numpy()[: gt.mel.shape[0]]
        q = quality_report(mel_r, gt.mel[: mel_r.shape[0]], align="trim")
        resynth_mcd.append(q["mcd_db"])
        write_wav(wav_dir / f"resynth_{gt.file_id}.wav", audio_r, sr)
        # the ground-truth audio next to it, for listening comparison
        gt_audio = load_audio(
            Path(data_root) / "wavs" / f"{gt.file_id}.wav", sr)
        write_wav(wav_dir / f"ref_{gt.file_id}.wav", gt_audio, sr)
        per_sample.write(i, {"resynth_mcd_db": q["mcd_db"]})

    # End-to-end wavs (text → audio through the full stack).
    for i in range(min(4, n_eval)):
        gt = val_ds[i]
        audio = pipe.synthesize(gt.text, seed=0, temperature=eval_temperature)
        write_wav(wav_dir / f"e2e_{gt.file_id}.wav", audio, sr)
    per_sample.close()

    mcd, mcd_ctrl = _mean(rows, "mcd_db"), _mean(rows, "control_mcd_db")
    summary = {
        "val_utterances": len(val_ds),
        "eval_samples": n_eval,
        "duration_mae_frames": mae,
        "mcd_db": mcd,
        "control_mcd_db": mcd_ctrl,
        "lsd_db": _mean(rows, "lsd_db"),
        "control_lsd_db": _mean(rows, "control_lsd_db"),
        "resynth_mcd_db": (
            float(np.mean(resynth_mcd)) if resynth_mcd else None
        ),
        "mcd_margin_db": (
            None if mcd is None else round(mcd_ctrl - mcd, 3)
        ),
        # host seconds in the DTW-aligned MCD/LSD of the held-out rows
        "quality_s": round(quality_s, 3),
    }
    return summary, rows


def artifact_smoke(pipe: TTSPipeline, artifact: Path, val_ds, rows: list,
                   half: bool) -> dict:
    """Save ``pipe`` to ``artifact``, reload it from disk and re-score
    held-out utterances against the pre-save model's MCD (``rows``). A
    meta or vocab export bug that changes the sound of the artifact shows
    here. float16 params round the weights by about 1e-4 relative, so
    that artifact is allowed more drift. ``save(half=True)`` refuses a
    tensor outside float16's range, and that error is not caught."""
    pipe.save(artifact, half=half)
    logger.info("pipeline artifact saved to %s%s", artifact,
                " (float16 params)" if half else "")
    tol_db = 0.25 if half else 0.02
    reloaded = TTSPipeline.load(artifact, device=pipe.device)
    smoke_rows = []
    for i in range(min(3, len(rows))):
        mel_a = reloaded.synthesize_mel(val_ds[i].text, seed=0,
                                        temperature=0.0)
        q = quality_report(mel_a, val_ds[i].mel, align="dtw")
        smoke_rows.append({
            "i": i,
            "mcd_db": round(q["mcd_db"], 4),
            "pre_save_mcd_db": round(rows[i]["mcd_db"], 4),
            "delta_db": round(q["mcd_db"] - rows[i]["mcd_db"], 4),
        })
    max_delta = max((abs(r["delta_db"]) for r in smoke_rows), default=0.0)
    ok = max_delta <= tol_db
    if ok:
        logger.info(
            "artifact smoke-eval OK: reloaded-artifact MCD within %.2f dB of "
            "the pre-save model (max delta %.4f dB)", tol_db, max_delta)
    else:
        logger.error(
            "artifact smoke-eval FAILED: reloaded artifact drifts %.4f dB "
            "MCD from the pre-save model (tol %.2f) — export bug?",
            max_delta, tol_db)
    return {
        "params_dtype": "float16" if half else "float32",
        "tol_db": tol_db,
        "max_abs_delta_db": round(max_delta, 4),
        "ok": ok,
        "samples": smoke_rows,
    }


def evaluate(args, out_root: Path, device: torch.device) -> dict:
    """Held-out evaluation of the assembled pipeline + artifact export."""
    pipe = build_pipeline(out_root, args.cache_dir, device, args.skip_gan)
    val_ds = LJSpeechVAEDataset(
        args.data_root, args.alignment_dir, split="val",
        cache_dir=args.cache_dir, audio=pipe.config.audio, device=device)
    eval_dir = out_root / "eval"
    summary, rows = evaluate_pipeline(
        pipe, val_ds, eval_dir, args.data_root, args.eval_samples,
        args.eval_temperature)
    logger.info("eval summary: %s", summary)
    (eval_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    summary["artifact_smoke"] = artifact_smoke(
        pipe, out_root / "pipeline_artifact", val_ds, rows,
        args.artifact_half)
    (eval_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_root", type=str,
                        default="data_synth/LJSpeech-1.1")
    parser.add_argument("--alignment_dir", type=str,
                        default="data_synth/aligned")
    parser.add_argument("--cache_dir", type=str, default="outputs/synth_cache")
    parser.add_argument("--output_dir", type=str, default="outputs/full_run")
    parser.add_argument("--config", type=str, default=None,
                        help="IrisConfig JSON (default: production config)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--encoder_epochs", type=int, default=150)
    parser.add_argument("--encoder_lr", type=float, default=1e-3)
    parser.add_argument("--vae_epochs", type=int, default=300)
    parser.add_argument("--vae_lr", type=float, default=1e-3)
    parser.add_argument("--postnet_epochs", type=int, default=60)
    parser.add_argument("--postnet_lr", type=float, default=1e-3)
    parser.add_argument("--gan_epochs", type=int, default=150)
    parser.add_argument("--gan_lr", type=float, default=2e-4)
    parser.add_argument("--gan_batch", type=int, default=16)
    parser.add_argument("--segment_frames", type=int, default=32)
    parser.add_argument("--disc_width", type=float, default=1.0)
    parser.add_argument("--ema_decay", type=float, default=0.999)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--eval_samples", type=int, default=16)
    parser.add_argument("--artifact_half", action="store_true",
                        help="store the pipeline artifact's params as "
                        "float16 (half size; ~1e-4 relative rounding)")
    parser.add_argument("--eval_temperature", type=float, default=0.7)
    parser.add_argument("--evidence_dir", type=str, default=None,
                        help="directory that receives per-stage evidence "
                        "(metrics, curves, snapshots) as each stage "
                        "completes, plus the final eval summary/wavs")
    parser.add_argument("--release_dir", type=str, default=None,
                        help="also copy the final pipeline artifact here")
    parser.add_argument("--skip_encoder", action="store_true")
    parser.add_argument("--skip_vae", action="store_true")
    parser.add_argument("--skip_postnet", action="store_true")
    parser.add_argument("--skip_gan", action="store_true")
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    return parser


def main(argv=None):
    """Returns the eval summary (None with ``--skip_eval``)."""
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    evidence_dir = Path(args.evidence_dir) if args.evidence_dir else None
    if evidence_dir:
        evidence_dir.mkdir(parents=True, exist_ok=True)
    timings: dict = {}

    def save_timings() -> None:
        """Persisted as each stage ends, so a cut-off run still reports
        stage costs."""
        payload = json.dumps(
            {k: round(v, 1) for k, v in timings.items()}, indent=2)
        (out_root / "timings.json").write_text(payload)
        if evidence_dir:
            (evidence_dir / "timings.json").write_text(payload)

    common = [
        "--data_root", args.data_root,
        "--alignment_dir", args.alignment_dir,
        "--cache_dir", args.cache_dir,
        "--output_dir", str(out_root),
        "--device", str(device),
    ]
    if args.config:
        common += ["--config", args.config]
    if args.bf16:
        common += ["--bf16"]

    # (stage, its timings key, skipped?, driver, the driver's own flags)
    stages = [
        ("encoder", "encoder_s", args.skip_encoder, train_encoder.main,
         ["--batch_size", str(args.batch_size),
          "--num_epochs", str(args.encoder_epochs),
          "--learning_rate", str(args.encoder_lr)]),
        ("vae", "vae_s", args.skip_vae, train_vae.main,
         ["--batch_size", str(args.batch_size),
          "--num_epochs", str(args.vae_epochs),
          "--learning_rate", str(args.vae_lr)]),
        ("postnet", "postnet_s", args.skip_postnet, train_postnet.main,
         ["--batch_size", str(args.batch_size),
          "--num_epochs", str(args.postnet_epochs),
          "--learning_rate", str(args.postnet_lr)]),
        # GAN segments are fixed-shape: the stage has its own batch size.
        ("hifigan", "gan_s", args.skip_gan, train_hifigan.main,
         ["--batch_size", str(args.gan_batch),
          "--num_epochs", str(args.gan_epochs),
          "--learning_rate", str(args.gan_lr),
          "--segment_frames", str(args.segment_frames),
          "--disc_width", str(args.disc_width),
          "--ema_decay", str(args.ema_decay)]),
    ]
    for name, key, skip, main_fn, stage_args in stages:
        if skip:
            continue
        timings[key] = run_stage(name, main_fn, common + stage_args,
                                 out_root, evidence_dir)
        save_timings()

    summary = None
    if not args.skip_eval:
        t0 = time.time()
        summary = evaluate(args, out_root, device)
        timings["eval_s"] = time.time() - t0
        save_timings()
        summary["stage_timings_s"] = {
            k: round(v, 1) for k, v in timings.items()}
        (out_root / "eval" / "summary.json").write_text(
            json.dumps(summary, indent=2))
        if evidence_dir:
            # eval evidence: summary, per-utterance quality, listening wavs
            dst = evidence_dir / "eval"
            if dst.exists():
                shutil.rmtree(dst)
            shutil.copytree(out_root / "eval", dst)
            logger.info("eval evidence copied to %s", dst)
        if args.release_dir:
            rel = Path(args.release_dir)
            if rel.exists():
                shutil.rmtree(rel)
            shutil.copytree(out_root / "pipeline_artifact", rel)
            logger.info("release artifact copied to %s", rel)
    logger.info("full pipeline run complete: %s", timings)
    if summary is not None and not summary["artifact_smoke"]["ok"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
