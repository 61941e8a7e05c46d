"""Bucketed batched synthesis of many utterances on one device.

The texts are sorted by phoneme count and cut into batches of
``--batch_size`` (the last padded with its final row). Stage A (encoder +
durations) runs for every batch first; then stage B (acoustic model and
vocoder) runs grouped by frame bucket, so consecutive calls reuse the same
shapes. The summary of ``SynthesisMeter`` (realtime factor, mel frames a
second, latency) is logged and returned.

``--mesh`` runs data-parallel over the processes of the
``torch.distributed`` group (``TTSPipeline.use_mesh``; the batch size
rounds to a multiple of the ranks, at least one row each), each rank
synthesizing its rows of every batch; rank 0 writes the WAVs.
``--force_cpu_devices N`` starts N gloo ranks on the CPU.

Usage:
    python -m iris_tts_tpu_torch.scripts.batch_synthesize \
        --text_file sentences.txt --output_dir outputs/batch --random_weights
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.data.audio_io import write_wav
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.runtime import resolve_device, wrap_int32
from iris_tts_tpu_torch.parallel.mesh import is_primary
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    add_mesh_arg,
    mesh_from_args,
    run_as_script,
    setup_logging,
    spawn_cpu_ranks,
)
from iris_tts_tpu_torch.utils.metrics import SynthesisMeter

logger = logging.getLogger(__name__)

DEFAULT_SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello world, this is a test of batched synthesis.",
    "Speech synthesis on tensor processing units is fast.",
    "Numbers like 42 and $3.50 are verbalised by rule.",
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--text_file", type=str, default=None,
                        help="one utterance per line")
    parser.add_argument("--num_utterances", type=int, default=256)
    parser.add_argument("--output_dir", type=str, default="outputs/batch")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--random_weights", action="store_true")
    parser.add_argument("--encoder_checkpoint", type=str,
                        default="outputs/encoder/checkpoints")
    parser.add_argument("--vae_checkpoint", type=str,
                        default="outputs/vae/checkpoints")
    parser.add_argument("--postnet_checkpoint", type=str, default=None)
    parser.add_argument("--hifigan_checkpoint", type=str, default=None,
                        help="pretrained torch generator.ckpt")
    parser.add_argument("--lexicon_path", type=str, default=None)
    parser.add_argument("--write_wavs", action="store_true")
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    add_mesh_arg(parser, model_parallel=False)
    return parser


@torch.inference_mode()
def synthesize_batches(
    pipe: TTSPipeline, texts: Sequence[str], batch_size: int, seed: int,
) -> Tuple[Dict[int, np.ndarray], List[Tuple[List[int], int]]]:
    """Synthesize ``texts`` in two sweeps → (waveform per text index, the
    plan: each batch's row indices, padding repeats included, and the seed
    its stage B drew the prior noise with).

    Stage B of a batch is the pipeline's own two-stage path, so each row
    equals ``pipe.synthesize([texts[i] for i in idxs], seed=batch_seed,
    fused=False)``. On a pipeline's mesh each rank runs its rows of every
    batch and every rank gets every waveform."""
    encoded = [pipe._text_to_ids_cached(t) for t in texts]
    order = sorted(range(len(texts)), key=lambda i: len(encoded[i]))
    staged = []
    for start in range(0, len(order), batch_size):
        idxs = order[start: start + batch_size]
        while len(idxs) < batch_size:  # pad the last batch (dropped below)
            idxs.append(idxs[-1])
        staged.append((idxs, *pipe._stage_a_device(
            *pipe._encode_texts([texts[i] for i in idxs]))))

    # Reading the totals waits for all of stage A, queued back to back.
    by_bucket: Dict[int, list] = {}
    for item in staged:
        by_bucket.setdefault(pipe._frame_bucket(int(item[3])), []).append(
            item)

    audio: Dict[int, np.ndarray] = {}
    plan = []
    n_done = 0
    for t_bucket, group in sorted(by_bucket.items()):
        for gi, (idxs, enc, frames, _) in enumerate(group):
            batch_seed = wrap_int32(seed + n_done)
            rows = pipe._batched_collect(pipe._stage_b(
                enc, frames, t_bucket, batch_seed, 1.0, False, len(idxs)))
            for r, i in enumerate(idxs):
                audio.setdefault(i, rows[r])
            plan.append((idxs, batch_seed))
            n_done += len(set(idxs))
            logger.info("bucket T=%d batch %d: P=%d → %d utterances done",
                        t_bucket, gi, frames.shape[1], n_done)
    return audio, plan


def main(argv=None) -> Dict[str, float]:
    """Returns the meter's summary."""
    args = build_parser().parse_args(argv)
    if args.force_cpu_devices:
        return spawn_cpu_ranks(__spec__.name, argv, args.force_cpu_devices)
    setup_logging(args.verbose)
    device = resolve_device(args.device)
    mesh = mesh_from_args(args, device)
    if mesh is not None:
        device = mesh.device
    if args.text_file:
        texts = [line.strip()
                 for line in Path(args.text_file).read_text().splitlines()
                 if line.strip()]
    else:
        texts = [DEFAULT_SENTENCES[i % len(DEFAULT_SENTENCES)]
                 for i in range(args.num_utterances)]
    logger.info("%d utterances", len(texts))

    if args.random_weights:
        pipe = TTSPipeline.initialize(IrisConfig(), seed=args.seed,
                                      device=device,
                                      lexicon_path=args.lexicon_path)
    else:
        pipe = TTSPipeline.from_checkpoints(
            args.encoder_checkpoint, args.vae_checkpoint,
            postnet_checkpoint=args.postnet_checkpoint,
            hifigan_checkpoint=args.hifigan_checkpoint,
            lexicon_path=args.lexicon_path, device=device)

    batch_size = args.batch_size
    if mesh is not None:
        pipe.use_mesh(mesh)
        dp = mesh.data_size
        batch_size = max(batch_size, dp) // dp * dp
    meter = SynthesisMeter(pipe.config.audio.sample_rate,
                           pipe.config.audio.hop_length)
    meter.start()
    audio, _ = synthesize_batches(pipe, texts, batch_size, args.seed)
    meter.stop(sum(len(a) for a in audio.values()))

    if args.write_wavs and is_primary(mesh):
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, a in sorted(audio.items()):
            write_wav(out_dir / f"utt_{i:04d}.wav", a,
                      pipe.config.audio.sample_rate)
    summary = meter.summary()
    logger.info("== batched synthesis summary ==")
    for k, v in summary.items():
        logger.info("  %s: %.3f", k, v)
    return summary


if __name__ == "__main__":
    run_as_script(main)
