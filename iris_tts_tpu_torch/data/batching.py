"""Length-bucketed batching with static shapes, GAN segment batches, and
a host→device prefetch thread.

The port's own copy of the JAX package's ``data/batching.py`` (plus the
``AudioSegmentBatcher`` of its ``scripts/train_hifigan.py``): every batch
is padded to a bucket shape from a small fixed ladder, and the numpy
batches are bit-identical to the JAX package's for the same dataset and
seed. :func:`prefetch_to_device` stages batches on a background thread
with pinned-memory ``non_blocking`` copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iris_tts_tpu_torch.data.audio_io import load_audio
from iris_tts_tpu_torch.data.ljspeech import Sample
from iris_tts_tpu_torch.ops.length import pick_bucket, round_up_to_multiple

DEFAULT_PHONEME_BUCKETS = (32, 64, 96, 128, 192, 256)
DEFAULT_FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048)


def collate_duration_batch(
    samples: Sequence[Sample],
    phoneme_bucket: Optional[int] = None,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Samples → static-shape duration-training batch
    (keys match iris_tts_tpu_torch.train.steps; reference: datasets.py:646-686)."""
    max_p = max(s.num_phonemes for s in samples)
    P = phoneme_bucket or max_p
    B = len(samples)
    ids = np.full((B, P), pad_id, np.int32)
    durs = np.zeros((B, P), np.float32)
    mask = np.zeros((B, P), np.float32)
    for i, s in enumerate(samples):
        n = min(s.num_phonemes, P)
        ids[i, :n] = s.phoneme_ids[:n]
        durs[i, :n] = s.durations[:n]
        mask[i, :n] = 1.0
    return {"phoneme_ids": ids, "durations": durs, "phoneme_mask": mask}


def collate_vae_batch(
    samples: Sequence[Sample],
    phoneme_bucket: Optional[int] = None,
    frame_bucket: Optional[int] = None,
    pad_id: int = 0,
    down_factor: int = 4,
) -> Dict[str, np.ndarray]:
    """Adds zero-padded mel [B, T, n_mels] with T a bucket multiple of the
    VAE down factor (reference: datasets.py:689-737 + the pad-to-multiple
    blocks it copy-pastes, train_vae.py:409-431)."""
    batch = collate_duration_batch(samples, phoneme_bucket, pad_id)
    max_t = max(s.mel.shape[0] for s in samples)
    T = frame_bucket or round_up_to_multiple(max_t, down_factor)
    n_mels = samples[0].mel.shape[1]
    mel = np.zeros((len(samples), T, n_mels), np.float32)
    for i, s in enumerate(samples):
        t = min(s.mel.shape[0], T)
        mel[i, :t] = s.mel[:t]
        # Clamp durations so their sum can't exceed the frame bucket
        # (length_regulate masks by cumulative duration).
        excess = int(batch["durations"][i].sum()) - t
        if excess > 0:
            d = batch["durations"][i]
            j = len(d) - 1
            while excess > 0 and j >= 0:
                take = min(excess, d[j] - (1.0 if d[j] > 0 else 0.0))
                d[j] -= take
                excess -= int(take)
                j -= 1
    batch["mel"] = mel
    return batch


@dataclass
class BucketedBatcher:
    """Groups samples into (P-bucket, T-bucket) bins and yields static-shape
    batches; deterministic shuffle per epoch."""

    dataset: Sequence[Sample] | "object"
    batch_size: int
    phoneme_buckets: Tuple[int, ...] = DEFAULT_PHONEME_BUCKETS
    frame_buckets: Tuple[int, ...] = DEFAULT_FRAME_BUCKETS
    with_mel: bool = True
    down_factor: int = 4
    pad_id: int = 0
    drop_last: bool = False
    seed: int = 1337

    def _bucket_key(self, sample: Sample) -> Tuple[int, int]:
        p = pick_bucket(sample.num_phonemes, self.phoneme_buckets)
        if not self.with_mel:
            return (p, 0)
        t = pick_bucket(
            round_up_to_multiple(
                sample.mel.shape[0] if sample.mel is not None
                else sample.num_frames,
                self.down_factor,
            ),
            self.frame_buckets,
        )
        return (p, t)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches for one epoch (shuffled deterministically)."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.dataset))

        bins: Dict[Tuple[int, int], List[Sample]] = {}
        for idx in order:
            s = self.dataset[int(idx)]
            key = self._bucket_key(s)
            bins.setdefault(key, []).append(s)
            if len(bins[key]) == self.batch_size:
                yield self._collate(bins.pop(key), key)
        if not self.drop_last:
            # Flush remainders, padding to the static batch size by cycling
            # the bin's real samples; the padded rows are then masked out of
            # every loss (phoneme mask and durations zeroed in _collate).
            for key, samples in sorted(
                bins.items(), key=lambda kv: kv[0]
            ):
                n_real = len(samples)
                while len(samples) < self.batch_size:
                    samples.append(samples[len(samples) % n_real])
                yield self._collate(samples, key, n_real=n_real)

    def _collate(self, samples: List[Sample], key: Tuple[int, int],
                 n_real: Optional[int] = None):
        p, t = key
        if self.with_mel:
            batch = collate_vae_batch(
                samples, p, t, self.pad_id, self.down_factor
            )
        else:
            batch = collate_duration_batch(samples, p, self.pad_id)
        if n_real is not None and n_real < len(samples):
            # Padding rows contribute nothing: masked losses divide by
            # mask sums, and zero durations yield an all-zero frame mask.
            batch["phoneme_mask"][n_real:] = 0.0
            batch["durations"][n_real:] = 0.0
        return batch

    def num_batches(self) -> int:
        """Lower bound on batches per epoch (remainder flushing adds up to
        one extra batch per occupied bucket bin). Epoch accounting must not
        rely on this — TrainState tracks the epoch directly."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class AudioSegmentBatcher:
    """Random fixed-length (mel, audio) segment batches — the standard
    HiFi-GAN training regime (8192-sample segments); a copy of the JAX
    package's ``scripts/train_hifigan.py`` batcher.

    Conditioning mels are sliced from the full-utterance cached mel rather
    than recomputed per crop: recomputing would centre-pad each crop, so its
    edge frames would encode audio the discriminator never sees."""

    def __init__(self, dataset, batch_size: int, segment_frames: int,
                 audio_cfg, seed: int = 1337):
        self.dataset = dataset
        self.batch_size = batch_size
        self.segment_frames = segment_frames
        self.audio_cfg = audio_cfg
        self.seed = seed

    def num_batches(self) -> int:
        return max(1, len(self.dataset) // self.batch_size)

    def epoch(self, epoch: int):
        rng = np.random.default_rng(self.seed + epoch)
        hop = self.audio_cfg.hop_length
        seg_t = self.segment_frames
        order = rng.permutation(len(self.dataset))
        batch_mel, batch_audio = [], []
        for idx in order:
            sample = self.dataset[int(idx)]  # full-context cached mel
            sid = sample.file_id
            wav = load_audio(
                Path(self.dataset.root) / "wavs" / f"{sid}.wav",
                self.audio_cfg.sample_rate,
            )
            n_frames = min(sample.mel.shape[0], len(wav) // hop)
            if n_frames <= seg_t:
                continue
            start_frame = int(rng.integers(0, n_frames - seg_t))
            audio_seg = wav[start_frame * hop : (start_frame + seg_t) * hop]
            mel = sample.mel[start_frame : start_frame + seg_t]
            batch_mel.append(mel)
            batch_audio.append(audio_seg)
            if len(batch_mel) == self.batch_size:
                yield {
                    "mel": np.stack(batch_mel),
                    "audio": np.stack(batch_audio),
                }
                batch_mel, batch_audio = [], []


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on ``device``. For a CUDA device each array is
    copied into pinned host memory and sent with a ``non_blocking`` copy on
    the current stream, so the copy overlaps whatever the card is running;
    the caching host allocator keeps the pinned block alive until the copy
    has finished."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def prefetch_to_device(
    batches: Iterator,
    size: int = 2,
    place: Optional[Callable] = None,
):
    """Overlap host batch preparation and the host→device copy with device
    compute: a background thread pulls up to ``size`` batches ahead and
    applies ``place`` (default: :func:`to_device` on the CUDA device), and
    the consumer receives device-resident batches.

    The copies are issued on the default stream, which the consumer's
    kernels use too, so a batch is complete before any kernel reads it.
    The worker shuts down promptly when the consumer stops early (the
    generator's ``finally`` signals it and drains the queue), and any
    worker exception re-raises in the consumer.
    """
    import queue as queue_mod
    import threading

    if place is None:
        place = lambda b: to_device(b, "cuda")  # noqa: E731
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, size))
    stop = threading.Event()
    END = object()

    def _put(item) -> bool:
        """Blocking put that aborts when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker():
        try:
            for b in batches:
                if stop.is_set() or not _put((None, place(b))):
                    return
            _put((None, END))
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            _put((e, None))

    t = threading.Thread(target=_worker, name="prefetch_to_device",
                         daemon=True)
    t.start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is END:
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        t.join(timeout=5.0)
