"""LJSpeech dataset layer: metadata, MFA durations, cached features, splits.

The port's own copy of the JAX package's ``data/ljspeech.py``. Mel features
are computed once into an on-disk cache through the port's
:func:`~iris_tts_tpu_torch.ops.stft.log_mel_spectrogram`, so on the card the
cache is built by the hand-written log-mel kernel (one launch per clip).

Conventions preserved exactly (reference datasets.py):

* vocab = ``<PAD> <UNK>`` + sorted MFA phones, built on the train split and
  persisted (datasets.py:245-285),
* duration frames = ``max(1, round(sec * sr / hop))`` (datasets.py:363-367),
* mel trimmed to ``sum(durations)`` frames because MFA alignments exclude
  trailing silence (datasets.py:621-624),
* split = sorted ids, first 5% validation (datasets.py:234-241),
* length filters ``max_phoneme_length`` / ``max_frames``
  (datasets.py:303-312,525-536).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.data.audio_io import load_audio
from iris_tts_tpu_torch.data.textgrid import (
    durations_to_frames,
    load_alignment_cache,
    load_alignments,
    save_alignment_cache,
)
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.runtime import DeviceLike, resolve_device
from iris_tts_tpu_torch.text.lexicon import strip_stress
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

logger = logging.getLogger(__name__)

def read_metadata(root: str | Path) -> Dict[str, str]:
    """metadata.csv → {file_id: normalized_text} (column 3, the convention
    of alignment.py:177-208)."""
    out: Dict[str, str] = {}
    meta = Path(root) / "metadata.csv"
    for line in meta.read_text(encoding="utf-8").splitlines():
        parts = line.split("|")
        if len(parts) >= 3:
            out[parts[0]] = parts[2].strip()
        elif len(parts) == 2:
            out[parts[0]] = parts[1].strip()
    return out


@dataclass
class Sample:
    file_id: str
    text: str
    phoneme_ids: np.ndarray  # [P] int32
    durations: np.ndarray  # [P] float32 (frames)
    mel: Optional[np.ndarray] = None  # [T, n_mels] float32 (time-major)

    @property
    def num_phonemes(self) -> int:
        return len(self.phoneme_ids)

    @property
    def num_frames(self) -> int:
        return int(self.durations.sum())


def train_val_split(ids: Sequence[str], val_fraction: float = 0.05):
    """Sorted ids; first ``val_fraction`` = validation
    (reference: datasets.py:234-241)."""
    ids = sorted(ids)
    n_val = int(len(ids) * val_fraction)
    return ids[n_val:], ids[:n_val]


class LJSpeechDurationDataset:
    """Phoneme-IDs + MFA frame durations per utterance
    (reference: datasets.py:177-404)."""

    def __init__(
        self,
        root: str | Path,
        alignment_dir: str | Path,
        split: str = "train",
        cache_dir: Optional[str | Path] = None,
        audio: AudioConfig = AudioConfig(),
        max_phoneme_length: Optional[int] = None,
        max_frames: Optional[int] = None,
        val_fraction: float = 0.05,
    ):
        self.root = Path(root)
        self.audio = audio
        self.cache_dir = Path(cache_dir) if cache_dir else None

        self.metadata = read_metadata(self.root) if (
            self.root / "metadata.csv"
        ).exists() else {}

        # Alignments: parse TextGrids once, cache as npz.
        align_cache = (
            self.cache_dir / "alignments.npz" if self.cache_dir else None
        )
        if align_cache and align_cache.exists():
            self.alignments = load_alignment_cache(align_cache)
        else:
            self.alignments = load_alignments(alignment_dir)
            if align_cache and self.alignments:
                self.cache_dir.mkdir(parents=True, exist_ok=True)
                save_alignment_cache(self.alignments, align_cache)

        ids = [k for k, v in self.alignments.items() if v]
        train_ids, val_ids = train_val_split(ids, val_fraction)
        self.sample_ids = train_ids if split == "train" else val_ids

        # Vocab: built on train, loaded otherwise (datasets.py:245-300).
        # MFA's english_us_arpa phone labels carry stress digits (AH0, EY1,
        # ...) while the synthesis frontend emits stress-stripped ARPABET
        # (text.py:196-198 convention) — the reference keeps the raw labels,
        # so at synthesis every vowel maps to <UNK> (a latent reference
        # defect, SURVEY.md §2.5). We strip stress on BOTH sides so the
        # training vocab and the frontend agree.
        vocab_file = (
            self.cache_dir / "phoneme_vocab.json" if self.cache_dir else None
        )
        if split == "train":
            phones = {
                strip_stress(p["phone"])
                for sid in self.sample_ids
                for p in self.alignments[sid]
            }
            self.vocab = PhonemeVocab.build(phones)
            if vocab_file:
                self.cache_dir.mkdir(parents=True, exist_ok=True)
                self.vocab.save(vocab_file)
        else:
            if vocab_file and vocab_file.exists():
                self.vocab = PhonemeVocab.load(vocab_file)
            else:
                raise FileNotFoundError(
                    "validation split needs the train-split vocab; build the "
                    "train split first (or pass the same cache_dir)"
                )

        # Length filters (datasets.py:303-312, 525-536).
        if max_phoneme_length or max_frames:
            keep = []
            for sid in self.sample_ids:
                ph = self.alignments[sid]
                if max_phoneme_length and len(ph) > max_phoneme_length:
                    continue
                if max_frames:
                    frames = durations_to_frames(
                        ph, audio.sample_rate, audio.hop_length
                    ).sum()
                    if frames > max_frames:
                        continue
                keep.append(sid)
            self.sample_ids = keep

    def __len__(self) -> int:
        return len(self.sample_ids)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def __getitem__(self, idx: int) -> Sample:
        sid = self.sample_ids[idx]
        phones = self.alignments[sid]
        frames = durations_to_frames(
            phones, self.audio.sample_rate, self.audio.hop_length
        )
        ids = self.vocab.encode(
            [strip_stress(p["phone"]) for p in phones]
        )
        return Sample(
            file_id=sid,
            text=self.metadata.get(sid, ""),
            phoneme_ids=ids,
            durations=frames.astype(np.float32),
        )

    def __iter__(self) -> Iterator[Sample]:
        for i in range(len(self)):
            yield self[i]


class LJSpeechVAEDataset(LJSpeechDurationDataset):
    """Adds cached log-mel features, trimmed to the aligned duration sum
    (reference: datasets.py:407-644)."""

    def __init__(self, *args, mel_cache_dir: Optional[str | Path] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__(*args, **kwargs)
        # Where the mel features are computed: the CUDA device (the log-mel
        # kernel) unless the caller asks for the CPU (the plain version).
        self.device = resolve_device(device)
        self.mel_cache_dir = Path(
            mel_cache_dir
            or (self.cache_dir / "mels" if self.cache_dir else "mel_cache")
        )

    def _mel_path(self, sid: str) -> Path:
        return self.mel_cache_dir / f"{sid}.npy"

    def _compute_mel(self, sid: str) -> np.ndarray:
        """Log-mel of one clip on ``self.device``.

        The audio is zero-padded up to a 64-hop sample bucket and the result
        sliced back to the true frame count, as the JAX package does (there
        it keeps the number of compiled shapes small). Zero tail padding is
        exact: the centring pad is already constant-zero, so the first
        ``1 + n//hop`` frames are those of the unpadded clip."""
        wav_path = self.root / "wavs" / f"{sid}.wav"
        audio = load_audio(wav_path, self.audio.sample_rate)
        hop = self.audio.hop_length
        true_frames = 1 + len(audio) // hop
        bucket = 64 * hop  # ~0.74 s granularity → a handful of shapes
        padded = -(-len(audio) // bucket) * bucket
        if padded != len(audio):
            audio = np.pad(audio, (0, padded - len(audio)))
        mel = log_mel_spectrogram(
            torch.from_numpy(audio).to(self.device), self.audio)
        return mel[:true_frames].cpu().numpy()  # [T, n_mels]

    def precompute_mels(self, overwrite: bool = False) -> int:
        """Fill the mel cache for the whole split; returns count computed."""
        self.mel_cache_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for sid in self.sample_ids:
            p = self._mel_path(sid)
            if p.exists() and not overwrite:
                continue
            np.save(p, self._compute_mel(sid))
            n += 1
        return n

    def __getitem__(self, idx: int) -> Sample:
        sample = super().__getitem__(idx)
        sid = sample.file_id
        p = self._mel_path(sid)
        if p.exists():
            mel = np.load(p)
        else:
            mel = self._compute_mel(sid)
            self.mel_cache_dir.mkdir(parents=True, exist_ok=True)
            np.save(p, mel)
        # Trim to aligned frames (MFA excludes trailing silence;
        # datasets.py:621-624). Clamp durations if audio is shorter —
        # walking backwards over phonemes so the invariant
        # sum(durations) <= mel frames always holds.
        total = int(sample.durations.sum())
        if total > mel.shape[0]:
            overflow = total - mel.shape[0]
            d = sample.durations.copy()
            j = len(d) - 1
            while overflow > 0 and j >= 0:
                take = min(overflow, d[j] - 1.0)
                if take > 0:
                    d[j] -= take
                    overflow -= int(take)
                j -= 1
            sample.durations = d
            total = int(d.sum())
        sample.mel = mel[:total]
        return sample
