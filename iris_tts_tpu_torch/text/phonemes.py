"""Phoneme vocabularies (ID mappings) with save/load.

The reference has two coexisting vocab schemes (SURVEY.md §2.5):

* the frontend scheme: ``<PAD> <SOS> <EOS> <UNK>`` + sorted phonemes
  (reference src/iris/text.py:250-288), and
* the training scheme: ``<PAD> <UNK>`` + sorted MFA phone labels, persisted
  as ``phoneme_vocab.npy`` (reference src/iris/datasets.py:245-285).

Both are instances of :class:`PhonemeVocab` here; the training scheme is the
default because it's what all checkpoints and the synthesis entry use
(scripts/synthesize.py:30-38 maps frontend phonemes through it with ``<UNK>``
fallback). Persistence is JSON, not numpy pickle.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import numpy as np

from iris_tts_tpu_torch.text.lexicon import ARPABET

PAD = "<PAD>"
SOS = "<SOS>"
EOS = "<EOS>"
UNK = "<UNK>"


class PhonemeVocab:
    """Bidirectional phoneme ↔ ID mapping."""

    def __init__(self, phoneme_to_id: Dict[str, int]):
        self.phoneme_to_id = dict(phoneme_to_id)
        self.id_to_phoneme = {i: p for p, i in self.phoneme_to_id.items()}
        self.pad_id = self.phoneme_to_id.get(PAD, 0)
        self.unk_id = self.phoneme_to_id.get(UNK, self.pad_id)

    # -- constructors -------------------------------------------------------

    @classmethod
    def build(
        cls,
        phonemes: Iterable[str],
        special_tokens: Sequence[str] = (PAD, UNK),
    ) -> "PhonemeVocab":
        """Specials first (in order), then sorted unique phonemes — matches
        the reference's training-vocab construction (datasets.py:259-274)."""
        table: Dict[str, int] = {}
        for tok in special_tokens:
            table[tok] = len(table)
        for p in sorted(set(phonemes) - set(special_tokens)):
            table[p] = len(table)
        return cls(table)

    @classmethod
    def default_arpabet(cls) -> "PhonemeVocab":
        """Stress-stripped ARPABET + ``<PAD> <UNK>`` — a 41-symbol vocab that
        covers the CMUdict/G2P frontend output."""
        return cls.build(ARPABET)

    @classmethod
    def frontend_scheme(cls, phonemes: Iterable[str]) -> "PhonemeVocab":
        """4-special-token scheme of the reference frontend
        (text.py:272-284)."""
        return cls.build(phonemes, special_tokens=(PAD, SOS, EOS, UNK))

    # -- encoding ------------------------------------------------------------

    def encode(self, phonemes: Sequence[str]) -> np.ndarray:
        """Phoneme strings → int32 IDs with ``<UNK>`` fallback (matches
        scripts/synthesize.py:30-38). Empty input yields a single UNK."""
        ids = [self.phoneme_to_id.get(p, self.unk_id) for p in phonemes]
        if not ids:
            ids = [self.unk_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.id_to_phoneme.get(int(i), UNK) for i in ids]

    def __len__(self) -> int:
        return len(self.phoneme_to_id)

    def __contains__(self, phoneme: str) -> bool:
        return phoneme in self.phoneme_to_id

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.phoneme_to_id, indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "PhonemeVocab":
        path = Path(path)
        if path.suffix == ".npy":
            # Compatibility with the reference's numpy-pickle vocab
            # (datasets.py:278-285, scripts/synthesize.py:25-27).
            data = np.load(path, allow_pickle=True).item()
            return cls(data["phoneme_to_id"])
        return cls(json.loads(path.read_text()))
