"""The benchmark's reference text frontend: text → phoneme ids.

A frozen copy of the lexicon path of ``iris_tts_tpu_torch/text``
(``frontend.TextProcessor.text_to_ids``, ``lexicon``, ``phonemes``):
normalization (:mod:`.normalize`, copied whole), words split on white
space and cleaned of everything but word characters and apostrophes, each
word's first CMUdict pronunciation with its stress digits stripped, then
the artifact's phoneme vocabulary with ``<UNK>`` for a phoneme it lacks.

The port falls back to a neural and a rule G2P for a word outside the
lexicon; the traffic sends none, so here such a word raises.
"""

from __future__ import annotations

import gzip
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench.reference.normalize import normalize_text

LEXICON = Path(__file__).resolve().parents[1] / "data" / "cmu_dict.txt.gz"

_STRESS_RE = re.compile(r"[0-2]")
_WORD_CLEAN_RE = re.compile(r"[^\w']")
_APOSTROPHE_RE = re.compile(r"'+")
ARPABET = frozenset(
    "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG OW OY "
    "P R S SH T TH UH UW V W Y Z ZH".split())


def strip_stress(phoneme: str) -> str:
    return _STRESS_RE.sub("", phoneme)


def read_lexicon(path: Path = LEXICON) -> Dict[str, List[str]]:
    """CMUdict text → {lowercase word: first pronunciation, stress
    stripped}; alternates (``WORD(2)``), comments and entries with a
    symbol outside ARPABET are skipped, as the port's loader skips them."""
    table: Dict[str, List[str]] = {}
    with gzip.open(path, "rt", encoding="latin-1") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith((";;;", "##")):
                continue
            parts = line.split()
            if len(parts) < 2 or "(" in parts[0]:
                continue
            phones = [strip_stress(p) for p in parts[1:]]
            if all(p in ARPABET for p in phones):
                table.setdefault(parts[0].lower(), phones)
    return table


class Frontend:
    """Text → int32 phoneme ids through a lexicon and a vocabulary
    (phoneme → id, with ``<UNK>``)."""

    def __init__(self, lexicon: Dict[str, List[str]],
                 vocab: Dict[str, int]):
        self.lexicon = lexicon
        self.vocab = vocab
        self.unk = vocab.get("<UNK>", vocab.get("<PAD>", 0))
        self.pad = vocab.get("<PAD>", 0)

    def phonemes(self, text: str) -> List[str]:
        out: List[str] = []
        for token in normalize_text(text).split():
            word = _APOSTROPHE_RE.sub("'", _WORD_CLEAN_RE.sub("", token))
            word = word.strip("'")
            if not word:
                continue
            phones = self.lexicon.get(word)
            if phones is None and "'" in word:
                phones = self.lexicon.get(word.replace("'", ""))
            if phones is None:
                raise ValueError(f"{word!r} is not in the lexicon")
            out.extend(phones)
        return out

    def ids(self, text: str) -> np.ndarray:
        ids = [self.vocab.get(p, self.unk) for p in self.phonemes(text)]
        return np.asarray(ids or [self.unk], np.int64)
