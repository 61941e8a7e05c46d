"""Text → phoneme-ID frontend (host-side, feeding the synthesis batches).

A copy of the JAX package's ``text/frontend.py``, with the same G2P ladder
and the same default: the neural G2P is on whenever its checkpoint exists.

Public API parity with the reference (BASELINE.json north star):
``create_text_processor()`` and ``TextProcessor.normalize_text /
text_to_phonemes / word_to_phonemes / text_to_sequence /
create_phoneme_mapping`` mirror reference src/iris/text.py:28-307.

The implementation stack is: rule normalization (:mod:`normalize`) →
lexicon lookup with first-pronunciation + stress stripping (:mod:`lexicon`)
→ neural G2P (:mod:`neural_g2p`, a transformer trained on the shipped
CMUdict) → rule-based G2P fallback (:mod:`g2p`) → character spell-out last
resort — the same fallback
ladder as the reference (text.py:164-194), with pure-Python/first-party
replacements for the pynini/nltk/g2p_en native dependencies (SURVEY.md §2.3).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from iris_tts_tpu_torch.text.g2p import g2p, spell_out
from iris_tts_tpu_torch.text.lexicon import Lexicon, strip_stress
from iris_tts_tpu_torch.text.neural_g2p import NeuralG2P
from iris_tts_tpu_torch.text.normalize import normalize_text as _normalize
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

logger = logging.getLogger(__name__)

_WORD_CLEAN_RE = re.compile(r"[^\w']")
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?;])\s+")
_APOSTROPHE_RE = re.compile(r"'+")


class TextProcessor:
    """Text → ARPABET phonemes → IDs.

    Mirrors the reference ``TextProcessor`` contract (text.py:28-288) with a
    deterministic, dependency-free implementation.
    """

    def __init__(
        self,
        lexicon: Optional[Lexicon] = None,
        use_g2p: bool = True,
        spell_acronyms: bool = True,
        neural_g2p=None,
    ):
        self.lexicon = lexicon or Lexicon()
        self.use_g2p = use_g2p
        self.spell_acronyms = spell_acronyms
        # Lazy: constructing NeuralG2P loads nothing; the first OOV word
        # pays the one-time checkpoint load (and rules still back it up if
        # that fails). Pass neural_g2p=False to force rules only.
        if neural_g2p is None or neural_g2p is True:
            self.neural_g2p = NeuralG2P() if NeuralG2P.available() else None
        elif neural_g2p is False:
            self.neural_g2p = None
        else:
            self.neural_g2p = neural_g2p

    # -- normalization -------------------------------------------------------

    def normalize_text(self, text: str) -> str:
        """Lowercased, number-expanded, whitespace-collapsed text
        (reference: text.py:94-130)."""
        return _normalize(text)

    # -- word level ----------------------------------------------------------

    def word_to_phonemes(self, word: str) -> List[str]:
        """Lexicon first (first pronunciation, stress stripped), then G2P,
        then character spell-out (reference ladder: text.py:164-194)."""
        word_clean = _APOSTROPHE_RE.sub("'", word.lower()).strip("'")
        if not word_clean:
            return []
        phones = self.lexicon.lookup(word_clean)
        if phones is None and "'" in word_clean:
            phones = self.lexicon.lookup(word_clean.replace("'", ""))
        if phones is not None:
            return [strip_stress(p) for p in phones]
        bare = word_clean.replace("'", "")
        if self.use_g2p:
            if self.neural_g2p is not None:
                out = self.neural_g2p(bare)
                if out:
                    return out
            out = g2p(bare)
            if out:
                return out
        if self.spell_acronyms:
            return spell_out(bare)
        return list(bare)

    # -- sentence level ------------------------------------------------------

    def _prefetch_oov(self, words: List[str]) -> None:
        """Batch all out-of-lexicon words of a sentence into one neural-G2P
        decode (its per-word results are memoized, so the per-word ladder
        that follows hits the cache)."""
        if not (self.use_g2p and self.neural_g2p is not None):
            return
        oov = []
        seen = set()
        for word in words:
            w = _APOSTROPHE_RE.sub("'", word.lower()).strip("'")
            if not w or w in seen:
                continue
            seen.add(w)
            if self.lexicon.lookup(w) is None and (
                "'" not in w or self.lexicon.lookup(w.replace("'", "")) is None
            ):
                oov.append(w.replace("'", ""))
        if oov:
            self.neural_g2p.predict_batch(oov)

    def text_to_phonemes(self, text: str, separator: str = " ") -> str:
        """Full sentence → space-joined phoneme string
        (reference: text.py:132-162)."""
        norm = self.normalize_text(text)
        words = [
            w for w in (_WORD_CLEAN_RE.sub("", t) for t in norm.split()) if w
        ]
        self._prefetch_oov(words)
        phonemes: List[str] = []
        for word_clean in words:
            phonemes.extend(self.word_to_phonemes(word_clean))
        return separator.join(phonemes)

    def split_sentences(self, text: str) -> List[str]:
        """Normalize, then split into sentence segments on terminal
        punctuation (. ! ? ;).

        Normalization first means abbreviation periods ("Dr.", "St.") are
        already expanded and never split on. New functionality beyond the
        reference (whose entry point handles one utterance,
        scripts/synthesize.py:64-220); used by
        ``TTSPipeline.synthesize_long`` to keep long-form text inside the
        phoneme bucket ladder instead of truncating.
        """
        norm = self.normalize_text(text)
        parts = _SENTENCE_SPLIT_RE.split(norm)
        return [p.strip() for p in parts if p.strip()]

    def text_to_sequence(
        self, text: str, phoneme_to_id: Optional[Dict[str, int]] = None
    ):
        """Text → phoneme-ID list (reference: text.py:200-229). Returns the
        phoneme strings if no mapping is given."""
        phonemes = self.text_to_phonemes(text).split()
        if phoneme_to_id is None:
            return phonemes
        unk = phoneme_to_id.get("<UNK>")
        seq = []
        for p in phonemes:
            if p in phoneme_to_id:
                seq.append(phoneme_to_id[p])
            elif unk is not None:
                seq.append(unk)
        return seq

    def text_to_ids(self, text: str, vocab: PhonemeVocab) -> np.ndarray:
        """Text → int32 ID array with ``<UNK>`` fallback (reference:
        scripts/synthesize.py:30-38)."""
        return vocab.encode(self.text_to_phonemes(text).split())

    # -- vocab helpers (reference: text.py:231-288) --------------------------

    def get_phoneme_set(self, texts: Sequence[str]) -> Set[str]:
        out: Set[str] = set()
        for t in texts:
            out.update(self.text_to_phonemes(t).split())
        return out

    def create_phoneme_mapping(
        self, texts: Sequence[str], add_special_tokens: bool = True
    ) -> Tuple[Dict[str, int], Dict[int, str]]:
        phonemes = self.get_phoneme_set(texts)
        specials = (
            ("<PAD>", "<SOS>", "<EOS>", "<UNK>") if add_special_tokens else ()
        )
        vocab = PhonemeVocab.build(phonemes, special_tokens=specials)
        return vocab.phoneme_to_id, vocab.id_to_phoneme


def create_text_processor(
    use_g2p: bool = True,
    use_nemo: bool = True,  # accepted for API parity; rule engine is built in
    lang: str = "en",
    lexicon_path: Optional[str | Path] = None,
    neural_g2p=None,
) -> TextProcessor:
    """Factory matching the reference signature (text.py:291-307).

    ``use_nemo`` is accepted for compatibility; normalization is always the
    deterministic built-in rule engine. ``lexicon_path`` may point at any
    CMUdict-format file to extend the built-in core lexicon. ``neural_g2p``:
    None/True = use the shipped transformer checkpoint when present, False =
    rule G2P only, or a ready NeuralG2P instance.
    """
    del use_nemo, lang
    lexicon = None
    if lexicon_path is not None and Path(lexicon_path).exists():
        lexicon = Lexicon.from_cmudict_file(lexicon_path)
        logger.info("Loaded lexicon with %d entries", len(lexicon))
    return TextProcessor(
        lexicon=lexicon, use_g2p=use_g2p, neural_g2p=neural_g2p
    )


def chunk_text_by_phonemes(
    processor: TextProcessor,
    vocab: PhonemeVocab,
    text: str,
    max_phonemes: int,
) -> List[str]:
    """Sentence-pack ``text`` into chunks of <= ``max_phonemes`` ids.

    Sentences are packed greedily; a single sentence that alone exceeds the
    cap is split at word boundaries (each word's phoneme count measured
    through the same frontend the synthesizer uses, so the packing is
    exact, not estimated). Shared by TTSPipeline.synthesize_long and the
    AOT serving adapter (serve/export.py) — one chunking policy everywhere.
    """

    def n_ids(t: str) -> int:
        return len(processor.text_to_ids(t, vocab))

    pieces = []  # (text, id_count)
    for sent in processor.split_sentences(text):
        n = n_ids(sent)
        if n <= max_phonemes:
            pieces.append((sent, n))
            continue

        def split_token(tok: str) -> List:
            """Recursively halve a token until every part fits the cap
            (pronunciation of the parts goes through G2P, so this is a
            lossy last resort for pathological run-on tokens)."""
            tn = n_ids(tok)
            if tn <= max_phonemes or len(tok) <= 1:
                return [(tok, tn)]
            half = len(tok) // 2
            return split_token(tok[:half]) + split_token(tok[half:])

        cur, cur_n = [], 0
        for w in sent.split():
            wn = n_ids(w)
            parts = (
                [(w, wn)] if wn <= max_phonemes else split_token(w)
            )
            if len(parts) > 1:
                logger.warning(
                    "token %r alone exceeds max_phonemes=%d; splitting "
                    "mid-word", w[:40], max_phonemes,
                )
            for part, wn in parts:
                if cur and cur_n + wn > max_phonemes:
                    pieces.append((" ".join(cur), cur_n))
                    cur, cur_n = [], 0
                cur.append(part)
                cur_n += wn
        if cur:
            pieces.append((" ".join(cur), cur_n))

    chunks, cur, cur_n = [], [], 0
    for sent, n in pieces:
        if cur and cur_n + n > max_phonemes:
            chunks.append(" ".join(cur))
            cur, cur_n = [], 0
        cur.append(sent)
        cur_n += n
    if cur:
        chunks.append(" ".join(cur))
    return chunks
