"""Bulk jobs of LJSpeech-shaped English sentences, drawn from a seed.

A job is ``utterances_per_job`` sentences, and every job of every seed
asks for the same sizes in another order: the sentences' word counts are
spread evenly over ``words_per_utterance`` (both ends included), and each
word slot's phoneme count is drawn once, from a stream that no seed
changes, as the lexicon's purely alphabetic entries of at most
``max_phonemes_per_word`` phonemes weigh it. A job takes these sentence
shapes in an order drawn from the seed and fills each slot with a word
drawn uniformly from the entries of its phoneme count; a comma follows
every ``comma_every_words``-th word and a period ends the sentence, whose
first letter is upper case. So jobs differ in their words, and in their
frame counts only as far as the model's durations differ. A sentence whose
normalization is not just lower-casing (a final word that reads as an
abbreviation before the period, such as "co.") draws its last word again,
so every word the frontend sees is in the lexicon and the neural G2P never
loads. Every job's sentences are new.

Parameters (the traffic file): ``utterances_per_job``,
``words_per_utterance`` [lo, hi], ``max_phonemes_per_word``,
``comma_every_words``. A file fits them to a corpus's published clip
lengths and words a clip, and says so under ``fitted_to``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.reference.frontend import read_lexicon
from perfbench.reference.normalize import normalize_text

SIZES_SEED = 0  # the stream the sentence shapes are drawn from, once


class Generator:
    def __init__(self, params: Dict, seed: int,
                 lexicon: Dict[str, List[str]] = None):
        lexicon = lexicon if lexicon is not None else read_lexicon()
        cap = int(params["max_phonemes_per_word"])
        by_len: Dict[int, List[str]] = {}
        for w, ph in lexicon.items():
            if w.isascii() and w.isalpha() and len(ph) <= cap:
                by_len.setdefault(len(ph), []).append(w)
        self.words = {k: np.array(sorted(v)) for k, v in by_len.items()}
        self.n = int(params["utterances_per_job"])
        lo, hi = params["words_per_utterance"]
        span = hi - lo + 1
        lengths = np.array(sorted(self.words))
        weight = np.array([len(self.words[k]) for k in lengths], float)
        sizes = np.random.default_rng(SIZES_SEED)
        self.shapes = [sizes.choice(lengths, lo + i * span // self.n,
                                    p=weight / weight.sum())
                       for i in range(self.n)]
        self.comma = int(params["comma_every_words"])
        self.rng = np.random.default_rng(int(seed) % 2**64)

    def _word(self, phonemes: int) -> str:
        pool = self.words[int(phonemes)]
        return str(pool[self.rng.integers(len(pool))])

    def _sentence(self, words: List[str]) -> str:
        parts = [w + ("," if (i + 1) % self.comma == 0 and i + 1 < len(words)
                      else "") for i, w in enumerate(words)]
        text = " ".join(parts) + "."
        return text[0].upper() + text[1:]

    def job(self) -> List[str]:
        """The next job's sentences."""
        shapes = [self.shapes[i] for i in self.rng.permutation(self.n)]
        sentences = [[self._word(k) for k in shape] for shape in shapes]
        texts = [self._sentence(s) for s in sentences]
        joined = " ".join(texts)
        if normalize_text(joined) != joined.lower():  # find the sentence
            for words, shape, i in zip(sentences, shapes, range(len(texts))):
                while normalize_text(texts[i]) != texts[i].lower():
                    words[-1] = self._word(shape[-1])
                    texts[i] = self._sentence(words)
        return texts
