"""Port parity: the port's own copy of the text frontend gives the same
phoneme ids as the JAX package's (both with their defaults, neural G2P on;
``tests/test_torch_g2p.py`` holds the rules-only case), and its
normalizer passes the JAX package's two normalization goldens, read in
place from ``tests/data``."""

from pathlib import Path

import numpy as np
import pytest

from iris_tts_tpu.text.frontend import create_text_processor as jax_frontend
from iris_tts_tpu.text.phonemes import PhonemeVocab as JaxVocab
from iris_tts_tpu_torch.text import PhonemeVocab, create_text_processor

TEXTS = [
    "Hello world, this is a test of the speech system.",
    "",
    "   ",
    "?!...;,",
    "\U0001F600 \U0001F680",
    "Call me at 555-0123 before 10:30 pm.",
    "It cost $12.50, or about £9.99 and 3.5%.",
    "On January 3, 1984 the 21st century was 16 years away.",
    "Dr. Smith lives at 221B Baker St.",
    "Xylophonic zorblax quuxification NASA TPU",
]


@pytest.fixture(scope="module")
def frontends():
    return (jax_frontend(), JaxVocab.default_arpabet(),
            create_text_processor(), PhonemeVocab.default_arpabet())


@pytest.mark.parametrize("text", TEXTS)
def test_text_to_ids_matches_jax(frontends, text):
    jtp, jvocab, tp, vocab = frontends
    want = jtp.text_to_ids(text, jvocab)
    got = tp.text_to_ids(text, vocab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 1  # hostile text yields <UNK>, never nothing


def test_vocab_matches_jax():
    assert (PhonemeVocab.default_arpabet().phoneme_to_id
            == JaxVocab.default_arpabet().phoneme_to_id)


GOLDEN = Path(__file__).parent / "data"


def _golden_cases(name):
    return [line.split(" || ")
            for line in (GOLDEN / name).read_text().splitlines()
            if line and not line.startswith("#")]


def _golden_failures(cases):
    from iris_tts_tpu_torch.text.normalize import normalize_text

    return [(src, want, normalize_text(src)) for src, want in cases
            if normalize_text(src) != want]


def test_normalization_golden_file():
    """The NeMo-class constructs of ``normalize_golden.txt``: times,
    fractions, mixed numbers, ranges, roman numerals, units, degrees,
    currency, percents, ordinals, years and decades, dates,
    abbreviations."""
    cases = _golden_cases("normalize_golden.txt")
    assert len(cases) >= 50
    failures = _golden_failures(cases)
    assert not failures, failures[:5]


def test_normalization_corpus_golden():
    """The corpus-scale golden (``normalize_corpus_golden.txt``, 514
    generated cases in 18 classes; the port's generator reproduces it,
    ``tests/test_torch_diagnostics.py``)."""
    cases = _golden_cases("normalize_corpus_golden.txt")
    assert len(cases) >= 500
    failures = _golden_failures(cases)
    assert not failures, (len(failures), failures[:5])
