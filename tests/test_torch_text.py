"""Port parity: the port's own copy of the text frontend gives the same
phoneme ids as the JAX package's (both with their defaults, neural G2P on;
``tests/test_torch_g2p.py`` holds the rules-only case)."""

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
