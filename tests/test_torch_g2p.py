"""Port parity: the port's neural G2P and its default text frontend.

The JAX frontend turns the shipped transformer G2P on by default; so does
the port's. Out-of-lexicon words must get the same phoneme ids in both
packages' default pipelines, and ``neural_g2p=False`` must force rules only
in both.
"""

from pathlib import Path

import numpy as np
import pytest

from iris_tts_tpu.text.frontend import create_text_processor as jax_frontend
from iris_tts_tpu.text.neural_g2p import NeuralG2P as JaxNeuralG2P
from iris_tts_tpu.text.neural_g2p import load_g2p as jax_load_g2p
from iris_tts_tpu.text.phonemes import PhonemeVocab as JaxVocab
from iris_tts_tpu_torch.text import PhonemeVocab, create_text_processor
from iris_tts_tpu_torch.text.neural_g2p import (
    DEFAULT_CHECKPOINT,
    NeuralG2P,
    encode_word,
    load_g2p,
)

GOLDEN = Path(__file__).parent / "data" / "g2p_oov_golden.txt"


def _golden_words():
    words = []
    for line in GOLDEN.read_text().splitlines():
        if line and not line.startswith("#"):
            words.append(line.split(" || ")[0])
    return words


WORDS = _golden_words()
SENTENCES = [
    f"The {WORDS[0]} met a {WORDS[1]} near the {WORDS[2]}.",
    f"{WORDS[3].capitalize()}, {WORDS[4]} and {WORDS[5]} cost $12.50!",
    " ".join(WORDS[6:16]),
    f"Is {WORDS[-1]} a word? I said {WORDS[-2]} twice: {WORDS[-2]}.",
]


@pytest.fixture(scope="module")
def defaults():
    return (jax_frontend(), JaxVocab.default_arpabet(),
            create_text_processor(), PhonemeVocab.default_arpabet())


def test_checkpoint_is_the_jax_packages():
    from iris_tts_tpu.text.neural_g2p import DEFAULT_CHECKPOINT as JAX_CKPT

    assert DEFAULT_CHECKPOINT.read_bytes() == JAX_CKPT.read_bytes()


def test_default_frontend_uses_neural_g2p(defaults):
    jtp, _, tp, _ = defaults
    assert isinstance(jtp.neural_g2p, JaxNeuralG2P)
    assert isinstance(tp.neural_g2p, NeuralG2P)
    assert create_text_processor(neural_g2p=False).neural_g2p is None


def test_golden_oov_words_match_jax_default(defaults):
    """Every golden OOV word, one at a time: the port's default ids equal
    JAX's default ids (rules-only would differ on most of them)."""
    jtp, jvocab, tp, vocab = defaults
    assert len(WORDS) >= 50
    for word in WORDS:
        np.testing.assert_array_equal(tp.text_to_ids(word, vocab),
                                      jtp.text_to_ids(word, jvocab),
                                      err_msg=word)


@pytest.mark.parametrize("text", SENTENCES)
def test_sentences_with_oov_words_match_jax_default(defaults, text):
    jtp, jvocab, tp, vocab = defaults
    want = jtp.text_to_ids(text, jvocab)
    got = tp.text_to_ids(text, vocab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rules_only_matches_jax_rules_only():
    """``neural_g2p=False`` forces rules in both packages, and rules give
    other phonemes than the model on OOV words."""
    jtp = jax_frontend(neural_g2p=False)
    tp = create_text_processor(neural_g2p=False)
    vocab = PhonemeVocab.default_arpabet()
    for text in SENTENCES:
        np.testing.assert_array_equal(
            tp.text_to_ids(text, vocab),
            jtp.text_to_ids(text, JaxVocab.default_arpabet()))
    neural = create_text_processor()
    assert any(tp.word_to_phonemes(w) != neural.word_to_phonemes(w)
               for w in WORDS)


def test_predict_batch_matches_jax():
    words = WORDS + ["", "x" * 40, "naïve", "o'brien"]
    got = NeuralG2P().predict_batch(words)
    want = JaxNeuralG2P().predict_batch(words)
    assert got == want
    assert got[-3] == [] and got[-4] == []  # over-long / unknown character


def test_load_g2p_matches_jax():
    params, cfg, meta = load_g2p(DEFAULT_CHECKPOINT)
    jparams, jcfg, jmeta = jax_load_g2p(DEFAULT_CHECKPOINT)
    import jax

    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert vars(cfg) == vars(jcfg)
    assert meta == jmeta


def test_encode_word_matches_jax():
    from iris_tts_tpu.models.g2p import encode_word as jax_encode_word

    for w in WORDS + ["", "a" * 33, "don't", "x1"]:
        assert encode_word(w, 32) == jax_encode_word(w, 32)
