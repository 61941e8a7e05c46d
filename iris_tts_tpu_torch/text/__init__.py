"""Host-side text frontend: normalization, lexicon, rule G2P, vocabularies."""

from iris_tts_tpu_torch.text.frontend import TextProcessor, create_text_processor
from iris_tts_tpu_torch.text.g2p import g2p, spell_out
from iris_tts_tpu_torch.text.lexicon import ARPABET, Lexicon, strip_stress
from iris_tts_tpu_torch.text.normalize import collapse_whitespace, normalize_text
from iris_tts_tpu_torch.text.numbers import (
    expand_numbers,
    number_to_words,
    ordinal_to_words,
    year_to_words,
)
from iris_tts_tpu_torch.text.phonemes import EOS, PAD, SOS, UNK, PhonemeVocab

__all__ = [
    "TextProcessor",
    "create_text_processor",
    "g2p",
    "spell_out",
    "ARPABET",
    "Lexicon",
    "strip_stress",
    "collapse_whitespace",
    "normalize_text",
    "expand_numbers",
    "number_to_words",
    "ordinal_to_words",
    "year_to_words",
    "PhonemeVocab",
    "PAD",
    "SOS",
    "EOS",
    "UNK",
]
