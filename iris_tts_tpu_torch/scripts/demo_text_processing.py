"""Text frontend demo: normalization, G2P, vocabulary building.

The port's counterpart of the JAX package's root
``demo_text_processing.py``, on the port's own frontend (rule normalizer,
lexicon, neural G2P for out-of-lexicon words): the same five sentences and
four sections, printed line for line as JAX prints them.

Usage:
    python -m iris_tts_tpu_torch.scripts.demo_text_processing \
        [--text "Dr. Who saw 3 cats."] [--lexicon_path cmu_dict.txt]
"""

from __future__ import annotations

import argparse

from iris_tts_tpu_torch.text import PhonemeVocab, create_text_processor

DEMO_SENTENCES = [
    "Hello world, this is a test.",
    "Dr. Smith paid $12.50 on January 3, 1984.",
    "The meeting is at 10:30 and covers 25% of the agenda.",
    "Mr. Jones bought 1,234 apples for his co. in 2007.",
    "She said: “It's the 3rd time!”",
]
OOV_WORDS = ["zorblax", "brillig", "slithy", "cromulent"]


def main(argv=None) -> dict:
    """Prints the four sections and returns what they print: the
    normalized texts, the phoneme strings, the OOV pronunciations, the
    mapping size and the first sentence's ids."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--lexicon_path", type=str, default=None)
    parser.add_argument("--text", type=str, default=None)
    args = parser.parse_args(argv)

    tp = create_text_processor(lexicon_path=args.lexicon_path)
    sentences = [args.text] if args.text else DEMO_SENTENCES
    out = {"normalized": [], "phonemes": [], "oov": {}}

    print("=" * 70)
    print("1. Text normalization")
    print("=" * 70)
    for s in sentences:
        out["normalized"].append(tp.normalize_text(s))
        print(f"  in : {s}")
        print(f"  out: {out['normalized'][-1]}\n")

    print("=" * 70)
    print("2. Grapheme-to-phoneme")
    print("=" * 70)
    for s in sentences:
        out["phonemes"].append(tp.text_to_phonemes(s))
        print(f"  {s}")
        print(f"  → {out['phonemes'][-1]}\n")

    print("=" * 70)
    print("3. OOV fallback (rule G2P)")
    print("=" * 70)
    for word in OOV_WORDS:
        out["oov"][word] = " ".join(tp.word_to_phonemes(word))
        print(f"  {word} → {out['oov'][word]}")

    print()
    print("=" * 70)
    print("4. Vocabulary")
    print("=" * 70)
    p2i, i2p = tp.create_phoneme_mapping(sentences)
    out["mapping_size"] = len(p2i)
    print(f"  mapping size: {len(p2i)} (specials: "
          f"{[i2p[i] for i in range(4)]})")
    vocab = PhonemeVocab.default_arpabet()
    ids = tp.text_to_ids(sentences[0], vocab)
    out["ids"] = [int(i) for i in ids]
    print(f"  '{sentences[0]}' → {list(ids)}")
    return out


if __name__ == "__main__":
    main()
