"""Rule-based grapheme-to-phoneme fallback for out-of-lexicon words.

The reference uses the g2p_en neural G2P package for OOV words
(reference src/iris/text.py:186-190) with a character fallback. g2p_en
is not available here, so this module implements a deterministic
letter-to-sound rule engine (longest-match contextual rules in the spirit of
the classic NRL ruleset). It is a *fallback* — lexicon entries always win —
so coverage beats elegance; every output symbol is valid ARPABET.
"""

from __future__ import annotations

import re
from typing import List

# Rules are (pattern, phones) tried longest-first at each position, with a
# few context-sensitive special cases handled in code. Patterns are on
# lowercase letters.
_DIGRAPHS = [
    ("tion", ["SH", "AH", "N"]),
    ("sion", ["ZH", "AH", "N"]),
    ("ough", ["AO"]),
    ("augh", ["AE", "F"]),
    ("eigh", ["EY"]),
    ("igh", ["AY"]),
    ("tch", ["CH"]),
    ("dge", ["JH"]),
    ("sch", ["S", "K"]),
    ("ai", ["EY"]),
    ("ay", ["EY"]),
    ("au", ["AO"]),
    ("aw", ["AO"]),
    ("ea", ["IY"]),
    ("ee", ["IY"]),
    ("ei", ["EY"]),
    ("eu", ["UW"]),
    ("ew", ["UW"]),
    ("ey", ["IY"]),
    ("ie", ["IY"]),
    ("oa", ["OW"]),
    ("oe", ["OW"]),
    ("oi", ["OY"]),
    ("oy", ["OY"]),
    ("oo", ["UW"]),
    ("ou", ["AW"]),
    ("ow", ["OW"]),
    ("ue", ["UW"]),
    ("ui", ["UW"]),
    ("ch", ["CH"]),
    ("ck", ["K"]),
    ("gh", ["G"]),
    ("ng", ["NG"]),
    ("ph", ["F"]),
    ("qu", ["K", "W"]),
    ("sh", ["SH"]),
    ("th", ["TH"]),
    ("wh", ["W"]),
    ("wr", ["R"]),
    ("kn", ["N"]),
    ("mb$", ["M"]),
    ("ps", ["S"]),
]

_SINGLE = {
    "a": ["AE"],
    "b": ["B"],
    "c": ["K"],
    "d": ["D"],
    "e": ["EH"],
    "f": ["F"],
    "g": ["G"],
    "h": ["HH"],
    "i": ["IH"],
    "j": ["JH"],
    "k": ["K"],
    "l": ["L"],
    "m": ["M"],
    "n": ["N"],
    "o": ["AA"],
    "p": ["P"],
    "q": ["K"],
    "r": ["R"],
    "s": ["S"],
    "t": ["T"],
    "u": ["AH"],
    "v": ["V"],
    "w": ["W"],
    "x": ["K", "S"],
    "y": ["Y"],
    "z": ["Z"],
}

# Long-vowel variants used for magic-e ("make" → M EY K).
_LONG_VOWEL = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW"}
_VOWELS = set("aeiou")

# Letter names for acronym spelling.
_LETTER_NAMES = {
    "a": ["EY"], "b": ["B", "IY"], "c": ["S", "IY"], "d": ["D", "IY"],
    "e": ["IY"], "f": ["EH", "F"], "g": ["JH", "IY"], "h": ["EY", "CH"],
    "i": ["AY"], "j": ["JH", "EY"], "k": ["K", "EY"], "l": ["EH", "L"],
    "m": ["EH", "M"], "n": ["EH", "N"], "o": ["OW"], "p": ["P", "IY"],
    "q": ["K", "Y", "UW"], "r": ["AA", "R"], "s": ["EH", "S"],
    "t": ["T", "IY"], "u": ["Y", "UW"], "v": ["V", "IY"],
    "w": ["D", "AH", "B", "AH", "L", "Y", "UW"], "x": ["EH", "K", "S"],
    "y": ["W", "AY"], "z": ["Z", "IY"],
}


def spell_out(word: str) -> List[str]:
    """Acronym reading: each letter by name ('tpu' → T IY . P IY . Y UW)."""
    phones: List[str] = []
    for ch in word.lower():
        phones.extend(_LETTER_NAMES.get(ch, []))
    return phones


# Voiced consonant LETTERS for the -s/-ed voicing assimilation rules.
_VOICED_LETTERS = set("bdglmnrvwyz") | _VOWELS

# Common suffixes with fixed pronunciations, applied before the main scan
# (longest first). Each entry: suffix → phones; the stem is re-scanned.
_SUFFIXES = [
    ("ability", ["AH", "B", "IH", "L", "IH", "T", "IY"]),
    ("ology", ["AA", "L", "AH", "JH", "IY"]),
    ("ation", ["EY", "SH", "AH", "N"]),
    ("ically", ["IH", "K", "L", "IY"]),
    ("ment", ["M", "AH", "N", "T"]),
    ("ness", ["N", "AH", "S"]),
    ("able", ["AH", "B", "AH", "L"]),
    ("ible", ["AH", "B", "AH", "L"]),
    ("ture", ["CH", "ER"]),
    ("sure", ["ZH", "ER"]),
    ("tious", ["SH", "AH", "S"]),
    ("cious", ["SH", "AH", "S"]),
    ("ous", ["AH", "S"]),
    ("ful", ["F", "AH", "L"]),
    ("ism", ["IH", "Z", "AH", "M"]),
    ("ist", ["IH", "S", "T"]),
    ("ity", ["IH", "T", "IY"]),
    ("ily", ["AH", "L", "IY"]),
    ("ly", ["L", "IY"]),
]


def _scan(word: str) -> List[str]:
    """The core longest-match scan (no suffix handling)."""

    phones: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        matched = False

        # Doubled consonant → one phone ('little' → single T, 'pass' → S).
        if (
            i + 1 < n
            and word[i] == word[i + 1]
            and word[i] not in _VOWELS
            and word[i] not in "oe"  # oo/ee are digraphs
        ):
            # Consume one of the pair; the survivor is handled by the
            # ordinary rules next iteration (so 'ss' before e/i still
            # softens etc.).
            i += 1
            continue

        # Final magic-e: C V C e$ → long vowel, silent e.
        if (
            i + 2 < n
            and word[i] in _VOWELS
            and word[i + 1] not in _VOWELS
            and i + 3 == n
            and word[i + 2] == "e"
            and word[i + 1] not in "wxy"
        ):
            phones.append(_LONG_VOWEL[word[i]])
            phones.extend(_SINGLE[word[i + 1]])
            i += 3
            continue

        # Silent final e.
        if word[i] == "e" and i + 1 == n and len(phones) >= 2:
            i += 1
            continue

        # Soft c/g before e/i/y: emit the soft consonant but consume ONLY
        # the c/g — the vowel still gets its own phoneme ('cent' → S EH N T,
        # not S N T).
        if word[i] == "c" and i + 1 < n and word[i + 1] in "eiy":
            phones.append("S")
            i += 1
            continue
        if word[i] == "g" and i + 1 < n and word[i + 1] in "eiy":
            phones.append("JH")
            i += 1
            continue

        # Final y is a vowel ('fancy' → ... S IY).
        if word[i] == "y" and i + 1 == n and phones:
            phones.append("IY")
            i += 1
            continue

        # Mid-word y between consonants is the vowel IH ('system').
        if (
            word[i] == "y"
            and 0 < i < n - 1
            and word[i - 1] not in _VOWELS
            and word[i + 1] not in _VOWELS
        ):
            phones.append("IH")
            i += 1
            continue

        # '-le' after a consonant at word end → AH L ('little', 'table').
        if (
            word[i] == "l"
            and i + 2 == n
            and word[i + 1] == "e"
            and i > 0
            and word[i - 1] not in _VOWELS
        ):
            phones.extend(["AH", "L"])
            i += 2
            continue

        # Open-syllable vowel before -tion/-sion/-ture reads long
        # ('nation' → N EY SH AH N).
        if (
            word[i] in _LONG_VOWEL
            and any(
                word.startswith(s, i + 1) for s in ("tion", "sion", "ture")
            )
        ):
            phones.append(_LONG_VOWEL[word[i]])
            i += 1
            continue

        # r-colored vowels: ar/er/ir/or/ur.
        if i + 1 < n and word[i] in _VOWELS and word[i + 1] == "r":
            colored = {
                "a": ["AA", "R"],
                "e": ["ER"],
                "i": ["ER"],
                "o": ["AO", "R"],
                "u": ["ER"],
            }[word[i]]
            phones.extend(colored)
            i += 2
            continue

        for pat, ph in _DIGRAPHS:
            if pat.endswith("$"):
                core = pat[:-1]
                if word.startswith(core, i) and i + len(core) == n:
                    phones.extend(ph)
                    i += len(core)
                    matched = True
                    break
            elif word.startswith(pat, i):
                phones.extend(ph)
                i += len(pat)
                matched = True
                break
        if matched:
            continue

        phones.extend(_SINGLE.get(word[i], []))
        i += 1

    return phones


_VOICELESS_TAILS = {"P", "T", "K", "F", "TH", "S", "SH", "CH"}


def g2p(word: str) -> List[str]:
    """Convert one lowercase word to ARPABET phonemes by rule."""
    word = re.sub(r"[^a-z]", "", word.lower())
    if not word:
        return []

    # Inflectional endings with voicing assimilation (CMUdict conventions):
    # '-ed' after t/d → AH D, after a voiceless tail → T, else D;
    # final '-s' after a voiced tail → Z ('dogs' → ... G Z).
    if len(word) > 3 and word.endswith("ed") and word[-3] not in _VOWELS:
        stem = _scan(word[:-2])
        if not stem:
            return _scan(word)
        if stem[-1] in ("T", "D"):
            return stem + ["AH", "D"]
        if stem[-1] in _VOICELESS_TAILS:
            return stem + ["T"]
        return stem + ["D"]
    if (
        len(word) > 3
        and word.endswith("s")
        and not word.endswith("ss")
        and word[-2] in _VOICED_LETTERS
    ):
        stem = _scan(word[:-1])
        if stem:
            if stem[-1] in ("S", "Z", "SH", "ZH", "CH", "JH"):
                return stem + ["IH", "Z"]  # 'churches', 'roses'
            if stem[-1] in _VOICELESS_TAILS:
                return stem + ["S"]
            return stem + ["Z"]
        return _scan(word)

    # Derivational suffixes with fixed readings (longest first). A stem
    # left with a final open-syllable vowel reads long ('na|ture' → N EY).
    for suf, ph in _SUFFIXES:
        if word.endswith(suf) and len(word) >= len(suf) + 2:
            stem_letters = word[: -len(suf)]
            stem = _scan(stem_letters)
            last = stem_letters[-1]
            if (
                stem
                and last in _LONG_VOWEL
                and stem[-1] == _SINGLE[last][0]
            ):
                stem[-1] = _LONG_VOWEL[last]
            return stem + ph

    return _scan(word)
