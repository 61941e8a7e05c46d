"""Frozen copy of ``iris_tts_tpu_torch/text/normalize.py`` for the benchmark's reference (imports
adjusted; nothing of the port is imported).

English text normalization (host-side frontend stage).

Replaces the reference's NeMo/pynini WFST normalizer + lowercase fallback
(reference src/iris/text.py:94-130) with a deterministic rule engine:
abbreviation expansion, number/currency/date verbalisation
(:mod:`perfbench.reference.numbers`), unicode cleanup, and whitespace collapse.
The output feeds the lexicon/G2P stage.
"""

from __future__ import annotations

import re
import unicodedata

from perfbench.reference.numbers import expand_numbers

# Title/unit abbreviations, matched case-sensitively with trailing period
# where customary. Expanded before lowercasing so "Dr." vs "dr" is unambiguous.
_ABBREVIATIONS = [
    # No trailing \b: the patterns end in a literal '.', and \b cannot match
    # between '.' and whitespace.
    (re.compile(rf"\b{abbr}", re.IGNORECASE), full)
    for abbr, full in [
        (r"mrs\.", "missus"),
        (r"mr\.", "mister"),
        (r"dr\.", "doctor"),
        # st. is context-sensitive (saint/street) — see _expand_st below.
        (r"ave\.", "avenue"),
        (r"blvd\.", "boulevard"),
        # "Maple Rd." → road, but "3rd." is an ordinal — gate on no digit.
        (r"(?<![0-9])rd\.", "road"),
        (r"mt\.", "mount"),
        (r"co\.", "company"),
        (r"jr\.", "junior"),
        (r"sr\.", "senior"),
        (r"maj\.", "major"),
        (r"gen\.", "general"),
        (r"drs\.", "doctors"),
        (r"rev\.", "reverend"),
        (r"lt\.", "lieutenant"),
        (r"hon\.", "honorable"),
        (r"sgt\.", "sergeant"),
        (r"capt\.", "captain"),
        (r"esq\.", "esquire"),
        (r"ltd\.", "limited"),
        (r"col\.", "colonel"),
        # "Ft. Worth" → fort, but "6 ft." is the measurement (numbers.py
        # expands it to feet) — gate on no digit before.
        (r"(?<!\d)(?<!\d\s)ft\.", "fort"),
        (r"etc\.", "et cetera"),
        (r"vs\.", "versus"),
        (r"no\.\s?(?=\d)", "number "),
    ]
]

_MONTHS = (
    "january|february|march|april|may|june|july|august|september|october|"
    "november|december"
)

# "St." is the one genuinely ambiguous abbreviation (saint vs street) — a
# WFST normalizer disambiguates it by context and so do we, case-sensitively
# before lowercasing (classify-then-verbalize, reference text.py:69-77):
#   1. "St." introducing a capitalized name reads as saint
#      ("St. Louis", "Visit St. James").
#   2. "St." after a capitalized or ordinal street name, NOT followed by a
#      capitalized word, reads as street ("Main St. at noon", "42nd St.").
#   3. anything left (lowercase input, no usable context) falls back to
#      saint — the pre-round-5 behavior.
# Residual ambiguity ("Main St. The next day" — a street at sentence end
# followed by a new sentence) resolves to saint; no local rule can tell
# that apart from "the St. James Gate".
_RE_ST_SAINT = re.compile(r"\bSt\.\s*(?=[A-Z])")
_RE_ST_STREET = re.compile(
    r"\b([A-Z][a-z]+|\d+(?:st|nd|rd|th))\s+St\.(?!\s*[A-Z])"
)
_RE_ST_FALLBACK = re.compile(r"\bst\.", re.IGNORECASE)


def _expand_st(text: str) -> str:
    text = _RE_ST_SAINT.sub("saint ", text)
    text = _RE_ST_STREET.sub(r"\1 street", text)
    return _RE_ST_FALLBACK.sub("saint", text)

# Roman numerals are expanded only in context (NeMo's classify-then-verbalize
# approach, reference text.py:69-77): a counting noun before the numeral
# reads as a cardinal ("Chapter IV" → "chapter four"), a capitalized proper
# name before it reads as a regnal ordinal ("Henry VIII" → "Henry the
# eighth"). Bare all-caps tokens are left alone — "MIX"/"CD"/"XL" are far
# more often acronyms than numerals.
_ROMAN_CARDINAL_CONTEXT = (
    "chapter|act|part|section|volume|book|war|grade|phase|stage|level|"
    "type|class|article|appendix|scene|quadrant|apollo|rocky"
)
# Context word matches any case; the numeral itself must be UPPERCASE
# (scoped (?i:...) flag) — otherwise "class mix" would read MIX as 1009.
_RE_ROMAN_CARDINAL = re.compile(
    rf"\b(?i:({_ROMAN_CARDINAL_CONTEXT}))\s+([IVXLCDM]{{1,8}})(?=\W|$)"
)
_RE_ROMAN_REGNAL = re.compile(
    r"\b([A-Z][a-z]{2,})\s+([IVXLCDM]{2,8}|[IV])(?=\W|$)"
)
# Capitalized sentence-position words that precede acronyms like IV/XL/VI
# without naming a monarch ("The IV drip", "His XL shirt").
_REGNAL_STOPWORDS = frozenset(
    "the this that these those his her its our their your some any each "
    "every another with for and but nor was were has had who she him "
    "they all not one two new old".split()
)
# SINGLE-letter numerals are far more ambiguous than 'VIII': "Saturn V",
# "Malcolm X", "Gemini V" are names/vehicles, not regnal ordinals. A bare
# 'V'/'I' only reads regnally after a first name that historically takes
# one (the classify-then-verbalize gate, same approach as the cardinal
# context list above).
_REGNAL_NAMES = frozenset(
    "henry edward charles louis george william richard james mary "
    "elizabeth philip frederick alexander napoleon leo paul pius urban "
    "gregory benedict clement innocent".split()
)
# "January 5" / "January 5, 1984" style dates → ordinal day reading.
_RE_MONTH_DAY = re.compile(
    rf"\b({_MONTHS})\s+(\d{{1,2}})(st|nd|rd|th)?\b", re.IGNORECASE
)

_UNICODE_MAP = {
    "‘": "'", "’": "'", "“": '"', "”": '"',
    "–": "-", "—": " - ", "…": "...", " ": " ",
    # "İ" (U+0130) lowercases to "i" + U+0307, a combining mark that is no
    # word character: a digit after it would be glued to the word on the
    # first pass and read as a number on the second ("İ0" → "i̇0" →
    # "i̇zero"). Read as "I", normalization stays idempotent.
    "\u0130": "I",
}


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _expand_romans(text: str) -> str:
    from perfbench.reference.numbers import (
        number_to_words,
        ordinal_to_words,
        roman_to_int,
    )

    def cardinal(m: re.Match) -> str:
        # The context word is the gate, so "Chapter I" reads as "chapter
        # one" — but a bare "I" continuing into another word is almost
        # always the pronoun ("after the war I went home"), so "I" only
        # counts before punctuation/end or "of" ("Part I of the trilogy").
        numeral = m.group(2)
        if numeral == "I":
            tail = m.string[m.end():]
            if re.match(r"\s+(?!of\b)\w", tail):
                return m.group(0)
        n = roman_to_int(numeral)
        if n is None:
            return m.group(0)
        return f"{m.group(1)} {number_to_words(n)}"

    def regnal(m: re.Match) -> str:
        if m.group(1).lower() in _REGNAL_STOPWORDS:
            return m.group(0)  # "The IV drip" — not a monarch
        numeral = m.group(2)
        # Single-letter numerals: only after a known regnal first name
        # ("Henry V", "Charles V" — NOT "Saturn V"/"Malcolm X"), and a bare
        # "I" continuing into more words is almost always the pronoun
        # ("yesterday Mary I met..."), so "I" additionally requires
        # punctuation/end or "of" after it.
        if len(numeral) == 1:
            if m.group(1).lower() not in _REGNAL_NAMES:
                return m.group(0)
            if numeral == "I" and re.match(
                r"\s+(?!of\b)\w", m.string[m.end():]
            ):
                return m.group(0)
        n = roman_to_int(numeral)
        if n is None or n > 50:  # Henry VIII yes, NASDAQ CM no
            return m.group(0)
        return f"{m.group(1)} the {ordinal_to_words(n)}"

    text = _RE_ROMAN_CARDINAL.sub(cardinal, text)
    return _RE_ROMAN_REGNAL.sub(regnal, text)


def _expand_dates(text: str) -> str:
    from perfbench.reference.numbers import ordinal_to_words

    def repl(m: re.Match) -> str:
        day = int(m.group(2))
        if not 1 <= day <= 31:
            return m.group(0)
        return f"{m.group(1)} {ordinal_to_words(day)}"

    return _RE_MONTH_DAY.sub(repl, text)


def normalize_text(text: str) -> str:
    """Full normalization: unicode cleanup → abbreviations → dates →
    numbers/currency → lowercase → whitespace collapse.

    The contract matches the reference's ``TextProcessor.normalize_text``
    (text.py:94-130): output is lowercase with collapsed whitespace, with all
    numeric constructs verbalised.
    """
    for src, dst in _UNICODE_MAP.items():
        text = text.replace(src, dst)
    text = unicodedata.normalize("NFKC", text)
    text = _expand_st(text)  # context-sensitive; needs original case
    for pattern, full in _ABBREVIATIONS:
        text = pattern.sub(full, text)
    text = _expand_romans(text)  # case-sensitive: must precede lowercasing
    text = _expand_dates(text)
    text = expand_numbers(text)
    text = text.lower()
    # A rule can take the space before a combining mark ("0° ́" → "zero
    # degrees" + U+0301), which then composes with the letter it now
    # follows on the next pass: compose it here.
    return unicodedata.normalize("NFKC", collapse_whitespace(text))
